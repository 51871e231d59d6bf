"""Checkpoints with optional paper-driven lossy compression
(``repro/ckpt/checkpoint.py``), in the reference's on-disk layout.

Layout on disk (the same files either package writes and reads)::

  <dir>/step_<N>/manifest.json        tensor index, shapes, dtypes, codec
  <dir>/step_<N>/<leaf>.npz | .lossy  payload per tensor
  <dir>/step_<N>/COMMITTED            written last (crash-consistent)

Keys are a tree's paths joined by ``/`` (``params/seg0/attn/wq``), file
names the keys with ``/`` as ``__``.  A raw tensor is an ``.npz`` with
one array ``data`` (bfloat16 stored as float32, the manifest keeping
``"bfloat16"``).  A lossy one is the pickled dict ``{"recon": float32
array, "shape": tuple, "dtype": "float32"}`` (stored decompressed for
simplicity; its size is metered).

Lossy path (the paper as a framework feature), the reference's rule: a
float32 or bfloat16 tensor of at least ``min_size`` elements, and not an
optimizer moment (``"mu/"`` / ``"nu/"`` in its key) while
``skip_moments``, is viewed as a 2-D slice (``_pack2d``), its error
bound is ``rel_eb`` times its value range, UC2's trained per-compressor
CR models pick its compressor from its features (no trial compression;
otherwise ``compressor``), and predicted and achieved CR go into the
manifest.  ``_compress_tensor`` runs on ``LossyPolicy.device`` (the
card unless the caller asks for the CPU): the features' Gram, and the
sz3-lorenzo and zfp encodes' Lorenzo and ZFP kernels, run there.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import queue
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.params import tree_flatten, tree_unflatten


@dataclasses.dataclass
class LossyPolicy:
    enabled: bool = False
    rel_eb: float = 1e-4                  # error bound = rel_eb * value range
    compressor: str = "sz3-lorenzo"       # fallback when no predictor given
    predictors: Optional[Dict[str, Any]] = None   # name -> CRPredictor (UC2)
    min_size: int = 65536                 # small tensors stay lossless
    skip_moments: bool = True             # optimizer moments stay lossless
    device: str = "cuda"                  # where the compressors run


def _leaf_paths(tree) -> Dict[str, Any]:
    """{"a/b/c": leaf} in ``jax.tree.flatten``'s order."""
    return {path.replace(".", "/"): leaf for path, leaf in tree_flatten(tree)}


def _pack2d(arr: torch.Tensor) -> torch.Tensor:
    """View an arbitrary tensor as a 2-D slice for the compressor suite."""
    n = arr.numel()
    w = 1
    for cand in (4096, 2048, 1024, 512, 256, 128, 64):
        if n % cand == 0:
            w = cand
            break
    return arr.reshape(-1, w) if w > 1 else arr.reshape(1, -1)


def _compress_tensor(arr: torch.Tensor, policy: LossyPolicy
                     ) -> Tuple[bytes, Dict]:
    """(payload, manifest entry) of one float32 tensor."""
    from repro_torch import compressors as C
    from repro_torch.core import pipeline as PL
    data2d = _pack2d(arr.to(policy.device, torch.float32))
    rng = float(torch.max(data2d) - torch.min(data2d)) if arr.numel() else 0.0
    eps = max(policy.rel_eb * rng, 1e-12)
    name = policy.compressor
    pred_cr = None
    if policy.predictors:
        feats = PL.featurize_slices(data2d[None], eps)
        preds = {n: float(m.predict_from_features(feats)[0])
                 for n, m in policy.predictors.items()}
        name = max(preds, key=preds.get)
        pred_cr = preds[name]
    comp = C.get(name)
    codes, aux = comp.encode(data2d, eps)
    size = comp.size_bytes(codes, aux, eps)
    recon = comp.decode(codes, aux, eps).to("cpu", torch.float32).numpy()
    payload = pickle.dumps({
        "recon": recon.astype(np.float32),
        "shape": tuple(arr.shape), "dtype": "float32",
    }, protocol=4)
    meta = {"codec": name, "eps": eps, "metered_bytes": int(size),
            "raw_bytes": int(arr.numel() * 4),
            "achieved_cr": float(arr.numel() * 4 / max(size, 1)),
            "predicted_cr": pred_cr}
    return payload, meta


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).split(".")[-1]


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bfloat16 as float32 (the reference's .npz)."""
    t = t.detach().to("cpu")
    return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()


def save(directory: str, step: int, tree, policy: LossyPolicy = LossyPolicy(),
         extra_meta: Optional[Dict] = None) -> Dict:
    """Blocking save of a tree of tensors; returns the manifest."""
    d = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(d, exist_ok=True)
    manifest: Dict[str, Any] = {"step": step, "tensors": {}, "time": time.time()}
    if extra_meta:
        manifest.update(extra_meta)
    for key, leaf in _leaf_paths(tree).items():
        fname = key.replace("/", "__")
        lossy_ok = (policy.enabled and leaf.numel() >= policy.min_size
                    and leaf.dtype in (torch.float32, torch.bfloat16)
                    and not (policy.skip_moments
                             and ("mu/" in key or "nu/" in key)))
        if lossy_ok:
            payload, meta = _compress_tensor(leaf, policy)
            with open(os.path.join(d, fname + ".lossy"), "wb") as f:
                f.write(payload)
            manifest["tensors"][key] = {"file": fname + ".lossy", **meta}
        else:
            np.savez(os.path.join(d, fname + ".npz"), data=_host(leaf))
            manifest["tensors"][key] = {
                "file": fname + ".npz", "codec": "raw",
                "dtype": _dtype_name(leaf), "shape": list(leaf.shape)}
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, default=str)
    with open(os.path.join(d, "COMMITTED"), "w") as f:
        f.write(str(step))
    return manifest


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and \
                os.path.exists(os.path.join(directory, name, "COMMITTED")):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def load(directory: str, step: int, like_tree) -> Any:
    """Restore into the structure of ``like_tree``: each leaf in its
    like's dtype (float32 data rounded to bfloat16 where the like is),
    shape and device."""
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    out = []
    for key, leaf in _leaf_paths(like_tree).items():
        info = manifest["tensors"][key]
        path = os.path.join(d, info["file"])
        if info["file"].endswith(".lossy"):
            with open(path, "rb") as f:
                blob = pickle.loads(f.read())
            arr = blob["recon"].reshape(blob["shape"])
        else:
            arr = np.load(path)["data"]
        out.append(torch.from_numpy(np.ascontiguousarray(arr)).to(
            leaf.device).to(leaf.dtype).reshape(leaf.shape))
    return tree_unflatten(like_tree, out)


class AsyncCheckpointer:
    """Background-thread writer: the train loop hands off host copies and
    keeps stepping while the previous checkpoint serializes (its lossy
    tensors go back to ``policy.device`` to be compressed)."""

    def __init__(self, directory: str, policy: LossyPolicy = LossyPolicy()):
        self.directory = directory
        self.policy = policy
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self.last_manifest: Optional[Dict] = None
        self.error: Optional[Exception] = None

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, host_tree, extra = item
            try:
                self.last_manifest = save(self.directory, step, host_tree,
                                          self.policy, extra)
            except Exception as e:          # re-raised by wait()
                self.error = e
            finally:
                self._q.task_done()

    def submit(self, step: int, tree, extra: Optional[Dict] = None):
        host_tree = tree_unflatten(tree, [
            leaf.detach().to("cpu", copy=True)
            for _, leaf in tree_flatten(tree)])      # device -> host copy
        self._q.put((step, host_tree, extra))

    def wait(self):
        """Block until every submitted save is written; a save that
        failed raises here instead of leaving the caller waiting."""
        self._q.join()
        if self.error is not None:
            err, self.error = self.error, None
            raise err

    def close(self):
        self._q.put(None)
        self._worker.join(timeout=30)
