"""Training across processes on the ``pod`` and ``data`` axes of a mesh
(``repro_torch.dist.{sharding, collectives, fault}``, ``launch.mesh``,
``train.train_step``'s podsync and data-parallel modes, ``launch.train
--mesh``, the ``REPRO_REMAT`` policies) against the reference on the CPU.

The reference's own multi-device tests (``tests/test_dist.py``) run in
child interpreters with 8 virtual devices; here the port is held against
the reference's single-device routes instead:

* specs: the reference's ``spec_for`` over its ``logical_axes`` on a
  stand-in mesh (``axis_names`` and ``devices.shape``, all it reads), at
  16 x 16 and 2 x 16 x 16;
* the int8 collective: ``jax.jit`` of the reference's ``quantize_int8`` /
  ``dequantize_int8`` composed over the stacked pods (its all-gather's
  receiver side) -- bit for bit, ties at .5 and all-zero rows included;
* podsync and data-parallel steps on 2 gloo ranks: the reference's
  ``_grads``, collectives and ``OPT.apply`` composed per pod on one
  device (``jax.jit`` each), and its whole-batch ``pjit`` step, at the
  LLM bounds of ``tests/test_torch_train.py`` (float32 losses rtol 1e-4,
  parameters rtol 2e-2 / atol 2e-4; bfloat16 losses rtol 1e-3, at most
  1 % of a leaf past that, none past 2 sum(lr)); given the same
  gradients, the int8 codes, scales, synced gradients and residuals bit
  for bit; both ranks' parameters and moments bit-identical;
* re-meshing on a 4 x 2 mesh of 8 gloo ranks, bit-exact
  (``test_elastic_remesh``);
* the remat policies: gradients under ``dots`` and ``tp_outs`` equal to
  ``full``'s bit for bit (same operations, some kept instead of
  recomputed).

Each group of ranks starts once per module, fresh interpreters joined by
``file://`` init under the test's tmp dir, one thread each.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as RB  # noqa: E402
from repro.dist import collectives as JCOL  # noqa: E402
from repro.dist import sharding as JS  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import params as RPRM  # noqa: E402
from repro.train import grad_compress as JGC  # noqa: E402
from repro.train import optimizer as JOPT  # noqa: E402
from repro.train import train_step as JTS  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.dist import collectives as COL  # noqa: E402
from repro_torch.dist import fault as F  # noqa: E402
from repro_torch.dist import sharding as S  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.params import tree_flatten, tree_leaves  # noqa: E402
from repro_torch.train import grad_compress as TGC  # noqa: E402
from repro_torch.train import optimizer as TOPT  # noqa: E402
from repro_torch.train import train_step as TTS  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RANK_TIMEOUT_S = 120
ARCH = "granite-3-2b"
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
LR, WARMUP = 3e-3, 10
BATCH, SEQ, STEPS = 8, 32, 2
PODSYNC = [(mode, mb) for mode in ("ef", "int8", "plain") for mb in (1, 2)]
DATA_PARALLEL = [("float32", 2), ("bfloat16", 1)]


class StandInMesh:
    """What the reference's ``spec_for`` / ``use_mesh`` read of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.devices = np.empty(shape, dtype=object)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        x = x.numpy()
    x = np.ascontiguousarray(np.asarray(x))
    return x.view({4: np.int32, 2: np.int16, 1: np.int8}[x.itemsize])


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------------ specs

def test_logical_sharding_divisibility_fallback():
    """``tests/test_dist.py::test_logical_sharding_divisibility_fallback``
    on the port, beside the reference's ``spec_for`` on a stand-in mesh."""
    mesh = S.AbstractMesh((2, 4), ("data", "model"))
    with S.use_mesh(mesh):
        s1 = S.spec_for((8, 20, 64), ("batch", "model", None))
        s2 = S.spec_for((8, 25, 64), ("batch", "model", None))
    assert tuple(s1) == ("data", "model", None)
    assert tuple(s2) == ("data", None, None)
    ref = StandInMesh((2, 4), ("data", "model"))
    assert tuple(s1) == tuple(JS.spec_for((8, 20, 64),
                                          ("batch", "model", None), ref))
    assert tuple(s2) == tuple(JS.spec_for((8, 25, 64),
                                          ("batch", "model", None), ref))
    assert tuple(S.spec_for((8, 4), ("batch", None))) == (None, None)
    with pytest.raises(ValueError, match="needs a mesh"):
        S.named_sharding((8, 4), ("batch", None))


def test_rules_placements_and_sweep_meshes():
    """A rule over two axes shards one dimension on both (``Shard(d)``
    on each mesh dimension, the first outermost, as JAX splits it);
    a sweep mesh's one axis is ``"data"``."""
    mesh = S.AbstractMesh((2, 4, 2), ("pod", "data", "model"))
    ref = StandInMesh((2, 4, 2), ("pod", "data", "model"))
    rules = {"batch": ("pod", "data")}
    with S.use_mesh(mesh, rules):
        ns = S.named_sharding((16, 6, 4), ("batch", None, "model"))
    with JS.use_mesh(ref, rules):
        want = JS.spec_for((16, 6, 4), ("batch", None, "model"), ref)
    assert tuple(ns.spec) == tuple(want) == (("pod", "data"), None, "model")
    Replicate, Shard = S._placement_types()
    assert ns.placements == (Shard(0), Shard(0), Shard(2))
    with S.use_mesh(mesh):
        assert S.named_sharding((16, 6, 4), ("batch", None, None)
                                ).placements == (Replicate(), Shard(0),
                                                 Replicate())
    sweep = M.make_sweep_mesh(devices=["cpu"] * 4)
    assert tuple(S.spec_for((8, 3, 3), ("slices", None, None), sweep)) == (
        "data", None, None)
    assert S.current_rules() == S.DEFAULT_RULES


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", TB.ARCH_IDS)
def test_param_specs_at_production_meshes(arch, mesh):
    shape, names = MESHES[mesh]
    got = TM.param_specs(TB.get_arch(arch), S.AbstractMesh(shape, names))
    ref = StandInMesh(shape, names)
    table = RM.param_table(RB.get_arch(arch))
    defs = jax.tree.leaves(table, is_leaf=lambda d: isinstance(d,
                                                                RPRM.ParamDef))
    axes = jax.tree.leaves(RPRM.logical_axes(table),
                           is_leaf=lambda x: isinstance(x, tuple))
    got = tree_flatten(got)
    assert len(got) == len(defs) == len(axes)
    for (k, ns), d, ax in zip(got, defs, axes):
        assert tuple(ns.spec) == tuple(JS.spec_for(d.shape, ax, ref)), k
        assert len(ns.placements) == len(shape)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", TB.ARCH_IDS)
def test_cache_logical_axes_at_production_meshes(arch, mesh):
    """Every family's cache axes (the flash-decoding ``seq_model``
    fallback where the KV heads do not divide the model extent; whisper's
    5-D / 3-D rule) and their specs, against the reference's under its
    ``use_mesh``."""
    shape, names = MESHES[mesh]
    cfg, rcfg = TB.get_arch(arch), RB.get_arch(arch)
    amesh, ref = S.AbstractMesh(shape, names), StandInMesh(shape, names)
    cache = TM.abstract_cache(cfg, 2, 64)
    with S.use_mesh(amesh):
        got = TM.cache_logical_axes(cfg, cache)
    rcache = RM.abstract_cache(rcfg, 2, 64)
    with JS.use_mesh(ref):
        want = RM.cache_logical_axes(rcfg, rcache)
    is_axes = lambda x: isinstance(x, tuple) and not hasattr(x, "_fields")
    got_l = tree_leaves(got, is_leaf=is_axes)
    want_l = jax.tree.leaves(want, is_leaf=is_axes)
    assert got_l == [tuple(a) for a in want_l]
    for x, ax, r in zip(tree_leaves(cache), got_l, jax.tree.leaves(rcache)):
        assert tuple(x.shape) == tuple(r.shape)
        assert tuple(S.spec_for(x.shape, ax, amesh)) == tuple(
            JS.spec_for(r.shape, ax, ref))


@pytest.mark.parametrize("arch", TB.ARCH_IDS)
def test_abstract_trees_at_full_size(arch):
    """Meta-device parameters and caches of every config at full size:
    the reference's shapes and dtypes, a count equal to
    ``cfg.param_count()``, nothing allocated."""
    cfg, rcfg = TB.get_arch(arch), RB.get_arch(arch)
    ab = TM.abstract_params(cfg)
    want = dict(tree_flatten(jax.tree.map(lambda s: s,
                                          RM.abstract_params(rcfg))))
    got = dict(tree_flatten(ab))
    assert list(got) == list(want)
    for k, x in got.items():
        assert x.device.type == "meta", k
        assert tuple(x.shape) == tuple(want[k].shape), k
        assert str(x.dtype).split(".")[-1] == str(want[k].dtype), k
    assert sum(x.numel() for x in got.values()) == cfg.param_count() == \
        rcfg.param_count()
    cache = TM.abstract_cache(cfg, 2, 64)
    rcache = jax.tree.leaves(RM.abstract_cache(rcfg, 2, 64))
    leaves = tree_leaves(cache)
    assert len(leaves) == len(rcache)
    for x, r in zip(leaves, rcache):
        assert x.device.type == "meta"
        assert tuple(x.shape) == tuple(r.shape)
        assert str(x.dtype).split(".")[-1] == str(r.dtype)


def test_meshes_without_a_group_are_abstract():
    mesh = M.make_production_mesh(multi_pod=True)
    assert isinstance(mesh, S.AbstractMesh)
    assert S.axis_sizes(mesh) == {"pod": 2, "data": 16, "model": 16}
    assert S.axis_sizes(M.make_production_mesh()) == {"data": 16,
                                                      "model": 16}
    with pytest.raises(ValueError, match="differ in length"):
        M.make_mesh((2, 2), ("data",))
    small = F.shrink_mesh(mesh, "data", 4)
    assert S.axis_sizes(small) == {"pod": 2, "data": 4, "model": 16}
    with pytest.raises(ValueError, match="not 'seq'"):
        F.shrink_mesh(mesh, "seq", 1)
    with pytest.raises(ValueError, match="outside"):
        F.shrink_mesh(mesh, "data", 17)


# ------------------------------------------------------------ collectives

def _planted(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 0.01).astype(np.float32)
    rows = x.reshape(-1, shape[-1])
    rows[0] = 0.0                                     # an all-zero row
    if rows.shape[0] > 2:
        # ties: x / scale lands on .5 (amax 127, so scale 1 up to its
        # reciprocal's rounding: exact halves only where the product is)
        rows[1] = np.arange(shape[-1], dtype=np.float32) % 7 - 3.5
        rows[1, 0] = 127.0
        rows[2] = (np.arange(shape[-1]) % 5 + 0.5).astype(np.float32) * 0.25
        rows[2, 1] = 127.0 * 0.25
    return x


@pytest.mark.parametrize("shape", [(64, 1000), (1000,), (3, 5, 7),
                                   (2, 24, 48)])
def test_quantize_int8_is_the_jitted_reference(shape):
    x = _planted(shape, 0)
    qj, sj = jax.jit(JCOL.quantize_int8)(x)
    q, s = COL.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(_bits(s), _bits(sj))
    np.testing.assert_array_equal(
        _bits(COL.dequantize_int8(q, s)),
        _bits(jax.jit(JCOL.dequantize_int8)(qj, sj)))
    rows = x.reshape(-1, shape[-1])
    if rows.shape[0] > 2:
        # the planted halves really are ties, rounded to even
        ratio = rows[1:3] / np.asarray(sj).reshape(-1, 1)[1:3]
        half = np.abs(ratio % 1 - 0.5) == 0
        assert half.any()
        assert (np.abs(q.numpy().reshape(-1, shape[-1])[1:3][half]) % 2
                == 0).all()
    # the eager reference divides by 127 where the jitted one multiplies
    assert not np.array_equal(_bits(COL.quantize_int8(
        torch.from_numpy(_planted((512, 64), 3)))[1]),
        _bits(JCOL.quantize_int8(_planted((512, 64), 3))[1]))


def _jit_pod_mean(xs):
    q, s = jax.vmap(JCOL.quantize_int8)(xs)
    return jnp.mean(JCOL.dequantize_int8(q, s), axis=0)


def _jit_residual(gf):
    """The reference step's residual (``train_step.py:166-171``)."""
    amax = jnp.max(jnp.abs(gf), axis=-1, keepdims=True)
    scale = jnp.maximum(amax, 1e-12) / 127.0
    deq = (jnp.clip(jnp.round(gf / scale), -127, 127)
           .astype(jnp.int8).astype(jnp.float32) * scale)
    return gf - deq


@pytest.mark.parametrize("pods", [1, 2, 3, 4])
def test_pod_mean_and_residual_are_the_jitted_reference(pods):
    """The receiver side of ``compressed_pod_allreduce`` (dequantize, mean
    over the gathered pods) and the error-feedback residual, against
    ``jax.jit`` of the reference's functions over stacked pods."""
    xs = np.stack([_planted((48, 96), s) for s in range(pods)])
    want = np.asarray(jax.jit(_jit_pod_mean)(xs))
    parts = [COL.quantize_int8(torch.from_numpy(x)) for x in xs]
    got = COL.pod_mean([q for q, _ in parts], [s for _, s in parts])
    np.testing.assert_array_equal(_bits(got), _bits(want))
    for x, (q, s) in zip(xs, parts):
        np.testing.assert_array_equal(
            _bits(COL.residual(torch.from_numpy(x), q, s)),
            _bits(jax.jit(_jit_residual)(x)))
    assert COL.all_gather(torch.ones(3), None)[0].tolist() == [1.0] * 3


# ------------------------------------------------------------ rank groups

RANK_PREAMBLE = """
import dataclasses, json, pickle, sys
import numpy as np
import torch
from repro_torch.launch import mesh as M
INIT, NPROCS, RANK, OUT = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
torch.set_num_threads(1)
M.dist_init(INIT, num_processes=NPROCS, process_id=RANK, backend="gloo",
            device="cpu", init_timeout_s={timeout})
SAVED, ERRORS = {{}}, {{}}

def save(name, value):
    if isinstance(value, torch.Tensor):
        value = value.detach()
        if value.dtype == torch.bfloat16:
            value = value.float()
    SAVED[name] = np.array(value)     # a copy: a donated step writes in place

def error(name, fn, kinds=(ValueError, NotImplementedError)):
    try:
        fn()
    except kinds as e:
        ERRORS[name] = [type(e).__name__, str(e)]
    else:
        ERRORS[name] = None
"""

RANK_EPILOGUE = """
np.savez(f"{OUT}/rank{RANK}.npz", **SAVED)
with open(f"{OUT}/rank{RANK}.json", "w") as f:
    json.dump(ERRORS, f)
torch.distributed.destroy_process_group()
"""


def _rank_env() -> dict:
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=SRC + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


def _wait(procs, timeout: float) -> list:
    deadline = time.monotonic() + timeout
    try:
        outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        outs = [p.communicate() for p in procs]
        raise AssertionError("process group timed out:\n" + "\n".join(
            f"--- rank {i} ---\n{o}\n{e}" for i, (o, e) in enumerate(outs)))
    return outs


def run_ranks(tmp_path, body: str, nprocs: int, consts: dict) -> list:
    """Run ``body`` in ``nprocs`` gloo processes; each one's (saved
    arrays, errors)."""
    header = "".join(f"{k} = {v!r}\n" for k, v in consts.items())
    script = tmp_path / "rank.py"
    script.write_text(RANK_PREAMBLE.format(timeout=RANK_TIMEOUT_S) + header
                      + textwrap.dedent(body) + RANK_EPILOGUE)
    init = f"file://{tmp_path / 'init'}"
    procs = [subprocess.Popen([sys.executable, str(script), init, str(nprocs),
                               str(r), str(tmp_path)], env=_rank_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(nprocs)]
    outs = _wait(procs, RANK_TIMEOUT_S)
    report = "\n".join(f"--- rank {i} (rc={p.returncode}) ---\n{o}\n{e}"
                       for i, (p, (o, e)) in enumerate(zip(procs, outs)))
    assert all(p.returncode == 0 for p in procs), report
    res = []
    for r in range(nprocs):
        with np.load(tmp_path / f"rank{r}.npz") as z:
            saved = dict(z)
        with open(tmp_path / f"rank{r}.json") as f:
            res.append((saved, json.load(f)))
    return res


def _ref_tree(dtype: str):
    rcfg = dataclasses.replace(RB.get_smoke(ARCH), dtype=dtype)
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                        RM.init_params(rcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    seg = tree["seg0"]
    for k in ("norm1", "norm2"):
        seg[k] = (1 + 0.1 * rng.standard_normal(seg[k].shape)).astype(
            np.float32)
    # rounded to the dtype, so both packages start from the same values
    return jax.tree.map(lambda a: np.asarray(
        jnp.asarray(a, jnp.dtype(dtype)).astype(jnp.float32)), tree)


def _batches():
    out = []
    for i in range(STEPS):
        toks = np.random.default_rng(10 + i).integers(
            0, RB.get_smoke(ARCH).vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


COHORT2 = """
from repro_torch import convert
from repro_torch.configs import base as TB
from repro_torch.dist import collectives as COL, sharding as S
from repro_torch.models.params import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.train import grad_compress as GC, optimizer as OPT
from repro_torch.train import train_step as TS

with open(INPUTS, "rb") as f:
    INP = pickle.load(f)
world = torch.distributed.group.WORLD
x = torch.from_numpy(INP["x"][RANK])
save("allreduce", COL.compressed_pod_allreduce(x, world))
save("allreduce_bf16", COL.compressed_pod_allreduce(x.to(torch.bfloat16),
                                                    world))
save("pmean", COL.pmean(x, world))
save("gathered", torch.stack(COL.all_gather(x.to(torch.bfloat16), world)))

ocfg = OPT.AdamWConfig(lr=LR, warmup_steps=WARMUP)
batches = [{k: torch.from_numpy(v) for k, v in b.items()}
           for b in INP["batches"]]
REC = []
orig_q, orig_mean = COL.quantize_int8, COL.pod_mean

def rec_q(x):
    q, s = orig_q(x)
    REC.append({"gf": x.clone(), "q": q, "s": s})
    return q, s

def rec_mean(qs, ss):
    out = orig_mean(qs, ss)
    REC[-1]["synced"] = out
    return out

COL.quantize_int8, COL.pod_mean = rec_q, rec_mean

def state_of(dtype, ef):
    params = convert.lm_tree(INP["tree_" + dtype], "cpu")
    params = tree_unflatten(params, [p.to(getattr(torch, dtype))
                                     for p in tree_leaves(params)])
    return TS.TrainState(params, OPT.init(params),
                         GC.init_ef(params) if ef else None)

pod_mesh = M.make_mesh((2, 1, 1), ("pod", "data", "model"))
cfg32 = dataclasses.replace(TB.get_smoke(ARCH), dtype="float32")
for mode, mb in PODSYNC:
    tag = f"podsync_{mode}_{mb}"
    compress = (GC.CompressConfig(enabled=True, gate_ratio=0.0)
                if mode != "plain" else None)
    state = TS.stack_for_podsync(state_of("float32", mode == "ef"), 2)
    step = TS.make_train_step(cfg32, ocfg, microbatches=mb,
                              compress=compress, mode="podsync",
                              mesh=pod_mesh, donate=mb == 2)
    for i, batch in enumerate(batches):
        REC.clear()
        state, m = step(state, batch)
        for k, v in m.items():
            save(f"{tag}/{i}/{k}", v)
        for k, v in tree_flatten(state.params):
            save(f"{tag}/{i}/params/{k}", v[0])
        for k, v in tree_flatten(state.opt.mu):
            save(f"{tag}/{i}/mu/{k}", v[0])
        for k, v in tree_flatten(state.opt.nu):
            save(f"{tag}/{i}/nu/{k}", v[0])
        if state.ef is not None:
            for k, v in tree_flatten(state.ef.residuals):
                save(f"{tag}/{i}/res/{k}", v[0])
        for j, r in enumerate(REC):
            for k, v in r.items():
                save(f"{tag}/{i}/rec/{j}/{k}", v)

data_mesh = M.make_mesh((2, 1), ("data", "model"))
for dtype, mb in DATA_PARALLEL:
    tag = f"dp_{dtype}_{mb}"
    cfg = dataclasses.replace(TB.get_smoke(ARCH), dtype=dtype)
    state = state_of(dtype, False)
    with S.use_mesh(data_mesh):
        step = TS.make_train_step(cfg, ocfg, microbatches=mb)
    for i, batch in enumerate(batches):
        state, m = step(state, batch)
        for k, v in m.items():
            save(f"{tag}/{i}/{k}", v)
        for k, v in tree_flatten(state.params):
            save(f"{tag}/{i}/params/{k}", v)

error("model_axis", lambda: TS.make_train_step(
    cfg32, mesh=M.make_mesh((1, 2), ("data", "model"))))
error("no_pod_axis", lambda: TS.make_train_step(
    cfg32, mode="podsync", mesh=data_mesh))
error("group_size", lambda: M.make_mesh((2, 2), ("data", "model")))
"""


@pytest.fixture(scope="module")
def cohort2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cohort2")
    rng = np.random.default_rng(5)
    inputs = {"x": (rng.standard_normal((2, 24, 64)) * 0.01).astype(
        np.float32),
              "tree_float32": _ref_tree("float32"),
              "tree_bfloat16": _ref_tree("bfloat16"),
              "batches": _batches()}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    res = run_ranks(tmp, COHORT2, 2, dict(
        INPUTS=str(tmp / "inputs.pkl"), ARCH=ARCH, LR=LR, WARMUP=WARMUP,
        PODSYNC=PODSYNC, DATA_PARALLEL=DATA_PARALLEL))
    return inputs, res


def test_compressed_pod_allreduce_two_ranks(cohort2):
    """Both ranks get the reference's jitted composition's bits, within
    0.05 of the mean (``test_compressed_pod_allreduce_matches_mean``)."""
    inputs, res = cohort2
    xs = inputs["x"]
    want = np.asarray(jax.jit(_jit_pod_mean)(xs))
    mean = xs.mean(0)
    for saved, _ in res:
        np.testing.assert_array_equal(_bits(saved["allreduce"]), _bits(want))
        rel = np.abs(saved["allreduce"] - mean).max() / np.abs(mean).max()
        assert rel < 0.05, rel
        want_bf = np.asarray(jax.jit(_jit_pod_mean)(
            xs.astype(jnp.bfloat16).astype(np.float32)).astype(jnp.bfloat16)
            .astype(np.float32))
        np.testing.assert_array_equal(saved["allreduce_bf16"], want_bf)
        np.testing.assert_array_equal(_bits(saved["pmean"]),
                                      _bits((xs[0] + xs[1]) * np.float32(0.5)))
        np.testing.assert_array_equal(
            saved["gathered"],
            xs.astype(jnp.bfloat16).astype(np.float32))


def test_model_axis_raises_and_pod_data_axes_need_a_group(cohort2):
    _, res = cohort2
    for _, errors in res:
        kind, msg = errors["model_axis"]
        assert kind == "NotImplementedError" and "'model' axis" in msg
        assert "next slice" in msg
        assert errors["no_pod_axis"][0] == "ValueError"
        kind, msg = errors["group_size"]
        assert kind == "ValueError" and "dist_init" in msg
    cfg = TB.get_smoke(ARCH)
    with pytest.raises(ValueError, match="dist_init"):
        TTS.make_train_step(cfg, mesh=S.AbstractMesh((2, 1),
                                                     ("data", "model")))
    with pytest.raises(NotImplementedError, match="next slice"):
        TTS.make_train_step(cfg, mode="podsync", mesh=S.AbstractMesh(
            (1, 1, 2), ("pod", "data", "model")))


def _ref_podsync(mode: str, mb: int, tree, batches):
    """The reference's podsync step composed per pod on one device:
    ``_grads`` of each pod's rows, the collectives over the stacked pods,
    ``OPT.apply``; each part under ``jax.jit``.  Returns per step (loss,
    params)."""
    rcfg = dataclasses.replace(RB.get_smoke(ARCH), dtype="float32")
    ocfg = JOPT.AdamWConfig(lr=LR, warmup_steps=WARMUP)
    grads_fn = jax.jit(lambda p, b: JTS._grads(rcfg, p, b, mb))
    apply_fn = jax.jit(lambda p, g, s: JOPT.apply(ocfg, p, g, s))
    mean_fn = jax.jit(lambda xs: jnp.mean(xs, axis=0))
    params = jax.tree.map(jnp.asarray, tree)
    opt = JOPT.init(params)
    res = [jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), params)
           for _ in range(2)]
    out = []
    for batch in batches:
        half = BATCH // 2
        lg = [grads_fn(params, {k: v[p * half:(p + 1) * half]
                                for k, v in batch.items()}) for p in range(2)]
        loss = (lg[0][0] + lg[1][0]) * 0.5
        leaves = [jax.tree.leaves(g) for _, g in lg]
        rl = [jax.tree.leaves(r) for r in res]
        synced, new_r = [], [[], []]
        for j, g0 in enumerate(leaves[0]):
            gs = [leaves[p][j] for p in range(2)]
            if mode == "ef":
                gf = [gs[p].astype(jnp.float32) + rl[p][j] for p in range(2)]
                synced.append(jax.jit(_jit_pod_mean)(jnp.stack(gf)))
                for p in range(2):
                    new_r[p].append(jax.jit(_jit_residual)(gf[p]))
            elif mode == "int8":
                synced.append(jax.jit(_jit_pod_mean)(jnp.stack(gs)))
            else:
                synced.append(mean_fn(jnp.stack(gs)))
        tdef = jax.tree.structure(params)
        if mode == "ef":
            res = [jax.tree.unflatten(tdef, r) for r in new_r]
        params, opt, _ = apply_fn(params, jax.tree.unflatten(tdef, synced),
                                  opt)
        out.append((float(loss), jax.tree.map(np.asarray, params)))
    return out


@pytest.mark.parametrize("mode,mb", PODSYNC)
def test_podsync_steps(cohort2, mode, mb):
    """Two pods, one rank each: the reference composed per pod at the LLM
    bounds; both ranks' parameters and moments bit-identical after every
    step; given the ranks' own gradients, the int8 codes, scales, synced
    gradients and residuals the reference's jitted bits."""
    inputs, res = cohort2
    tag = f"podsync_{mode}_{mb}"
    want = _ref_podsync(mode, mb, inputs["tree_float32"], inputs["batches"])
    (a, _), (b, _) = res
    for i, (loss, params) in enumerate(want):
        pre = f"{tag}/{i}/"
        for part in ("params", "mu", "nu", "loss", "grad_norm"):
            keys = [k for k in a if k.startswith(pre + part)]
            assert keys, (pre, part)
            for k in keys:
                np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]),
                                              err_msg=k)
        np.testing.assert_allclose(float(a[pre + "loss"]), loss, rtol=1e-4)
        for k, w in tree_flatten(params):
            np.testing.assert_allclose(a[f"{pre}params/{k}"], w, rtol=2e-2,
                                       atol=2e-4, err_msg=k)
        if mode == "plain":
            continue
        recs = sorted({k.split("/")[3] for k in a if k.startswith(pre + "rec/")},
                      key=int)
        assert len(recs) == len(tree_flatten(params))
        names = [k for k, _ in tree_flatten(params)]
        for j in recs:
            r = {s: (a[f"{pre}rec/{j}/{s}"], b[f"{pre}rec/{j}/{s}"])
                 for s in ("gf", "q", "s", "synced")}
            for side in (0, 1):
                qj, sj = jax.jit(JCOL.quantize_int8)(r["gf"][side])
                np.testing.assert_array_equal(r["q"][side], np.asarray(qj))
                np.testing.assert_array_equal(_bits(r["s"][side]), _bits(sj))
                np.testing.assert_array_equal(
                    _bits(r["synced"][side]), _bits(jax.jit(_jit_pod_mean)(
                        np.stack([r["gf"][0], r["gf"][1]]))))
                if mode == "ef":
                    own = (a, b)[side][f"{pre}res/{names[int(j)]}"]
                    np.testing.assert_array_equal(
                        _bits(own), _bits(jax.jit(_jit_residual)(
                            r["gf"][side])))


@pytest.mark.parametrize("dtype,mb", DATA_PARALLEL)
def test_data_parallel_pjit_steps(cohort2, dtype, mb):
    """The pjit mode across a 2-rank ``data`` axis against the reference's
    whole-batch jitted step, at the LLM bounds; both ranks bit-identical."""
    inputs, res = cohort2
    tag = f"dp_{dtype}_{mb}"
    rcfg = dataclasses.replace(RB.get_smoke(ARCH), dtype=dtype)
    ocfg = JOPT.AdamWConfig(lr=LR, warmup_steps=WARMUP)
    jstep = jax.jit(JTS.make_train_step(rcfg, ocfg, microbatches=mb))
    p = jax.tree.map(lambda a: jnp.asarray(a, jnp.dtype(dtype)),
                     inputs["tree_" + dtype])
    js = JTS.TrainState(p, JOPT.init(p), None)
    (a, _), (b, _) = res
    lr_sum = 0.0
    for i, batch in enumerate(inputs["batches"]):
        js, jm = jstep(js, jax.tree.map(jnp.asarray, batch))
        lr_sum += LR * min((i + 1) / WARMUP, 1.0)
        pre = f"{tag}/{i}/"
        for k in [k for k in a if k.startswith(pre)]:
            np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]), err_msg=k)
        np.testing.assert_allclose(
            float(a[pre + "loss"]), float(jm["loss"]),
            rtol=1e-4 if dtype == "float32" else 1e-3)
        for k, w in tree_flatten(jax.tree.map(np.asarray, js.params)):
            got, ref = a[f"{pre}params/{k}"], _f32(w)
            if dtype == "float32":
                np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-4,
                                           err_msg=k)
                continue
            np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2 * lr_sum,
                                       err_msg=k)
            off = np.abs(got - ref) > 2e-4 + 2e-2 * np.abs(ref)
            assert off.mean() <= 0.01, (k, off.mean())


def test_podsync_state_round_trip():
    """The reference's pod-stacked state, one pod's slice in the port,
    and back through ``numpy_tree``."""
    tree = jax.tree.map(jnp.asarray, _ref_tree("bfloat16"))
    tree = jax.tree.map(lambda a: a.astype(jnp.bfloat16), tree)
    st = JTS.stack_for_podsync(JTS.TrainState(
        tree, JOPT.init(tree), JGC.init_ef(tree)), 2)
    ref = jax.tree.map(np.asarray, st)
    for pod in (0, 1):
        ts = convert.podsync_state(ref, pod, "cpu")
        assert int(ts.opt.step) == 0
        for got, want in ((ts.params, ref.params), (ts.opt.mu, ref.opt.mu),
                          (ts.ef.residuals, ref.ef.residuals)):
            want = dict(tree_flatten(want))
            for k, x in tree_flatten(got):
                assert tuple(x.shape) == (1,) + tuple(want[k].shape[1:]), k
                np.testing.assert_array_equal(_bits(x), _bits(
                    want[k][pod:pod + 1]))
        back = dict(tree_flatten(convert.numpy_tree(ts.params)))
        for k, w in tree_flatten(ref.params):
            np.testing.assert_array_equal(
                back[k], np.asarray(w[pod:pod + 1], np.float32))
    params = convert.lm_tree(jax.tree.map(np.asarray, tree), "cpu")
    local = TTS.stack_for_podsync(TTS.TrainState(
        params, TOPT.init(params), TGC.init_ef(params)), 2)
    for tree_ in (local.params, local.opt.mu, local.opt.nu,
                  local.ef.residuals):
        for x, p in zip(tree_leaves(tree_), tree_leaves(params)):
            assert tuple(x.shape) == (1,) + tuple(p.shape)
    for x, p in zip(tree_leaves(local.params), tree_leaves(params)):
        assert x.data_ptr() == p.data_ptr()          # a view: no copy


# --------------------------------------------------------------- re-mesh

COHORT8 = """
from repro_torch import convert
from repro_torch.dist import fault as F, sharding as S
mesh = M.make_mesh((4, 2), ("data", "model"))
tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
        "b": torch.arange(48, dtype=torch.bfloat16).reshape(6, 8),
        "n": {"v": torch.arange(8, dtype=torch.float32) - 3.5}}
axes = {"w": ("fsdp", "model"), "b": ("fsdp", "model"), "n": {"v": (None,)}}
with S.use_mesh(mesh):
    placed = F.remesh_state(tree, axes, mesh)
save("placements_w", [p.dim if p.is_shard() else -1
                      for p in placed["w"].placements])
save("placements_b", [p.dim if p.is_shard() else -1
                      for p in placed["b"].placements])
save("local_w", placed["w"].to_local())
save("local_b", placed["b"].to_local())
small = F.shrink_mesh(mesh, "data", 2)
with S.use_mesh(small):
    replaced = F.remesh_state(placed, axes, small)
if small.get_coordinate() is not None:
    save("small_data", S.axis_sizes(replaced["w"].device_mesh)["data"])
    for k, v in convert.numpy_tree(replaced).items():
        if isinstance(v, dict):
            for k2, v2 in v.items():
                save(f"full_{k}_{k2}", v2)
        else:
            save(f"full_{k}", v)
else:
    save("outside", replaced["w"].to_local().numel())
error("bad_axis", lambda: F.shrink_mesh(mesh, "pod", 1))
error("bad_size", lambda: F.shrink_mesh(mesh, "data", 5))
"""


@pytest.fixture(scope="module")
def cohort8(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("cohort8"), COHORT8, 8, {})


def test_elastic_remesh(cohort8):
    """``tests/test_dist.py::test_elastic_remesh`` on 8 gloo ranks: a 4 x 2
    mesh, then its data axis shrunk to 2; values bit-exact, each rank's
    block the one its coordinates name; the reference's two errors."""
    w = np.arange(64, dtype=np.float32).reshape(8, 8)
    b = np.arange(48, dtype=np.float32).reshape(6, 8)
    for rank, (saved, errors) in enumerate(cohort8):
        d, m = divmod(rank, 2)
        assert list(saved["placements_w"]) == [0, 1]       # Shard(0), Shard(1)
        # 6 rows do not divide the 4-way data axis: replicated there
        assert list(saved["placements_b"]) == [-1, 1]

        np.testing.assert_array_equal(saved["local_w"],
                                      w[2 * d:2 * d + 2, 4 * m:4 * m + 4])
        np.testing.assert_array_equal(saved["local_b"], b[:, 4 * m:4 * m + 4])
        if rank < 4:
            assert int(saved["small_data"]) == 2
            np.testing.assert_array_equal(saved["full_w"], w)
            np.testing.assert_array_equal(saved["full_b"], b)
            np.testing.assert_array_equal(saved["full_n_v"],
                                          np.arange(8) - 3.5)
        else:
            assert int(saved["outside"]) == 0
        assert errors["bad_axis"][0] == "ValueError"
        assert "not 'pod'" in errors["bad_axis"][1]
        assert errors["bad_size"][0] == "ValueError"
        assert "outside [1, 4]" in errors["bad_size"][1]


# ----------------------------------------------------------------- remat

@pytest.mark.parametrize("arch", ["granite-3-2b", "phi3.5-moe-42b-a6.6b",
                                  "hymba-1.5b"])
def test_remat_policies_bitequal(arch, monkeypatch):
    """``REPRO_REMAT=dots`` and ``tp_outs`` keep products (every one
    inside a layer, or the two ``tp_ar_out`` ones) instead of
    recomputing them: the gradients are ``full``'s bits."""
    from repro_torch.models import causal_lm as TCLM
    from repro_torch.data.tokens import make_data_iter
    cfg = TB.get_smoke(arch)
    state = TTS.init_state(cfg, torch.Generator().manual_seed(0))
    batch = make_data_iter(cfg, 4, 32, device="cpu")(0)
    kept = {}
    for name in ("_save_dots", "_save_tp_outs"):
        orig = getattr(TCLM, name)

        def spy(ctx, op, *a, _orig=orig, _name=name, **k):
            out = _orig(ctx, op, *a, **k)
            kept[_name] = kept.get(_name, 0) + int(
                "MUST_SAVE" in str(out) and not ctx.is_recompute)
            return out
        monkeypatch.setattr(TCLM, name, spy)
    out = {}
    for mode in ("full", "dots", "tp_outs"):
        monkeypatch.setenv("REPRO_REMAT", mode)
        out[mode] = TTS._grads(cfg, state.params, batch, 2)
    n_layers = cfg.num_layers
    # at least attention's output projection, a layer a microbatch
    assert kept["_save_dots"] > kept["_save_tp_outs"] >= n_layers * 2
    for mode in ("dots", "tp_outs"):
        assert torch.equal(out[mode][0], out["full"][0])
        for x, y in zip(tree_leaves(out[mode][1]), tree_leaves(out["full"][1])):
            assert torch.equal(x, y), mode


# ---------------------------------------------------------------- launch

def test_launch_train_mesh_over_two_processes(tmp_path):
    """``launch.train --mesh 2x1`` over two gloo processes: rank 0 prints
    the summary and writes the checkpoints; ``--mesh 2x2`` raises the
    model axis's ``NotImplementedError`` before joining a group."""
    init = f"file://{tmp_path / 'init'}"
    ckpt = tmp_path / "ckpt"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--steps", "4", "--batch", "4", "--seq", "32",
         "--device", "cpu", "--mesh", "2x1", "--coordinator", init,
         "--num-processes", "2", "--process-id", str(r), "--backend", "gloo",
         "--ckpt-dir", str(ckpt)], env=_rank_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = _wait(procs, RANK_TIMEOUT_S)
    assert all(p.returncode == 0 for p in procs), outs
    assert outs[0][0].startswith("granite-3-2b: steps 0..3 loss "), outs[0]
    assert "loss" not in outs[1][0]
    assert sorted(p.name for p in ckpt.iterdir()) == [
        "step_00000001", "step_00000002", "step_00000003", "step_00000004"]
    from repro_torch.launch import train as LT
    with pytest.raises(NotImplementedError, match="'model' axis"):
        LT.main(["--arch", ARCH, "--smoke", "--mesh", "2x2", "--device",
                 "cpu"])


def test_only_the_model_axis_is_left_unported():
    """The only ``NotImplementedError`` in ``train/`` and ``launch/`` is
    the model axis's."""
    root = os.path.join(SRC, "repro_torch")
    found = []
    for sub in ("launch", "train"):
        for name in sorted(os.listdir(os.path.join(root, sub))):
            if name.endswith(".py"):
                text = open(os.path.join(root, sub, name)).read()
                found += [(sub, name)] * text.count("NotImplementedError(")
    assert found == [("launch", "train.py"), ("train", "train_step.py")], found
    assert "'model' axis" in TTS.ACROSS_CARDS and "next slice" in \
        TTS.ACROSS_CARDS
