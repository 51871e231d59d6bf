"""The port's checkpoints and training loop (``repro_torch.ckpt``,
``repro_torch.train.loop``) against the reference on the CPU.

Inputs are numpy arrays made from a seed; reference parameters and CR
predictors are carried into the port with ``convert``.  Both packages
write the same layout (``step_%08d/``, ``manifest.json``, ``.npz`` with
bfloat16 stored as float32, pickled ``.lossy`` payloads, ``COMMITTED``),
so a checkpoint written by either loads in the other.

Bounds:

* manifests of the same parameters under the same policy and carried
  predictors: keys, files, codecs, eps, metered and raw bytes and
  achieved CR equal; predicted CR rtol 1e-4 (the SVD-truncation feature's
  Gram sums in another order: rtol 1e-5 on the features, and the spline
  magnifies it);
* loads across the packages: bit-equal tensors (raw and lossy payloads
  are the same float32 values);
* a restart from step 4 of 8 == the uninterrupted run, bit for bit on
  the CPU (the reference's bound, rtol 1e-5 / atol 1e-6, is
  ``tests/test_train.py:105``);
* the lossy error: ``rel_eb`` x range + a bfloat16 re-cast ulp per
  tensor, ``tests/test_train.py``'s bound (a constant tensor, whose eb
  the reference floors at 1e-12, reproduces the reference's
  reconstruction instead).
"""
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import compressors as JC  # noqa: E402
from repro.ckpt import checkpoint as JCK  # noqa: E402
from repro.configs import base as RB  # noqa: E402
from repro.core import pipeline as JPL  # noqa: E402
from repro.data import scientific as JS  # noqa: E402
from repro.models import model as RM  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.ckpt import checkpoint as TCK  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.data import tokens as TT  # noqa: E402
from repro_torch.models.params import tree_flatten, tree_leaves  # noqa: E402
from repro_torch.train import grad_compress as TGC  # noqa: E402
from repro_torch.train import loop as TLOOP  # noqa: E402
from repro_torch.train import optimizer as TOPT  # noqa: E402
from repro_torch.train import train_step as TTS  # noqa: E402

from test_torch_usecases import export_cr_model  # noqa: E402

CFG = TB.get_smoke("granite-3-2b")
RCFG = RB.get_smoke("granite-3-2b")


def ref_params(seed: int = 0):
    return jax.tree.map(np.asarray,
                        RM.init_params(RCFG, jax.random.PRNGKey(seed)))


def _step(compress=None, lr=3e-3):
    return TTS.make_train_step(CFG, TOPT.AdamWConfig(lr=lr, warmup_steps=10),
                               compress=compress, remat=False)


def _state(compress=False):
    return TTS.init_state(CFG, torch.Generator().manual_seed(0),
                          compress=compress)


def _it():
    return TT.make_data_iter(CFG, batch=4, seq=32, device="cpu")


@pytest.fixture(scope="module")
def predictors():
    """UC2's recipe (``tests/test_system.py``): sz3-lorenzo and zfp CR
    models trained on miranda-vx slices by the reference, carried
    across."""
    slices = JS.field_slices("miranda-vx", count=12, n=96)
    rng = float(jnp.max(slices) - jnp.min(slices))
    eps = 1e-4 * rng
    ref, port = {}, {}
    for name in ("sz3-lorenzo", "zfp"):
        comp = JC.get(name)
        crs = jnp.asarray([comp.cr(s, eps) for s in slices])
        ref[name] = JPL.CRPredictor.train(slices, crs, eps)
        port[name] = convert.cr_predictor(
            export_cr_model(ref[name].model, eps, 2),
            dataclasses.asdict(ref[name].cfg), device="cpu")
    return ref, port


# ---------------------------------------------------------------- layout

def test_leaf_paths_and_pack2d_equal_reference():
    tree = {"params": ref_params(), "mu": {"a": np.zeros((3, 5), np.float32)}}
    want = JCK._leaf_paths(tree)
    got = TCK._leaf_paths(convert.lm_tree(tree, "cpu"))
    assert list(got) == list(want)
    for n in (4096 * 3, 2048 * 5, 64 * 7, 1000, 63, 8192 * 4096):
        a = np.zeros(n, np.uint8) if n < 10 ** 6 else None
        shape = (JCK._pack2d(a).shape if a is not None
                 else (n // 4096, 4096))
        assert tuple(TCK._pack2d(torch.empty(n, dtype=torch.uint8)).shape) \
            == shape, n


# ------------------------------------- the reference's tests on the port

def test_checkpoint_restart_bitwise(tmp_path):
    d = str(tmp_path)
    it = _it()
    step = _step()
    lc = TLOOP.LoopConfig(total_steps=8, ckpt_every=4, ckpt_dir=d)
    sA, resA = TLOOP.run(CFG, _state(), step, it, lc)
    # restart from step 4 (fresh state object) and continue to 8
    shutil.rmtree(f"{d}/step_00000008")
    lcB = TLOOP.LoopConfig(total_steps=8, ckpt_every=4, ckpt_dir=d)
    sB, resB = TLOOP.run(CFG, _state(), step, it, lcB)
    assert resB.restarts == 1 and sorted(resB.losses) == [4, 5, 6, 7]
    assert int(sB.opt.step) == 8
    for a, b in zip(tree_leaves(sA.params), tree_leaves(sB.params)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert torch.equal(a, b)
    for k in (4, 5, 6, 7):
        assert resA.losses[k] == resB.losses[k]


def test_restart_takes_the_checkpoints_step_and_fresh_residuals(tmp_path):
    """With compression: the optimizer's step is the checkpoint's and the
    error-feedback residuals are the fresh state's (not checkpointed)."""
    d = str(tmp_path)
    step = _step(compress=TGC.CompressConfig(gate_ratio=0.0))
    lc = TLOOP.LoopConfig(total_steps=3, ckpt_every=3, ckpt_dir=d)
    s, _ = TLOOP.run(CFG, _state(compress=True), step, _it(), lc)
    assert any(r.any() for r in tree_leaves(s.ef.residuals))
    seen = {}

    def spy(state, batch):
        seen.setdefault("step", int(state.opt.step))
        seen.setdefault("ef", [r.clone() for r in tree_leaves(state.ef.residuals)])
        return step(state, batch)

    lc4 = TLOOP.LoopConfig(total_steps=4, ckpt_every=4, ckpt_dir=d)
    TLOOP.run(CFG, _state(compress=True), spy, _it(), lc4)
    assert seen["step"] == 3
    assert not any(r.any() for r in seen["ef"])


def test_failure_recovery_completes(tmp_path):
    it = _it()
    step = _step()
    lc = TLOOP.LoopConfig(total_steps=10, ckpt_every=3, ckpt_dir=str(tmp_path),
                          failure_prob=0.2, failure_seed=5)
    state, res = TLOOP.run_with_recovery(CFG, _state, step, it, lc)
    assert res.restarts >= 1
    assert 9 in res.losses                  # reached the final step


def test_lossy_checkpoint_policy(tmp_path):
    d = str(tmp_path)
    state = _state()
    pol = TCK.LossyPolicy(enabled=True, rel_eb=1e-4, min_size=4096,
                          device="cpu")
    man = TCK.save(d, 0, state.params, pol)
    lossy = [k for k, t in man["tensors"].items() if t["codec"] != "raw"]
    raw = [k for k, t in man["tensors"].items() if t["codec"] == "raw"]
    assert lossy and raw                     # policy splits by size
    restored = TCK.load(d, 0, state.params)
    for k, t in man["tensors"].items():
        if t["codec"] != "raw":
            assert t["achieved_cr"] > 1.0
    flat_o = TCK._leaf_paths(state.params)
    flat_r = TCK._leaf_paths(restored)
    for k in lossy:
        o = flat_o[k].float().numpy()
        r = flat_r[k].float().numpy()
        rng = o.max() - o.min()
        # rel_eb bound + bf16 re-cast ulp (bf16 params stored via f32)
        slack = 1.1e-4 * rng + np.max(np.abs(o)) * 2.0 ** -8
        assert np.max(np.abs(o - r)) <= slack, k
    for k in raw:
        assert torch.equal(flat_o[k], flat_r[k]), k


def test_async_checkpointer(tmp_path):
    d = str(tmp_path)
    state = _state()
    ck = TCK.AsyncCheckpointer(d)
    ck.submit(1, state.params)
    ck.wait()
    ck.close()
    assert TCK.latest_step(d) == 1


def test_async_checkpointer_raises_a_failed_save(tmp_path):
    """A save that fails surfaces in ``wait`` instead of hanging it."""
    ck = TCK.AsyncCheckpointer(str(tmp_path), TCK.LossyPolicy(
        enabled=True, min_size=1, compressor="no-such-codec", device="cpu"))
    ck.submit(1, {"w": torch.ones(64)})
    with pytest.raises(KeyError):
        ck.wait()
    ck.close()
    assert TCK.latest_step(str(tmp_path)) is None


def test_uc2_driven_lossy_checkpoint(tmp_path, predictors):
    """Train briefly, then checkpoint with the paper's UC2 predictor
    choosing the compressor per tensor -- predicted CR recorded
    (``tests/test_system.py``)."""
    state = _state()
    step = TTS.make_train_step(CFG, TOPT.AdamWConfig(lr=1e-3), remat=False)
    it = _it()
    for i in range(5):
        state, _ = step(state, it(i))
    pol = TCK.LossyPolicy(enabled=True, rel_eb=1e-4, min_size=4096,
                          predictors=predictors[1], device="cpu")
    man = TCK.save(str(tmp_path), 0, state.params, pol)
    lossy = {k: t for k, t in man["tensors"].items() if t["codec"] != "raw"}
    assert lossy
    for k, t in lossy.items():
        assert t["predicted_cr"] is not None
        assert t["codec"] in predictors[1]
    restored = TCK.load(str(tmp_path), 0, state.params)
    state2 = TTS.TrainState(restored, state.opt, None)
    state2, m = step(state2, it(6))
    assert bool(torch.isfinite(m["loss"]))


# ---------------------------------------------------------------- parity

@pytest.mark.parametrize("uc2", [False, True])
def test_manifest_equals_reference(tmp_path, predictors, uc2):
    """The same parameters under the same policy: the same manifest."""
    tree = {"params": ref_params(), "mu": jax.tree.map(
        lambda a: np.asarray(a, np.float32) * 0.5, ref_params(1))}
    jpol = JCK.LossyPolicy(enabled=True, rel_eb=1e-4, min_size=4096,
                           predictors=predictors[0] if uc2 else None)
    tpol = TCK.LossyPolicy(enabled=True, rel_eb=1e-4, min_size=4096,
                           predictors=predictors[1] if uc2 else None,
                           device="cpu")
    want = JCK.save(str(tmp_path / "ref"), 2, tree, jpol)
    got = TCK.save(str(tmp_path / "port"), 2, convert.lm_tree(tree, "cpu"),
                   tpol)
    assert got["step"] == want["step"] == 2
    assert list(got["tensors"]) == list(want["tensors"])
    n_lossy = 0
    for k, w in want["tensors"].items():
        g = got["tensors"][k]
        assert set(g) == set(w), k
        for field in ("file", "codec", "eps", "metered_bytes", "raw_bytes",
                      "achieved_cr", "dtype", "shape"):
            assert g.get(field) == w.get(field), (k, field)
        if w["codec"] != "raw":
            n_lossy += 1
            if uc2:
                np.testing.assert_allclose(g["predicted_cr"],
                                           w["predicted_cr"], rtol=1e-4)
            else:
                assert g["predicted_cr"] is w["predicted_cr"] is None
    assert n_lossy >= 6
    assert sorted(os.listdir(tmp_path / "port" / "step_00000002")) == \
        sorted(os.listdir(tmp_path / "ref" / "step_00000002"))
    with open(tmp_path / "port" / "step_00000002" / "manifest.json") as f:
        assert json.load(f)["tensors"] == got["tensors"]


def test_checkpoints_load_across_packages(tmp_path):
    """Each package loads the other's checkpoint (raw and lossy leaves,
    bfloat16 and float32) to the same tensors as its own."""
    tree = {"params": ref_params(), "mu": jax.tree.map(
        lambda a: np.asarray(a, np.float32) * 0.5, ref_params(1))}
    jpol = JCK.LossyPolicy(enabled=True, rel_eb=1e-4, min_size=4096)
    tpol = TCK.LossyPolicy(enabled=True, rel_eb=1e-4, min_size=4096,
                           device="cpu")
    JCK.save(str(tmp_path / "ref"), 1, tree, jpol)
    TCK.save(str(tmp_path / "port"), 1, convert.lm_tree(tree, "cpu"), tpol)
    like_j = jax.tree.map(jnp.asarray, tree)
    like_t = convert.lm_tree(tree, "cpu")
    for d in ("ref", "port"):
        j = dict(tree_flatten(jax.tree.map(
            np.asarray, JCK.load(str(tmp_path / d), 1, like_j))))
        t = dict(tree_flatten(TCK.load(str(tmp_path / d), 1, like_t)))
        assert list(j) == list(t)
        for k in j:
            assert t[k].dtype == convert.array(j[k], "cpu").dtype, (d, k)
            assert torch.equal(t[k], convert.array(j[k], "cpu")), (d, k)
    # and the two checkpoints hold the same values
    a = dict(tree_flatten(TCK.load(str(tmp_path / "ref"), 1, like_t)))
    b = dict(tree_flatten(TCK.load(str(tmp_path / "port"), 1, like_t)))
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_convert_train_state_carries_the_reference_state():
    from repro.train import train_step as JTS
    from repro.train import grad_compress as JGC
    p = jax.tree.map(jnp.asarray, ref_params())
    js = JTS.TrainState(p, JTS.OPT.init(p), JGC.init_ef(p))
    js = js._replace(opt=js.opt._replace(step=jnp.int32(7)))
    ts = convert.train_state(jax.tree.map(np.asarray, js), "cpu")
    assert int(ts.opt.step) == 7 and ts.opt.step.device.type == "cpu"
    for got, want in ((ts.params, js.params), (ts.opt.mu, js.opt.mu),
                      (ts.ef.residuals, js.ef.residuals)):
        for (k, a), (_, b) in zip(tree_flatten(got), tree_flatten(
                jax.tree.map(np.asarray, want))):
            assert torch.equal(a, convert.array(b, "cpu")), k
    none = convert.train_state(jax.tree.map(np.asarray, js._replace(ef=None)),
                               "cpu")
    assert none.ef is None


def test_constant_tensor_follows_the_reference_eb_floor(tmp_path):
    """A constant tensor's range is 0, so both packages floor its eb to
    1e-12: sz3-lorenzo's codes then pass int32 and the reconstruction is
    far off (a reference fault, ROADMAP Queue 3); the port writes the
    same manifest entry and payload."""
    tree = {"norm": np.ones((2, 2048), np.float32)}
    man_j = JCK.save(str(tmp_path / "ref"), 0, tree, JCK.LossyPolicy(
        enabled=True, min_size=4096))
    man_t = TCK.save(str(tmp_path / "port"), 0, convert.lm_tree(tree, "cpu"),
                     TCK.LossyPolicy(enabled=True, min_size=4096,
                                     device="cpu"))
    for f in ("codec", "eps", "metered_bytes", "achieved_cr"):
        assert man_t["tensors"]["norm"][f] == man_j["tensors"]["norm"][f], f
    assert man_t["tensors"]["norm"]["eps"] == 1e-12
    j = np.asarray(JCK.load(str(tmp_path / "ref"), 0, tree)["norm"])
    t = TCK.load(str(tmp_path / "port"), 0,
                 convert.lm_tree(tree, "cpu"))["norm"].numpy()
    assert np.array_equal(j, t)
    assert np.abs(t - 1.0).max() > 0.5
