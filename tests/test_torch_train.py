"""The port's LLM training (``repro_torch.train``, ``models.causal_lm``'s
loss and backward, ``data.tokens``, ``launch.train``) against the
reference on the CPU.

Inputs are numpy arrays made from a seed; the reference runs as its own
tests run it (``jax.jit`` of ``TS.make_train_step`` and of its parts)
and its parameters and state are carried into the port with
``convert.lm_tree`` / ``convert.train_state``.  The port's own runs use
``remat=False`` where a test takes many steps (the CPU's checkpointing
costs ~5x a step); ``test_remat_changes_no_bit`` holds remat to the
plain backward bit for bit.

Bounds:

* bit-equal: ``compress_tree``'s sent gradients, residuals and
  predicted CRs (the jitted size model: ``counts * f32(1/n)``, the size
  as one FMA, the residual as ``fma(-code, scale, g)``), and
  ``OPT.apply``'s parameters and moments with the clip inactive (XLA's
  three contracted multiply-adds, exactly rounded, a correctly rounded
  square root, ``powf`` on the host); int8 codes and scales;
* float32 loss and gradients: rtol 1e-5, atol 1e-5 of the leaf's
  largest |value| (summation orders differ); the RMSNorm backward and
  the chunked cross-entropy alike;
* a bfloat16 model's loss: rtol 1e-3 (its logits differ by a few
  bfloat16 ulps, ``tests/test_torch_models.py``; 3.6e-4 seen);
* bfloat16 gradients: within 16 bfloat16 ulps of the leaf's largest
  |value|, and no farther from the float32 gradient than 1.5x the
  reference's own bfloat16 gradient plus 2 ulps (the libraries round
  products, reductions and bias sums at different points);
* whole steps (three steps, plain and compressed, microbatches 1 and 4,
  in float32; two of the four in bfloat16): losses rtol 1e-4 (bfloat16: 1e-3, as above)
  and every parameter leaf rtol 2e-2 / atol 2e-4, the reference's own
  bounds for two computations of one step (``tests/test_train.py:50-55``,
  which holds the first leaf).  In bfloat16 a near-zero gradient whose
  sign the two libraries' roundings flip moves the runs +lr and -lr
  (0.02-0.2 % of embed's and lm_head's entries): there at most 1 % of a
  leaf's entries may pass the reference's bound, none the two runs'
  largest possible Adam gap, 2 sum(lr);
* the ported ``tests/test_train.py`` cases at the reference's bounds.
"""
import contextlib
import dataclasses
import functools
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as RB  # noqa: E402
from repro.models import causal_lm as RCLM  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.train import grad_compress as JGC  # noqa: E402
from repro.train import optimizer as JOPT  # noqa: E402
from repro.train import train_step as JTS  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch import refmath  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.data import tokens as TT  # noqa: E402
from repro_torch.models import causal_lm as TCLM  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.params import tree_flatten, tree_leaves  # noqa: E402
from repro_torch.train import grad_compress as TGC  # noqa: E402
from repro_torch.train import optimizer as TOPT  # noqa: E402
from repro_torch.train import train_step as TTS  # noqa: E402

DENSE = ["granite-3-2b", "granite-8b", "stablelm-3b", "codeqwen1.5-7b"]
CFG = TB.get_smoke("granite-3-2b")
RCFG = RB.get_smoke("granite-3-2b")
F32_RTOL = 1e-5
BF16_ULPS = 16
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def bits(x) -> np.ndarray:
    """A tensor's or array's bit patterns as integers."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.view({4: torch.int32, 1: torch.int8}[x.element_size()]
                      ).numpy()
    x = np.asarray(x)
    return x.view({4: np.int32, 2: np.int16, 1: np.int8}[x.itemsize])


def bf16_ulp(m: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(m, 2.0 ** -126))) - 7)


def assert_f32_close(got, want, what=""):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=F32_RTOL,
                               atol=F32_RTOL * scale, err_msg=what)


def t(x) -> torch.Tensor:
    return convert.array(x, "cpu")


def ref_tree(cfg, dtype: str, seed: int = 0):
    """The reference's parameters in ``dtype`` as numpy, norms and biases
    perturbed (their inits are constants)."""
    dt = jnp.dtype(dtype)
    tree = jax.tree.map(lambda a: np.asarray(a.astype(dt)),
                        RM.init_params(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    seg = tree["seg0"]
    for k in ("norm1", "norm2"):
        seg[k] = (1 + 0.1 * rng.standard_normal(seg[k].shape)).astype(dt)
    for k in ("bq", "bk", "bv"):
        if k in seg["attn"]:
            seg["attn"][k] = (0.1 * rng.standard_normal(
                seg["attn"][k].shape)).astype(dt)
    return tree


def token_batch(cfg, b: int, s: int, seed: int = 1) -> dict:
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def tbatch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _ref_grads_fn(rcfg, microbatches):
    return jax.jit(lambda p, b: JTS._grads(rcfg, p, b, microbatches))


def ref_grads(rcfg, tree, batch, microbatches=1):
    """``jax.jit`` of the reference's ``_grads`` (one compile per config)."""
    return _ref_grads_fn(rcfg, microbatches)(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch))


# ---------------------------------------------------------------- layers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_forward_and_backward(dtype):
    """Forward bits unchanged (the serving path's), ``dx`` in x's dtype and
    ``dgamma`` in gamma's, against ``jax.vjp`` of the custom VJP."""
    rng = np.random.default_rng(2)
    dt = jnp.dtype(dtype)
    x = rng.standard_normal((2, 5, 64)).astype(dt)
    g = (1 + 0.1 * rng.standard_normal(64)).astype(dt)
    ct = rng.standard_normal((2, 5, 64)).astype(dt)
    want_y, vjp = jax.vjp(jax.jit(RL.rms_norm), jnp.asarray(x), jnp.asarray(g))
    want_dx, want_dg = jax.jit(vjp)(jnp.asarray(ct))
    tx, tg = t(x).requires_grad_(), t(g).requires_grad_()
    y = TL.rms_norm(tx, tg)
    dx, dg = torch.autograd.grad(y, (tx, tg), t(ct))
    with torch.no_grad():
        plain = TL.rms_norm(t(x), t(g))
    assert torch.equal(y.detach(), plain)            # one forward, both ways
    assert (dx.dtype, dg.dtype) == (tx.dtype, tg.dtype)
    for what, got, want in (("y", y, want_y), ("dx", dx, want_dx),
                            ("dgamma", dg, want_dg)):
        if dtype == "float32":
            assert_f32_close(got, want, what)
        else:
            err = float(np.abs(f32(got) - f32(want)).max())
            tol = 4 * bf16_ulp(float(np.abs(f32(want)).max()))
            assert err <= tol, (what, err, tol)


@pytest.mark.parametrize("s", [40, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xent_loss(dtype, s):
    """The chunked cross-entropy on the same hidden states: one chunk
    (s < 512) and two; float32 rtol 1e-5, bfloat16 rtol 1e-4 (one
    bfloat16 product rounded apart moves a logit by an ulp)."""
    rng = np.random.default_rng(s)
    dt = jnp.dtype(dtype)
    hid = rng.standard_normal((2, s, 64)).astype(dt)
    w = (rng.standard_normal((64, 384)) / 8).astype(dt)
    lab = rng.integers(0, 384, (2, s)).astype(np.int32)
    want = jax.jit(lambda h, w, y: RCLM.xent_loss({"lm_head": w}, h, y, 384))(
        hid, w, lab)
    got = TCLM.xent_loss({"lm_head": t(w)}, t(hid), t(lab), 384)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want),
                               rtol=1e-5 if dtype == "float32" else 1e-4)


# ---------------------------------------------------------------- gradients

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_every_gradient_leaf(arch, dtype):
    tcfg = dataclasses.replace(TB.get_smoke(arch), dtype=dtype)
    rcfg = dataclasses.replace(RB.get_smoke(arch), dtype=dtype)
    tree = ref_tree(rcfg, dtype)
    batch = token_batch(rcfg, 4, 32)
    jl, jg = ref_grads(rcfg, tree, batch)
    tl, tg = TTS._grads(tcfg, convert.lm_tree(tree, "cpu"), tbatch(batch), 1)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL[dtype])
    want = dict(tree_flatten(jax.tree.map(np.asarray, jg)))
    got = dict(tree_flatten(tg))
    assert list(got) == list(want)
    if dtype == "float32":
        for k in want:
            assert got[k].dtype == torch.float32, k
            assert_f32_close(got[k], want[k], k)
        return
    # bfloat16: against the float32 gradient of the same (rounded) weights
    ref32 = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    _, j32 = ref_grads(dataclasses.replace(rcfg, dtype="float32"), ref32, batch)
    want32 = dict(tree_flatten(jax.tree.map(np.asarray, j32)))
    for k in want:
        assert got[k].dtype == torch.bfloat16, k
        g, w, w32 = f32(got[k]), f32(want[k]), want32[k]
        ulp = bf16_ulp(float(np.abs(w).max()))
        err = float(np.abs(g - w).max())
        assert err <= BF16_ULPS * ulp, (k, err, BF16_ULPS * ulp)
        e_port = float(np.abs(g - w32).max())
        e_ref = float(np.abs(w - w32).max())
        assert e_port <= 1.5 * e_ref + 2 * ulp, (k, e_port, e_ref)


def test_remat_changes_no_bit():
    tree = convert.lm_tree(ref_tree(RCFG, "bfloat16"), "cpu")
    batch = tbatch(token_batch(RCFG, 4, 32))
    la, ga = TTS._grads(CFG, tree, batch, 1, remat=True)
    lb, gb = TTS._grads(CFG, tree, batch, 1, remat=False)
    assert torch.equal(la, lb)
    for a, b in zip(tree_leaves(ga), tree_leaves(gb)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- compress

@functools.lru_cache(maxsize=None)
def _ref_grads_np(dtype: str, microbatches: int):
    rcfg = dataclasses.replace(RCFG, dtype=dtype)
    _, g = ref_grads(rcfg, ref_tree(rcfg, dtype), token_batch(rcfg, 4, 32),
                     microbatches)
    return jax.tree.map(np.asarray, g)


@pytest.mark.parametrize("dtype,mb", [("bfloat16", 1), ("float32", 4)])
def test_compress_tree_bitequal(dtype, mb):
    """The reference's gradients (bfloat16 from one microbatch, float32
    sums from four) plus random residuals, a constant leaf and a ragged
    one, at gates 2.0, 6.6 and 0.0: sent gradients, residuals and CRs
    bit for bit, in and out of place.  At 6.6 some leaves gate and some
    do not; an ungated leaf's residual is exactly zero."""
    grads = dict(_ref_grads_np(dtype, mb))
    rng = np.random.default_rng(3)
    gdt = grads["embed"].dtype
    grads["extra"] = {"const": np.full((3, 100), 0.25, gdt),
                      "ragged": (rng.standard_normal(1001) * 1e-2).astype(gdt)}
    res = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 1e-4
                                  ).astype(np.float32), grads)
    for gate in (2.0, 6.6, 0.0):
        cfg = JGC.CompressConfig(gate_ratio=gate)
        jg, je, jc = jax.jit(lambda g, r: JGC.compress_tree(
            g, JGC.EFState(r), cfg))(grads, res)
        gated = {k for k, c in tree_flatten(jax.tree.map(np.asarray, jc))
                 if c >= gate}
        if gate == 6.6:
            assert 0 < len(gated) < len(tree_leaves(grads))
        for inplace in (False, True):
            tg, te, tc = TGC.compress_tree(
                convert.lm_tree(grads, "cpu"),
                TGC.EFState(convert.lm_tree(res, "cpu")),
                TGC.CompressConfig(gate_ratio=gate), inplace=inplace)
            for name, got, want in (("sent", tg, jg),
                                    ("resid", te.residuals, je.residuals),
                                    ("cr", tc, jc)):
                want = dict(tree_flatten(jax.tree.map(np.asarray, want)))
                for k, x in tree_flatten(got):
                    assert np.array_equal(bits(x), bits(want[k])), \
                        (gate, name, k)
            for k, r in tree_flatten(te.residuals):
                if k not in gated:
                    assert not r.any(), (gate, k)


def test_jit_size_model_differs_from_eager_where_n_is_no_power_of_two():
    """Why the port has one size model: on a 3000-value leaf (3072
    codes) the reference's eager call and its jitted form (the one its
    gate, its service and ``compress_tree`` run) give different bits;
    the port's ``predicted_cr_int8`` and ``predicted_cr_jit`` of the
    leaf's code counts both give the jitted bits."""
    x = np.asarray(np.random.default_rng(1).standard_normal(3000) * 1e-3,
                   np.float32)
    eager = np.float32(JGC.predicted_cr_int8(jnp.asarray(x)))
    jitted = np.float32(jax.jit(JGC.predicted_cr_int8)(jnp.asarray(x)))
    assert eager != jitted
    codes, _ = TGC.quantize_int8(t(x))
    counts = TGC._code_counts(codes, TGC.DEFAULT_BINS)
    got_jit = TGC.predicted_cr_jit(counts, codes.numel(), codes.shape[0])
    assert bits(got_jit) == bits(np.float32(jitted))
    assert bits(TGC.predicted_cr_int8(t(x))) == bits(np.float32(jitted))


def test_int8_roundtrip_error_small():
    g = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4096,)) * 0.01)
    codes, scales = TGC.quantize_int8(t(g))
    deq = TGC.dequantize_int8(codes, scales, g.shape)
    assert float((deq - t(g)).abs().max()) <= float(np.abs(g).max()) / 100


def test_predicted_cr_gate_sane():
    sparse = np.zeros(8192, np.float32)
    sparse[::64] = 1.0
    dense = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (8192,)))
    cr_sparse = float(TGC.predicted_cr_int8(t(sparse)))
    cr_dense = float(TGC.predicted_cr_int8(t(dense)))
    assert cr_sparse > cr_dense
    assert cr_dense >= 3.5


# ---------------------------------------------------------------- AdamW

def _opt_inputs(dtype: str, seed: int):
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 64, 96), "b": (1000,), "c": {"d": (64,)}}
    mk = lambda f: jax.tree.map(f, shapes, is_leaf=lambda s: isinstance(
        s, tuple))
    p = mk(lambda s: rng.standard_normal(s).astype(jnp.dtype(dtype)))
    g = mk(lambda s: (rng.standard_normal(s) * 1e-3
                      * 10.0 ** rng.integers(-3, 1, s)).astype(np.float32))
    mu = mk(lambda s: (rng.standard_normal(s) * 1e-3).astype(np.float32))
    nu = mk(lambda s: (rng.random(s) * 1e-6).astype(np.float32))
    return p, g, mu, nu


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_apply_bitequal(dtype):
    """Clip inactive (norm < 1): parameters and moments bit for bit, at
    steps inside and past the warmup; the norm within float32 rtol."""
    for seed, step, cfg in ((0, 0, JOPT.AdamWConfig()),
                            (1, 5, JOPT.AdamWConfig(lr=1e-3, warmup_steps=10)),
                            (2, 99, JOPT.AdamWConfig()),
                            (3, 150, JOPT.AdamWConfig(lr=3e-3))):
        p, g, mu, nu = _opt_inputs(dtype, seed)
        jp, js, jn = jax.jit(lambda p, g, s: JOPT.apply(cfg, p, g, s))(
            p, g, JOPT.OptState(jnp.int32(step), mu, nu))
        for inplace in (False, True):
            tp, ts, tn = TOPT.apply(
                TOPT.AdamWConfig(**dataclasses.asdict(cfg)),
                convert.lm_tree(p, "cpu"), convert.lm_tree(g, "cpu"),
                TOPT.OptState(torch.tensor(step, dtype=torch.int32),
                              convert.lm_tree(mu, "cpu"),
                              convert.lm_tree(nu, "cpu")), inplace=inplace)
            assert int(ts.step) == step + 1 == int(js.step)
            assert float(jn) < 1.0
            np.testing.assert_allclose(float(tn), float(jn), rtol=F32_RTOL)
            for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
                want = dict(tree_flatten(jax.tree.map(np.asarray, want)))
                for k, x in tree_flatten(got):
                    assert np.array_equal(bits(x), bits(want[k])), (step, k)


def test_adamw_clip_active_within_float32():
    """Norm above the clip: the scale is a quotient of the norm, whose
    summation order differs, so the update meets float32 rtol."""
    p, g, mu, nu = _opt_inputs("float32", 4)
    g = jax.tree.map(lambda a: a * 1e4, g)
    cfg = JOPT.AdamWConfig(lr=1e-3, warmup_steps=1)
    jp, js, jn = jax.jit(lambda p, g, s: JOPT.apply(cfg, p, g, s))(
        p, g, JOPT.OptState(jnp.int32(3), mu, nu))
    tp, ts, tn = TOPT.apply(TOPT.AdamWConfig(**dataclasses.asdict(cfg)),
                            convert.lm_tree(p, "cpu"),
                            convert.lm_tree(g, "cpu"),
                            TOPT.OptState(torch.tensor(3, dtype=torch.int32),
                                          convert.lm_tree(mu, "cpu"),
                                          convert.lm_tree(nu, "cpu")))
    assert float(jn) > 1.0
    for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        want = dict(tree_flatten(jax.tree.map(np.asarray, want)))
        for k, x in tree_flatten(got):
            assert_f32_close(x, want[k], k)


def test_powf_is_xlas_scalar_pow():
    f = jax.jit(lambda b, s: b ** s.astype(jnp.float32))
    for b in (0.9, 0.95):
        for s in (1, 2, 7, 58, 99, 100, 101, 685, 1000, 3000):
            want = np.float32(f(np.float32(b), jnp.int32(s)))
            assert bits(np.float32(refmath.powf(b, s))) == bits(want), (b, s)


# ---------------------------------------------------------------- steps

def _ref_state(tree, compress: bool):
    p = jax.tree.map(jnp.asarray, tree)
    return JTS.TrainState(p, JOPT.init(p), JGC.init_ef(p) if compress
                          else None)


@pytest.mark.parametrize("compress,mb,dtype", [
    (False, 1, "float32"), (False, 4, "float32"), (True, 1, "float32"),
    (True, 4, "float32"), (False, 4, "bfloat16"), (True, 1, "bfloat16")])
def test_three_steps_equal_reference(compress, mb, dtype):
    rcfg = dataclasses.replace(RCFG, dtype=dtype)
    tree = ref_tree(rcfg, dtype)
    ccfg = JGC.CompressConfig() if compress else None
    ocfg = JOPT.AdamWConfig(lr=3e-3, warmup_steps=10)
    jstep = jax.jit(JTS.make_train_step(rcfg, ocfg, microbatches=mb,
                                        compress=ccfg))
    tstep = TTS.make_train_step(
        dataclasses.replace(CFG, dtype=dtype),
        TOPT.AdamWConfig(**dataclasses.asdict(ocfg)), microbatches=mb,
        compress=TGC.CompressConfig() if compress else None, remat=False)
    js = _ref_state(tree, compress)
    ts = convert.train_state(jax.tree.map(np.asarray, js), "cpu")
    for i in range(3):
        batch = token_batch(RCFG, 8, 32, seed=10 + i)
        js, jm = jstep(js, jax.tree.map(jnp.asarray, batch))
        ts, tm = tstep(ts, tbatch(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4 if dtype == "float32" else 1e-3)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=2e-2)
        if compress:
            np.testing.assert_allclose(float(tm["mean_pred_cr"]),
                                       float(jm["mean_pred_cr"]), rtol=2e-2)
    assert int(ts.opt.step) == int(js.opt.step) == 3
    want = dict(tree_flatten(jax.tree.map(np.asarray, js.params)))
    # bfloat16: a near-zero gradient (a rare token's embedding row or
    # logit column) whose sign the libraries' roundings flip becomes Adam
    # moves of +lr and -lr: at most 2 sum(lr) apart, on few entries
    lr_sum = sum(3e-3 * min(s / 10, 1.0) for s in (1, 2, 3))
    for k, x in tree_flatten(ts.params):
        got, ref = f32(x), f32(want[k])
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-4,
                                       err_msg=k)
            continue
        np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2 * lr_sum,
                                   err_msg=k)
        off = np.abs(got - ref) > 2e-4 + 2e-2 * np.abs(ref)
        assert off.mean() <= 0.01, (k, off.mean())


# ------------------------------------- the reference's tests on the port

def _step(compress=None, microbatches=1, lr=3e-3, remat=False):
    return TTS.make_train_step(CFG, TOPT.AdamWConfig(lr=lr, warmup_steps=10),
                               microbatches=microbatches, compress=compress,
                               remat=remat)


def _state(compress=False):
    return TTS.init_state(CFG, torch.Generator().manual_seed(0),
                          compress=compress)


def test_loss_decreases():
    state = _state()
    step = _step()
    it = TT.make_data_iter(CFG, batch=8, seq=64, device="cpu")
    first = last = None
    for i in range(30):
        state, m = step(state, it(i % 4))  # few batches -> memorizable
        if first is None:
            first = float(m["loss"])
        last = float(m["loss"])
    assert last < first - 0.3, (first, last)


def test_microbatching_matches_full_batch():
    """Grad accumulation must equal the single big batch (linearity)."""
    state = _state()
    batch = TT.make_data_iter(CFG, batch=8, seq=32, device="cpu")(0)
    s1, m1 = _step(microbatches=1)(state, batch)
    s4, m4 = _step(microbatches=4)(state, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-4)
    l1 = tree_leaves(s1.params)[0].float().numpy()
    l4 = tree_leaves(s4.params)[0].float().numpy()
    np.testing.assert_allclose(l1, l4, rtol=2e-2, atol=2e-4)


def test_compressed_training_converges():
    """int8 + error feedback training tracks uncompressed training."""
    it = TT.make_data_iter(CFG, batch=8, seq=64, device="cpu")

    def run(compress):
        state = _state(compress=compress is not None)
        step = _step(compress=compress)
        for i in range(25):
            state, m = step(state, it(i % 4))
        return float(m["loss"])

    plain = run(None)
    comp = run(TGC.CompressConfig(enabled=True, gate_ratio=0.0))
    assert abs(comp - plain) < 0.5, (plain, comp)


@pytest.mark.parametrize("arch", DENSE)
def test_smoke_forward_and_loss(arch):
    cfg = TB.get_smoke(arch)
    params = TM.init_tree(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32))
    loss = TM.loss_fn(params, {"tokens": toks, "labels": toks}, cfg)
    assert loss.shape == ()
    assert bool(torch.isfinite(loss)), arch
    assert 1.0 < float(loss) < 20.0, (arch, float(loss))


@pytest.mark.parametrize("arch", DENSE)
def test_smoke_train_step(arch):
    cfg = TB.get_smoke(arch)
    state = TTS.init_state(cfg, torch.Generator().manual_seed(0))
    step = TTS.make_train_step(cfg, microbatches=2)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32))
    state2, metrics = step(state, {"tokens": toks, "labels": toks})
    assert bool(torch.isfinite(metrics["loss"]))
    assert bool(torch.isfinite(metrics["grad_norm"]))
    d0 = tree_leaves(state.params)[0]
    d1 = tree_leaves(state2.params)[0]
    assert not bool(torch.all(d0 == d1)), arch


def test_donated_step_equals_plain_step():
    """``donate=True`` writes the same bits over the input state."""
    tree = ref_tree(RCFG, "bfloat16")
    batch = tbatch(token_batch(RCFG, 8, 32))
    out = []
    for donate in (False, True):
        state = convert.train_state(
            jax.tree.map(np.asarray, _ref_state(tree, True)), "cpu")
        step = TTS.make_train_step(CFG, microbatches=2,
                                   compress=TGC.CompressConfig(),
                                   donate=donate, remat=False)
        new, m = step(state, batch)
        same = tree_leaves(new.params)[0] is tree_leaves(state.params)[0]
        assert same == donate
        out.append((new, m))
    (a, ma), (b, mb) = out
    assert torch.equal(ma["loss"], mb["loss"])
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


def test_across_cards_raises_naming_the_roadmap_item():
    """The ``model`` axis (the next slice, ROADMAP Queue 1 item 7) raises;
    the ``pod`` and ``data`` axes run: on a 1 x 1 x 1 mesh the
    uncompressed podsync step is the plain step bit for bit
    (``tests/test_torch_across_cards.py`` runs them across processes)."""
    from repro_torch.dist import sharding as S
    model = S.AbstractMesh((1, 1, 2), ("pod", "data", "model"))
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        TTS.make_train_step(CFG, mode="podsync", mesh=model)
    with pytest.raises(NotImplementedError, match="'model' axis"):
        TTS.make_train_step(CFG, mesh=S.AbstractMesh((1, 2),
                                                     ("data", "model")))
    with pytest.raises(ValueError, match="not a mesh with named axes"):
        TTS.make_train_step(CFG, mesh=object())
    from repro_torch.launch import train as LT
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        LT.main(["--arch", "granite-3-2b", "--smoke", "--mesh", "2x2",
                 "--device", "cpu"])
    one = S.AbstractMesh((1, 1, 1), ("pod", "data", "model"))
    batch = TT.make_data_iter(CFG, batch=4, seq=32, device="cpu")(0)
    plain, pm = _step()(_state(), batch)
    stacked = TTS.stack_for_podsync(_state(), 1)
    assert all(x.shape[0] == 1 for x in tree_leaves(stacked.params))
    pod, qm = TTS.make_train_step(
        CFG, TOPT.AdamWConfig(lr=3e-3, warmup_steps=10), mode="podsync",
        mesh=one, remat=False)(stacked, batch)
    assert torch.equal(pm["loss"], qm["loss"])
    for x, y in zip(tree_leaves(plain.params), tree_leaves(pod.params)):
        assert torch.equal(x, y[0])


# ---------------------------------------------------------------- data

def test_token_stream_is_a_function_of_seed_and_step():
    it = TT.make_data_iter(CFG, batch=4, seq=32, seed=3, device="cpu")
    a, b = it(5), it(5)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], it(6)["tokens"])
    other = TT.make_data_iter(CFG, batch=4, seq=32, seed=4, device="cpu")(5)
    assert not torch.equal(a["tokens"], other["tokens"])
    assert a["tokens"].dtype == torch.int32 and a["tokens"].shape == (4, 32)
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert int(a["tokens"].min()) >= 0
    assert int(a["tokens"].max()) < CFG.vocab_size
    # noisy arithmetic progressions: most steps repeat the row's stride
    full = torch.cat([a["tokens"], a["labels"][:, -1:]], 1).long()
    d = (full[:, 1:] - full[:, :-1]) % CFG.vocab_size
    mode = torch.mode(d, dim=1).values
    assert bool(((mode >= 1) & (mode <= 16)).all())
    assert float((d == mode[:, None]).float().mean()) > 0.7


# ---------------------------------------------------------------- CLI

def test_launch_train_on_the_cpu(tmp_path):
    from repro_torch.launch import train as LT
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        r = LT.main(["--arch", "granite-3-2b", "--smoke", "--steps", "4",
                     "--batch", "4", "--seq", "32", "--compress",
                     "--lossy-ckpt", "--device", "cpu",
                     "--ckpt-dir", str(tmp_path)])
    assert buf.getvalue().startswith("granite-3-2b: steps 0..3 loss ")
    assert sorted(r["losses"]) == [0, 1, 2, 3]
    assert all(np.isfinite(list(r["losses"].values())))
    assert len(r["step_s"]) == 4 and r["params"] == TM.count_params(CFG)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000001", "step_00000002", "step_00000003", "step_00000004"]
