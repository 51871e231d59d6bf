"""The port's hybrid family (``models.causal_lm``'s hymba: attention and
a mamba2 mixer in parallel, sliding-window attention with global
layers, meta tokens, the nested ``HybridCache``) against the reference
on the CPU, at hymba-1.5b's smoke config (5 layers: a global one, then
4 windowed ones; window 32, 8 meta tokens).

Inputs are numpy arrays made from a seed; the reference runs as its own
tests run it (``jax.jit`` of its functions), compiled with XLA's
``xla_allow_excess_precision`` off as ``tests/test_torch_families.py``
compiles it (``ref_jit``), and its parameters are carried into the port
with ``convert``.  Every leaf whose init is a constant (the norms, the
mixing vectors, the SSM's ``a_log``, ``d_skip``, ``dt_bias`` and
``conv_b``) is perturbed first, so that it is exercised; the SSM's
float32 leaves stay float32 in a bfloat16 model, as the reference makes
them.

Bounds:

* bit-equal: parameter tables, counts, ``active_params`` and segments;
  converted parameters and caches; the cache's leaves and their order;
  the KV gate's CRs, rewritten leaves and metering; ``pos``;
* float32: rtol 1e-5, atol 2e-5 (windowed attention, logits, caches);
  loss rtol 1e-5; gradients rtol 1e-5 / atol 1e-5 of the leaf's largest
  |value|;
* bfloat16: 4 bfloat16 ulps of the largest |value|, loss rtol 1e-3,
  gradients 16 ulps of the leaf's largest |value| and no farther from
  the reference's float32 gradient than 1.5x the reference's own
  bfloat16 gradient plus 2 ulps;
* the whole bfloat16 forward's logits: 4 ulps, or, past them, no
  farther from the reference's float32 logits than the reference's own
  bfloat16 logits plus 2 ulps.  XLA fuses the meta tokens' concatenation
  into the first norm's reduction and so sums it in another order: the
  jitted layer given the same input is the port's bit for bit, but
  inside the forward 27 of 1920 values of the first layer's output are
  an ulp apart, and at 5 layers and S = 15 + 8 one logit of seed 1 is
  6 ulps from the port's (the port 12.3 ulps from float32, the
  reference 14.0);
* float32 gradients of the 5-layer smoke model at S = 48 + 8: atol 1e-4
  of the leaf's largest |value| (4.7e-5 seen), and rtol 1e-5 / atol
  1e-5 at 2 layers.  Against a float64 evaluation the reference's
  gradients are 1.5e-5 of a leaf's largest value away and the port's
  4.1e-5; the error grows in the backward of the first windowed layer,
  whose mixer and attention VJPs alone, fed the model's own inputs and
  output gradients, agree with float64 to 1e-6 in both packages;
* the reference's own properties (``tests/test_models.py``): decode ==
  the full forward within 1e-4 in float32, the windowed forward causal
  (``test_hymba_window_masks_long_context``), a smoke loss in (1, 20).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as RB  # noqa: E402
from repro.models import causal_lm as RCLM  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serve import engine as RE  # noqa: E402
from repro.train import train_step as JTS  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.launch import serve as TLS  # noqa: E402
from repro_torch.launch import train as TLT  # noqa: E402
from repro_torch.models import causal_lm as TCLM  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.params import (ParamDef, tree_flatten,  # noqa: E402
                                       tree_leaves)
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.serve.sweep_service import (ServiceConfig,  # noqa: E402
                                             SweepService)
from repro_torch.train import grad_compress as TGC  # noqa: E402
from repro_torch.train import optimizer as TOPT  # noqa: E402
from repro_torch.train import train_step as TTS  # noqa: E402

from test_torch_families import (LOSS_RTOL, assert_close, bf16_ulp,  # noqa: E402
                                 bits, cfgs, f32, ref_jit, t, tokens)

ARCH = "hymba-1.5b"
DTYPES = ["float32", "bfloat16"]
ONES = ("norm1", "norm2", "final_norm", "norm_g", "d_skip", "mix_attn",
        "mix_ssm")
ZEROS = ("conv_b", "dt_bias", "a_log")
SSM_F32 = ("a_log", "d_skip", "dt_bias")
# phase 26's cut depths (layers, global layers) besides the full model's
CUT_DEPTHS = [(32, 3), (4, 1), (2, 1), (5, 1)]


def perturbed(tree: dict, ones, zeros, seed: int) -> dict:
    """``tree`` with every leaf named in ``ones`` drawn about 1 and every
    one in ``zeros`` about 0 (their inits are constants), in place."""
    rng = np.random.default_rng(seed)

    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ones:
                node[k] = (1 + 0.1 * rng.standard_normal(v.shape)
                           ).astype(v.dtype)
            elif k in zeros:
                node[k] = (0.3 * rng.standard_normal(v.shape)).astype(v.dtype)

    walk(tree)
    return tree


def ref_tree(rcfg, seed: int = 0) -> dict:
    """The reference's parameters as numpy: bfloat16 leaves in the
    config's dtype, float32 leaves kept float32, constants perturbed."""
    dt = jnp.dtype(rcfg.dtype)
    tree = jax.tree.map(
        lambda a: np.asarray(a.astype(dt) if a.dtype == jnp.bfloat16 else a),
        RM.init_params(rcfg, jax.random.PRNGKey(seed)))
    return perturbed(tree, ONES, ZEROS, seed)


def jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def tbatch(batch: dict) -> dict:
    return {k: t(v) for k, v in batch.items()}


def flat_ref(tree) -> dict:
    return dict(tree_flatten(jax.tree.map(np.asarray, tree)))


def assert_tree_close(got, want, dtype: str, what: str) -> None:
    """Every leaf of the port's ``got`` against the reference's ``want``:
    the same paths in the same order; int32 exact, float leaves in their
    dtype at the module's bounds."""
    want = flat_ref(want)
    got = dict(tree_flatten(got))
    assert list(got) == list(want), what
    for k, w in want.items():
        if w.dtype == np.int32:
            assert np.array_equal(got[k].numpy(), w), (what, k)
        else:
            assert str(got[k].dtype).split(".")[-1] == w.dtype.name, k
            assert_close(got[k], w, dtype, f"{what} {k}")


# ---------------------------------------------------------------- tables

@pytest.mark.parametrize("size", ["full", "smoke"])
def test_param_table_counts_and_active_params(size):
    """Names, shapes and dtypes (the SSM's float32 leaves, ``meta``, the
    mixing vectors) == the reference's ``M.abstract_params`` without
    allocating; counts and ``active_params`` equal; hymba-1.5b whole is
    1 641 995 520 parameters."""
    get = "get_arch" if size == "full" else "get_smoke"
    cfg, rcfg = getattr(TB, get)(ARCH), getattr(RB, get)(ARCH)
    ref = {".".join(str(getattr(k, "key", k)) for k in path): leaf
           for path, leaf in jax.tree_util.tree_flatten_with_path(
               RM.abstract_params(rcfg))[0]}
    got = dict(tree_flatten(TM.param_table(cfg),
                            lambda x: isinstance(x, ParamDef)))
    assert list(got) == list(ref)
    for name, d in got.items():
        assert d.shape == ref[name].shape, name
        assert str(d.dtype).split(".")[-1] == np.dtype(ref[name].dtype).name
    assert TM.count_params(cfg) == RM.count_params(rcfg) == cfg.param_count()
    assert TM.active_params(cfg) == RM.active_params(rcfg)
    assert got["meta"].shape == (cfg.meta_tokens, cfg.d_model)
    for k in SSM_F32:
        assert got[f"seg0.ssm.{k}"].dtype == torch.float32
    if size == "full":
        assert TM.count_params(cfg) == 1_641_995_520


@pytest.mark.parametrize("layers,globals_", CUT_DEPTHS)
def test_segments_equal_reference(layers, globals_):
    """``segments`` at the full config (global 1, scan 9, global 1, scan
    9, global 1, scan 11), the smoke one and phase 26's cut depths, and
    the parameter counts there."""
    for get in ("get_arch", "get_smoke"):
        cfg = dataclasses.replace(getattr(TB, get)(ARCH), num_layers=layers,
                                  num_global_layers=globals_)
        rcfg = dataclasses.replace(getattr(RB, get)(ARCH),
                                   num_layers=layers,
                                   num_global_layers=globals_)
        assert TCLM.segments(cfg) == RCLM.segments(rcfg), (get, layers)
        assert sum(n for _, n in TCLM.segments(cfg)) == layers
        assert TM.count_params(cfg) == RM.count_params(rcfg)
    assert TCLM.segments(TB.get_arch(ARCH)) == [
        ("global", 1), ("scan", 9), ("global", 1), ("scan", 9),
        ("global", 1), ("scan", 11)]
    assert TCLM.segments(TB.get_smoke(ARCH)) == [("global", 1), ("scan", 4)]


def test_check_family_admits_every_family():
    for arch in TB.ARCH_IDS:
        TCLM.check_family(TB.get_arch(arch))
    with pytest.raises(ValueError, match="unknown family"):
        TCLM.check_family(dataclasses.replace(TB.get_arch(ARCH),
                                              family="rnn"))


# ---------------------------------------------------------------- layers

@pytest.mark.parametrize("mode", ["forward", "ragged", "ring"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_windowed_attention_matches_reference(dtype, mode):
    """``layers.attention`` with a window: a causal sequence (one chunk,
    and several with a ragged tail), and a decode query against a ring
    buffer whose slots hold positions out of order (``kv_positions``)."""
    rng = np.random.default_rng(0)
    b, hq, hkv, hd, window = 2, 4, 2, 16, 32
    if mode == "ring":
        s, tlen, q_offset, chunk = 1, 40, 70, 1024
        pos = ((np.arange(tlen) - 70) % tlen + 31).astype(np.int32)
        kvp = np.broadcast_to(pos, (b, tlen)).copy()
    else:
        s = tlen = 100 if mode == "ragged" else 48
        q_offset, chunk, kvp = 0, 32 if mode == "ragged" else 1024, None
    dt = jnp.dtype(dtype)
    q = rng.standard_normal((b, s, hq, hd)).astype(dt)
    k = rng.standard_normal((b, tlen, hkv, hd)).astype(dt)
    v = rng.standard_normal((b, tlen, hkv, hd)).astype(dt)
    args = (q, k, v) if kvp is None else (q, k, v, kvp)
    want = ref_jit(lambda q, k, v, *p: RL.attention(
        q, k, v, causal=True, q_offset=q_offset, window=window, chunk=chunk,
        kv_positions=p[0] if p else None))(*args)
    got = TL.attention(t(q), t(k), t(v), causal=True, q_offset=q_offset,
                       window=window, chunk=chunk,
                       kv_positions=None if kvp is None else t(kvp))
    assert_close(got, want, dtype, mode)


# ---------------------------------------------------------------- model

def _ref_forward(rcfg):
    return ref_jit(lambda p, tk: RCLM.logits_fn(p, RCLM.forward(
        p, tk, rcfg, remat=False)))


@pytest.mark.parametrize("s", [15, 40])
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_and_loss_equal_reference(dtype, s):
    """The whole smoke forward (the meta tokens before the sequence; S =
    15 + 8 runs the SSD in chunks of 1, 40 + 8 past the window of 32)
    and the loss on the same converted parameters."""
    cfg, rcfg = cfgs(ARCH, dtype)
    tree = ref_tree(rcfg, seed=1)
    rp = jtree(tree)
    model = convert.lm_params(tree, cfg, device="cpu")
    toks = tokens(cfg, 2, s + 1, seed=2)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    want = _ref_forward(rcfg)(rp, batch["tokens"])
    with torch.inference_mode():
        got = TCLM.logits_fn(model, TCLM.forward(model, t(batch["tokens"]),
                                                 cfg))
    assert got.shape[1] == s
    if dtype == "bfloat16":
        r32 = dataclasses.replace(rcfg, dtype="float32")
        w32 = _ref_forward(r32)(jax.tree.map(
            lambda a: jnp.asarray(a, jnp.float32), tree), batch["tokens"])
        ulp = bf16_ulp(float(np.abs(f32(want)).max()))
        err = float(np.abs(f32(got) - f32(want)).max())
        e_port = float(np.abs(f32(got) - f32(w32)).max())
        e_ref = float(np.abs(f32(want) - f32(w32)).max())
        assert err <= 4 * ulp or e_port <= e_ref + 2 * ulp, \
            (err / ulp, e_port / ulp, e_ref / ulp)
    else:
        assert_close(got, want, dtype, "logits")
    wl = ref_jit(lambda p, b: RM.loss_fn(p, b, rcfg))(rp, jtree(batch))
    with torch.inference_mode():
        tl = TM.loss_fn(model, tbatch(batch), cfg)
    np.testing.assert_allclose(float(tl), float(wl), rtol=LOSS_RTOL[dtype])


@pytest.mark.parametrize("prompt", [16, 48])
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_teacher_forced_decode(dtype, prompt):
    """Prefill logits and every cache leaf (the nested ``attn`` K/V and
    positions, the conv window, the float32 state), then 4 decode steps
    fed the same tokens.  A prompt of 48 ids and 8 meta tokens passes
    the windowed segment's 32 + 8 slots, so the prefill wraps its ring
    buffer, and the decode steps write over the oldest slots."""
    cfg, rcfg = cfgs(ARCH, dtype)
    tree = ref_tree(rcfg, seed=2)
    rp = jtree(tree)
    model = convert.lm_params(tree, cfg, device="cpu")
    toks = tokens(cfg, 2, prompt + 4, seed=3)
    max_len = prompt + 8
    pre = ref_jit(lambda p, tk: RM.prefill(p, {"tokens": tk}, rcfg, max_len))
    dec = ref_jit(lambda p, c, tk, pos: RM.decode_step(p, c, tk, pos, rcfg))
    lr, cr = pre(rp, toks[:, :prompt])
    with torch.inference_mode():
        lt, ct = TM.prefill(model, {"tokens": t(toks[:, :prompt])}, cfg,
                            max_len)
    slots = {k: x.shape[2] for k, x in tree_flatten(ct) if k.endswith(".k")}
    assert slots == {"seg0.attn.k": max_len + 8,
                     "seg1.attn.k": min(32, max_len) + 8}
    for i in range(prompt, prompt + 5):
        what = "prefill" if i == prompt else f"decode {i - 1}"
        assert_close(lt, lr, dtype, f"{what} logits")
        assert_tree_close(ct, cr, dtype, what)
        if i < prompt + 4:
            lr, cr = dec(rp, cr, toks[:, i:i + 1], jnp.int32(i))
            with torch.inference_mode():
                lt, ct = TM.decode_step(model, ct, t(toks[:, i:i + 1]), i,
                                        cfg)
    if prompt + 8 > 40:
        pos = ct["seg1"].attn.pos.numpy()
        assert pos.max() == prompt + 3 + 8 and pos.min() > 8


# ------------------------------------- the reference's tests/test_models.py

def _ref_style_batch(cfg, b=2, s=32) -> dict:
    toks = tokens(cfg, b, s, seed=0)
    return {"tokens": toks, "labels": toks}


def test_smoke_forward_and_loss():
    cfg = TB.get_smoke(ARCH)
    model = TM.init_params(cfg, torch.Generator().manual_seed(0))
    with torch.inference_mode():
        loss = TM.loss_fn(model, tbatch(_ref_style_batch(cfg)), cfg)
    assert loss.shape == () and bool(torch.isfinite(loss))
    assert 1.0 < float(loss) < 20.0, float(loss)


def test_smoke_train_step():
    """Two microbatches of 2, the gate on: finite metrics, changed
    parameters, and the SSM's float32 leaves through ``compress_tree``
    and AdamW with float32 gradients, in the global and the windowed
    segment."""
    cfg = TB.get_smoke(ARCH)
    state = TTS.init_state(cfg, torch.Generator().manual_seed(0),
                           compress=True)
    before = {k: x.clone() for k, x in tree_flatten(state.params)}
    seen = []
    orig = TGC.compress_tree

    def spy(grads, ef, c, inplace=False):
        seen.append(dict(tree_flatten(grads)))
        return orig(grads, ef, c, inplace)

    step = TTS.make_train_step(cfg, microbatches=2,
                               compress=TGC.CompressConfig())
    TGC.compress_tree = spy
    try:
        state2, m = step(state, tbatch(_ref_style_batch(cfg, b=4)))
    finally:
        TGC.compress_tree = orig
    assert bool(torch.isfinite(m["loss"])) and bool(
        torch.isfinite(m["grad_norm"]))
    after = dict(tree_flatten(state2.params))
    for k in ("embed", "meta"):
        assert not torch.equal(before[k], after[k]), k
    for k in (f"seg{i}.ssm.{n}" for i in (0, 1) for n in SSM_F32):
        g = seen[0][k]
        assert g.dtype == torch.float32 and bool(g.abs().sum() > 0), k
        assert after[k].dtype == torch.float32, k
        assert not torch.equal(after[k], before[k]), k


def test_decode_matches_forward():
    """float32: prefill 15 tokens and decode the 16th == the full
    forward's last logits within 1e-4 (the recurrent step against the
    chunked SSD; the decode token without meta tokens, at pos + 8)."""
    cfg = dataclasses.replace(TB.get_smoke(ARCH), dtype="float32")
    model = TM.init_params(cfg, torch.Generator().manual_seed(0)).float()
    toks = torch.from_numpy(tokens(cfg, 2, 16, seed=9))
    with torch.inference_mode():
        full = TCLM.logits_fn(model, TCLM.forward(model, toks, cfg))
        _, cache = TM.prefill(model, {"tokens": toks[:, :15]}, cfg, 20)
        lg, _ = TM.decode_step(model, cache, toks[:, 15:16], 15, cfg)
    err = float((lg - full[:, 15]).abs().max())
    assert err < 1e-4, err


def test_hymba_window_masks_long_context():
    """The reference's test: the windowed forward is causal -- changing
    the last of 64 tokens leaves every earlier position's hidden state
    within 1e-5; and the port's hidden states == the reference's."""
    cfg, rcfg = cfgs(ARCH, "float32")
    tree = ref_tree(rcfg, seed=3)
    model = convert.lm_params(tree, cfg, device="cpu")
    toks = tokens(cfg, 1, 64, seed=4)
    toks2 = toks.copy()
    toks2[:, -1] = (toks2[:, -1] + 1) % cfg.vocab_size
    with torch.inference_mode():
        h1 = TCLM.forward(model, t(toks), cfg)
        h2 = TCLM.forward(model, t(toks2), cfg)
    assert torch.allclose(h1[:, :63], h2[:, :63], atol=1e-5)
    assert not torch.allclose(h1[:, 63], h2[:, 63], atol=1e-5)
    want = ref_jit(lambda p, tk: RCLM.forward(p, tk, rcfg, remat=False))(
        jtree(tree), toks)
    assert_close(h1, want, "float32", "hidden")


# ---------------------------------------------------------------- training

@functools.lru_cache(maxsize=None)
def _ref_grads_fn(rcfg, microbatches: int = 1):
    return ref_jit(lambda p, b: JTS._grads(rcfg, p, b, microbatches))


def assert_grads(got, want, dtype: str, want32=None,
                 f32_atol: float = 1e-5) -> None:
    """Every gradient leaf at the module's bounds (float32: ``f32_atol``
    of the leaf's largest |value|)."""
    want = flat_ref(want)
    got = dict(tree_flatten(got))
    assert list(got) == list(want)
    for k in want:
        assert str(got[k].dtype).split(".")[-1] == want[k].dtype.name, k
        g, w = f32(got[k]), f32(want[k])
        m = float(np.abs(w).max())
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=f32_atol * m,
                                       err_msg=k)
            continue
        ulp = bf16_ulp(m)
        err = float(np.abs(g - w).max())
        assert err <= 16 * ulp, (k, err, 16 * ulp)
        e_port = float(np.abs(g - want32[k]).max())
        e_ref = float(np.abs(w - want32[k]).max())
        assert e_port <= 1.5 * e_ref + 2 * ulp, (k, e_port, e_ref)


@pytest.mark.parametrize("layers", [2, 5])
@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_and_every_gradient_leaf(dtype, layers):
    """The loss and every gradient leaf (``meta``, the mixing vectors,
    both segments' attention and SSM leaves) against ``jax.jit`` of the
    reference's ``_grads``, on the default remat path (each layer under
    ``checkpoint``), S = 48 + 8 past the window; at 2 layers (a global
    and a windowed one) and the smoke model's 5 (float32 bound: module
    docstring)."""
    cfg, rcfg = cfgs(ARCH, dtype, num_layers=layers)
    tree = ref_tree(rcfg, seed=6)
    toks = tokens(cfg, 2, 49, seed=7)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, jg = _ref_grads_fn(rcfg)(jtree(tree), jtree(batch))
    tl, tg = TTS._grads(cfg, convert.lm_tree(tree, "cpu"), tbatch(batch), 1)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL[dtype])
    want32 = None
    if dtype == "bfloat16":
        r32 = dataclasses.replace(rcfg, dtype="float32")
        _, j32 = _ref_grads_fn(r32)(
            jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree),
            jtree(batch))
        want32 = flat_ref(j32)
    assert_grads(tg, jg, dtype, want32, 1e-5 if layers == 2 else 1e-4)


def test_ssm_float32_leaves_compress_and_adamw_bitequal():
    """``compress_tree`` and one AdamW step on a bfloat16 hymba tree with
    its float32 ``a_log`` / ``d_skip`` / ``dt_bias`` leaves in both
    segments: the reference's bits (clip inactive)."""
    from repro.train import grad_compress as JGC
    from repro.train import optimizer as JOPT
    cfg, rcfg = cfgs(ARCH, "bfloat16")
    tree = ref_tree(rcfg, seed=8)
    toks = tokens(cfg, 2, 33, seed=9)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    _, jg = _ref_grads_fn(rcfg)(jtree(tree), jtree(batch))
    grads = jax.tree.map(np.asarray, jg)
    rng = np.random.default_rng(10)
    res = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 1e-4
                                  ).astype(np.float32), grads)
    cc = JGC.CompressConfig()
    js, je, jc = jax.jit(lambda g, r: JGC.compress_tree(
        g, JGC.EFState(r), cc))(grads, res)
    ts, te, tc = TGC.compress_tree(convert.lm_tree(grads, "cpu"),
                                   TGC.EFState(convert.lm_tree(res, "cpu")),
                                   TGC.CompressConfig())
    for name, got, want in (("sent", ts, js), ("resid", te.residuals,
                                               je.residuals), ("cr", tc, jc)):
        want = flat_ref(want)
        for k, x in tree_flatten(got):
            assert np.array_equal(bits(x), bits(want[k])), (name, k)
    ocfg = dict(lr=1e-3, grad_clip=1e9)
    jst = JOPT.init(jtree(tree))
    jp, jo, _ = jax.jit(lambda p, g, s: JOPT.apply(
        JOPT.AdamWConfig(**ocfg), p, g, s))(jtree(tree), js, jst)
    tp, to, _ = TOPT.apply(TOPT.AdamWConfig(**ocfg),
                           convert.lm_tree(tree, "cpu"),
                           convert.lm_tree(jax.tree.map(np.asarray, js),
                                           "cpu"),
                           TOPT.init(convert.lm_tree(tree, "cpu")))
    for name, got, want in (("params", tp, jp), ("mu", to.mu, jo.mu),
                            ("nu", to.nu, jo.nu)):
        want = flat_ref(want)
        for k, x in tree_flatten(got):
            assert np.array_equal(bits(x), bits(want[k])), (name, k)
    for i in (0, 1):
        assert dict(tree_flatten(tp))[f"seg{i}.ssm.a_log"].dtype == \
            torch.float32


# ---------------------------------------------------------------- convert

def test_convert_round_trips():
    """A reference tree (``meta``, the mixing vectors and SSM leaves of
    the global and the windowed segment) into ``lm_params`` / ``lm_tree``
    / ``train_state``, and a prefilled cache (``HybridCache`` with its
    ``AttnCache`` nested) into ``lm_cache``: every leaf's dtype and bits
    kept, the model's modules holding them layer by layer."""
    cfg, rcfg = cfgs(ARCH)
    tree = ref_tree(rcfg, seed=11)
    model = convert.lm_params(tree, cfg, device="cpu")
    want = dict(tree_flatten(tree))
    named = dict(model.named_parameters())
    for k, a in want.items():
        parts = k.split(".")
        if parts[0].startswith("seg"):
            slots = [i for i, (seg, _) in enumerate(model.layer_slots)
                     if seg == parts[0]]
            assert len(slots) == a.shape[0], k
            for j, i in enumerate(slots):
                x = named[".".join(["layers", str(i)] + parts[1:])]
                assert np.array_equal(bits(x), bits(a[j])), (k, j)
        else:
            assert np.array_equal(bits(named[k]), bits(a)), k
    back = dict(tree_flatten(convert.lm_tree(tree, "cpu")))
    for k, a in want.items():
        assert str(back[k].dtype).split(".")[-1] == a.dtype.name, k
        assert np.array_equal(bits(back[k]), bits(a)), k
    rst = JTS.init_state(rcfg, jax.random.PRNGKey(1), compress=True)
    st = convert.train_state(jax.tree.map(np.asarray, rst), "cpu")
    for got, ref in ((st.params, rst.params), (st.opt.mu, rst.opt.mu),
                     (st.ef.residuals, rst.ef.residuals)):
        w = flat_ref(ref)
        for k, x in tree_flatten(got):
            assert np.array_equal(bits(x), bits(w[k])), k
    _, rcache = ref_jit(lambda p, tk: RM.prefill(p, {"tokens": tk}, rcfg,
                                                 12))(jtree(tree),
                                                      tokens(cfg, 2, 8))
    rc = jax.tree.map(np.asarray, rcache)
    cache = convert.lm_cache(rc, device="cpu")
    want = dict(tree_flatten(rc))
    got = dict(tree_flatten(cache))
    assert list(got) == list(want)
    for k, x in got.items():
        assert np.array_equal(bits(x), bits(want[k])), k
    for c in cache.values():
        assert type(c) is TCLM.HybridCache and type(c.attn) is TCLM.AttnCache
        assert c.state.dtype == torch.float32


@pytest.mark.parametrize("dtype", DTYPES)
def test_init_cache_equals_reference_structure(dtype):
    """The port's empty cache: the reference's leaves (paths in
    ``jax.tree.flatten``'s order through the nested ``attn``, shapes,
    dtypes, values), the windowed segment's ring ``min(window, max_len)
    + meta`` slots and the global one's ``max_len + meta``."""
    cfg, rcfg = cfgs(ARCH, dtype)
    for max_len in (24, 64):
        want = flat_ref(RCLM.init_cache(rcfg, 2, max_len))
        got = dict(tree_flatten(TCLM.init_cache(cfg, 2, max_len, "cpu")))
        assert list(got) == list(want) == [
            f"seg{i}.{k}" for i in (0, 1)
            for k in ("attn.k", "attn.v", "attn.pos", "conv", "state")]
        for k, w in want.items():
            assert tuple(got[k].shape) == w.shape, k
            assert str(got[k].dtype).split(".")[-1] == w.dtype.name, k
            assert np.array_equal(bits(got[k]), bits(w)), k
        assert got["seg1.attn.k"].shape[2] == min(32, max_len) + 8
        assert got["seg0.attn.k"].shape[2] == max_len + 8


# ---------------------------------------------------------------- serving

def test_gate_on_a_prefilled_cache_bitequal():
    """The reference's prefilled cache (a ring that wrapped), gated by
    both engines, the port's through its own call and through a
    ``SweepService``: the scored leaves (k, v, conv and the float32
    state of each segment), CRs, rewritten leaves and metering
    bit-equal."""
    cfg, rcfg = cfgs(ARCH)
    tree = ref_tree(rcfg, seed=12)
    rp = jtree(tree)
    toks = tokens(cfg, 2, 40, seed=13)
    _, rcache = ref_jit(lambda p, tk: RM.prefill(p, {"tokens": tk}, rcfg,
                                                 48))(rp, toks)
    rc = jax.tree.map(np.asarray, rcache)
    ref = RE.Engine(rcfg, rp, RE.ServeConfig(max_len=48, kv_compress=True))
    want_leaves = jax.tree.leaves(ref._maybe_compress_cache(rcache))
    rl = [x for x in jax.tree.leaves(rcache)
          if x.dtype in (jnp.bfloat16, jnp.float32) and x.ndim >= 4]
    want_crs = np.asarray(ref._gate_crs(tuple(rl)))
    for svc in (None, SweepService(ServiceConfig(max_wait_ms=1.0),
                                   device="cpu")):
        try:
            cache = convert.lm_cache(rc, device="cpu")
            eng = TE.Engine(cfg, None, TE.ServeConfig(max_len=48,
                                                      kv_compress=True),
                            sweep_service=svc)
            names = [k for k, x in tree_flatten(cache)
                     if x.dtype in (torch.bfloat16, torch.float32)
                     and x.ndim >= 4]
            assert names == [f"seg{i}.{k}" for i in (0, 1)
                             for k in ("attn.k", "attn.v", "conv", "state")]
            tl = dict(tree_flatten(cache))
            got_crs = eng._predict_crs([tl[k] for k in names])
            assert np.array_equal(np.asarray(got_crs).view(np.uint32),
                                  want_crs.view(np.uint32))
            got = tree_leaves(eng._maybe_compress_cache(cache))
            assert len(got) == len(want_leaves)
            for g, w in zip(got, want_leaves):
                assert np.array_equal(bits(g), bits(w))
            assert (eng.kv_saved_bytes, eng.kv_total_bytes) == \
                (ref.kv_saved_bytes, ref.kv_total_bytes)
            if svc is not None:
                assert svc.stats()["methods"]["kv_gate"]["rows"] == \
                    2 * len(names)
        finally:
            if svc is not None:
                svc.close()


def test_launchers_serve_and_train_the_family(tmp_path):
    """``launch.serve`` with the gate, directly and through the service
    (the same ids and metering, one kv_gate row per scored leaf), and
    ``launch.train --compress --lossy-ckpt`` on the smoke config."""
    base = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--steps", "4", "--max-len", "16",
            "--kv-compress"]
    a = TLS.main(base)
    b = TLS.main(base + ["--kv-gate-service"])
    assert a["shape"] == [2, 4] and a["ids"] == b["ids"]
    assert a["params"] == TM.count_params(TB.get_smoke(ARCH))
    assert (a["kv_saved_bytes"], a["kv_total_bytes"]) == \
        (b["kv_saved_bytes"], b["kv_total_bytes"])
    assert b["kv_gate"]["rows"] == 8
    r = TLT.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps",
                  "4", "--batch", "4", "--seq", "32", "--compress",
                  "--lossy-ckpt", "--ckpt-dir", str(tmp_path)])
    assert sorted(r["losses"]) == [0, 1, 2, 3]
    assert np.all(np.isfinite(list(r["losses"].values())))
    assert r["params"] == TM.count_params(TB.get_smoke(ARCH))
