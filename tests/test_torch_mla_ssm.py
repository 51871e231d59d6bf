"""The port's mla_moe and ssm families (``models.causal_lm``'s MLA and
dense first layer, ``models.ssm``) against the reference on the CPU, at
the smoke configs of deepseek-v2-236b and mamba2-370m.

Inputs are numpy arrays made from a seed; the reference runs as its own
tests run it (``jax.jit`` of its functions), compiled with XLA's
``xla_allow_excess_precision`` off as ``tests/test_torch_families.py``
compiles it (``ref_jit``), and its parameters are carried into the port
with ``convert``.  Every leaf whose init is a constant (the norms, the
SSM's ``a_log``, ``d_skip``, ``dt_bias`` and ``conv_b``) is perturbed
first, so that it is exercised; the SSM's float32 leaves and the router
stay float32 in a bfloat16 model, as the reference makes them.

Bounds:

* bit-equal: parameter tables, counts and ``active_params``; the
  chunk-halving loop; converted parameters and caches; the KV gate's
  CRs, rewritten leaves and metering; ``pos``;
* float32: rtol 1e-5, atol 2e-5 (``mla_block`` in both forms and its
  cache writes, ``ssd_forward``, ``ssm_step``, ``_causal_conv``,
  ``mamba_mixer`` and its cache, logits, caches); loss rtol 1e-5;
  gradients rtol 1e-5 / atol 1e-5 of the leaf's largest |value|
  (``tests/test_torch_train.py``);
* bfloat16: 4 bfloat16 ulps of the largest |value| (the same values;
  ``ssd_forward`` and ``ssm_step`` return float32 in a bfloat16 model,
  built from bfloat16 products, and are held so too), loss rtol 1e-3,
  gradients 16 ulps of the leaf's largest |value| and no farther from
  the reference's float32 gradient than 1.5x the reference's own
  bfloat16 gradient plus 2 ulps;
* the reference's own properties (``tests/test_models.py``): decode ==
  the full forward within 1e-4 in float32 with no token dropped
  (capacity factor 64), the chunked SSD == the sequential recurrence
  within rtol 1e-4 / atol 1e-4, a smoke loss in (1, 20).
"""
import contextlib
import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as RB  # noqa: E402
from repro.models import causal_lm as RCLM  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import moe as RMOE  # noqa: E402
from repro.models import ssm as RSSM  # noqa: E402
from repro.serve import engine as RE  # noqa: E402
from repro.train import train_step as JTS  # noqa: E402

from repro_torch import convert, refmath  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.launch import serve as TLS  # noqa: E402
from repro_torch.launch import train as TLT  # noqa: E402
from repro_torch.models import causal_lm as TCLM  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models import ssm as TSSM  # noqa: E402
from repro_torch.models.params import (ParamDef, tree_flatten,  # noqa: E402
                                       tree_leaves)
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.train import grad_compress as TGC  # noqa: E402
from repro_torch.train import optimizer as TOPT  # noqa: E402
from repro_torch.train import train_step as TTS  # noqa: E402

from test_torch_families import (LOSS_RTOL, assert_close, bf16_ulp,  # noqa: E402
                                 bits, cfgs, f32, ref_jit, t, tbatch,
                                 tokens)

MLA_ARCH, SSM_ARCH = "deepseek-v2-236b", "mamba2-370m"
FAMILIES = [MLA_ARCH, SSM_ARCH]
DTYPES = ["float32", "bfloat16"]
ONES = ("norm1", "norm2", "final_norm", "q_norm", "kv_norm", "norm_g",
        "d_skip")
ZEROS = ("conv_b", "dt_bias", "a_log")


def ref_tree(rcfg, seed: int = 0) -> dict:
    """The reference's parameters as numpy: bfloat16 leaves in the
    config's dtype, float32 leaves kept float32; every constant-init
    leaf perturbed (norms and ``d_skip`` about 1, the rest about 0)."""
    dt = jnp.dtype(rcfg.dtype)
    tree = jax.tree.map(
        lambda a: np.asarray(a.astype(dt) if a.dtype == jnp.bfloat16 else a),
        RM.init_params(rcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ONES:
                node[k] = (1 + 0.1 * rng.standard_normal(v.shape)
                           ).astype(v.dtype)
            elif k in ZEROS:
                node[k] = (0.3 * rng.standard_normal(v.shape)).astype(v.dtype)

    walk(tree)
    return tree


def jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def ns(group: dict, i: int = 0) -> SimpleNamespace:
    """Layer ``i`` of a stacked reference group as the port's argument."""
    return SimpleNamespace(**{k: t(v[i]) for k, v in group.items()})


def layer(group: dict, i: int = 0) -> dict:
    return {k: jnp.asarray(v[i]) for k, v in group.items()}


def rand(shape, dtype, seed: int, scale: float = 1.0) -> np.ndarray:
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(jnp.dtype(dtype))


# ---------------------------------------------------------------- tables

@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_param_table_counts_and_active_params(arch, size):
    """Names, shapes and dtypes (the SSM's and the router's float32
    leaves) == the reference's ``M.abstract_params`` without allocating,
    the counts and ``active_params`` equal, and the segments (deepseek's
    dense first layer in ``seg0``, d_ff 12288) the reference's."""
    get = "get_arch" if size == "full" else "get_smoke"
    cfg, rcfg = getattr(TB, get)(arch), getattr(RB, get)(arch)
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
    assert TCLM.segments(cfg) == RCLM.segments(rcfg)
    if arch == MLA_ARCH:
        assert got["seg0.mlp.wg"].shape[-1] == 12288
        assert got["seg1.moe.router"].dtype == torch.float32
        if size == "full":
            six = dataclasses.replace(cfg, num_layers=6)
            assert TM.count_params(six) == 21_247_144_960
            assert TM.active_params(six) == 3_080_565_760
            assert TM.count_params(dataclasses.replace(
                cfg, num_layers=2)) == 5_358_679_040
    else:
        for k in ("a_log", "d_skip", "dt_bias"):
            assert got[f"seg0.ssm.{k}"].dtype == torch.float32
        if size == "full":
            assert TM.count_params(cfg) == TM.active_params(cfg) \
                == 420_136_448


def test_check_family_admits_mla_moe_and_ssm():
    """The two families are admitted, and so, since the hybrid and encdec
    families were ported, is every config's."""
    for arch in FAMILIES + ["hymba-1.5b", "whisper-large-v3"]:
        TCLM.check_family(TB.get_arch(arch))


# ---------------------------------------------------------------- MLA

def _mla_cache(cfg, b: int, tlen: int, dtype: str, filled: int, seed: int):
    """A per-layer latent cache (B, T, ...) with ``filled`` slots written
    (random latents, positions 0..filled-1) and the rest unwritten."""
    ckv = rand((b, tlen, cfg.kv_lora_rank), dtype, seed)
    kr = rand((b, tlen, cfg.qk_rope_head_dim), dtype, seed + 1)
    pos = np.full((b, tlen), 10 ** 9, np.int32)
    pos[:, :filled] = np.arange(filled, dtype=np.int32)
    ckv[:, filled:] = 0
    kr[:, filled:] = 0
    return ckv, kr, pos


@pytest.mark.parametrize("form", ["expanded", "prefill", "absorbed"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_block_matches_reference(dtype, form):
    """``mla_block`` on one converted MoE layer's attention: the expanded
    form without a cache and as a prefill into a cache (its writes), and
    the absorbed form's decode step against a filled latent cache (its
    writes at the slot)."""
    cfg, rcfg = cfgs(MLA_ARCH, dtype)
    attn = ref_tree(rcfg, seed=1)["seg1"]["attn"]
    b, tlen = 2, 16
    s = 1 if form == "absorbed" else 12
    pos = 12 if form == "absorbed" else 0
    x = rand((b, s, cfg.d_model), dtype, seed=2)
    if form == "expanded":
        want, _ = ref_jit(lambda x, p: RCLM.mla_block(x, p, rcfg))(
            x, layer(attn))
        with torch.inference_mode():
            got = TCLM.mla_block(t(x), ns(attn), cfg)
        assert got.dtype == t(x).dtype
        assert_close(got, want, dtype, "expanded")
        return
    ckv, kr, cpos = _mla_cache(cfg, b, tlen, dtype,
                               filled=12 if form == "absorbed" else 0, seed=3)
    want, wc = ref_jit(lambda x, p, c, o: RCLM.mla_block(
        x, p, rcfg, cache=RCLM.MLACache(*c), pos_offset=o))(
        x, layer(attn), (ckv, kr, cpos), jnp.int32(pos))
    cache = TCLM.MLACache(t(ckv), t(kr), t(cpos))
    with torch.inference_mode():
        got = TCLM.mla_block(t(x), ns(attn), cfg, cache=cache,
                             pos_offset=pos)
    assert_close(got, want, dtype, form)
    assert_close(cache.ckv, wc.ckv, dtype, f"{form} ckv")
    assert_close(cache.krope, wc.krope, dtype, f"{form} krope")
    assert np.array_equal(cache.pos.numpy(), np.asarray(wc.pos))


# ---------------------------------------------------------------- SSM

@pytest.mark.parametrize("s,chunk", [(15, 32), (33, 32), (256, 32),
                                     (256, 256), (48, 32), (64, 256)])
def test_ssd_chunk_halving_follows_reference(s, chunk):
    """The largest chunk, halving from the config's, that divides S:
    15 and 33 go down to 1."""
    want = chunk
    while s % want:
        want //= 2
        if want <= 1:
            want = 1
            break
    assert TSSM.ssd_chunk(s, chunk) == want
    if s in (15, 33):
        assert want == 1


SSD_SHAPES = {
    # name: (H, P, G, N): the smoke mixer's, N > P (the reference test's)
    "smoke": (4, 16, 1, 16),
    "n_gt_p": (4, 8, 2, 16),
    "p_gt_n": (4, 16, 2, 8),
}


def _ssd_inputs(s: int, shape: str, dtype: str, seed: int, b: int = 2):
    h, p, g, n = SSD_SHAPES[shape]
    rng = np.random.default_rng(seed)
    dt_raw = rng.standard_normal((b, s, h)).astype(np.float32)
    return dict(
        x=rand((b, s, h, p), dtype, seed + 1),
        b_in=rand((b, s, g, n), dtype, seed + 2, 0.3),
        c_in=rand((b, s, g, n), dtype, seed + 3, 0.3),
        dt=np.log1p(np.exp(dt_raw)).astype(np.float32),
        a=(-np.exp(0.3 * rng.standard_normal(h))).astype(np.float32),
        d_skip=(1 + 0.1 * rng.standard_normal(h)).astype(np.float32))


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("shape", sorted(SSD_SHAPES))
@pytest.mark.parametrize("s", [15, 33, 256])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_forward_matches_reference(dtype, s, shape, init):
    """``ssd_forward`` at the chunk the mixer takes for S (the smoke
    config's 32, halved: 15 and 33 run chunks of 1), with and without an
    initial state: the output (float32 in both dtypes) and the final
    state."""
    a = _ssd_inputs(s, shape, dtype, seed=s)
    chunk = TSSM.ssd_chunk(s, TB.get_smoke(SSM_ARCH).ssm_chunk)
    st = (np.random.default_rng(5).standard_normal(
        (2,) + SSD_SHAPES[shape][:2] + (SSD_SHAPES[shape][3],)
    ).astype(np.float32) if init else None)
    names = ("x", "b_in", "c_in", "dt", "a", "d_skip")
    wy, ws = ref_jit(lambda *z: RSSM.ssd_forward(*z[:6], chunk, z[6]))(
        *[a[k] for k in names], st)
    with torch.inference_mode():
        gy, gs = TSSM.ssd_forward(*[t(a[k]) for k in names], chunk,
                                  None if st is None else t(st))
    assert str(gy.dtype).split(".")[-1] == np.asarray(wy).dtype.name
    assert gs.dtype == torch.float32
    assert_close(gy, wy, dtype, "y")
    assert_close(gs, ws, dtype, "state")


@pytest.mark.parametrize("shape", sorted(SSD_SHAPES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_step_matches_reference(dtype, shape):
    a = _ssd_inputs(1, shape, dtype, seed=11)
    names = ("x", "b_in", "c_in", "dt", "a", "d_skip")
    args = [a[k][:, 0] if k in ("x", "b_in", "c_in", "dt") else a[k]
            for k in names]
    h, p, _, n = SSD_SHAPES[shape]
    st = np.random.default_rng(12).standard_normal((2, h, p, n)).astype(
        np.float32)
    wy, ws = ref_jit(RSSM.ssm_step)(*args, st)
    with torch.inference_mode():
        gy, gs = TSSM.ssm_step(*[t(v) for v in args], t(st))
    assert str(gy.dtype).split(".")[-1] == np.asarray(wy).dtype.name
    assert_close(gy, wy, dtype, "y")
    assert_close(gs, ws, dtype, "state")


@pytest.mark.parametrize("history", [False, True])
@pytest.mark.parametrize("s", [1, 15, 33])
@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv_matches_reference(dtype, s, history):
    c, k = 24, 4
    xbc = rand((2, s, c), dtype, seed=20)
    w, b = rand((k, c), dtype, seed=21), rand((c,), dtype, 22, 0.1)
    hist = rand((2, k - 1, c), dtype, seed=23) if history else None
    want = ref_jit(RSSM._causal_conv)(xbc, w, b, hist)
    got = TSSM._causal_conv(t(xbc), t(w), t(b),
                            None if hist is None else t(hist))
    assert got.dtype == t(xbc).dtype
    assert_close(got, want, dtype, "conv")


@pytest.mark.parametrize("mode,s", [(m, s) for m in ("none", "prefill")
                                    for s in (15, 33, 256)]
                         + [("decode", 1)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_mixer_matches_reference(dtype, mode, s):
    """``mamba_mixer`` on a converted layer: without a cache, as a
    prefill (the conv window's tail and the final state), and as a
    decode step from a filled cache."""
    cfg, rcfg = cfgs(SSM_ARCH, dtype)
    p = ref_tree(rcfg, seed=3)["seg0"]["ssm"]
    x = rand((2, s, cfg.d_model), dtype, seed=s + 30)
    fn = ref_jit(lambda x, p, c: RSSM.mamba_mixer(
        x, p, rcfg, None if c is None else RSSM.SSMCache(*c)))
    cache = None
    if mode != "none":
        c0 = TSSM.init_ssm_cache(2, cfg, getattr(torch, dtype), "cpu")
        conv, state = f32(c0.conv), f32(c0.state)
        if mode == "decode":
            conv = rand(conv.shape, "float32", 31)
            state = rand(state.shape, "float32", 32)
        cache = (conv.astype(jnp.dtype(dtype)), state)
    want, wc = fn(x, layer(p), cache)
    with torch.inference_mode():
        got, gc = TSSM.mamba_mixer(
            t(x), ns(p), cfg,
            None if cache is None else TSSM.SSMCache(t(cache[0]),
                                                     t(cache[1])))
    assert got.dtype == t(x).dtype
    assert_close(got, want, dtype, f"{mode} out")
    if mode == "none":
        assert gc is None and wc is None
        return
    assert gc.conv.dtype == t(cache[0]).dtype
    assert gc.state.dtype == torch.float32
    assert_close(gc.conv, wc.conv, dtype, "conv")
    assert_close(gc.state, wc.state, dtype, "state")


def test_ssd_chunked_equals_sequential():
    """The reference's test on the port: the chunked SSD (chunk 16) ==
    ``ssm_step`` token by token, output and final state, in float32."""
    rng = np.random.default_rng(7)
    b, s, h, p, g, n = 1, 64, 4, 8, 2, 16
    x = torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(np.float32))
    b_in = torch.from_numpy(
        (0.3 * rng.standard_normal((b, s, g, n))).astype(np.float32))
    c_in = torch.from_numpy(
        (0.3 * rng.standard_normal((b, s, g, n))).astype(np.float32))
    dt = TSSM.softplus(torch.from_numpy(
        rng.standard_normal((b, s, h)).astype(np.float32)))
    a = -torch.exp(torch.from_numpy(
        (0.3 * rng.standard_normal(h)).astype(np.float32)))
    d = torch.full((h,), 0.5)
    y_c, fin_c = TSSM.ssd_forward(x, b_in, c_in, dt, a, d, chunk=16)
    state = torch.zeros((b, h, p, n))
    ys = []
    for i in range(s):
        y, state = TSSM.ssm_step(x[:, i], b_in[:, i], c_in[:, i], dt[:, i],
                                 a, d, state)
        ys.append(y)
    np.testing.assert_allclose(y_c.numpy(), torch.stack(ys, 1).numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(fin_c.numpy(), state.numpy(),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- model

@functools.lru_cache(maxsize=None)
def _ref_forward(rcfg):
    return ref_jit(lambda p, tk: RCLM.logits_fn(p, RCLM.forward(
        p, tk, rcfg, remat=False)))


@pytest.mark.parametrize("s", [15, 40])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_and_loss_equal_reference(arch, dtype, s):
    """The whole smoke forward (logits; S = 15 runs the SSD in chunks of
    1) and the loss on the same converted parameters."""
    cfg, rcfg = cfgs(arch, dtype)
    tree = ref_tree(rcfg, seed=1)
    rp = jtree(tree)
    model = convert.lm_params(tree, cfg, device="cpu")
    toks = tokens(cfg, 2, s + 1, seed=2)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    want = _ref_forward(rcfg)(rp, batch["tokens"])
    with torch.inference_mode():
        got = TCLM.logits_fn(model, TCLM.forward(model, t(batch["tokens"]),
                                                 cfg))
    assert_close(got, want, dtype, "logits")
    wl = ref_jit(lambda p, b: RM.loss_fn(p, b, rcfg))(rp, jtree(batch))
    with torch.inference_mode():
        tl = TM.loss_fn(model, tbatch(batch), cfg)
    np.testing.assert_allclose(float(tl), float(wl), rtol=LOSS_RTOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_teacher_forced_decode(arch, dtype):
    """Prefill logits and every cache leaf, then 4 decode steps fed the
    same tokens (MLA's absorbed form; the SSM's recurrent step)."""
    cfg, rcfg = cfgs(arch, dtype)
    tree = ref_tree(rcfg, seed=2)
    rp = jtree(tree)
    model = convert.lm_params(tree, cfg, device="cpu")
    toks = tokens(cfg, 2, 16, seed=3)
    pre = ref_jit(lambda p, tk: RM.prefill(p, {"tokens": tk}, rcfg, 24))
    dec = ref_jit(lambda p, c, tk, pos: RM.decode_step(p, c, tk, pos, rcfg))
    lr, cr = pre(rp, toks[:, :12])
    with torch.inference_mode():
        lt, ct = TM.prefill(model, {"tokens": t(toks[:, :12])}, cfg, 24)
    for i in range(12, 17):
        what = "prefill" if i == 12 else f"decode {i - 1}"
        assert_close(lt, lr, dtype, f"{what} logits")
        want = dict(tree_flatten(jax.tree.map(np.asarray, cr)))
        got = dict(tree_flatten(ct))
        assert list(got) == list(want)
        for k, w in want.items():
            if w.dtype == np.int32:
                assert np.array_equal(got[k].numpy(), w), (what, k)
            else:
                assert str(got[k].dtype).split(".")[-1] == w.dtype.name, k
                assert_close(got[k], w, dtype, f"{what} {k}")
        if i < 16:
            lr, cr = dec(rp, cr, toks[:, i:i + 1], jnp.int32(i))
            with torch.inference_mode():
                lt, ct = TM.decode_step(model, ct, t(toks[:, i:i + 1]), i,
                                        cfg)


# ------------------------------------- the reference's tests/test_models.py

def _ref_style_batch(cfg, b=2, s=32) -> dict:
    toks = tokens(cfg, b, s, seed=0)
    return {"tokens": toks, "labels": toks}


@pytest.mark.parametrize("arch", FAMILIES)
def test_smoke_forward_and_loss(arch):
    cfg = TB.get_smoke(arch)
    model = TM.init_params(cfg, torch.Generator().manual_seed(0))
    with torch.inference_mode():
        loss = TM.loss_fn(model, tbatch(_ref_style_batch(cfg)), cfg)
    assert loss.shape == () and bool(torch.isfinite(loss)), arch
    assert 1.0 < float(loss) < 20.0, (arch, float(loss))


@pytest.mark.parametrize("arch", FAMILIES)
def test_smoke_train_step(arch):
    """Two microbatches of 2, the gate on; finite metrics, changed
    parameters, and the float32 leaves (the SSM's ``a_log``, ``d_skip``,
    ``dt_bias``; deepseek's router) through ``compress_tree`` and AdamW
    with float32 gradients (on the CPU for deepseek-v2)."""
    cfg = TB.get_smoke(arch)
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
    assert not torch.equal(before["embed"], after["embed"]), arch
    f32_leaves = (["seg1.moe.router"] if arch == MLA_ARCH else
                  [f"seg0.ssm.{k}" for k in ("a_log", "d_skip", "dt_bias")])
    for k in f32_leaves:
        g = seen[0][k]
        assert g.dtype == torch.float32 and bool(g.abs().sum() > 0), k
        assert after[k].dtype == torch.float32, k
        assert not torch.equal(after[k], before[k]), k


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_forward(arch):
    """float32, capacity factor 64 (no token dropped): prefill 15 tokens
    and decode the 16th == the full forward's last logits within 1e-4
    (deepseek: the absorbed form against the expanded one; mamba2: the
    recurrent step against the chunked SSD)."""
    cfg = dataclasses.replace(TB.get_smoke(arch), dtype="float32",
                              capacity_factor=64.0)
    model = TM.init_params(cfg, torch.Generator().manual_seed(0)).float()
    toks = torch.from_numpy(tokens(cfg, 2, 16, seed=9))
    with torch.inference_mode():
        full = TCLM.logits_fn(model, TCLM.forward(model, toks, cfg))
        _, cache = TM.prefill(model, {"tokens": toks[:, :15]}, cfg, 20)
        lg, _ = TM.decode_step(model, cache, toks[:, 15:16], 15, cfg)
    err = float((lg - full[:, 15]).abs().max())
    assert err < 1e-4, (arch, err)


# ---------------------------------------------------------------- training

@functools.lru_cache(maxsize=None)
def _ref_grads_fn(rcfg):
    return ref_jit(lambda p, b: JTS._grads(rcfg, p, b, 1))


ROUTED_APART_MAX = {"float32": 0.0, "bfloat16": 1 / 16}


def _ref_routes(rcfg, rp, toks) -> list:
    """The top-k indices of each MoE layer of the reference's forward, in
    layer order (its ``_top_k_gating`` read by an ordered callback)."""
    seen, orig = [], RMOE._top_k_gating

    def spy(logits, k):
        w, idx = orig(logits, k)
        jax.debug.callback(lambda i: seen.append(np.asarray(i)), idx,
                           ordered=True)
        return w, idx

    RMOE._top_k_gating = spy
    try:
        jax.block_until_ready(jax.jit(lambda p, tk: RCLM.forward(
            p, tk, rcfg, remat=False)).lower(rp, toks).compile(
            compiler_options={"xla_allow_excess_precision": False})(rp, toks))
    finally:
        RMOE._top_k_gating = orig
    return seen


class _RouteAs:
    """The port's ``moe._top_k_gating`` taking the given top-k indices,
    one per call in order (its weights the port's float32 softmax at
    those indices, normalized as ``_top_k_gating`` does), and counting
    the (token, choice) pairs its own logits would route elsewhere."""

    def __init__(self, routes):
        self.routes, self.calls = routes, 0
        self.apart = self.pairs = 0

    def __enter__(self):
        self.orig = TMOE._top_k_gating
        TMOE._top_k_gating = self
        return self

    def __exit__(self, *exc):
        TMOE._top_k_gating = self.orig

    def __call__(self, logits, k):
        _, own = self.orig(logits.detach(), k)
        idx = torch.from_numpy(self.routes[self.calls].copy()).to(own.dtype)
        self.calls += 1
        self.apart += int((own != idx).sum())
        self.pairs += own.numel()
        probs = torch.softmax(logits.to(torch.float32), dim=-1)
        w = torch.gather(probs, -1, idx)
        total = refmath.sum_rows_f32(w)[..., None]
        return w / torch.clamp(total, min=1e-9), idx


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_every_gradient_leaf(arch, dtype):
    """The loss and every gradient leaf against ``jax.jit`` of the
    reference's ``_grads``; float32 rtol 1e-5 / atol 1e-5 of the leaf's
    max; bfloat16 16 ulps of the leaf's max and within 1.5x the
    reference's own distance to its float32 gradient plus 2 ulps
    (``tests/test_torch_train.py``).  The float32 leaves' gradients are
    float32 in both dtypes; in a bfloat16 model they come through a
    bfloat16 product, so they are held as the bfloat16 leaves are.

    deepseek's MoE layers route as the reference's forward routes
    (``_RouteAs``): MLA's latent product ``x @ wkv_a`` rounds its
    float32 sums in the library's order, so the port's bfloat16 router
    logits are a few ulps from the reference's and a near-tied pair can
    go to another expert (1 of 256 at the last layer here).  The share
    of pairs the port's own logits route elsewhere is held to 0 in
    float32 and 1/16 in bfloat16 (``chip_smoke.FAM_ROUTING_DIFFERS_MAX``)."""
    cfg, rcfg = cfgs(arch, dtype)
    tree = ref_tree(rcfg, seed=6)
    toks = tokens(cfg, 4, 33, seed=7)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, jg = _ref_grads_fn(rcfg)(jtree(tree), jtree(batch))
    routes = (_ref_routes(rcfg, jtree(tree), batch["tokens"])
              if arch == MLA_ARCH else [])
    # with forced routes, no remat: a recomputed layer would take the
    # next layer's routes (checkpoint recomputes in reverse order)
    with _RouteAs(routes) if routes else contextlib.nullcontext() as ra:
        tl, tg = TTS._grads(cfg, convert.lm_tree(tree, "cpu"), tbatch(batch),
                            1, remat=not routes)
    if routes:
        assert ra.calls == len(routes) == cfg.num_layers - 1
        assert ra.apart <= ROUTED_APART_MAX[dtype] * ra.pairs, ra.apart
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL[dtype])
    want = dict(tree_flatten(jax.tree.map(np.asarray, jg)))
    got = dict(tree_flatten(tg))
    assert list(got) == list(want)
    if dtype == "bfloat16":
        r32 = dataclasses.replace(rcfg, dtype="float32")
        _, j32 = _ref_grads_fn(r32)(
            jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree),
            jtree(batch))
        want32 = dict(tree_flatten(jax.tree.map(np.asarray, j32)))
    for k in want:
        assert str(got[k].dtype).split(".")[-1] == want[k].dtype.name, k
        g, w = f32(got[k]), f32(want[k])
        m = float(np.abs(w).max())
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * m,
                                       err_msg=k)
            continue
        ulp = bf16_ulp(m)
        err = float(np.abs(g - w).max())
        assert err <= 16 * ulp, (k, err, 16 * ulp)
        e_port = float(np.abs(g - want32[k]).max())
        e_ref = float(np.abs(w - want32[k]).max())
        assert e_port <= 1.5 * e_ref + 2 * ulp, (k, e_port, e_ref)


def test_deepseek_remat_gradients_equal_reference(monkeypatch):
    """deepseek's default training path, every layer under ``checkpoint``
    across its two segments (the dense first layer, then the MoE scan),
    in float32 with capacity factor 64 and its own routes: the loss and
    every gradient leaf against the reference's ``_grads`` at rtol 1e-5 /
    atol 1e-5 of the leaf's max, and no pair routed apart."""
    cfg, rcfg = cfgs(MLA_ARCH, "float32", capacity_factor=64.0)
    assert [k for k, _ in TCLM.segments(cfg)] == ["dense0", "scan"]
    tree = ref_tree(rcfg, seed=6)
    toks = tokens(cfg, 4, 33, seed=7)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, jg = _ref_grads_fn(rcfg)(jtree(tree), jtree(batch))
    calls, routes = [], []
    orig_checkpoint, orig_gating = TCLM.checkpoint, TMOE._top_k_gating

    def counted(*a, **kw):
        calls.append(1)
        return orig_checkpoint(*a, **kw)

    def gating(logits, k):
        w, idx = orig_gating(logits, k)
        routes.append(idx.numpy().copy())
        return w, idx

    monkeypatch.setattr(TCLM, "checkpoint", counted)
    monkeypatch.setattr(TMOE, "_top_k_gating", gating)
    tl, tg = TTS._grads(cfg, convert.lm_tree(tree, "cpu"), tbatch(batch), 1,
                        remat=True)
    assert len(calls) == cfg.num_layers
    want_routes = _ref_routes(rcfg, jtree(tree), batch["tokens"])
    # the forward's routes, then each MoE layer's again as the backward
    # recomputes it, last layer first
    assert len(routes) == 2 * len(want_routes) == 2 * (cfg.num_layers - 1)
    for got_idx, want_idx in zip(routes, want_routes + want_routes[::-1]):
        np.testing.assert_array_equal(got_idx, want_idx)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL["float32"])
    want = dict(tree_flatten(jax.tree.map(np.asarray, jg)))
    got = dict(tree_flatten(tg))
    assert list(got) == list(want)
    for k in want:
        w = f32(want[k])
        np.testing.assert_allclose(f32(got[k]), w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=k)


def test_ssm_float32_leaves_compress_and_adamw_bitequal():
    """``compress_tree`` and one AdamW step on a bfloat16 mamba2 tree with
    its float32 ``a_log`` / ``d_skip`` / ``dt_bias`` leaves: the
    reference's bits (clip inactive)."""
    from repro.train import grad_compress as JGC
    from repro.train import optimizer as JOPT
    cfg, rcfg = cfgs(SSM_ARCH, "bfloat16")
    tree = ref_tree(rcfg, seed=8)
    toks = tokens(cfg, 4, 33, seed=9)
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
        want = dict(tree_flatten(jax.tree.map(np.asarray, want)))
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
        want = dict(tree_flatten(jax.tree.map(np.asarray, want)))
        for k, x in tree_flatten(got):
            assert np.array_equal(bits(x), bits(want[k])), (name, k)
    assert dict(tree_flatten(tp))["seg0.ssm.a_log"].dtype == torch.float32


# ---------------------------------------------------------------- convert

@pytest.mark.parametrize("arch", FAMILIES)
def test_convert_round_trips(arch):
    """Reference trees (bfloat16 leaves, the float32 ones, deepseek's two
    segments) into ``lm_params`` / ``lm_tree`` / ``train_state`` and a
    prefilled cache into ``lm_cache``: every leaf's dtype and bits kept;
    the model's modules hold them, layer by layer across the segments."""
    cfg, rcfg = cfgs(arch)
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
        w = dict(tree_flatten(jax.tree.map(np.asarray, ref)))
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
    kind = TCLM.MLACache if arch == MLA_ARCH else TCLM.HybridCache
    assert all(type(c) is kind for c in cache.values())
    if arch == SSM_ARCH:
        assert cache["seg0"].attn is None
        assert cache["seg0"].state.dtype == torch.float32


def test_init_cache_equals_reference_structure():
    """The port's empty caches: the reference's leaves (paths, shapes,
    dtypes, values), ssm's ``None`` dropped from the tree as JAX drops
    it."""
    for arch in FAMILIES:
        for dtype in DTYPES:
            cfg, rcfg = cfgs(arch, dtype)
            want = dict(tree_flatten(jax.tree.map(
                np.asarray, RCLM.init_cache(rcfg, 2, 24))))
            got = dict(tree_flatten(TCLM.init_cache(cfg, 2, 24, "cpu")))
            assert list(got) == list(want), arch
            for k, w in want.items():
                assert tuple(got[k].shape) == w.shape, k
                assert str(got[k].dtype).split(".")[-1] == w.dtype.name, k
                assert np.array_equal(bits(got[k]), bits(w)), k


# ---------------------------------------------------------------- serving

@pytest.mark.parametrize("arch", FAMILIES)
def test_gate_on_a_prefilled_cache_bitequal(arch):
    """The reference's prefilled cache of the family (MLA: ``ckv`` and
    ``krope`` of both segments; SSM: ``conv`` and the float32 ``state``),
    gated by both engines: the candidates, CRs (the jitted size model),
    rewritten leaves and metering bit-equal."""
    cfg, rcfg = cfgs(arch)
    tree = ref_tree(rcfg, seed=12)
    rp = jtree(tree)
    toks = tokens(cfg, 2, 10, seed=13)
    _, rcache = ref_jit(lambda p, tk: RM.prefill(p, {"tokens": tk}, rcfg,
                                                 16))(rp, toks)
    cache = convert.lm_cache(jax.tree.map(np.asarray, rcache), device="cpu")
    ref = RE.Engine(rcfg, rp, RE.ServeConfig(max_len=16, kv_compress=True))
    eng = TE.Engine(cfg, None, TE.ServeConfig(max_len=16, kv_compress=True))
    names = [k for k, x in tree_flatten(cache)
             if x.dtype in (torch.bfloat16, torch.float32) and x.ndim >= 4]
    assert names == ([f"seg{i}.{k}" for i in (0, 1)
                      for k in ("ckv", "krope")] if arch == MLA_ARCH else
                     ["seg0.conv", "seg0.state"])
    rl = [x for x in jax.tree.leaves(rcache)
          if x.dtype in (jnp.bfloat16, jnp.float32) and x.ndim >= 4]
    tl = dict(tree_flatten(cache))
    want_crs = np.asarray(ref._gate_crs(tuple(rl)))
    got_crs = eng._predict_crs([tl[k] for k in names])
    assert np.array_equal(got_crs.view(np.uint32), want_crs.view(np.uint32))
    got = tree_leaves(eng._maybe_compress_cache(cache))
    want = jax.tree.leaves(ref._maybe_compress_cache(rcache))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(bits(g), bits(w))
    assert (eng.kv_saved_bytes, eng.kv_total_bytes) == \
        (ref.kv_saved_bytes, ref.kv_total_bytes)


@pytest.mark.parametrize("arch", FAMILIES)
def test_launchers_serve_and_train_the_family(arch, tmp_path):
    """``launch.serve`` with the gate, directly and through the service
    (the same ids and metering), and ``launch.train --compress
    --lossy-ckpt`` (the float32 leaves go through the lossy checkpoint
    like the others), on the smoke config."""
    base = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--steps", "4", "--max-len", "16",
            "--kv-compress"]
    a = TLS.main(base)
    b = TLS.main(base + ["--kv-gate-service"])
    assert a["shape"] == [2, 4] and a["ids"] == b["ids"]
    assert a["params"] == TM.count_params(TB.get_smoke(arch))
    assert (a["kv_saved_bytes"], a["kv_total_bytes"]) == \
        (b["kv_saved_bytes"], b["kv_total_bytes"])
    assert b["kv_gate"]["rows"] == (4 if arch == MLA_ARCH else 2)
    r = TLT.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                  "4", "--batch", "4", "--seq", "32", "--compress",
                  "--lossy-ckpt", "--ckpt-dir", str(tmp_path)])
    assert sorted(r["losses"]) == [0, 1, 2, 3]
    assert np.all(np.isfinite(list(r["losses"].values())))
    assert r["params"] == TM.count_params(TB.get_smoke(arch))
