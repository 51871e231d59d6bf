"""The port's encdec family (``models.whisper``: the encoder over the
stubbed frontend's frames, the decoder with self- and cross-attention,
``layers.layer_norm`` and ``layers.gelu_mlp``) against the reference on
the CPU, at whisper-large-v3's smoke config (2 + 2 layers, 64 frames).

Inputs are numpy arrays made from a seed; the reference runs as its own
tests run it (``jax.jit`` of its functions), compiled with XLA's
``xla_allow_excess_precision`` off as ``tests/test_torch_families.py``
compiles it (``ref_jit``), and its parameters are carried into the port
with ``convert``.  Every leaf whose init is a constant (the norms' gains
and offsets, the biases) is perturbed first, so that it is exercised.

Bounds:

* bit-equal: parameter tables, counts and ``active_params``; converted
  parameters and caches; the cache's leaves and their order; the KV
  gate's CRs, rewritten leaves and metering; ``pos``;
* ``layers.gelu`` (``jax.nn.gelu``'s tanh form, written out in its
  order) within 4 float32 ulps of |x| of ``jax.jit``'s (2 seen over
  300 001 values in [-12, 12]: XLA's CPU ``tanh`` is its own rational
  approximation, 2.4e-7 from PyTorch's); ``layer_norm`` at the float32
  bound (7.2e-7 seen);
* float32: rtol 1e-5, atol 2e-5 (attention, the encoder's memory,
  logits, caches); loss rtol 1e-5; gradients rtol 1e-5 / atol 1e-5 of
  the leaf's largest |value|;
* bfloat16: 4 bfloat16 ulps of the largest |value|, loss rtol 1e-3,
  gradients 16 ulps of the leaf's largest |value| and no farther from
  the reference's float32 gradient than 1.5x the reference's own
  bfloat16 gradient plus 2 ulps;
* the reference's own properties (``tests/test_models.py``): decode ==
  the full forward within 1e-4 in float32, a smoke loss in (1, 20).
"""
import dataclasses
import functools
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as RB  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import whisper as RWSP  # noqa: E402
from repro.serve import engine as RE  # noqa: E402
from repro.train import train_step as JTS  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.launch import serve as TLS  # noqa: E402
from repro_torch.launch import train as TLT  # noqa: E402
from repro_torch.models import causal_lm as TCLM  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import whisper as TWSP  # noqa: E402
from repro_torch.models.params import (ParamDef, tree_flatten,  # noqa: E402
                                       tree_leaves)
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.serve.sweep_service import (ServiceConfig,  # noqa: E402
                                             SweepService)
from repro_torch.train import train_step as TTS  # noqa: E402

from test_torch_families import (LOSS_RTOL, assert_close, bits,  # noqa: E402
                                 cfgs, ref_jit, t, tokens)
from test_torch_hybrid import (assert_grads, assert_tree_close,  # noqa: E402
                               flat_ref, jtree, perturbed, tbatch)

ARCH = "whisper-large-v3"
DTYPES = ["float32", "bfloat16"]
GELU_ULPS = 4


def ref_tree(rcfg, seed: int = 0) -> dict:
    """The reference's parameters as numpy in the config's dtype, the
    norms' gains about 1 and their offsets and every bias about 0."""
    dt = jnp.dtype(rcfg.dtype)
    tree = jax.tree.map(lambda a: np.asarray(a.astype(dt)),
                        RM.init_params(rcfg, jax.random.PRNGKey(seed)))
    names = [k for k, _ in tree_flatten(tree)]
    last = {k.split(".")[-1] for k in names}
    ones = {k for k in last if k.endswith("_g")}
    zeros = {k for k in last if k.endswith("_b") or k.lstrip("x_")[:1] == "b"}
    return perturbed(tree, ones, zeros, seed)


def frames(cfg, b: int, seed: int = 5) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_frames, cfg.d_model)).astype(jnp.dtype(cfg.dtype))


def batch_of(cfg, b: int, s: int, seed: int = 2) -> dict:
    toks = tokens(cfg, b, s + 1, seed=seed)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "frames": frames(cfg, b, seed + 3)}


# ---------------------------------------------------------------- tables

@pytest.mark.parametrize("size", ["full", "smoke"])
def test_param_table_counts_and_active_params(size):
    """Names, shapes and dtypes of the ``enc`` / ``dec`` stacks and the
    top leaves == the reference's ``M.abstract_params`` without
    allocating; counts and ``active_params`` equal; whisper-large-v3
    whole is 1 614 643 200 parameters."""
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
    assert "dec.x_wk" in got and "dec.bk" not in got and "dec.x_bk" not in got
    if size == "full":
        assert TM.count_params(cfg) == 1_614_643_200
        cut = dataclasses.replace(cfg, num_layers=2, encoder_layers=2)
        rcut = dataclasses.replace(rcfg, num_layers=2, encoder_layers=2)
        assert TM.count_params(cut) == RM.count_params(rcut)


# ---------------------------------------------------------------- layers

def test_gelu_is_jax_tanh_form():
    """``layers.gelu`` against ``jax.jit(jax.nn.gelu)`` (its default, the
    tanh approximation) on normal draws and a grid over [-12, 12]:
    within ``GELU_ULPS`` float32 ulps of |x|; ``F.gelu``'s default (the
    erf form) is farther."""
    x = np.concatenate([
        4 * np.random.default_rng(0).standard_normal(200_000),
        np.linspace(-12, 12, 100_001)]).astype(np.float32)
    want = np.asarray(ref_jit(jax.nn.gelu)(x))
    got = TL.gelu(torch.from_numpy(x)).numpy()
    err = np.abs(got - want)
    assert np.all(err <= GELU_ULPS * np.spacing(np.abs(x))), float(
        (err / np.spacing(np.abs(x))).max())
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 100 * err.max()


@pytest.mark.parametrize("dtype", DTYPES)
def test_layer_norm_and_gelu_mlp_match_reference(dtype):
    """``layer_norm`` (two-pass, float32 inside, cast back) and
    ``gelu_mlp`` (biased, the GELU in float32) on offset, scaled rows."""
    rng = np.random.default_rng(1)
    dt = jnp.dtype(dtype)
    x = (3 * rng.standard_normal((2, 7, 64)) + 1.5).astype(dt)
    g = (1 + 0.1 * rng.standard_normal(64)).astype(dt)
    b = (0.3 * rng.standard_normal(64)).astype(dt)
    assert_close(TL.layer_norm(t(x), t(g), t(b)),
                 ref_jit(RL.layer_norm)(x, g, b), dtype, "layer_norm")
    w1 = (rng.standard_normal((64, 128)) / 8).astype(dt)
    b1 = (0.3 * rng.standard_normal(128)).astype(dt)
    w2 = (rng.standard_normal((128, 64)) / 11).astype(dt)
    b2 = (0.3 * rng.standard_normal(64)).astype(dt)
    assert_close(TL.gelu_mlp(t(x), t(w1), t(b1), t(w2), t(b2)),
                 ref_jit(RL.gelu_mlp)(x, w1, b1, w2, b2), dtype, "gelu_mlp")


@pytest.mark.parametrize("frames_", [64, 1500])
@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_attention_over_frames(dtype, frames_):
    """Non-causal attention over the frames: 1500 is not a multiple of
    the 1024-query chunk, so the last chunk is zero-padded."""
    rng = np.random.default_rng(2)
    dt = jnp.dtype(dtype)
    q, k, v = (rng.standard_normal((1, frames_, 2, 16)).astype(dt)
               for _ in range(3))
    want = ref_jit(lambda q, k, v: RL.attention(q, k, v, causal=False))(
        q, k, v)
    got = TL.attention(t(q), t(k), t(v), causal=False)
    assert_close(got, want, dtype, "attention")


# ---------------------------------------------------------------- model

@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_decode_and_loss_equal_reference(dtype):
    """The encoder's memory (the frames cast to the activation dtype,
    then ``pos_enc``), the decoder's final hidden without a cache and the
    loss, on the same converted parameters."""
    cfg, rcfg = cfgs(ARCH, dtype)
    tree = ref_tree(rcfg, seed=1)
    rp = jtree(tree)
    model = convert.lm_params(tree, cfg, device="cpu")
    assert isinstance(model, TWSP.Whisper)
    batch = batch_of(cfg, 2, 12)
    mem_r = ref_jit(lambda p, f: RWSP.encode(p, f, rcfg))(rp, batch["frames"])
    hid_r = ref_jit(lambda p, tk, m: RWSP.decode(p, tk, m, rcfg)[0])(
        rp, batch["tokens"], mem_r)
    with torch.inference_mode():
        mem = TWSP.encode(model, t(batch["frames"]), cfg)
        hid, cache = TWSP.decode(model, t(batch["tokens"]), mem, cfg)
    assert cache is None
    assert_close(mem, mem_r, dtype, "memory")
    assert_close(hid, hid_r, dtype, "hidden")
    wl = ref_jit(lambda p, b: RM.loss_fn(p, b, rcfg))(rp, jtree(batch))
    with torch.inference_mode():
        tl = TM.loss_fn(model, tbatch(batch), cfg)
    np.testing.assert_allclose(float(tl), float(wl), rtol=LOSS_RTOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_teacher_forced_decode(dtype):
    """``model.prefill`` (encode, the cross K/V from the memory, the
    decoder written into the cache) and 4 decode steps fed the same
    tokens, the self-attention cache written at ``pos % T`` in place:
    logits and every cache leaf (``k``, ``v``, ``pos``, ``xk``, ``xv``)."""
    cfg, rcfg = cfgs(ARCH, dtype)
    tree = ref_tree(rcfg, seed=2)
    rp = jtree(tree)
    model = convert.lm_params(tree, cfg, device="cpu")
    toks = tokens(cfg, 2, 16, seed=3)
    fr = frames(cfg, 2)
    pre = ref_jit(lambda p, b: RM.prefill(p, b, rcfg, 20))
    dec = ref_jit(lambda p, c, tk, pos: RM.decode_step(p, c, tk, pos, rcfg))
    lr, cr = pre(rp, {"tokens": toks[:, :11], "frames": fr})
    with torch.inference_mode():
        lt, ct = TM.prefill(model, {"tokens": t(toks[:, :11]),
                                    "frames": t(fr)}, cfg, 20)
    assert isinstance(ct, TWSP.WhisperCache)
    for i in range(11, 16):
        what = "prefill" if i == 11 else f"decode {i - 1}"
        assert_close(lt, lr, dtype, f"{what} logits")
        assert_tree_close(ct, cr, dtype, what)
        if i < 15:
            lr, cr = dec(rp, cr, toks[:, i:i + 1], jnp.int32(i))
            with torch.inference_mode():
                lt, ct = TM.decode_step(model, ct, t(toks[:, i:i + 1]), i,
                                        cfg)


def test_init_cache_equals_reference_structure():
    """``model.init_cache``'s zero placeholders for the cross K/V (shaped
    by ``encoder_frames``) and ``whisper.init_cache``'s cross K/V from a
    memory: the reference's leaves, shapes, dtypes and values."""
    for dtype in DTYPES:
        cfg, rcfg = cfgs(ARCH, dtype)
        want = flat_ref(RM.init_cache(rcfg, None, 2, 24))
        model = TM.init_params(cfg, torch.Generator().manual_seed(0))
        got = dict(tree_flatten(TM.init_cache(cfg, model, 2, 24)))
        assert list(got) == list(want) == ["k", "v", "pos", "xk", "xv"]
        for k, w in want.items():
            assert tuple(got[k].shape) == w.shape, k
            assert str(got[k].dtype).split(".")[-1] == w.dtype.name, k
            assert np.array_equal(bits(got[k]), bits(w)), k
    cfg, rcfg = cfgs(ARCH, "float32")
    tree = ref_tree(rcfg, seed=4)
    mem = np.random.default_rng(4).standard_normal(
        (2, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    want = ref_jit(lambda p, m: RWSP.init_cache(p, m, rcfg, 24))(
        jtree(tree), mem)
    got = TWSP.init_cache(convert.lm_params(tree, cfg, device="cpu"),
                          t(mem), cfg, 24)
    assert_tree_close(got, want, "float32", "init_cache")


# ------------------------------------- the reference's tests/test_models.py

def _ref_style_batch(cfg, b=2, s=32) -> dict:
    toks = tokens(cfg, b, s, seed=0)
    return {"tokens": toks, "labels": toks, "frames": frames(cfg, b, 0)}


def test_smoke_forward_and_loss():
    cfg = TB.get_smoke(ARCH)
    model = TM.init_params(cfg, torch.Generator().manual_seed(0))
    with torch.inference_mode():
        loss = TM.loss_fn(model, tbatch(_ref_style_batch(cfg)), cfg)
    assert loss.shape == () and bool(torch.isfinite(loss))
    assert 1.0 < float(loss) < 20.0, float(loss)


def test_smoke_train_step():
    """Two microbatches of 2 (the frames split with the tokens), the
    gate on: finite metrics, changed parameters in both stacks."""
    from repro_torch.train import grad_compress as TGC
    cfg = TB.get_smoke(ARCH)
    state = TTS.init_state(cfg, torch.Generator().manual_seed(0),
                           compress=True)
    before = {k: x.clone() for k, x in tree_flatten(state.params)}
    step = TTS.make_train_step(cfg, microbatches=2,
                               compress=TGC.CompressConfig())
    state2, m = step(state, tbatch(_ref_style_batch(cfg, b=4)))
    assert bool(torch.isfinite(m["loss"])) and bool(
        torch.isfinite(m["grad_norm"]))
    after = dict(tree_flatten(state2.params))
    for k in ("embed", "pos_enc", "enc.wq", "dec.x_wk", "dec.w1"):
        assert not torch.equal(before[k], after[k]), k


def test_decode_matches_forward():
    """float32: prefill 15 tokens with the frames and decode the 16th ==
    the decoder's full forward's last logits within 1e-4."""
    cfg = dataclasses.replace(TB.get_smoke(ARCH), dtype="float32")
    model = TM.init_params(cfg, torch.Generator().manual_seed(0)).float()
    toks = torch.from_numpy(tokens(cfg, 2, 16, seed=9))
    fr = torch.from_numpy(frames(cfg, 2, 9))
    with torch.inference_mode():
        mem = TWSP.encode(model, fr, cfg)
        full = TCLM.logits_fn(model, TWSP.decode(model, toks, mem, cfg)[0])
        _, cache = TM.prefill(model, {"tokens": toks[:, :15], "frames": fr},
                              cfg, 20)
        lg, _ = TM.decode_step(model, cache, toks[:, 15:16], 15, cfg)
    err = float((lg - full[:, 15]).abs().max())
    assert err < 1e-4, err


# ---------------------------------------------------------------- training

@functools.lru_cache(maxsize=None)
def _ref_grads_fn(rcfg, microbatches: int = 1):
    return ref_jit(lambda p, b: JTS._grads(rcfg, p, b, microbatches))


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_and_every_gradient_leaf(dtype, microbatches):
    """The loss and every gradient leaf (both stacks, the positions,
    the cross-attention's leaves) against ``jax.jit`` of the reference's
    ``_grads``, on the default remat path (each encoder and decoder
    layer under ``checkpoint``); with 2 microbatches, each splitting the
    frames with the tokens, as the reference's step splits them."""
    cfg, rcfg = cfgs(ARCH, dtype)
    tree = ref_tree(rcfg, seed=6)
    batch = batch_of(cfg, 4, 16, seed=7)
    jl, jg = _ref_grads_fn(rcfg, microbatches)(jtree(tree), jtree(batch))
    calls = []
    orig = TWSP.checkpoint

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    TWSP.checkpoint = counted
    try:
        tl, tg = TTS._grads(cfg, convert.lm_tree(tree, "cpu"), tbatch(batch),
                            microbatches)
    finally:
        TWSP.checkpoint = orig
    assert len(calls) == microbatches * (cfg.encoder_layers + cfg.num_layers)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL[dtype])
    want32 = None
    if dtype == "bfloat16":
        r32 = dataclasses.replace(rcfg, dtype="float32")
        _, j32 = _ref_grads_fn(r32, microbatches)(
            jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree),
            jtree(dict(batch, frames=batch["frames"].astype(np.float32))))
        want32 = flat_ref(j32)
    assert_grads(tg, jg, dtype, want32)


# ---------------------------------------------------------------- convert

def test_convert_round_trips():
    """A reference tree (the ``enc`` / ``dec`` stacks and the top
    leaves) into ``lm_params`` / ``lm_tree`` / ``train_state``, and a
    prefilled ``WhisperCache`` (bare, not a dict of segments) into
    ``lm_cache``: every leaf's dtype and bits kept, the model's layers
    holding their slices."""
    cfg, rcfg = cfgs(ARCH)
    tree = ref_tree(rcfg, seed=11)
    model = convert.lm_params(tree, cfg, device="cpu")
    named = dict(model.named_parameters())
    for k, a in tree_flatten(tree):
        parts = k.split(".")
        if parts[0] in ("enc", "dec"):
            for j in range(a.shape[0]):
                x = named[f"{parts[0]}.{j}.{parts[1]}"]
                assert np.array_equal(bits(x), bits(a[j])), (k, j)
        else:
            assert np.array_equal(bits(named[k]), bits(a)), k
    back = dict(tree_flatten(convert.lm_tree(tree, "cpu")))
    for k, a in tree_flatten(tree):
        assert str(back[k].dtype).split(".")[-1] == a.dtype.name, k
        assert np.array_equal(bits(back[k]), bits(a)), k
    rst = JTS.init_state(rcfg, jax.random.PRNGKey(1), compress=True)
    st = convert.train_state(jax.tree.map(np.asarray, rst), "cpu")
    for got, ref in ((st.params, rst.params), (st.opt.mu, rst.opt.mu),
                     (st.ef.residuals, rst.ef.residuals)):
        w = flat_ref(ref)
        for k, x in tree_flatten(got):
            assert np.array_equal(bits(x), bits(w[k])), k
    _, rcache = ref_jit(lambda p, b: RM.prefill(p, b, rcfg, 12))(
        jtree(tree), {"tokens": tokens(cfg, 2, 8), "frames": frames(cfg, 2)})
    rc = jax.tree.map(np.asarray, rcache)
    cache = convert.lm_cache(rc, device="cpu")
    assert type(cache) is TWSP.WhisperCache
    want = dict(tree_flatten(rc))
    got = dict(tree_flatten(cache))
    assert list(got) == list(want)
    for k, x in got.items():
        assert np.array_equal(bits(x), bits(want[k])), k


# ---------------------------------------------------------------- serving

def test_gate_on_a_prefilled_cache_bitequal():
    """The reference's prefilled cache, gated by both engines, the port's
    through its own call and through a ``SweepService``: the scored
    leaves (``k``, ``v``, ``xk``, ``xv``; not the int32 ``pos``), CRs,
    rewritten leaves and metering bit-equal."""
    cfg, rcfg = cfgs(ARCH)
    tree = ref_tree(rcfg, seed=12)
    rp = jtree(tree)
    _, rcache = ref_jit(lambda p, b: RM.prefill(p, b, rcfg, 16))(
        rp, {"tokens": tokens(cfg, 2, 10, seed=13), "frames": frames(cfg, 2)})
    rc = jax.tree.map(np.asarray, rcache)
    ref = RE.Engine(rcfg, rp, RE.ServeConfig(max_len=16, kv_compress=True))
    want_leaves = jax.tree.leaves(ref._maybe_compress_cache(rcache))
    rl = [x for x in jax.tree.leaves(rcache)
          if x.dtype in (jnp.bfloat16, jnp.float32) and x.ndim >= 4]
    want_crs = np.asarray(ref._gate_crs(tuple(rl)))
    for svc in (None, SweepService(ServiceConfig(max_wait_ms=1.0),
                                   device="cpu")):
        try:
            cache = convert.lm_cache(rc, device="cpu")
            eng = TE.Engine(cfg, None, TE.ServeConfig(max_len=16,
                                                      kv_compress=True),
                            sweep_service=svc)
            names = [k for k, x in tree_flatten(cache)
                     if x.dtype in (torch.bfloat16, torch.float32)
                     and x.ndim >= 4]
            assert names == ["k", "v", "xk", "xv"]
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
        finally:
            if svc is not None:
                svc.close()


def test_engine_generate_passes_frames(tmp_path):
    """``Engine.generate`` on a batch with frames, with the gate, directly
    and through the service: the same ids and metering, one kv_gate
    request of 4 rows; the ids == the reference engine's in float32."""
    cfg, rcfg = cfgs(ARCH, "float32")
    tree = ref_tree(rcfg, seed=14)
    model = convert.lm_params(tree, cfg, device="cpu")
    batch = {"tokens": tokens(cfg, 2, 8, seed=15), "frames": frames(cfg, 2)}
    ref = RE.Engine(rcfg, jtree(tree), RE.ServeConfig(max_len=16))
    want = np.asarray(ref.generate(jtree(batch), steps=4))
    runs = []
    for svc in (None, SweepService(ServiceConfig(max_wait_ms=1.0),
                                   device="cpu")):
        try:
            eng = TE.Engine(cfg, model, TE.ServeConfig(
                max_len=16, kv_compress=True), sweep_service=svc)
            ids = eng.generate(tbatch(batch), steps=4)
            runs.append((ids.tolist(), eng.kv_saved_bytes,
                         eng.kv_total_bytes))
            if svc is not None:
                gate = svc.stats()["methods"]["kv_gate"]
                assert (gate["completed"], gate["rows"]) == (1, 4)
        finally:
            if svc is not None:
                svc.close()
    assert runs[0] == runs[1]
    plain = TE.Engine(cfg, model, TE.ServeConfig(max_len=16))
    assert np.array_equal(plain.generate(tbatch(batch), steps=4).numpy(),
                          want)


def test_launchers_train_and_refuse_to_serve(tmp_path, monkeypatch):
    """``launch.train --compress --lossy-ckpt`` trains the smoke model on
    the data stream's frames; ``launch.serve`` fails in both packages,
    whose batches carry no frames (the reference's in its prefill with
    ``KeyError: 'frames'``, the port's before it builds a model, naming
    the frames)."""
    r = TLT.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps",
                  "4", "--batch", "4", "--seq", "32", "--compress",
                  "--lossy-ckpt", "--ckpt-dir", str(tmp_path)])
    assert sorted(r["losses"]) == [0, 1, 2, 3]
    assert np.all(np.isfinite(list(r["losses"].values())))
    assert r["params"] == TM.count_params(TB.get_smoke(ARCH))
    argv = ["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "8",
            "--steps", "2", "--max-len", "16"]
    with pytest.raises(SystemExit) as exc:
        TLS.main(argv + ["--device", "cpu"])
    assert exc.value.code == 2
    from repro.launch import serve as RLS
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with pytest.raises(KeyError, match="frames"):
        RLS.main()
    with pytest.raises(KeyError, match="frames"):
        TM.prefill(TM.init_params(TB.get_smoke(ARCH),
                                  torch.Generator().manual_seed(0)),
                   {"tokens": torch.zeros((1, 4), dtype=torch.int32)},
                   TB.get_smoke(ARCH), 8)
