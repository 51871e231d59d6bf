"""The port's LLM configs and dense model (``repro_torch.configs``,
``repro_torch.models``) against the reference on the CPU.

Inputs are numpy arrays made from a seed; the reference runs as its own
tests run it (``jax.jit`` of ``CLM.forward`` / ``M.prefill`` /
``M.decode_step``) and its parameters are carried into the port with
``convert.lm_params`` (norms and QKV biases perturbed first, so that
they are exercised).

Tolerances:

* float32: rtol 1e-5, atol 2e-5 (matmul summation orders and XLA's
  ``sin``/``cos`` are not torch's);
* bfloat16: 4 bfloat16 ulps of the largest |value| compared (the two
  libraries round products and fused chains at different points, one or
  two ulps each; at |logit| ~4, 4 ulps are 0.125), so bfloat16 parity
  is teacher-forced;
* exact: ``pos`` caches, and the scaled query at head dims 64, 80 and
  128 in bfloat16 (the scale rounded to bfloat16 first, as JAX rounds a
  weak-typed Python float).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as RB  # noqa: E402
from repro.models import causal_lm as RCLM  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.models import causal_lm as TCLM  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.params import ParamDef, tree_flatten  # noqa: E402

DENSE = ["granite-3-2b", "granite-8b", "stablelm-3b", "codeqwen1.5-7b"]
F32_TOL = dict(rtol=1e-5, atol=2e-5)
BF16_ULPS = 4


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def bf16_ulp(m: float) -> float:
    """The spacing of bfloat16 values at magnitude ``m``."""
    return 2.0 ** (np.floor(np.log2(max(m, 2.0 ** -126))) - 7)


def assert_close(got, want, dtype: str, what: str = "") -> None:
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, err_msg=what, **F32_TOL)
        return
    tol = BF16_ULPS * bf16_ulp(float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


def ref_params(cfg, seed: int = 0):
    """The reference's parameters in ``cfg.dtype`` as numpy, norms and
    biases perturbed (their inits are constants)."""
    dt = jnp.dtype(cfg.dtype)
    tree = jax.tree.map(lambda a: np.asarray(a.astype(dt)),
                        RM.init_params(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    seg = tree["seg0"]
    for k in ("norm1", "norm2"):
        seg[k] = (1 + 0.1 * rng.standard_normal(seg[k].shape)).astype(dt)
    tree["final_norm"] = (1 + 0.1 * rng.standard_normal(
        tree["final_norm"].shape)).astype(dt)
    for k in ("bq", "bk", "bv"):
        if k in seg["attn"]:
            seg["attn"][k] = (0.1 * rng.standard_normal(
                seg["attn"][k].shape)).astype(dt)
    return tree


def both_models(cfg, seed: int = 0):
    tree = ref_params(cfg, seed)
    return (jax.tree.map(jnp.asarray, tree),
            convert.lm_params(tree, cfg, device="cpu"))


def tokens(cfg, b: int, s: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def t(x) -> torch.Tensor:
    return convert.array(x, "cpu")


# ---------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", RB.ARCH_IDS)
def test_config_fields_equal_reference(arch):
    """Every field of the full and smoke configs, and the derived dims."""
    for get in ("get_arch", "get_smoke"):
        r, p = getattr(RB, get)(arch), getattr(TB, get)(arch)
        assert dataclasses.asdict(r) == dataclasses.asdict(p), (arch, get)
        assert (r.hd, r.padded_vocab, r.attention_free, r.subquadratic) == \
            (p.hd, p.padded_vocab, p.attention_free, p.subquadratic)


def test_shapes_and_arch_ids_equal_reference():
    assert TB.ARCH_IDS == RB.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in TB.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in RB.SHAPES.items()}


def test_full_configs_match_assignment():
    """The reference's published dims (``tests/test_models.py``)."""
    spec = {
        "stablelm-3b": (32, 2560, 32, 32, 6912, 50304),
        "codeqwen1.5-7b": (32, 4096, 32, 32, 13440, 92416),
        "granite-8b": (36, 4096, 32, 8, 14336, 49152),
        "granite-3-2b": (40, 2048, 32, 8, 8192, 49155),
        "phi3.5-moe-42b-a6.6b": (32, 4096, 32, 8, 6400, 32064),
        "deepseek-v2-236b": (60, 5120, 128, 128, 1536, 102400),
        "whisper-large-v3": (32, 1280, 20, 20, 5120, 51866),
        "mamba2-370m": (48, 1024, 32, 32, 0, 50280),
        "qwen2-vl-72b": (80, 8192, 64, 8, 29568, 152064),
        "hymba-1.5b": (32, 1600, 25, 5, 5504, 32001),
    }
    for arch, (l, d, h, kv, ff, v) in spec.items():
        cfg = TB.get_arch(arch)
        assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                cfg.d_ff, cfg.vocab_size) == (l, d, h, kv, ff, v), arch


@pytest.mark.parametrize("arch", DENSE)
def test_param_table_equals_reference_at_full_size(arch):
    """Names, shapes and dtypes of the table == ``M.abstract_params``,
    and the counts, without allocating either."""
    cfg = TB.get_arch(arch)
    ref = {".".join(str(getattr(k, "key", k)) for k in path): leaf
           for path, leaf in jax.tree_util.tree_flatten_with_path(
               RM.abstract_params(RB.get_arch(arch)))[0]}
    got = dict(tree_flatten(TM.param_table(cfg),
                            lambda x: isinstance(x, ParamDef)))
    assert list(got) == list(ref)
    for name, d in got.items():
        assert d.shape == ref[name].shape, name
        assert str(d.dtype).split(".")[-1] == np.dtype(ref[name].dtype).name
    assert TM.count_params(cfg) == RM.count_params(RB.get_arch(arch))
    assert TM.active_params(cfg) == RM.active_params(RB.get_arch(arch))
    if arch == "granite-3-2b":
        assert TM.count_params(cfg) == cfg.param_count() == 2_635_237_376


def test_other_families_raise():
    """Every one of the ten configs builds (its smoke model allocated,
    its full one sized without allocating); what still raises is
    a mesh's ``model`` axis (ROADMAP Queue 1 item 7, its model-axis
    half)."""
    from repro_torch.train import train_step as TTS
    for arch in TB.ARCH_IDS:
        cfg = TB.get_smoke(arch)
        model = TM.init_params(cfg, torch.Generator().manual_seed(0))
        assert sum(p.numel() for p in model.parameters()) == \
            TM.count_params(cfg) == cfg.param_count(), arch
        assert TM.count_params(TB.get_arch(arch)) == \
            RM.count_params(RB.get_arch(arch)), arch
    from repro_torch.dist import sharding as S
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        TTS.make_train_step(TB.get_smoke("hymba-1.5b"), mode="podsync",
                            mesh=S.AbstractMesh((1, 1, 2),
                                                ("pod", "data", "model")))
    with pytest.raises(ValueError, match="'pod' axis"):
        TTS.make_train_step(TB.get_smoke("hymba-1.5b"), mode="podsync")


def test_init_params_rules():
    """zeros / ones / normal * scale / sqrt(shape[-2]), in the def's dtype."""
    cfg = TB.get_smoke("codeqwen1.5-7b")
    model = TM.init_params(cfg, torch.Generator().manual_seed(0))
    assert model.layers[1].attn.bq.dtype == torch.bfloat16
    assert not model.layers[1].attn.bq.any()
    assert bool((model.layers[0].norm2 == 1).all())
    for w, fan_in in ((model.layers[0].mlp.wg, cfg.d_model),
                      (model.lm_head, cfg.d_model),
                      (model.embed, cfg.padded_vocab)):
        std = float(w.float().std())
        assert abs(std * np.sqrt(fan_in) - 1.0) < 0.1, (w.shape, std)


# ---------------------------------------------------------------- layers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_swiglu(dtype):
    rng = np.random.default_rng(2)
    dt = jnp.dtype(dtype)
    x = rng.standard_normal((2, 5, 64)).astype(dt)
    g = (1 + 0.1 * rng.standard_normal(64)).astype(dt)
    assert_close(TL.rms_norm(t(x), t(g)),
                 jax.jit(RL.rms_norm)(jnp.asarray(x), jnp.asarray(g)),
                 dtype, "rms_norm")
    wg, wu = (rng.standard_normal((64, 96)).astype(dt) / 8 for _ in "gu")
    wd = rng.standard_normal((96, 64)).astype(dt) / 10
    assert_close(TL.swiglu(t(x), t(wg), t(wu), t(wd)),
                 jax.jit(RL.swiglu)(*map(jnp.asarray, (x, wg, wu, wd))),
                 dtype, "swiglu")


@pytest.mark.parametrize("partial", [1.0, 0.25])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope(dtype, partial):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 4, 80)).astype(jnp.dtype(dtype))
    pos = (np.arange(7)[None, :] + 1000).astype(np.int32)
    want = jax.jit(lambda x, p: RL.apply_rope(x, p, 1e6, partial))(x, pos)
    assert_close(TL.apply_rope(t(x), t(pos), 1e6, partial), want, dtype)
    if partial < 1.0:       # the unrotated dims pass unchanged
        assert np.array_equal(f32(TL.apply_rope(t(x), t(pos), 1e6,
                                                partial))[..., 20:],
                              f32(x)[..., 20:])


@pytest.mark.parametrize("hd", [64, 80, 128])
def test_scaled_query_bitequal_in_bfloat16(hd):
    """JAX rounds the weak-typed scale to bfloat16 before the product; a
    Python float on a torch bfloat16 tensor would not be."""
    rng = np.random.default_rng(hd)
    q = rng.standard_normal((4, 16, 8, hd)).astype(jnp.bfloat16)
    want = jax.jit(lambda q: (q * hd ** -0.5).astype(q.dtype))(q)
    got = TL.scaled_query(t(q), hd ** -0.5)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(),
                          np.asarray(want).view(np.int16))


ATTN_CASES = {
    # name: (hq, hkv, s, t, kwargs)
    "mha": (4, 4, 9, 9, {}),
    "gqa4": (8, 2, 9, 9, {}),
    "window": (8, 2, 12, 12, {"window": 5}),
    "chunked_ragged": (8, 2, 13, 13, {"chunk": 4}),
    "chunked_window": (4, 1, 10, 10, {"chunk": 4, "window": 3}),
    "decode_kv_positions": (8, 2, 1, 16, {"q_offset": 21,
                                          "kv_positions": True}),
    "noncausal": (4, 2, 6, 11, {"causal": False}),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention(dtype, case):
    hq, hkv, s, tt, kw = ATTN_CASES[case]
    rng = np.random.default_rng(len(case))
    dt = jnp.dtype(dtype)
    q = rng.standard_normal((2, s, hq, 16)).astype(dt)
    k = rng.standard_normal((2, tt, hkv, 16)).astype(dt)
    v = rng.standard_normal((2, tt, hkv, 16)).astype(dt)
    kw = dict(kw)
    tkw = dict(kw)
    if kw.pop("kv_positions", False):
        # a ring buffer: slot j holds position 10 + (j + 5) % 16, unwritten
        # slots at 10**9
        kvp = np.stack([10 + (np.arange(tt) + 5) % tt] * 2).astype(np.int32)
        kvp[1, 3] = 10 ** 9
        kw["kv_positions"] = jnp.asarray(kvp)
        tkw["kv_positions"] = t(kvp)
    want = jax.jit(lambda q, k, v: RL.attention(q, k, v, **kw))(q, k, v)
    got = TL.attention(t(q), t(k), t(v), **tkw)
    assert got.dtype == (torch.float32 if dtype == "float32"
                         else torch.bfloat16)
    assert_close(got, want, dtype, case)


# ---------------------------------------------------------------- model

def _ref_fns(cfg, max_len):
    pre = jax.jit(lambda p, tk: RM.prefill(p, {"tokens": tk}, cfg, max_len))
    dec = jax.jit(lambda p, c, tk, pos: RM.decode_step(p, c, tk, pos, cfg))
    return pre, dec


def _assert_cache(got, want, dtype, what):
    assert_close(got["seg0"].k, want["seg0"].k, dtype, f"{what} k")
    assert_close(got["seg0"].v, want["seg0"].v, dtype, f"{what} v")
    assert np.array_equal(got["seg0"].pos.numpy(),
                          np.asarray(want["seg0"].pos)), what


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_teacher_forced_decode(arch, dtype):
    """Prefill logits and cache, then 4 decode steps fed the same tokens,
    each step's logits and cache."""
    cfg = dataclasses.replace(TB.get_smoke(arch), dtype=dtype)
    rcfg = dataclasses.replace(RB.get_smoke(arch), dtype=dtype)
    rp, model = both_models(cfg)
    toks = tokens(cfg, 2, 16)
    pre, dec = _ref_fns(rcfg, 24)
    lr, cr = pre(rp, toks[:, :12])
    with torch.inference_mode():
        lt, ct = TM.prefill(model, {"tokens": t(toks[:, :12])}, cfg, 24)
    assert_close(lt, lr, dtype, "prefill logits")
    _assert_cache(ct, cr, dtype, "prefill")
    for i in range(12, 16):
        lr, cr = dec(rp, cr, toks[:, i:i + 1], jnp.int32(i))
        with torch.inference_mode():
            lt, ct = TM.decode_step(model, ct, t(toks[:, i:i + 1]), i, cfg)
        assert_close(lt, lr, dtype, f"decode {i} logits")
        _assert_cache(ct, cr, dtype, f"decode {i}")


def test_prompt_longer_than_cache_is_a_ring_buffer():
    """A 20-token prompt into an 8-slot cache: position p at slot p % 8,
    then a decode step attends over the ring through its positions."""
    cfg = dataclasses.replace(TB.get_smoke("granite-8b"), dtype="float32")
    rcfg = dataclasses.replace(RB.get_smoke("granite-8b"), dtype="float32")
    rp, model = both_models(cfg, seed=5)
    toks = tokens(cfg, 2, 21, seed=6)
    pre, dec = _ref_fns(rcfg, 8)
    lr, cr = pre(rp, toks[:, :20])
    with torch.inference_mode():
        lt, ct = TM.prefill(model, {"tokens": t(toks[:, :20])}, cfg, 8)
    assert_close(lt, lr, "float32", "ring prefill logits")
    _assert_cache(ct, cr, "float32", "ring prefill")
    assert ct["seg0"].pos[0, 0].tolist() == [16, 17, 18, 19, 12, 13, 14, 15]
    lr, cr = dec(rp, cr, toks[:, 20:21], jnp.int32(20))
    with torch.inference_mode():
        lt, ct = TM.decode_step(model, ct, t(toks[:, 20:21]), 20, cfg)
    assert_close(lt, lr, "float32", "ring decode logits")
    _assert_cache(ct, cr, "float32", "ring decode")


def test_full_forward_equals_reference():
    """``CLM.forward`` + ``logits_fn`` over a whole sequence, long enough
    for two query chunks of 16 with a ragged tail."""
    cfg = dataclasses.replace(TB.get_smoke("stablelm-3b"), dtype="float32")
    rcfg = dataclasses.replace(RB.get_smoke("stablelm-3b"), dtype="float32")
    rp, model = both_models(cfg, seed=7)
    toks = tokens(cfg, 2, 40, seed=8)
    want = jax.jit(lambda p, tk: RCLM.logits_fn(
        p, RCLM.forward(p, tk, rcfg, remat=False)))(rp, toks)
    with torch.inference_mode():
        got = TCLM.logits_fn(model, model(t(toks)))
    assert_close(got, want, "float32", "forward logits")


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward(arch):
    """The reference's own property on the port (``tests/test_models.py``):
    prefill 15 tokens and decode the 16th == the full forward's last
    logits, float32 parameters, within 1e-4."""
    cfg = dataclasses.replace(TB.get_smoke(arch), dtype="float32")
    model = TM.init_params(cfg, torch.Generator().manual_seed(0))
    model = model.float()
    toks = torch.from_numpy(tokens(cfg, 2, 16, seed=9))
    with torch.inference_mode():
        full = TCLM.logits_fn(model, TCLM.forward(model, toks, cfg))
        _, cache = TM.prefill(model, {"tokens": toks[:, :15]}, cfg, 20)
        lg, _ = TM.decode_step(model, cache, toks[:, 15:16], 15, cfg)
    err = float((lg - full[:, 15]).abs().max())
    assert err < 1e-4, (arch, err)
