"""The port's serving engine and launcher (``repro_torch.serve.engine``,
``repro_torch.launch.serve``) against the reference's on the CPU.

* greedy ids of ``Engine.generate`` == the reference ``Engine``'s in
  float32, with every step's top-2 logit margin above the float32
  tolerance of ``tests/test_torch_models.py`` (so equal ids are not
  luck);
* the KV gate: the same cache (the reference's prefill, carried across
  with ``convert.lm_cache``) gated by both engines -- CRs, rewritten
  leaves and both byte counters bit-equal -- through the engine's own
  call and through ``SweepService``; the port's counterparts of
  ``tests/test_methods.py::test_engine_fused_qdq_bitequal`` and
  ``::test_engine_gate_through_sweep_service`` with the reference
  engine's results as the expected values;
* ``launch.serve.main`` on a smoke config, with and without
  ``--kv-gate-service``;
* ``convert.lm_params`` refusing a tree with a missing, extra or
  mis-shaped leaf.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as RB  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serve import engine as RE  # noqa: E402
from repro.serve.sweep_service import ServiceConfig as RServiceConfig  # noqa: E402
from repro.serve.sweep_service import SweepService as RSweepService  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.launch import serve as TLS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.serve.sweep_service import ServiceConfig, SweepService  # noqa: E402
from repro_torch.train import grad_compress as TGC  # noqa: E402

from test_torch_models import F32_TOL, ref_params, tokens  # noqa: E402


def _bits(x) -> np.ndarray:
    """A leaf's bytes as unsigned integers (bfloat16 has no numpy type
    on the torch side)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(f"u{x.element_size()}")
    a = np.asarray(x)
    return a.view(f"u{a.dtype.itemsize}")


def _assert_same_leaves(got, want) -> None:
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(np.shape(b))
        assert np.array_equal(_bits(a), _bits(b))


def _pair(arch="granite-3-2b", dtype="float32", seed=0):
    cfg = dataclasses.replace(TB.get_smoke(arch), dtype=dtype)
    rcfg = dataclasses.replace(RB.get_smoke(arch), dtype=dtype)
    tree = ref_params(cfg, seed)
    return (cfg, rcfg, jax.tree.map(jnp.asarray, tree),
            convert.lm_params(tree, cfg, device="cpu"))


@pytest.mark.parametrize("arch", ["granite-3-2b", "stablelm-3b"])
def test_generate_ids_equal_reference_float32(arch):
    cfg, rcfg, rp, model = _pair(arch)
    toks = tokens(cfg, 2, 12, seed=3)
    scfg = dict(max_len=32)
    want = np.asarray(RE.Engine(rcfg, rp, RE.ServeConfig(**scfg)).generate(
        {"tokens": jnp.asarray(toks)}, steps=8))
    eng = TE.Engine(cfg, model, TE.ServeConfig(**scfg))
    got = eng.generate({"tokens": torch.from_numpy(toks)}, steps=8)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 8)
    assert np.array_equal(got.numpy(), want)
    assert set(eng.timings) == {"prefill_s", "gate_s", "decode_s"}
    assert len(eng.timings["decode_s"]) == 8
    # every greedy choice had a margin the float32 tolerance cannot flip
    with torch.inference_mode():
        logits, cache = TM.prefill(model, {"tokens": torch.from_numpy(toks)},
                                   cfg, 32)
        for i in range(8):
            top2 = torch.topk(logits, 2, dim=-1).values
            margin = float((top2[:, 0] - top2[:, 1]).min())
            tol = F32_TOL["atol"] + F32_TOL["rtol"] * float(top2.abs().max())
            assert margin > 2 * tol, (i, margin, tol)
            assert torch.equal(torch.argmax(logits, -1).to(torch.int32),
                               got[:, i])
            logits, cache = TM.decode_step(model, cache, got[:, i:i + 1],
                                           12 + i, cfg)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gate_on_a_prefilled_cache_bitequal(dtype):
    """The reference's prefill cache, gated by both engines: CRs, leaves
    (k and v rewritten, pos untouched) and metering bit-equal."""
    cfg, rcfg, rp, model = _pair("granite-8b", dtype)
    toks = tokens(cfg, 2, 10, seed=4)
    _, rcache = jax.jit(lambda p, t: RM.prefill(p, {"tokens": t}, rcfg,
                                                16))(rp, toks)
    cache = convert.lm_cache(jax.tree.map(np.asarray, rcache), device="cpu")
    ref = RE.Engine(rcfg, rp, RE.ServeConfig(max_len=16, kv_compress=True))
    eng = TE.Engine(cfg, model, TE.ServeConfig(max_len=16, kv_compress=True))
    leaves = jax.tree.leaves(rcache)[:2]
    want_crs = np.asarray(ref._gate_crs(tuple(leaves)))
    got_crs = eng._predict_crs(tree_leaves(cache)[:2])
    assert np.array_equal(got_crs.view(np.uint32), want_crs.view(np.uint32))
    assert (want_crs >= 2.5).all()                  # both leaves gate
    _assert_same_leaves(eng._maybe_compress_cache(cache),
                        ref._maybe_compress_cache(rcache))
    assert (eng.kv_saved_bytes, eng.kv_total_bytes) == \
        (ref.kv_saved_bytes, ref.kv_total_bytes)
    assert eng.kv_saved_bytes > 0


def _kv_cache(seed=3):
    """``tests/test_methods.py``'s test cache, as numpy."""
    rng = np.random.default_rng(seed)
    return {
        # smooth leaf: predicted CR 4.05
        "k": (np.cumsum(rng.standard_normal((1, 2, 4, 256)), axis=-1)
              * 1e-3).astype(np.float32),
        # white-noise leaf: predicted CR 4.27
        "v": rng.standard_normal((1, 2, 4, 256)).astype(np.float32),
        # rank-2 leaf: not a KV block, never a candidate
        "aux": rng.standard_normal((4, 8)).astype(np.float32),
    }


def _port(cache):
    return {k: torch.from_numpy(v.copy()) for k, v in cache.items()}


def _jax(cache):
    return {k: jnp.asarray(v) for k, v in cache.items()}


@pytest.mark.parametrize("ratio", [2.5, 4.2])
def test_engine_fused_qdq_bitequal(ratio):
    """One quantize / dequantize over all gated leaves == the per-leaf
    round trip, and the engine's leaves and metering == the reference
    engine's.  Both leaves clear 2.5 (CRs 4.05 and 4.27: the reference
    test's "white-noise leaf fails the gate" does not hold); at 4.2 only
    the white-noise one does, and the smooth one stays as it was."""
    cache = _kv_cache()
    ref = RE.Engine(None, None, RE.ServeConfig(kv_compress=True,
                                               kv_gate_ratio=ratio))
    want = ref._maybe_compress_cache(_jax(cache))
    eng = TE.Engine(None, None, TE.ServeConfig(kv_compress=True,
                                               kv_gate_ratio=ratio))
    got = eng._maybe_compress_cache(_port(cache))
    _assert_same_leaves(got, want)
    assert (eng.kv_saved_bytes, eng.kv_total_bytes) == \
        (ref.kv_saved_bytes, ref.kv_total_bytes)
    assert eng.kv_total_bytes == 2 * 2048 * 4
    assert eng.kv_saved_bytes == (2 if ratio < 4 else 1) * (8192 - 2048 - 32)
    assert torch.equal(got["aux"], torch.from_numpy(cache["aux"]))
    gated = ["k", "v"] if ratio < 4 else ["v"]
    for name in ("k", "v"):
        x = torch.from_numpy(cache[name])
        rt = TGC.dequantize_int8(*TGC.quantize_int8(x), x.shape, x.dtype)
        assert torch.equal(got[name], rt if name in gated else x), name
    leaves = [torch.from_numpy(cache["k"]),
              torch.from_numpy(cache["v"][:, :, :3, :100].copy())]
    for a, b in zip(TE.qdq_leaves(leaves), leaves):
        assert torch.equal(a, TGC.dequantize_int8(*TGC.quantize_int8(b),
                                                  b.shape, b.dtype))


def test_engine_gate_through_sweep_service():
    """With ``sweep_service=`` the CRs come from the service's kv_gate
    method: one request of 2 rows, and the same cache and metering as the
    engine's own call and the reference's service-attached engine."""
    cache = _kv_cache(seed=4)
    scfg = TE.ServeConfig(kv_compress=True, kv_gate_ratio=2.5)
    with SweepService(ServiceConfig(max_wait_ms=2.0), device="cpu") as svc:
        eng = TE.Engine(None, None, scfg, sweep_service=svc)
        got = eng._maybe_compress_cache(_port(cache))
        st = svc.stats()
    own = TE.Engine(None, None, scfg)
    _assert_same_leaves(got, own._maybe_compress_cache(_port(cache)))
    with RSweepService(RServiceConfig(max_wait_ms=2.0)) as rsvc:
        ref = RE.Engine(None, None, RE.ServeConfig(kv_compress=True,
                                                   kv_gate_ratio=2.5),
                        sweep_service=rsvc)
        want = ref._maybe_compress_cache(_jax(cache))
    _assert_same_leaves(got, want)
    assert (eng.kv_saved_bytes, eng.kv_total_bytes) == \
        (own.kv_saved_bytes, own.kv_total_bytes) == \
        (ref.kv_saved_bytes, ref.kv_total_bytes)
    assert st["methods"]["kv_gate"]["completed"] == 1
    assert st["methods"]["kv_gate"]["rows"] == 2     # the two candidates


def _odd_gate_leaves():
    """Eight rank-5 float32 leaves of 7680 values (30 blocks: no power of
    two of codes), magnitudes 1e-4-1; the reference's eager size model
    and its jitted one differ on some of them."""
    rng = np.random.default_rng(26)
    return [(rng.standard_normal((2, 3, 40, 2, 16))
             * 10.0 ** rng.uniform(-4, 0)).astype(np.float32)
            for _ in range(8)]


@pytest.mark.parametrize("path", ["engine", "service"])
def test_gate_crs_are_the_reference_jitted_forms(path):
    """The gate's CRs on leaves whose code counts are no power of two:
    the port's ``Engine._predict_crs`` == the reference ``Engine``'s
    ``_gate_crs`` (one ``jax.jit``), and the port's service ``kv_gate``
    == the reference's ``Int8CRLauncher`` (``jit(vmap)``), bit for bit;
    the reference's eager call differs from both on at least one
    leaf."""
    from repro.serve.method import Int8CRLauncher
    from repro.train.grad_compress import predicted_cr_int8
    leaves = _odd_gate_leaves()
    eager = np.asarray([np.float32(predicted_cr_int8(jnp.asarray(x)))
                        for x in leaves])
    if path == "engine":
        ref = RE.Engine(None, None, RE.ServeConfig(kv_compress=True))
        want = np.asarray(ref._gate_crs(tuple(jnp.asarray(x)
                                              for x in leaves)))
        got = TE.Engine(None, None, TE.ServeConfig(kv_compress=True)
                        )._predict_crs([torch.from_numpy(x) for x in leaves])
    else:
        stack = np.stack([x.reshape(-1) for x in leaves])
        want = Int8CRLauncher().launch(stack, [0.0], None, 8, None)[:, 0, 0]
        with SweepService(ServiceConfig(max_wait_ms=5.0), device="cpu") as svc:
            got = svc.kv_gate(leaves)
    assert got.shape == want.shape == (8,)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert not np.array_equal(eager.view(np.uint32), want.view(np.uint32))


def test_bfloat16_leaves_through_the_service():
    """The service reads bfloat16 leaves (numpy has no bfloat16): its CRs
    == the engine's own for the same leaves."""
    rng = np.random.default_rng(5)
    leaves = [torch.from_numpy(rng.standard_normal((2, 3, 8, 4, 16))
                               .astype(np.float32)).to(torch.bfloat16)
              for _ in range(2)]
    with SweepService(ServiceConfig(max_wait_ms=1.0), device="cpu") as svc:
        served = TE.Engine(None, None, sweep_service=svc)._predict_crs(leaves)
    own = TE.Engine(None, None)._predict_crs(leaves)
    assert np.array_equal(served.view(np.uint32), own.view(np.uint32))


def test_launch_serve_smoke_with_and_without_service(capsys):
    base = ["--arch", "granite-3-2b", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "8", "--steps", "4",
            "--max-len", "16", "--kv-compress"]
    a = TLS.main(base)
    b = TLS.main(base + ["--kv-gate-service"])
    for r in (a, b):
        assert r["shape"] == [2, 4] and r["params"] == 139_584
        assert r["param_bytes"] == 2 * r["params"]
        nums = [r[k] for k in ("init_s", "prefill_s", "gate_s",
                               "decode_ms_per_step", "tokens_per_s")]
        assert np.all(np.isfinite(nums)) and min(nums) >= 0
        assert 0 < r["kv_saved_bytes"] < r["kv_total_bytes"]
    assert a["ids"] == b["ids"]
    assert (a["kv_saved_bytes"], a["kv_total_bytes"]) == \
        (b["kv_saved_bytes"], b["kv_total_bytes"])
    assert a["kv_gate"] is None
    assert (b["kv_gate"]["completed"], b["kv_gate"]["rows"]) == (1, 2)
    out = capsys.readouterr().out
    assert "KV gate:" in out and "kv_gate service: 1 requests" in out


def test_lm_params_raises_on_bad_trees():
    cfg = TB.get_smoke("granite-3-2b")
    tree = ref_params(cfg)
    missing = {k: v for k, v in tree.items() if k != "lm_head"}
    with pytest.raises(ValueError, match="misses.*lm_head"):
        convert.lm_params(missing, cfg, device="cpu")
    extra = dict(tree, meta=np.zeros((8, cfg.d_model), np.float32))
    with pytest.raises(ValueError, match="extra.*meta"):
        convert.lm_params(extra, cfg, device="cpu")
    bad = dict(tree, seg0=dict(tree["seg0"], norm1=tree["seg0"]["norm1"][:1]))
    with pytest.raises(ValueError, match="mis-shaped.*seg0.norm1"):
        convert.lm_params(bad, cfg, device="cpu")
    model = convert.lm_params(tree, cfg, device="cpu")
    names = dict(model.named_parameters())
    assert names["layers.1.attn.wq"].dtype == torch.bfloat16
    assert np.array_equal(_bits(names["layers.1.attn.wq"]),
                          _bits(tree["seg0"]["attn"]["wq"][1]))
