"""The port's sweep service (``repro_torch.serve``) on the CPU.

Three groups:

* the reference's single-process service and method cases
  (``tests/test_sweep_service.py``, ``tests/test_methods.py``) run
  against the port: coalesced, deduplicated and cached results
  bit-equal to the port's direct calls, the cache's admission and LRU,
  buckets, the adaptive window, admission control and the kv gate;
* parity: the reference's ``SweepService`` and the port's serve the same
  numpy requests, made from a seed, with the reference's models carried
  into the port: features within the reference's feature tolerance
  (1e-5, the log q-ent bit-equal), quality and kv-gate CRs bit-equal,
  UC1's eb and CR and UC3's eb within 1e-5, equal UC2/UC3 picks,
  advisor CRs within 1e-5;
* the port's modules import neither ``jax`` nor ``repro``.

Slices are 48 x 48 to 64 x 64, so every case runs in seconds.
"""
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import compressors as TC  # noqa: E402
from repro_torch.core import pipeline as TPL  # noqa: E402
from repro_torch.core import predictors as TP  # noqa: E402
from repro_torch.core import usecases as TUC  # noqa: E402
from repro_torch.data import scientific as TS  # noqa: E402
from repro_torch.dist import sweep as TDS  # noqa: E402
from repro_torch.serve import method as MM  # noqa: E402
from repro_torch.serve.registry import (MethodRegistry,  # noqa: E402
                                        default_registry)
from repro_torch.serve.sweep_service import (  # noqa: E402
    FeatureCache, RetryAfter, ServiceConfig, SweepService, _eps_bucket,
    _row_bucket, slice_digest)
from repro_torch.train import grad_compress as TGC  # noqa: E402

N = 64


def _service(scfg=None, **kw):
    return SweepService(scfg, device="cpu", **kw)


def _slices(k, n=24, seed=0):
    rng = np.random.default_rng(seed)
    return np.asarray(np.cumsum(rng.standard_normal((k, n, n)), axis=-1),
                      np.float32)


@pytest.fixture(scope="module")
def setup():
    """16 scale-u slices of 64 x 64 made on the CPU: a zfp eb-grid model
    and zfp/bitgrooming UC2 predictors trained on the first 10."""
    slices = TS.field_slices("scale-u", count=16, n=N, device="cpu")
    rng = float(slices.max() - slices.min())
    ebs = [1e-5 * rng, 1e-4 * rng, 1e-3 * rng, 1e-2 * rng]
    gm = TUC.EbGridModel.train(slices[:10], "zfp", ebs)
    eps = ebs[2]
    models = {}
    for name in ("zfp", "bitgrooming"):
        comp = TC.get(name)
        crs = [comp.cr(s, eps) for s in slices[:10]]
        models[name] = TPL.CRPredictor.train(slices[:10], crs, eps)
    return slices.numpy(), ebs, gm, eps, models


def _feats(x, ebs, cfg=TP.PredictorConfig()):
    return TP.features_sweep(torch.from_numpy(np.asarray(x)), ebs,
                             cfg).numpy()


# ------------------------------------------ the reference's service cases

def test_coalesced_bitequal_serial_mixed_shapes(setup):
    """Concurrent mixed requests (two slice shapes) == serial calls."""
    slices, ebs, gm, eps, models = setup
    small = TS.field_slices("scale-u", count=2, seed=3, n=48,
                            device="cpu").numpy()
    test = slices[12]
    s_uc1 = TUC.find_error_bound_for_cr(gm, torch.from_numpy(test), 6.0)
    s_uc2 = TUC.best_compressor(models, torch.from_numpy(test), eps)
    s_feat = _feats(slices[13:15], ebs)
    s_feat_small = _feats(small, [eps])
    with _service(ServiceConfig(max_wait_ms=200.0)) as svc:
        futs = [svc.submit_find_eb(gm, test, 6.0),
                svc.submit_best_compressor(models, test, eps),
                svc.submit_featurize(slices[13:15], ebs),
                svc.submit_featurize(small, [eps])]
        c_uc1, c_uc2, c_feat, c_feat_small = [
            f.result(timeout=120) for f in futs]
        stats = svc.stats()
    assert c_uc1 == s_uc1
    assert c_uc2[0] == s_uc2[0] and c_uc2[1] == s_uc2[1]
    assert np.array_equal(c_feat, s_feat)
    assert np.array_equal(c_feat_small, s_feat_small)
    assert stats["launches"] == 2            # two shape groups
    assert stats["rows_launched"] == 5       # UC2 deduped onto UC1's row


def test_concurrent_clients_bitequal(setup):
    """Requests from many client threads at once match serial calls."""
    slices, ebs, gm, eps, models = setup
    tests = [slices[11], slices[12], slices[13]]
    targets = [4.0, 6.0, 9.0]
    serial = [TUC.find_error_bound_for_cr(gm, torch.from_numpy(x), t)
              for x, t in zip(tests, targets)]
    serial += [TUC.best_compressor(models, torch.from_numpy(x), eps)
               for x in tests]
    results = [None] * 6
    with _service(ServiceConfig(max_wait_ms=50.0)) as svc:
        def uc1(i):
            results[i] = svc.find_eb(gm, tests[i], targets[i])

        def uc2(i):
            results[3 + i] = svc.best_compressor(models, tests[i], eps)

        threads = [threading.Thread(target=uc1, args=(i,)) for i in range(3)]
        threads += [threading.Thread(target=uc2, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert results == serial


def test_cache_admission_transitions(setup):
    """A digest is admitted on its SECOND sighting; from the third
    request on it is served with zero launches."""
    slices, ebs, gm, eps, models = setup
    test = slices[11]
    with _service(ServiceConfig(max_wait_ms=5.0)) as svc:
        first = svc.find_eb(gm, test, 6.0)              # sighting 1: cold
        launches = svc.launches
        assert launches >= 1
        assert svc.stats()["cache"]["entries"] == 0
        assert svc.stats()["cache"]["admissions_denied"] >= 1
        second = svc.find_eb(gm, test, 6.0)             # sighting 2: admits
        assert svc.launches == launches + 1
        assert second == first
        assert svc.stats()["cache"]["entries"] == 1
        third = svc.find_eb(gm, test, 6.0)              # hot: pure cache
        assert svc.launches == launches + 1
        assert third == first
        svc.best_compressor(models, test, eps)          # a grid eb: cached
        assert svc.launches == launches + 1
        assert svc.stats()["cache"]["hits"] >= len(ebs) + 1


def test_cache_admit_first_touch_config(setup):
    slices, ebs, gm, eps, models = setup
    test = slices[11]
    with _service(ServiceConfig(max_wait_ms=5.0, cache_admit_after=1)) as svc:
        first = svc.find_eb(gm, test, 6.0)
        launches = svc.launches
        second = svc.find_eb(gm, test, 6.0)
        assert svc.launches == launches
        assert second == first


def test_cache_concurrent_requests_admit_in_one_batch(setup):
    """In-batch sightings count: a field arriving with two simultaneous
    requests is admitted on its first (deduplicated) launch."""
    slices, ebs, gm, eps, models = setup
    test = slices[12]
    with _service(ServiceConfig(max_wait_ms=200.0,
                                max_batch_slices=64)) as svc:
        f1 = svc.submit_find_eb(gm, test, 6.0)
        f2 = svc.submit_best_compressor(models, test, eps)
        f1.result(timeout=120), f2.result(timeout=120)
        stats = svc.stats()
        assert stats["launches"] == 1
        assert stats["cache"]["entries"] == 1
        svc.find_eb(gm, test, 6.0)
        assert svc.launches == 1


def test_dedup_within_batch(setup):
    slices, ebs, gm, eps, models = setup
    x = slices[14]
    with _service(ServiceConfig(max_wait_ms=200.0,
                                max_batch_slices=64)) as svc:
        f1 = svc.submit_featurize(x[None], ebs)
        f2 = svc.submit_featurize(x[None].copy(), ebs)
        r1, r2 = f1.result(timeout=120), f2.result(timeout=120)
        stats = svc.stats()
    assert np.array_equal(r1, r2)
    assert stats["launches"] == 1
    assert stats["rows_launched"] == 1


def test_deadline_flush_single_pending_request(setup):
    slices, ebs, gm, eps, models = setup
    with _service(ServiceConfig(max_batch_slices=64, max_wait_ms=30.0)) as svc:
        out = svc.submit_featurize(slices[11:12], [ebs[0]]).result(timeout=120)
        stats = svc.stats()
    assert out.shape == (1, 1, 2)
    assert stats["batches"] == 1 and stats["launches"] == 1
    assert np.array_equal(out, _feats(slices[11:12], [ebs[0]]))


def test_submit_after_close_raises(setup):
    slices, ebs, gm, eps, models = setup
    svc = _service(ServiceConfig(max_wait_ms=1.0))
    svc.close()
    with pytest.raises(RuntimeError):
        svc.submit_featurize(slices[11:12], [ebs[0]])


def test_feature_cache_admission_policy_unit():
    row = np.zeros(2, np.float32)
    cache = FeatureCache(max_bytes=1 << 20, admit_after=2)
    key = ("cold", None)
    assert cache.record_sighting(key) == 1
    assert cache.put(key, 1.0, row) is False
    assert cache.get(key, 1.0) is None
    assert cache.stats()["admissions_denied"] == 1
    assert cache.record_sighting(key) == 2
    assert cache.put(key, 1.0, row) is True
    assert cache.get(key, 1.0) is not None
    assert cache.stats()["pending_sightings"] == 0
    assert cache.put(key, 2.0, row) is True
    key2 = ("hot", None)
    assert cache.record_sighting(key2, n=2) == 2
    assert cache.put(key2, 1.0, row) is True
    small = FeatureCache(max_bytes=1 << 20, admit_after=2, seen_capacity=2)
    for i in range(5):
        small.record_sighting((f"d{i}", None))
    assert small.stats()["pending_sightings"] == 2


def test_feature_cache_lru_eviction():
    row = np.zeros(2, np.float32)
    overhead = FeatureCache.ENTRY_OVERHEAD + FeatureCache.ROW_BYTES
    cache = FeatureCache(max_bytes=2 * overhead)
    ka, kb, kc = ("a", None), ("b", None), ("c", None)
    cache.put(ka, 1.0, row)
    cache.put(kb, 1.0, row)
    assert cache.get(ka, 1.0) is not None             # B is now LRU
    cache.put(kc, 1.0, row)                           # evicts B
    assert cache.get(kb, 1.0) is None
    assert cache.get(ka, 1.0) is not None
    assert cache.get(kc, 1.0) is not None
    assert cache.evictions == 1
    stats = cache.stats()
    assert stats["entries"] == 2
    assert stats["bytes"] <= 2 * overhead


def test_feature_cache_never_evicts_last_written():
    cache = FeatureCache(max_bytes=1)
    cache.put(("a", None), 1.0, np.zeros(2, np.float32))
    assert cache.get(("a", None), 1.0) is not None


def test_slice_digest_f32_canonical():
    x64 = np.random.default_rng(0).standard_normal((8, 8))
    assert slice_digest(x64) == slice_digest(x64.astype(np.float32))
    assert slice_digest(x64) == slice_digest(torch.from_numpy(x64))
    assert slice_digest(x64) != slice_digest(x64.T.copy())
    assert slice_digest(x64) != slice_digest(x64.reshape(4, 16))


def test_buckets():
    assert [_row_bucket(k) for k in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 16]
    assert [_eps_bucket(e) for e in (1, 5, 6, 7, 33)] == [1, 6, 6, 8, 48]


def test_sweep_padded_and_scatter(setup):
    slices, ebs, gm, eps, models = setup
    stack = torch.from_numpy(slices[10:13])
    epss = np.asarray(ebs, np.float32)
    ref = TP.features_sweep(stack, epss).numpy()
    out = TDS.sweep_padded(stack, epss, k_pad=8)
    assert out.shape == (8, len(ebs), 2)
    assert np.array_equal(out.numpy()[:3], ref)
    blocks = TDS.scatter_requests(out, [1, 2])
    assert np.array_equal(blocks[0], ref[:1])
    assert np.array_equal(blocks[1], ref[1:3])
    with pytest.raises(ValueError):
        TDS.scatter_requests(out, [9])
    with pytest.raises(ValueError):
        TDS.sweep_padded(stack, epss, k_pad=2)


def test_eps_union_rows_bitequal(setup):
    """A row featurized at an eb union equals that row at each eb
    alone (what in-batch eb unions rely on)."""
    slices, ebs, gm, eps, models = setup
    union = np.asarray(ebs, np.float32)
    full = _feats(slices[10:11], union)
    for i, e in enumerate(union):
        assert np.array_equal(full[:, i:i + 1], _feats(slices[10:11], [e]))


def test_submit_validation(setup):
    """Malformed requests fail at submit time, and eps <= 0 is rejected
    by ``sweep_padded``."""
    slices, ebs, gm, eps, models = setup
    with _service(ServiceConfig(max_wait_ms=1.0)) as svc:
        with pytest.raises(ValueError):
            svc.submit_find_eb(gm, slices[10:12], 6.0)
        with pytest.raises(ValueError):
            svc.submit_best_compressor(models, slices[10:12], eps)
        with pytest.raises(ValueError):
            svc.submit_featurize(slices[10], ebs)
        with pytest.raises(ValueError):
            svc.submit_featurize(slices[10:12], [])
    with pytest.raises(ValueError):
        TDS.sweep_padded(torch.from_numpy(slices[10:12]), [0.0])
    with pytest.raises(ValueError):
        TDS.sweep_padded(torch.from_numpy(slices[10:12]), [-1e-3], k_pad=8)


def test_cached_rows_are_owned_copies(setup):
    slices, ebs, gm, eps, models = setup
    with _service(ServiceConfig(max_wait_ms=1.0)) as svc:
        svc.featurize(slices[10:11], ebs)
        svc.featurize(slices[10:11], ebs)     # second sighting -> admitted
        [entry] = list(svc.cache._entries.values())
        for row in entry.values():
            assert row.base is None


# ------------------------------------------- the reference's method cases

def test_row_bucket_boundaries():
    assert [_row_bucket(k) for k in (1, 2, 3, 4, 5, 1024, 1025)] == \
        [1, 2, 4, 4, 8, 1024, 2048]


def test_eps_bucket_boundaries():
    for b in MM._EPS_BUCKETS:
        assert _eps_bucket(b) == b
    assert _eps_bucket(5) == 6
    assert _eps_bucket(31) == 32
    assert _eps_bucket(33) == 48
    assert _eps_bucket(48) == 48
    assert _eps_bucket(49) == 64


def test_method_ladder_pad_and_overflow():
    reg = MethodRegistry()
    m = reg.register(MM.FeaturizeMethod(MM.SweepLauncher(),
                                        batch_buckets=(3, 6)))
    with _service(ServiceConfig(max_wait_ms=50.0), registry=reg) as svc:
        assert svc._k_pad((m,), 2) == 3
        assert svc._k_pad((m,), 3) == 3
        assert svc._k_pad((m,), 4) == 6
        assert svc._k_pad((m,), 7) == 8
        s = _slices(2)
        assert np.array_equal(svc.featurize(s, [1e-2]), _feats(s, [1e-2]))
        assert svc.stats()["pad_rows"] == 1


def test_unsorted_batch_buckets_rejected():
    for bb in ((4, 2), (2, 2, 4), ()):
        with pytest.raises(ValueError, match="sorted"):
            MM.FeaturizeMethod(MM.SweepLauncher(), batch_buckets=bb)


def test_default_registry_shape():
    reg = default_registry()
    assert reg.names() == ("featurize", "find_eb", "best_compressor",
                           "kv_gate", "advise", "find_setting", "quality")
    sweep = reg.get("featurize").launcher
    for name in ("find_eb", "best_compressor", "advise", "find_setting"):
        assert reg.get(name).launcher is sweep
    assert reg.get("kv_gate").launcher is not sweep
    assert reg.get("quality").launcher is not sweep
    assert reg.launcher_id(sweep) == 0
    assert reg.launcher_id(reg.get("kv_gate").launcher) == 1
    assert reg.launcher_id(reg.get("quality").launcher) == 2
    assert reg.launcher(0) is sweep
    assert "featurize" in reg and "nope" not in reg


def test_registry_rejects_duplicates_and_unknowns():
    reg = default_registry()
    with pytest.raises(ValueError, match="already registered"):
        reg.register(MM.FeaturizeMethod(MM.SweepLauncher()))
    with pytest.raises(ValueError, match="kv_gate"):
        reg.get("not-a-method")


def test_submit_unknown_method_raises():
    with _service(ServiceConfig(max_wait_ms=5.0)) as svc:
        with pytest.raises(ValueError, match="registered"):
            svc.submit("not-a-method", _slices(1), [1e-2])


def test_warmup_covers_all_registered_methods():
    """No-argument warmup launches every registered method's spec once
    per launcher; methods sharing the sweep launcher share its shapes."""
    with _service(ServiceConfig(max_wait_ms=5.0)) as svc:
        svc.warmup()
        sigs = svc._executables
        assert {s[0] for s in sigs} == {"sweep", "int8cr", "quality"}
        by = {name: {(s[1], s[2]) for s in sigs if s[0] == name}
              for name in ("sweep", "int8cr", "quality")}
        assert by["sweep"] == {(1, (32, 32)), (2, (32, 32))}
        assert by["int8cr"] == {(1, (256,)), (2, (256,))}
        assert by["quality"] == {(1, (32, 32)), (2, (32, 32))}
        assert len(sigs) == 6
        assert svc.launches == 0
        assert len(svc._staging) == 4       # (1|2, 32, 32), (1|2, 256)
        before = len(sigs)
        svc.kv_gate([np.zeros(256, np.float32)])
        assert len(svc._executables) == before


def _gate_leaves():
    """``tests/test_methods.py``'s kv_gate leaves and one of 3000 values
    (3072 codes, no power of two) on which the reference's eager call
    and its jitted form give different CRs."""
    rng = np.random.default_rng(1)
    return [
        np.asarray(rng.standard_normal((2, 3, 8, 16)), np.float32),
        np.asarray(rng.standard_normal((4, 64)) * 1e-3, np.float32),
        np.zeros((512,), np.float32) + 0.25,
        np.asarray(np.random.default_rng(1).standard_normal(3000) * 1e-3,
                   np.float32),
    ]


def test_kv_gate_matches_reference_model():
    """Served kv_gate CRs are bit-equal to the reference's jitted
    ``predicted_cr_int8`` of each raw leaf and to its own service's
    ``kv_gate`` (``Int8CRLauncher``'s ``jit(vmap)``), the forms its
    program runs; its eager call differs on the 3000-value leaf."""
    import jax
    import jax.numpy as jnp
    from repro.serve.sweep_service import ServiceConfig as RServiceConfig
    from repro.serve.sweep_service import SweepService as RSweepService
    from repro.train.grad_compress import predicted_cr_int8
    leaves = _gate_leaves()
    ref = np.asarray([np.float32(jax.jit(predicted_cr_int8)(jnp.asarray(x)))
                      for x in leaves], np.float32)
    eager = np.float32(predicted_cr_int8(jnp.asarray(leaves[3])))
    assert eager.view(np.int32) != ref[3].view(np.int32)
    with RSweepService(RServiceConfig(max_wait_ms=5.0)) as rsvc:
        served = np.asarray(rsvc.kv_gate(leaves), np.float32)
    np.testing.assert_array_equal(served.view(np.int32), ref.view(np.int32))
    with _service(ServiceConfig(max_wait_ms=5.0)) as svc:
        got = svc.kv_gate(leaves)
    assert got.shape == (4,)
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_int8_quantizer_matches_reference():
    """``quantize_int8`` / ``dequantize_int8`` and a batch of
    ``predicted_cr_rows`` give the reference's bits, the CRs those of
    its ``jit(vmap(predicted_cr_int8))`` (a ragged last block, mixed
    magnitudes, a constant leaf; 3000 values: 3072 codes, no power of
    two)."""
    import jax
    import jax.numpy as jnp
    from repro.train import grad_compress as JGC
    rng = np.random.default_rng(6)
    leaves = [(rng.standard_normal(3000) * 10.0 ** rng.integers(-3, 3, 3000)
               ).astype(np.float32),
              np.cumsum(rng.standard_normal(3000)).astype(np.float32),
              np.full(3000, 0.25, np.float32)]
    for x in leaves:
        jc, js = JGC.quantize_int8(jnp.asarray(x))
        tc, ts = TGC.quantize_int8(torch.from_numpy(x))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                      np.asarray(js).view(np.int32))
        np.testing.assert_array_equal(
            TGC.dequantize_int8(tc, ts, (30, 100)).numpy().view(np.int32),
            np.asarray(JGC.dequantize_int8(jc, js, (30, 100))).view(np.int32))
    rows = np.stack(leaves)
    want = np.asarray(jax.jit(jax.vmap(JGC.predicted_cr_int8))(
        jnp.asarray(rows)))
    got = TGC.predicted_cr_rows(torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _gate_lengths(count: int, seed: int):
    """``count`` leaf lengths in [2304, 306687] whose padded code counts
    are no power of two."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < count:
        n = int(rng.integers(2304, 306688))
        codes = -(-n // 256) * 256
        if codes & (codes - 1) and n & (n - 1):
            out.append(n)
    return out


def test_predicted_cr_rows_is_the_jitted_size_model():
    """300 seeded float32 leaves of 2304-306687 values (30 lengths, 10
    leaves each, magnitudes 1e-4-10), none with a power of two of codes:
    ``predicted_cr_rows`` of each length's rows == the reference's
    ``jax.jit(predicted_cr_int8)`` of each leaf and its
    ``jax.jit(jax.vmap(...))`` of the rows, bit for bit, and each row
    alone == in its batch."""
    import jax
    import jax.numpy as jnp
    from repro.train import grad_compress as JGC
    rng = np.random.default_rng(26)
    jit1 = jax.jit(JGC.predicted_cr_int8)
    jitv = jax.jit(jax.vmap(JGC.predicted_cr_int8))
    checked = 0
    for n in _gate_lengths(30, 26):
        rows = (rng.standard_normal((10, n))
                * 10.0 ** rng.uniform(-4, 1, (10, 1))).astype(np.float32)
        got = TGC.predicted_cr_rows(torch.from_numpy(rows)).numpy()
        want_v = np.asarray(jitv(jnp.asarray(rows)), np.float32)
        want_1 = np.asarray([np.float32(jit1(jnp.asarray(r))) for r in rows])
        np.testing.assert_array_equal(got.view(np.int32),
                                      want_v.view(np.int32), err_msg=str(n))
        np.testing.assert_array_equal(got.view(np.int32),
                                      want_1.view(np.int32), err_msg=str(n))
        alone = TGC.predicted_cr_int8(torch.from_numpy(rows[3])).numpy()
        assert alone.view(np.int32) == got[3].view(np.int32)
        checked += len(rows)
    assert checked == 300


def test_kv_gate_dedups_and_coalesces():
    leaf = np.asarray(np.random.default_rng(2).standard_normal(128),
                      np.float32)
    with _service(ServiceConfig(max_wait_ms=200.0)) as svc:
        f1 = svc.submit_kv_gate([leaf, leaf.copy(), leaf + 1.0])
        f2 = svc.submit_featurize(_slices(2), [1e-2])
        crs = f1.result(timeout=60)
        f2.result(timeout=60)
        assert crs[0] == crs[1]
        st = svc.stats()
        assert st["launches"] == 2
        assert st["rows_launched"] == 4
        assert st["batches"] == 1


def test_kv_gate_rejects_empty():
    with _service(ServiceConfig(max_wait_ms=5.0)) as svc:
        with pytest.raises(ValueError, match="leaf"):
            svc.submit_kv_gate([])
        with pytest.raises(ValueError, match="empty"):
            svc.submit_kv_gate([np.zeros((0,), np.float32)])


def test_adaptive_window_shrinks_and_recovers():
    with _service(ServiceConfig(max_wait_ms=8.0, min_wait_ms=0.5)) as svc:
        assert svc.stats()["window_ms"] == 8.0
        for want in (4.0, 2.0, 1.0, 0.5, 0.5):
            svc._note_flush(True)
            assert svc._window_ms == want
        assert svc._window_shrinks == 5
        for want in (1.0, 2.0, 4.0, 8.0, 8.0):
            svc._note_flush(False)
            assert svc._window_ms == want
        assert svc.stats()["window_ms"] == 8.0


def test_adaptive_window_disabled_stays_pinned():
    with _service(ServiceConfig(max_wait_ms=8.0, adapt_window=False)) as svc:
        for _ in range(4):
            svc._note_flush(True)
        assert svc._window_ms == 8.0
        assert svc.stats()["window_shrinks"] == 0


def test_saturated_traffic_shrinks_window_live():
    scfg = ServiceConfig(max_batch_slices=2, max_wait_ms=50.0,
                         min_wait_ms=0.0)
    with _service(scfg) as svc:
        futs = [svc.submit_featurize(_slices(2, seed=s), [1e-2])
                for s in range(4)]
        for f in futs:
            f.result(timeout=60)
        st = svc.stats()
        assert st["window_shrinks"] >= 1
        assert st["window_ms"] < 50.0


def test_per_method_counters():
    with _service(ServiceConfig(max_wait_ms=5.0)) as svc:
        svc.featurize(_slices(2), [1e-2, 1e-1])
        svc.kv_gate([np.ones(64, np.float32)])
        m = svc.stats()["methods"]
    assert m["featurize"]["completed"] == 1
    assert m["featurize"]["rows"] == 2
    assert m["featurize"]["p99_ms"] >= m["featurize"]["p50_ms"] > 0
    assert m["kv_gate"]["completed"] == 1
    assert m["kv_gate"]["failed"] == 0


def test_stats_report_post_processing_seconds():
    """Each method's ``post_s`` in ``stats()`` sums the seconds its
    requests spent in ``post_process``: the pool's busy time."""
    with _service(ServiceConfig(max_wait_ms=5.0)) as svc:
        svc.featurize(_slices(2), [1e-2, 1e-1])
        svc.featurize(_slices(1, seed=3), [1e-2])
        t = time.perf_counter()
        svc.kv_gate([np.ones(64, np.float32)])
        wall = time.perf_counter() - t
        m = svc.stats()["methods"]
    assert m["featurize"]["post_s"] > 0.0
    assert 0.0 < m["kv_gate"]["post_s"] <= wall


def test_max_live_batches_validated_and_reported():
    with _service(ServiceConfig(max_wait_ms=5.0, max_live_batches=1)) as svc:
        svc.featurize(_slices(1), [1e-2])
        assert svc.stats()["live_batches"] == 0


def test_retry_after_is_load_proportional():
    scfg = ServiceConfig(max_wait_ms=10_000.0, adapt_window=False,
                         max_queue_rows=4)
    svc = _service(scfg)
    try:
        parked = svc.submit_featurize(_slices(40, n=8), [1e-2])
        deadline = time.perf_counter() + 5.0
        while not svc.stats()["queue_rows"] and \
                time.perf_counter() < deadline:
            time.sleep(0.01)
        svc._ema_rows_per_s = 2.0
        with pytest.raises(RetryAfter) as ei:
            svc.submit_featurize(_slices(1, n=8), [1e-2])
        assert ei.value.pending_rows == 40
        assert ei.value.retry_after_s == pytest.approx(20.0)
        svc._ema_rows_per_s = 0.0
        svc._ema_batch_s = 0.0
        with pytest.raises(RetryAfter) as ei:
            svc.submit_featurize(_slices(1, n=8), [1e-2])
        assert ei.value.retry_after_s == pytest.approx(10.0)
        assert svc.stats()["rejected"] == 2
    finally:
        svc.close()
        parked.result(timeout=120)


# ------------------------------------------------------ the port's own

def submit_all(svc, r: dict) -> list:
    """One request of each of the seven methods on ``svc`` from the inputs
    of :func:`all_methods`: futures in its order."""
    x = r["x"]
    return [svc.submit_featurize(x, r["ebs"]),
            svc.submit_featurize(x[1:3], r["sub"]),
            svc.submit_featurize(r["vols"], [r["ebs"][2]]),
            svc.submit_find_eb(r["gm"], x[0], 6.0),
            svc.submit_best_compressor(r["models"], x[1], r["eps"]),
            svc.submit_advise(r["grid"], x[2:4]),
            svc.submit_find_setting(r["grid"], x[3], cr_floor=4.0,
                                    psnr_floor=40.0),
            svc.submit_quality(x, r["ebs"], TP.PredictorConfig()),
            svc.submit_kv_gate(r["leaves"])]


def all_methods(setup):
    """The inputs of :func:`submit_all` (with eb unions, bucket padding
    and a volume group) and the port's direct calls' results in its
    order."""
    slices, ebs, gm, eps, models = setup
    x = slices[10:14]
    vols = np.stack([slices[10:14], slices[11:15]])          # (2, 4, N, N)
    sub = [ebs[1], 0.5 * (ebs[1] + ebs[2]), ebs[3]]
    grid = {"zfp": gm, "bitgrooming": TUC.EbGridModel.train(
        torch.from_numpy(slices[:10]), "bitgrooming", ebs)}
    leaves = [slices[0].ravel(), slices[1].ravel(), slices[0].ravel().copy()]
    req = dict(x=x, vols=vols, sub=sub, ebs=ebs, eps=eps, gm=gm,
               models=models, grid=grid, leaves=leaves)
    t = {k: torch.from_numpy(v) for k, v in (("x", x), ("vols", vols))}
    want = [_feats(x, ebs), _feats(x[1:3], sub), _feats(vols, [ebs[2]]),
            TUC.find_error_bound_for_cr(gm, t["x"][0], 6.0),
            TUC.best_compressor(models, t["x"][1], eps),
            MM.AdviseMethod.cr_table(grid, _feats(x[2:4], ebs)),
            TUC.find_setting(grid, t["x"][3], cr_floor=4.0, psnr_floor=40.0),
            TP.quality_sweep(t["x"], ebs, TP.PredictorConfig()).numpy(),
            np.stack([TGC.predicted_cr_int8(torch.from_numpy(v)).numpy()
                      for v in leaves])]
    return req, want


def assert_all_methods(got, want) -> None:
    """Results of ``all_methods``' requests bit-equal to its direct calls."""
    got = list(got)
    advice = got.pop(5)
    assert advice["compressors"] == ("zfp", "bitgrooming")
    assert np.array_equal(advice["cr"], want[5])
    for i, (g, w) in enumerate(zip(got, want[:5] + want[6:])):
        if isinstance(w, np.ndarray):
            assert np.array_equal(g, w), i
        else:
            assert g == w, i


def test_every_method_bit_equal_to_direct_calls(setup):
    """One batch of all seven methods, with eb unions, bucket padding and
    a volume group, each result bit-equal to the port's direct call;
    served again from the cache with zero launches."""
    req, want = all_methods(setup)
    with _service(ServiceConfig(max_wait_ms=300.0, cache_admit_after=1,
                                cache_bytes=1 << 20)) as svc:
        for rnd in range(2):
            got = [f.result(timeout=120) for f in submit_all(svc, req)]
            if rnd == 0:
                launched = svc.launches
                assert launched == 4     # sweep (2-D, volumes), quality, int8
            else:
                assert svc.launches == launched
            assert_all_methods(got, want)


def test_failed_launch_fails_its_requests():
    """A launch that raises fails every future of its batch with the
    error and the service goes on serving."""
    class Broken(MM.SweepLauncher):
        def launch(self, stack, epss, cfg, k_pad, mesh=None):
            raise RuntimeError("launch failed")

    reg = MethodRegistry()
    reg.register(MM.FeaturizeMethod(Broken()))
    reg.register(MM.QualityMethod())
    with _service(ServiceConfig(max_wait_ms=100.0), registry=reg) as svc:
        f1 = svc.submit_featurize(_slices(2), [1e-2])
        f2 = svc.submit_quality(_slices(1), [1e-2])
        with pytest.raises(RuntimeError, match="launch failed"):
            f1.result(timeout=60)
        with pytest.raises(RuntimeError, match="launch failed"):
            f2.result(timeout=60)
        assert svc.quality(_slices(1), [1e-2]).shape == (1, 1, 2)
        assert svc.stats()["methods"]["featurize"]["failed"] == 1


def test_cuda_service_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        SweepService()


# ------------------------------------------------------------ parity

@pytest.fixture(scope="module")
def parity():
    """The same numpy slices (8 training, 4 served, 48 x 48, from a
    seed): the reference trains the models and the port carries them
    across (``repro_torch.convert``), so both services evaluate the same
    models on their own served rows."""
    import dataclasses
    import jax.numpy as jnp
    from repro import compressors as JC
    from repro.core import pipeline as JPL
    from repro.core import usecases as JUC
    from test_torch_usecases import export_cr_model, export_grid
    from repro_torch import convert
    x = _slices(12, n=48, seed=7)
    rng = float(np.ptp(x[:8]))
    ebs = [r * rng for r in (1e-4, 1e-3, 1e-2)]
    eps = ebs[1]
    jgrid = {c: JUC.EbGridModel.train(jnp.asarray(x[:8]), c, ebs)
             for c in ("zfp", "bitgrooming")}
    tgrid = {c: convert.eb_grid_model(export_grid(m), device="cpu")
             for c, m in jgrid.items()}
    jm, tm = {}, {}
    for c in ("zfp", "bitgrooming"):
        crs = [float(JC.get(c).cr(jnp.asarray(s), eps)) for s in x[:8]]
        jm[c] = JPL.CRPredictor.train(jnp.asarray(x[:8]), jnp.asarray(crs),
                                      eps)
        tm[c] = convert.cr_predictor(
            export_cr_model(jm[c].model, eps, 2),
            dataclasses.asdict(jm[c].cfg), device="cpu")
    return x, ebs, eps, jgrid, tgrid, jm, tm


def _both(jsvc, tsvc, name, *args, **kw):
    return (jsvc.submit(name, *args[0], **kw).result(timeout=300),
            tsvc.submit(name, *args[1], **kw).result(timeout=300))


def check_parity_with_reference(parity, tsvc) -> None:
    """The reference's single-device ``SweepService`` and the port's
    ``tsvc`` serve the same requests (module docstring's tolerances)."""
    from repro.serve.registry import default_registry as jreg
    from repro.serve.sweep_service import ServiceConfig as JCfg
    from repro.serve.sweep_service import SweepService as JSvc
    x, ebs, eps, jgrid, tgrid, jm, tm = parity
    held = x[8:]
    j, t = jreg(), default_registry()
    assert j.names() == t.names()
    for name in j.names():
        assert j.launcher_id(j.get(name).launcher) == \
            t.launcher_id(t.get(name).launcher), name
    leaves = [held[0].ravel(), held[1][:7] * 1e-3, held[2].ravel()]
    with JSvc(JCfg(max_wait_ms=5.0)) as jsvc:
        jf, tf = _both(jsvc, tsvc, "featurize", (held, ebs), (held, ebs))
        np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(tf[..., 0].view(np.int32),
                                      jf[..., 0].view(np.int32))
        jq, tq = _both(jsvc, tsvc, "quality", (held, ebs), (held, ebs))
        np.testing.assert_array_equal(tq.view(np.int32), jq.view(np.int32))
        jk, tk = _both(jsvc, tsvc, "kv_gate", (leaves,), (leaves,))
        np.testing.assert_array_equal(tk.view(np.int32), jk.view(np.int32))
        for i, target in enumerate((3.0, 6.0, 12.0)):
            (je, jc), (te, tc) = _both(
                jsvc, tsvc, "find_eb", (jgrid["zfp"], held[i], target),
                (tgrid["zfp"], held[i], target))
            np.testing.assert_allclose([te, tc], [je, jc], rtol=1e-5)
        for s in held:
            (jb, _), (tb, _) = _both(jsvc, tsvc, "best_compressor",
                                     (jm, s, eps), (tm, s, eps))
            assert jb == tb
            js, ts = _both(jsvc, tsvc, "find_setting",
                           (jgrid, s, 3.0, 30.0), (tgrid, s, 3.0, 30.0))
            assert (js.feasible, js.compressor) == (ts.feasible, ts.compressor)
            np.testing.assert_allclose(ts.eb, js.eb, rtol=1e-5)
        ja, ta = _both(jsvc, tsvc, "advise", (jgrid, held), (tgrid, held))
        assert ja["compressors"] == ta["compressors"]
        np.testing.assert_allclose(ta["cr"], ja["cr"], rtol=1e-5)


def test_parity_with_reference_service(parity):
    with _service(ServiceConfig(max_wait_ms=5.0)) as tsvc:
        check_parity_with_reference(parity, tsvc)


# ------------------------------------------------------------ boundary

def test_port_modules_load_without_jax_or_reference():
    """Importing every module of ``repro_torch`` (and constructing a CPU
    service, reading the card's hardware from ``kernels.tune`` and
    sweeping with the kernels' route) loads neither ``jax`` nor
    ``repro`` into the process, and the CPU route never initializes
    CUDA."""
    code = (
        "import pkgutil, importlib, sys, repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "print('SSM', 'repro_torch.models.ssm' in names)\n"
        "print('WSP', 'repro_torch.models.whisper' in names)\n"
        "print('COL', 'repro_torch.dist.collectives' in names)\n"
        "from repro_torch.serve.sweep_service import SweepService\n"
        "SweepService(device='cpu').close()\n"
        "import torch\n"
        "from repro_torch.kernels import tune as KT\n"
        "from repro_torch.core import predictors as P\n"
        "assert KT.backend_kind('cpu') == 'cpu'\n"
        "assert KT.smem_budget('h100') == 196608\n"
        "P.features_sweep(torch.ones((2, 8, 8)), [0.1],\n"
        "                 P.PredictorConfig(use_kernels=True))\n"
        "print('CUDA_INIT', torch.cuda.is_initialized())\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print('BAD', bad)\n")
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(src)))
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert "SSM True" in out.stdout, out.stdout
    assert "WSP True" in out.stdout, out.stdout
    assert "COL True" in out.stdout, out.stdout
    assert "CUDA_INIT False" in out.stdout, out.stdout


def test_advise_cli_service_equals_direct(tmp_path):
    """``launch.advise --service`` (each chunk through the service's
    advise and quality methods) writes the direct run's report, bit for
    bit: chunked and whole-variable CR tables agree because a row's
    features and its model predictions do not depend on its batch."""
    from repro_torch.launch import advise as TADV
    from repro_torch.launch import make_dataset as TMK
    ds = TMK.main([str(tmp_path / "ds"), "--var", "miranda-vx:9:32",
                   "--var", "qmcpack:7:32", "--dtype", "float64",
                   "--seed", "5", "--device", "cpu"])
    args = [ds, "--compressors", "sz2,zfp", "--targets", "4,8",
            "--train-rows", "4", "--budget-mb", "0.02", "--psnr-floor",
            "40", "--device", "cpu"]
    direct = TADV.main(args)
    served = TADV.main(args + ["--service"])
    assert served == direct


class _InFlight:
    """A service that counts the advise futures it has handed out and
    the caller has not yet read."""

    def __init__(self, svc):
        self.svc, self.out, self.most = svc, 0, 0
        self.lock = threading.Lock()

    def submit_advise(self, models, chunk):
        fut = self.svc.submit_advise(models, chunk)
        with self.lock:
            self.out += 1
            self.most = max(self.most, self.out)
        owner = self

        class _Read:
            def result(self, timeout=None):
                out = fut.result(timeout)
                with owner.lock:
                    owner.out -= 1
                return out
        return _Read()


def test_advise_service_bounds_chunks_in_flight(tmp_path):
    """With a service, the advisor keeps at most the stream's
    ``max_in_flight`` chunks outstanding (so the chunk budget bounds its
    host memory), and its report is the direct one."""
    from repro_torch.core import stream as TST
    from repro_torch.data import source as TSRC
    from repro_torch.launch import advise as TADV
    from repro_torch.launch import make_dataset as TMK
    ds = TMK.main([str(tmp_path / "ds"), "--var", "miranda-vx:9:32",
                   "--dtype", "float64", "--seed", "5", "--device", "cpu"])
    src = TSRC.open_dataset(ds)
    kw = dict(compressors=["sz2", "zfp"], targets=[4.0, 8.0], train_rows=4,
              stream=TST.StreamConfig(budget_bytes=32 * 32 * 4,
                                      max_in_flight=2), device="cpu")
    direct = TADV.advise_dataset(src, **kw)
    with _service(ServiceConfig(max_wait_ms=1.0)) as svc:
        proxy = _InFlight(svc)
        served = TADV.advise_dataset(src, service=proxy, **kw)
    assert served == direct
    assert proxy.out == 0 and proxy.most == 2
