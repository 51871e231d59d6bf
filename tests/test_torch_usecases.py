"""The port's compressors, use cases, data and state conversion against
the reference.

Models fitted by the reference are exported here as plain numpy arrays
(the port never imports the reference) and carried across with
``repro_torch.convert``; they must give the reference's predictions, UC1
error bound, UC2 ranking and UC3 setting.  Models the port trains itself
on the same data see the same CR labels (the ported compressors' ratios
are exactly the reference's) and agree to rtol 1e-3, the float32 solve
order being the only difference.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import compressors as JC  # noqa: E402
from repro.core import regression as JR  # noqa: E402
from repro.core import usecases as JUC  # noqa: E402
from repro.data import scientific as JS  # noqa: E402
from repro.dist import sweep as JDS  # noqa: E402
from repro_torch import compressors as TC  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.compressors import lossless as TL  # noqa: E402
from repro_torch.compressors import sz as TSZ  # noqa: E402
from repro_torch.core import usecases as TUC  # noqa: E402
from repro_torch.data import scientific as TS  # noqa: E402
from repro_torch.dist import sweep as TDS  # noqa: E402

PORTED = ("sz3-lorenzo", "bitgrooming", "digitrounding")


def export_cr_model(m, eps, ndim):
    """State of a reference CR model as plain arrays (see convert.py)."""
    state = {"eps": float(eps), "ndim": ndim,
             "mean": np.asarray(m.std.mean), "std": np.asarray(m.std.std),
             "coef": np.asarray(m.coef)}
    if isinstance(m, JR.SplineCRModel):
        state.update(kind="spline", knots1=np.asarray(m.knots1),
                     knots2=np.asarray(m.knots2))
    else:
        state["kind"] = "linear"
    return state


def export_grid(gm):
    q = gm.quality
    return {"ebs": np.asarray(gm.ebs), "name": gm.name,
            "cfg": dataclasses.asdict(gm.cfg),
            "models": [export_cr_model(p.model, p.eps, p.ndim)
                       for p in gm.models],
            "quality": None if q is None else {
                "coef": q.coef, "mean_psnr": q.mean_psnr,
                "mean_nrmse": q.mean_nrmse}}


@pytest.fixture(scope="module")
def study():
    slices = np.array(JS.field_slices("hurricane-u", count=14, n=64))
    rng = float(np.ptp(slices))
    ebs = [1e-3 * rng, 3e-3 * rng, 1e-2 * rng, 3e-2 * rng]
    train = slices[:10]
    jax_models = {n: JUC.EbGridModel.train(jnp.asarray(train), n, ebs)
                  for n in PORTED}
    return slices, ebs, jax_models


# --------------------------------------------------------------- compressors
@pytest.mark.parametrize("name", PORTED)
def test_compressor_cr_exactly_equal(name):
    x2 = np.array(JS.field_slices("nyx-vx", count=1, n=48)[0])
    x3 = np.array(JS.volume("miranda-vx", shape=(4, 24, 24)))
    rng = float(np.ptp(x2))
    for x, eps in ((x2, 1e-4 * rng), (x2, 1e-2 * rng), (x3, 1e-3)):
        want = JC.get(name).cr(jnp.asarray(x), eps)
        got = TC.get(name).cr(torch.from_numpy(x), eps)
        assert got == want, (name, x.shape, eps)


def test_lorenzo_codes_equal_and_bounded():
    from repro.compressors import sz as JSZ
    x = np.array(JS.field_slices("qmcpack", count=1, n=40)[0])
    for eps in (1e-4, 1e-2):
        codes = TSZ.lorenzo_encode(torch.from_numpy(x), eps)
        np.testing.assert_array_equal(
            codes.numpy(), np.asarray(JSZ.lorenzo_encode(jnp.asarray(x), eps)))
        recon = TSZ.lorenzo_decode(codes, eps)
        slack = float(np.max(np.abs(x))) * 2.0 ** -23
        assert float((recon - torch.from_numpy(x)).abs().max()) <= eps + slack
    err = TC.get("digitrounding").roundtrip_error(torch.from_numpy(x), 1e-3)
    assert err <= 1e-3
    assert TC.names() == sorted(set(TC.STUDY_2D) | set(TC.STUDY_3D))
    assert TL.BACKEND in ("zstd", "zlib")


def test_training_crs_table_equal(study):
    slices, ebs, _ = study
    comp = "bitgrooming"
    want = JDS.training_crs(JC.get(comp), jnp.asarray(slices[:3]), ebs)
    got = TDS.training_crs(TC.get(comp), torch.from_numpy(slices[:3]), ebs)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


# -------------------------------------------------- models carried across
def _carried(study):
    _, _, jax_models = study
    return {n: convert.eb_grid_model(export_grid(m), device="cpu")
            for n, m in jax_models.items()}


def test_carried_models_predict_like_reference(study):
    slices, ebs, jax_models = study
    port = _carried(study)
    probes = [ebs[0] * 0.5, ebs[1], np.sqrt(ebs[1] * ebs[2]), ebs[3] * 2]
    for name, jm in jax_models.items():
        tm = port[name]
        assert tm.name == name and tm.cfg.qent_bins == 65536
        for i in (10, 12):
            for e in probes:
                want = jm.predict(jnp.asarray(slices[i]), e)
                got = tm.predict(torch.from_numpy(slices[i]), e)
                np.testing.assert_allclose(got, want, rtol=1e-5)
                np.testing.assert_allclose(
                    tm.predict_psnr(torch.from_numpy(slices[i]), e),
                    jm.predict_psnr(jnp.asarray(slices[i]), e),
                    rtol=1e-5, atol=1e-4)


def test_carried_models_uc1_uc2_uc3(study):
    slices, ebs, jax_models = study
    port = _carried(study)
    for i in (11, 13):
        x_j, x_t = jnp.asarray(slices[i]), torch.from_numpy(slices[i])
        # UC1: the same error bound for a target CR
        for name in PORTED:
            mid = jax_models[name].predict(x_j, ebs[1])
            want_eb, _ = JUC.find_error_bound_for_cr(jax_models[name], x_j,
                                                     mid * 1.3)
            got_eb, _ = TUC.find_error_bound_for_cr(port[name], x_t,
                                                    mid * 1.3)
            np.testing.assert_allclose(got_eb, want_eb, rtol=1e-3)
        # UC2: the same ranking of compressors
        jbest, jpreds = JUC.best_compressor(
            {n: m.models[2] for n, m in jax_models.items()}, x_j, ebs[2])
        tbest, tpreds = TUC.best_compressor(
            {n: m.models[2] for n, m in port.items()}, x_t, ebs[2])
        assert tbest == jbest
        assert sorted(tpreds, key=tpreds.get) == sorted(jpreds, key=jpreds.get)
        # UC3: the same joint setting
        psnr = jax_models["sz3-lorenzo"].predict_psnr(x_j, ebs[1])
        for cr_floor in (1.5, 1e6):
            want = JUC.find_setting(jax_models, x_j, cr_floor=cr_floor,
                                    psnr_floor=psnr)
            got = TUC.find_setting(port, x_t, cr_floor=cr_floor,
                                   psnr_floor=psnr)
            assert (got.feasible, got.compressor) == \
                (want.feasible, want.compressor)
            np.testing.assert_allclose(got.eb, want.eb, rtol=1e-3)


def test_port_trained_models_agree(study):
    slices, ebs, jax_models = study
    for name in ("sz3-lorenzo", "digitrounding"):
        tm = TUC.EbGridModel.train(torch.from_numpy(slices[:10]), name, ebs)
        jm = jax_models[name]
        np.testing.assert_allclose(tm.quality.mean_psnr, jm.quality.mean_psnr,
                                   rtol=1e-6)
        for i in (10, 13):
            for e in (ebs[0], np.sqrt(ebs[2] * ebs[3])):
                np.testing.assert_allclose(
                    tm.predict(torch.from_numpy(slices[i]), e),
                    jm.predict(jnp.asarray(slices[i]), e), rtol=1e-3)


def test_uc2_over_the_study_set(study):
    """The slice as a whole: each package trains an EbGridModel for every
    2-D study compressor on the same slices, then UC2 ranks all 8."""
    slices, ebs, _ = study
    train = slices[:10]
    jm = {n: JUC.EbGridModel.train(jnp.asarray(train), n, ebs)
          for n in JC.STUDY_2D}
    tm = {n: TUC.EbGridModel.train(torch.from_numpy(train), n, ebs)
          for n in TC.STUDY_2D}
    for i in (10, 12):
        jbest, jpreds = JUC.best_compressor(
            {n: m.models[1] for n, m in jm.items()}, jnp.asarray(slices[i]),
            ebs[1])
        tbest, tpreds = TUC.best_compressor(
            {n: m.models[1] for n, m in tm.items()}, torch.from_numpy(slices[i]),
            ebs[1])
        assert tbest == jbest
        np.testing.assert_allclose([tpreds[n] for n in JC.STUDY_2D],
                                   [jpreds[n] for n in JC.STUDY_2D], rtol=1e-3)


def test_exhaustive_baselines_match(study):
    slices, ebs, _ = study
    x_j, x_t = jnp.asarray(slices[12]), torch.from_numpy(slices[12])
    want = JUC.find_error_bound_exhaustive("sz3-lorenzo", x_j, 5.0,
                                           ebs[0], ebs[-1])
    got = TUC.find_error_bound_exhaustive("sz3-lorenzo", x_t, 5.0,
                                          ebs[0], ebs[-1])
    assert got == want
    assert TUC.best_compressor_exhaustive(PORTED, x_t, ebs[1]) == \
        JUC.best_compressor_exhaustive(PORTED, x_j, ebs[1])


def test_usecase_validation_errors(study):
    port = _carried(study)
    with pytest.raises(ValueError):
        TUC.best_compressor({}, torch.zeros(8, 8), 1e-3)
    with pytest.raises(ValueError):
        port["bitgrooming"].predict(torch.zeros(2, 8, 8), 1e-3)
    with pytest.raises(ValueError):
        TUC.find_setting({}, torch.zeros(8, 8), cr_floor=1, psnr_floor=1)
    with pytest.raises(ValueError):
        convert.cr_model({"kind": "lasso", "mean": [0, 0], "std": [1, 1]},
                         device="cpu")


# ---------------------------------------------------------------------- data
@pytest.mark.parametrize("name", sorted(TS.FIELDS))
def test_fields_generate_on_device(name):
    a = TS.field_slices(name, count=3, n=40, seed=1, device="cpu")
    b = TS.field_slices(name, count=3, n=40, seed=1, device="cpu")
    assert a.shape == (3, 40, 40) and a.dtype == torch.float32
    assert torch.isfinite(a).all() and torch.equal(a, b)
    assert not torch.equal(a[0], a[1])
    if name == "cesm-cloud":
        assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    assert TS.FIELDS[name].full_n == JS.FIELDS[name].full_n
