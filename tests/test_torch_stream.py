"""The port's streaming sweep, dataset sources and advisor against the
reference and against its own in-memory sweep.

The load-bearing invariant, as in the reference's ``tests/test_stream.py``:
the chunked driver (``repro_torch.core.stream``) gives the EXACT tensor
one in-memory ``features_sweep`` gives, whatever the chunking, the
ragged last chunk or the prefetch depth.  Datasets are written by one
package and read by the other (the file format is shared), digests are
the reference's, and the streamed features are held to the reference's
own stream within the feature tolerance of 1e-5.  Everything runs on
the CPU, the route a CPU tensor takes.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import predictors as JP  # noqa: E402
from repro.core import stream as JST  # noqa: E402
from repro.data import source as JSRC  # noqa: E402
from repro.launch import advise as JADV  # noqa: E402
from repro_torch.core import predictors as TP  # noqa: E402
from repro_torch.core import stream as TST  # noqa: E402
from repro_torch.data import scientific as TS  # noqa: E402
from repro_torch.data import source as TSRC  # noqa: E402
from repro_torch.dist import sweep as TDS  # noqa: E402
from repro_torch.launch import advise as TADV  # noqa: E402
from repro_torch.launch import make_dataset as TMK  # noqa: E402
from repro_torch.serve.method import AdviseMethod, slice_digest  # noqa: E402

EBS = [1e-4, 1e-3, 1e-2]
CPU = "cpu"
ROW_2D = 32 * 32 * 4
ROW_4D = 4 * 16 * 16 * 4


def _gen(count=11, n=32, seed=0):
    return TSRC.GeneratorSource(
        [TSRC.FieldVariable("miranda-vx", count, (n,), seed=seed),
         TSRC.FieldVariable("qmcpack", 5, (4, 16, 16), seed=seed)],
        device=CPU)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """An 11-row 2-D and a 5-row rank-4 variable, written as float64 by
    the port, and each one's in-memory sweep (features and quality)."""
    path = TSRC.write_dataset(str(tmp_path_factory.mktemp("ds") / "ds"),
                              _gen(), dtype="float64", budget_bytes=1 << 20)
    ds = TSRC.MemmapSource(path)
    ref = {}
    for name in ds.variables():
        x = torch.from_numpy(ds.read(name))
        f, q = TP.features_sweep(x, EBS, quality=True)
        ref[name] = (f.numpy(), q.numpy())
    return path, ds, ref


# ---------------------------------------------------------------------------
# Sources
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", ["sequential", "out_of_order"])
def test_generator_rows_equal_field_slices(order):
    """GeneratorSource rows == the port's field_slices rows, bit for bit,
    read in order or not (each read resumes from a saved generator
    state); volume rows are ``volume(seed + i)``."""
    full = TS.field_slices("miranda-vx", count=9, n=32, device=CPU).numpy()
    ranges = [(0, 9), (2, 5), (8, 9), (3, 3)]
    if order == "out_of_order":
        ranges = [(8, 9), (3, 3), (2, 5), (0, 9), (5, 7)]
    gen = TSRC.GeneratorSource(
        [TSRC.FieldVariable("miranda-vx", 9, (32,))], device=CPU)
    for lo, hi in ranges:
        rows = gen.read_rows("miranda-vx", lo, hi)
        assert rows.dtype == np.float32 and rows.flags.c_contiguous
        assert np.array_equal(rows, full[lo:hi]), (lo, hi)
        assert np.array_equal(
            TSRC.generate_field_rows("miranda-vx", 9, lo, hi, n=32,
                                     device=CPU), full[lo:hi])
    got = np.concatenate([c for _, c in gen.chunks("miranda-vx", rows=4)])
    assert np.array_equal(got, full)
    vols = _gen().read_rows("qmcpack-vol", 1, 3)
    for i, vol in enumerate(vols, start=1):
        assert np.array_equal(vol, TS.volume("qmcpack", (4, 16, 16), seed=i,
                                             device=CPU).numpy())


def _array_source(mod, arrays):
    """A DatasetSource of ``mod`` (either package) serving given arrays."""
    class ArraySource(mod.DatasetSource):
        def variables(self):
            return tuple(arrays)

        def meta(self, name):
            a = arrays[name]
            return mod.VariableMeta(name, a.shape, str(a.dtype))

        def read_rows(self, name, lo, hi):
            return np.ascontiguousarray(arrays[name][lo:hi], np.float32)
    return ArraySource()


@pytest.mark.parametrize("fmt", ["memmap", "npz"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_datasets_cross_between_packages(tmp_path, fmt, dtype):
    """A dataset written by either package reads back bit-equal in the
    other; memmap directories are byte for byte the same files."""
    rng = np.random.default_rng(3)
    arrays = {"slices": rng.normal(size=(5, 12, 16)).astype(np.float32),
              "vols": rng.normal(size=(3, 4, 8, 8)).astype(np.float32)}
    paths = {}
    for tag, mod in (("ref", JSRC), ("port", TSRC)):
        paths[tag] = mod.write_dataset(
            str(tmp_path / tag), _array_source(mod, arrays), fmt=fmt,
            dtype=dtype, budget_bytes=2 * 12 * 16 * 4, seed=7)
    for writer, reader in (("ref", TSRC), ("port", JSRC)):
        ds = reader.open_dataset(paths[writer])
        for name, want in arrays.items():
            assert ds.meta(name).shape == want.shape
            assert ds.meta(name).dtype == dtype
            assert np.array_equal(ds.read(name), want)
            assert np.array_equal(ds.read_rows(name, 1, 3), want[1:3])
            if reader is TSRC:
                out = np.empty((2,) + want.shape[1:], np.float32)
                ds.read_rows_into(name, 1, 3, out)
                assert np.array_equal(out, want[1:3])
    if fmt == "memmap":
        files = sorted(os.listdir(paths["ref"]))
        assert files == sorted(os.listdir(paths["port"]))
        for f in files:
            with open(os.path.join(paths["ref"], f), "rb") as a, \
                    open(os.path.join(paths["port"], f), "rb") as b:
                assert a.read() == b.read(), f


def test_make_dataset_cli_reads_in_the_reference(tmp_path):
    """The port's make_dataset writes slices bit-equal to its
    field_slices and volumes to its volume(), readable by the
    reference's MemmapSource."""
    path = TMK.main([str(tmp_path / "ds"), "--var", "miranda-vx:5:32",
                     "--var", "qmcpack:2:4:16:16", "--dtype", "float64",
                     "--seed", "3", "--device", "cpu"])
    ds = JSRC.open_dataset(path)
    assert ds.variables() == ("miranda-vx", "qmcpack-vol")
    assert np.array_equal(ds.read("miranda-vx"), TS.field_slices(
        "miranda-vx", count=5, n=32, seed=3, device=CPU).numpy())
    assert np.array_equal(ds.read("qmcpack-vol")[1], TS.volume(
        "qmcpack", (4, 16, 16), seed=4, device=CPU).numpy())
    with open(os.path.join(path, "manifest.json")) as f:
        assert json.load(f)["seed"] == 3


@pytest.mark.parametrize("shape", [(7,), (5, 6), (4, 3, 3), (6, 2, 3, 3)])
def test_digests_equal_the_reference(shape):
    """StreamingDigest over any chunk split and slice_digest equal the
    reference's digests of the same array (float64 in, float32 bytes)."""
    from repro.serve.method import slice_digest as j_slice_digest
    x = np.random.default_rng(0).normal(size=shape)
    want = j_slice_digest(x)
    assert slice_digest(x) == want
    assert slice_digest(torch.from_numpy(x.astype(np.float32))) == want
    for split in (1, 2, x.shape[0]):
        d, jd = TSRC.StreamingDigest(), JSRC.StreamingDigest()
        for lo in range(0, x.shape[0], split):
            d.update(x[lo:lo + split])
            jd.update(x[lo:lo + split])
        assert d.digest() == jd.digest() == want
        assert d.rows == x.shape[0]


def test_source_validation(tmp_path):
    gen = _gen(5, 32)
    with pytest.raises(ValueError, match="out of range"):
        gen.read_rows("miranda-vx", 0, 6)
    with pytest.raises(ValueError, match="rows= or budget_bytes="):
        list(gen.chunks("miranda-vx"))
    with pytest.raises(ValueError, match="budget must be positive"):
        TSRC.rows_per_chunk(gen.meta("miranda-vx"), 0)
    with pytest.raises(FileNotFoundError):
        TSRC.MemmapSource(str(tmp_path / "nope"))
    with pytest.raises(ValueError, match="neither"):
        TSRC.open_dataset(str(tmp_path / "nope.bin"))
    assert TSRC.rows_per_chunk(gen.meta("miranda-vx"), 1) == 1
    with pytest.raises(ValueError, match="shape must be"):
        TSRC.FieldVariable("miranda-vx", 3, (4, 4))
    d = TSRC.StreamingDigest()
    with pytest.raises(ValueError, match="before any update"):
        d.digest()
    d.update(np.zeros((2, 3)))
    with pytest.raises(ValueError, match="trailing shape"):
        d.update(np.zeros((2, 4)))


# ---------------------------------------------------------------------------
# Streamed == in-memory, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("budget, prefetch", [
    (4 * ROW_2D, 2), (4 * ROW_2D, 0), (1, 2), (100 * ROW_2D, 1),
    (3 * ROW_2D, 3)])
def test_stream_bitequal_2d(dataset, budget, prefetch):
    """Every chunking regime of the reference's test: a budget that does
    not divide k (ragged last chunk), single-row chunks, one covering
    chunk; prefetch on and off."""
    _, ds, ref = dataset
    got = TST.stream_features(
        ds, "miranda-vx", EBS, device=CPU,
        stream=TST.StreamConfig(budget_bytes=budget, prefetch=prefetch))
    assert got.shape == ref["miranda-vx"][0].shape
    assert np.array_equal(got, ref["miranda-vx"][0])


@pytest.mark.parametrize("rows", [2, 3, 5])
def test_stream_bitequal_rank4(dataset, rows):
    """Rank-4 volume variables chunk over the leading axis like slice
    stacks (HOSVD body, ragged last chunk)."""
    _, ds, ref = dataset
    got = TST.stream_features(
        ds, "qmcpack-vol", EBS, device=CPU,
        stream=TST.StreamConfig(budget_bytes=rows * ROW_4D))
    assert np.array_equal(got, ref["qmcpack-vol"][0])


@pytest.mark.parametrize("name", ["miranda-vx", "qmcpack-vol"])
def test_stream_quality_digest_and_entries(dataset, name):
    """quality=True streams both halves bit-equal to the in-memory pair;
    the streaming digest is slice_digest of the variable; the engine's
    stream entry and stream_dataset give the same tensor."""
    _, ds, ref = dataset
    row = ROW_2D if name == "miranda-vx" else ROW_4D
    cfg = TST.StreamConfig(budget_bytes=3 * row)
    d = TSRC.StreamingDigest()
    f, q = TST.stream_features(ds, name, EBS, stream=cfg, digest=d,
                               quality=True, device=CPU)
    assert np.array_equal(f, ref[name][0]) and np.array_equal(q, ref[name][1])
    assert d.digest() == slice_digest(ds.read(name))
    got = TP.get_engine().stream(ds, name, EBS, stream=cfg, device=CPU)
    assert np.array_equal(got, ref[name][0])
    digests = {}
    out = TST.stream_dataset(ds, EBS, stream=cfg, digests=digests,
                             device=CPU)
    assert np.array_equal(out[name], ref[name][0])
    assert digests[name] == d.digest()


@pytest.mark.parametrize("name", ["miranda-vx", "qmcpack-vol"])
def test_stream_matches_reference_stream(dataset, name):
    """The port's streamed features within 1e-5 of the reference's
    stream_features on the same dataset (the log q-ent column bit for
    bit), and its digest the same."""
    path, ds, _ = dataset
    row = ROW_2D if name == "miranda-vx" else ROW_4D
    jds = JSRC.MemmapSource(path)
    jd, d = JSRC.StreamingDigest(), TSRC.StreamingDigest()
    want = np.asarray(JST.stream_features(
        jds, name, EBS, stream=JST.StreamConfig(budget_bytes=4 * row),
        digest=jd))
    got = TST.stream_features(ds, name, EBS, digest=d, device=CPU,
                              stream=TST.StreamConfig(budget_bytes=4 * row))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[..., 0].view(np.int32),
                                  want[..., 0].view(np.int32))
    assert d.digest() == jd.digest()


@pytest.mark.parametrize("mode", ["features", "quality", "both"])
def test_sweep_padded_rows_equal_direct_rows(mode):
    """sweep_padded pads with copies of the last row; every real row,
    and every request block scatter_requests returns, is bit-equal to a
    direct sweep of those rows and of each row alone."""
    x = torch.from_numpy(TS.field_slices("qmcpack", count=5, n=24,
                                         device=CPU).numpy())
    cfg = TP.PredictorConfig()
    out = TDS.sweep_padded(x[:3], EBS, cfg, k_pad=8, mode=mode)
    assert out.shape == (8, 3, TP.SWEEP_MODE_WIDTHS[mode])
    direct = TP._sweep(x[:3], EBS, cfg, mode)
    assert torch.equal(out[:3], direct)
    assert torch.equal(out[3:], direct[2:3].expand(5, -1, -1))
    for i in range(3):
        assert torch.equal(direct[i], TP._sweep(x[i:i + 1], EBS, cfg, mode)[0])
    blocks = TDS.scatter_requests(out, [1, 2])
    assert [b.shape[0] for b in blocks] == [1, 2]
    assert np.array_equal(np.concatenate(blocks), TDS.gather_rows(direct))
    with pytest.raises(ValueError, match="smaller than batch"):
        TDS.sweep_padded(x, EBS, cfg, k_pad=2)
    with pytest.raises(ValueError, match="only"):
        TDS.scatter_requests(out, [5, 5])
    with pytest.raises(ValueError, match="expects"):
        TDS.sweep_padded(x[0], EBS, cfg)


def test_stream_validation():
    gen = _gen(4, 32)
    with pytest.raises(ValueError, match="budget_bytes must be positive"):
        TST.StreamConfig(budget_bytes=0)
    with pytest.raises(ValueError, match="max_in_flight"):
        TST.StreamConfig(max_in_flight=0)
    with pytest.raises(ValueError, match="error bound"):
        TST.stream_features(gen, "miranda-vx", [0.0], device=CPU)

    class Broken(TSRC.DatasetSource):
        def variables(self):
            return ("x",)

        def meta(self, name):
            return TSRC.VariableMeta("x", (4, 8, 8), "float32")

        def read_rows(self, name, lo, hi):
            raise RuntimeError("disk on fire")

    # a reader-thread failure surfaces as the caller's exception
    for prefetch in (2, 0):
        with pytest.raises(RuntimeError, match="disk on fire"):
            TST.stream_features(Broken(), "x", EBS, device=CPU,
                                stream=TST.StreamConfig(
                                    budget_bytes=1 << 10, prefetch=prefetch))
    assert TST.chunk_schedule(5, 2) == [(0, 2, 0, 2), (2, 4, 2, 4),
                                        (4, 5, 4, 5)]


# ---------------------------------------------------------------------------
# Advisor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("psnr", [None, 30.0, 45.0, 80.0])
def test_recommendation_logic_bit_equal(psnr):
    """harmonic_cr, eb_for_target and recommend return the reference's
    values, bit for bit, on the same numpy inputs."""
    rng = np.random.default_rng(1)
    ebs = np.asarray([1e-4, 1e-3, 3e-3, 1e-2])
    rows = np.exp(rng.normal(1.5, 0.8, size=(9, 3, 4))).cumsum(axis=2)
    assert np.array_equal(TADV.harmonic_cr(rows), JADV.harmonic_cr(rows))
    var_cr = JADV.harmonic_cr(rows)
    for ci in range(3):
        for t in (1.0, 4.0, 9.5, 30.0, 1e4):
            assert (TADV.eb_for_target(ebs, var_cr[ci], t)
                    == JADV.eb_for_target(ebs, var_cr[ci], t))
    var_psnr = np.asarray([70.0, 52.0, 44.0, 33.0])
    kw = {} if psnr is None else dict(psnr_floor=psnr, var_psnr=var_psnr)
    targets = [2.0, 8.0, 20.0, 1e4]
    assert (TADV.recommend(("a", "b", "c"), ebs, var_cr, targets, **kw)
            == JADV.recommend(("a", "b", "c"), ebs, var_cr, targets, **kw))


def test_advise_dataset_matches_reference(tmp_path):
    """advise_dataset on a small two-variable dataset: the reference's
    recommendations (compressor, feasibility), digests, grid and PSNR
    curve exactly.  CRs and ebs within 5e-3: the models are float32 fits
    on features that agree within 1e-5, which move a prediction by up to
    ~1e-3 (tests/test_torch_usecases.py holds single predictions there),
    and a harmonic mean over rows and an interpolated eb add to it.  The
    report has the reference's keys, at every level."""
    arrays = {
        "hurricane-u": TS.field_slices("hurricane-u", count=13, n=64,
                                       device=CPU).numpy(),
        "miranda-vx": TS.field_slices("miranda-vx", count=12, n=48,
                                      device=CPU).numpy()}
    path = TSRC.write_dataset(str(tmp_path / "ds"),
                              _array_source(TSRC, arrays), dtype="float64")
    kw = dict(compressors=("sz2", "zfp"), targets=(4.0, 8.0),
              train_rows=10, psnr_floor=40.0)
    budget = 5 * 64 * 64 * 4
    want = JADV.advise_dataset(JSRC.open_dataset(path), **kw,
                               stream=JST.StreamConfig(budget_bytes=budget))
    got = TADV.advise_dataset(TSRC.open_dataset(path), **kw, device=CPU,
                              stream=TST.StreamConfig(budget_bytes=budget))
    assert got.keys() == want.keys()
    assert got["variables"].keys() == want["variables"].keys()
    for name, w in want["variables"].items():
        g = got["variables"][name]
        assert g.keys() == w.keys()
        assert g["digest"] == w["digest"]
        assert g["eb_grid"] == w["eb_grid"]
        np.testing.assert_allclose(g["psnr_by_eb"], w["psnr_by_eb"],
                                   rtol=0, atol=0)
        for comp, crs in w["cr_by_compressor"].items():
            np.testing.assert_allclose(g["cr_by_compressor"][comp], crs,
                                       rtol=5e-3)
        assert g["targets"].keys() == w["targets"].keys()
        for t, rec in w["targets"].items():
            mine = g["targets"][t]
            for key in ("compressor", "feasible", "psnr_ok"):
                assert mine[key] == rec[key], (name, t, key)
            for key in ("eb", "predicted_cr", "predicted_psnr"):
                np.testing.assert_allclose(mine[key], rec[key], rtol=5e-3)
            assert mine.keys() == rec.keys()


def test_advise_models_validation_and_cr_table():
    """check_models rejects what the reference rejects; cr_table clamps
    like EbGridModel.predict and gives one CR per (row, model, eb)."""
    from repro_torch.core import usecases as UC
    stack = TS.field_slices("miranda-vx", count=6, n=32, device=CPU)
    rng = float(stack.max() - stack.min())
    ebs = [r * rng for r in (1e-3, 1e-2)]
    models = {c: UC.EbGridModel.train(stack[:4], c, ebs) for c in
              ("sz2", "zfp")}
    assert np.array_equal(AdviseMethod.check_models(models)[0], ebs)
    assert AdviseMethod.check_models(models)[1] == 3
    feats = TP.features_sweep(stack, ebs).numpy()
    cr = AdviseMethod.cr_table(models, feats)
    assert cr.shape == (6, 2, 2) and np.all(cr > 0)
    assert cr[0, 1, 1] == pytest.approx(
        models["zfp"].predict(stack[0], ebs[1]), rel=1e-6)
    bad = dict(models)
    bad["zfp2"] = UC.EbGridModel.train(stack[:4], "zfp", [e * 2 for e in ebs])
    with pytest.raises(ValueError, match="share one eb grid"):
        AdviseMethod.check_models(bad)
    with pytest.raises(ValueError, match="at least one"):
        AdviseMethod.check_models({})


def test_advise_cli_end_to_end(tmp_path):
    """make_dataset CLI -> advise CLI on the CPU: the JSON report covers
    every variable and target, with finite numbers."""
    ds = TMK.main([str(tmp_path / "ds"), "--var", "miranda-vx:8:32",
                   "--var", "qmcpack:6:32", "--dtype", "float64",
                   "--seed", "3", "--device", "cpu"])
    out = tmp_path / "report.json"
    report = TADV.main([ds, "--compressors", "sz3-lorenzo,zfp", "--targets",
                        "4,8", "--train-rows", "4", "--budget-mb", "0.02",
                        "--device", "cpu", "--use-kernels",
                        "--out", str(out)])
    with open(out) as f:
        assert json.load(f)["variables"].keys() == report["variables"].keys()
    assert set(report["variables"]) == {"miranda-vx", "qmcpack"}
    for var in report["variables"].values():
        assert set(var["targets"]) == {"4", "8"}
        for rec in var["targets"].values():
            assert rec["compressor"] in ("sz3-lorenzo", "zfp")
            assert np.isfinite(rec["eb"]) and rec["eb"] > 0
            assert np.isfinite(rec["predicted_cr"]) and rec["predicted_cr"] > 0
