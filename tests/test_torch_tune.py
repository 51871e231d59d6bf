"""The port's kernel tuning module (``repro_torch.kernels.tune``).

The launch shapes are compile-time constants (the Gram's 128 x 128 tile
and 32-deep stage, q-ent's 16384 elements a CTA, a 196 608-byte counter
budget on an H100), and the q-ent search runs offline over candidate
builds of ``csrc/qent.cu``: it admits a candidate only if its output
is the default's bits and only if it wins by more than 2 %, as the
reference's search does.  The card's own cases are in
``tests/test_torch_tune_cuda.py``.
"""
import dataclasses
import json
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

from repro.core import predictors as JP  # noqa: E402
from repro.kernels import tune as JKT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import predictors as TP  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import tune as KT  # noqa: E402
from repro_torch.kernels.qent import ops as qent_ops  # noqa: E402

CSRC = pathlib.Path(_build.CSRC)


# ------------------------------------------------------ backend and card
def test_backend_kind_and_hardware():
    assert KT.normalize_kind("NVIDIA H100 80GB HBM3") == "h100"
    assert KT.normalize_kind(" NVIDIA H100 ") == "h100"
    assert KT.normalize_kind("NVIDIA H200") == "nvidia-h200"
    assert KT.backend_kind("cpu") == "cpu"
    assert KT.backend_kind(torch.device("cpu")) == "cpu"
    assert KT.hw_for("h100")["peak_flops"] == 67e12
    assert KT.hw_for("h100")["mem_bw"] == 3.35e12
    assert KT.hw_for("h100")["smem_bytes"] == 232448
    assert KT.hw_for("nvidia-h100-80gb-hbm3") is KT.BACKEND_HW["h100"]
    assert KT.hw_for("h100-pcie") is KT.BACKEND_HW["h100"]       # prefix
    assert KT.hw_for("quantum") is KT.BACKEND_HW["default"]
    assert KT.smem_budget("h100") == 196608
    assert KT.smem_budget("quantum") == 196608
    assert KT.smem_budget("cpu") == 0


def test_launch_shapes_are_the_kernels_constants():
    """The plain builds launch as before: q-ent takes at least 16384
    elements a CTA with a 192 KiB counter budget on an H100, the Gram
    128 x 128 tiles of 32-deep stages; the search's default is the
    plain build, with no defines."""
    qent = (CSRC / "qent.cu").read_text()
    assert re.search(r"#define REPRO_QENT_MIN_PER_CTA 16384\b", qent)
    assert KT.DEFAULT_TILE == 16384 and KT.tile_defines(16384) == ()
    assert KT.smem_budget("h100") == 192 * 1024
    gram = (CSRC / "gram.cu").read_text()
    assert re.search(r"constexpr int BM = 128;", gram)
    assert re.search(r"constexpr int BK = 32;", gram)
    assert "REPRO_" not in gram           # no build-time knob


@pytest.mark.parametrize("x", list(range(1, 70)) + [1800, 1028, 3240000,
                                                    37748736, 2 ** 20])
def test_bucket_matches_reference(x):
    assert KT._bucket_p2(x) == JKT._bucket_p2(x)


def test_constants_match_reference():
    assert KT.HYSTERESIS == JKT.HYSTERESIS
    assert KT.SCHEMA_VERSION == JKT.SCHEMA_VERSION


def test_keys():
    assert KT.qent_key(41, 3240000, 65536, 6) \
        == "qent:f32:k64:n4194304:b65536:e8"
    assert KT.qent_key(1, 3240000, 65536, 6) \
        != KT.qent_key(32, 3240000, 65536, 6)       # the batch's bucket
    full = [KT.qent_key(*c) for c in KT.FULL_QENT_CELLS]
    assert len(set(full)) == len(full)


# ------------------------------------------------------ candidate builds
def test_candidate_builds_have_their_own_libraries():
    variants = KT.qent_variants()
    assert [d for _, d in variants] == [
        (f"REPRO_QENT_MIN_PER_CTA={t}",) for t in KT.QENT_TILE_CANDIDATES
        if t != KT.DEFAULT_TILE]
    paths = {_build.library_path(n, d) for n, d in variants}
    paths.add(_build.library_path("qent"))
    assert len(paths) == len(variants) + 1
    assert _build.library_path("qent", ()) == _build.library_path("qent")


def test_build_starts_every_nvcc_together(tmp_path, monkeypatch):
    """One nvcc per missing library, the variants with their -D flags,
    every process started before the first is waited on; a built
    library is not built again."""
    events = []

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **_):
            self.cmd = cmd
            events.append(("start", cmd))

        def communicate(self):
            events.append(("wait", self.cmd))
            out = pathlib.Path(self.cmd[self.cmd.index("-o") + 1])
            out.write_bytes(b"")
            return "", None

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", FakeProc)
    paths = _build.build(["qent", "gram"], KT.qent_variants())
    starts = [c for kind, c in events if kind == "start"]
    assert len(starts) == 2 + len(KT.qent_variants())
    assert [kind for kind, _ in events[:len(starts)]] == ["start"] * len(starts)
    for n, d in KT.qent_variants():
        cmd = next(c for c in starts if f"-D{d[0]}" in c)
        assert cmd[-1].endswith("qent.cu")
        assert paths[(n, d)].exists()
    assert all(p.exists() for p in (paths["qent"], paths["gram"]))
    plain = next(c for c in starts if c[-1].endswith("qent.cu")
                 and not any(a.startswith("-D") for a in c))
    assert plain[:len(_build.NVCC_FLAGS) + 1] == ["nvcc", *_build.NVCC_FLAGS]
    events.clear()
    assert _build.build(["qent"], KT.qent_variants()) == {
        k: v for k, v in paths.items() if k != "gram"}
    assert events == []


def test_load_builds_only_its_library(tmp_path, monkeypatch):
    """Loading a library (the plain build or a variant) starts one nvcc,
    for that library alone, once."""
    started = []

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **_):
            started.append(cmd)
            self.out = pathlib.Path(cmd[cmd.index("-o") + 1])

        def communicate(self):
            self.out.write_bytes(b"")
            return "", None

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", FakeProc)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    monkeypatch.setattr(_build, "_LIBS", {})
    (_, d), = KT.qent_variants()[:1]
    assert _build.load("qent", d) == ("lib", str(_build.library_path(
        "qent", d)))
    assert len(started) == 1 and f"-D{d[0]}" in started[0]
    _build.load("qent")
    _build.load("qent", d)
    assert len(started) == 2 and started[1][-1].endswith("qent.cu")
    assert not any(a.startswith("-D") for a in started[1])


def test_launch_refuses_a_cpu_tensor():
    """The kernel's launch takes CUDA tensors only; the CPU route is the
    wrapper's plain version, which has no tile."""
    x = torch.zeros((2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        qent_ops.launch(x, torch.tensor([0.1]), 512, KT.tile_defines(4096))


# --------------------------------------------------------------- search
def test_search_bit_filter_discards_unsafe_candidate():
    """A candidate whose histograms differ is dropped even when it is the
    fastest."""
    h = torch.arange(8, dtype=torch.int32)

    def run(tile):
        return h + (1 if tile == 8192 else 0)

    def timer(fn, tile):
        return 0.5 if tile == 8192 else 1.0
    cell = KT.search_qent_cell(1, 1 << 20, 65536, 1, run=run, timer=timer,
                               device="cpu")
    assert cell["discarded_bit_unsafe"] == [8192]
    assert cell["tile"] == 16384 and cell["speedup"] == 1.0
    assert "8192" not in cell["times"]


@pytest.mark.parametrize("gain, want", [(0.01, 16384), (0.019, 16384),
                                        (0.05, 8192)])
def test_search_hysteresis(gain, want):
    """A 1 % (or 1.9 %) win keeps the default; 5 % takes the winner."""
    h = torch.arange(8, dtype=torch.int32)

    def run(tile):
        return h.clone()

    def timer(fn, tile):
        return 1.0 - gain if tile == 8192 else 1.0
    cell = KT.search_qent_cell(1, 1 << 20, 65536, 1, run=run, timer=timer,
                               device="cpu")
    assert cell["tile"] == want
    assert cell["discarded_bit_unsafe"] == []
    assert set(cell["times"]) == {str(t) for t in KT.QENT_TILE_CANDIDATES}
    assert cell["speedup"] == pytest.approx(1.0 / (1.0 - gain)
                                            if want != 16384 else 1.0)


def test_search_skips_tiles_above_the_slice():
    h = torch.zeros(4, dtype=torch.int32)
    cell = KT.search_qent_cell(1, 5000, 4096, 1, run=lambda tile: h,
                               timer=lambda fn, tile: 1.0, device="cpu")
    assert set(cell["times"]) == {"4096", "8192", "16384"}


def test_search_on_cpu_runs_the_plain_version():
    """The search through the wrapper's plain version: every candidate
    passes the filter, and the cell is well formed."""
    q = KT.search_qent_cell(2, 9000, 512, 2, iters=2, device="cpu")
    assert q["discarded_bit_unsafe"] == [] and not q["cold"]
    assert q["tile"] in KT.QENT_TILE_CANDIDATES and q["t_default"] > 0
    assert q["shape"] == [2, 9000, 512, 2]


def test_cli_writes_the_report(tmp_path):
    out = tmp_path / "sub" / "report.json"
    KT.main(["--smoke", "--device", "cpu", "--iters", "1", "--out",
             str(out)])
    report = json.loads(out.read_text())
    assert report["schema_version"] == KT.SCHEMA_VERSION
    assert report["backend"] == "cpu" and report["card"] is None
    (key, cell), = report["cells"].items()
    assert key == KT.qent_key(*KT.SMOKE_QENT_CELLS[0])
    assert cell["tile"] in KT.QENT_TILE_CANDIDATES


def test_time_fn_on_cpu():
    calls = []
    t = KT.time_fn(lambda: calls.append(1), warmup=2, iters=3)
    assert t >= 0 and len(calls) == 5


# ----------------------------------------------------------- the config
def test_convert_drops_reference_tune():
    """The reference's TuneConfig holds TPU block shapes; the port's
    config has no counterpart, so ``convert`` drops it."""
    jcfg = JP.PredictorConfig(use_kernels=True, qent_bins=4096,
                              tune=JKT.TuneConfig(gram_bn=512, qent_tile=1024))
    for fields in ({k: getattr(jcfg, k) for k in jcfg.__dataclass_fields__},
                   dataclasses.asdict(jcfg)):
        cfg = convert.predictor_config(fields)
        assert cfg == TP.PredictorConfig(use_kernels=True, qent_bins=4096)
        assert "tune" not in TP.PredictorConfig.__dataclass_fields__
