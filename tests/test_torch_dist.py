"""The port's sharded sweep layer (``repro_torch.dist``, ``launch.mesh``)
against its own single-device sweep and the reference's.

The gate, as in the reference's tests/test_dist_sweep.py and
tests/test_multihost.py: every sharded or process-spanning sweep equals
the single-device sweep of the same rows.  Here it is held BIT FOR BIT
against the port's single-device sweep (a row's bits depend on nothing
but the row), and within the reference's own 1e-5 (quality bit-equal)
against the reference's single-device ``features_sweep`` on the same
numpy input.  Every test names its reference counterpart where there is
one; the reference's leader/follower service test waits for the
service's process fabric.

One process holds several shards on the CPU (``devices=["cpu"] * n``).
Multi-process cases run as gloo process groups of fresh interpreters
joined by ``file://`` init under the test's tmp dir, each process under
its own wall-clock limit; a cohort runs once per module and saves what
each process computed, and the tests compare it here.
"""
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import predictors as JP  # noqa: E402
from repro_torch import compressors as TC  # noqa: E402
from repro_torch.core import pipeline as TPL  # noqa: E402
from repro_torch.core import predictors as TP  # noqa: E402
from repro_torch.core import stream as TST  # noqa: E402
from repro_torch.core import usecases as TUC  # noqa: E402
from repro_torch.data import scientific as TS  # noqa: E402
from repro_torch.data import source as TSRC  # noqa: E402
from repro_torch.dist import sharding as S  # noqa: E402
from repro_torch.dist import sweep as DS  # noqa: E402
from repro_torch.launch import advise as TADV  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = "cpu"
RANK_TIMEOUT_S = 60
K2, N2 = 7, 48                      # 2-D stacks: 7 slices of 48 x 48
VOL_SHAPE, K_VOL = (12, 16, 20), 3  # volumes: 3 of 12 x 16 x 20
EB_RELS = (1e-3, 3e-3, 1e-2, 3e-2, 1e-1)
ROUTES = {"sort": TP.PredictorConfig(),
          "kernel": TP.PredictorConfig(use_kernels=True, qent_bins=4096)}
JAX_ROUTES = {"sort": JP.PredictorConfig(),
              "kernel": JP.PredictorConfig(use_kernels=True, qent_bins=4096)}


def _slices() -> torch.Tensor:
    return TS.field_slices("miranda-vx", count=K2, n=N2, device=CPU)


def _volumes() -> torch.Tensor:
    return torch.stack([TS.volume("miranda-vx", VOL_SHAPE, seed=s,
                                  device=CPU) for s in range(K_VOL)])


def _ebs(x) -> list:
    rng = float(x.max() - x.min())
    return [r * rng for r in EB_RELS]


STACKS = {3: _slices, 4: _volumes}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Every result here is made on one thread, as the ranks make theirs
    (their environment): on the CPU, ``eigvalsh``'s last bits follow the
    thread count (LAPACK over a threaded BLAS)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def stacks():
    return {rank: (make(), _ebs(make())) for rank, make in STACKS.items()}


@pytest.fixture(scope="module")
def jax_both(stacks):
    """The reference's single-device "both" sweep per (rank, route)."""
    out = {}
    for rank, (x, ebs) in stacks.items():
        for route, cfg in JAX_ROUTES.items():
            out[rank, route] = np.asarray(JP._features_sweep_traced(
                jnp.asarray(x.numpy()), jnp.asarray(ebs, jnp.float32),
                vf=JP.variance_fraction_for(cfg, x.ndim), bins=cfg.qent_bins,
                use_kernels=cfg.use_kernels, tune=cfg.tune, mode="both"))
    return out


MODE_COLS = {"features": slice(0, 2), "quality": slice(2, 4),
             "both": slice(0, 4)}


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def assert_bit_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def assert_near_reference(got, jax_both_rows, mode, route):
    """Within the reference's 1e-5 of its single-device sweep; the
    quality half bit-equal, and so is the sort route's log q-ent."""
    want = jax_both_rows[..., MODE_COLS[mode]]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if mode != "features":
        assert_bit_equal(got[..., -2:], want[..., -2:])
    if mode != "quality" and route == "sort":
        assert_bit_equal(got[..., 0], want[..., 0])


# ---------------------------------------------------------------------------
# The pure rules (the reference's arithmetic, written out)
# ---------------------------------------------------------------------------

class _FakeGroup:
    """Stands for a process group where only the rules are exercised."""


# (shares, k) -> each process's [lo, hi): k_pad = ceil(k / extent) *
# extent, k_pad / extent rows per shard, blocks proportional to shares,
# clipped to k
PROCESS_BLOCKS = {
    ((1, 1), 1): [(0, 1), (1, 1)],
    ((1, 1), 2): [(0, 1), (1, 2)],
    ((1, 1), 5): [(0, 3), (3, 5)],
    ((2, 1), 2): [(0, 2), (2, 2)],
    ((2, 1), 3): [(0, 2), (2, 3)],
    ((2, 1), 7): [(0, 6), (6, 7)],
    ((1, 3), 2): [(0, 1), (1, 2)],
    ((1, 3), 4): [(0, 1), (1, 4)],
    ((1, 3), 9): [(0, 3), (3, 9)],
}


@pytest.mark.parametrize("shares,k", sorted(PROCESS_BLOCKS))
def test_process_block_rules(monkeypatch, shares, k):
    """process_block for shares (1, 1), (2, 1) and (1, 3) with k below,
    at and above the extent: contiguous blocks proportional to the
    shares, real rows at their global positions, the pad rows (and a
    process with no row) at the end."""
    import torch.distributed as dist
    ranks = tuple(range(len(shares)))
    blocks = []
    for rank in ranks:
        mesh = DS.SweepMesh((torch.device(CPU),) * shares[rank], shares,
                            ranks, _FakeGroup())
        monkeypatch.setattr(dist, "get_rank", lambda: rank)
        blocks.append(DS.process_block(k, mesh))
    assert blocks == PROCESS_BLOCKS[shares, k]
    # the blocks tile [0, k) in rank order
    assert [lo for lo, _ in blocks[1:]] == [hi for _, hi in blocks[:-1]]
    assert blocks[0][0] == 0 and blocks[-1][1] == k


def test_even_bounds_rules():
    """_even_bounds: the reference's partition (tests/test_dist_sweep.py::
    test_sharded_helpers_single_device), remainder on the leading parts,
    an empty part when k is below the part count."""
    assert [DS._even_bounds(10, 3, i) for i in range(3)] == \
        [(0, 4), (4, 7), (7, 10)]
    assert [DS._even_bounds(2, 3, i) for i in range(3)] == \
        [(0, 1), (1, 2), (2, 2)]
    assert [DS._even_bounds(6, 2, i) for i in range(2)] == [(0, 3), (3, 6)]


def test_pad_block_repeats_last_row_or_feeds_zeros():
    x = torch.arange(12, dtype=torch.float32).reshape(3, 2, 2)
    padded = DS._pad_block(x, 5)
    assert torch.equal(padded[:3], x)
    assert torch.equal(padded[3:], x[-1:].expand(2, 2, 2))
    assert torch.equal(DS._pad_block(x[:0], 2), torch.zeros(2, 2, 2))
    assert DS._pad_block(x, 3) is x


# ---------------------------------------------------------------------------
# One process, several shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["features", "quality", "both"])
@pytest.mark.parametrize("route", ["sort", "kernel"])
@pytest.mark.parametrize("rank", [3, 4])
@pytest.mark.parametrize("shards", [2, 3])
def test_shards_in_one_process_bit_equal(stacks, jax_both, shards, rank,
                                         route, mode):
    """Counterpart of tests/test_dist_sweep.py::
    test_sharded_sweep_matches_single_device, with the volumes of
    tests/test_sweep_3d.py: features_sweep_sharded over ["cpu"] * 2 and
    * 3 (7 slices pad to 8 and 9, 3 volumes to 4 and stay 3), on both
    q-ent routes and in every mode: gather=True is the port's
    single-device sweep bit for bit and within 1e-5 of the reference's;
    gather=False holds the same real rows and zeroed pad rows."""
    x, ebs = stacks[rank]
    cfg = ROUTES[route]
    mesh = M.make_sweep_mesh(devices=[CPU] * shards)
    want = TP._sweep(x, ebs, cfg, mode).numpy()
    got = DS.features_sweep_sharded(x, ebs, cfg, mesh=mesh, mode=mode)
    assert_bit_equal(got, want)
    assert_near_reference(got.numpy(), jax_both[rank, route], mode,
                          route)
    padded = DS.features_sweep_sharded(x, ebs, cfg, mesh=mesh, mode=mode,
                                       gather=False)
    k = x.shape[0]
    assert padded.shape == (-(-k // shards) * shards,) + want.shape[1:]
    assert len(padded.blocks) == shards
    rows = DS.gather_rows(padded)
    assert_bit_equal(rows[:k], want)
    assert not rows[k:].any()


@pytest.mark.parametrize("route", ["sort", "kernel"])
def test_shards_on_distinct_devices_run_on_threads(stacks, monkeypatch,
                                                   route):
    """Shards on distinct devices sweep on a thread per device, a
    device's shards in turn; the rows are the single-device rows bit for
    bit.  ("cpu" and "cpu:0" are distinct devices to the mesh, so the
    host stands in for two cards.)"""
    import threading
    x, ebs = stacks[3]
    cfg = ROUTES[route]
    want = TP._sweep(x, ebs, cfg, "both").numpy()
    threads = []
    real = TP._sweep

    def recorded(*a, **kw):
        threads.append(threading.get_ident())
        return real(*a, **kw)

    monkeypatch.setattr(TP, "_sweep", recorded)
    mesh = M.make_sweep_mesh(devices=[CPU, "cpu:0", CPU])
    got = DS.features_sweep_sharded(x, ebs, cfg, mesh=mesh, mode="both")
    assert_bit_equal(got, want)
    assert len(threads) == 3 and len(set(threads)) == 2
    assert threading.get_ident() not in threads


def test_sharded_out_option_masks_padding(stacks):
    """Counterpart of tests/test_dist_sweep.py::
    test_sharded_out_option_masks_padding: through features_sweep under
    use_mesh, 7 slices on 4 shards pad to 8, the pad row is zero, one
    block per shard."""
    x, ebs = stacks[3]
    with S.use_mesh(M.make_sweep_mesh(devices=[CPU] * 4)):
        padded = TP.features_sweep(x, ebs, gather=False)
        gathered = TP.features_sweep(x, ebs)
    assert isinstance(padded, DS.ShardedRows)
    assert padded.shape == (8, len(ebs), 2) and len(padded.blocks) == 4
    rows = DS.gather_rows(padded)
    assert not rows[7:].any()
    assert_bit_equal(rows[:7], gathered)


def test_sharded_volume_sweep_matches_single_device(stacks, jax_both):
    """Counterpart of tests/test_sweep_3d.py::
    test_sharded_volume_sweep_matches_single_device: volumes under
    use_mesh (divisible and ragged), and gather=False with the pad
    zeroed."""
    v, ebs = stacks[4]
    want = TP.features_sweep(v, ebs, sharded=False)
    for shards in (3, 2):
        with S.use_mesh(M.make_sweep_mesh(devices=[CPU] * shards)):
            got = TP.features_sweep(v, ebs)
            padded = TP.features_sweep(v, ebs, gather=False)
        assert_bit_equal(got, want)
        assert_near_reference(got.numpy(), jax_both[4, "sort"], "features",
                              "sort")
        rows = DS.gather_rows(padded)
        assert rows.shape[0] == -(-K_VOL // shards) * shards
        assert not rows[K_VOL:].any()


def test_engine_and_pipeline_auto_route_under_mesh(stacks, monkeypatch):
    """Counterpart of tests/test_dist_sweep.py::
    test_engine_and_pipeline_auto_route_under_mesh: the pipeline, the
    engine and the kernel route shard under use_mesh, bit-equal to one
    device; a single slice (the UC query shape) stays on one device."""
    x, ebs = stacks[3]
    kcfg = ROUTES["kernel"]
    ref_sweep = TPL.featurize_sweep(x, ebs)
    ref_feats = TPL.featurize_slices(x, ebs[0])
    ref_kern = TP.features_sweep(x, ebs, kcfg, sharded=False)
    calls = []
    real = DS.features_sweep_sharded

    def counted(*a, **kw):
        calls.append(a[0].shape[0])
        return real(*a, **kw)

    monkeypatch.setattr(DS, "features_sweep_sharded", counted)
    with S.use_mesh(M.make_sweep_mesh(devices=[CPU] * 2)):
        assert S.current_mesh().size == 2
        assert_bit_equal(TPL.featurize_sweep(x, ebs), ref_sweep)
        assert_bit_equal(TPL.featurize_slices(x, ebs[0]), ref_feats)
        assert_bit_equal(TP.get_engine(kcfg).sweep(x, ebs), ref_kern)
        one = TP.features_sweep(x[:1], ebs)
    assert calls == [K2, K2, K2]
    assert_bit_equal(one, ref_sweep[:1])
    assert S.current_mesh() is None


def test_explicit_mesh_argument(stacks):
    """Counterpart of tests/test_dist_sweep.py::test_explicit_mesh_argument:
    mesh= shards with no use_mesh; sharded=True with no usable mesh
    raises; a mesh of one shard leaves the sweep on one device."""
    x, ebs = stacks[3]
    mesh = M.make_sweep_mesh(devices=[CPU] * 3)
    assert_bit_equal(TP.features_sweep(x, ebs, mesh=mesh),
                     TP.features_sweep(x, ebs, sharded=False))
    with pytest.raises(ValueError, match="mesh of extent > 1"):
        TP.features_sweep(x, ebs, sharded=True)
    with S.use_mesh(M.make_sweep_mesh(devices=[CPU])):
        assert DS.active_sweep_mesh() is None
        with pytest.raises(ValueError, match="mesh of extent > 1"):
            TP.features_sweep(x, ebs, sharded=True)


def test_ebgrid_train_under_mesh_matches(stacks):
    """Counterpart of tests/test_dist_sweep.py::
    test_ebgrid_train_under_mesh_matches: EbGridModel.train under a mesh
    predicts what the unsharded model predicts, exactly."""
    x, ebs = stacks[3]
    ebs = ebs[:3]
    ref = TUC.EbGridModel.train(x[:6], "sz2", ebs)
    with S.use_mesh(M.make_sweep_mesh(devices=[CPU] * 4)):
        sharded = TUC.EbGridModel.train(x[:6], "sz2", ebs)
    for eps in (ebs[0], (ebs[0] * ebs[1]) ** 0.5, ebs[-1]):
        assert sharded.predict(x[6], eps) == ref.predict(x[6], eps)


def test_sharded_helpers_single_device(stacks):
    """Counterpart of tests/test_dist_sweep.py::
    test_sharded_helpers_single_device: no mesh anywhere, and
    features_sweep_sharded falls back to the single-device sweep."""
    x, ebs = stacks[3]
    assert DS.active_sweep_mesh(None) is None
    assert not DS.mesh_spans_processes(None)
    assert_bit_equal(DS.features_sweep_sharded(x[:2], ebs),
                     TP.features_sweep(x[:2], ebs, sharded=False))


@pytest.mark.parametrize("name", ["sz3-lorenzo", "zfp"])
def test_training_crs_single_process(stacks, name):
    """Counterpart of tests/test_dist_sweep.py::
    test_training_crs_single_process: the serial loop's table, float64
    bit for bit, with or without a one-process mesh."""
    x, ebs = stacks[3]
    comp = TC.get(name)
    want = np.asarray([[comp.cr(s, e) for e in ebs[:2]] for s in x[:3]])
    for mesh in (None, M.make_sweep_mesh(devices=[CPU] * 2)):
        got = DS.training_crs(comp, x[:3], ebs[:2], mesh=mesh)
        np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))


def test_make_sweep_mesh_single_device(stacks):
    """Counterpart of tests/test_multihost.py::
    test_make_sweep_mesh_single_device: a one-shard mesh builds and the
    sweep takes the single-device path."""
    x, ebs = stacks[3]
    mesh = M.make_sweep_mesh(1, devices=[CPU] * 2)
    assert mesh.devices == (torch.device(CPU),) and mesh.size == 1
    assert DS.active_sweep_mesh(mesh) is None
    got = DS.features_sweep_sharded(x[:2], ebs, mesh=mesh)
    assert isinstance(got, torch.Tensor)
    assert_bit_equal(got, TP.features_sweep(x[:2], ebs, sharded=False))


def test_make_sweep_mesh_rejects_beyond_the_runtime():
    """Counterpart of tests/test_multihost.py::
    test_make_sweep_mesh_rejects_process_spanning_without_dist: more
    shards than the process has raises at once with the dist_init hint;
    0 raises."""
    with pytest.raises(ValueError, match="dist_init"):
        M.make_sweep_mesh(5, devices=[CPU])
    with pytest.raises(ValueError):
        M.make_sweep_mesh(0, devices=[CPU])
    with pytest.raises(ValueError, match="tcp://"):
        M.dist_init("localhost:1", num_processes=1, process_id=0,
                    device=CPU)


def test_make_sweep_mesh_non_power_of_two(stacks):
    """Counterpart of tests/test_multihost.py::
    test_make_sweep_mesh_non_power_of_two: 6 shards, k = 7 pads to 12."""
    x, ebs = stacks[3]
    mesh = M.make_sweep_mesh(devices=[CPU] * 6)
    assert mesh.size == 6 and DS.process_block(K2, mesh) == (0, K2)
    assert_bit_equal(DS.features_sweep_sharded(x, ebs, mesh=mesh),
                     TP.features_sweep(x, ebs, sharded=False))


def test_process_local_needs_a_spanning_mesh(stacks):
    """Counterpart of tests/test_multihost.py::
    test_process_block_single_process_mesh_raises_cleanly: process_local
    with no mesh, or on a one-process mesh, raises."""
    x, ebs = stacks[3]
    with pytest.raises(ValueError, match="process-spanning"):
        DS.features_sweep_sharded(x[:4], ebs, process_local=True, global_k=4)
    with pytest.raises(ValueError, match="process-spanning"):
        DS.features_sweep_sharded(x[:4], ebs, process_local=True, global_k=4,
                                  mesh=M.make_sweep_mesh(devices=[CPU] * 2))


def test_sweep_padded_sharded_matches_single_device(stacks):
    """Counterpart of tests/test_sweep_service.py::
    test_sweep_padded_sharded_matches_single_device: a bucket equal to
    the extent launches sharded, real rows bit-equal (a ragged batch
    too); a bucket below the extent runs on one device."""
    x, ebs = stacks[3]
    mesh = M.make_sweep_mesh(devices=[CPU] * 4)
    ref = TP.features_sweep(x[:4], ebs, sharded=False).numpy()
    out = DS.sweep_padded(x[:4], ebs, k_pad=4, mesh=mesh)
    assert isinstance(out, DS.ShardedRows)
    assert_bit_equal(DS.gather_rows(out), ref)
    ragged = DS.sweep_padded(x[:3], ebs, k_pad=4, mesh=mesh)
    blocks = DS.scatter_requests(ragged, [1, 2])
    assert_bit_equal(blocks[0], ref[:1])
    assert_bit_equal(blocks[1], ref[1:3])
    below = DS.sweep_padded(x[:2], ebs, k_pad=3, mesh=mesh)
    assert isinstance(below, torch.Tensor)
    assert_bit_equal(below[:2], ref[:2])


def _write_dataset(path) -> str:
    gen = TSRC.GeneratorSource([TSRC.FieldVariable("miranda-vx", 10, (32,)),
                                TSRC.FieldVariable("qmcpack", 7, (4, 8, 8))],
                               device=CPU)
    return TSRC.write_dataset(str(path), gen, fmt="memmap", dtype="float64",
                              budget_bytes=1 << 20)


STREAM_EBS = [1e-3, 1e-2]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = _write_dataset(tmp_path_factory.mktemp("dist") / "ds")
    src = TSRC.MemmapSource(path)
    want = {n: TP.features_sweep(torch.from_numpy(src.read(n)), STREAM_EBS,
                                 sharded=False, quality=True)
            for n in src.variables()}
    return path, {n: tuple(t.numpy() for t in w) for n, w in want.items()}


def test_stream_sharded_mesh_bitequal(dataset):
    """Counterpart of tests/test_stream.py::test_stream_sharded_mesh_bitequal:
    one process, 4 shards; chunks whose bucket the extent divides launch
    sharded, a ragged bucket on one device, all bit-equal to the
    in-memory sweep."""
    path, want = dataset
    src = TSRC.MemmapSource(path)
    mesh = M.make_sweep_mesh(devices=[CPU] * 4)
    for rows in (4, 3):
        got = TST.stream_features(
            src, "miranda-vx", STREAM_EBS, mesh=mesh, device=CPU,
            stream=TST.StreamConfig(budget_bytes=rows * 32 * 32 * 4))
        assert_bit_equal(got, want["miranda-vx"][0])


# ---------------------------------------------------------------------------
# Process groups (gloo on the CPU)
# ---------------------------------------------------------------------------

RANK_PREAMBLE = """
import json, sys
import numpy as np, torch
from repro_torch.launch import mesh as M
INIT, NPROCS, RANK, OUT = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                           sys.argv[4])
M.dist_init(INIT, num_processes=NPROCS, process_id=RANK, backend="gloo",
            device="cpu", init_timeout_s={timeout})
SAVED, ERRORS = {{}}, {{}}

def save(name, value):
    SAVED[name] = np.asarray(value)

def error(name, fn):
    try:
        fn()
    except ValueError as e:
        ERRORS[name] = str(e)
    else:
        ERRORS[name] = None
"""

RANK_EPILOGUE = """
np.savez(f"{OUT}/rank{RANK}.npz", **SAVED)
with open(f"{OUT}/rank{RANK}.json", "w") as f:
    json.dump(ERRORS, f)
torch.distributed.destroy_process_group()
"""


def _rank_env() -> dict:
    """A rank's environment: the port on its path, and one thread for its
    CPU pools (ranks that each take every core starve each other)."""
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=SRC + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


def run_ranks(tmp_path, body: str, nprocs: int, consts: dict) -> list:
    """Run ``body`` in ``nprocs`` gloo processes (``RANK``, ``NPROCS``,
    ``save``, ``error`` and ``consts`` in scope), each under
    RANK_TIMEOUT_S; returns each process's (saved arrays, errors)."""
    header = "".join(f"{k} = {v!r}\n" for k, v in consts.items())
    script = tmp_path / "rank.py"
    script.write_text(RANK_PREAMBLE.format(timeout=RANK_TIMEOUT_S) + header
                      + textwrap.dedent(body) + RANK_EPILOGUE)
    env = _rank_env()
    init = f"file://{tmp_path / 'init'}"
    procs = [subprocess.Popen([sys.executable, str(script), init, str(nprocs),
                               str(r), str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(nprocs)]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        outs = [p.communicate() for p in procs]
        raise AssertionError("process group timed out:\n" + "\n".join(
            f"--- rank {i} ---\n{o}\n{e}" for i, (o, e) in enumerate(outs)))
    report = "\n".join(f"--- rank {i} (rc={p.returncode}) ---\n{o}\n{e}"
                       for i, (p, (o, e)) in enumerate(zip(procs, outs)))
    assert all(p.returncode == 0 for p in procs), report
    res = []
    for r in range(nprocs):
        with np.load(tmp_path / f"rank{r}.npz") as z:
            saved = dict(z)
        with open(tmp_path / f"rank{r}.json") as f:
            res.append((saved, json.load(f)))
    return res


COHORT2 = """
from repro_torch import compressors as C
from repro_torch.core import predictors as P, stream as ST, usecases as UC
from repro_torch.data import scientific as TS, source as SRC
from repro_torch.dist import sharding as S, sweep as DS

ROUTES = {"sort": P.PredictorConfig(),
          "kernel": P.PredictorConfig(use_kernels=True, qent_bins=4096)}
mesh = M.make_sweep_mesh()
assert mesh.shares == (1, 1) and mesh.ranks == (0, 1), mesh
s2 = TS.field_slices("miranda-vx", count=K2, n=N2, device="cpu")
vols = torch.stack([TS.volume("miranda-vx", VOL_SHAPE, seed=s, device="cpu")
                    for s in range(K_VOL)])
for route, cfg in ROUTES.items():
    for what, x, ebs in (("2d", s2, EBS2), ("vol", vols, EBS_VOL)):
        for k in sorted({x.shape[0], x.shape[0] - 1, 1}):
            lo, hi = DS.process_block(k, mesh)
            save(f"spmd_{what}_{route}_{k}", DS.features_sweep_sharded(
                x[:k], ebs, cfg, mesh=mesh, mode="both"))
            save(f"local_{what}_{route}_{k}", DS.features_sweep_sharded(
                x[lo:hi].numpy(), ebs, cfg, mesh=mesh, mode="both",
                process_local=True, global_k=k))
with S.use_mesh(mesh):
    save("auto", P.features_sweep(s2, EBS2))
padded = DS.features_sweep_sharded(s2, EBS2, mesh=mesh, gather=False)
save("padded_local", torch.cat(padded.blocks))
save("padded", DS.gather_rows(padded))
error("wrong_rows", lambda: DS.features_sweep_sharded(
    s2[:1], EBS2, mesh=mesh, process_local=True, global_k=K2))
error("no_global_k", lambda: DS.features_sweep_sharded(
    s2[:1], EBS2, mesh=mesh, process_local=True))

uneven = M.make_sweep_mesh(devices=["cpu"] * (2 if RANK == 0 else 1))
save("uneven_shares", uneven.shares)
for k in (K2 - 2, 2):
    lo, hi = DS.process_block(k, uneven)
    save(f"uneven_block_{k}", (lo, hi))
    save(f"uneven_spmd_{k}", DS.features_sweep_sharded(s2[:k], EBS2,
                                                       mesh=uneven))
    save(f"uneven_local_{k}", DS.features_sweep_sharded(
        s2[lo:hi], EBS2, mesh=uneven, process_local=True, global_k=k))
prefix = M.make_sweep_mesh(2, devices=["cpu"] * 2)
save("prefix_ranks", prefix.ranks)
if RANK == 0:
    save("prefix", DS.features_sweep_sharded(s2, EBS2, mesh=prefix))
else:
    error("not_in_prefix", lambda: DS.features_sweep_sharded(
        s2, EBS2, mesh=prefix))

for k, k_pad in ((2, 2), (1, 2), (3, 4), (1, 1)):
    out = DS.sweep_padded(s2[:k], EBS2, k_pad=k_pad, mesh=mesh)
    save(f"padded_sharded_{k}_{k_pad}", isinstance(out, DS.ShardedRows))
    save(f"padded_rows_{k}_{k_pad}",
         np.concatenate(DS.scatter_requests(out, [k])))

for name in ("sz3-lorenzo", "zfp"):
    save(f"crs_{name}", DS.training_crs(C.get(name), s2, EBS2, mesh=mesh))
gm = UC.EbGridModel.train(s2[:K2 - 1], "sz2", EBS2[:3], mesh=mesh)
save("train_pred", [gm.predict(s2[K2 - 1], e) for e in PRED_EBS])

src = SRC.MemmapSource(DATASET)
for name in src.variables():
    row = int(np.prod(src.meta(name).row_shape)) * 4
    for rows in (1, 3, 10):
        f, q = ST.stream_features(src, name, STREAM_EBS, mesh=mesh,
                                  device="cpu", quality=True,
                                  stream=ST.StreamConfig(budget_bytes=rows * row))
        save(f"stream_{name}_{rows}", np.concatenate([f, q], axis=-1))
error("digest", lambda: ST.stream_features(
    src, "miranda-vx", STREAM_EBS, mesh=mesh, device="cpu",
    digest=SRC.StreamingDigest()))
"""


@pytest.fixture(scope="module")
def cohort2(tmp_path_factory, stacks, dataset):
    x, ebs = stacks[3]
    v, ebs_v = stacks[4]
    tmp = tmp_path_factory.mktemp("cohort2")
    return run_ranks(tmp, COHORT2, 2, dict(
        K2=K2, N2=N2, VOL_SHAPE=VOL_SHAPE, K_VOL=K_VOL, EBS2=ebs,
        EBS_VOL=ebs_v, PRED_EBS=_pred_ebs(ebs), DATASET=dataset[0],
        STREAM_EBS=STREAM_EBS))


def _pred_ebs(ebs) -> list:
    return [ebs[0], (ebs[0] * ebs[1]) ** 0.5, ebs[2]]


def _both(stacks, rank, route, k):
    x, ebs = stacks[rank]
    return TP._sweep(x[:k], ebs, ROUTES[route], "both").numpy()


@pytest.mark.parametrize("route", ["sort", "kernel"])
@pytest.mark.parametrize("what,rank", [("2d", 3), ("vol", 4)])
@pytest.mark.parametrize("ingest", ["spmd", "local"])
def test_two_process_sweep_bitexact(cohort2, stacks, jax_both, ingest, what,
                                    rank, route):
    """Counterpart of tests/test_multihost.py::
    test_two_process_sweep_bitexact_2d / _volumes and
    test_process_local_ingestion: on both processes, SPMD and
    process-local ingestion of a divisible, a ragged and a one-row stack
    (a process with no row), features and quality, equal the port's
    single-device sweep bit for bit, and the reference's within 1e-5."""
    kmax = stacks[rank][0].shape[0]
    for k in sorted({kmax, kmax - 1, 1}):
        want = _both(stacks, rank, route, k)
        for saved, _ in cohort2:
            got = saved[f"{ingest}_{what}_{route}_{k}"]
            assert_bit_equal(got, want)
            assert_near_reference(got, jax_both[rank, route][:k], "both",
                                  route)


def test_process_local_rejects_wrong_rows(cohort2):
    """tests/test_multihost.py::test_process_local_ingestion's error half:
    a wrong row count names process_block; no global_k raises."""
    for rank, (_, errors) in enumerate(cohort2):
        assert "process_block" in errors["wrong_rows"], errors
        assert "global_k" in errors["no_global_k"], errors


def test_auto_route_across_processes(cohort2, stacks):
    """features_sweep under use_mesh of a spanning mesh takes the
    collective path and equals one device on every process."""
    x, ebs = stacks[3]
    want = TP.features_sweep(x, ebs, sharded=False)
    for saved, _ in cohort2:
        assert_bit_equal(saved["auto"], want)


def test_gather_false_across_processes(cohort2, stacks):
    """gather=False keeps each process's block (4 rows each for k = 7)
    with the pad row zeroed on the last process; gather_rows brings the
    padded 8 rows to both."""
    x, ebs = stacks[3]
    want = TP.features_sweep(x, ebs, sharded=False).numpy()
    (s0, _), (s1, _) = cohort2
    assert_bit_equal(s0["padded_local"], want[:4])
    assert_bit_equal(s1["padded_local"][:3], want[4:])
    assert not s1["padded_local"][3:].any()
    for saved in (s0, s1):
        assert_bit_equal(saved["padded"][:7], want)
        assert not saved["padded"][7:].any()


def test_uneven_device_shares_across_processes(cohort2, stacks):
    """Counterpart of tests/test_multihost.py::
    test_uneven_device_shares_across_processes: 2 shards on process 0
    and 1 on process 1 (extent 3); the blocks follow the shares (k = 2
    leaves process 1 no row) and both ingestion modes are bit-exact."""
    x, ebs = stacks[3]
    blocks = {K2 - 2: [(0, 4), (4, 5)], 2: [(0, 2), (2, 2)]}
    for rank, (saved, _) in enumerate(cohort2):
        assert tuple(saved["uneven_shares"]) == (2, 1)
        for k, want_blocks in blocks.items():
            assert tuple(saved[f"uneven_block_{k}"]) == want_blocks[rank]
            want = TP.features_sweep(x[:k], ebs, sharded=False)
            assert_bit_equal(saved[f"uneven_spmd_{k}"], want)
            assert_bit_equal(saved[f"uneven_local_{k}"], want)


def test_prefix_mesh_excludes_a_process(cohort2, stacks):
    """make_sweep_mesh(2) over two shards a process takes only process
    0's: it sweeps alone over its subgroup, and process 1, holding no
    shard, is refused instead of hanging."""
    x, ebs = stacks[3]
    (s0, _), (s1, e1) = cohort2
    for saved in (s0, s1):
        assert tuple(saved["prefix_ranks"]) == (0,)
    assert_bit_equal(s0["prefix"], TP.features_sweep(x, ebs, sharded=False))
    assert "no devices in the sweep mesh" in e1["not_in_prefix"]


def test_sweep_padded_across_processes(cohort2, stacks):
    """sweep_padded over the spanning mesh: buckets of 2 and 4 (multiples
    of the extent) launch sharded, a bucket of 1 (below it) runs the
    same local sweep on both processes; scatter_requests gives the real
    rows bit-equal to one device everywhere."""
    x, ebs = stacks[3]
    for saved, _ in cohort2:
        for k, k_pad in ((2, 2), (1, 2), (3, 4), (1, 1)):
            assert bool(saved[f"padded_sharded_{k}_{k_pad}"]) == (k_pad >= 2)
            assert_bit_equal(saved[f"padded_rows_{k}_{k_pad}"],
                             TP.features_sweep(x[:k], ebs, sharded=False))


@pytest.mark.parametrize("name", ["sz3-lorenzo", "zfp"])
def test_training_crs_reuses_mesh_processes(cohort2, stacks, name):
    """Counterpart of tests/test_multihost.py::
    test_training_crs_reuses_mesh_processes: each process compresses its
    block, and the gathered float64 table is the serial loop's bit for
    bit on both."""
    x, ebs = stacks[3]
    want = DS.training_crs(TC.get(name), x, ebs)
    for saved, _ in cohort2:
        np.testing.assert_array_equal(saved[f"crs_{name}"].view(np.int64),
                                      want.view(np.int64))


def test_ebgrid_train_across_processes(cohort2, stacks):
    """EbGridModel.train(mesh=) over two processes (sharded sweep, split
    compressor runs) predicts what the unsharded model predicts."""
    x, ebs = stacks[3]
    ref = TUC.EbGridModel.train(x[:K2 - 1], "sz2", ebs[:3])
    want = [ref.predict(x[K2 - 1], e) for e in _pred_ebs(ebs)]
    for saved, _ in cohort2:
        np.testing.assert_array_equal(saved["train_pred"], want)


@pytest.mark.parametrize("name", ["miranda-vx", "qmcpack-vol"])
def test_stream_two_process_cohort(cohort2, dataset, name):
    """Counterpart of tests/test_stream.py::test_stream_two_process_cohort:
    every process streams the same schedule, reading only its rows of
    each chunk (chunks of 1 row leave one process none; 3 rows are
    ragged; 10 covers the variable), and returns features and quality
    bit-equal to the in-memory sweep."""
    want = np.concatenate(dataset[1][name], axis=-1)
    for saved, _ in cohort2:
        for rows in (1, 3, 10):
            assert_bit_equal(saved[f"stream_{name}_{rows}"], want)


def test_stream_digest_refused_across_processes(cohort2):
    for _, errors in cohort2:
        assert "single-process" in errors["digest"], errors


COHORT3 = """
from repro_torch.core import predictors as P
from repro_torch.data import scientific as TS
from repro_torch.dist import sweep as DS

mesh = M.make_sweep_mesh()
assert mesh.size == 3, mesh
s2 = TS.field_slices("miranda-vx", count=K2, n=N2, device="cpu")
kcfg = P.PredictorConfig(use_kernels=True, qent_bins=4096)
for k in (2, 3, K2):
    lo, hi = DS.process_block(k, mesh)
    save(f"block_{k}", (lo, hi))
    for route, cfg in (("sort", P.PredictorConfig()), ("kernel", kcfg)):
        save(f"spmd_{route}_{k}", DS.features_sweep_sharded(
            s2[:k], EBS2, cfg, mesh=mesh, mode="both"))
        save(f"local_{route}_{k}", DS.features_sweep_sharded(
            s2[lo:hi], EBS2, cfg, mesh=mesh, mode="both", process_local=True,
            global_k=k))
"""


@pytest.fixture(scope="module")
def cohort3(tmp_path_factory, stacks):
    x, ebs = stacks[3]
    return run_ranks(tmp_path_factory.mktemp("cohort3"), COHORT3, 3,
                     dict(K2=K2, N2=N2, EBS2=ebs))


@pytest.mark.parametrize("k", [2, 3, K2])
def test_three_process_sweep(cohort3, stacks, jax_both, k):
    """Three processes, k below (process 2 gets no row), at and above the
    extent: the blocks are the reference's, and SPMD and process-local
    sweeps on both q-ent routes equal one device bit for bit on every
    process (and the reference within 1e-5)."""
    blocks = {2: [(0, 1), (1, 2), (2, 2)], 3: [(0, 1), (1, 2), (2, 3)],
              K2: [(0, 3), (3, 6), (6, 7)]}
    for rank, (saved, _) in enumerate(cohort3):
        assert tuple(saved[f"block_{k}"]) == blocks[k][rank]
        for route in ROUTES:
            want = _both(stacks, 3, route, k)
            for ingest in ("spmd", "local"):
                got = saved[f"{ingest}_{route}_{k}"]
                assert_bit_equal(got, want)
                assert_near_reference(got, jax_both[3, route][:k], "both",
                                      route)


# ---------------------------------------------------------------------------
# advise --mesh, and advise over a process group
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def advise_runs(tmp_path_factory, dataset):
    """The advise CLI on the dataset: directly, with ``--mesh cpu,cpu``
    (two shards on the CPU in one process), and over 2 gloo processes (each
    under RANK_TIMEOUT_S); the report files' bytes."""
    tmp = tmp_path_factory.mktemp("advise")
    argv = [dataset[0], "--compressors", "sz2,zfp", "--targets", "4,8",
            "--train-rows", "4", "--psnr-floor", "30", "--budget-mb",
            "0.02", "--device", CPU]
    reports = {}
    for form, extra in (("direct", []), ("mesh2", ["--mesh", "cpu,cpu"])):
        out = tmp / f"{form}.json"
        TADV.main(argv + extra + ["--out", str(out)])
        reports[form] = out.read_bytes()
    out = tmp / "ranks.json"
    env = _rank_env()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.advise", *argv,
         "--coordinator", f"file://{tmp / 'init'}", "--num-processes", "2",
         "--process-id", str(r), "--backend", "gloo", "--out", str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    assert outs[1][0] == "", "only process 0 prints the report"
    reports["two processes"] = out.read_bytes()
    return reports


def test_advise_mesh_spec():
    """--mesh: 'none' is no mesh, N the first N devices of the process
    (more than it has raises, as make_sweep_mesh does), a comma list
    those devices (two shards on one device)."""
    assert M.mesh_from_spec("none", CPU) is None
    assert M.mesh_from_spec("auto", CPU).size == 1
    assert M.mesh_from_spec("1", CPU).size == 1
    with pytest.raises(ValueError, match="exceeds"):
        M.mesh_from_spec("2", CPU)
    mesh = M.mesh_from_spec("cpu,cpu", CPU)
    assert mesh.size == 2 and mesh.devices == (torch.device(CPU),) * 2


@pytest.mark.parametrize("form", ["mesh2", "two processes"])
def test_advise_mesh_matches_direct_report(advise_runs, form):
    """advise --mesh cpu,cpu in one process, and advise over two gloo
    processes
    (--coordinator, one shard each, training split between them), write
    the direct single-device report byte for byte (digests included:
    process 0 reads the variable once more for them)."""
    assert advise_runs[form] == advise_runs["direct"]
    report = json.loads(advise_runs[form])
    assert all(v["digest"] for v in report["variables"].values())
