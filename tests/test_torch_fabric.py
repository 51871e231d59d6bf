"""The sweep service on a mesh and across processes, on the CPU.

* **One process, a mesh of 2 and of 3 CPU shards**: every registered
  method's served result is bit-equal to the port's direct call and to
  the meshless service, and held against the reference's single-device
  service (its models carried across by ``convert``) at the tolerances
  of ``tests/test_torch_serve.py``.
* **Leader/follower cohorts** of fresh interpreters in a gloo group
  (``file://`` init under the test's tmp dir, one thread each, a
  wall-clock limit per cohort), their results compared here with direct
  calls made on one thread: the counterparts of the reference's
  ``tests/test_multihost.py::test_leader_follower_sweep_service`` and
  ``tests/test_methods.py::test_kv_gate_across_processes``, three
  processes with uneven shares, an idle spell longer than the group's
  timeout, a follower that exits mid-traffic (the fabric recovers onto
  the survivors; ``tests/test_torch_fault.py`` has the other faults) and
  a leader whose store goes with it (the follower's ``leader_lost``).
* The single-process ``FabricError`` case of the reference's
  ``tests/test_fault.py``.
"""
import os
import pickle
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.dist.fault import FabricError  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.serve.sweep_service import (ServiceConfig,  # noqa: E402
                                             SweepService)

from test_torch_serve import (all_methods, assert_all_methods,  # noqa: E402
                              check_parity_with_reference, parity, setup,
                              submit_all)

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
TESTS = os.path.dirname(os.path.abspath(__file__))
GROUP_TIMEOUT_S = 60.0       # a cohort's process group (and collectives)
WALL_S = 120.0               # a cohort's wall-clock limit

__all__ = ["parity", "setup"]          # module fixtures shared with serve


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Compared results are made on one thread (the CPU ``eigvalsh``'s
    last bits follow the thread count), as each rank runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def methods(setup):
    return all_methods(setup)


# ---------------------------------------------------------------------------
# One process: a mesh of CPU shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [2, 3])
def test_mesh_service_bit_equal_to_direct_and_meshless(methods, shards):
    req, want = methods
    mesh = M.make_sweep_mesh(devices=["cpu"] * shards)
    scfg = ServiceConfig(max_wait_ms=300.0, cache_admit_after=1,
                         cache_bytes=1 << 20)
    with SweepService(scfg, device="cpu") as plain:
        meshless = [f.result(timeout=120) for f in submit_all(plain, req)]
    with SweepService(scfg, mesh=mesh) as svc:
        assert svc.device == torch.device("cpu") and svc.mesh is mesh
        got = [f.result(timeout=120) for f in submit_all(svc, req)]
        st = svc.stats()
    assert_all_methods(got, want)
    assert_all_methods(meshless, want)
    assert st["launches"] == 4 and st["mesh"] is not None
    # every bucket was rounded up to a multiple of the extent
    assert all(sig[1] % shards == 0 for sig in svc._executables)


def test_mesh_captured_from_use_mesh(methods):
    from repro_torch.dist import sharding as S
    req, want = methods
    mesh = M.make_sweep_mesh(devices=["cpu"] * 2)
    with S.use_mesh(mesh):
        svc = SweepService(ServiceConfig(max_wait_ms=50.0))
    with svc:
        assert svc.mesh is mesh
        got = svc.featurize(req["x"], req["ebs"])
    assert np.array_equal(got, want[0])


@pytest.mark.parametrize("shards", [2, 3])
def test_mesh_service_against_reference(parity, shards):
    mesh = M.make_sweep_mesh(devices=["cpu"] * shards)
    with SweepService(ServiceConfig(max_wait_ms=5.0), mesh=mesh) as tsvc:
        check_parity_with_reference(parity, tsvc)


def _tiny(k, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (k, 16, 16)).astype(np.float32)


def test_fabric_error_fails_everything_and_close_is_idempotent():
    """tests/test_fault.py::
    test_fabric_error_fails_everything_and_close_is_idempotent"""
    eps = np.asarray([1e-2], np.float32)
    svc = SweepService(ServiceConfig(max_wait_ms=1.0), device="cpu")
    release = threading.Event()

    def poisoned(*a, **kw):
        release.wait(30)
        raise FabricError("injected fabric fault", kind="failed")

    svc._collective_sweep = poisoned
    f1 = svc.submit_featurize(_tiny(2), eps)
    time.sleep(0.2)                    # the worker is blocked in poisoned()
    f2 = svc.submit_featurize(_tiny(1), eps)
    release.set()
    for fut in (f1, f2):
        with pytest.raises(FabricError, match="injected fabric fault"):
            fut.result(30)
    with pytest.raises(FabricError):
        svc.serve()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit_featurize(_tiny(1), eps)
    assert svc._fabric_error is not None
    assert svc.stats()["methods"]["featurize"]["failed"] == 2
    svc.close()
    svc.close()


def test_spanning_mesh_needs_dist_init_store(monkeypatch):
    from repro_torch.dist.sweep import SweepMesh
    monkeypatch.setattr(M, "_STORE", None)
    mesh = SweepMesh((torch.device("cpu"),), (1, 1), (0, 1), object())
    with pytest.raises(ValueError, match="dist_init"):
        SweepService(mesh=mesh)


# ---------------------------------------------------------------------------
# Cohorts of processes (gloo on the CPU)
# ---------------------------------------------------------------------------

PRELUDE = """
import os, pickle, sys, threading, time
import numpy as np, torch
from repro_torch.core import predictors as P
from repro_torch.dist.fault import FabricError
from repro_torch.launch import mesh as M
from repro_torch.serve.sweep_service import ServiceConfig, SweepService
from test_torch_serve import submit_all
INIT, NPROCS, RANK, OUT = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                           sys.argv[4])
M.dist_init(INIT, num_processes=NPROCS, process_id=RANK, backend="gloo",
            device="cpu", init_timeout_s={timeout})
RESULTS = {{}}
with open(os.path.join(OUT, "req.pkl"), "rb") as f:
    REQ = pickle.load(f)


def caught(fn):
    try:
        fn()
    except Exception as e:
        return (type(e).__name__, str(e))
    return None
"""

EPILOGUE = """
with open(os.path.join(OUT, f"rank{RANK}.pkl"), "wb") as f:
    pickle.dump(RESULTS, f)
if FAULTED:
    sys.stdout.flush()
    os._exit(0)
torch.distributed.destroy_process_group()
"""


def run_cohort(tmp_path, body: str, nprocs: int, req: dict,
               consts: dict = None, wall_s: float = WALL_S,
               init: str = None, faulted: bool = False) -> list:
    """Run ``body`` in ``nprocs`` fresh interpreters of one gloo group
    (``RANK``, ``NPROCS``, ``REQ``, ``RESULTS`` and ``consts`` in scope;
    the group's store at ``init``, default a ``FileStore`` under
    ``tmp_path``) under a wall-clock limit; returns each rank's (return
    code, output, RESULTS or None).  With ``faulted`` the ranks end with
    ``os._exit(0)`` instead of tearing down a group that lost a peer."""
    with open(tmp_path / "req.pkl", "wb") as f:
        pickle.dump(req, f)
    consts = dict(consts or {}, FAULTED=faulted)
    header = "".join(f"{k} = {v!r}\n" for k, v in consts.items())
    script = tmp_path / "rank.py"
    script.write_text(PRELUDE.format(timeout=GROUP_TIMEOUT_S) + header
                      + textwrap.dedent(body) + EPILOGUE)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [SRC, TESTS, os.environ.get("PYTHONPATH", "")]))
    init = init or f"file://{tmp_path / 'init'}"
    procs = [subprocess.Popen(
        [sys.executable, str(script), init, str(nprocs), str(r),
         str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(nprocs)]
    deadline = time.monotonic() + wall_s
    try:
        outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
                for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        outs = [p.communicate()[0] for p in procs]
        raise AssertionError("cohort hung past its wall-clock limit:\n" +
                             "\n".join(f"--- rank {i} ---\n{o}"
                                       for i, o in enumerate(outs)))
    res = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        path = tmp_path / f"rank{r}.pkl"
        saved = None
        if path.exists():
            with open(path, "rb") as f:
                saved = pickle.load(f)
        res.append((p.returncode, out, saved))
    return res


def _report(res) -> str:
    return "\n".join(f"--- rank {r} (rc={rc}) ---\n{out}"
                     for r, (rc, out, _) in enumerate(res))


SERVE_ALL = """
mesh = M.make_sweep_mesh(devices=["cpu"] * SHARES[RANK])
# the reference's kv-gate case: a mixed kv_gate + featurize batch is one
# launch per launcher, on the leader and on the follower
svc = SweepService(ServiceConfig(max_wait_ms=200.0), mesh=mesh)
if svc.role == "leader":
    f1 = svc.submit_kv_gate(REQ["leaves"])
    f2 = svc.submit_featurize(REQ["x"][:3], [REQ["ebs"][0]])
    RESULTS["kv"] = (f1.result(timeout=60), f2.result(timeout=60))
    RESULTS["kv_launches"] = svc.stats()["launches"]
    svc.close()
else:
    svc.serve()
    RESULTS["kv_launches"] = svc.launches
# every method in one batch, twice (the second pass from the cache)
svc = SweepService(ServiceConfig(max_wait_ms=300.0, cache_admit_after=1,
                                 cache_bytes=1 << 20), mesh=mesh)
RESULTS["role"] = svc.role
if svc.role == "leader":
    svc.warmup([(16, 16)], grid_sizes=(1,), row_buckets=(1, 2))
    RESULTS["got"] = [f.result(timeout=60) for f in submit_all(svc, REQ)]
    launched = svc.launches
    RESULTS["again"] = [f.result(timeout=60) for f in submit_all(svc, REQ)]
    RESULTS["launches"] = (launched, svc.launches)
    RESULTS["foreign_cfg"] = caught(lambda: svc.submit_featurize(
        REQ["x"][:2], REQ["ebs"], P.PredictorConfig(qent_bins=128)))
    RESULTS["stats"] = svc.stats()
    svc.close()
    svc.close()
else:
    RESULTS["submit"] = caught(lambda: svc.submit_featurize(
        REQ["x"][:2], REQ["ebs"]))
    RESULTS["warmup"] = caught(lambda: svc.warmup())
    svc.serve()
    svc.close()
    RESULTS["launches"] = svc.launches
"""


@pytest.mark.parametrize("shares", [(1, 1), (2, 1, 3)],
                         ids=["two-processes", "three-uneven"])
def test_leader_follower_cohort(tmp_path, methods, shares):
    """tests/test_multihost.py::test_leader_follower_sweep_service and
    tests/test_methods.py::test_kv_gate_across_processes: every method
    served over the fabric bit-equal to the direct call; followers refuse
    submissions, the leader refuses a foreign config, and ``close()``
    releases every follower."""
    req, want = methods
    res = run_cohort(tmp_path, SERVE_ALL, len(shares), req,
                     {"SHARES": list(shares)})
    assert all(rc == 0 for rc, _, _ in res), _report(res)
    lead = res[0][2]
    assert lead["role"] == "leader"
    assert_all_methods(lead["got"], want)
    assert_all_methods(lead["again"], want)
    assert lead["launches"] == (4, 4), lead["launches"]
    assert lead["foreign_cfg"][0] == "ValueError"
    assert "multi-process" in lead["foreign_cfg"][1]
    assert lead["stats"]["procs"] == list(range(len(shares)))
    assert lead["stats"]["transport"] == "gloo"
    kv, feats = lead["kv"]
    assert np.array_equal(kv, want[-1])
    assert np.array_equal(feats, want[0][:3, :1])
    for _, _, saved in res[1:]:
        assert saved["role"] == "follower"
        assert saved["submit"][0] == "RuntimeError"
        assert "follower" in saved["submit"][1]
        assert saved["warmup"][0] == "RuntimeError"
        assert saved["launches"] == 4
    assert [s["kv_launches"] for _, _, s in res] == [2] * len(shares)


IDLE = """
import dataclasses, datetime
mesh = M.make_sweep_mesh(devices=["cpu"])
group = torch.distributed.new_group(
    list(range(NPROCS)), timeout=datetime.timedelta(seconds=SHORT_S))
mesh = dataclasses.replace(mesh, group=group)
svc = SweepService(ServiceConfig(max_wait_ms=5.0), mesh=mesh)
if svc.role == "leader":
    RESULTS["first"] = svc.featurize(REQ["x"][:2], REQ["ebs"])
    time.sleep(IDLE_S)
    RESULTS["after"] = svc.featurize(REQ["x"][2:4], REQ["ebs"])
    svc.close()
else:
    svc.serve()
    RESULTS["launches"] = svc.launches
"""


def test_idle_spell_longer_than_the_group_timeout(tmp_path, methods):
    """The group's collectives time out after 4 s; the leader idles 6 s
    between two launches, and the second still succeeds: followers wait
    in the store, not in a collective."""
    req, want = methods
    res = run_cohort(tmp_path, IDLE, 2, req, {"SHORT_S": 4.0, "IDLE_S": 6.0})
    assert all(rc == 0 for rc, _, _ in res), _report(res)
    lead = res[0][2]
    assert np.array_equal(lead["first"], want[0][:2])
    assert np.array_equal(lead["after"], want[0][2:4])
    assert res[1][2]["launches"] == 2


LOSS = """
import dataclasses, datetime
mesh = M.make_sweep_mesh(devices=["cpu"])
group = torch.distributed.new_group(
    list(range(NPROCS)), timeout=datetime.timedelta(seconds=SHORT_S))
mesh = dataclasses.replace(mesh, group=group)
svc = SweepService(ServiceConfig(max_wait_ms=5.0, heartbeat_s=0.5,
                                 launch_timeout_s=SHORT_S - 1.0), mesh=mesh)
if svc.role == "leader":
    RESULTS["first"] = svc.featurize(REQ["x"][:2], REQ["ebs"])
    gone = os.path.join(OUT, "gone")
    deadline = time.monotonic() + 60
    while not os.path.exists(gone) and time.monotonic() < deadline:
        time.sleep(0.01)                      # rank 2 exits meanwhile
    time.sleep(0.5)
    t0 = time.monotonic()
    futs = [svc.submit_featurize(REQ["x"][i:i + 1], REQ["ebs"])
            for i in range(3)]
    RESULTS["got"] = [f.result(timeout=120) for f in futs]
    RESULTS["recover_s"] = time.monotonic() - t0
    RESULTS["later"] = svc.featurize(REQ["x"][3:5], REQ["ebs"])
    RESULTS["stats"] = svc.stats()
    svc.close()
    svc.close()
elif RANK == NPROCS - 1:
    def leave():
        while svc.launches < 1:
            time.sleep(0.01)
        open(os.path.join(OUT, "gone"), "w").close()
        os._exit(3)
    threading.Thread(target=leave, daemon=True).start()
    svc.serve()
else:
    RESULTS["serve"] = caught(svc.serve)
    svc.close()
    RESULTS["launches"] = svc.launches
"""


def test_lost_follower_fails_pending_futures(tmp_path, methods):
    """A follower exits mid-traffic.  The pending futures no longer fail:
    the leader recovers onto the two survivors within the group's
    timeout and a few seconds, every future and a later request complete
    bit-equal to the direct call through the store, the other follower's
    ``serve()`` returns cleanly, and no process hangs."""
    req, want = methods
    short = 5.0
    res = run_cohort(tmp_path, LOSS, 3, req, {"SHORT_S": short},
                     faulted=True)
    (rc0, _, lead), (rc1, _, mid), (rc2, _, _) = res
    assert (rc0, rc1, rc2) == (0, 0, 3), _report(res)
    assert np.array_equal(lead["first"], want[0][:2])
    for i, got in enumerate(lead["got"]):
        assert np.array_equal(got, want[0][i:i + 1]), i
    assert np.array_equal(lead["later"], want[0][3:5])
    assert lead["recover_s"] < short + 5.0, lead["recover_s"]
    st = lead["stats"]
    assert (st["recoveries"], st["procs"], st["transport"]) == \
        (1, [0, 1], "kv"), st
    assert mid["serve"] is None and mid["launches"] == 3, mid


LEADER_GONE = """
mesh = M.make_sweep_mesh(devices=["cpu"])
svc = SweepService(ServiceConfig(max_wait_ms=5.0, heartbeat_s=0.5),
                   mesh=mesh)
if svc.role == "leader":
    RESULTS["first"] = svc.featurize(REQ["x"][:2], REQ["ebs"])
    with open(os.path.join(OUT, f"rank{RANK}.pkl"), "wb") as f:
        pickle.dump(RESULTS, f)
    os._exit(3)                     # the store it serves goes with it
t0 = time.monotonic()
RESULTS["serve"] = caught(svc.serve)
RESULTS["kind"] = svc._fabric_error.kind
RESULTS["serve_s"] = time.monotonic() - t0
RESULTS["launches"] = svc.launches
"""


def test_leader_store_lost_raises_on_follower(tmp_path, methods):
    """The leader serves the group's ``TCPStore`` itself (``tcp://``
    without an external coordinator) and exits: its follower cannot go
    on, and its ``serve()`` raises ``FabricError(kind="leader_lost")``
    promptly, from the store's error, instead of hanging."""
    import socket
    req, want = methods
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    res = run_cohort(tmp_path, LEADER_GONE, 2, req,
                     init=f"tcp://127.0.0.1:{port}", faulted=True)
    (rc0, _, lead), (rc1, _, follower) = res
    assert (rc0, rc1) == (3, 0), _report(res)
    assert np.array_equal(lead["first"], want[0][:2])
    assert follower["serve"][0] == "FabricError", follower
    assert follower["kind"] == "leader_lost", follower
    assert follower["serve_s"] < 10.0 and follower["launches"] == 1


# ---------------------------------------------------------------------------
# The CLIs across processes
# ---------------------------------------------------------------------------

def _launch_ranks(argvs, wall_s: float = WALL_S) -> list:
    """Run one command per rank (fresh interpreters, one thread each)
    under a wall-clock limit; returns (return code, stdout, stderr)."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([SRC,
                                           os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-m", *argv], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for argv in argvs]
    deadline = time.monotonic() + wall_s
    try:
        outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        outs = [p.communicate() for p in procs]
        raise AssertionError(f"ranks hung: {outs}")
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


def _rank_args(tmp_path, rank: int, nprocs: int = 2) -> list:
    return ["--coordinator", f"file://{tmp_path / 'init'}", "--num-processes",
            str(nprocs), "--process-id", str(rank), "--backend", "gloo"]


SERVE_ARGS = ["repro_torch.launch.sweep_serve", "--device", "cpu",
              "--fields", "scale-u", "--n", "32", "--compressor",
              "bitgrooming", "--train-slices", "6", "--hot-slices", "2",
              "--clients", "2", "--requests", "8", "--verify"]


def test_sweep_serve_cli_across_processes(tmp_path):
    """``sweep_serve --mesh auto --coordinator ...`` in two processes: the
    leader serves every request over the fabric and the follower joins
    its launches until the leader closes."""
    out = tmp_path / "serve.json"
    res = _launch_ranks([SERVE_ARGS + ["--mesh", "auto", "--out", str(out)]
                         + _rank_args(tmp_path, r) for r in range(2)])
    assert all(rc == 0 for rc, _, _ in res), res
    import json
    report = json.loads(out.read_text())
    assert report["requests"] == 8 and report["procs"] == [0, 1]
    assert report["verify"]["mismatches"] == 0
    assert report["verify"]["checked"] >= 1
    assert report["stats"]["transport"] == "gloo"
    launches = report["stats"]["launches"]
    assert launches >= 1
    assert f"({launches} launches joined)" in res[1][1]


def test_sweep_serve_coordinator_needs_a_spanning_mesh(tmp_path):
    res = _launch_ranks([SERVE_ARGS + _rank_args(tmp_path, r)
                         for r in range(2)])
    for rc, _, err in res:
        assert rc != 0 and "spans the processes" in err


def test_advise_service_on_a_mesh_and_across_processes(tmp_path):
    """``advise --service`` with ``--mesh cpu,cpu`` in one process and
    over two gloo processes writes the direct report byte for byte."""
    from repro_torch.launch import advise as TADV
    from test_torch_dist import _write_dataset
    data = _write_dataset(tmp_path / "ds")
    argv = [data, "--compressors", "sz2,zfp", "--targets", "4,8",
            "--train-rows", "4", "--psnr-floor", "30", "--budget-mb",
            "0.02", "--device", "cpu"]
    reports = {}
    for form, extra in (("direct", []),
                        ("mesh2", ["--service", "--mesh", "cpu,cpu"])):
        out = tmp_path / f"{form}.json"
        TADV.main(argv + extra + ["--out", str(out)])
        reports[form] = out.read_bytes()
    out = tmp_path / "ranks.json"
    res = _launch_ranks([["repro_torch.launch.advise", *argv, "--service",
                          "--out", str(out)] + _rank_args(tmp_path, r)
                         for r in range(2)])
    assert all(rc == 0 for rc, _, _ in res), res
    assert res[1][1] == "", "only the leader prints the report"
    assert reports["mesh2"] == reports["direct"]
    assert out.read_bytes() == reports["direct"]
