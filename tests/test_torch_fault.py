"""The fabric's fault tolerance (``repro_torch.dist.fault`` and the
service's recovery), on the CPU: the counterparts of the reference's
``tests/test_fault.py``.

* **Units**: ``FabricError`` and ``faultinject.parse`` against the
  reference's; the store helpers (no value above 1 MiB, a 20 MiB payload
  round trip on a ``FileStore`` and a ``TCPStore``); a heartbeat that a
  blocking call on another client does not stall; staleness; the subset
  barrier; the survivors' submesh.
* **Chaos cohorts**: fresh interpreters in a gloo group (one thread
  each, a wall-clock limit per cohort), broken on purpose by
  ``REPRO_FAULT_INJECT`` -- a follower killed inside a launch, during
  warmup, a second one on the store transport, the leader killed under an
  external coordinator, a follower that hangs, and ``sweep_serve
  --chaos`` under ``--coordinator-only``.  Every result the leader
  serves, before and after a recovery, is held bit for bit to the port's
  direct call made here on one thread, and within 1e-5 to the
  reference's ``features_sweep``.  Ranks end with ``os._exit(0)``: a
  cohort with a killed peer must not wait for it at exit.
"""
import datetime
import json
import os
import pickle
import signal
import socket
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import predictors as TP  # noqa: E402
from repro_torch.dist import fault as F  # noqa: E402
from repro_torch.dist import faultinject as FI  # noqa: E402
from repro_torch.dist.sweep import SweepMesh  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
GROUP_TIMEOUT_S = 60.0       # a cohort's process group (and collectives)
LAUNCH_TIMEOUT_S = 45.0      # the leader's launch deadline in the cohorts
WALL_S = 120.0               # a cohort's wall-clock limit
EPS = np.asarray([1e-3, 1e-2, 1e-1], np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Compared results are made on one thread (the CPU ``eigvalsh``'s
    last bits follow the thread count), as each rank runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _stack(seed=0):
    return np.random.default_rng(seed).standard_normal(
        (4, 32, 32)).astype(np.float32)


def _direct(x) -> np.ndarray:
    return TP.features_sweep(torch.from_numpy(x), EPS).numpy()


def assert_served(got, x):
    """Bit-equal to the port's direct call, within 1e-5 of the
    reference's single-device sweep."""
    from repro.core import predictors as JP
    want = _direct(x)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_allclose(
        got, np.asarray(JP.features_sweep(x, EPS, sharded=False)),
        rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# Units
# ---------------------------------------------------------------------------

def test_fabric_error_matches_reference():
    """tests/test_fault.py::test_fabric_error_carries_typed_fields, and
    the same fields and message as the reference's for the same
    arguments."""
    from repro.dist import fault as JF
    for args, kw in ((("boom",), dict(kind="follower_lost", lost=(2, 1),
                                      retriable=True)),
                     (("gone",), dict(kind="leader_lost")),
                     (("x",), dict(kind="evicted", lost=(3,))),
                     (("y",), {})):
        got, want = F.FabricError(*args, **kw), JF.FabricError(*args, **kw)
        assert (got.kind, got.lost, got.retriable, str(got)) == \
            (want.kind, want.lost, want.retriable, str(want))
        assert isinstance(got, RuntimeError)
    e = F.FabricError("boom", kind="follower_lost", lost=(2, 1),
                      retriable=True)
    assert "lost processes=[2, 1]" in str(e) and "retriable" in str(e)
    assert "restart" in str(F.FabricError("gone", kind="leader_lost"))


def test_faultinject_parse_matches_reference():
    """tests/test_fault.py::test_faultinject_parse, against the
    reference's ``parse`` on its specs and bad specs."""
    from repro.dist import faultinject as JFI
    for spec in ("a:kill:1,b:hang:2,c:slow:3:0.25", "a:kill:1,a:exit:4",
                 "", " leader_launch:kill:2 , bcast:slow:1:0.5"):
        assert FI.parse(spec) == JFI.parse(spec), spec
    spec = FI.parse("a:kill:1,b:hang:2,c:slow:3:0.25")
    assert spec["b"] == [("hang", 2, 3600.0)]
    for bad in ("a:frob:1", "a:kill", "a:kill:0", "a:kill:x", "a:slow:1:zz"):
        for parse in (FI.parse, JFI.parse):
            with pytest.raises(ValueError):
                parse(bad)


def test_faultinject_fire_counts_and_disarm():
    """tests/test_fault.py::test_faultinject_fire_counts_and_disarm"""
    FI.configure("s:slow:2:0.2")
    try:
        t0 = time.perf_counter()
        FI.fire("s")
        assert time.perf_counter() - t0 < 0.1
        t0 = time.perf_counter()
        FI.fire("s")
        assert time.perf_counter() - t0 >= 0.2
        FI.fire("other")
        assert FI.counts() == {"s": 2}
    finally:
        FI.configure(None)
    FI.fire("s")
    assert FI.counts() == {}


class _Spy:
    """A store that records the size of every value set through it."""

    def __init__(self, store):
        self.store, self.sizes = store, []

    def set(self, key, value):
        self.sizes.append(len(value))
        return self.store.set(key, value)

    def __getattr__(self, name):
        return getattr(self.store, name)


def _tcp_store(world=None):
    import torch.distributed as dist
    server = dist.TCPStore("127.0.0.1", 0, world, True,
                           wait_for_workers=False)
    return server, dist.TCPStore("127.0.0.1", server.port, world, False)


@pytest.mark.parametrize("kind", ["file", "tcp"])
def test_kv_bytes_roundtrip_in_chunks(tmp_path, kind):
    """A 20 MiB payload goes through the store with no value above
    ``KV_CHUNK`` (1 MiB; a ``TCPStore`` value above 8 MiB breaks the
    connection), reads back byte for byte, and is gone after
    ``kv_delete_bytes``; missing keys read as None without waiting."""
    import torch.distributed as dist
    if kind == "file":
        store = dist.FileStore(str(tmp_path / "store"), 1)
    else:
        server, store = _tcp_store()
    spy = _Spy(store)
    data = np.random.default_rng(1).bytes(20 << 20)
    F.kv_put_bytes(spy, "p/x", data)
    assert max(spy.sizes) <= F.KV_CHUNK and len(spy.sizes) == 21
    assert F.kv_get_bytes(store, "p/x", 1000) == data
    assert F.kv_set(spy, "p/small", "v") and F.kv_get(store, "p/small", 0) \
        == "v"
    with pytest.raises(ValueError, match="kv_put_bytes"):
        F.kv_set(store, "p/big", b"x" * (F.KV_CHUNK + 1))
    F.kv_delete_bytes(store, "p/x")
    F.kv_delete(store, "p/small")
    assert not store.check(["p/x/n"]) and not store.check(["p/x/0"])
    t0 = time.monotonic()
    assert F.kv_get(store, "p/small", 50) is None
    assert F.kv_get_bytes(store, "p/x", 50) is None
    assert time.monotonic() - t0 < 2.0


def test_heartbeat_not_stalled_by_a_blocking_call():
    """The heartbeat publishes on a client of its own: a thread parked in
    a blocking ``wait`` on the main client does not delay it (on one
    shared client it would stand still for the whole wait)."""
    server, store = _tcp_store()
    hb = F.Heartbeat(store, "hbt", 7, interval_s=0.05).start()
    try:
        assert F.kv_get(store, "hbt/hb/7", 2000) is not None
        parked = []

        def park():             # a blocking wait on the main client
            try:
                store.wait(["never"], datetime.timedelta(seconds=1.5))
            except Exception as exc:
                parked.append(exc)

        blocked = threading.Thread(target=park)
        blocked.start()
        time.sleep(0.1)
        reader = store.clone()
        first = int(reader.get("hbt/hb/7"))
        time.sleep(0.8)
        assert blocked.is_alive()            # the main client is still parked
        assert int(reader.get("hbt/hb/7")) >= first + 8
        blocked.join()
        assert parked                        # the wait timed out
    finally:
        hb.stop()


def test_peer_monitor_marks_a_stopped_publisher_stale(tmp_path):
    import torch.distributed as dist
    store = dist.FileStore(str(tmp_path / "store"), 1)
    live = F.Heartbeat(store, "pm", 1, interval_s=0.05).start()
    gone = F.Heartbeat(store, "pm", 2, interval_s=0.05).start()
    mon = F.PeerMonitor(store, "pm")
    mon.track([1, 2, 3])
    try:
        time.sleep(0.3)
        mon.poll()
        assert mon.seen(1) and mon.seen(2) and not mon.seen(3)
        gone.stop()
        time.sleep(0.2)
        # 2 stopped, 3 never beat; 1 keeps beating
        assert sorted(mon.observe_stale([1, 2, 3], 0.5)) == [2, 3]
    finally:
        live.stop()
        gone.stop()


def test_fabric_barrier_among_a_subset(tmp_path):
    """Ranks 0 and 2 meet without rank 1; a member that never comes
    times the others out (False, no raise); arriving twice counts once."""
    import torch.distributed as dist
    store = dist.FileStore(str(tmp_path / "store"), 1)
    got = {}

    def member(r, ranks, name, timeout):
        got[(name, r)] = F.fabric_barrier(store.clone(), name, timeout,
                                          ranks, rank=r)

    threads = [threading.Thread(target=member, args=(r, [0, 2], "b1", 5.0))
               for r in (0, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert got[("b1", 0)] and got[("b1", 2)]
    t0 = time.monotonic()
    assert not F.fabric_barrier(store, "b2", 0.3, [0, 1], rank=0)
    assert not F.fabric_barrier(store, "b2", 0.3, [0, 1], rank=0)
    assert time.monotonic() - t0 < 3.0
    assert F.fabric_barrier(store, "b2", 1.0, [0, 1], rank=1)


def test_surviving_submesh_keeps_blocks_contiguous():
    """tests/test_fault.py::test_surviving_submesh_rejects_nd_and_empty
    and ::test_surviving_submesh_keeps_process_blocks_contiguous: the
    alive ranks' shares in the original order; an empty set raises."""
    cpu = torch.device("cpu")
    mesh = SweepMesh((cpu, cpu), (2, 1, 3), (0, 1, 2), object())
    for alive, ranks, shares in (([0, 2], (0, 2), (2, 3)),
                                 ([2, 0], (0, 2), (2, 3)),
                                 ([1], (1,), (1,)),
                                 ([0, 1, 2], (0, 1, 2), (2, 1, 3))):
        sub = F.surviving_submesh(mesh, alive)
        assert (sub.ranks, sub.shares) == (ranks, shares), alive
        assert sub.group is None and sub.devices == mesh.devices
        assert sub.size == sum(shares)
    with pytest.raises(ValueError, match="no devices left"):
        F.surviving_submesh(mesh, [99])


def test_service_reports_the_fault_fields():
    """A single-process service reports the reference's fault fields."""
    from repro_torch.serve.sweep_service import ServiceConfig, SweepService
    with SweepService(ServiceConfig(max_wait_ms=1.0), device="cpu") as svc:
        got = svc.featurize(_stack()[:1], EPS)
        st = svc.stats()
    np.testing.assert_array_equal(got, _direct(_stack()[:1]))
    assert (st["epoch"], st["transport"], st["recoveries"], st["procs"],
            st["last_recovery_s"]) == (0, "local", 0, [0], 0.0)
    assert ServiceConfig().launch_timeout_s == 60.0
    assert ServiceConfig().heartbeat_s == 0.5


# ---------------------------------------------------------------------------
# Chaos cohorts
# ---------------------------------------------------------------------------

PRELUDE = """
import dataclasses, os, pickle, sys, time
import numpy as np, torch
from repro_torch.launch import mesh as M
from repro_torch.serve.sweep_service import ServiceConfig, SweepService
INIT, NPROCS, RANK, OUT = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                           sys.argv[4])
M.dist_init(INIT, num_processes=NPROCS, process_id=RANK, backend="gloo",
            device="cpu", init_timeout_s={group},
            external_coordinator=INIT.startswith("tcp://"))
mesh = M.make_sweep_mesh(devices=["cpu"])
scfg = ServiceConfig(launch_timeout_s={launch}, heartbeat_s=0.5,
                     max_wait_ms=20.0)
svc = SweepService(scfg, mesh=mesh)
rng = np.random.default_rng(0)
stack = rng.standard_normal((4, 32, 32)).astype(np.float32)
eps = np.asarray([1e-3, 1e-2, 1e-1], np.float32)
RESULTS = {{}}


def follow():
    t0 = time.monotonic()
    try:
        svc.serve()
        RESULTS["serve"] = ("clean", None)
    except Exception as e:
        RESULTS["serve"] = (type(e).__name__, getattr(e, "kind", None))
    RESULTS["serve_s"] = time.monotonic() - t0
    svc.close()
    RESULTS["launches"] = svc.launches
"""

EPILOGUE = """
with open(os.path.join(OUT, f"rank{RANK}.pkl"), "wb") as f:
    pickle.dump(RESULTS, f)
sys.stdout.flush()
os._exit(0)
"""


def _env(extra=None) -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([SRC,
                                           os.environ.get("PYTHONPATH", "")]))
    env.pop("REPRO_FAULT_INJECT", None)
    env.update(extra or {})
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Coordinator:
    """``sweep_serve --coordinator-only`` in a process of its own, ended
    with SIGINT."""

    def __init__(self, nprocs: int):
        self.address = f"tcp://127.0.0.1:{_free_port()}"
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.sweep_serve",
             "--coordinator-only", "--coordinator", self.address,
             "--num-processes", str(nprocs)], env=_env(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        line = self.proc.stdout.readline()
        assert "serving the store" in line, line

    def stop(self) -> str:
        self.proc.send_signal(signal.SIGINT)
        out = self.proc.communicate(timeout=30)[0]
        assert self.proc.returncode == 0, out
        return out


def _wait_all(procs, wall_s: float) -> list:
    deadline = time.monotonic() + wall_s
    try:
        return [p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        outs = [p.communicate() for p in procs]
        raise AssertionError("a cohort hung past its wall-clock limit:\n" +
                             "\n".join(f"--- rank {i} ---\n{o}"
                                       for i, o in enumerate(outs)))


def run_chaos(tmp_path, body: str, nprocs: int, chaos: dict,
              external: bool = False, launch_s: float = LAUNCH_TIMEOUT_S):
    """Run ``body`` in ``nprocs`` fresh interpreters of one gloo group,
    rank r armed with ``chaos[r]`` (a ``REPRO_FAULT_INJECT`` spec); the
    group's store is a ``FileStore``, or with ``external`` a ``TCPStore``
    that ``--coordinator-only`` serves.  Returns each rank's (return
    code, output, RESULTS or None)."""
    script = tmp_path / "rank.py"
    script.write_text(PRELUDE.format(group=GROUP_TIMEOUT_S, launch=launch_s)
                      + textwrap.dedent(body) + EPILOGUE)
    coord = _Coordinator(nprocs) if external else None
    init = coord.address if external else f"file://{tmp_path / 'init'}"
    try:
        procs = [subprocess.Popen(
            [sys.executable, str(script), init, str(nprocs), str(r),
             str(tmp_path)],
            env=_env({"REPRO_FAULT_INJECT": chaos[r]} if r in chaos else {}),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(nprocs)]
        outs = [o for o, _ in _wait_all(procs, WALL_S)]
    finally:
        if coord is not None:
            coord.stop()
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
    return "\n".join(f"--- rank {r} (rc={rc}) ---\n{out[-4000:]}"
                     for r, (rc, out, _) in enumerate(res))


def _check(res, killed=()):
    for r, (rc, _, saved) in enumerate(res):
        if r in killed:
            assert rc == -signal.SIGKILL, _report(res)
        else:
            assert rc == 0 and saved is not None, _report(res)


def test_follower_loss_recovery_3proc(tmp_path):
    """The headline case: a 3-process fabric loses follower 2 inside a
    launch (SIGKILL after the header).  The leader attributes it by
    heartbeat, shrinks to [0, 1], relaunches through the store, and
    every future -- the in-flight batch's too -- completes bit-equal.
    The surviving follower rejoins and its ``serve()`` returns cleanly
    at the leader's ``close()``."""
    res = run_chaos(tmp_path, """
        if svc.role == "leader":
            RESULTS["r1"] = svc.submit_featurize(stack, eps).result(60)
            t0 = time.monotonic()
            futs = [svc.submit_featurize(stack[i*2:(i+1)*2] + i, eps)
                    for i in range(2)]
            RESULTS["rs"] = [f.result(100) for f in futs]
            RESULTS["dt"] = time.monotonic() - t0
            RESULTS["after"] = svc.submit_featurize(stack + 2, eps).result(60)
            RESULTS["stats"] = svc.stats()
            svc.close()
            RESULTS["store_keys_left"] = [
                k for k in ("l/1/1/hdr", "l/1/1/eps/n", "l/1/1/x/1/n",
                            "l/1/1/out/1/n", "l/1/2/hdr")
                if M.coordination_store().check([f"{svc._kvp}/{k}"])]
        else:
            follow()
    """, 3, {2: "follower_launch:kill:2"})
    _check(res, killed={2})
    lead, mid = res[0][2], res[1][2]
    x = _stack()
    assert_served(lead["r1"], x)
    for i, r in enumerate(lead["rs"]):
        assert_served(r, x[i * 2:(i + 1) * 2] + i)
    assert_served(lead["after"], x + 2)
    st = lead["stats"]
    assert st["epoch"] == 1 and st["transport"] == "kv", st
    assert st["recoveries"] == 1 and st["procs"] == [0, 1], st
    assert st["kv_bytes"] > 0 and st["last_recovery_s"] > 0
    assert lead["dt"] < 3 * LAUNCH_TIMEOUT_S, lead["dt"]
    assert lead["store_keys_left"] == [], lead["store_keys_left"]
    assert mid["serve"] == ("clean", None), mid
    assert mid["launches"] == 3             # 1 over gloo, 2 through the store


def test_follower_loss_during_warmup_degrades_to_local(tmp_path):
    """A follower dying in the leader's warmup launch recovers the same
    way: with no other survivor the leader serves alone."""
    res = run_chaos(tmp_path, """
        if svc.role == "leader":
            svc.warmup([(32, 32)], grid_sizes=(3,), row_buckets=(4,))
            RESULTS["r"] = svc.submit_featurize(stack, eps).result(60)
            RESULTS["stats"] = svc.stats()
            svc.close()
        else:
            follow()
    """, 2, {1: "follower_launch:kill:1"})
    _check(res, killed={1})
    lead = res[0][2]
    assert_served(lead["r"], _stack())
    st = lead["stats"]
    assert st["recoveries"] == 1 and st["procs"] == [0], st
    assert st["launches"] == 1


def test_double_fault_shrinks_twice_then_serves_local(tmp_path):
    """Follower 2 dies on the group launch, then follower 1 on the first
    launch through the store: the leader sheds both across two epochs and
    still completes the future bit-equal, alone."""
    res = run_chaos(tmp_path, """
        if svc.role == "leader":
            RESULTS["r1"] = svc.submit_featurize(stack, eps).result(60)
            RESULTS["r2"] = svc.submit_featurize(stack + 1, eps).result(100)
            RESULTS["stats"] = svc.stats()
            svc.close()
        else:
            follow()
    """, 3, {2: "follower_launch:kill:2", 1: "kv_launch:kill:1"})
    _check(res, killed={1, 2})
    lead = res[0][2]
    assert_served(lead["r1"], _stack())
    assert_served(lead["r2"], _stack() + 1)
    st = lead["stats"]
    assert st["recoveries"] == 2 and st["procs"] == [0], st
    assert st["epoch"] >= 2 and st["transport"] == "kv", st


def test_leader_death_raises_typed_error_on_followers(tmp_path):
    """With the store in a process of its own (``--coordinator-only``), a
    leader SIGKILLed before its second launch releases the follower from
    ``serve()`` with ``FabricError(kind="leader_lost")`` promptly, by
    the leader's heartbeat, and the follower exits 0."""
    res = run_chaos(tmp_path, """
        if svc.role == "leader":
            RESULTS["r1"] = svc.submit_featurize(stack, eps).result(60)
            svc.submit_featurize(stack, eps).result(60)   # killed here
            RESULTS["survived"] = True
        else:
            follow()
    """, 2, {0: "leader_launch:kill:2"}, external=True)
    _check(res, killed={0})
    follower = res[1][2]
    assert follower["serve"] == ("FabricError", "leader_lost"), follower
    assert follower["serve_s"] < 150, follower
    assert follower["launches"] == 1


def test_hung_follower_evicted_within_deadline(tmp_path):
    """A wedged follower (hanging inside its join, heartbeat still
    beating): the leader's deadline (8 s once warm) expires, it evicts
    the follower and completes alone; the follower sees the new epoch,
    learns it was evicted and its ``serve()`` raises
    ``kind="evicted"``."""
    res = run_chaos(tmp_path, """
        if svc.role == "leader":
            RESULTS["r1"] = svc.submit_featurize(stack, eps).result(60)
            svc.scfg = dataclasses.replace(svc.scfg, launch_timeout_s=8.0)
            t0 = time.monotonic()
            RESULTS["r2"] = svc.submit_featurize(stack + 1, eps).result(60)
            RESULTS["dt"] = time.monotonic() - t0
            RESULTS["stats"] = svc.stats()
            svc.close()
        else:
            follow()
    """, 2, {1: "follower_launch:hang:2:3600"})
    _check(res)
    lead, follower = res[0][2], res[1][2]
    assert_served(lead["r1"], _stack())
    assert_served(lead["r2"], _stack() + 1)
    st = lead["stats"]
    assert st["recoveries"] == 1 and st["procs"] == [0], st
    assert 8.0 <= lead["dt"] < 30.0, lead["dt"]
    assert st["last_detect_s"] >= 8.0
    assert follower["serve"] == ("FabricError", "evicted"), follower


def test_sweep_serve_chaos_under_an_external_coordinator(tmp_path):
    """``sweep_serve --coordinator-only`` and three ``--external-
    coordinator`` ranks, rank 2 with ``--chaos`` killed in its fifth
    launch (the first after the four warmups): the report shows one
    recovery onto [0, 1] and ``--verify`` finds no served result that
    differs from the direct call."""
    coord = _Coordinator(3)
    out = tmp_path / "serve.json"
    try:
        argv = ["repro_torch.launch.sweep_serve", "--device", "cpu",
                "--fields", "scale-u", "--n", "32", "--compressor",
                "bitgrooming", "--train-slices", "6", "--hot-slices", "2",
                "--clients", "2", "--requests", "8", "--verify",
                "--mesh", "auto", "--coordinator", coord.address,
                "--external-coordinator", "--num-processes", "3",
                "--backend", "gloo", "--heartbeat-s", "0.5",
                "--launch-timeout-s", str(LAUNCH_TIMEOUT_S), "--out",
                str(out)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", *argv, "--process-id", str(r)]
            + (["--chaos", "follower_launch:kill:5"] if r == 2 else []),
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(3)]
        outs = _wait_all(procs, WALL_S)
    finally:
        coord.stop()
    rcs = [p.returncode for p in procs]
    assert rcs == [0, 0, -signal.SIGKILL], list(zip(rcs, outs))
    report = json.loads(out.read_text())
    assert report["requests"] == 8 and report["verify"]["mismatches"] == 0
    assert report["recoveries"] == 1 and report["procs"] == [0, 1], report
    assert report["epoch"] == 1
    assert "chaos armed: follower_launch:kill:5" in outs[2][0]
    assert "done" in outs[1][0]
