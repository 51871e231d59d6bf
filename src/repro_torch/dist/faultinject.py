"""Deterministic, opt-in fault injection for the sweep fabric (the
reference's ``dist.faultinject``, which imports nothing of JAX; the port
keeps its own copy).

Disabled unless armed -- ``fire()`` is a dict-lookup no-op in
production.  Armed via the ``REPRO_FAULT_INJECT`` environment variable
(read at import, so child processes arm themselves before they start
work) or :func:`configure` in tests.  The spec is a comma-separated
list of

    site:mode:nth[:arg]

* ``site`` -- a named hook point on the broadcast/launch path; the
  serving fabric fires ``leader_launch`` (leader, before each
  collective launch), ``follower_launch`` (follower, after decoding a
  launch header, inside the bounded join), ``kv_launch`` (follower,
  after reading a store-transport launch descriptor) and ``bcast``
  (every payload broadcast on either side).
* ``mode`` -- ``kill`` (SIGKILL self: a crash-stop), ``exit``
  (``os._exit(17)``: abrupt but not signal-terminated), ``hang``
  (sleep ``arg`` seconds, default 3600: a wedged peer whose heartbeat
  thread keeps running), ``slow`` (sleep ``arg`` seconds, default 1.0:
  degraded but alive).
* ``nth`` -- fire on exactly the nth call of that site (1-based), so
  chaos tests pick the precise launch to break.
* ``arg`` -- optional float parameter for hang/slow.

Example: kill this process the second time it joins a launch::

    REPRO_FAULT_INJECT=follower_launch:kill:2
"""
from __future__ import annotations

import os
import signal
import time
from typing import Dict, List, Optional, Tuple

MODES = ("kill", "exit", "hang", "slow")

_specs: Dict[str, List[Tuple[str, int, float]]] = {}
_counts: Dict[str, int] = {}


def parse(spec: str) -> Dict[str, List[Tuple[str, int, float]]]:
    """``"site:mode:nth[:arg],..."`` -> {site: [(mode, nth, arg)]}."""
    out: Dict[str, List[Tuple[str, int, float]]] = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        bits = part.split(":")
        if len(bits) not in (3, 4):
            raise ValueError(
                f"fault-inject spec {part!r} is not site:mode:nth[:arg]")
        site, mode, nth = bits[0], bits[1], bits[2]
        if mode not in MODES:
            raise ValueError(
                f"fault-inject mode {mode!r} not in {MODES}")
        try:
            n = int(nth)
            arg = float(bits[3]) if len(bits) == 4 else \
                (3600.0 if mode == "hang" else 1.0)
        except ValueError as e:
            raise ValueError(f"fault-inject spec {part!r}: {e}") from None
        if n < 1:
            raise ValueError(f"fault-inject nth must be >= 1, got {n}")
        out.setdefault(site, []).append((mode, n, arg))
    return out


def configure(spec: Optional[str]) -> None:
    """(Re)arm from ``spec``; None/"" disarms.  Resets all counters."""
    global _specs
    _specs = parse(spec) if spec else {}
    _counts.clear()


def fire(site: str) -> None:
    """Hook point: counts the call and executes any armed fault whose
    ``nth`` matches.  No-op (one dict lookup) when disarmed."""
    if not _specs:
        return
    armed = _specs.get(site)
    if not armed:
        return
    _counts[site] = n = _counts.get(site, 0) + 1
    for mode, nth, arg in armed:
        if nth != n:
            continue
        if mode == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        elif mode == "exit":
            os._exit(17)
        elif mode in ("hang", "slow"):
            time.sleep(arg)


def counts() -> Dict[str, int]:
    return dict(_counts)


configure(os.environ.get("REPRO_FAULT_INJECT"))
