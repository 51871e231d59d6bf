"""The typed failure of the multi-process sweep fabric.

``serve.sweep_service.SweepService`` on a process-spanning mesh runs
every launch as a series of collectives over the mesh's group.  When
one of them raises or times out (a peer exited, or stopped answering
within the group's timeout), the fabric is broken: every pending and
queued request fails with :class:`FabricError`, later submissions are
refused, and the service does not try to recover.  Recovery (heartbeats,
shrinking the mesh, epochs) is not part of the port yet.
"""
from __future__ import annotations

from typing import Sequence


class FabricError(RuntimeError):
    """A failure of the multi-process fabric itself (vs one request).

    ``kind`` classifies the fault:

    * ``"follower_lost"`` -- a follower died or stopped answering;
    * ``"leader_lost"``   -- the leader (or its coordination store)
      went away under a follower;
    * ``"timeout"``       -- a collective hit the group's timeout with no
      peer identified as lost;
    * ``"failed"``        -- anything else; restart the fabric.

    ``lost`` names the process ranks believed lost (may be empty when
    the fault could not be attributed).  ``retriable`` says whether a
    relaunch on a smaller mesh could succeed; nothing in the port
    retries yet."""

    def __init__(self, message: str, *, kind: str = "failed",
                 lost: Sequence[int] = (), retriable: bool = False):
        self.kind = kind
        self.lost = tuple(lost)
        self.retriable = retriable
        detail = f" [kind={kind}"
        if self.lost:
            detail += f", lost processes={list(self.lost)}"
        detail += ", retriable]" if retriable else \
            "; restart the affected process(es) to rejoin the fabric]"
        super().__init__(message + detail)
