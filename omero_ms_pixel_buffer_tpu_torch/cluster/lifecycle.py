"""Graceful drain — a planned leave must not look like a crash.

(Copy of ``omero_ms_pixel_buffer_tpu/cluster/lifecycle.py``. Step 1
publishes the draining marker through the lease or the gossip digest,
and step 4 releases the lease or tombstones the member; over a static
member list there is neither, so step 1 only rebuilds the replica's own
ring and step 4 has nothing to release.)

Before this module a rolling restart rode the CRASH path: the lease
expired one TTL after the process died, peers kept routing ownership
at a corpse for that window, and only the TinyLFU-qualified slice of
the hot set survived (the >= 0.8 post-crash bench pin — good for a
crash, embarrassing for a deploy someone scheduled). PATCHEDSERVE's
SLO framing says availability targets must hold *through* operational
churn; for a fleet restarted nightly, the planned-leave path IS the
steady state.

The drain protocol (SIGTERM or a signed ``POST /internal/drain``):

1. **announce** — the replica re-publishes its lease with a
   ``draining`` marker. Peers observing the marker rebuild their
   rings WITHOUT the drainer (it stops being an owner fleet-wide
   within one heartbeat), and the drainer rebuilds its own ring the
   same way so its final fills route to the post-drain owners. It
   keeps serving everything throughout — the marker moves ownership,
   not traffic.
2. **hand off** — the FULL RAM hot set (not just the TinyLFU-
   qualified slice replication pushes) is framed with the existing
   transfer encoding and POSTed to the post-drain owners, grouped by
   ring target. Epoch stamps ride along, so a handoff can never
   resurrect purged bytes.
3. **quiesce** — wait for in-flight renders (admission slots + SLO
   wait queues) to finish, bounded by ``cluster.drain.deadline-s``.
   The scheduler is told (``note_draining``) so it stops minting NEW
   degraded permits — a draining replica finishes real work, it does
   not start speculative work.
4. **leave** — DELETE the lease (peers that already saw the marker
   observe the leave instantly; stragglers within one scan) and stop
   heartbeating. The caller — the SIGTERM handler or the operator's
   process manager — then stops the server.

Every step is bounded by the one deadline and every failure degrades
to the crash path the fleet already survives: a dead Redis leaves the
lease to expire by TTL, a dead successor skips its handoff batch.
Draining is idempotent — a second trigger joins the first.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional

from ..utils.metrics import REGISTRY

log = logging.getLogger("omero_ms_pixel_buffer_tpu_torch.cluster")

DRAIN_EVENTS = REGISTRY.counter(
    "cluster_drain_events_total",
    "Graceful-drain lifecycle events on this replica",
)


class DrainCoordinator:
    """The drain state machine: ``serving -> draining -> drained``.
    Owns the timeline and the stats; the cache plane owns the
    mechanics (lease marker, ring rebuild, handoff pushes)."""

    def __init__(
        self,
        plane,
        deadline_s: float = 10.0,
        admission=None,
        scheduler=None,
        session_registry=None,
        clock=time.monotonic,
    ):
        self.plane = plane
        self.deadline_s = float(deadline_s)
        self.admission = admission
        self.scheduler = scheduler
        # the session plane's ChannelRegistry (r22): live channels get
        # a reconnect frame and their subscription summary rides to a
        # successor before the lease drops
        self.session_registry = session_registry
        self._clock = clock
        self.state = "serving"
        self.stats: dict = {}
        self._task: Optional[asyncio.Task] = None

    @property
    def draining(self) -> bool:
        return self.state != "serving"

    async def drain(self) -> dict:
        """Run (or join) the drain. Idempotent: concurrent triggers —
        SIGTERM racing an operator's /internal/drain — share one
        protocol run and one answer."""
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(
                self._run()
            )
        # shield: an HTTP drain request disconnecting must not cancel
        # the protocol the SIGTERM path (or another caller) is riding
        return await asyncio.shield(self._task)

    async def _run(self) -> dict:
        t0 = self._clock()
        deadline = t0 + self.deadline_s
        self.state = "draining"
        DRAIN_EVENTS.inc(event="started")
        log.info("drain: started (deadline %.1fs)", self.deadline_s)
        if self.scheduler is not None:
            try:
                self.scheduler.note_draining(True)
            except Exception:
                log.debug("drain: scheduler hook failed", exc_info=True)
        announced = await self.plane.begin_drain()
        # let one heartbeat land so peers observe the marker and stop
        # routing ownership here BEFORE the handoff entries arrive at
        # their post-drain owners (bounded by the drain deadline)
        await asyncio.sleep(
            min(self.plane.drain_propagation_s(),
                max(0.0, deadline - self._clock()))
        )
        # the deadline is in THIS coordinator's clock domain — pass
        # the clock along so the plane's per-target checks compare
        # like with like (an injected test clock included)
        handoff = await self.plane.handoff_hot_set(
            deadline, clock=self._clock
        )
        # session-plane handoff (r22) rides the same deadline: every
        # live channel gets a {"reconnect": url} frame pointing at the
        # chosen successor (or the balancer when we're the last
        # replica), and the subscription summary POSTs over the same
        # authenticated /internal/handoff surface the cache uses.
        # Zero dropped sessions means zero frames lost BEFORE the
        # reconnect frame — the channel closes only after it lands.
        sessions = {"channels": 0, "successor": "", "pushed": False}
        if self.session_registry is not None:
            try:
                sessions = await self.plane.handoff_sessions(
                    self.session_registry, deadline, clock=self._clock
                )
                DRAIN_EVENTS.inc(event="sessions_handed_off")
            except Exception:
                log.warning("drain: session handoff failed",
                            exc_info=True)
        quiesced = await self._await_quiescence(deadline)
        released = await self.plane.release_lease()
        self.state = "drained"
        DRAIN_EVENTS.inc(event="completed")
        self.stats = {
            "announced": announced,
            "handoff": handoff,
            "sessions": sessions,
            "quiesced": quiesced,
            "lease_released": released,
            "took_s": round(self._clock() - t0, 3),
        }
        log.info("drain: complete %s", self.stats)
        return dict(self.stats)

    def _inflight(self) -> int:
        count = 0
        if self.admission is not None:
            count += self.admission.inflight
        sched = self.scheduler
        if sched is not None:
            count += sched._waiting_total
        return count

    async def _await_quiescence(self, deadline: float) -> bool:
        """True when in-flight work drained inside the deadline;
        False means the deadline expired with work still running —
        the drain proceeds anyway (bounded beats complete: the
        stragglers ride the same failure paths a crash would, which
        the fleet already survives)."""
        while self._clock() < deadline:
            if self._inflight() == 0:
                DRAIN_EVENTS.inc(event="quiesced")
                return True
            await asyncio.sleep(0.05)
        if self._inflight() == 0:
            DRAIN_EVENTS.inc(event="quiesced")
            return True
        DRAIN_EVENTS.inc(event="deadline_expired")
        log.warning(
            "drain: deadline expired with %d in-flight", self._inflight()
        )
        return False

    def snapshot(self) -> dict:
        out = {"state": self.state, "deadline_s": self.deadline_s}
        if self.stats:
            out["stats"] = dict(self.stats)
        return out
