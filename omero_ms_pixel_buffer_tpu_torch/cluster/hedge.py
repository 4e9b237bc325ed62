"""Owner-side hedging — cap peer-fetch tails through partial outages.

(Copy of ``omero_ms_pixel_buffer_tpu/cluster/hedge.py``.)

A non-owner's cold miss asks the key's owner once before rendering
locally, bounded by ``cluster.peer-timeout-ms``. When the owner is
merely SLOW (wedged device queue, GC pause, half-dead host), every
such miss eats the whole timeout before the local render even starts
— the tail of a partial outage is ``peer-timeout + render``.

Hedging starts the local render as soon as the peer fetch runs past
the OBSERVED p99 of peer fetches (the flight recorder's
``request_stage_seconds{stage="peer"}`` histogram — always on since
r16, so the signal exists whether or not tracing does), and serves
whichever finishes first. The healthy-cluster cost is ~1% duplicate
renders (by the definition of p99); the sick-cluster win is tails
capped at ~p99 + render instead of timeout + render. The delay is
clamped to ``[hedge.min-ms, hedge.max-ms]`` so a cold histogram or a
pathological distribution can neither hedge every fetch nor disable
hedging entirely; with no samples at all the fallback is
``hedge.fallback-ms`` (defaulting to half the peer timeout).

This never changes bytes: both runners produce entries under the same
fully-qualified key, and the loser's work lands in the caches it was
headed for anyway (the "at most one extra render per disagreement"
bound the membership module documents — hedging spends the same
bounded cost on purpose, when the latency evidence says it's worth
it). Outcomes are tagged onto the request's flight record
(``hedge=peer_win|local_win|...``) and counted.
"""

from __future__ import annotations

import logging

from ..utils.metrics import REGISTRY

log = logging.getLogger("omero_ms_pixel_buffer_tpu_torch.cluster")

HEDGE_OUTCOMES = REGISTRY.counter(
    "cluster_hedge_total",
    "Hedged peer fetches by outcome (fired, peer_win, local_win)",
)


class HedgePolicy:
    def __init__(
        self,
        enabled: bool = False,
        quantile: float = 0.99,
        min_s: float = 0.02,
        max_s: float = 0.25,
        fallback_s: float = 0.25,
    ):
        self.enabled = enabled
        self.quantile = quantile
        self.min_s = min_s
        self.max_s = max_s
        self.fallback_s = fallback_s
        # fixed-slot outcome record: every label note() ever receives
        # is declared here (callers pass literals only)
        self.outcomes = {
            "fired": 0, "peer_win": 0, "peer_failed": 0, "local_win": 0,
        }

    def delay_s(self):
        """How long to give the peer fetch before starting the local
        render, or None when hedging is off (the fetch keeps its full
        peer-timeout bound either way)."""
        if not self.enabled:
            return None
        p = self._observed_quantile()
        if p is None:
            p = self.fallback_s
        return min(max(p, self.min_s), self.max_s)

    def _observed_quantile(self):
        """The observed peer-stage quantile from the flight recorder's
        always-on stage histogram, or None before any peer fetch has
        completed (tests monkeypatch this to pin delay math)."""
        from ..obs.recorder import REQUEST_STAGE_SECONDS

        return REQUEST_STAGE_SECONDS.quantile(
            self.quantile, stage="peer"
        )

    def note(self, outcome: str) -> None:
        self.outcomes[outcome] = self.outcomes.get(outcome, 0) + 1
        HEDGE_OUTCOMES.inc(outcome=outcome)

    def snapshot(self) -> dict:
        out = {"enabled": self.enabled, "outcomes": dict(self.outcomes)}
        if self.enabled:
            delay = self.delay_s()
            out["delay_ms"] = round(delay * 1000.0, 3)
        return out
