"""Cluster-scale elasticity: the autoscaler policy on the router control
plane (DESIGN.md §16).

A copy of ``repro.runtime.autoscale``: the port keeps its own so that it imports
nothing of the JAX package.

gLLM balances work *within* a fleet; production traffic also requires the
fleet itself to track load — diurnal swings and flash crowds change the
request rate by integer factors, and a peak-sized static fleet burns
replica-hours all night to stay ready for noon.  `AutoscalePolicy` closes
that loop one level above `RebalancePolicy`: the router's periodic control
tick measures fleet *pressure* (waiting-queue depth and projected-KV
occupancy — the same signals Token Throttling and `balance_score` already
read), smooths it with an EWMA, and

* **scales up** when sustained pressure exceeds `up_threshold` — new
  replicas come from a `replica_factory` the builder supplies (sim
  backend: a fresh `PipelineSimulator` from the spec's base geometry);
* **scales down by draining**: the victim is masked from admission, its
  waiting requests are stolen and its resident prefill/decode state
  live-migrated through the §9/§15 migration plane, and only a fully
  empty replica is retired.  Role-aware: the last prefill- or
  decode-capable replica of a disaggregated fleet is never drained.

Hysteresis comes from the distinct up/down thresholds plus per-direction
cooldowns; both transitions are recorded in the trace streams (`scale_up` /
`drain` / `retire` record kinds, trace schema 1.6) so elastic runs replay
byte-identically.

This module stays import-light (policy data + pure pressure/attainment
math) so the spec layer can depend on it; the passes themselves live in
`ReplicaRouter` next to the rebalance/handoff planes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import SLO_BATCH, SLO_INTERACTIVE


@dataclass(frozen=True)
class AutoscalePolicy:
    """When the fleet grows and shrinks.

    Pressure is normalized so 1.0 means "each replica is carrying exactly
    its target load": a replica at `target_queue` waiting requests — or
    with its projected KV headroom at the stall activation point —
    contributes 1.0.  The EWMA over control passes (`ewma_alpha`) plus the
    threshold gap (`up_threshold` > `down_threshold`) and per-direction
    cooldowns give the loop hysteresis: a single bursty pass neither grows
    the fleet nor starts a drain, and a freshly-grown fleet is given
    `up_cooldown` seconds to absorb the backlog before growing again.

    Scale-up is proportional (up to `max_step_up` replicas per pass: a
    flash crowd doubling the load should not be answered one replica per
    interval); scale-down always drains exactly one replica per decision —
    shrinking is cheap to do again next pass and expensive to get wrong.
    `drain_batch` caps how many requests a single pass moves off a
    draining victim (steals + migrations), bounding per-tick control work.
    """

    interval: float = 0.5
    min_replicas: int = 1
    max_replicas: int = 8
    target_queue: float = 4.0
    up_threshold: float = 1.0
    down_threshold: float = 0.25
    ewma_alpha: float = 0.4
    up_cooldown: float = 1.0
    down_cooldown: float = 4.0
    max_step_up: int = 8
    drain_batch: int = 16

    def __post_init__(self) -> None:
        if self.min_replicas < 1:
            raise ValueError("AutoscalePolicy.min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("AutoscalePolicy.max_replicas must be >= "
                             "min_replicas")
        if not self.down_threshold < self.up_threshold:
            raise ValueError("hysteresis requires down_threshold < "
                             "up_threshold")
        if self.interval <= 0.0:
            raise ValueError("AutoscalePolicy.interval must be positive")


@dataclass
class AutoscaleStats:
    """Counters + the scaling event log (surfaced through
    `LLMServer.stats()` / `GET /v1/stats`; `replica_seconds` integrates
    fleet size over the event log — the cost axis fig_autoscale trades
    against attainment)."""

    passes: int = 0
    scale_ups: int = 0          # scale-up decisions
    replicas_added: int = 0
    drains_started: int = 0
    retired: int = 0
    drain_moves: int = 0        # steals + migrations forced by drains
    rehomed: int = 0            # in-transit deliveries re-pointed at flush
    # (time, "scale_up" | "drain" | "retire", fleet size after the event)
    events: List[Tuple[float, str, int]] = field(default_factory=list)

    def note(self, now: float, kind: str, fleet_size: int) -> None:
        self.events.append((now, kind, fleet_size))

    def replica_seconds(self, start_size: int, start: float,
                        end: float) -> float:
        """Integral of serving fleet size over [start, end] given the event
        log (draining replicas still count — they hold state and burn the
        replica until retired)."""
        total = 0.0
        t, n = start, start_size
        for at, kind, size in self.events:
            if kind == "drain":
                continue        # fleet size changes at retire, not drain
            at = min(max(at, start), end)
            total += n * (at - t)
            t, n = at, size
        total += n * (max(end, t) - t)
        return total


# ---------------------------------------------------------------------------
# Pressure: the signal the scale decisions run on
# ---------------------------------------------------------------------------

def _remaining_decode_growth(sched) -> int:
    # forward-looking KV growth of the resident decode population (kept
    # local: router.py imports this module, not the other way round)
    return sum(r.sampling.max_new_tokens - r.num_output_tokens
               for r in sched.running_decode)


def replica_pressure(replica, policy: AutoscalePolicy) -> float:
    """One replica's load, normalized to its own capacity: the max of

    * waiting-queue depth over `target_queue` (admission backlog — the
      signal a TTFT SLO dies by), and
    * projected-KV shortfall relative to the UT stall activation band
      (decode residents keep appending; a pool *heading* for its stall
      is pressure even while the queue is short).

    0 is idle, 1 is "exactly at target", >1 is sustained overload.
    """
    sched = replica.scheduler
    queue = len(sched.waiting) / max(policy.target_queue, 1e-9)
    pool = sched.kv.num_pages * sched.kv.page_size
    projected = sched.kv.kv_free_rate - _remaining_decode_growth(sched) / pool
    activation = min(1.0, 4.0 * sched.cfg.kv_threshold)
    shortfall = max(0.0, activation - projected) / max(activation, 1e-9)
    return max(queue, shortfall)


def fleet_pressure(replicas: Sequence[Any], policy: AutoscalePolicy) -> float:
    """Mean per-replica pressure — the quantity the EWMA smooths.  The mean
    (not the max) on purpose: one hot replica is the *rebalance* plane's
    problem; the fleet only needs to grow when the whole fleet is loaded."""
    if not replicas:
        return 0.0
    return float(np.mean([replica_pressure(r, policy) for r in replicas]))


def scale_up_step(n: int, ewma: float, policy: AutoscalePolicy) -> int:
    """How many replicas a scale-up decision adds: proportional to the
    overload factor (pressure 2.0 at threshold 1.0 wants ~n more replicas),
    clamped to [1, max_step_up] and the max_replicas ceiling."""
    want = int(np.ceil(n * (ewma / max(policy.up_threshold, 1e-9) - 1.0)))
    return max(0, min(max(want, 1), policy.max_step_up,
                      policy.max_replicas - n))


# ---------------------------------------------------------------------------
# Per-class SLO attainment — the shared report (GET /v1/stats,
# fig_autoscale, fig_disagg all call this one definition)
# ---------------------------------------------------------------------------

# Default per-class targets (sim seconds): interactive requests are TTFT-
# and TBT-bound; batch requests only need a sane token cadence.  Benchmarks
# may pass their own table; the stats surface reports against these.
DEFAULT_SLOS: Dict[str, Dict[str, float]] = {
    SLO_INTERACTIVE: {"ttft": 2.0, "tbt": 0.02},
    SLO_BATCH: {"ttft": 20.0, "tbt": 0.30},
}


def request_attains(req, slo: Dict[str, float]) -> bool:
    """One request against one SLO row: TTFT within `slo["ttft"]` and mean
    time-between-tokens (TPOT) within `slo["tbt"]`.  A request that never
    produced a first token does not attain."""
    ttft = req.metrics.ttft()
    if ttft is None or ttft > slo["ttft"]:
        return False
    tbt = req.metrics.tpot(req.num_output_tokens)
    return (tbt or 0.0) <= slo["tbt"]


def attainment_by_class(finished: Sequence[Any],
                        slos: Optional[Dict[str, Dict[str, float]]] = None,
                        *, elapsed: Optional[float] = None
                        ) -> Dict[str, Dict[str, float]]:
    """{slo_class: {n, attained, attainment, ttft_p95, tbt_p95[, goodput]}}
    over finished requests.  `attainment` is the fraction of the class's
    requests meeting both their TTFT and TBT targets (1.0 for an empty
    class — nothing violated); `goodput` (attaining requests per second)
    is included iff `elapsed` is given."""
    slos = slos if slos is not None else DEFAULT_SLOS
    out: Dict[str, Dict[str, float]] = {}
    for cls, slo in slos.items():
        reqs = [r for r in finished if r.sampling.slo_class == cls]
        ttfts = [r.metrics.ttft() for r in reqs
                 if r.metrics.ttft() is not None]
        tbts = [r.metrics.tpot(r.num_output_tokens) for r in reqs
                if r.metrics.tpot(r.num_output_tokens) is not None]
        ok = sum(1 for r in reqs if request_attains(r, slo))
        row: Dict[str, float] = {
            "n": len(reqs),
            "attained": ok,
            "attainment": ok / len(reqs) if reqs else 1.0,
            "ttft_p95": float(np.quantile(ttfts, 0.95)) if ttfts else 0.0,
            "tbt_p95": float(np.quantile(tbts, 0.95)) if tbts else 0.0,
        }
        if elapsed is not None:
            row["goodput"] = ok / max(elapsed, 1e-9)
        out[cls] = row
    return out
