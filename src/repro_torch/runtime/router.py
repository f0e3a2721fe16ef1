"""Globally-balanced multi-replica routing + control plane (DESIGN.md §1.3, §9).

A copy of ``repro.runtime.router``: the port keeps its own so that it
imports nothing of the JAX package.  Its replicas are `PipelineEngine`s on
`TorchBackend` or the port's `PipelineSimulator`s (`SimCluster`), and
`open_trace` writes the JAX package's `gllm-route` stream.  One addition:
`_move_request` settles the source first (`PipelineEngine.settle`), since
an async engine at depth 1 holds every running decode in flight between
its steps, where the JAX router could never move it.

gLLM's thesis is that *global* state — pending prefill tokens (#WP), decode
population (#RD), KV idle rate — should drive scheduling.  Token Throttling
applies that inside one replica; `ReplicaRouter` applies the same principle
one level up: it fronts N independent `TickLoop` replicas (real engines or
simulators, possibly heterogeneous in speed or pipeline depth) and routes
each arriving request to the replica whose global balance score is lowest.

The score is computed from exactly the scheduler signals Token Throttling
uses, so imbalance is *discovered* — a slow or KV-saturated replica
accumulates #WP/#RD backlog and sheds load without any static capacity
configuration (`ReplicaCapacity` hints can still be supplied when
capacities are known).

Admission-time placement alone reacts a queue-buildup too late: a replica
that saturates *after* placement keeps its backlog while neighbors idle.
With a `RebalancePolicy` the router becomes a periodic **control plane**
(§9): each interval it re-polls every replica's balance score and, when the
spread exceeds the trigger, first *steals* waiting requests from the
saturated queue (cheap — no state moves) and, if imbalance persists,
**live-migrates** running decode requests — draining them from the source
scheduler, shipping their KV pages (and recurrent state) through the
backend migration hooks, and re-admitting them at their current position
with no recompute.

`SimCluster` drives N `PipelineSimulator` replicas in causally-consistent
virtual time: before each routing decision (and each control-plane tick)
every replica is advanced to that instant, so the router sees the state a
real frontend would; migration pays the modeled KV-transfer latency.
"""

from __future__ import annotations

import dataclasses
import enum
import heapq
import itertools
from dataclasses import dataclass
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import numpy as np

from repro_torch.core import (SLO_BATCH, KVExport, Request, RequestState,
                        SamplingParams)
from repro_torch.runtime.autoscale import (AutoscalePolicy, AutoscaleStats,
                                     fleet_pressure, replica_pressure,
                                     scale_up_step)
from repro_torch.runtime.disagg import (ROLE_MIXED, ROLE_PREFILL, DisaggStats,
                                  HandoffPolicy, decode_capable,
                                  handoff_candidates, prefill_capable,
                                  retirable, validate_roles)


class RoutingPolicy(enum.Enum):
    ROUND_ROBIN = "rr"
    BALANCED = "balanced"


@dataclass(frozen=True)
class BalanceWeights:
    """Converts the scheduler's global signals into one load scalar.

    A decode-resident request represents future work (its remaining output
    tokens) — `decode_tokens` is the prefill-token-equivalent charged per
    resident decode; calibrate it to ~E[remaining output length] of the
    workload (the default suits chat-style ~240-token outputs; with a
    `RebalancePolicy` the router calibrates it online from an EWMA of
    observed output lengths).  `kv_pressure` inflates the score of replicas
    close to the UT stall point, where admission would trigger the throttle
    guard or preemption-recompute churn (paper Fig. 15's no-UT pathology,
    avoided cluster-wide).  The pressure is *threshold-relative* — it
    engages below `kv_activation_margin` times the replica's own KV
    threshold — so a structurally smaller pool is not penalized while it
    still has headroom (the asymmetric-KV heterogeneity case of
    fig_router_balance.py).
    """

    decode_tokens: float = 128.0
    kv_pressure: float = 4.0
    kv_activation_margin: float = 4.0
    # Prefill-token-equivalent credit per token of the candidate's prompt
    # already cached on a replica (`ReplicaSnapshot.cached_prefix_tokens`,
    # probed via the non-mutating `PagedKVManager.peek_prefix`).  At 1.0 a
    # replica is charged only the *uncached* remainder of the prompt — the
    # work it would actually do — so cache affinity and load balance trade
    # in the same currency.  Zero disables cache-aware routing; the term is
    # inert whenever prefix caching is off (probes return 0).
    cache_affinity: float = 1.0
    # Waiting-queue composition surcharge, per waiting request by SLO
    # class: `waiting_prefill_tokens` already counts the queue's tokens,
    # but a queue of interactive requests is *latency debt* (each one has
    # a TTFT clock running) while an equally deep all-batch queue is not —
    # the per-request charge makes placement prefer burying new work
    # behind batch backlog over interactive backlog.
    interactive_queue: float = 4.0
    batch_queue: float = 1.0
    # Blend between static `ReplicaCapacity` hints (0.0) and the
    # *discovered* per-replica service rate (1.0): when every replica has
    # retired enough work to report a `SchedulerStats.note_retire` EWMA,
    # each rate is normalized by the fleet mean and blended over the hint
    # at this weight.  Discovery closes the loop the static hints only
    # approximate — a straggler's real throughput deficit is measured,
    # not declared (fig_rebalance's discovery-only scenarios).  The
    # default is deliberately conservative: a service rate conflates
    # capacity with utilization (an under-fed replica *retires* slowly no
    # matter how fast it could go), so measured rates nudge the score
    # rather than dominate it; set 1.0 to trust measurement fully on a
    # cluster you know stays saturated.  Discovery only applies when the
    # operator declared no capacities at all — explicit hints are truth
    # and are never diluted by utilization-confounded measurement.
    discovered_rate: float = 0.25


@dataclass(frozen=True)
class ReplicaCapacity:
    """Static capacity hint for one replica, stated as hardware facts.

    The router only consumes the derived `scalar()` (throughput relative to
    a 1.0 reference replica), but callers declare what they actually know —
    relative FLOPs, KV pool size, pipeline depth — and the constructors
    derive the scalar, so benchmark configs stay in the language of the
    heterogeneity they model (fig_router_balance's slow / straggler cases).
    """

    rel_flops: float = 1.0
    kv_pool_pages: Optional[int] = None
    pipeline_depth: Optional[int] = None

    @staticmethod
    def scaled(slow_factor: float, **kw) -> "ReplicaCapacity":
        """Uniformly `slow_factor`x slower silicon."""
        return ReplicaCapacity(rel_flops=1.0 / slow_factor, **kw)

    @staticmethod
    def straggler(pp: int, slow_factor: float, **kw) -> "ReplicaCapacity":
        """One of `pp` stages is `slow_factor`x slower.  A fully *packed*
        ring is gated by the slow stage alone (1/slow_factor), but serving
        pipelines spend much of their time decode-bubbled, where per-batch
        latency — the sum of stages, (pp-1+f)/pp relative — is what gates
        throughput; this hint uses that sum-of-stages ratio,
        pp / (pp - 1 + slow_factor), which fig_router_balance validates
        empirically.  Use `scaled(slow_factor)` for a pipeline you expect
        to stay packed."""
        return ReplicaCapacity(rel_flops=pp / (pp - 1 + slow_factor),
                               pipeline_depth=pp, **kw)

    def scalar(self) -> float:
        return self.rel_flops


@dataclass(frozen=True)
class RebalancePolicy:
    """Control-plane knobs: when to act and how much state to move.

    A pass triggers when max/min balance score exceeds `trigger_ratio`
    (with an absolute `min_score_gap` floor so near-idle clusters don't
    ping-pong).  Steals are cheap (waiting requests carry no device state),
    so up to `steal_batch` happen first; live migrations move KV over the
    interconnect, so they carry hysteresis: they fire only past the higher
    `migrate_trigger_ratio` (imbalance that stealing alone could not clear),
    are rationed to `migrate_batch` per pass, prefer requests with the most
    output still to generate (durable relief per transfer; at least
    `min_remaining_tokens`), and each request moves at most
    `max_request_migrations` times — without that cap a relieved replica
    looks attractive again next pass and the same KV bounces back and
    forth.  `calibrate_decode_weight` keeps `BalanceWeights.decode_tokens`
    tracking an EWMA of observed output lengths (charged at half: the
    expected *remaining* length of a request in steady state).
    """

    interval: float = 0.25
    trigger_ratio: float = 1.5
    min_score_gap: float = 256.0
    steal_batch: int = 8
    migrate: bool = True
    migrate_trigger_ratio: float = 2.5
    migrate_batch: int = 2
    min_remaining_tokens: int = 16
    max_request_migrations: int = 1
    calibrate_decode_weight: bool = True
    ewma_alpha: float = 0.01


def remaining_decode_growth(sched) -> int:
    """KV tokens the resident decode population will still append before
    finishing (bounded by each request's max_new_tokens) — the forward-
    looking half of every KV projection below."""
    return sum(r.sampling.max_new_tokens - r.num_output_tokens
               for r in sched.running_decode)


def kv_activation(weights: BalanceWeights, kv_threshold: float) -> float:
    """Free-rate level below which the pressure term engages: a margin
    above the replica scheduler's own UT stall point."""
    return min(1.0, weights.kv_activation_margin * kv_threshold)


@dataclass(frozen=True)
class ReplicaSnapshot:
    """The router's view of one replica at a routing instant.

    `projected_kv_free` looks past the instantaneous idle rate: resident
    decodes keep appending KV until they finish, so a structurally small
    pool that *looks* idle can be minutes from the UT stall.  The projection
    subtracts `remaining_decode_growth` — the KV-aware signal both
    admission and the rebalance control plane score against.
    """

    waiting_prefill_tokens: int
    running_decode: int
    kv_free_rate: float
    kv_threshold: float = 0.05      # the replica scheduler's UT stall point
    projected_kv_free: Optional[float] = None
    # Discovered tokens-retired-per-second EWMA (scheduler service clock);
    # None until the replica has retired work over a measurable window.
    # First step toward replacing static `ReplicaCapacity` hints: exposed
    # through `LLMServer.stats()` so operators can compare hint vs. reality.
    service_rate: Optional[float] = None
    # Waiting-queue composition by SLO class: a queue of interactive
    # requests is latency debt; an equally deep all-batch queue is not.
    # Folded into `balance_score` via `BalanceWeights.interactive_queue` /
    # `batch_queue` (class-aware placement, DESIGN.md §11).
    waiting_interactive: int = 0
    waiting_batch: int = 0
    # Tokens of the candidate request's prompt whose KV is already cached
    # here (longest hash-chained full-page prefix, non-mutating probe).
    # 0 when the snapshot was taken without a candidate prompt or the
    # replica has prefix caching disabled.
    cached_prefix_tokens: int = 0

    @staticmethod
    def of(replica,
           prompt: Optional[Sequence[int]] = None) -> "ReplicaSnapshot":
        sched = replica.scheduler
        pool = sched.kv.num_pages * sched.kv.page_size
        growth = remaining_decode_growth(sched)
        n_batch = sum(1 for r in sched.waiting
                      if r.sampling.slo_class == SLO_BATCH)
        cached = 0
        if prompt is not None and getattr(sched.kv, "enable_prefix_caching",
                                          False):
            # mirror the admission probe exactly (it matches the effective
            # prompt minus the final token, which the first chunk must
            # still consume to sample from)
            cached = sched.kv.peek_prefix(list(prompt)[:-1])
        return ReplicaSnapshot(
            waiting_prefill_tokens=sched.num_waiting_prefill_tokens,
            running_decode=sched.num_running_decode,
            kv_free_rate=sched.kv.kv_free_rate,
            kv_threshold=sched.cfg.kv_threshold,
            projected_kv_free=sched.kv.kv_free_rate - growth / pool,
            service_rate=sched.stats.service_rate,
            waiting_interactive=len(sched.waiting) - n_batch,
            waiting_batch=n_batch,
            cached_prefix_tokens=cached,
        )


def balance_score(snap: ReplicaSnapshot, prompt_tokens: int,
                  weights: BalanceWeights, capacity: float = 1.0) -> float:
    """Estimated completion burden of placing `prompt_tokens` on a replica:
    pending work (incl. the candidate request) per unit capacity, inflated
    by proximity to the KV stall point.  Lower is better.

    Cache affinity: tokens of the candidate's prompt already cached on
    this replica (`snap.cached_prefix_tokens`) are prefill work it will
    never do — they are credited against the candidate's burden at
    `weights.cache_affinity` per token (clamped so a cache hit can reduce
    the candidate's own charge to zero, never below)."""
    burden = prompt_tokens - min(
        weights.cache_affinity * snap.cached_prefix_tokens,
        float(prompt_tokens))
    load = (snap.waiting_prefill_tokens + burden
            + weights.decode_tokens * snap.running_decode
            + weights.interactive_queue * snap.waiting_interactive
            + weights.batch_queue * snap.waiting_batch)
    activation = kv_activation(weights, snap.kv_threshold)
    free = snap.kv_free_rate
    if snap.projected_kv_free is not None:
        # decode residents keep growing their KV: pressure engages on where
        # the pool is *heading*, not only where it is
        free = min(free, snap.projected_kv_free)
    shortfall = max(0.0, activation - free) / max(activation, 1e-9)
    pressure = 1.0 + weights.kv_pressure * shortfall
    return load * pressure / max(capacity, 1e-9)


def discovered_capacities(snaps: Sequence[ReplicaSnapshot],
                          static: Sequence[float],
                          blend: float) -> List[float]:
    """Effective per-replica capacities: the static hints until *every*
    replica reports a discovered service rate, then each rate normalized
    by the fleet mean, blended in at `blend` (1.0 fully replaces the
    hints).  All-or-nothing on purpose: mixing measured rates with
    declared hints inside one score vector would compare replicas in two
    different currencies."""
    if blend <= 0.0:
        return list(static)
    rates = [s.service_rate for s in snaps]
    if any(r is None or r <= 0.0 for r in rates):
        return list(static)
    mean = sum(rates) / len(rates)
    if mean <= 0.0:
        return list(static)
    return [(1.0 - blend) * c + blend * (r / mean)
            for c, r in zip(static, rates)]


@dataclass
class RebalanceStats:
    passes: int = 0
    stolen: int = 0
    migrated: int = 0
    migrated_tokens: int = 0        # KV tokens shipped over the interconnect
    migration_fallbacks: int = 0    # destination pool shrank in transit


class ReplicaRouter:
    """Fronts N serving replicas; routes by global balance score.

    A replica is anything exposing `scheduler` (a `PipelineScheduler`) and
    `backend` (an `ExecutionBackend` — the migration hooks live there);
    engine replicas additionally expose `add_request`/`step`/`has_work`/
    `busy` so the router can serve as a drop-in engine for the serving
    layer (`repro_torch.serving.LLMServer`) and the launchers.

    With `rebalance=RebalancePolicy(...)` the router runs the periodic
    control plane: step-driven replicas (engines) get control ticks from
    `step()` on the backend clock; `SimCluster` drives them explicitly in
    virtual time via `next_control_event`/`control_tick`.
    """

    def __init__(
        self,
        replicas: Sequence[Any],
        policy: str | RoutingPolicy = RoutingPolicy.BALANCED,
        *,
        weights: Optional[BalanceWeights] = None,
        capacities: Optional[Sequence[Any]] = None,
        rebalance: Optional[RebalancePolicy] = None,
        roles: Optional[Sequence[str]] = None,
        handoff: Optional[HandoffPolicy] = None,
        autoscale: Optional[AutoscalePolicy] = None,
        replica_factory: Optional[Callable[[int], Any]] = None,
        trace_path: Optional[str] = None,
    ) -> None:
        if not replicas:
            raise ValueError("ReplicaRouter needs at least one replica")
        self.replicas = list(replicas)
        self.policy = RoutingPolicy(policy)
        self.weights = weights or BalanceWeights()
        n = len(self.replicas)
        # The replica set is *elastic* (§16): every piece of per-replica
        # bookkeeping that outlives a single pass is keyed by a stable
        # replica ordinal (`replica_ids[i]`), never by position — positions
        # shift when a replica retires.  The parallel positional lists
        # (`capacities`, `roles`, `_caps_eff`, ...) are mutated together in
        # `add_replica` / `_retire` only.
        self.replica_ids: List[int] = list(range(n))
        self._next_ordinal = n
        self.capacity_hints = list(capacities) if capacities is not None \
            else [1.0] * n
        if len(self.capacity_hints) != n:
            raise ValueError("one capacity per replica")
        self.capacities = [c.scalar() if isinstance(c, ReplicaCapacity)
                           else float(c) for c in self.capacity_hints]
        # discovery refines the *uniform default*; explicitly declared
        # hints are operator truth and are never diluted by measured
        # rates (which conflate capacity with utilization)
        self._caps_declared = capacities is not None
        self._caps_eff = list(self.capacities)
        self.roles = (validate_roles(roles, n) if roles is not None
                      else (ROLE_MIXED,) * n)
        self.handoff_policy = handoff
        self.disagg_stats = DisaggStats()
        self._handoffs_of: dict = {}        # rid -> times handed off
        self._next_handoff_due = handoff.interval if handoff is not None \
            else None
        self._rr_next = 0
        self._routed_by_id: Dict[int, int] = {o: 0 for o in self.replica_ids}
        self.rebalance_policy = rebalance
        self.rebalance_stats = RebalanceStats()
        self._next_due = rebalance.interval if rebalance is not None else None
        # elastic lifecycle: the autoscaler pass, draining ordinals, and
        # replicas retired (kept for finished-request accounting)
        self.autoscale_policy = autoscale
        self.autoscale_stats = AutoscaleStats()
        self.replica_factory = replica_factory
        self._add_hooks: List[Callable[[Any, int, float], None]] = []
        self._draining: set = set()         # ordinals mid-drain
        self._next_drain_due: Optional[float] = None
        self.retired: List[Any] = []
        self._next_autoscale_due = autoscale.interval \
            if autoscale is not None else None
        self._pressure_ewma: Optional[float] = None
        self._last_scale_up = -float("inf")
        self._last_scale_down = 0.0     # first drain waits a full cooldown
        # in-transit entries address the destination by *ordinal* — the
        # replica list can change while a payload is on the wire, and a
        # delivery to a retired/draining destination is re-homed at flush
        self._in_transit: List[Tuple[float, int, int, Request, KVExport,
                                     Any, Any, str]] = []
        self._transit_seq = itertools.count()
        self._aborted: List[Request] = []   # aborted while in transit
        self._migrations_of: dict = {}      # rid -> times live-migrated
        self._seen_finished: Dict[int, int] = {o: 0 for o in self.replica_ids}
        self._ewma_output: Optional[float] = None
        self._calib_count = 0
        self._trace = None
        if trace_path is not None:
            self.open_trace(trace_path)

    # ------------------------------------------------------- replica indexing
    @property
    def _admissible(self) -> List[int]:
        """Admission candidates: prefill-capable (a pure decode replica only
        ever receives handed-off / migrated work) and not draining (a
        draining replica is masked from new placements)."""
        return [i for i, r in enumerate(self.roles)
                if prefill_capable(r)
                and self.replica_ids[i] not in self._draining]

    def _serving(self) -> List[int]:
        """Indices counted toward fleet capacity: not draining."""
        return [i for i in range(len(self.replicas))
                if self.replica_ids[i] not in self._draining]

    def _index_of(self, ordinal: int) -> Optional[int]:
        try:
            return self.replica_ids.index(ordinal)
        except ValueError:
            return None

    @property
    def routed_counts(self) -> List[int]:
        """Requests placed on each *current* replica, position-aligned with
        `self.replicas` (backed by ordinal-keyed counters, so the list stays
        correct as the fleet grows and shrinks)."""
        return [self._routed_by_id[o] for o in self.replica_ids]

    # ---------------------------------------------------------------- tracing
    def open_trace(self, sink) -> None:
        """Log every placement decision (per-replica scores + chosen index)
        and every control-plane pass to a `gllm-route` JSONL stream — the
        routing counterpart of the per-replica tick traces
        (runtime/trace.py)."""
        from repro_torch.runtime.trace import (ROUTE_SCHEMA, SCHEMA_MAJOR,
                                               SCHEMA_MINOR, TraceWriter)
        assert self._trace is None, "router trace already open"
        self._trace = TraceWriter(sink)
        header = {
            "kind": "header",
            "schema": ROUTE_SCHEMA,
            "version": [SCHEMA_MAJOR, SCHEMA_MINOR],
            "replicas": len(self.replicas),
            "policy": self.policy.value,
            "capacities": list(self.capacities),
        }
        if self.rebalance_policy is not None:
            header["rebalance"] = dataclasses.asdict(self.rebalance_policy)
        if any(r != ROLE_MIXED for r in self.roles):
            header["roles"] = list(self.roles)
        if self.handoff_policy is not None:
            header["handoff"] = dataclasses.asdict(self.handoff_policy)
        if self.autoscale_policy is not None:
            header["autoscale"] = dataclasses.asdict(self.autoscale_policy)
        self._trace.write(header)

    def close_trace(self) -> None:
        if self._trace is not None:
            self._trace.close()

    # ---------------------------------------------------------------- routing
    def scores(self, prompt_tokens: int = 0,
               prompt: Optional[Sequence[int]] = None) -> List[float]:
        """Per-replica balance scores for a candidate request.  Passing the
        actual `prompt` token ids (not just the count) lets each snapshot
        probe its replica's prefix cache (`peek_prefix`, non-mutating) and
        apply the `cache_affinity` credit — cache-aware routing."""
        if prompt is not None:
            prompt_tokens = len(prompt)
        snaps = [ReplicaSnapshot.of(r, prompt) for r in self.replicas]
        self._caps_eff = discovered_capacities(
            snaps, self.capacities,
            0.0 if self._caps_declared else self.weights.discovered_rate)
        return [balance_score(s, prompt_tokens, self.weights, c)
                for s, c in zip(snaps, self._caps_eff)]

    def select(self, prompt_tokens: int = 0,
               prompt: Optional[Sequence[int]] = None) -> int:
        """Index of the replica the next request should land on (only
        prefill-capable replicas are admission candidates)."""
        if prompt is not None:
            prompt_tokens = len(prompt)
        scores: Optional[List[float]] = None
        admissible = self._admissible
        if self.policy is RoutingPolicy.ROUND_ROBIN:
            i = admissible[self._rr_next % len(admissible)]
            self._rr_next = (self._rr_next + 1) % len(admissible)
        else:
            scores = self.scores(prompt_tokens, prompt)
            i = min(admissible, key=lambda j: scores[j])
        self._routed_by_id[self.replica_ids[i]] += 1
        if self._trace is not None:
            self._trace.write({"kind": "route", "n": prompt_tokens,
                               "scores": scores, "replica": i})
        return i

    # -------------------------------------------------- control plane ticking
    @property
    def has_in_transit(self) -> bool:
        return bool(self._in_transit)

    def next_control_event(self) -> Optional[float]:
        """Earliest instant the control plane must run: the next periodic
        rebalance or handoff pass, or an in-flight transfer completing.
        None without any policy and nothing in transit."""
        cands = [t for t, *_ in self._in_transit]
        if self.rebalance_policy is not None and self._next_due is not None:
            cands.append(self._next_due)
        if self.handoff_policy is not None \
                and self._next_handoff_due is not None:
            cands.append(self._next_handoff_due)
        if self.autoscale_policy is not None \
                and self._next_autoscale_due is not None:
            cands.append(self._next_autoscale_due)
        if self._next_drain_due is not None:
            # active drains need periodic control ticks to push moves and
            # retire even when no policy supplies a cadence
            cands.append(self._next_drain_due)
        return min(cands) if cands else None

    def control_tick(self, now: float) -> None:
        """Run everything due at `now`: deliver completed transfers, push
        active drains forward, then a handoff / rebalance / autoscale pass
        if their intervals elapsed."""
        self._flush_in_transit(now)
        if self._draining:
            self._drain_pass(now)
        if self._next_drain_due is not None:
            if not self._draining:
                self._next_drain_due = None
            elif now >= self._next_drain_due:
                interval = self._drain_interval()
                missed = int((now - self._next_drain_due) // interval) + 1
                self._next_drain_due += missed * interval
        if self.handoff_policy is not None and now >= self._next_handoff_due:
            self._handoff_pass(now)
            interval = self.handoff_policy.interval
            missed = int((now - self._next_handoff_due) // interval) + 1
            self._next_handoff_due += missed * interval
        if self.rebalance_policy is not None and now >= self._next_due:
            self.rebalance(now)
            # re-anchor arithmetically: engine clocks are time.monotonic(),
            # so `now` can be arbitrarily far past the virtual-time-zero
            # anchor — a += loop would spin once per elapsed interval
            interval = self.rebalance_policy.interval
            missed = int((now - self._next_due) // interval) + 1
            self._next_due += missed * interval
        if self.autoscale_policy is not None \
                and now >= self._next_autoscale_due:
            self._autoscale_pass(now)
            interval = self.autoscale_policy.interval
            missed = int((now - self._next_autoscale_due) // interval) + 1
            self._next_autoscale_due += missed * interval

    # ---------------------------------------------------- first-decode handoff
    def _handoff_pass(self, now: float) -> None:
        """One disagg control pass: every prefill-role replica ships its
        freshly-prefilled requests (first decode: the final chunk sampled
        the first token, no decode step has run) to the decode-capable
        replica with the lowest balance score, up to the per-pass cap.
        Deferred candidates (no destination with KV headroom) stay put —
        the prefill replica keeps decoding them, and later passes retry
        until they outgrow `max_decode_tokens`."""
        pol = self.handoff_policy
        st = self.disagg_stats
        st.passes += 1
        moved = 0
        for src_i, src in enumerate(self.replicas):
            if self.roles[src_i] != ROLE_PREFILL:
                continue
            for req in handoff_candidates(src, pol, self._handoffs_of):
                if moved >= pol.handoff_batch:
                    break
                dst_i = self._pick_handoff_dst(src_i, req)
                if dst_i is None:
                    st.deferred += 1
                    continue
                if self._move_request(req.request_id, src_i, dst_i,
                                      now=now, kind="handoff"):
                    moved += 1
        if self._trace is not None and moved:
            self._trace.write({"kind": "handoff", "now": now,
                               "moved": moved})

    def _pick_handoff_dst(self, src_i: int, req: Request) -> Optional[int]:
        """Lowest-balance-score decode-capable replica that can actually
        take the request: servable, pages allocatable now, and projected
        KV headroom after absorbing everything it will still write."""
        best = None
        best_score = None
        for i, r in enumerate(self.replicas):
            if i == src_i or not decode_capable(self.roles[i]):
                continue
            if self.replica_ids[i] in self._draining:
                continue
            if not self._servable_on(r, req):
                continue
            if not r.scheduler.kv.can_allocate(req.request_id,
                                               req.num_prefilled):
                continue
            if not self._dst_headroom_ok(r, req):
                continue
            score = balance_score(ReplicaSnapshot.of(r), 0, self.weights,
                                  self._caps_eff[i])
            if best_score is None or score < best_score:
                best, best_score = i, score
        return best

    # ------------------------------------------------------------- rebalance
    def _imbalance(self, trigger_ratio: float
                   ) -> Optional[Tuple[int, int, List[float]]]:
        """(overloaded, underloaded, scores) when the spread warrants a
        move, else None."""
        pol = self.rebalance_policy
        scores = self.scores(0)
        # a draining replica may *shed* load (src) but never receive it —
        # the drain pass is emptying it
        serving = self._serving()
        if not serving:
            return None
        src = int(np.argmax(scores))
        dst = min(serving, key=lambda j: scores[j])
        if src == dst:
            return None
        if scores[src] - scores[dst] < pol.min_score_gap:
            return None
        if scores[src] <= trigger_ratio * max(scores[dst], 1e-9):
            return None
        return src, dst, scores

    def rebalance(self, now: float) -> None:
        """One control-plane pass: calibrate weights, steal waiting work,
        then live-migrate decode state while imbalance persists."""
        pol = self.rebalance_policy
        self._calibrate()
        self.rebalance_stats.passes += 1
        stolen = migrated = 0
        trigger = self._imbalance(pol.trigger_ratio)
        while trigger is not None and stolen < pol.steal_batch:
            src, dst, scores = trigger
            if not self._steal_one(src, dst, now, scores[src]):
                break
            stolen += 1
            trigger = self._imbalance(pol.trigger_ratio)
        if pol.migrate:
            trigger = self._imbalance(pol.migrate_trigger_ratio)
            while trigger is not None and migrated < pol.migrate_batch:
                src, dst, scores = trigger
                if not self._migrate_one(src, dst, now, scores[src]):
                    break
                migrated += 1
                trigger = self._imbalance(pol.migrate_trigger_ratio)
        if self._trace is not None and (stolen or migrated):
            self._trace.write({"kind": "rebalance", "now": now,
                               "stolen": stolen, "migrated": migrated,
                               "decode_tokens": self.weights.decode_tokens})

    def _calibrate(self) -> None:
        """Walk newly finished requests: retire their control-plane
        bookkeeping, and feed output lengths into a debiased EWMA ->
        decode_tokens weight (charged at half: a request's expected
        *remaining* output in steady state).  During warm-up (the first
        1/alpha completions) the EWMA is the plain running mean — a
        recency-weighted average over few samples would chase completion
        order, which anti-correlates with length (short outputs finish
        first, long ones dominate the drain tail)."""
        pol = self.rebalance_policy
        calibrate = pol is not None and pol.calibrate_decode_weight
        for ordinal, r in zip(self.replica_ids, self.replicas):
            fin = _finished_of(r)
            for req in fin[self._seen_finished.get(ordinal, 0):]:
                # move counts only matter while the request is alive
                self._migrations_of.pop(req.request_id, None)
                self._handoffs_of.pop(req.request_id, None)
                if not calibrate:
                    continue
                n = req.num_output_tokens
                self._calib_count += 1
                alpha = max(pol.ewma_alpha, 1.0 / self._calib_count)
                if self._ewma_output is None:
                    self._ewma_output = float(n)
                else:
                    self._ewma_output += alpha * (n - self._ewma_output)
            self._seen_finished[ordinal] = len(fin)
        if calibrate and self._ewma_output is not None:
            self.weights = dataclasses.replace(
                self.weights,
                decode_tokens=max(1.0, self._ewma_output / 2.0))

    # ------------------------------------------------------------- stealing
    def _servable_on(self, replica, req: Request) -> bool:
        sched = replica.scheduler
        total = req.num_effective_prompt_tokens + req.sampling.max_new_tokens
        return (total <= sched.max_model_len
                and total <= sched.kv.num_pages * sched.kv.page_size)

    def _improves_max(self, src_i: int, dst_i: int, req: Request,
                      src_score: float) -> bool:
        """A move must reduce the cluster's worst score: after receiving the
        request, the destination has to remain clearly below the source —
        otherwise the move just relocates the hot spot (and a big request
        landing on a marginally-less-loaded replica makes the tail worse)."""
        burden = (req.remaining_prefill_tokens
                  + self.weights.decode_tokens * bool(req.prefill_done))
        after = balance_score(ReplicaSnapshot.of(self.replicas[dst_i]),
                              int(burden), self.weights,
                              self._caps_eff[dst_i])
        return after < src_score

    def _dst_headroom_ok(self, dst, req: Request) -> bool:
        """KV-aware destination guard for moves that land *resident* state
        (live migration, first-decode handoff): after absorbing everything
        this request will still write (remaining prefill + all remaining
        outputs), plus the projected growth of the destination's own decode
        residents, the pool must stay out of the pressure band — shipping
        KV into a pool that is heading for its UT stall trades one hot
        spot for a worse one.  Steals of *waiting* requests skip this
        guard on purpose: they land in the destination's waiting queue
        with no KV written, the destination's own WT/UT throttle decides
        when (whether) to start them, and the dst's KV pressure already
        inflates the `_improves_max` score it must beat."""
        sched = dst.scheduler
        pool = sched.kv.num_pages * sched.kv.page_size
        need = (req.num_effective_prompt_tokens + req.sampling.max_new_tokens
                - req.num_prefilled)
        projected = sched.kv.kv_free_rate - (
            remaining_decode_growth(sched) + need) / pool
        return projected > kv_activation(self.weights,
                                         sched.cfg.kv_threshold)

    def _role_ok(self, dst_i: int, req: Request) -> bool:
        """Role guard for rebalance moves: decode residents may only move
        to decode-capable replicas; anything with prefill still ahead
        (waiting or mid-prefill) needs a prefill-capable destination —
        without this the rebalance plane would undo the disagg shape the
        handoff plane maintains."""
        role = self.roles[dst_i]
        if req.state is RequestState.DECODING:
            return decode_capable(role)
        return prefill_capable(role)

    def _steal_one(self, src_i: int, dst_i: int, now: float,
                   src_score: float) -> bool:
        """Move one *waiting* request (no device state) off the saturated
        replica.  Cheap: drain from the source queue tail, adopt at the
        destination queue tail."""
        src, dst = self.replicas[src_i], self.replicas[dst_i]
        for req in src.scheduler.steal_candidates():
            if not self._servable_on(dst, req) \
                    or not self._role_ok(dst_i, req):
                continue
            if not self._improves_max(src_i, dst_i, req, src_score):
                continue
            drained = src.scheduler.drain_request(req.request_id)
            if drained is None:
                continue
            # waiting requests carry no KV, but host-side per-request state
            # (encoder embeddings) must follow them or the destination
            # prefills without it
            state = src.backend.export_request_state(drained)
            _record_move_out(src, drained.request_id, now, "migrate")
            dst.backend.import_request_state(drained, state, resident=False)
            dst.scheduler.adopt_request(drained)
            _record_move_in(dst, drained, now, "migrate")
            _advance_replica_clock(dst, now)
            self.rebalance_stats.stolen += 1
            return True
        return False

    # ------------------------------------------------------------- migration
    def _source_pressured(self, src) -> bool:
        """Live migration moves state, so it needs *persistent* saturation,
        not a cosmetic decode-population spread: the source must still have
        admission work it cannot start (waiting queue survived the steal
        phase) or be inside the KV pressure band (resident decode is
        forcing the UT guard / preemption churn).  Without this gate a
        discovery-only straggler cluster migrates in the wrong direction —
        the *fast* replica carries more decode and looks overloaded."""
        sched = src.scheduler
        if sched.waiting:
            return True
        return sched.kv.kv_free_rate <= kv_activation(
            self.weights, sched.cfg.kv_threshold)

    @staticmethod
    def _remaining_work(req: Request) -> int:
        """Tokens the request will still produce/consume wherever it runs:
        unprefilled prompt plus unsampled output (zero prefill remainder
        for a decode resident)."""
        return (req.remaining_prefill_tokens
                + req.sampling.max_new_tokens - req.num_output_tokens)

    def _migration_candidates(self, src) -> List[Request]:
        pol = self.rebalance_policy
        if not self._source_pressured(src):
            return []
        # decode residents *and* mid-prefill requests are movable: a
        # partially-prefilled request carries its chunk cursor
        # (`num_prefilled`) and resident KV — including any adopted prefix
        # head — through drain/export, and resumes at the right chunk on
        # the destination (the disagg enabler, DESIGN.md §15)
        live = list(src.scheduler.running_decode) + [
            r for r in src.scheduler.running_prefill if r.num_prefilled > 0]
        out = [r for r in live
               if self._remaining_work(r) >= pol.min_remaining_tokens
               and self._migrations_of.get(r.request_id, 0)
               < pol.max_request_migrations]
        # most remaining work first: each transfer should buy the most
        # durable relief (ties broken toward smaller resident KV = cheaper)
        out.sort(key=lambda r: (-self._remaining_work(r), r.num_prefilled))
        return out

    def _migrate_one(self, src_i: int, dst_i: int, now: float,
                     src_score: float) -> bool:
        """Policy layer of migration: pick a candidate worth moving and
        hand it to `migrate_request`."""
        src, dst = self.replicas[src_i], self.replicas[dst_i]
        for req in self._migration_candidates(src):
            if not self._servable_on(dst, req) \
                    or not self._role_ok(dst_i, req):
                continue
            if not dst.scheduler.kv.can_allocate(req.request_id,
                                                 req.num_prefilled):
                continue
            if not self._improves_max(src_i, dst_i, req, src_score) \
                    or not self._dst_headroom_ok(dst, req):
                continue
            if self.migrate_request(req.request_id, src_i, dst_i, now=now):
                return True
        return False

    def migrate_request(self, rid: str, src_i: int, dst_i: int,
                        *, now: Optional[float] = None) -> bool:
        """Mechanism layer: live-migrate one request (§9 protocol):
        drain -> export KV addressing -> gather device pages -> free source
        -> (transfer latency) -> import at destination -> adopt, resuming at
        the current position with no recompute.  Returns False when the
        request is in flight this tick (the caller may retry next pass).
        Public so operators and tests can force a move the policy would
        not pick."""
        return self._move_request(rid, src_i, dst_i, now=now,
                                  kind="migrate")

    def _move_request(self, rid: str, src_i: int, dst_i: int, *,
                      now: Optional[float] = None,
                      kind: str = "migrate") -> bool:
        """Shared mechanism under both planes: `kind` selects the trace
        record vocabulary and the stats bucket — `"migrate"` for the
        rebalance control plane, `"handoff"` for the disagg prefill ->
        decode transfer (identical wire format, distinct intent)."""
        if now is None:
            now = self._clock()
        src = self.replicas[src_i]
        taken = take_out(src, rid)
        if taken is None:
            return False
        drained, export, payload, state = taken
        if export is None:
            # nothing resident (a waiting request): this is just a steal
            dst = self.replicas[dst_i]
            _record_move_out(src, rid, now, kind)
            dst.backend.import_request_state(drained, state, resident=False)
            dst.scheduler.adopt_request(drained)
            _record_move_in(dst, drained, now, kind)
            _advance_replica_clock(dst, now)
            self.rebalance_stats.stolen += 1
            return True
        delay = src.backend.migration_cost(export.num_tokens)
        _record_move_out(src, rid, now, kind)
        if kind == "handoff":
            self._handoffs_of[rid] = self._handoffs_of.get(rid, 0) + 1
            self.disagg_stats.handoffs += 1
            self.disagg_stats.handoff_tokens += export.num_tokens
        else:
            self._migrations_of[rid] = self._migrations_of.get(rid, 0) + 1
            self.rebalance_stats.migrated += 1
            self.rebalance_stats.migrated_tokens += export.num_tokens
        if delay <= 0.0:
            self._deliver(dst_i, drained, export, payload, state, now, kind)
        else:
            heapq.heappush(self._in_transit,
                           (now + delay, next(self._transit_seq),
                            self.replica_ids[dst_i],
                            drained, export, payload, state, kind))
        return True

    def _flush_in_transit(self, now: float) -> None:
        while self._in_transit and self._in_transit[0][0] <= now:
            at, _, dst_ord, req, export, payload, state, kind = heapq.heappop(
                self._in_transit)
            dst_i = self._index_of(dst_ord)
            if dst_i is None or dst_ord in self._draining:
                # the destination drained/retired while the payload was on
                # the wire: re-home the delivery instead of dropping it —
                # the source already freed its pages, so this host-held
                # copy is the only live form of the request
                dst_i = self._rehome_dst(req)
                self.autoscale_stats.rehomed += 1
            self._deliver(dst_i, req, export, payload, state,
                          max(at, now), kind)

    def _rehome_dst(self, req: Request) -> int:
        """Pick a fresh destination for an orphaned in-transit delivery:
        lowest-score serving replica whose role can hold the request (the
        `_deliver` fallback path absorbs any KV shortfall by degrading to
        recompute admission, so headroom is a preference, not a guard)."""
        cands = [i for i in self._serving()
                 if self._role_ok(i, req)
                 and self._servable_on(self.replicas[i], req)]
        if not cands:   # no serving replica fits: any serving role-ok one
            cands = [i for i in self._serving() if self._role_ok(i, req)]
        if not cands:
            raise RuntimeError(
                f"no serving replica can adopt in-transit request "
                f"{req.request_id!r}")
        scores = self.scores(0)
        good = [i for i in cands
                if self._dst_headroom_ok(self.replicas[i], req)]
        return min(good or cands, key=lambda i: scores[i])

    def _deliver(self, dst_i: int, req: Request, export: KVExport,
                 payload: Any, state: Any, now: float,
                 kind: str = "migrate") -> None:
        dst = self.replicas[dst_i]
        if not put_in(dst, req, export, payload, state):
            # destination capacity shrank in transit: fall back to recompute
            # admission (correctness preserved — outputs fold into the
            # effective prompt exactly like a preemption).  resident=False:
            # recompute rebuilds recurrent state from scratch, so only
            # recompute-surviving state (encoder embeddings) attaches.
            req.preempt()
            if kind == "handoff":
                self.disagg_stats.fallbacks += 1
            else:
                self.rebalance_stats.migration_fallbacks += 1
            dst.backend.import_request_state(req, state, resident=False)
        dst.scheduler.adopt_request(req)
        _record_move_in(dst, req, now, kind)
        _advance_replica_clock(dst, now)

    # ------------------------------------------------- elastic lifecycle (§16)
    def add_replica_hook(self, fn: Callable[[Any, int, float], None]) -> None:
        """Register `fn(replica, ordinal, now)` to run on every replica the
        autoscaler adds — the integration seam: `SimCluster` namespaces the
        rid stream and attaches the per-replica trace; `LLMServer` wires
        token/preempt callbacks."""
        self._add_hooks.append(fn)

    def add_replica(self, now: Optional[float] = None) -> int:
        """Grow the fleet by one replica from `replica_factory` (role
        `mixed`, unit capacity — elastic replicas are the homogeneous pool;
        heterogeneous hints belong to the static fleet).  Returns the new
        replica's index."""
        if self.replica_factory is None:
            raise RuntimeError("ReplicaRouter has no replica_factory; "
                               "cannot scale up")
        if now is None:
            now = self._clock()
        ordinal = self._next_ordinal
        self._next_ordinal += 1
        replica = self.replica_factory(ordinal)
        self.replicas.append(replica)
        self.replica_ids.append(ordinal)
        self.capacity_hints.append(1.0)
        self.capacities.append(1.0)
        self._caps_eff.append(1.0)
        self.roles = self.roles + (ROLE_MIXED,)
        self._routed_by_id[ordinal] = 0
        self._seen_finished[ordinal] = 0
        for hook in self._add_hooks:
            hook(replica, ordinal, now)
        rec = getattr(replica, "recorder", None)
        if rec is not None:     # first record of the newborn's trace stream
            rec.record_scale_event("scale_up", now)
        self.autoscale_stats.replicas_added += 1
        self.autoscale_stats.note(now, "scale_up", len(self._serving()))
        if self._trace is not None:
            self._trace.write({"kind": "scale_up", "now": now,
                               "replica": ordinal,
                               "fleet": len(self._serving())})
        return len(self.replicas) - 1

    def start_drain(self, i: int, now: Optional[float] = None) -> None:
        """Begin retiring replica `i`: mask it from admission and from
        control-plane destinations; subsequent control ticks move its work
        off (waiting requests are stolen, residents live-migrated) and
        retire it once empty.  Refuses a drain that would leave the serving
        fleet without prefill or decode cover (§15 roles)."""
        ordinal = self.replica_ids[i]
        if ordinal in self._draining:
            raise ValueError(f"replica {ordinal} is already draining")
        if now is None:
            now = self._clock()
        serving = self._serving()
        serving_roles = [self.roles[j] for j in serving]
        if len(serving) <= 1 or not retirable(serving_roles,
                                              serving.index(i)):
            raise ValueError(
                f"draining replica {ordinal} would leave the fleet without "
                f"prefill or decode cover (serving roles: {serving_roles})")
        self._draining.add(ordinal)
        if self._next_drain_due is None:
            self._next_drain_due = now + self._drain_interval()
        self.autoscale_stats.drains_started += 1
        self.autoscale_stats.note(now, "drain", len(self._serving()))
        _record_scale(self.replicas[i], "drain", now)
        if self._trace is not None:
            self._trace.write({"kind": "drain", "now": now,
                               "replica": ordinal,
                               "fleet": len(self._serving())})

    def _drain_interval(self) -> float:
        """Cadence of drain pushes: the autoscaler's interval when the
        drain came from the policy loop, a fixed 50ms for manual drains."""
        return (self.autoscale_policy.interval
                if self.autoscale_policy is not None else 0.05)

    def _drain_dst(self, victim_i: int, req: Request) -> Optional[int]:
        """Destination for work leaving a draining replica.  Unlike the
        rebalance plane's moves, drains are *mandatory* — the victim must
        empty — so headroom is a preference, not a gate: prefer serving
        replicas whose projected KV absorbs the request, but fall back to
        any serving role-compatible one (`_deliver` degrades to recompute
        admission if its pool shrank by arrival time)."""
        cands = [i for i in self._serving()
                 if i != victim_i and self._role_ok(i, req)
                 and self._servable_on(self.replicas[i], req)]
        if not cands:
            return None
        scores = self.scores(0)
        good = [i for i in cands
                if self._dst_headroom_ok(self.replicas[i], req)]
        return min(good or cands, key=lambda i: scores[i])

    def _drain_move(self, victim_i: int, dst_i: int, req: Request,
                    now: float) -> bool:
        """One forced move off a draining replica (kept as a single seam so
        chaos tests can fault-inject a broken drain)."""
        return self._move_request(req.request_id, victim_i, dst_i,
                                  now=now, kind="migrate")

    def _drain_pass(self, now: float) -> None:
        """Push every active drain forward: move the victim's waiting queue
        and resident prefill/decode state to serving replicas (up to
        `drain_batch` per pass — in-flight requests are undrainable this
        tick and retry next pass), then retire victims that emptied."""
        cap = self.autoscale_policy.drain_batch \
            if self.autoscale_policy is not None else 16
        for ordinal in sorted(self._draining):
            i = self._index_of(ordinal)
            victim = self.replicas[i]
            sched = victim.scheduler
            moved = 0
            # waiting first (cheap, no KV on the wire), then residents
            candidates = (list(sched.waiting) + list(sched.running_decode)
                          + list(sched.running_prefill))
            for req in candidates:
                if moved >= cap:
                    break
                dst_i = self._drain_dst(i, req)
                if dst_i is None:
                    continue
                if self._drain_move(i, dst_i, req, now):
                    moved += 1
            self.autoscale_stats.drain_moves += moved
            self._try_retire(ordinal, now)

    def _try_retire(self, ordinal: int, now: float) -> bool:
        """Retire a draining replica iff nothing references it anymore: no
        scheduler work, no in-flight ticks, nothing in transit toward it.
        The replica object moves to `self.retired` so its finished-request
        history stays part of the cluster's accounting."""
        i = self._index_of(ordinal)
        victim = self.replicas[i]
        if victim.has_work or victim.busy:
            return False
        if any(entry[2] == ordinal for entry in self._in_transit):
            return False
        # final bookkeeping sweep before the finished list freezes
        for req in _finished_of(victim)[self._seen_finished.get(ordinal, 0):]:
            self._migrations_of.pop(req.request_id, None)
            self._handoffs_of.pop(req.request_id, None)
        self._seen_finished.pop(ordinal, None)
        _record_scale(victim, "retire", now)
        rec = getattr(victim, "recorder", None)
        if rec is not None:
            rec.close()     # `retire` is the stream's last record
        del self.replicas[i]
        del self.replica_ids[i]
        del self.capacities[i]
        del self.capacity_hints[i]
        del self._caps_eff[i]
        self.roles = self.roles[:i] + self.roles[i + 1:]
        self._draining.discard(ordinal)
        self.retired.append(victim)
        self.autoscale_stats.retired += 1
        self.autoscale_stats.note(now, "retire", len(self._serving()))
        if self._trace is not None:
            self._trace.write({"kind": "retire", "now": now,
                               "replica": ordinal,
                               "fleet": len(self._serving())})
        return True

    def _autoscale_pass(self, now: float) -> None:
        """One autoscale decision on the EWMA of fleet pressure: grow on
        sustained overload, start (at most one) drain on sustained
        underload.  Hysteresis = threshold gap + per-direction cooldowns;
        the drain victim is the lowest-pressure replica whose removal keeps
        role cover."""
        pol = self.autoscale_policy
        self.autoscale_stats.passes += 1
        serving = self._serving()
        p = fleet_pressure([self.replicas[i] for i in serving], pol)
        if self._pressure_ewma is None:
            self._pressure_ewma = p
        else:
            self._pressure_ewma += pol.ewma_alpha * (p - self._pressure_ewma)
        ewma = self._pressure_ewma
        n = len(serving)
        if (ewma > pol.up_threshold and n < pol.max_replicas
                and now - self._last_scale_up >= pol.up_cooldown
                and self.replica_factory is not None):
            step = scale_up_step(n, ewma, pol)
            for _ in range(step):
                self.add_replica(now)
            if step:
                self.autoscale_stats.scale_ups += 1
                self._last_scale_up = now
            return
        if (ewma < pol.down_threshold and n > pol.min_replicas
                and not self._draining
                and now - self._last_scale_down >= pol.down_cooldown):
            victims = sorted(
                serving,
                key=lambda i: replica_pressure(self.replicas[i], pol))
            roles = [self.roles[i] for i in serving]
            for i in victims:
                if retirable(roles, serving.index(i)):
                    self.start_drain(i, now)
                    self._last_scale_down = now
                    break

    def check_invariants(self,
                         expected_rids: Optional[Sequence[str]] = None
                         ) -> None:
        """Cluster-wide conservation audit (the chaos suite runs this after
        every operation): every per-replica scheduler invariant holds, no
        request id appears in two places at once (across all waiting /
        running groups and the in-transit heap), no id finishes twice, and
        — when `expected_rids` is given — every submitted request is
        accounted for somewhere (alive, in transit, or finished)."""
        alive: Dict[str, str] = {}

        def see(rid: str, where: str) -> None:
            if rid in alive:
                raise AssertionError(
                    f"request {rid!r} is both {alive[rid]} and {where}")
            alive[rid] = where

        for ordinal, r in zip(self.replica_ids, self.replicas):
            sched = r.scheduler
            sched.check_invariants()
            local: Dict[str, str] = {}
            for group, name in ((sched.waiting, "waiting"),
                                (sched.running_prefill, "running_prefill"),
                                (sched.running_decode, "running_decode")):
                for req in group:
                    if req.request_id in local:
                        raise AssertionError(
                            f"request {req.request_id!r} is both "
                            f"{local[req.request_id]} and {name} on "
                            f"replica{ordinal}")
                    local[req.request_id] = name
            # mid-tick, a request whose *final* prefill chunk is in flight
            # has left `waiting` but not yet entered `running_decode` — it
            # is alive only in the scheduled batch (a decode/chunk seq also
            # appears in its running list, hence setdefault, not see)
            for bid in sched.active_batch_ids():
                for seq in sched.get_batch(bid).seqs:
                    local.setdefault(seq.request.request_id, "in-flight")
            for rid, name in local.items():
                see(rid, f"replica{ordinal}:{name}")
        for entry in self._in_transit:
            see(entry[3].request_id, "in-transit")
        counts: Dict[str, int] = {}
        for req in self.finished:
            counts[req.request_id] = counts.get(req.request_id, 0) + 1
        dups = sorted(rid for rid, c in counts.items() if c > 1)
        if dups:
            raise AssertionError(f"requests finished more than once: {dups}")
        both = sorted(set(alive) & set(counts))
        if both:
            raise AssertionError(
                f"requests both alive and finished: {both}")
        if expected_rids is not None:
            seen = set(alive) | set(counts)
            missing = sorted(set(expected_rids) - seen)
            if missing:
                raise AssertionError(f"requests lost (not alive, in "
                                     f"transit, or finished): {missing}")

    # ---------------------------------------------------------------- abort
    def abort_request(self, rid: str) -> bool:
        """Abort a request anywhere in the cluster: on whichever replica
        holds it (waiting — including a stolen request sitting in a
        destination queue — or running), or *mid-migration* while its KV
        payload is in transit between replicas.

        The in-transit case is the one only the router can see: the source
        already exported-and-freed the pages and released the request's
        state slot, the destination has allocated nothing yet, so dropping
        the queued delivery leaks nothing — the payload and exported state
        are host-held copies.  Without this path the delivery would land
        after the abort and permanently re-admit a request nobody wants
        (re-acquiring pages and a slot on the destination).
        """
        for i, entry in enumerate(self._in_transit):
            req = entry[3]
            if req.request_id == rid:
                self._in_transit.pop(i)
                heapq.heapify(self._in_transit)
                self._migrations_of.pop(rid, None)
                self._handoffs_of.pop(rid, None)
                req.state = RequestState.FINISHED_ABORTED
                req.metrics.finish_time = self._clock()
                self._aborted.append(req)
                return True
        for replica in self.replicas:
            if _abort_on_replica(replica, rid):
                self._migrations_of.pop(rid, None)
                self._handoffs_of.pop(rid, None)
                return True
        return False

    # ------------------------------------------------- engine-cluster surface
    def add_request(self, prompt: Sequence[int],
                    sampling: Optional[SamplingParams] = None,
                    request_id: Optional[str] = None, **kw) -> Request:
        i = self.select(len(prompt), prompt=prompt)
        return self.replicas[i].add_request(prompt, sampling, request_id,
                                            **kw)

    @property
    def scheduler(self):
        """Single-replica compatibility: the scheduler when fronting one
        replica (ambiguous otherwise)."""
        if len(self.replicas) != 1:
            raise AttributeError(
                "ReplicaRouter fronts multiple replicas; inspect "
                ".replicas[i].scheduler")
        return self.replicas[0].scheduler

    @property
    def has_work(self) -> bool:
        return any(r.has_work for r in self.replicas) or self.has_in_transit

    @property
    def busy(self) -> bool:
        return any(r.busy for r in self.replicas)

    def _clock(self) -> float:
        return max(r.backend.clock() for r in self.replicas)

    def step(self) -> List[Request]:
        """One tick on every replica that has work (the single-process
        analogue of N independent driver loops), preceded by any due
        control-plane work on the backend clock."""
        if self.rebalance_policy is not None \
                or self.handoff_policy is not None \
                or self.autoscale_policy is not None \
                or self._draining or self._in_transit:
            self.control_tick(self._clock())
        out: List[Request] = []
        for r in self.replicas:
            if r.has_work or r.busy:
                out.extend(r.step())
        return out

    def drain(self, max_ticks: int = 100000) -> List[Request]:
        out: List[Request] = []
        t = 0
        while (self.has_work or self.busy) and t < max_ticks:
            out.extend(self.step())
            t += 1
        return out

    @property
    def finished(self) -> List[Request]:
        out: List[Request] = []
        for r in self.replicas:
            out.extend(_finished_of(r))
        for r in self.retired:     # history survives the replica's retirement
            out.extend(_finished_of(r))
        out.extend(self._aborted)
        return out


# --------------------------------------------------------------------------
# Replica plumbing helpers (engines and simulators expose slightly different
# surfaces; the control plane treats them uniformly through these)
# --------------------------------------------------------------------------

def _finished_of(replica) -> List[Request]:
    fin = getattr(replica, "finished", None)
    if fin is not None:
        return fin
    return replica.metrics.finished


def _abort_on_replica(replica, rid: str) -> bool:
    """Abort through the replica's own entry point when it has one (engines
    and simulators serialize against their tick/trace machinery); fall back
    to the bare scheduler + backend release for test doubles."""
    fn = getattr(replica, "abort_request", None)
    if fn is not None:
        return bool(fn(rid))
    req = replica.scheduler.abort_request(rid, replica.backend.clock())
    if req is None:
        return False
    if req.is_finished:
        replica.backend.finish_request(req)
    return True


def take_out(src, rid: str) -> Optional[tuple]:
    """The export half of moving request `rid` off engine `src` (the
    router's migration and hand-off, and a move between processes): settle
    an async engine (it holds its last tick's requests in flight until its
    next step), drain the request and, when it holds KV, gather its pages
    and state and free them.  Returns ``(request, export, payload,
    state)``, export and payload None for a request with nothing resident
    (a waiting one), or None when the request is in flight this tick."""
    _settle(src)
    req = src.scheduler.drain_request(rid)
    if req is None:
        return None
    kv = src.scheduler.kv
    if not kv.has_request(rid):
        return req, None, None, src.backend.export_request_state(req)
    export = kv.export_kv(rid)
    payload = src.backend.export_kv_pages(rid, export.slots)
    state = src.backend.export_request_state(req)
    kv.free(rid)
    return req, export, payload, state


def put_in(dst, req: Request, export: KVExport, payload: Any,
           state: Any) -> bool:
    """The delivery half: allocate `req`'s tokens on engine `dst`
    (`import_kv`) and write its pages and state in place.  False, holding
    nothing, when `dst` has no room for them.  The caller adopts `req`."""
    kv = dst.scheduler.kv
    rid = req.request_id
    if not kv.can_allocate(rid, export.num_tokens):
        return False
    slots = kv.import_kv(export)
    try:
        dst.backend.import_kv_pages(rid, payload, slots)
        dst.backend.import_request_state(req, state)
    except MemoryError:
        # destination ran out of per-request device state (e.g.
        # recurrent-state slots, which the KV headroom checks don't
        # cover): release the pages
        kv.free(rid)
        return False
    return True


def _settle(replica) -> None:
    """Retire the replica's deferred tick, if it defers one (the port's
    async engines; `PipelineEngine.settle`)."""
    fn = getattr(replica, "settle", None)
    if fn is not None:
        fn()


def _advance_replica_clock(replica, now: float) -> None:
    """A request materialized on this replica at `now` by control-plane
    action (not an arrival): virtual-time backends must not tick earlier
    than that.  Wall-clock backends ignore it."""
    fn = getattr(replica, "advance_clock", None)
    if fn is not None:
        fn(now)


def _record_move_out(replica, rid: str, now: float, kind: str) -> None:
    rec = getattr(replica, "recorder", None)
    if rec is not None:
        rec.record_move_out(rid, now, kind=kind)


def _record_move_in(replica, req: Request, now: float, kind: str) -> None:
    rec = getattr(replica, "recorder", None)
    if rec is not None:
        rec.record_move_in(req, now, kind=kind)


def _record_scale(replica, kind: str, now: float) -> None:
    rec = getattr(replica, "recorder", None)
    if rec is not None:
        rec.record_scale_event(kind, now)


class SimCluster:
    """N `PipelineSimulator` replicas behind a `ReplicaRouter`, driven in
    causally-consistent virtual time: each arrival first advances every
    replica to the arrival instant, then routes on the resulting state.
    Control-plane events (periodic rebalance passes, migration deliveries)
    are interleaved at their own instants the same way."""

    def __init__(self, sims: Sequence[Any], router: ReplicaRouter,
                 *, trace_dir: Optional[str] = None) -> None:
        # the router's replica list is authoritative — the autoscaler
        # mutates it (add/retire) and the cluster must track those changes,
        # so `self.sims` is a live view, not a copy
        if list(sims) != router.replicas:
            raise ValueError(
                "SimCluster must front the router's own replica list")
        self.router = router
        for ordinal, sim in zip(router.replica_ids, self.sims):
            # migration needs cluster-unique request ids: namespace each
            # replica's default id stream (engines already share a
            # process-wide counter)
            if getattr(sim, "rid_prefix", None) == "r":
                sim.rid_prefix = f"r{ordinal}:"
        self._trace_dir = trace_dir
        if trace_dir is not None:
            # one tick trace per replica + the router's placement stream —
            # together they capture the whole cluster run for offline replay
            import os
            os.makedirs(trace_dir, exist_ok=True)
            for ordinal, sim in zip(router.replica_ids, self.sims):
                sim.attach_trace(
                    os.path.join(trace_dir, f"replica{ordinal}.trace.jsonl"))
            if router._trace is None:
                router.open_trace(
                    os.path.join(trace_dir, "router.trace.jsonl"))
        router.add_replica_hook(self._on_add_replica)

    @property
    def sims(self) -> List[Any]:
        return self.router.replicas

    def _on_add_replica(self, sim, ordinal: int, now: float) -> None:
        """Bring an autoscaler-added simulator into the cluster: namespaced
        rid stream, its own trace file, clock advanced to its birth instant
        (it must not tick in the past)."""
        if getattr(sim, "rid_prefix", None) == "r":
            sim.rid_prefix = f"r{ordinal}:"
        if self._trace_dir is not None:
            import os
            sim.attach_trace(os.path.join(
                self._trace_dir, f"replica{ordinal}.trace.jsonl"))
        sim.advance_clock(now)

    def _advance_to(self, t: float) -> None:
        """Advance every replica to `t`, running control-plane events
        (rebalance passes, migration deliveries) at their due instants."""
        while True:
            due = self.router.next_control_event()
            if due is None or due > t:
                break
            for sim in self.sims:
                sim.run_until(due)
            self.router.control_tick(due)
        for sim in self.sims:
            sim.run_until(t)

    @property
    def _cluster_busy(self) -> bool:
        return self.router.has_in_transit or bool(self.router._draining) \
            or any(s.sched.has_work or s.loop.busy or s._arrivals
                   for s in self.sims)

    # ------------------------------------------------- engine-compatible API
    # The serving layer drives a sim cluster through the same surface as a
    # single engine: submissions are placed by the router at the cluster's
    # current virtual instant; one `step()` advances the earliest-due
    # replica (control-plane events interleaved at their own instants).

    @property
    def replicas(self) -> List[Any]:
        return self.sims

    @property
    def has_work(self) -> bool:
        return self._cluster_busy

    @property
    def busy(self) -> bool:
        return any(s.loop.busy for s in self.sims)

    def add_request(self, prompt: Sequence[int],
                    sampling: Optional[SamplingParams] = None,
                    request_id: Optional[str] = None) -> Request:
        # causality: route on the state every replica has reached by "now"
        t = max(s.backend.time for s in self.sims)
        self._advance_to(t)
        return self.router.add_request(prompt, sampling, request_id)

    def abort_request(self, rid: str) -> bool:
        return self.router.abort_request(rid)

    def _finished_marks(self) -> Dict[Any, int]:
        """Per-source finished-list lengths (every replica — live *or*
        retired — plus the router's in-transit-aborted list), keyed by the
        source object: new finishes land in *whichever* source's list, the
        fleet can change size between marks, and a replica can finish work
        and then retire within one step — so the marks must survive both."""
        marks: Dict[Any, int] = {
            id(s): len(s.metrics.finished)
            for s in itertools.chain(self.sims, self.router.retired)}
        marks["aborted"] = len(self.router._aborted)
        return marks

    def _finished_since(self, marks: Dict[Any, int]) -> List[Request]:
        out: List[Request] = []
        for sim in itertools.chain(self.sims, self.router.retired):
            out.extend(sim.metrics.finished[marks.get(id(sim), 0):])
        out.extend(self.router._aborted[marks.get("aborted", 0):])
        return out

    def step(self) -> List[Request]:
        """Advance the cluster by one event: every replica runs to the
        earliest pending tick instant (control-plane events — rebalance
        passes, migration deliveries — fire at their due times on the way)."""
        marks = self._finished_marks()
        pending = [s for s in self.sims
                   if s.sched.has_work or s.loop.busy or s._arrivals]
        if pending:
            self._advance_to(min(s._next_tick_time() for s in pending))
        elif self.router.has_in_transit or self.router._draining:
            due = self.router.next_control_event()
            if due is not None:
                self._advance_to(due)
                self.router.control_tick(due)
        return self._finished_since(marks)

    def drain(self, max_ticks: int = 1_000_000) -> List[Request]:
        marks = self._finished_marks()
        last = None
        for _ in range(max_ticks):
            if not self._cluster_busy:
                break
            self.step()
            # wedge guard: identical clocks + frontiers + completions across
            # two steps means nothing can unblock (e.g. every waiting request
            # UT-gated with no decode to retire) — stop instead of spinning
            state = (tuple((s.backend.time, s.backend.stage_free_at[0])
                           for s in self.sims),
                     self._finished_marks(), len(self.router._in_transit))
            if state == last:
                break
            last = state
        return self._finished_since(marks)

    def run(self, arrivals: Iterable[Tuple],
            until: float = float("inf")) -> List[Request]:
        """arrivals: (time, prompt_tokens, output_len[, sampling]), any
        order — the optional 4th element is a `SamplingParams` (SLO class,
        priority, ...).  Returns all finished requests across replicas."""
        t = 0.0
        for t, prompt, out_len, *rest in sorted(arrivals,
                                                key=lambda a: a[0]):
            if t > until:
                break
            self._advance_to(t)
            i = self.router.select(len(prompt), prompt=prompt)
            self.sims[i].inject_request(t, prompt, out_len, *rest)
        intervals = [p.interval for p in (self.router.rebalance_policy,
                                          self.router.handoff_policy,
                                          self.router.autoscale_policy)
                     if p is not None]
        if not intervals:
            for sim in self.sims:
                sim.run(until)
            return self.finished
        # drain with the control plane still ticking: advance in interval
        # steps so rebalance/handoff keep seeing fresh state until the last
        # replica goes idle
        step = min(intervals)
        for _ in range(10_000_000):
            if not self._cluster_busy or t > until:
                break
            t += step
            self._advance_to(min(t, until))
        for sim in self.sims:
            sim.run(until)
        return self.finished

    @property
    def finished(self) -> List[Request]:
        out: List[Request] = []
        for sim in itertools.chain(self.sims, self.router.retired):
            out.extend(sim.metrics.finished)
        out.extend(self.router._aborted)   # aborted while in transit
        return out

    # ------------------------------------------------------------- aggregates
    def ttft_quantile(self, q: float) -> float:
        vals = [r.metrics.ttft() for r in self.finished
                if r.metrics.ttft() is not None]
        return float(np.quantile(vals, q)) if vals else 0.0

    def mean_ttft(self) -> float:
        vals = [r.metrics.ttft() for r in self.finished
                if r.metrics.ttft() is not None]
        return float(np.mean(vals)) if vals else 0.0

    def throughput(self) -> float:
        return float(sum(s.metrics.throughput()
                         for s in itertools.chain(self.sims,
                                                  self.router.retired)))
