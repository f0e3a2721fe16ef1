"""Discrete-event simulator of the pipeline-parallel serving runtime.

A copy of ``repro.runtime.simulator``: the port keeps its own so that it
imports nothing of the JAX package.  Its roofline rates are the H100's
(`roofline/analysis.py`: HBM bandwidth, bf16 tensor-core peak, an NVLink
direction as the interconnect) in place of the JAX module's TPU constants;
its efficiencies and floors are the JAX module's values.

Reproduces the paper's evaluation methodology at cluster scale on a CPU-only
box: the *real* `PipelineScheduler` (Token Throttling or Sarathi policy — the
actual policy code, not a model of it) drives the shared `TickLoop`
(runtime/core.py) over a `SimBackend` whose per-stage latency comes from a
roofline cost model at the card's data-sheet rates.

Stage semantics match the SPMD tick: a micro-batch occupies one stage at a
time; stage s starts batch b when (a) stage s-1 finished b and (b) stage s
finished its previous batch.  Inter-batch imbalance therefore creates exactly
the bubbles of paper Fig. 3, and Token Throttling's equalized token counts
remove them.  The depth-S ring bounds in-flight micro-batches to the pipeline
depth, exactly like the engine.

Also models: the serving loop's host overhead (serialized for the
vLLM-like runtime, overlapped for the gLLM runtime — paper §3.4's 17%
input-prep cost), pod failures (in-flight work lost, recompute on
recovery), and straggler stages.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import (
    PagedKVManager,
    PipelineScheduler,
    PrefillPolicy,
    Request,
    SamplingParams,
    ScheduledBatch,
    ThrottleConfig,
)
from repro_torch.roofline.analysis import HBM_BW, NVLINK_BW, PEAK_FLOPS
from repro_torch.runtime.core import ExecResult, ExecutionBackend, TickLoop


@dataclass
class CostModel:
    """Per-stage latency of one micro-batch (roofline form).

    `mfu`, `hbm_eff` and `fixed_us` are the model's assumptions (the JAX
    module's values, kept so that both packages simulate alike), not a
    measurement of any card: `fit_from_trace` calibrates them from a trace
    with per-stage latencies."""

    flops_per_token_stage: float      # 2*N_active/pp
    param_bytes_stage: float          # active weight bytes read per tick
    kv_bytes_per_ctx_token: float     # per context token per stage
    chips_per_stage: int = 1
    mfu: float = 0.55                 # achievable compute efficiency
    hbm_eff: float = 0.75
    fixed_us: float = 30.0            # kernel launch / sync floor
    # tensor-parallel baseline: per-token activation all-reduce traffic plus
    # a per-step latency floor (2 all-reduces per layer; each costs
    # ~2(N-1) link latencies regardless of payload — dominant for decode on
    # cross-node fabrics).  PP only communicates inter-stage activations
    # (tiny, overlapped) — exactly the tradeoff the paper exploits (§2.3).
    comm_bytes_per_token: float = 0.0
    comm_latency: float = 0.0         # per-tick serialized all-reduce latency
    net_bw: float = NVLINK_BW         # interconnect (NVLink / sim-network)
    # Paged-attention depth term (DESIGN.md §14).  When > 0, attention HBM
    # traffic is billed per *scanned KV page* (attn_page_bytes each) instead
    # of per context token — mirroring the engine, whose depth-bucketed
    # tables + dead-page-skipping kernel make cost track pages walked, not
    # the pool maximum.  0 keeps the legacy per-token formula (and every
    # previously fitted model / golden fixture) bit-for-bit unchanged.
    attn_page_bytes: float = 0.0
    page_size: int = 16               # tokens per KV page (for the estimator)

    def est_scanned_pages(self, prefill_tokens: int, decode_tokens: int,
                          prefill_ctx: int, decode_ctx: int) -> float:
        """Scanned KV pages per stage estimated from the batch aggregates a
        `TickSample` records — the *same* estimator backs `stage_time` (when
        no exact count is passed), `fit_from_trace`, and
        `calibration_error`, so sim, fit, and validation bill one term."""
        pg = max(self.page_size, 1)
        pages = 0.0
        if decode_tokens:
            pages += decode_tokens * float(-(-max(decode_ctx, 1) // pg))
        if prefill_tokens:
            pages += float(-(-int(prefill_tokens * 0.5 * max(prefill_ctx, 1))
                             // pg))
        return pages

    def stage_time(self, prefill_tokens: int, decode_tokens: int,
                   prefill_ctx: int, decode_ctx: int,
                   scanned_pages: Optional[float] = None) -> float:
        tokens = prefill_tokens + decode_tokens
        t_comp = tokens * self.flops_per_token_stage / (
            PEAK_FLOPS * self.mfu * self.chips_per_stage)
        if self.attn_page_bytes > 0.0:
            pages = (scanned_pages if scanned_pages is not None else
                     self.est_scanned_pages(prefill_tokens, decode_tokens,
                                            prefill_ctx, decode_ctx))
            kv_bytes = pages * self.attn_page_bytes
        else:
            kv_bytes = (prefill_tokens * 0.5 * prefill_ctx
                        + decode_tokens * decode_ctx
                        ) * self.kv_bytes_per_ctx_token
        weight_bytes = self.param_bytes_stage if tokens else 0.0
        t_mem = (weight_bytes + kv_bytes) / (
            HBM_BW * self.hbm_eff * self.chips_per_stage)
        t_comm = tokens * self.comm_bytes_per_token / self.net_bw
        if tokens and self.comm_bytes_per_token:
            t_comm += self.comm_latency
        return max(t_comp, t_mem) + t_comm + self.fixed_us * 1e-6

    def scaled(self, factor: float) -> "CostModel":
        """A uniformly `factor`x slower copy (heterogeneous-replica modeling:
        older silicon, thermal throttling, fewer chips per stage)."""
        import dataclasses
        return dataclasses.replace(
            self, mfu=self.mfu / factor, hbm_eff=self.hbm_eff / factor,
            fixed_us=self.fixed_us * factor)

    @classmethod
    def fit_from_trace(cls, trace, base: "CostModel", *, iters: int = 60
                       ) -> "CostModel":
        """Calibrate the roofline efficiencies from a recorded trace.

        The structural constants (FLOPs/bytes per token per stage) come from
        `base` — they are architecture facts, not free parameters; what a
        trace identifies is how efficiently the hardware achieved them:
        `mfu`, `hbm_eff`, and the fixed per-tick floor.  Fitting alternates
        regime assignment (compute- vs memory-bound under the current
        parameters) with per-regime least squares, exactly the structure of
        `stage_time`.  A trace that never visits one regime leaves that
        regime's efficiency at the base value (it is unidentifiable).

        Closes the sim-vs-engine loop: `calibration_error(trace, fitted)`
        (runtime/trace.py) bounds how well the returned model reproduces the
        recorded per-tick latencies.
        """
        import dataclasses

        from repro_torch.runtime.trace import tick_samples

        samples = tick_samples(trace)
        if not samples:
            raise ValueError("trace has no ticks with stage latencies")
        F = np.empty(len(samples))      # compute seconds at mfu = 1
        M = np.empty(len(samples))      # memory seconds at hbm_eff = 1
        comm = np.empty(len(samples))
        y = np.empty(len(samples))      # observed per-stage service time
        for i, s in enumerate(samples):
            tokens = s.prefill_tokens + s.decode_tokens
            F[i] = tokens * base.flops_per_token_stage / (
                PEAK_FLOPS * base.chips_per_stage)
            if base.attn_page_bytes > 0.0:
                # structural constant like the per-token rate: the fit keeps
                # the same per-page billing `stage_time` uses
                kv_bytes = base.attn_page_bytes * base.est_scanned_pages(
                    s.prefill_tokens, s.decode_tokens,
                    s.prefill_ctx, s.decode_ctx)
            else:
                kv_bytes = (s.prefill_tokens * 0.5 * s.prefill_ctx
                            + s.decode_tokens * s.decode_ctx
                            ) * base.kv_bytes_per_ctx_token
            M[i] = (base.param_bytes_stage + kv_bytes) / (
                HBM_BW * base.chips_per_stage)
            comm[i] = tokens * base.comm_bytes_per_token / base.net_bw
            if tokens and base.comm_bytes_per_token:
                comm[i] += base.comm_latency
            y[i] = s.stage_time

        mfu, hbm_eff = base.mfu, base.hbm_eff
        fixed = base.fixed_us * 1e-6
        for _ in range(iters):
            resid = np.maximum(y - comm - fixed, 1e-12)
            compute_bound = F / mfu >= M / hbm_eff
            for mask, num in ((compute_bound, F), (~compute_bound, M)):
                if mask.any():
                    denom = float((num[mask] * resid[mask]).sum())
                    if denom > 0:
                        eff = float((num[mask] ** 2).sum()) / denom
                        if num is F:
                            mfu = eff
                        else:
                            hbm_eff = eff
            fixed = max(0.0, float(np.mean(
                y - comm - np.maximum(F / mfu, M / hbm_eff))))
        return dataclasses.replace(base, mfu=mfu, hbm_eff=hbm_eff,
                                   fixed_us=fixed * 1e6)


def cost_model_for(cfg, *, chips_per_stage: int = 1, pp: int = None,
                   page_size: Optional[int] = None) -> CostModel:
    """Stage-cost model for a pipeline of depth `pp` (defaults to the arch's
    plan).  Per stage: 1/pp of the layers on `chips_per_stage` chips.
    Passing `page_size` (the KV page length, `ServeDims.page`) enables the
    per-scanned-page attention term at page_size × the per-token KV rate —
    the depth-bucketed engine's cost shape."""
    from repro_torch.roofline.analysis import param_count
    n_active = param_count(cfg, active_only=True)
    pp = pp or cfg.plan.pp
    kv_bytes = cfg.kv_cache_dim_per_token * (cfg.num_layers / pp) * 2  # bf16
    extra = ({"attn_page_bytes": page_size * kv_bytes, "page_size": page_size}
             if page_size else {})
    return CostModel(
        flops_per_token_stage=2.0 * n_active / pp,
        param_bytes_stage=2.0 * n_active / pp,
        kv_bytes_per_ctx_token=kv_bytes,
        chips_per_stage=chips_per_stage,
        **extra,
    )


@dataclass
class RuntimeModel:
    """Host-side behaviour of the serving loop (paper §3.3/§3.4).  The `gllm()` and
    `vllm_like()` presets are the model's assumptions (the JAX module's
    values); `fit_from_trace` measures the host term from a trace."""

    overhead_serial: float = 0.0     # blocks the pipeline (vLLM-style coupling)
    overhead_overlap: float = 0.0    # hidden behind compute (gLLM async)

    @staticmethod
    def gllm() -> "RuntimeModel":
        return RuntimeModel(overhead_serial=0.0002, overhead_overlap=0.002)

    @staticmethod
    def vllm_like() -> "RuntimeModel":
        # ~17% of execution serialized on input prep (paper §3.4)
        return RuntimeModel(overhead_serial=0.0025, overhead_overlap=0.0)

    @property
    def host_s_per_tick(self) -> float:
        """Total modeled host work per non-bubble tick — the quantity trace
        schema 1.3 records as `host_s` (how much of it blocks the pipeline
        is the serial/overlap split)."""
        return self.overhead_serial + self.overhead_overlap

    @staticmethod
    def fit_from_trace(trace, *, overlap_fraction: float = 0.0
                       ) -> "RuntimeModel":
        """Calibrate the host-overhead term from a schema ≥ 1.3 trace: the
        mean per-tick `host_s` over non-bubble ticks, split by
        `overlap_fraction` into the part hidden behind compute (the async
        double-buffered engine overlaps nearly all of it → fraction near 1)
        versus the part that serializes with the pipeline (a sync engine →
        fraction 0).  Raises ValueError on traces without `host_s` — sim
        throughput would otherwise silently assume a free host."""
        from repro_torch.runtime.trace import host_overhead_samples

        samples = host_overhead_samples(trace)
        if not samples:
            raise ValueError(
                "trace records no per-tick host_s (pre-1.3 schema, or a "
                "backend without host accounting) — cannot calibrate "
                "RuntimeModel")
        if not 0.0 <= overlap_fraction <= 1.0:
            raise ValueError("overlap_fraction must be within [0, 1]")
        mean = float(np.mean(samples))
        return RuntimeModel(
            overhead_serial=mean * (1.0 - overlap_fraction),
            overhead_overlap=mean * overlap_fraction)


@dataclass
class SimMetrics:
    finished: List[Request] = field(default_factory=list)
    sim_time: float = 0.0
    total_output_tokens: int = 0
    total_input_tokens: int = 0
    bubble_time: float = 0.0          # last-stage idle while work pending
    busy_time: float = 0.0

    def _vals(self, fn):
        vals = [fn(r) for r in self.finished]
        return [v for v in vals if v is not None]

    def ttft(self):
        return float(np.mean(self._vals(lambda r: r.metrics.ttft()) or [0]))

    def tpot(self):
        return float(np.mean(self._vals(
            lambda r: r.metrics.tpot(r.num_output_tokens)) or [0]))

    def e2el(self):
        return float(np.mean(self._vals(lambda r: r.metrics.e2el()) or [0]))

    def throughput(self):
        """Steady-state token throughput: tokens completed within the p90
        request-completion window (the paper saturates and excludes the
        drain tail — a lone long-output straggler would otherwise dominate
        the denominator)."""
        if not self.finished:
            return 0.0
        fins = sorted(r.metrics.finish_time for r in self.finished
                      if r.metrics.finish_time is not None)
        if not fins:
            return 0.0
        t90 = fins[max(0, int(len(fins) * 0.9) - 1)]
        tok = sum(r.num_prompt_tokens + r.num_output_tokens
                  for r in self.finished
                  if r.metrics.finish_time is not None
                  and r.metrics.finish_time <= t90)
        return tok / max(t90, 1e-9)

    def slo_attainment(self, ttft_slo: float, tpot_slo: float) -> float:
        ok = 0
        for r in self.finished:
            t1, t2 = r.metrics.ttft(), r.metrics.tpot(r.num_output_tokens)
            if t1 is not None and t1 <= ttft_slo and (t2 or 0) <= tpot_slo:
                ok += 1
        return ok / max(1, len(self.finished))


class SimBackend(ExecutionBackend):
    """ExecutionBackend whose tick cost comes from the roofline model.

    Sampled tokens are placeholders (0): the simulator studies *scheduling*,
    not model outputs.  The backend keeps a virtual clock; `execute` cascades
    the entering micro-batch through the per-stage `stage_free_at` frontier
    and reports the exiting batch's modeled completion time.
    """

    def __init__(
        self,
        pp: int,
        cost: CostModel,
        runtime: RuntimeModel = None,
        *,
        straggler_stage: Optional[int] = None,
        straggler_factor: float = 1.0,
        metrics: Optional[SimMetrics] = None,
    ) -> None:
        self.pp = pp
        self.cost = cost
        self.runtime = runtime or RuntimeModel.gllm()
        self.straggler = (straggler_stage, straggler_factor)
        self.stage_free_at = [0.0] * pp
        self.time = 0.0
        self.metrics = metrics or SimMetrics()
        self._completion_time: Dict[int, float] = {}

    # --------------------------------------------------------------- protocol
    @property
    def depth(self) -> int:
        return self.pp

    def clock(self) -> float:
        return self.time

    def execute(self, ring: Sequence[Tuple[Optional[int], Any]],
                exiting_id: Optional[int], now: float) -> ExecResult:
        self.time = max(self.time, now)
        entering_id = ring[0][0]
        stage_times: Optional[List[float]] = None
        if entering_id is not None:
            batch = self.scheduler.get_batch(entering_id)
            stage_times = []
            t = now + self.runtime.overhead_serial
            for s in range(self.pp):
                start = max(t, self.stage_free_at[s])
                dt = self._batch_time(s, batch)
                stage_times.append(dt)
                if s == self.pp - 1:
                    if self.stage_free_at[s] < start and \
                            self.metrics.sim_time > 0:
                        self.metrics.bubble_time += \
                            start - self.stage_free_at[s]
                    self.metrics.busy_time += dt
                self.stage_free_at[s] = start + dt
                t = start + dt
            self._completion_time[entering_id] = t
        self.metrics.sim_time = max(self.metrics.sim_time, self.time)
        # Modeled per-tick host work (schema 1.3 `host_s`): dispatching a
        # real batch costs the full serial+overlap budget, a bubble costs
        # nothing.  Deterministic, so golden fixtures stay reproducible and
        # RuntimeModel.fit_from_trace recovers the model exactly.
        host_s = self.runtime.host_s_per_tick if entering_id is not None \
            else 0.0

        if exiting_id is None:
            return ExecResult([], now, stage_times=stage_times, host_s=host_s)
        done_at = self._completion_time.pop(exiting_id, now)
        exiting = self.scheduler.get_batch(exiting_id)
        n = sum(1 for s in exiting.seqs if s.produces_token) \
            if exiting is not None else 0
        self.metrics.total_output_tokens += n
        # the host loop cannot act on this completion before it happened
        self.time = max(self.time, done_at)
        self.metrics.sim_time = max(self.metrics.sim_time, self.time)
        return ExecResult([0] * n, done_at, stage_times=stage_times,
                          host_s=host_s)

    def reset(self, now: float) -> None:
        self._completion_time.clear()
        self.stage_free_at = [now] * self.pp
        self.time = max(self.time, now)
        self.metrics.sim_time = max(self.metrics.sim_time, self.time)

    def migration_cost(self, num_tokens: int) -> float:
        """Modeled seconds to ship a request's KV off this replica: per-stage
        KV bytes × pipeline depth (every stage holds its own layers' pages)
        over the interconnect, plus the fixed per-transfer floor.  This is
        the price `RebalancePolicy` trades against the imbalance it removes —
        tunable entirely in sim."""
        total_bytes = self.cost.kv_bytes_per_ctx_token * self.pp * num_tokens
        return total_bytes / self.cost.net_bw + self.cost.fixed_us * 1e-6

    # -------------------------------------------------------------- internals
    def _batch_time(self, stage: int, batch: ScheduledBatch) -> float:
        p_ctx = max((s.start_pos + s.num_tokens for s in batch.prefill),
                    default=0)
        d_ctx = int(np.mean([s.start_pos for s in batch.decode])) \
            if batch.decode else 0
        dt = self.cost.stage_time(batch.num_prefill_tokens,
                                  batch.num_decode_tokens, p_ctx, d_ctx)
        st, fac = self.straggler
        if st is not None and stage == st:
            dt *= fac
        return dt


class PipelineSimulator:
    """PP serving simulator: the shared TickLoop over a `SimBackend`.

    Arrival/failure injection and virtual-time advancement live here; the
    schedule→execute→complete cycle is the same code the real engine runs.
    """

    def __init__(
        self,
        scheduler: PipelineScheduler,
        pp: int,
        cost: CostModel,
        runtime: RuntimeModel = RuntimeModel.gllm(),
        *,
        straggler_stage: Optional[int] = None,
        straggler_factor: float = 1.0,
        trace_path: Optional[str] = None,
    ) -> None:
        self.sched = scheduler
        self.pp = pp
        self.backend = SimBackend(pp, cost, runtime,
                                  straggler_stage=straggler_stage,
                                  straggler_factor=straggler_factor)
        self.recorder = None
        loop_backend = self.backend
        if trace_path is not None:
            from repro_torch.runtime.trace import TraceRecorder
            self.recorder = TraceRecorder(self.backend, trace_path)
            loop_backend = self.recorder
        self.loop = TickLoop(scheduler, loop_backend)
        self.metrics = self.backend.metrics
        self._arrivals: List[Tuple[float, int, List[int], int,
                                   Optional[SamplingParams]]] = []
        self._failures: List[Tuple[float, float]] = []
        self._seq = itertools.count(1)
        # Request-id namespace.  Ids must be unique *cluster*-wide once live
        # migration can move a request between replicas (a namesake on the
        # destination would corrupt its block table) — `SimCluster`
        # re-prefixes fresh replicas to guarantee it.
        self.rid_prefix = "r"

    def attach_trace(self, trace_path) -> None:
        """Start recording this replica's ticks (before any work has run —
        used by `SimCluster` which receives already-built simulators)."""
        from repro_torch.runtime.trace import TraceRecorder
        assert self.recorder is None, "trace already attached"
        assert self.backend.time == 0.0 and not self.loop.busy, \
            "attach_trace before the simulator runs"
        self.recorder = TraceRecorder(self.backend, trace_path)
        self.recorder.scheduler = self.sched
        self.loop.backend = self.recorder

    @property
    def scheduler(self) -> PipelineScheduler:   # replica-router signal surface
        return self.sched

    # ------------------------------------------------- engine-compatible API
    # The serving layer (repro.serving) and `ReplicaRouter` drive engines and
    # simulators through one surface: add_request / step / abort_request /
    # has_work / busy / finished / on_token.  For the simulator, "now" is the
    # virtual clock, and one `step()` is one loop action.

    @property
    def finished(self) -> List[Request]:
        return self.metrics.finished

    @property
    def has_work(self) -> bool:
        return self.sched.has_work or bool(self._arrivals)

    @property
    def busy(self) -> bool:
        return self.loop.busy

    @property
    def on_token(self):
        return self.loop.on_token

    @on_token.setter
    def on_token(self, fn) -> None:
        self.loop.on_token = fn

    def add_request(self, prompt: List[int],
                    sampling: Optional[SamplingParams] = None,
                    request_id: Optional[str] = None) -> Request:
        """Admit a request at the current virtual instant (the interactive
        analogue of `inject_request`, which schedules a *future* arrival)."""
        rid = request_id or f"{self.rid_prefix}{next(self._seq)}"
        req = Request(rid, list(prompt), sampling or SamplingParams())
        req.metrics.arrival_time = self.backend.time
        self.metrics.total_input_tokens += len(prompt)
        self.sched.add_request(req)
        if self.recorder is not None:
            self.recorder.record_arrival(req)
        return req

    def step(self) -> List[Request]:
        """One loop action (tick, failure, or arrival jump); returns the
        requests that finished during it."""
        before = len(self.metrics.finished)
        self._advance(float("inf"))
        return self.metrics.finished[before:]

    def abort_request(self, request_id: str) -> bool:
        """User abort at the current virtual instant; frees KV immediately
        for waiting/running requests, at batch retire for in-flight ones."""
        now = self.backend.time
        req = self.sched.abort_request(request_id, now)
        if req is None:
            return False
        if self.recorder is not None:
            self.recorder.record_abort(request_id, now)
        if req.is_finished:
            self.loop.backend.finish_request(req)
            self.metrics.finished.append(req)
            self.loop.finished.append(req)
        return True

    def drain(self, max_ticks: int = 100000) -> List[Request]:
        before = len(self.metrics.finished)
        for _ in range(max_ticks):
            if not self._advance(float("inf")):
                break
        return self.metrics.finished[before:]

    def advance_clock(self, t: float) -> None:
        """Control-plane causality: a request materialized here at `t` (a
        steal or migration delivery) — this replica must not tick earlier."""
        self.backend.time = max(self.backend.time, t)
        self.metrics.sim_time = max(self.metrics.sim_time, self.backend.time)

    # ------------------------------------------------------------------ intake
    def add_workload(self, arrivals: List[Tuple]):
        """arrivals: (time, prompt_tokens, output_len[, sampling])."""
        for t, prompt, out_len, *rest in arrivals:
            self.inject_request(t, prompt, out_len, *rest)

    def inject_request(self, t: float, prompt: List[int], out_len: int,
                       sampling: Optional[SamplingParams] = None) -> None:
        """Schedule a future arrival.  `sampling` overrides the default
        greedy `SamplingParams(max_new_tokens=out_len)` — the hook for
        SLO-class / priority mixes in cluster studies; when given, its
        `max_new_tokens` wins over `out_len`."""
        heapq.heappush(self._arrivals,
                       (t, next(self._seq), prompt, out_len, sampling))

    def inject_failure(self, at: float, downtime: float):
        heapq.heappush(self._failures, (at, downtime))

    # ------------------------------------------------------------------- run
    def run(self, until: float = float("inf"), max_events: int = 5_000_000
            ) -> SimMetrics:
        for _ in range(max_events):
            if not self._advance(until):
                break
        return self.metrics

    def run_until(self, t: float, max_events: int = 5_000_000) -> SimMetrics:
        """Advance virtual time until the next tick would start after `t`
        (or the replica goes idle).  Used by the multi-replica cluster loop
        to keep replicas causally consistent at each routing decision."""
        for _ in range(max_events):
            if self._next_tick_time() > t or not self._advance(float("inf")):
                break
        return self.metrics

    # -------------------------------------------------------------- internals
    def _next_tick_time(self) -> float:
        return max(self.backend.time, self.backend.stage_free_at[0])

    def _advance(self, until: float) -> bool:
        """One loop action: apply a due failure, or run one tick, or jump
        virtual time to the next arrival.  Returns False when fully idle."""
        t = self._next_tick_time()
        if self._failures and self._failures[0][0] <= t:
            at, downtime = heapq.heappop(self._failures)
            self._apply_failure(at, downtime)
            return True
        self._admit_arrivals(t, until)
        if self.sched.has_work or self.loop.busy:
            was_busy = self.loop.busy
            finished = self.loop.step(t)
            self.metrics.finished.extend(finished)
            if self.loop.last_tick_empty and not was_busy:
                # an idle pipeline scheduled nothing (e.g. admission gated on
                # the KV threshold): only an arrival can unblock us
                return self._jump_to_next_arrival(until)
            return True
        return self._jump_to_next_arrival(until)

    def _admit_arrivals(self, t: float, until: float) -> None:
        while self._arrivals and self._arrivals[0][0] <= t:
            at, _, prompt, out_len, sampling = heapq.heappop(self._arrivals)
            if at > until:
                continue            # past the measurement horizon: dropped
            req = Request(f"{self.rid_prefix}{next(self._seq)}", prompt,
                          sampling or SamplingParams(max_new_tokens=out_len))
            req.metrics.arrival_time = at
            self.metrics.total_input_tokens += len(prompt)
            self.metrics.sim_time = max(self.metrics.sim_time, at)
            self.sched.add_request(req)
            if self.recorder is not None:
                self.recorder.record_arrival(req)

    def _jump_to_next_arrival(self, until: float) -> bool:
        while self._arrivals:
            at = self._arrivals[0][0]
            if at > until:
                heapq.heappop(self._arrivals)
                continue
            self.backend.time = max(self.backend.time, at)
            self._admit_arrivals(self.backend.time, until)
            return True
        return False

    def _apply_failure(self, at: float, downtime: float) -> None:
        # in-flight micro-batches lost: abort + recompute on recovery
        # (reset goes through the loop's backend so a TraceRecorder sees it)
        affected = self.loop.abort_inflight(at)
        self.metrics.finished.extend(r for r in affected if r.is_finished)
        self.loop.backend.reset(at + downtime)


def record_sim_trace(
    trace_path,
    arrivals: List[Tuple[float, List[int], int]],
    *,
    arch: str = "qwen2.5-14b",
    pp: int = 4,
    pages: int = 2048,
    page_size: int = 16,
    policy: PrefillPolicy = PrefillPolicy.GLLM,
    runtime: RuntimeModel = None,
    straggler_stage: Optional[int] = None,
    straggler_factor: float = 1.0,
    fail_at: Optional[float] = None,
    downtime: float = 1.0,
    enable_prefix_caching: bool = False,
    attn_page_billing: bool = False,
) -> PipelineSimulator:
    """Run a traced simulation of `arrivals` — the canonical way to mint a
    golden trace (tests/fixtures/traces/make_fixtures.py) or a calibration
    trace (`benchmarks.run --trace-out`).  Returns the finished simulator;
    the trace is at `trace_path` (or in `sim.recorder` for in-memory sinks).
    `attn_page_billing` bills attention HBM traffic per scanned KV page
    (the depth-bucketed engine's cost shape) instead of per context token.
    """
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    th = ThrottleConfig(pipeline_depth=pp, policy=policy)
    kv = PagedKVManager(num_pages=pages, page_size=page_size,
                        enable_prefix_caching=enable_prefix_caching)
    sched = PipelineScheduler(th, kv, max_model_len=pages * page_size)
    cost = cost_model_for(cfg, pp=pp,
                          page_size=page_size if attn_page_billing else None)
    sim = PipelineSimulator(sched, pp, cost, runtime,
                            straggler_stage=straggler_stage,
                            straggler_factor=straggler_factor,
                            trace_path=trace_path)
    sim.add_workload(arrivals)
    if fail_at is not None:
        sim.inject_failure(fail_at, downtime)
    sim.run()
    if sim.recorder is not None:
        sim.recorder.close()
    return sim
