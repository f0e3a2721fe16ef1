"""Shared serving-runtime core: the ring/schedule/complete cycle (DESIGN.md §1).

A copy of ``repro.runtime.core``: the port keeps its own so that it imports
nothing of the JAX package.

Every serving scenario in this repo — the exact PyTorch engine, the calibrated
discrete-event simulator, the benchmark drivers — runs the same loop: form a
micro-batch, push it into a depth-S pipeline ring, execute one tick, retire
the micro-batch that exits the ring.  `TickLoop` owns that cycle once;
*what a tick costs and produces* is delegated to an `ExecutionBackend`:

  * `TorchBackend` (runtime/engine.py) — the PyTorch serve tick (a CUDA
    graph replay per bucket); tokens are real, the clock is the wall clock.
  * `SimBackend` (runtime/simulator.py) — the roofline cost model; tokens are
    placeholders, the clock is virtual time.

This is the same policy/execution split Sarathi-Serve and TD-Pipe use, and it
is what lets `ReplicaRouter` (runtime/router.py) front N replicas of either
kind without touching the tick loop.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, List, Optional, Sequence, Tuple

from repro_torch.core import PipelineScheduler, Request, ScheduledBatch


@dataclass
class ExecResult:
    """Outcome of one pipeline tick, as seen by the exiting micro-batch.

    `tokens` has one sampled token per token-producing seq of the exiting
    batch, in batch order (prefill entries first, then decode) — exactly the
    currency `PipelineScheduler.complete` expects.  `completed_at` is the
    backend-clock time the exiting batch finished its last stage (for the
    engine this is "now"; the simulator reports the modeled completion time).

    `stage_times` optionally attributes the *entering* micro-batch's service
    time per pipeline stage — backends that can't split time per stage
    (the live engine) leave it None; the simulator and trace replay fill it,
    and `CostModel.fit_from_trace` calibrates against it.

    `host_s` optionally reports the host-side time this tick spent outside
    device execution (metadata assembly, embedding lookups, dispatch) — the
    engine measures it, the simulator models it, and trace schema ≥ 1.3
    records it so `RuntimeModel.fit_from_trace` can calibrate the overhead.

    **Deferred form.**  A backend that dispatches asynchronously returns the
    result with `pending` set: a thunk that blocks on the device readback and
    yields the token list.  `resolve()` forces it (idempotently) and caches
    into `tokens`; callers must resolve before reading `tokens`.  Plain
    synchronous results leave `pending` None and `resolve()` is a no-op.
    `ready` optionally carries a *non-blocking* probe for whether the
    deferred readback has already materialized (the engine wires it to
    a CUDA event's `query()`); the async TickLoop reads it.
    """

    tokens: List[int] = field(default_factory=list)
    completed_at: float = 0.0
    stage_times: Optional[List[float]] = None
    host_s: Optional[float] = None
    pending: Optional[Callable[[], List[int]]] = None
    ready: Optional[Callable[[], bool]] = None

    def resolve(self) -> List[int]:
        """Force the deferred readback (if any) and return the tokens."""
        if self.pending is not None:
            thunk, self.pending = self.pending, None
            self.tokens = list(thunk())
        return self.tokens

    def is_ready(self) -> bool:
        """True when `resolve()` would not block: synchronous results always,
        deferred ones when the backend's probe says the device is done (a
        deferred result without a probe conservatively reports False)."""
        if self.pending is None:
            return True
        return bool(self.ready()) if self.ready is not None else False


class ExecutionBackend:
    """Executes micro-batches for a `TickLoop`.

    Subclasses override `depth`, `prepare`, and `execute`; the remaining
    hooks default to no-ops.  `scheduler` is attached by the TickLoop so the
    backend can resolve batch ids via the public `get_batch` API.
    """

    scheduler: PipelineScheduler

    @property
    def depth(self) -> int:
        """Pipeline depth S = number of in-flight micro-batches (ring size)."""
        raise NotImplementedError

    def clock(self) -> float:
        """Current time on this backend's clock (wall or virtual)."""
        return 0.0

    def prepare(self, batch: Optional[ScheduledBatch]) -> Any:
        """Host-side per-batch payload computed at schedule time (one tick
        ahead of execution — the engine's dual-phase metadata path).  `batch`
        is None for a bubble tick."""
        return None

    def execute(self, ring: Sequence[Tuple[Optional[int], Any]],
                exiting_id: Optional[int], now: float) -> ExecResult:
        """Advance the pipeline by one tick.  `ring[0]` is the micro-batch
        entering stage 0 this tick; `exiting_id` identifies the batch leaving
        the last stage (None for a bubble)."""
        raise NotImplementedError

    def finish_request(self, req: Request) -> None:
        """A request fully completed: release backend-held per-request state."""

    def reset(self, now: float) -> None:
        """Fault recovery: all in-flight work was lost; restart at `now`."""

    # ------------------------------------------------- live migration (§9)
    # The router's control plane moves a *running* request between replicas:
    # the source backend gathers the request's device-resident bytes (KV
    # pages + per-request state), the destination scatters them into its own
    # pools at freshly-allocated addresses.  Backends without real device
    # state (the simulator, trace replay) keep the no-op defaults — the
    # host-side addressing (`PagedKVManager.export_kv/import_kv`) is the
    # shared protocol; these hooks move only the payload.

    def export_kv_pages(self, request_id: str,
                        slots: Sequence[Tuple[int, int]]) -> Any:
        """Gather the KV cache content at `slots` ((page, slot) per resident
        token, sequence order).  Returns an opaque payload for
        `import_kv_pages` on the destination backend; None when the backend
        holds no real bytes."""
        return None

    def import_kv_pages(self, request_id: str, payload: Any,
                        slots: Sequence[Tuple[int, int]]) -> None:
        """Scatter a payload from `export_kv_pages` into this backend's KV
        pools at `slots` (the destination addressing from `import_kv`)."""

    def export_request_state(self, req: Request) -> Any:
        """Detach non-KV per-request device state (encoder caches, state
        slots) for migration; releases it locally."""
        return None

    def import_request_state(self, req: Request, state: Any,
                             resident: bool = True) -> None:
        """Attach state from `export_request_state` on the destination.
        `resident=False` means the request arrives *non-resident* (it will
        recompute from scratch — a stolen waiting request, or a migration
        that fell back to recompute): attach only state that must survive a
        recompute (e.g. encoder embeddings), not residency-scoped state
        like recurrent slots, which recompute rebuilds anyway."""

    def migration_cost(self, num_tokens: int) -> float:
        """Modeled wall-clock seconds to move `num_tokens` of KV off this
        backend (interconnect transfer).  Real backends pay the cost in the
        copy itself and report 0; the simulator models it so migration
        thresholds are tunable in sim."""
        return 0.0


class TickLoop:
    """The single schedule→execute→complete cycle (paper §3.3 driver loop).

    One `step()`:
      1. asks the scheduler for this tick's micro-batch (empty = bubble),
      2. rotates it into the depth-S ring (the batch entering stage 0),
      3. has the backend execute one pipeline tick,
      4. retires the batch exiting the ring: applies its sampled tokens,
         streams them, and releases finished requests.

    A request scheduled at tick t is retired at tick t+S-1 (same tick for a
    depth-1 pipeline) — the pipeline-parallel in-flight window the
    scheduler's exclusion rule (one resident micro-batch per request) is
    built around.

    **Async double-buffered mode** (`async_dispatch=True`): the exiting
    batch's readback is *not* forced inside its own tick.  Instead the
    deferred `ExecResult` is parked in `_pending` and retired one tick
    later — after the next tick's schedule/prepare host work has already
    run and the next device tick has been dispatched — so host metadata
    assembly for tick N+1 overlaps device execution of tick N.  The
    completion lag is invisible to outputs: a pending request is still in
    the scheduler's in-flight set, so it simply becomes schedulable one tick
    later, and greedy sampling makes per-request token streams independent
    of tick placement.  Sync mode stays the default.
    """

    def __init__(self, scheduler: PipelineScheduler, backend: ExecutionBackend,
                 on_token: Optional[Callable[[Request, int], None]] = None,
                 *, async_dispatch: bool = False) -> None:
        self.scheduler = scheduler
        self.backend = backend
        backend.scheduler = scheduler
        S = backend.depth
        self.ring: Deque[Tuple[Optional[int], Any]] = deque(
            [(None, backend.prepare(None)) for _ in range(S)], maxlen=S)
        self.on_token = on_token
        self.finished: List[Request] = []
        self.last_tick_empty = False
        self.async_dispatch = async_dispatch
        # async mode: the exiting batch of the *previous* tick, its readback
        # still deferred — retired at the top of the next step
        self._pending: Optional[Tuple[int, ExecResult]] = None
        # requests that `settle` finished, handed out by the next step
        self._settled: List[Request] = []

    # ------------------------------------------------------------------ state
    @property
    def _ring_busy(self) -> bool:
        return any(bid is not None for bid, _ in self.ring)

    @property
    def busy(self) -> bool:
        """True while any real micro-batch is in the ring or awaiting its
        deferred retirement."""
        return self._ring_busy or self._pending is not None

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work or self.busy or bool(self._settled)

    def settle(self, now: Optional[float] = None) -> None:
        """Async mode: retire the deferred batch now, blocking on its
        readback.  At depth 1 no request is then in flight until the next
        step, so the router may drain and move any of them (otherwise every
        running decode is in flight between steps).  At depth S > 1 only
        the deferred batch retires: the S-1 micro-batches still inside the
        ring stay in flight, so `drain_request` returns None for their
        requests and the router's move returns False (it may retry after
        later steps).  The requests this finishes are returned by the next
        `step`."""
        if self._pending is not None:
            self._settled.extend(self._retire_pending(
                self.backend.clock() if now is None else now))

    # ------------------------------------------------------------------- tick
    def step(self, now: Optional[float] = None) -> List[Request]:
        """One pipeline tick.  Returns requests finishing this tick (and
        those a `settle` since the last step finished)."""
        settled, self._settled = self._settled, []
        return settled + self._step(now)

    def _step(self, now: Optional[float]) -> List[Request]:
        if now is None:
            now = self.backend.clock()
        finished_early: List[Request] = []
        had_pending = self._pending is not None
        if (self.async_dispatch and had_pending
                and self._pending[1].is_ready()):
            # The deferred readback already materialized, so retiring it
            # costs no wait — and doing it BEFORE scheduling makes its
            # requests schedulable this very tick.  Without this, deferred
            # retirement delays every completion by a full tick and the
            # decode population freezes into two alternating cohorts.
            finished_early = self._retire_pending(now)
        batch = self.scheduler.schedule(now)
        if batch.is_empty:
            # nothing resident this tick: retire the empty batch immediately
            self.scheduler.complete(batch.batch_id, [], now)
            entry: Tuple[Optional[int], Any] = (None, self.backend.prepare(None))
        else:
            entry = (batch.batch_id, self.backend.prepare(batch))
        self.last_tick_empty = batch.is_empty
        if (self.async_dispatch and batch.is_empty and not self._ring_busy
                and had_pending):
            # nothing to execute — only the deferred batch remained (retired
            # above or here); no bubble device tick.  The JAX loop tests
            # `_pending` after the early retirement and so runs one bubble
            # tick more than sync mode at the end of every drain.
            return finished_early + (self._retire_pending(now)
                                     if self._pending is not None else [])
        # Rotate: the new batch enters stage 0; the entry reaching the ring's
        # tail is the one executing its LAST stage this tick — its results
        # materialize when `execute` returns.  (For depth 1 that is this
        # tick's own batch: schedule, execute, retire in one step.)
        self.ring.appendleft(entry)
        exiting_id, _ = self.ring[-1]

        result = self.backend.execute(tuple(self.ring), exiting_id, now)

        if self.async_dispatch:
            # This tick is now in flight on the device.  Retire the PREVIOUS
            # tick's exiting batch — its readback has had a full device tick
            # to complete — and park this tick's exiting batch until the
            # next step.
            finished = (self._retire_pending(now)
                        if self._pending is not None else [])
            if exiting_id is not None:
                self._pending = (exiting_id, result)
            self.ring[-1] = (None, self.backend.prepare(None))
            return finished_early + finished

        result.resolve()
        if exiting_id is None:
            return []
        finished = self._retire(exiting_id, result.tokens,
                                result.completed_at)
        # the retired entry is never read again (the next push would drop
        # it); clear it so `busy` reflects only live work
        self.ring[-1] = (None, self.backend.prepare(None))
        return finished

    def drain(self, now_fn: Callable[[], float],
              max_ticks: int = 100000) -> List[Request]:
        out: List[Request] = []
        t = 0
        while self.has_work and t < max_ticks:
            out.extend(self.step(now_fn()))
            t += 1
        return out

    # ----------------------------------------------------------------- retire
    def _retire_pending(self, now: float) -> List[Request]:
        """Force the deferred readback of the previous tick's exiting batch
        and retire it.  `now` (resolve-time clock) is the completion time —
        the tokens materialized no later than this."""
        bid, result = self._pending
        self._pending = None
        return self._retire(bid, result.resolve(), now)

    def _retire(self, batch_id: int, tokens: Sequence[int],
                now: float) -> List[Request]:
        batch = self.scheduler.get_batch(batch_id)
        if batch is None:
            return []
        producing = [s.request for s in batch.seqs if s.produces_token]
        finished = self.scheduler.complete(batch_id, tokens, now)
        if self.on_token is not None:
            for req, tok in zip(producing, tokens):
                self.on_token(req, int(tok))
        for req in finished:
            self.backend.finish_request(req)
            self.finished.append(req)
        return finished

    # ------------------------------------------------------------ fault paths
    def abort_inflight(self, now: Optional[float] = None) -> List[Request]:
        """A worker died: every in-flight micro-batch's results are lost.
        Requests recover by recompute via `scheduler.abort_batch`; requests
        with a pending user abort finalize it instead (backend state
        released, surfaced through `finished` like any completion)."""
        if now is None:
            now = self.backend.clock()
        affected: List[Request] = []
        if self._pending is not None:
            bid, _ = self._pending
            self._pending = None          # deferred readback never forced
            affected.extend(self.scheduler.abort_batch(bid, now))
        for bid, _ in list(self.ring):
            if bid is not None:
                affected.extend(self.scheduler.abort_batch(bid, now))
        S = self.ring.maxlen or self.backend.depth
        self.ring.clear()
        self.ring.extend((None, self.backend.prepare(None)) for _ in range(S))
        for req in affected:
            if req.is_finished:
                self.backend.finish_request(req)
                self.finished.append(req)
        return affected
