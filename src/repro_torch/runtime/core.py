"""Shared serving-runtime core: the ring/schedule/complete cycle (DESIGN.md §1).

A copy of ``repro.runtime.core``: the port keeps its own so that it imports
nothing of the JAX package.

Every serving scenario in this repo — the exact PyTorch engine, the calibrated
discrete-event simulator, the benchmark drivers — runs the same loop: form a
micro-batch, push it into a depth-S pipeline ring, execute one tick, retire
the micro-batch that exits the ring.  `TickLoop` owns that cycle once;
*what a tick costs and produces* is delegated to an `ExecutionBackend`:

  * `TorchBackend` (runtime/engine.py) — the eager PyTorch serve tick; tokens
    are real, the clock is the wall clock.
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
    a CUDA event's `query()`).  The JAX package's async TickLoop reads it;
    the port's loop resolves every result within its own tick.
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

    The JAX package's async double-buffered mode is not carried over: the
    port's engine has no use for it yet.
    """

    def __init__(self, scheduler: PipelineScheduler, backend: ExecutionBackend,
                 on_token: Optional[Callable[[Request, int], None]] = None
                 ) -> None:
        self.scheduler = scheduler
        self.backend = backend
        backend.scheduler = scheduler
        S = backend.depth
        self.ring: Deque[Tuple[Optional[int], Any]] = deque(
            [(None, backend.prepare(None)) for _ in range(S)], maxlen=S)
        self.on_token = on_token
        self.finished: List[Request] = []
        self.last_tick_empty = False

    # ------------------------------------------------------------------ state
    @property
    def busy(self) -> bool:
        """True while any real micro-batch is in the ring."""
        return any(bid is not None for bid, _ in self.ring)

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work or self.busy

    # ------------------------------------------------------------------- tick
    def step(self, now: Optional[float] = None) -> List[Request]:
        """One pipeline tick.  Returns requests finishing this tick."""
        if now is None:
            now = self.backend.clock()
        batch = self.scheduler.schedule(now)
        if batch.is_empty:
            # nothing resident this tick: retire the empty batch immediately
            self.scheduler.complete(batch.batch_id, [], now)
            entry: Tuple[Optional[int], Any] = (None, self.backend.prepare(None))
        else:
            entry = (batch.batch_id, self.backend.prepare(batch))
        self.last_tick_empty = batch.is_empty
        # Rotate: the new batch enters stage 0; the entry reaching the ring's
        # tail is the one executing its LAST stage this tick — its results
        # materialize when `execute` returns.  (For depth 1 that is this
        # tick's own batch: schedule, execute, retire in one step.)
        self.ring.appendleft(entry)
        exiting_id, _ = self.ring[-1]

        result = self.backend.execute(tuple(self.ring), exiting_id, now)
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
