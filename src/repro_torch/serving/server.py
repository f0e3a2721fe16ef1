"""`LLMServer`: the one client surface over every execution substrate
(DESIGN.md §10).

A copy of ``repro.serving.server``: the port keeps its own so that it imports
nothing of the JAX package.

Whatever a `ServeSpec` resolved to — a `PipelineEngine`, a
`PipelineSimulator`, a `TraceBackend` replay, a `ReplicaRouter` or
`SimCluster` fronting N of them — the handle you get back speaks the same
request lifecycle:

  * `submit()` / `generate()`        — enqueue, or enqueue-and-wait
  * `stream()` / `generate_stream()` — incremental `TokenDelta`s (sync
    generator stepping from the calling thread — the HTTP frontend's path —
    or the async variant with a shared background runner)
  * `abort()`                        — stop a request anywhere in its life:
    waiting (including a stolen request in a destination queue), mid-decode,
    inside an in-flight micro-batch, or mid-KV-migration between replicas —
    slots and KV pages are freed in every case and the stream ends with
    ``finish_reason="abort"``
  * `stats()`                        — per-replica scheduler/KV signals incl.
    the discovered service-rate EWMA, plus routing/rebalance counters

Preemption-by-recompute is surfaced, not hidden: the stream carries an
``event="preempt"`` delta when a request loses residency and tags the first
token after recovery ``event="preempt-resumed"``.

The server is synchronous at its core (`step()` advances the substrate one
tick/event); `generate_stream` lazily spawns one asyncio runner task that
steps the engine on a worker thread while any work is pending — the
decoupled-frontend design of gLLM §3.3 without a separate class.

Over a layout of ranks (engines built with `ranks=`, sharing one
`runtime.engine.RankLink`) the server keeps the worker ranks alive while it
waits: every collective, the workers' wait for rank 0's next command
included, raises after the group's timeout, so a thread sends the idle
command under the step lock whenever no command went for `idle_s` seconds.
`close()` ends the workers (once; it also runs when `HTTPFrontend` shuts
down).  The engines run their device work on the rank's device and stream
whichever thread steps them (`RankBackend`).
"""

from __future__ import annotations

import asyncio
import itertools
import queue
import threading
from dataclasses import dataclass, field
from typing import (Any, AsyncIterator, Callable, Dict, Iterator, List,
                    Optional, Sequence, Set)

from repro_torch.core import Request, RequestMetrics, SamplingParams
from repro_torch.core.request import RequestState

# Public finish-reason vocabulary (TokenDelta.finish_reason /
# RequestOutput.finish_reason)
FINISH_STOP = "stop"        # hit a stop token id
FINISH_LENGTH = "length"    # hit max_new_tokens
FINISH_ABORT = "abort"      # abort() — user or operator

# Stream event vocabulary (TokenDelta.event)
EVENT_PREEMPT = "preempt"                   # lost residency; will recompute
EVENT_PREEMPT_RESUMED = "preempt-resumed"   # first token after recovery


@dataclass(frozen=True)
class TokenDelta:
    """One increment of a request's output stream.

    `token` is None for pure lifecycle events (preemption, abort).  `index`
    is the number of output tokens the request has after this delta — for
    token-bearing deltas, consecutive and 1-based.  Exactly one delta per
    stream carries a non-None `finish_reason`, and it is the last.
    """

    request_id: str
    token: Optional[int]
    index: int
    finish_reason: Optional[str] = None
    event: Optional[str] = None


@dataclass
class RequestOutput:
    """Terminal (or in-progress) view of one request."""

    request_id: str
    prompt_token_ids: List[int]
    token_ids: List[int]
    finish_reason: Optional[str]
    metrics: RequestMetrics

    @staticmethod
    def of(req: Request) -> "RequestOutput":
        return RequestOutput(
            request_id=req.request_id,
            prompt_token_ids=list(req.prompt_token_ids),
            token_ids=list(req.output_token_ids),
            finish_reason=req.finish_reason,
            metrics=req.metrics,
        )

    @property
    def finished(self) -> bool:
        return self.finish_reason is not None


@dataclass
class ReplicaStats:
    """One replica's scheduler/KV signals at a stats() instant."""

    index: int
    ticks: int
    tokens_retired: int
    service_rate: Optional[float]   # tokens retired/sec EWMA (discovered)
    kv_free_rate: float
    waiting: int
    running_decode: int
    preemptions: int
    # Disaggregation role of this replica ("prefill" / "decode" / "mixed",
    # DESIGN.md §15) — "mixed" for single replicas and role-less clusters.
    role: str = "mixed"
    # Waiting-queue composition by SLO class ({"interactive": n, "batch": m},
    # absent classes omitted) — the signal an operator reads to tell "loaded
    # with latency-sensitive work" from "deep but all-batch" (docs/operations.md)
    waiting_by_class: Dict[str, int] = field(default_factory=dict)
    # Prefix-cache effectiveness (all zero with caching disabled):
    # admission-time lookups, hits (lookups that adopted a cached head),
    # and prefill tokens skipped because their KV was already resident.
    prefix_lookups: int = 0
    prefix_hits: int = 0
    prefix_tokens_avoided: int = 0
    # Bucketed-engine attention-depth signals (None/zero for sim replicas or
    # unbucketed engines): the last tick's selected serve shape
    # ({"Sp", "C", "Sd", "Bp", "Bd"}, DESIGN.md §14) and the cumulative KV
    # pages the attention scan walked vs. those actually holding context.
    bucket: Optional[Dict[str, int]] = None
    scanned_pages: int = 0
    live_pages: int = 0


@dataclass
class ServerStats:
    replicas: List[ReplicaStats] = field(default_factory=list)
    routed_counts: Optional[List[int]] = None     # clusters only
    # Stable per-replica ordinals, position-aligned with `replicas` /
    # `routed_counts` (clusters only).  On an elastic fleet the ordinal —
    # not the list position — identifies a replica across scale events:
    # retired ordinals leave the list, newborns get fresh ones.
    replica_ordinals: Optional[List[int]] = None
    rebalance: Optional[Any] = None               # RebalanceStats, if enabled
    disagg: Optional[Any] = None                  # DisaggStats, if handoff on
    autoscale: Optional[Any] = None               # AutoscaleStats, if elastic
    # Elastic fleets (DESIGN.md §16): serving replica count (draining
    # replicas excluded), active drains, and replicas already retired.
    fleet_size: Optional[int] = None
    draining: Optional[int] = None
    retired: Optional[int] = None
    # Per-class SLO attainment over finished requests (the shared
    # `attainment_by_class` definition — same numbers fig_autoscale and
    # fig_disagg report); None until something finished.
    attainment_by_class: Optional[Dict[str, Dict[str, float]]] = None

    @property
    def tokens_retired(self) -> int:
        return sum(r.tokens_retired for r in self.replicas)

    @property
    def queue_depth_by_role(self) -> Dict[str, Dict[str, int]]:
        """Per-role aggregate queue signals: how deep the prefill-side
        admission backlog runs vs. how much decode work the decode side
        carries — the two queues a disaggregated deployment balances."""
        out: Dict[str, Dict[str, int]] = {}
        for r in self.replicas:
            agg = out.setdefault(r.role, {"replicas": 0, "waiting": 0,
                                          "running_decode": 0})
            agg["replicas"] += 1
            agg["waiting"] += r.waiting
            agg["running_decode"] += r.running_decode
        return out


def _replicas_of(engine: Any) -> List[Any]:
    """The per-replica objects behind any engine-surface target."""
    sims = getattr(engine, "sims", None)           # SimCluster
    if sims is not None:
        return list(sims)
    replicas = getattr(engine, "replicas", None)   # ReplicaRouter
    if replicas is not None:
        return list(replicas)
    return [engine]


def _router_of(engine: Any) -> Optional[Any]:
    router = getattr(engine, "router", None)       # SimCluster
    if router is not None:
        return router
    if getattr(engine, "replicas", None) is not None:   # ReplicaRouter
        return engine
    return None


class LLMServer:
    """The serving facade.  Construct via `repro_torch.serving.build(spec)`.

    `engine` is anything speaking the engine surface: ``add_request(prompt,
    sampling, request_id)`` / ``step()`` / ``abort_request(rid)`` /
    ``has_work`` / ``busy`` — a `PipelineEngine`, `PipelineSimulator`,
    `ReplicaRouter`, `SimCluster`, or the trace-replay engine.
    """

    _rid_counter = itertools.count()    # process-wide: unique across servers

    def __init__(self, engine: Any, *, spec: Any = None, cfg: Any = None,
                 replay: Any = None, replay_mode: str = "strict",
                 idle_s: Optional[float] = None) -> None:
        self.engine = engine
        self.spec = spec
        self.cfg = cfg                  # ArchConfig for model-backed servers
        self._replay_trace = replay
        self._replay_mode = replay_mode
        self.last_report = None
        self._requests: Dict[str, Request] = {}
        self._sinks: Dict[str, List[Callable[[TokenDelta], None]]] = {}
        self._final_emitted: Set[str] = set()
        self._resume_pending: Set[str] = set()
        self._step_lock = threading.Lock()
        self._runner_task: Optional[asyncio.Task] = None
        self._closed = False
        if engine is not None:
            for replica in _replicas_of(engine):
                self._wire_replica(replica)
            router = _router_of(engine)
            if router is not None \
                    and hasattr(router, "add_replica_hook"):
                # elastic fleets: replicas added later need the same wiring
                router.add_replica_hook(
                    lambda replica, ordinal, now: self._wire_replica(replica))
        # rank engines: the links to their worker ranks, each once
        self.links: List[Any] = []
        for replica in self.replicas:
            link = getattr(getattr(replica, "backend", None), "link", None)
            if link is not None and all(link is not k for k in self.links):
                self.links.append(link)
        self.idle_s = idle_s
        self._idle_stop = threading.Event()
        self._idle_thread: Optional[threading.Thread] = None
        if self.links and idle_s is not None:
            self._idle_thread = threading.Thread(
                target=self._keep_alive, name="rank-idle", daemon=True)
            self._idle_thread.start()

    def _wire_replica(self, replica: Any) -> None:
        replica.on_token = self._on_token
        sched = replica.scheduler
        sched.on_preempt = self._chain_preempt(sched.on_preempt)

    # ------------------------------------------------------------ enumeration
    @property
    def replicas(self) -> List[Any]:
        return _replicas_of(self.engine) if self.engine is not None else []

    @property
    def router(self) -> Optional[Any]:
        return _router_of(self.engine) if self.engine is not None else None

    @property
    def has_work(self) -> bool:
        return bool(self.engine is not None
                    and (self.engine.has_work or self.engine.busy))

    # ---------------------------------------------------------------- lifecycle
    def submit(self, prompt: Sequence[int],
               sampling: Optional[SamplingParams] = None,
               request_id: Optional[str] = None, **kw) -> str:
        """Enqueue a request; returns its id.  Extra kwargs (e.g.
        `enc_embeds` for encoder-decoder archs) pass through to the
        substrate."""
        self._require_interactive("submit")
        rid = request_id or f"llm-{next(LLMServer._rid_counter)}"
        # intake serializes against ticks: schedulers iterate their waiting
        # queue inside schedule(), so a concurrent add_request from another
        # client thread (HTTP handler, asyncio submitter) must not mutate it
        # mid-step
        with self._step_lock:
            req = self.engine.add_request(list(prompt), sampling, rid, **kw)
        self._requests[rid] = req
        return rid

    def step(self) -> List[RequestOutput]:
        """Advance the substrate one tick/event; returns requests that
        finished during it (server-submitted or not)."""
        self._require_interactive("step")
        with self._step_lock:
            # the sweep dispatches terminal deltas INSIDE the lock: the lock
            # is the dispatch barrier streaming threads rely on — once idle
            # is observed under it, every terminal delta has been queued
            finished = self.engine.step()
            self._sweep_finished(finished)
        return [RequestOutput.of(r) for r in finished]

    def drain(self, max_steps: int = 1_000_000) -> List[RequestOutput]:
        """Run until idle; returns everything that finished on the way."""
        self._require_interactive("drain")
        out: List[RequestOutput] = []
        for _ in range(max_steps):
            if not self.has_work:
                break
            out.extend(self.step())
        return out

    def generate(self, prompt: Sequence[int],
                 sampling: Optional[SamplingParams] = None,
                 max_steps: int = 1_000_000, **kw) -> RequestOutput:
        """Submit one request and run the substrate until it finishes.
        Other in-flight work keeps progressing — this is a wait, not an
        exclusive lease on the server."""
        rid = self.submit(prompt, sampling, **kw)
        req = self._requests[rid]
        for _ in range(max_steps):
            if req.is_finished or not self.has_work:
                break
            self.step()
        return RequestOutput.of(req)

    def abort(self, request_id: str) -> bool:
        """Stop a request wherever it stands; frees its KV pages and state
        slot.  Returns True when the request was found (the final
        ``finish_reason="abort"`` delta may arrive a tick later for requests
        inside an in-flight micro-batch)."""
        self._require_interactive("abort")
        with self._step_lock:
            found = self.engine.abort_request(request_id)
            req = self._requests.get(request_id)
            if req is not None and req.is_finished:
                # dispatch the terminal abort delta under the lock (see
                # step()): a stream observing an idle substrate must find
                # this delta already queued
                self._sweep_finished([req])
        return bool(found)

    def get(self, request_id: str) -> RequestOutput:
        return RequestOutput.of(self._requests[request_id])

    def outputs(self, request_ids: Optional[Sequence[str]] = None
                ) -> List[RequestOutput]:
        """Current view of the given (default: all) submitted requests."""
        rids = list(request_ids) if request_ids is not None \
            else list(self._requests)
        return [RequestOutput.of(self._requests[r]) for r in rids]

    # ------------------------------------------------------------- streaming
    def subscribe(self, request_id: str,
                  sink: Callable[[TokenDelta], None]) -> None:
        """Register `sink` for every `TokenDelta` of `request_id`.  Called
        from whichever thread steps the substrate — sinks must be
        thread-safe (e.g. `queue.Queue.put`).  Subscribe BEFORE submitting
        under that id, or deltas produced by an in-progress step are lost."""
        self._sinks.setdefault(request_id, []).append(sink)

    def unsubscribe(self, request_id: str, sink: Callable) -> None:
        subs = self._sinks.get(request_id)
        if subs is None:
            return
        if sink in subs:
            subs.remove(sink)
        if not subs:
            self._sinks.pop(request_id, None)

    def stream(self, prompt: Sequence[int],
               sampling: Optional[SamplingParams] = None,
               request_id: Optional[str] = None,
               max_steps: int = 1_000_000, **kw) -> Iterator[TokenDelta]:
        """Synchronous streaming: submit one request and yield its
        `TokenDelta`s as the substrate produces them, stepping it from the
        calling thread.  The last delta carries `finish_reason`.  Safe under
        concurrent callers (HTTP handler threads): steps serialize on the
        server's lock, and deltas produced by *another* thread's step are
        delivered here through the sink queue.

        The submit happens eagerly — admission errors (oversized request,
        unknown kwargs) raise *here*, before any delta exists, so callers
        that must commit to a response format first (HTTP) can still turn
        them into a clean client error."""
        self._require_interactive("stream")
        q: queue.Queue = queue.Queue()
        rid = request_id or f"llm-{next(LLMServer._rid_counter)}"
        self.subscribe(rid, q.put)
        try:
            self.submit(prompt, sampling, request_id=rid, **kw)
        except Exception:
            self.unsubscribe(rid, q.put)
            raise
        return self._stream_deltas(rid, q, max_steps)

    def _stream_deltas(self, rid: str, q: "queue.Queue",
                       max_steps: int) -> Iterator[TokenDelta]:
        try:
            for _ in range(max_steps):
                try:
                    delta = q.get_nowait()
                except queue.Empty:
                    if not self.has_work:
                        # another thread's step/abort may be mid-flight with
                        # our terminal delta not yet dispatched; all
                        # dispatches happen under the step lock, so taking
                        # it once is the barrier that makes emptiness final
                        with self._step_lock:
                            pass
                        if not self.has_work and q.empty():
                            break   # drained — whatever is queued is final
                        continue
                    self.step()
                    continue
                yield delta
                if delta.finish_reason is not None:
                    return
            while True:             # the terminal delta may already be queued
                try:
                    delta = q.get_nowait()
                except queue.Empty:
                    return
                yield delta
                if delta.finish_reason is not None:
                    return
        finally:
            self.unsubscribe(rid, q.put)

    async def generate_stream(self, prompt: Sequence[int],
                              sampling: Optional[SamplingParams] = None,
                              request_id: Optional[str] = None, **kw
                              ) -> AsyncIterator[TokenDelta]:
        """Submit and stream `TokenDelta`s as they materialize.  The last
        delta carries `finish_reason`.  A background runner task (shared by
        all concurrent streams) steps the substrate on a worker thread."""
        self._require_interactive("generate_stream")
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()

        def sink(delta: TokenDelta) -> None:
            loop.call_soon_threadsafe(q.put_nowait, delta)

        rid = request_id or f"llm-{next(LLMServer._rid_counter)}"
        # subscribe BEFORE the engine can see the request: the runner thread
        # may produce tokens the moment add_request lands
        self.subscribe(rid, sink)
        try:
            self.submit(prompt, sampling, request_id=rid, **kw)
        except Exception:
            self.unsubscribe(rid, sink)
            raise
        self._ensure_runner(loop)
        try:
            while True:
                delta = await q.get()
                yield delta
                if delta.finish_reason is not None:
                    return
        finally:
            self.unsubscribe(rid, sink)

    def _ensure_runner(self, loop: asyncio.AbstractEventLoop) -> None:
        if self._runner_task is not None and not self._runner_task.done():
            return

        async def run() -> None:
            # blocking device steps on a worker thread; intake and token
            # streaming stay responsive on the event loop (gLLM §3.3)
            while not self._closed and self.has_work:
                await asyncio.to_thread(self.step)

        self._runner_task = loop.create_task(run())

    # -------------------------------------------------------------- replay
    def replay(self) -> List[RequestOutput]:
        """Trace-replay servers: drive the recorded stream (requests,
        aborts, migrations, ticks) through a fresh scheduler and return the
        re-materialized outputs.  Strict mode asserts every scheduler
        decision matches the recording (`TraceDivergence` otherwise);
        timing-only replays the costs but lets decisions drift.  The full
        `ReplayReport` is kept on `self.last_report`."""
        if self._replay_trace is None:
            raise RuntimeError("not a trace-replay server: build with "
                               'ServeSpec(backend="trace", ...)')
        from repro_torch.runtime.trace import replay_trace
        report = replay_trace(self._replay_trace, mode=self._replay_mode)
        self.last_report = report
        for req in report.finished:
            self._requests.setdefault(req.request_id, req)
        return [RequestOutput.of(r) for r in report.finished]

    # ---------------------------------------------------------------- stats
    def stats(self) -> ServerStats:
        out = ServerStats()
        roles = getattr(self.router, "roles", None)
        for i, replica in enumerate(self.replicas):
            sched = replica.scheduler
            # iterating the waiting deque must not race a concurrent
            # submit/step mutating it (same reason intake serializes)
            with self._step_lock:
                by_class: Dict[str, int] = {}
                for req in sched.waiting:
                    cls = req.sampling.slo_class
                    by_class[cls] = by_class.get(cls, 0) + 1
            # engine replicas expose per-tick attention-depth stats on their
            # backend; sim/trace replicas have no EngineStats — leave defaults
            eng_stats = getattr(getattr(replica, "backend", None), "stats",
                                None)
            out.replicas.append(ReplicaStats(
                index=i,
                ticks=sched.stats.ticks,
                tokens_retired=sched.stats.tokens_retired,
                service_rate=sched.stats.service_rate,
                kv_free_rate=sched.kv.kv_free_rate,
                waiting=len(sched.waiting),
                running_decode=sched.num_running_decode,
                preemptions=sched.stats.preemptions,
                role=roles[i] if roles is not None else "mixed",
                waiting_by_class=by_class,
                prefix_lookups=sched.stats.prefix_lookups,
                prefix_hits=sched.stats.prefix_hits,
                prefix_tokens_avoided=sched.stats.prefix_tokens_avoided,
                bucket=getattr(eng_stats, "last_bucket", None),
                scanned_pages=getattr(eng_stats, "scanned_pages", 0),
                live_pages=getattr(eng_stats, "live_pages", 0),
            ))
        router = self.router
        if router is not None:
            out.routed_counts = list(router.routed_counts)
            out.replica_ordinals = list(router.replica_ids)
            if router.rebalance_policy is not None:
                out.rebalance = router.rebalance_stats
            if router.handoff_policy is not None:
                out.disagg = router.disagg_stats
            out.fleet_size = len(router._serving())
            out.draining = len(router._draining)
            out.retired = len(router.retired)
            if router.autoscale_policy is not None:
                out.autoscale = router.autoscale_stats
        finished = self._finished_requests()
        if finished:
            from repro_torch.runtime.autoscale import attainment_by_class
            out.attainment_by_class = attainment_by_class(finished)
        return out

    def _finished_requests(self) -> List[Request]:
        """Everything the substrate has retired (cluster-wide, including
        work that finished on since-retired replicas)."""
        if self.engine is None:
            return [r for r in self._requests.values() if r.is_finished]
        fin = getattr(self.engine, "finished", None)
        if fin is None:
            fin = self.engine.metrics.finished
        return list(fin)

    def close(self) -> None:
        """Flush and close any attached trace recorders/streams, and end
        the worker ranks of rank engines.  A second call does nothing
        more."""
        self._closed = True
        self._idle_stop.set()
        if self._idle_thread is not None:
            self._idle_thread.join()
        router = self.router
        if router is not None and getattr(router, "_trace", None) is not None:
            router.close_trace()
        for replica in self.replicas:
            rec = getattr(replica, "recorder", None)
            if rec is not None:
                rec.close()
        if self.links:
            with self._step_lock:
                for link in self.links:
                    link.stop()

    @property
    def idle_sent(self) -> int:
        """Idle commands sent to the worker ranks so far."""
        return sum(link.idle_sent for link in self.links)

    def _keep_alive(self) -> None:
        """The idle thread: every half `idle_s`, the idle command on each
        link that sent nothing for `idle_s` seconds, unless a step holds
        the lock (it sends commands itself)."""
        while not self._idle_stop.wait(self.idle_s / 2):
            if not self._step_lock.acquire(blocking=False):
                continue
            try:
                for link in self.links:
                    link.idle(self.idle_s)
            finally:
                self._step_lock.release()

    def __enter__(self) -> "LLMServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- internals
    def _require_interactive(self, what: str) -> None:
        if self.engine is None:
            raise RuntimeError(
                f"{what}() needs a live substrate; this is a strict "
                "trace-replay server — call replay(), or build with "
                "TraceSpec(timing_only=True) to serve new requests")

    def _chain_preempt(self, prev: Optional[Callable[[Request], None]]
                       ) -> Callable[[Request], None]:
        def hook(req: Request) -> None:
            if prev is not None:
                prev(req)
            self._on_preempt(req)
        return hook

    def _on_preempt(self, req: Request) -> None:
        rid = req.request_id
        if req.is_finished:
            return      # abort finalization under a fault path, not a pause
        self._resume_pending.add(rid)
        self._dispatch(TokenDelta(rid, None, req.num_output_tokens,
                                  event=EVENT_PREEMPT))

    def _on_token(self, req: Request, token: int) -> None:
        rid = req.request_id
        if req.state is RequestState.FINISHED_ABORTED:
            # the retiring tick produced a token for a request that was
            # aborted while in flight: it was discarded, not recorded — the
            # stream ends with the abort delta from the finished sweep
            return
        event = None
        if rid in self._resume_pending:
            self._resume_pending.discard(rid)
            event = EVENT_PREEMPT_RESUMED
        finish = req.finish_reason if req.is_finished else None
        self._dispatch(TokenDelta(rid, int(token), req.num_output_tokens,
                                  finish_reason=finish, event=event))
        if finish is not None:
            self._final_emitted.add(rid)

    def _sweep_finished(self, finished: Sequence[Request]) -> None:
        """Emit the terminal delta for requests that finished without a
        final token of their own (aborts, in-transit aborts)."""
        for req in finished:
            rid = req.request_id
            if rid in self._final_emitted:
                continue
            self._final_emitted.add(rid)
            self._resume_pending.discard(rid)
            self._dispatch(TokenDelta(rid, None, req.num_output_tokens,
                                      finish_reason=req.finish_reason))

    def _dispatch(self, delta: TokenDelta) -> None:
        subs = self._sinks.get(delta.request_id)
        if not subs:
            return
        for sink in list(subs):
            sink(delta)
