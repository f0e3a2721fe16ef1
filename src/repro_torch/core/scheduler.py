"""Iteration-level pipeline scheduler with Token Throttling (gLLM §3).

One `schedule()` call forms one micro-batch (= one pipeline tick's worth of
work for the first stage).  The scheduler is policy-parameterized:

  * ``PrefillPolicy.GLLM``    — Token Throttling (the paper's technique):
        decode:  #D = ceil(#RD / #PP_depth)                       (eq. 4)
        prefill: #P from eq. (3) (WT + UT + threshold)
  * ``PrefillPolicy.SARATHI`` — the baseline (Sarathi-Serve / vLLM policy):
        all available decode tokens first, then chunked prefill up to the
        fixed token budget (#MaxP).
  * ``NO_WT`` / ``NO_UT``     — the paper's ablations (Fig. 15).

Pipeline-parallel correctness constraint: a request may be resident in at most
one in-flight micro-batch (its KV pages are appended in sequence order), so
requests scheduled into batch *t* are unavailable until `complete(t)`.

Over data replicas (`kv_manager.ReplicaKVManager`) one scheduler forms the
batch of every replica at once: the budgets read the totals over the
replicas (pending prefill tokens, the KV idle rate), a request is placed in
a replica when it is admitted and stays there (the replica that caches the
longest prefix of its prompt first; admission's prefix path then adopts
from that replica's pool), the row limits
(`max_prefill_seqs`, `max_decode_seqs`) hold for each replica's rows, and a
request preempts only requests of its own replica.  With one pool it is
the one-replica case of the same code.
"""

from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.kv_manager import PagedKVManager
from repro_torch.core.request import Request, RequestState
from repro_torch.core.throttle import (
    PrefillPolicy,
    ThrottleConfig,
    decode_budget,
    prefill_budget,
)


@dataclass
class ScheduledSeq:
    """One sequence's contribution to a micro-batch."""

    request: Request
    start_pos: int          # context length before this step (tokens with KV)
    num_tokens: int         # chunk length (prefill) or 1 (decode)
    is_prefill: bool
    # (page, slot) per new token — where this step writes KV.
    slots: List[Tuple[int, int]] = field(default_factory=list)

    @property
    def produces_token(self) -> bool:
        """True if this entry emits a sampled token (decode, or final chunk)."""
        if not self.is_prefill:
            return True
        return self.start_pos + self.num_tokens == self.request.num_effective_prompt_tokens


@dataclass
class ScheduledBatch:
    batch_id: int
    prefill: List[ScheduledSeq]
    decode: List[ScheduledSeq]

    @property
    def num_prefill_tokens(self) -> int:
        return sum(s.num_tokens for s in self.prefill)

    @property
    def num_decode_tokens(self) -> int:
        return len(self.decode)

    @property
    def num_tokens(self) -> int:
        return self.num_prefill_tokens + self.num_decode_tokens

    @property
    def seqs(self) -> List[ScheduledSeq]:
        return self.prefill + self.decode

    @property
    def is_empty(self) -> bool:
        return not self.prefill and not self.decode


@dataclass
class SchedulerStats:
    """Per-tick observability (drives Fig. 1/4-style benchmarks)."""

    ticks: int = 0
    scheduled_prefill_tokens: List[int] = field(default_factory=list)
    scheduled_decode_tokens: List[int] = field(default_factory=list)
    kv_free_rate: List[float] = field(default_factory=list)
    # Raw throttle decisions per tick (eqs. 3/4 outputs, or the Sarathi
    # equivalents), before capacity clamps — the golden-trace regression
    # surface for core/throttle.py + this scheduler (tests/test_trace.py).
    prefill_budgets: List[int] = field(default_factory=list)
    decode_budgets: List[int] = field(default_factory=list)
    preemptions: int = 0
    # Service rate: tokens retired per second, EWMA over retire-to-retire
    # windows on the replica's own clock (wall or virtual).  This is the
    # *discovered* per-replica throughput signal the router can divide
    # balance scores by instead of static `ReplicaCapacity` hints.
    tokens_retired: int = 0
    service_rate: Optional[float] = None
    service_rate_alpha: float = 0.1
    _rate_clock: Optional[float] = None
    _rate_tokens: int = 0
    # Prefix caching (DESIGN.md §13): admission probes the pool's prefix
    # index for every first chunk; hits adopt the cached head and skip its
    # prefill entirely.  `cached_prefill_tokens` is the per-tick series —
    # the trace's optional `cached` field (schema 1.4) and the surface
    # benchmarks/fig_prefix_cache.py plots.
    prefix_lookups: int = 0
    prefix_hits: int = 0
    prefix_tokens_avoided: int = 0
    cached_prefill_tokens: List[int] = field(default_factory=list)

    def note_retire(self, num_tokens: int, now: float) -> None:
        """Fold one batch completion into the service-rate EWMA.  Tokens
        accumulate until the clock advances (virtual time can retire several
        batches at one instant), so every sample has a positive window."""
        self.tokens_retired += num_tokens
        self._rate_tokens += num_tokens
        if self._rate_clock is None:
            self._rate_clock = now
            return
        dt = now - self._rate_clock
        if dt <= 0.0:
            return
        rate = self._rate_tokens / dt
        if self.service_rate is None:
            self.service_rate = rate
        else:
            self.service_rate += self.service_rate_alpha * (
                rate - self.service_rate)
        self._rate_clock = now
        self._rate_tokens = 0


class PipelineScheduler:
    """Global scheduler owned by the driver worker."""

    def __init__(
        self,
        cfg: ThrottleConfig,
        kv: PagedKVManager,
        max_model_len: int = 1 << 20,
        max_batch_seqs: int = 4096,
        max_prefill_seqs: int = 4096,   # static tick bucket Sp
        max_chunk_tokens: int = 1 << 20,  # static tick bucket C
        max_decode_seqs: int = 4096,    # static tick bucket Sd
    ) -> None:
        self.cfg = cfg
        self.kv = kv
        self.max_model_len = max_model_len
        self.max_batch_seqs = max_batch_seqs
        self.max_prefill_seqs = max_prefill_seqs
        self.max_chunk_tokens = max_chunk_tokens
        self.max_decode_seqs = max_decode_seqs

        # Admission queue in arrival order; `admission_order()` derives the
        # SLO-class-aware order eq. 3's budget is actually spent in.
        self.waiting: Deque[Request] = deque()
        self.running_prefill: List[Request] = []         # partially prefilled
        self.running_decode: List[Request] = []          # decoding (FCFS order)
        self._in_flight: Dict[str, int] = {}             # request_id -> batch_id
        self._aborting: set = set()                      # in-flight, abort pending
        self._batches: Dict[int, ScheduledBatch] = {}
        self._batch_counter = itertools.count()
        self.stats = SchedulerStats()
        self._last_prefill_budget = 0
        self._last_decode_budget = 0
        self._last_cached_tokens = 0
        # Notified whenever a request loses its resident state (preemption or
        # batch abort) so the execution layer can release per-request
        # resources (state slots, caches) tied to residency.
        self.on_preempt: Optional[Callable[[Request], None]] = None

    # ---------------------------------------------------------------- intake
    def add_request(self, req: Request) -> None:
        total = req.num_prompt_tokens + req.sampling.max_new_tokens
        if total > self.max_model_len:
            raise ValueError(
                f"request {req.request_id}: {total} tokens > max_model_len {self.max_model_len}"
            )
        pool = self.kv.pool_pages * self.kv.page_size
        if total > pool:
            # would livelock on preempt/recompute: reject at admission
            raise ValueError(
                f"request {req.request_id}: {total} tokens exceed the KV pool "
                f"({pool} token slots) — unservable on this replica")
        req.state = RequestState.WAITING
        self.waiting.append(req)

    # ------------------------------------------------------------- accounting
    @property
    def num_waiting_prefill_tokens(self) -> int:
        """#WP — global pending prefill work (waiting + partially prefilled)."""
        wp = sum(r.remaining_prefill_tokens for r in self.waiting)
        wp += sum(r.remaining_prefill_tokens for r in self.running_prefill)
        return wp

    @property
    def num_running_decode(self) -> int:
        """#RD — all decode-state requests, in flight or not."""
        return len(self.running_decode)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running_prefill or self.running_decode
                    or self._in_flight)

    # ----------------------------------------------------------- batch lookup
    def get_batch(self, batch_id: int) -> Optional[ScheduledBatch]:
        """In-flight micro-batch by id; None once completed or aborted.

        This is the public API the execution layer uses to resolve ring
        entries back to their sequences — batches stay resolvable from
        `schedule()` until the matching `complete()`/`abort_batch()`."""
        return self._batches.get(batch_id)

    def active_batch_ids(self) -> List[int]:
        """Ids of all in-flight micro-batches, in scheduling order."""
        return list(self._batches)

    # ---------------------------------------------------------------- schedule
    def schedule(self, now: float = 0.0) -> ScheduledBatch:
        batch_id = next(self._batch_counter)
        decode_seqs = self._schedule_decode(now)
        prefill_seqs = self._schedule_prefill(now, len(decode_seqs))
        batch = ScheduledBatch(batch_id, prefill_seqs, decode_seqs)
        for seq in batch.seqs:
            self._in_flight[seq.request.request_id] = batch_id
        self._batches[batch_id] = batch

        self.stats.ticks += 1
        self.stats.scheduled_prefill_tokens.append(batch.num_prefill_tokens)
        self.stats.scheduled_decode_tokens.append(batch.num_decode_tokens)
        self.stats.kv_free_rate.append(self.kv.kv_free_rate)
        self.stats.prefill_budgets.append(self._last_prefill_budget)
        self.stats.decode_budgets.append(self._last_decode_budget)
        self.stats.cached_prefill_tokens.append(self._last_cached_tokens)
        return batch

    # ----------------------------------------------------------------- decode
    def _schedule_decode(self, now: float) -> List[ScheduledSeq]:
        available = [r for r in self.running_decode
                     if r.request_id not in self._in_flight]
        if self.cfg.policy is PrefillPolicy.SARATHI:
            quota = len(available)                     # decode-first, all of it
        else:
            quota = decode_budget(self.num_running_decode, self.cfg)
        self._last_decode_budget = quota               # raw eq. 4 decision
        quota = min(quota, len(available), self.max_batch_seqs,
                    self.max_decode_seqs * self.kv.replicas)

        out: List[ScheduledSeq] = []
        scheduled: set = set()
        rows = [0] * self.kv.replicas          # decode rows per replica
        for req in available:
            if len(out) >= quota:
                break
            if req.state is not RequestState.DECODING:
                # victimized by an earlier iteration's page hunt this very
                # tick: its KV is gone and it is back in the waiting queue —
                # scheduling it now would resurrect a zero-context decode
                continue
            home = self.kv.replica_of(req.request_id)
            if rows[home] >= self.max_decode_seqs:
                continue  # its replica's decode rows are full
            if not self._ensure_decode_page(req, protected=scheduled):
                continue  # could not allocate even after preemption: defer
            slots = self.kv.allocate(req.request_id, 1)
            out.append(ScheduledSeq(req, req.seq_len, 1, False, slots))
            scheduled.add(req.request_id)
            rows[home] += 1
        return out

    def _ensure_decode_page(self, req: Request,
                            protected: frozenset = frozenset()) -> bool:
        """Make room for one decode token, preempting if necessary (§3.1.3).
        `protected` requests (already in the batch being formed, with slots
        allocated) must not be victimized — freeing their pages would tear
        the very slots this tick is about to write.  Only a request of its
        own replica frees pages it can use."""
        while not self.kv.can_allocate(req.request_id, 1):
            victim = self._pick_preemption_victim(
                exclude={req.request_id} | set(protected),
                replica=self.kv.replica_of(req.request_id))
            if victim is None:
                return False
            self._preempt(victim)
        return True

    def _victim_order(self, group: List[Request]) -> List[Request]:
        """Preemption order within one residency group: batch-class requests
        are victimized before interactive ones, lower `priority` before
        higher, and within a tie the latest arrival goes first (vLLM
        recompute policy).  With every request at the defaults this reduces
        to plain latest-arrival-first."""
        return sorted(reversed(group),
                      key=lambda r: (-r.slo_rank, r.priority))

    def _pick_preemption_victim(self, exclude, replica: Optional[int] = None
                                ) -> Optional[Request]:
        """Resident request to evict, SLO-class-aware (batch-first).

        Partially-prefilled requests are victims *first*: a stalled chunked
        prefill holding pages while decode is starved is otherwise a
        deadlock (decode can only preempt decode, prefill can only shrink).
        Then decode requests — in both groups batch-class before
        interactive, then latest arrival (`_victim_order`).  With `replica`,
        only a request living in that replica."""
        if isinstance(exclude, str):
            exclude = {exclude}
        for group in (self.running_prefill, self.running_decode):
            for req in self._victim_order(group):
                if req.request_id in exclude \
                        or req.request_id in self._in_flight:
                    continue
                if replica is not None and \
                        self.kv.replica_of(req.request_id) != replica:
                    continue
                return req
        return None

    def _preempt(self, req: Request) -> None:
        self.kv.free(req.request_id)
        if req in self.running_decode:
            self.running_decode.remove(req)
        if req in self.running_prefill:
            self.running_prefill.remove(req)
        req.preempt()
        req.state = RequestState.WAITING
        self.waiting.appendleft(req)   # recompute with priority
        self.stats.preemptions += 1
        if self.on_preempt is not None:
            self.on_preempt(req)

    # ---------------------------------------------------------------- prefill
    def admission_order(self) -> List[Request]:
        """Waiting requests in the order eq. 3's prefill budget admits them:
        interactive class before batch, higher `priority` first within a
        class, queue position (FCFS, with preempted requests re-queued at
        the front) within a priority.  The sort is stable, so a queue of
        all-default requests admits in exactly the pre-SLO FCFS order —
        which keeps recorded traces replaying bit-identically."""
        return sorted(self.waiting,
                      key=lambda r: (r.slo_rank, -r.priority))

    def _schedule_prefill(self, now: float, num_decode: int) -> List[ScheduledSeq]:
        if self.cfg.policy is PrefillPolicy.SARATHI:
            budget = max(0, self.cfg.max_prefill_tokens - num_decode)
        else:
            budget = prefill_budget(
                self.num_waiting_prefill_tokens, self.kv.kv_free_rate, self.cfg
            )
        self._last_prefill_budget = budget             # raw eq. 3 decision
        self._last_cached_tokens = 0
        if budget <= 0:
            return []

        out: List[ScheduledSeq] = []
        n = self.kv.replicas
        rows = [0] * n                          # prefill rows per replica

        # 1) continue chunked prefills already in progress (not in flight)
        for req in self.running_prefill:
            if budget <= 0 or len(out) >= self.max_prefill_seqs * n:
                break
            if req.request_id in self._in_flight:
                continue
            home = self.kv.replica_of(req.request_id)
            if rows[home] >= self.max_prefill_seqs:
                continue  # its replica's prefill rows are full
            took = self._take_prefill_chunk(req, budget, now)
            if took is None:
                break  # KV exhausted: stop prefill scheduling entirely
            out.append(took)
            rows[home] += 1
            budget -= took.num_tokens

        # 2) admit new requests from the waiting queue, SLO-class order
        admitted: set = set()
        for req in self.admission_order():
            if budget <= 0 or len(out) >= min(
                    self.max_batch_seqs, self.max_prefill_seqs * n):
                break
            if self.cfg.policy is not PrefillPolicy.SARATHI:
                # UT guard: don't admit when below the KV idle threshold.
                if self.kv.kv_free_rate <= self.cfg.kv_threshold:
                    break
            home = self.kv.place(req.request_id, [
                r for r in range(n) if rows[r] < self.max_prefill_seqs],
                req.effective_prompt[:-1]
                if req.num_prefilled == 0 else None)
            if home is None:
                break  # no replica has a prefill row left
            # prefix-cache reuse on first chunk
            adopted = 0
            if req.num_prefilled == 0 and self.kv.enable_prefix_caching \
                    and not self.kv.has_request(req.request_id):
                self.stats.prefix_lookups += 1
                cached, pages = self.kv.match_prefix(
                    req.effective_prompt[:-1], req.request_id)
                if cached:
                    self.kv.adopt_prefix(req.request_id, cached, pages)
                    req.num_prefilled = cached
                    adopted = cached
            took = self._take_prefill_chunk(req, budget, now)
            if took is None:
                if adopted:
                    # Release-on-stall: the chunk could not take even one
                    # token (KV exhausted), so the request stays WAITING —
                    # it must not pin the adopted head under the very KV
                    # pressure that stalled it.  The pages return to the
                    # evictable LRU still hashed, so a later admission
                    # re-matches them for free.  Invariant restored: a
                    # WAITING request never holds KV.
                    self.kv.free(req.request_id)
                    req.num_prefilled = 0
                self.kv.unplace(req.request_id)
                break
            if adopted:
                self.stats.prefix_hits += 1
                self.stats.prefix_tokens_avoided += adopted
                self._last_cached_tokens += adopted
            admitted.add(req.request_id)
            req.state = RequestState.PREFILLING
            if req.metrics.first_scheduled_time is None:
                req.metrics.first_scheduled_time = now
            if not took.produces_token:
                self.running_prefill.append(req)
            out.append(took)
            rows[home] += 1
            budget -= took.num_tokens
        if admitted:
            # one O(n) rebuild instead of an O(n) deque.remove per admission
            # — the tick loop stays linear in queue depth
            self.waiting = deque(r for r in self.waiting
                                 if r.request_id not in admitted)
        return out

    def _take_prefill_chunk(
        self, req: Request, budget: int, now: float
    ) -> Optional[ScheduledSeq]:
        chunk = min(req.remaining_prefill_tokens, budget,
                    self.max_chunk_tokens)
        if chunk <= 0:
            return None
        if not self.kv.can_allocate(req.request_id, chunk):
            # Shrink to what fits rather than stalling completely.
            cur = self.kv.num_tokens(req.request_id)
            slack = (self.kv.page_size - cur % self.kv.page_size) % self.kv.page_size
            headroom = slack + (self.kv.free_pages_of(req.request_id)
                                * self.kv.page_size)
            chunk = min(chunk, headroom)
            if chunk <= 0:
                return None
        slots = self.kv.allocate(req.request_id, chunk)
        seq = ScheduledSeq(req, req.num_prefilled, chunk, True, slots)
        if req in self.running_prefill and seq.produces_token:
            self.running_prefill.remove(req)
        return seq

    # ---------------------------------------------------------------- complete
    def complete(
        self,
        batch_id: int,
        sampled_tokens: Sequence[int],
        now: float = 0.0,
    ) -> List[Request]:
        """Apply results of a finished micro-batch.

        `sampled_tokens` has one token per token-producing seq, in batch order
        (prefill entries first, then decode), matching `produces_token`.
        Returns requests that finished this tick.
        """
        batch = self._batches.pop(batch_id)
        finished: List[Request] = []
        it = iter(sampled_tokens)
        for seq in batch.seqs:
            req = seq.request
            self._in_flight.pop(req.request_id, None)
            # The step wrote KV for every token it consumed (prefill chunk, or
            # the single consumed token of a decode step).
            req.num_prefilled = seq.start_pos + seq.num_tokens
            if req.request_id in self._aborting:
                # aborted while this micro-batch was in flight: consume the
                # sampled token (alignment), but discard it — the user asked
                # for the request to stop, so nothing is recorded
                self._aborting.discard(req.request_id)
                if seq.produces_token:
                    next(it)
                for group in (self.running_prefill, self.running_decode):
                    if req in group:
                        group.remove(req)
                self._finalize_abort(req, now)
                finished.append(req)
                continue
            if not seq.produces_token:
                continue
            if seq.is_prefill and self.kv.enable_prefix_caching:
                # chunk completed the (effective) prompt -> freeze full pages
                self.kv.freeze_full_pages(req.request_id, req.effective_prompt)
            token = int(next(it))
            req.record_new_token(token, now)
            if req.is_finished:
                self.kv.free(req.request_id)
                if req in self.running_decode:
                    self.running_decode.remove(req)
                finished.append(req)
            elif seq.is_prefill:
                req.state = RequestState.DECODING
                self.running_decode.append(req)
        remaining = sum(1 for _ in it)
        assert remaining == 0, f"{remaining} unconsumed sampled tokens"
        self.stats.note_retire(len(sampled_tokens), now)
        return finished

    # ------------------------------------------------------------------ abort
    def abort_request(self, request_id: str, now: float = 0.0
                      ) -> Optional[Request]:
        """User-initiated abort, wherever the request stands.

        Waiting and running (not-in-flight) requests finalize immediately:
        KV pages freed, state -> FINISHED_ABORTED.  A request inside an
        in-flight micro-batch cannot be torn down mid-tick (its KV writes are
        still materializing on device); it is flagged and finalized by
        `complete()` when the batch retires, appearing in that tick's
        finished list.  Returns the request (check `is_finished` to tell
        immediate from deferred), or None when unknown / already finished.

        Callers owning backend state must release it for immediately-
        finalized requests (`ExecutionBackend.finish_request`); deferred ones
        flow through the TickLoop's normal retire path.
        """
        if request_id in self._aborting:
            return None
        if request_id in self._in_flight:
            batch = self._batches[self._in_flight[request_id]]
            for seq in batch.seqs:
                if seq.request.request_id == request_id:
                    self._aborting.add(request_id)
                    return seq.request
            return None
        for req in self.waiting:
            if req.request_id == request_id:
                self.waiting.remove(req)
                self._finalize_abort(req, now)
                return req
        for group in (self.running_prefill, self.running_decode):
            for req in group:
                if req.request_id == request_id:
                    group.remove(req)
                    self._finalize_abort(req, now)
                    return req
        return None

    def _finalize_abort(self, req: Request, now: float) -> None:
        """KV pages released (a waiting request may still hold an adopted
        prefix-cache head), terminal state + finish time stamped."""
        self.kv.free(req.request_id)
        req.state = RequestState.FINISHED_ABORTED
        req.metrics.finish_time = now

    # -------------------------------------------------------------- migration
    def drain_request(self, request_id: str) -> Optional[Request]:
        """Remove a request from this scheduler for live migration.

        Only requests *not* in an in-flight micro-batch can be drained (a
        resident micro-batch's KV writes are still materializing on device);
        returns None for those — the control plane retries next pass.  The
        request's KV stays resident: the migrator exports/frees it
        explicitly (`PagedKVManager.export_kv`), so a failed transfer can
        re-adopt locally without losing state.
        """
        if request_id in self._in_flight:
            return None
        for group in (self.running_decode, self.running_prefill):
            for req in group:
                if req.request_id == request_id:
                    group.remove(req)
                    return req
        for req in self.waiting:
            if req.request_id == request_id:
                self.waiting.remove(req)
                # A WAITING request owns no migratable state: if it holds an
                # adopted prefix-cache head, release it here (the pages stay
                # hashed in the evictable LRU) and let the destination
                # re-match against *its* cache at admission.  Without this
                # the steal path strands the source block table and the
                # destination's `adopt_request` rejects the orphaned
                # `num_prefilled` count.
                if self.kv.has_request(request_id):
                    self.kv.free(request_id)
                    req.num_prefilled = 0
                return req
        return None

    def adopt_request(self, req: Request) -> None:
        """Admit a drained request at its *current position* (no recompute).

        The caller must have imported the request's KV first
        (`PagedKVManager.import_kv`): every token counted by
        `req.num_prefilled` needs resident KV here.  The request resumes in
        the queue its progress implies — decoding, mid-prefill, or waiting.
        """
        rid = req.request_id
        if req.is_finished:
            raise ValueError(f"request {rid} already finished")
        resident = self.kv.num_tokens(rid)
        if resident != req.num_prefilled:
            raise ValueError(
                f"request {rid}: {req.num_prefilled} prefilled tokens but "
                f"{resident} with resident KV — import_kv before adopt")
        # Placement follows the drained *state*, not progress counters: a
        # DECODING request keeps one KV slot unwritten (its next decode step
        # consumes the newest sampled token), so counters alone cannot
        # distinguish it from a nearly-done prefill — and a WAITING request
        # with an adopted prefix head has num_prefilled > 0 without ever
        # having been admitted.  Only requests that were already admitted
        # (PREFILLING mid-chunk) may bypass the UT guard and SLO-class
        # admission order; everything else re-enters through `waiting`.
        if req.state is RequestState.DECODING:
            self.running_decode.append(req)
        elif req.state is RequestState.PREFILLING and req.num_prefilled > 0:
            self.running_prefill.append(req)
        else:
            req.state = RequestState.WAITING
            self.waiting.append(req)

    def steal_candidates(self) -> List[Request]:
        """Waiting requests a rebalancer may take, cheapest-first: stolen
        from the *tail* (last arrivals — FCFS order of the remainder is
        preserved).  Requests that already hold KV here (an adopted prefix-
        cache head) are skipped: stealing them would strand pages."""
        return [r for r in reversed(self.waiting)
                if not self.kv.has_request(r.request_id)]

    # ----------------------------------------------------------- fault paths
    def abort_batch(self, batch_id: int, now: float = 0.0) -> List[Request]:
        """A worker died mid-flight: the micro-batch's results never arrive.
        Affected requests recover by recompute — decode/partial-prefill
        requests are preempted (KV freed, re-queued with priority); their
        already-generated tokens are preserved (recompute re-prefills them).
        Requests with a pending user abort finalize it instead of requeuing.
        Returns the affected requests (check `is_finished` for the aborted
        ones — they need backend release, not recompute)."""
        batch = self._batches.pop(batch_id, None)
        if batch is None:
            return []
        affected = []
        for seq in batch.seqs:
            req = seq.request
            self._in_flight.pop(req.request_id, None)
            if req.is_finished:
                continue
            if req.request_id in self._aborting:
                # the user had already asked for this request to stop: the
                # fault finalizes the abort instead of queueing a recompute
                self._aborting.discard(req.request_id)
                for group in (self.running_prefill, self.running_decode):
                    if req in group:
                        group.remove(req)
                self._finalize_abort(req, now)
                affected.append(req)
                continue
            self.kv.free(req.request_id)
            if req in self.running_decode:
                self.running_decode.remove(req)
            if req in self.running_prefill:
                self.running_prefill.remove(req)
            req.preempt()
            req.state = RequestState.WAITING
            if req not in self.waiting:
                self.waiting.appendleft(req)
            self.stats.preemptions += 1
            if self.on_preempt is not None:
                self.on_preempt(req)
            affected.append(req)
        return affected

    # ------------------------------------------------------------- invariants
    def check_invariants(self) -> None:
        self.kv.check_invariants()
        ids = [r.request_id for r in self.running_decode]
        assert len(ids) == len(set(ids)), "duplicate request in running_decode"
        for rid in self._in_flight:
            assert self._in_flight[rid] in self._batches
