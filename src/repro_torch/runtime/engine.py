"""gLLM serving engine on PyTorch (``repro.runtime.engine``).

`TorchBackend` is the ExecutionBackend that runs the PyTorch serve tick
(`distributed.pipeline.build_serve_tick`) on one device, all S pipeline
stages of it at pp = S (S micro-batches in flight, one per stage); it owns
the parameters, the paged KV pool, the ring's activation carry and the
per-request host state.
`PipelineEngine` binds scheduler + KV manager + backend under the shared
`TickLoop`, exactly as the JAX engine does.

Per tick the host builds the metadata as numpy (`prepare`, one tick ahead),
`execute` picks the tick's bucket, ships metadata and token ids to the
device in one non-blocking copy from pinned memory (so `host_s` counts host
work, not waits for the device), replays the bucket's CUDA graph (embed,
layers, head, greedy argmax; or runs the same tick eagerly), draws the
temperature rows after it, copies the tokens back behind an event and
returns a deferred `ExecResult`: the readback lives in its `pending` thunk
and `ready()` is the event's ``query()`` (always True on the CPU).

An encoder-decoder request carries its encoder input (`add_request`'s
``enc_embeds`` [Te, d], zeros when not given, cut to ``Te``), which the
backend keeps until the request finishes or aborts (a preempted request
recomputes from it) and stages, like the token ids, into a static
device buffer the tick reads (`pipeline.build_serve_tick`'s ``p_enc``).

The live-migration hooks (`export/import_kv_pages`,
`export/import_request_state`) speak the JAX engine's wire format, so a
payload exported by either package imports into the other (an
encoder-decoder's state but for its snapshot leaves: one per encoder
group here, `models/serve.py`, one per stage in JAX).  Every device
operation of the backend runs on the device and stream it was built on
(`_on_stream`), whichever thread steps it: the CUDA graphs hold the pools'
addresses, so imports write into the pools in place, and an export's gather
is queued behind every tick already replayed.

Across ranks, `RankBackend` runs one stage at one tensor shard of one data
replica a process: rank 0's backend drives the tick loop and sends every
tick's input buffer (every replica's rows) to the other ranks, which run
it in `RankLink.serve`; the migration hooks there gather a request's
blocks from the ranks of its replica into the same wire format.  Several
engines share one layout of ranks (`RankLink`: the router's replicas,
each with its own pools on every rank), each command naming its engine.

With ``trace_path`` the engine logs every tick to a replayable JSONL trace
(`runtime/trace.py`, the JAX package's schema): a `TraceRecorder` wraps the
backend as the `TickLoop`'s backend, and a lock serialises intake against
the tick.  Traced engines are synchronous, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import (
    PagedKVManager,
    PipelineScheduler,
    ReplicaKVManager,
    Request,
    SamplingParams,
    ScheduledBatch,
    ThrottleConfig,
)
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.pipeline import (
    build_rank_serve_tick,
    build_serve_tick,
    init_carry,
    init_rank_carry,
    sample_tokens,
)
from repro_torch.kernels import ops
from repro_torch.models import serve as serve_lib
from repro_torch.models.serve import ServeDims
from repro_torch.models.transformer import expert_parts, shard_config
from repro_torch.runtime.core import ExecResult, ExecutionBackend, TickLoop


def resolve_device(device: Optional[torch.device | str]) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def _pinned(method):
    """Run a `TorchBackend` method on the backend's device and stream."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with self._on_stream():
            return method(self, *args, **kwargs)
    return run


class SlotAllocator:
    """Sequence slots for recurrent state / encoder caches."""

    def __init__(self, n: int) -> None:
        self.free = list(range(n - 1, -1, -1))
        self.owner: Dict[str, int] = {}

    def get(self, request_id: str) -> int:
        if request_id in self.owner:
            return self.owner[request_id]
        if not self.free:
            raise MemoryError("out of state slots")
        s = self.free.pop()
        self.owner[request_id] = s
        return s

    def release(self, request_id: str) -> None:
        s = self.owner.pop(request_id, None)
        if s is not None:
            self.free.append(s)


class ReplicaSlots:
    """One `SlotAllocator` per data replica: a request's slot is taken in
    the replica its KV lives in (`ReplicaKVManager.replica_of`), and
    released from whichever holds it."""

    def __init__(self, n: int, kv: ReplicaKVManager) -> None:
        self.pools = [SlotAllocator(n) for _ in range(kv.replicas)]
        self.kv = kv

    @property
    def owner(self) -> Dict[str, int]:
        return {rid: s for p in self.pools for rid, s in p.owner.items()}

    def get(self, request_id: str) -> int:
        return self.pools[self.kv.replica_of(request_id)].get(request_id)

    def release(self, request_id: str) -> None:
        for p in self.pools:
            p.release(request_id)


@dataclass
class EngineStats:
    ticks: int = 0
    tokens_out: int = 0
    padded_prefill: int = 0     # bucket padding (pipeline bubbles)
    padded_decode: int = 0
    scheduled_prefill: int = 0
    scheduled_decode: int = 0
    scanned_pages: int = 0      # block-table width the attention is given
    live_pages: int = 0         # KV pages actually holding context
    host_s: float = 0.0         # host-side per-tick work (meta/copy/launch)
    device_s: float = 0.0       # host time *blocked* on device readback
    last_bucket: Optional[Dict[str, int]] = None  # selected serve shape
    # ticks whose bucket has prefill (decode) rows: each runs that phase's
    # layers, so a kernel of one phase launches once per layer per such tick
    prefill_ticks: int = 0
    decode_ticks: int = 0
    # stages that held no micro-batch on a tick the device ran, and so
    # computed padding only: the pipeline bubble Token Throttling shrinks
    bubble_stage_ticks: int = 0


class _BucketProgram:
    """One ladder bucket's tick: its static int32 input buffer (the bucket's
    metadata, stacked over the stages at pp > 1, and the full-dims token
    ids, laid out as `serve.host_meta` orders them) and, when the backend
    replays graphs, the CUDA graph that runs the tick on that buffer, with
    the outputs it writes and the kernel launches one replay makes."""

    def __init__(self, tick, fields: Dict[str, np.ndarray],
                 device: torch.device) -> None:
        self.tick = tick
        self.shapes = {k: a.shape for k, a in fields.items()}
        self.size = sum(a.size for a in fields.values())
        self.static = torch.zeros(self.size, dtype=torch.int32,
                                  device=device)
        self.meta = serve_lib.unpack_meta(self.static, self.shapes)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None
        self.greedy: Optional[torch.Tensor] = None
        self.launches: Dict[Any, int] = {}


class TorchBackend(ExecutionBackend):
    """ExecutionBackend running the PyTorch serve tick on `device`.

    With `bucketed=True` the backend serves the fixed `bucket_ladder` of
    serve shapes (all over the full-dims caches) and each tick runs in the
    smallest bucket covering the ring; unbucketed is a ladder of one entry,
    ``(dims,)``.  Each bucket has a static input buffer (`_BucketProgram`).
    On CUDA, unless `cuda_graphs=False`, `warm_start()` captures one CUDA
    graph per bucket, all in one memory pool, and every tick is a replay:
    the host fills a pinned staging buffer, makes one non-blocking copy into
    the bucket's static buffer, replays the graph and copies the sampled
    tokens back into a pinned buffer, behind an event.  The pool is shared
    safely because every replay runs on one stream, in order, and each
    graph's outputs stay referenced.  On the CPU, and on CUDA with
    `cuda_graphs=False`, the same bucket programs run eagerly.  Two staging
    and two readback buffers alternate: the async `TickLoop` holds at most
    one deferred readback while the next tick runs.

    At pp = S the buffer holds every stage's metadata (the ring's entries),
    one bucket covers the whole ring, and the tick runs the S stages over
    the activation carry (`pipeline.init_carry`), which every bucket
    program shares."""

    replicas = 1                # data replicas whose rows a tick holds

    def __init__(self, cfg: ArchConfig, dims: ServeDims, params,
                 kv: PagedKVManager, *, device: torch.device,
                 dtype: Optional[torch.dtype] = None, seed: int = 0,
                 bucketed: bool = False, cuda_graphs: bool = True) -> None:
        self.cfg = cfg
        self.dims = dims
        self.device = device
        self.params = params
        self.dtype = dtype or getattr(torch, cfg.dtype)
        self.kv = kv
        self.slots = SlotAllocator(dims.slots)
        self.stats = EngineStats()
        self.bucketed = bucketed
        self.ladder: Tuple[ServeDims, ...] = (
            serve_lib.bucket_ladder(dims) if bucketed else (dims,))
        self.graphs = cuda_graphs and device.type == "cuda"
        # the stream every tick, capture and migration copy runs on: the
        # server may step the engine from any thread, whose current stream
        # is its own
        self._stream = (torch.cuda.current_stream(device)
                        if device.type == "cuda" else None)
        self._pool = torch.cuda.graph_pool_handle() if self.graphs else None
        self._programs: Dict[Tuple[int, ...], _BucketProgram] = {}
        self.caches, self.carry = self._make_state()
        self._gen = torch.Generator(device=device)
        self._gen.manual_seed(seed)
        self._zm = serve_lib.zero_meta(dims)
        self._prep_s = 0.0          # host prepare() time since last execute
        cuda = device.type == "cuda"
        # the largest static buffer of the ladder: the full shape's
        size = sum(a.size for a in self._fields(
            self._zero_ring(), dims, None).values())
        self._staging = [torch.empty(size, dtype=torch.int32,
                                     pin_memory=cuda) for _ in range(2)]
        self._host_tokens = [torch.empty(dims.Sp + dims.Sd,
                                         dtype=torch.int32, pin_memory=cuda)
                             for _ in range(2)]
        self._copied: List[Optional[torch.cuda.Event]] = [None, None]
        self._ring_slot = 0
        self.capture_s = 0.0        # warm_start: seconds spent
        self.graph_pool_bytes = 0   # warm_start: device memory it reserved
        # an encoder-decoder's per-request encoder input (f32, [<=Te, d]),
        # and the static device buffer the tick reads the entering prefill
        # rows' from, staged through two pinned buffers like the metadata
        self.enc_embeds: Dict[str, torch.Tensor] = {}
        self._enc = self._enc_staging = None
        if dims.Te:
            shape = (dims.Sp, dims.Te, cfg.d_model)
            self._enc = torch.zeros(shape, dtype=self.dtype, device=device)
            self._enc_staging = [torch.zeros(shape, dtype=self.dtype,
                                             pin_memory=cuda)
                                 for _ in range(2)]

    def _make_state(self):
        """The KV and state pools and the ring's activation carry."""
        return (serve_lib.init_caches(self.cfg, self.dims, self.dtype,
                                      self.device),
                init_carry(self.cfg, self.dims, self.dtype, self.device))

    def _on_stream(self):
        """Run on the backend's device and stream (a no-op on the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    # ------------------------------------------------------- bucket programs
    def _program(self, bucket: ServeDims) -> _BucketProgram:
        key = (bucket.Sp, bucket.C, bucket.Sd, bucket.Bp, bucket.Bd)
        prog = self._programs.get(key)
        if prog is None:
            tick = build_serve_tick(self.cfg, bucket, carry_dims=self.dims,
                                    dtype=self.dtype)
            prog = _BucketProgram(tick, self._fields(self._zero_ring(),
                                                     bucket, None),
                                  self.device)
            if self._enc is not None:
                prog.meta["p_enc"] = self._enc
            self._programs[key] = prog
        return prog

    def graph_count(self) -> int:
        """CUDA graphs captured across the bucket programs (flat after
        `warm_start`: serving captures none)."""
        return sum(p.graph is not None for p in self._programs.values())

    @_pinned
    @torch.inference_mode()
    def warm_start(self) -> None:
        """Run every ladder bucket once on a bubble tick (zero metadata: a
        state no-op, like any pipeline bubble; the rows that write go to the
        scratch page and slot) before serving begins, which builds every
        kernel.  With graphs, that run is made on a side stream, then the
        bucket's tick is captured into its graph and replayed once on the
        same bubble.  A capture that fails raises."""
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
            reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        for bucket in self.ladder:
            prog = self._program(bucket)
            self._load(prog, self._fields(self._zero_ring(), bucket, None))
            if not self.graphs:
                self._run(prog)
                continue
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                prog.tick(self.params, self.caches, prog.meta, self.carry)
            torch.cuda.current_stream(self.device).wait_stream(side)
            self._capture(prog)
            self._run(prog)
        if cuda:
            torch.cuda.synchronize(self.device)
            self.graph_pool_bytes = (torch.cuda.memory_reserved(self.device)
                                     - reserved)
        self.capture_s = time.perf_counter() - t0

    def _capture(self, prog: _BucketProgram) -> None:
        """Capture `prog`'s tick (the logits and the greedy tokens) into a
        CUDA graph in the shared pool.  The kernel wrappers count their
        launches while the graph is recorded; those counts are kept as the
        launches of one replay and taken back off the wrappers, since a
        capture launches nothing."""
        before = {mod: mod.launches for mod in ops.COUNTED}
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                _, logits = prog.tick(self.params, self.caches, prog.meta,
                                      self.carry)
                greedy = sample_tokens(logits)
        finally:
            prog.launches = {mod: mod.launches - n
                             for mod, n in before.items()
                             if mod.launches != n}
            for mod, n in before.items():
                mod.launches = n
        prog.graph, prog.logits, prog.greedy = graph, logits, greedy

    def _run(self, prog: _BucketProgram
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Run `prog`'s tick on its static buffer: replay its graph (and
        count the replay's kernel launches), or run it eagerly.  Returns
        (logits, greedy tokens)."""
        if self.graphs:
            if prog.graph is None:
                raise RuntimeError("bucket program not captured: "
                                   "warm_start() captures every bucket")
            prog.graph.replay()
            for mod, n in prog.launches.items():
                mod.launches += n
            return prog.logits, prog.greedy
        _, logits = prog.tick(self.params, self.caches, prog.meta,
                              self.carry)
        return logits, sample_tokens(logits)

    def _fields(self, ring: Sequence[Tuple[Optional[int], Any]],
                bucket: ServeDims, entering: Optional[ScheduledBatch]
                ) -> Dict[str, np.ndarray]:
        """The host arrays of a tick at `bucket`: each stage's metadata cut
        to the bucket with the fields the tick computes from it (stacked
        over the ring's stages at pp > 1), then the entering batch's
        full-dims token ids."""
        stacked = self._stack_meta(ring, bucket)
        p_tok, d_tok = self._fresh_tokens(entering)
        tokens = {"p_tok": p_tok, "d_tok": d_tok}
        stages = [serve_lib.host_meta({k: v[s] for k, v in stacked.items()},
                                      bucket) for s in range(len(ring))]
        if len(stages) == 1:
            return {**stages[0], **tokens}
        return {**{k: np.stack([f[k] for f in stages]) for k in stages[0]},
                **tokens}

    def _load(self, prog: _BucketProgram, fields: Dict[str, np.ndarray],
              entering: Optional[ScheduledBatch] = None) -> None:
        """Pack `fields` into this ring slot's staging buffer (once the
        device has read what it held before) and copy it into `prog`'s
        static buffer: one non-blocking copy on CUDA.  For an
        encoder-decoder whose entering batch holds prefill rows, their
        encoder inputs go the same way into the encoder buffer (zeros past
        a short input and on rows without a request)."""
        if [a.shape for a in fields.values()] != list(prog.shapes.values()):
            raise ValueError("tick metadata does not fit its bucket program")
        slot = self._ring_slot
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()
        staging = self._staging[slot][:prog.size]
        np.concatenate([a.reshape(-1) for a in fields.values()],
                       out=staging.numpy())
        prog.static.copy_(staging, non_blocking=True)
        if self._enc is not None and entering is not None \
                and entering.prefill:
            enc = self._enc_staging[slot]
            enc.zero_()
            for s, seq in enumerate(entering.prefill):
                src = self.enc_embeds.get(seq.request.request_id)
                if src is not None:
                    enc[s, :src.shape[0]].copy_(src)
            self._enc.copy_(enc, non_blocking=True)
        if self.device.type == "cuda":
            self._copied[slot] = torch.cuda.Event()
            self._copied[slot].record()

    def _select_bucket(self, ring: Sequence[Tuple[Optional[int], Any]]
                       ) -> ServeDims:
        if not self.bucketed:
            return self.dims
        need_c = need_d = need_bp = need_bd = 0
        page = self.dims.page
        for _, m in ring:
            if m["p_chunk_lens"].size:
                need_c = max(need_c, int(m["p_chunk_lens"].max()))
                # block-table depth demand = ring-wide max pages-in-use;
                # context_lens is 0 on empty rows so the max is safe
                need_bp = max(need_bp,
                              -(-int(m["p_context_lens"].max()) // page))
            if m["d_valid"].size:
                need_d = max(need_d, int(np.count_nonzero(m["d_valid"])))
                need_bd = max(need_bd,
                              -(-int(m["d_context_lens"].max()) // page))
        return serve_lib.select_bucket(self.ladder, need_c, need_d,
                                       need_bp=need_bp, need_bd=need_bd)

    @staticmethod
    def _slice_meta_field(key: str, arr: np.ndarray,
                          bucket: ServeDims) -> np.ndarray:
        """Cut one stage-stacked full-dims meta field down to bucket shape."""
        if key.startswith("p_"):
            arr = arr[:, :bucket.Sp]
            if key in ("p_positions", "p_slot_pages", "p_slot_offsets"):
                arr = arr[:, :, :bucket.C]
            elif key == "p_block_tables":
                # depth bucket: the selector guarantees every live page index
                # sits below bucket.Bp, so the tail is always zero padding
                arr = arr[:, :, :bucket.Bp]
        else:
            arr = arr[:, :bucket.Sd]
            if key == "d_block_tables":
                arr = arr[:, :, :bucket.Bd]
        return arr

    def _stack_meta(self, ring: Sequence[Tuple[Optional[int], Any]],
                    bucket: ServeDims) -> Dict[str, np.ndarray]:
        """The ring's metadata stacked over stages and cut to `bucket`, as
        host arrays."""
        full = bucket == self.dims
        out = {}
        for k in self._zm:
            stacked = np.stack([m[1][k] for m in ring], axis=0)
            if not full:
                stacked = np.ascontiguousarray(
                    self._slice_meta_field(k, stacked, bucket))
            out[k] = stacked
        return out

    def _zero_ring(self) -> Tuple[Tuple[Optional[int], Any], ...]:
        """A ring of bubbles: every stage's entry zero metadata."""
        return ((None, self._zm),) * self.depth

    def _exit_rows(self, exiting: ScheduledBatch,
                   bucket: ServeDims) -> List[int]:
        """The rows of the tick's tokens that hold the exiting batch's
        sampled tokens, in `PipelineScheduler.complete`'s order: its
        token-producing prefill rows, then its decode rows."""
        return ([i for i, seq in enumerate(exiting.prefill)
                 if seq.produces_token]
                + [bucket.Sp + j for j in range(len(exiting.decode))])

    # --------------------------------------------------------------- protocol
    @property
    def depth(self) -> int:
        return self.cfg.plan.pp

    def clock(self) -> float:
        return time.monotonic()

    def prepare(self, batch: Optional[ScheduledBatch]) -> dict:
        t0 = time.perf_counter()
        out = self._zm if batch is None else self._build_meta(batch)
        self._prep_s += time.perf_counter() - t0
        return out

    @_pinned
    @torch.inference_mode()
    def execute(self, ring: Sequence[Tuple[Optional[int], Any]],
                exiting_id: Optional[int], now: float) -> ExecResult:
        t0 = time.perf_counter()
        bucket = self._select_bucket(ring)
        prog = self._program(bucket)
        entering = (self.scheduler.get_batch(ring[0][0])
                    if ring[0][0] is not None else None)
        self._load(prog, self._fields(ring, bucket, entering), entering)
        slot, self._ring_slot = self._ring_slot, self._ring_slot ^ 1
        logits, tokens = self._run(prog)
        sampling = self._build_sampling(exiting_id, bucket)
        if sampling is not None:
            tokens = sample_tokens(logits, sampling)

        n_p = entering.num_prefill_tokens if entering is not None else 0
        n_d = entering.num_decode_tokens if entering is not None else 0
        reps = self.replicas
        self.stats.ticks += 1
        self.stats.scheduled_prefill += n_p
        self.stats.scheduled_decode += n_d
        self.stats.padded_prefill += reps * bucket.Sp * bucket.C - n_p
        self.stats.padded_decode += reps * bucket.Sd - n_d
        self.stats.prefill_ticks += bucket.Sp > 0
        self.stats.decode_ticks += bucket.Sd > 0
        self.stats.bubble_stage_ticks += sum(bid is None for bid, _ in ring)
        self.stats.scanned_pages += reps * (bucket.Sp * bucket.Bp
                                            + bucket.Sd * bucket.Bd)
        if entering is not None:
            page = self.dims.page
            live = sum(-(-(seq.start_pos + seq.num_tokens) // page)
                       for seq in entering.prefill)
            live += sum(-(-(seq.start_pos + 1) // page)
                        for seq in entering.decode)
            self.stats.live_pages += live
        self.stats.last_bucket = {"Sp": bucket.Sp, "C": bucket.C,
                                  "Sd": bucket.Sd, "Bp": bucket.Bp,
                                  "Bd": bucket.Bd}

        exiting = (self.scheduler.get_batch(exiting_id)
                   if exiting_id is not None else None)
        if exiting is None:
            return ExecResult(completed_at=now, host_s=self._host_s(t0))

        # copy the tokens out now: a later replay may reuse their memory
        host = self._host_tokens[slot][:tokens.shape[0]]
        host.copy_(tokens, non_blocking=True)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        rows = self._exit_rows(exiting, bucket)

        def readback() -> List[int]:
            t1 = time.perf_counter()
            if done is not None:
                done.synchronize()      # blocks until the tick finishes
            vals = host.numpy()
            self.stats.device_s += time.perf_counter() - t1
            toks = [int(vals[i]) for i in rows]
            self.stats.tokens_out += len(toks)
            return toks

        def probe() -> bool:
            return done is None or done.query()

        return ExecResult(completed_at=now, host_s=self._host_s(t0),
                          pending=readback, ready=probe)

    def _host_s(self, t0: float) -> float:
        """This tick's host time: the prepare() calls since the last
        execute plus execute's own, up to now."""
        host_s = self._prep_s + (time.perf_counter() - t0)
        self._prep_s = 0.0
        self.stats.host_s += host_s
        return host_s

    def finish_request(self, req: Request) -> None:
        self.slots.release(req.request_id)
        self.enc_embeds.pop(req.request_id, None)

    def release_resident_state(self, req: Request) -> None:
        """Preemption/abort recovery: the request lost residency, so its
        state slot can be reassigned.  Its encoder input stays: the
        recompute needs it."""
        self.slots.release(req.request_id)

    # ------------------------------------------------- live migration (§9)
    # The JAX engine's wire format: a paged "kv" leaf [S, R, pages, page, 2,
    # KH, hd] moves as one gather/scatter on its (page, offset) axes, the
    # payload "{group}/kv" [S, R, n, 2, KH, hd] in sequence order; the
    # slot-indexed recurrent leaves move by state slot on axis 2, an
    # encoder group's snapshot "h" [S, slots, Te, d] on axis 1.  The
    # scratch page (index `pages`) and slot (index `slots`) never move.

    _SLOT_LEAF_AXIS = {"conv": 2, "ssm": 2, "tm_x": 2, "cm_x": 2, "wkv": 2,
                       "h": 1}

    def _page_index(self, slots: Sequence[Tuple[int, int]]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        pg = [p for p, _ in slots]
        off = [o for _, o in slots]
        if any(not 0 <= p < self.dims.pages for p in pg) or any(
                not 0 <= o < self.dims.page for o in off):
            raise ValueError(f"KV slots outside the pool's {self.dims.pages}"
                             f" pages of {self.dims.page}")
        as_index = functools.partial(torch.tensor, dtype=torch.long,
                                     device=self.device)
        return as_index(pg), as_index(off)

    @_pinned
    @torch.inference_mode()
    def export_kv_pages(self, request_id: str,
                        slots: Sequence[Tuple[int, int]]) -> dict:
        """A copy of the KV at `slots`, gathered on the stream the ticks
        replay on: queued behind every tick already replayed, ahead of any
        tick that reuses the pages once the caller frees them."""
        pg, off = self._page_index(slots)
        return {f"{gk}/kv": grp["kv"][:, :, pg, off]
                for gk, grp in self.caches.items() if "kv" in grp}

    @_pinned
    @torch.inference_mode()
    def import_kv_pages(self, request_id: str, payload: Optional[dict],
                        slots: Sequence[Tuple[int, int]]) -> None:
        """Write a payload (a torch tensor on any device, or a numpy array)
        into the pools at `slots`, in place: the CUDA graphs replay on these
        very tensors."""
        if payload is None:
            return
        pg, off = self._page_index(slots)
        pools = {f"{gk}/kv": grp["kv"] for gk, grp in self.caches.items()
                 if "kv" in grp}
        if set(payload) != set(pools):
            raise ValueError(f"KV payload holds {sorted(payload)}, the pools "
                             f"are {sorted(pools)}")
        for key, pool in pools.items():
            want = pool.shape[:2] + (len(slots),) + pool.shape[4:]
            pool[:, :, pg, off] = self._landed(payload[key], pool, want, key)

    def _landed(self, vals, pool: torch.Tensor, want: Tuple[int, ...],
                key: str) -> torch.Tensor:
        """`vals` (a torch tensor, or a numpy array, bf16 ones as JAX
        exports them included) on the pool's device in its dtype, after
        checking its shape against `want`."""
        if not torch.is_tensor(vals):
            vals = np.array(vals)       # a writable copy
            vals = (torch.from_numpy(vals.view(np.uint16)).view(torch.bfloat16)
                    if vals.dtype.name == "bfloat16"
                    else torch.from_numpy(vals))
        if tuple(vals.shape) != tuple(want):
            raise ValueError(f"{key}: payload of shape {tuple(vals.shape)}, "
                             f"the pool takes {tuple(want)}")
        return vals.to(device=pool.device, dtype=pool.dtype)

    @_pinned
    @torch.inference_mode()
    def export_request_state(self, req: Request) -> dict:
        """Copies of the request's state slots (recurrent state, encoder
        snapshots; none for a model without them) and its encoder input
        (``"enc"``, f32 numpy as the JAX engine exports it); releases its
        slot and input here."""
        enc = self.enc_embeds.pop(req.request_id, None)
        state: Dict[str, Any] = {
            "enc": None if enc is None else enc.numpy(), "slot_leaves": {}}
        s = self.slots.owner.get(req.request_id)
        if s is not None:
            for gk, grp in self.caches.items():
                for name, arr in grp.items():
                    ax = self._SLOT_LEAF_AXIS.get(name)
                    if ax is not None:
                        state["slot_leaves"][f"{gk}/{name}"] = \
                            arr.select(ax, s).clone()
            self.slots.release(req.request_id)
        return state

    @_pinned
    @torch.inference_mode()
    def import_request_state(self, req: Request, state: Optional[dict],
                             resident: bool = True) -> None:
        """Attach exported state in a fresh slot, in place (`MemoryError`
        when no slot is free), and keep its encoder input.  A non-resident
        arrival recomputes from position 0, from zero state (and its
        encoder input), so it takes no slot."""
        if state is None:
            return
        if state.get("enc") is not None:
            self.enc_embeds[req.request_id] = torch.as_tensor(
                np.asarray(state["enc"], np.float32)).clone()
        leaves = (state.get("slot_leaves") or {}) if resident else {}
        if not leaves:
            return
        pools = {f"{gk}/{name}": arr for gk, grp in self.caches.items()
                 for name, arr in grp.items() if name in self._SLOT_LEAF_AXIS}
        if set(leaves) != set(pools):
            raise ValueError(f"state payload holds {sorted(leaves)}, the "
                             f"pools are {sorted(pools)}")
        s = self.slots.get(req.request_id)
        for key, pool in pools.items():
            ax = self._SLOT_LEAF_AXIS[key.rsplit("/", 1)[1]]
            want = pool.shape[:ax] + pool.shape[ax + 1:]
            pool.select(ax, s).copy_(self._landed(leaves[key], pool, want,
                                                  key))

    # -------------------------------------------------------------- internals
    def _build_sampling(self, exiting_id,
                        bucket: ServeDims) -> Optional[dict]:
        """Per-row temperatures for the micro-batch exiting this tick, at
        `bucket`'s rows; None when every row is greedy."""
        batch = (self.scheduler.get_batch(exiting_id)
                 if exiting_id is not None else None)
        if batch is None:
            return None
        temps = np.zeros(bucket.Sp + bucket.Sd, np.float32)
        for i, seq in enumerate(batch.prefill):
            temps[i] = seq.request.sampling.temperature
        for j, seq in enumerate(batch.decode):
            temps[bucket.Sp + j] = seq.request.sampling.temperature
        if not temps.any():
            return None
        return {"temps": serve_lib.host_to_device(torch.from_numpy(temps),
                                                  self.device),
                "generator": self._gen}

    def _build_meta(self, batch: ScheduledBatch) -> dict:
        dims = self.dims
        zm = self._zm
        # copy-on-write off the zero template: a field is copied the first
        # time the batch writes it, untouched fields alias the template
        m = dict(zm)

        def w(k: str) -> np.ndarray:
            if m[k] is zm[k]:
                m[k] = zm[k].copy()
            return m[k]

        for s, seq in enumerate(batch.prefill):
            req = seq.request
            L = seq.num_tokens
            w("p_positions")[s, :L] = seq.start_pos + np.arange(L)
            w("p_chunk_lens")[s] = L
            w("p_context_lens")[s] = seq.start_pos + L
            table = self.kv.block_table(req.request_id)[: dims.Bp]
            w("p_block_tables")[s, : len(table)] = table
            w("p_slot_pages")[s, :L] = [p for p, _ in seq.slots]
            w("p_slot_offsets")[s, :L] = [o for _, o in seq.slots]
            w("p_state_slots")[s] = self.slots.get(req.request_id)
            w("p_sample")[s] = int(seq.produces_token)
        for s, seq in enumerate(batch.decode):
            req = seq.request
            w("d_positions")[s] = seq.start_pos
            w("d_context_lens")[s] = seq.start_pos + 1
            table = self.kv.block_table(req.request_id)[: dims.Bd]
            w("d_block_tables")[s, : len(table)] = table
            w("d_slot_pages")[s] = seq.slots[0][0]
            w("d_slot_offsets")[s] = seq.slots[0][1]
            w("d_state_slots")[s] = self.slots.get(req.request_id)
            w("d_valid")[s] = 1
        return m

    def _fresh_tokens(self, batch: Optional[ScheduledBatch]):
        """Host token ids of the entering micro-batch at the full dims (0
        on padding rows): one layout for every bucket."""
        dims = self.dims
        p_tok = np.zeros((dims.Sp, dims.C), np.int32)
        d_tok = np.zeros((dims.Sd,), np.int32)
        if batch is not None:
            for s, seq in enumerate(batch.prefill):
                toks = seq.request.effective_prompt[
                    seq.start_pos: seq.start_pos + seq.num_tokens]
                p_tok[s, : len(toks)] = toks
            for s, seq in enumerate(batch.decode):
                d_tok[s] = seq.request.effective_prompt[seq.start_pos]
        return p_tok, d_tok


def _refuse_at_ranks(*, cuda_graphs: bool, device) -> None:
    """What the engine does not yet do at more than one rank raises, named
    by its ROADMAP item; nothing falls back to one rank."""
    dev = torch.device("cuda" if device is None else device)
    if cuda_graphs and dev.type == "cuda":
        raise ValueError(
            "CUDA graphs at more than one rank are not yet ported (ROADMAP "
            "Queue 1 item 6.5; gloo's collectives cannot be captured, "
            "NCCL's can once every rank has its card): pass "
            "cuda_graphs=False")


@dataclass
class RankStats:
    """One rank's serving time: ticks; the wall time of its ticks
    (``tick_s``, the message included); of it, the time inside collectives
    (``comm_s``: the transport, staging copies included, and the wait for
    peers), the time the host waited for its own device work (``wait_s``:
    before each staged collective and at the tick's end), and the rest,
    the host's own work (``host_s``); the device time of its compute
    (``device_s``: `collectives.CLOCK`'s stretches between collectives,
    idle gaps inside a stretch included); and its collectives' traffic
    (`collectives.TRAFFIC`)."""

    ticks: int = 0
    tick_s: float = 0.0
    comm_s: float = 0.0
    wait_s: float = 0.0
    device_s: float = 0.0

    def as_dict(self) -> dict:
        return {"ticks": self.ticks, "tick_s": self.tick_s,
                "comm_s": self.comm_s, "wait_s": self.wait_s,
                "host_s": self.tick_s - self.comm_s - self.wait_s,
                "device_s": self.device_s,
                "traffic": coll.TRAFFIC.snapshot()}


# `RankLink`'s header: six int32s; its commands beside 1 (a tick), 2 (reset
# the counters) and 0 (stop): 3-6 move state (`RankBackend._send_move`), 7
# does nothing (`RankLink.idle`)
_HEADER = 6
_EXPORT_KV, _IMPORT_KV, _EXPORT_STATE, _IMPORT_STATE, _IDLE = 3, 4, 5, 6, 7


class RankLink:
    """The channel from rank 0 to the worker ranks, one a process, that
    every engine built on one layout of ranks shares (`RankBackend(link=)`,
    `PipelineEngine(link=)`): the engines share the worker processes and
    each rank's weight shard, and each owns its pools, carry, slots and
    `RankStats` on every rank.

    Rank 0 broadcasts a header before every command: the command, the
    bucket index (a tick's) or data replica (a move's), the buffer size or
    count, the message size, the encoder flag, and the engine's index,
    which is the order the engines were built on the link in, the same on
    every rank.  A worker rank runs `serve` until command 0.  One engine's
    command runs whole under `lock` (its header, its message and rank 0's
    part of the collectives that follow), so that engines stepped or moved
    from several threads never interleave their commands.

    Every collective waits at most the group's timeout
    (`RankGroups.timeout_s`) for its peers, the workers' wait for the next
    header included: `idle` sends the idle command (nothing to do) when no
    header went for `interval` seconds, which an idle server calls at a
    fraction of that timeout (`LLMServer(idle_s=)`).  `stop` ends the
    workers once; a command after it raises."""

    def __init__(self, ranks, device) -> None:
        self.ranks = ranks
        self.device = torch.device(device)
        self.world = ranks.world_axis()
        self.backends: List["RankBackend"] = []
        self.lock = threading.RLock()
        self.last = time.monotonic()
        self.idle_sent = 0
        self.stopped = False

    def attach(self, backend: "RankBackend") -> int:
        """Number `backend` as the link's next engine."""
        self.backends.append(backend)
        return len(self.backends) - 1

    def bcast(self, t: torch.Tensor) -> torch.Tensor:
        """Host tensor `t` from rank 0 to every rank, in place."""
        if self.ranks.backend == "nccl":
            dev = t.to(self.device)
            coll.broadcast(dev, self.world, 0, kind="meta")
            t.copy_(dev.cpu())
        else:
            coll.broadcast(t, self.world, 0, kind="meta")
        return t

    def send(self, cmd: int, index: int = 0, n: int = 0, size: int = 0,
             enc: int = 0, engine: int = 0) -> None:
        """Rank 0: one header."""
        if self.stopped:
            raise RuntimeError("the worker ranks have stopped "
                               "(RankLink.stop); build a new server")
        self.bcast(torch.tensor([cmd, index, n, size, enc, engine],
                                dtype=torch.int32))
        self.last = time.monotonic()

    def _on_device(self):
        return (torch.cuda.device(self.device)
                if self.device.type == "cuda" else contextlib.nullcontext())

    def idle(self, interval: float) -> bool:
        """Rank 0: the idle command, when no header went for `interval`
        seconds and no engine is inside a command.  Whether it was sent."""
        if not self.lock.acquire(blocking=False):
            return False
        try:
            if self.stopped or time.monotonic() - self.last < interval:
                return False
            with self._on_device():
                self.send(_IDLE)
            self.idle_sent += 1
            return True
        finally:
            self.lock.release()

    def stop(self) -> None:
        """Rank 0: end every worker's `serve`; a second call does
        nothing."""
        with self.lock:
            if self.stopped:
                return
            with self._on_device():
                self.send(0)
            self.stopped = True

    @torch.inference_mode()
    def serve(self) -> List["RankStats"]:
        """A worker rank's loop: run every command rank 0 sends on the
        engine it names, until the stop command.  Returns each engine's
        rank stats."""
        if self.ranks.rank == 0:
            raise ValueError("rank 0 drives the engines; serve is for the "
                             "other ranks")
        header = torch.zeros(_HEADER, dtype=torch.int32)
        with self._on_device():
            while True:
                self.bcast(header)
                cmd, index, n, size, enc, engine = (int(v) for v in header)
                if not cmd:
                    self.stopped = True
                    return [b.rank_stats for b in self.backends]
                if cmd != _IDLE:
                    self.backends[engine]._serve(cmd, index, n, size, enc)


def serve_engines(cfg: ArchConfig, dims: ServeDims, params, *, ranks,
                  device: torch.device, dtype=None, engines: int = 1,
                  seed: int = 0, bucketed: bool = False) -> List["RankStats"]:
    """A worker rank's part of `engines` rank engines that rank 0 builds on
    one `RankLink` with the same arguments: their backends on this rank's
    shard `params`, in the same order, serving rank 0's commands until it
    stops them (`RankLink.serve`).  Returns each engine's rank stats."""
    link = RankLink(ranks, device)
    for _ in range(engines):
        RankBackend(cfg, dims, params, None, device=device, dtype=dtype,
                    seed=seed, bucketed=bucketed, ranks=ranks, link=link)
    return link.serve()


def _commanded(method):
    """Run a `RankBackend` method that sends commands whole under its
    link's lock, on the backend's device and stream."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with self.link.lock, self._on_stream():
            return method(self, *args, **kwargs)
    return run


class RankBackend(TorchBackend):
    """`TorchBackend` across ranks: every rank holds one stage of the model
    at its tensor shard (`params`: its `shard_params`; with expert
    parallelism, its data replica's block of the experts), its stage's
    pools at its shard's widths (`serve.block_cache_defs` of
    `shard_config`: its KV heads, WKV heads and Mamba channels; the MLA
    latent, shift states and encoder snapshots whole) and its carry
    (`pipeline.init_rank_carry`), and runs `pipeline.build_rank_serve_tick`.
    The KV manager on rank 0 hands out pages of every rank's pool at once:
    each pool of a data replica holds the same pages, each at its rank's
    heads.

    gLLM's runtime of one leading rank and workers: rank 0's backend sits
    under the scheduler and the `TickLoop` (`PipelineEngine(ranks=)`); per
    tick it picks the bucket and builds the static input buffer (every
    stage's metadata and
    the entering token ids, as at one rank), then broadcasts a header
    (`RankLink`) and the message (the buffer, then any exiting rows'
    temperatures as f32 bits; then an encoder-decoder's entering encoder
    input) to every rank, and runs its own stage.  Every other rank builds
    the same backends without a scheduler and serves them
    (`serve_engines`) until the stop message (`stop`).  Eager: the tokens every rank gets from the head
    (`vocab_argmax`) are read back on rank 0 as at one rank, deferred to
    the next step under async dispatch (each tick's exit rows are read off
    its replica split when it runs, into one of the two token buffers).
    The buffers travel as host tensors under gloo (the backend stages CUDA
    tensors through host memory anyway) and as device tensors under nccl.

    **State in and out.**  Four more commands move one request's KV pages
    (3 export, 4 import: the page and offset lists follow the header) or
    state slot (5 export, 6 import: the slot in the header) between rank 0
    and every rank of the request's data replica, leaf by leaf
    (`collectives.gather_rows` / `scatter_rows`, counted as ``state``):
    each rank sends or takes its block (its stage, at its tensor rank's
    heads or channels), and rank 0 joins or splits the rows
    (`serve.join_cache_rows` / `split_cache_rows`) in the one-process
    engine's layout, so a payload moves between a rank engine, a
    one-process engine and the JAX package's.  A leaf each tensor rank
    holds whole is taken from tensor rank 0 and given to each.

    **Data replicas.**  At dp > 1 the scheduler's KV manager is a
    `ReplicaKVManager` (a request lives in one replica's pool, with a
    state slot of that replica's, `ReplicaSlots`), every ring entry's
    metadata is a tuple of one per replica (`_split`: the batch's rows of
    each replica, in batch order), and the buffer holds every replica's
    fields, replica by replica, at the one bucket rank 0 picks for all;
    each rank's program reads its replica's block, its temperatures and
    its encoder input.  A replica with no rows still runs the tick (its
    rows are padding), so that every MoE exchange pairs up; the tick
    gathers every replica's tokens, and rank 0 reads each exiting row
    where its replica's block put it."""

    def __init__(self, cfg: ArchConfig, dims: ServeDims, params, kv, *,
                 device: torch.device, ranks, dtype=None, seed: int = 0,
                 bucketed: bool = False,
                 link: Optional[RankLink] = None) -> None:
        self.ranks = ranks
        self.link = link or RankLink(ranks, device)
        self.engine = self.link.attach(self)
        self.replicas = ranks.size("data")
        self.replica = ranks.index("data")
        self.local = shard_config(cfg, ranks.size("tensor"),
                                  expert_parts(cfg, self.replicas))
        self._splits: Dict[int, List[ScheduledBatch]] = {}
        super().__init__(cfg, dims, params, kv, device=device, dtype=dtype,
                         seed=seed, bucketed=bucketed, cuda_graphs=False)
        if isinstance(kv, ReplicaKVManager):
            self.slots = ReplicaSlots(dims.slots, kv)
        rows = self.replicas * (dims.Sp + dims.Sd)
        self._host_tokens = [torch.empty(rows, dtype=torch.int32,
                                         pin_memory=device.type == "cuda")
                             for _ in range(2)]
        self._enc_all = None
        if self._enc is not None:       # every replica's, this one's a view
            self._enc_all = torch.zeros((self.replicas,) + self._enc.shape,
                                        dtype=self.dtype, device=device)
            self._enc = self._enc_all[self.replica]
        self.world = ranks.world_axis()
        self._tdims = serve_lib.cache_tensor_dims(cfg, self.local, dims)
        self.rank_stats = RankStats()
        self._exiting: Optional[int] = None
        self._temps: Optional[torch.Tensor] = None
        self._rank_gen = torch.Generator(device=device)
        self._rank_gen.manual_seed(seed * 1_000_003 + ranks.rank)

    def _make_state(self):
        return (serve_lib.init_caches(self.local, self.dims, self.dtype,
                                      self.device),
                init_rank_carry(self.cfg, self.dims, self.ranks, self.dtype,
                                self.device))

    def _program(self, bucket: ServeDims) -> _BucketProgram:
        key = (bucket.Sp, bucket.C, bucket.Sd, bucket.Bp, bucket.Bd)
        prog = self._programs.get(key)
        if prog is None:
            tick = build_rank_serve_tick(self.cfg, bucket, self.ranks,
                                         carry_dims=self.dims,
                                         dtype=self.dtype)
            prog = _BucketProgram(tick, self._fields(self._zero_ring(),
                                                     bucket, None),
                                  self.device)
            mine = f"{self.replica}/"
            prog.meta = {k[len(mine):]: v for k, v in prog.meta.items()
                         if k.startswith(mine)}
            prog.bucket = bucket
            if self._enc is not None:
                prog.meta["p_enc"] = self._enc
            self._programs[key] = prog
        return prog

    # ------------------------------------------------------------ replicas
    def _zero_ring(self):
        return ((None, (self._zm,) * self.replicas),) * self.depth

    def _split(self, batch: ScheduledBatch) -> List[ScheduledBatch]:
        """`batch`'s rows of each replica (the replica its KV lives in), in
        batch order: one sub-batch each, under the batch's id."""
        subs = [ScheduledBatch(batch.batch_id, [], [])
                for _ in range(self.replicas)]
        for seq in batch.prefill:
            subs[self.kv.replica_of(seq.request.request_id)].prefill \
                .append(seq)
        for seq in batch.decode:
            subs[self.kv.replica_of(seq.request.request_id)].decode \
                .append(seq)
        return subs

    def prepare(self, batch: Optional[ScheduledBatch]):
        """Each replica's metadata of `batch` (the bubble's for none)."""
        if batch is None:
            return (self._zm,) * self.replicas
        t0 = time.perf_counter()
        subs = self._splits[batch.batch_id] = self._split(batch)
        out = tuple(self._build_meta(sub) for sub in subs)
        self._prep_s += time.perf_counter() - t0
        return out

    def _fields(self, ring, bucket: ServeDims,
                entering: Optional[ScheduledBatch]) -> Dict[str, np.ndarray]:
        """Every replica's `TorchBackend._fields`, replica by replica,
        each key prefixed with its replica (``"r/"``)."""
        subs = ([None] * self.replicas if entering is None
                else self._splits[entering.batch_id])
        out = {}
        for r, sub in enumerate(subs):
            fields = super()._fields([(bid, m[r]) for bid, m in ring],
                                     bucket, sub)
            out.update({f"{r}/{k}": a for k, a in fields.items()})
        return out

    def _select_bucket(self, ring) -> ServeDims:
        """One bucket that covers every replica's rows."""
        return super()._select_bucket([(bid, mr) for bid, m in ring
                                       for mr in m])

    def _exit_rows(self, exiting: ScheduledBatch,
                   bucket: ServeDims) -> List[int]:
        rows = bucket.Sp + bucket.Sd
        subs = self._splits.pop(exiting.batch_id)
        at = {}
        for r, sub in enumerate(subs):
            for i, seq in enumerate(sub.prefill):
                at[id(seq)] = r * rows + i
            for j, seq in enumerate(sub.decode):
                at[id(seq)] = r * rows + bucket.Sp + j
        return ([at[id(seq)] for seq in exiting.prefill
                 if seq.produces_token]
                + [at[id(seq)] for seq in exiting.decode])

    # ------------------------------------------------------------ messages
    def _send(self, cmd: int, index: int = 0, body=None,
              temps: Optional[np.ndarray] = None, enc: bool = False) -> None:
        """This engine's header (`RankLink.send`; command 1 a tick, 2
        reset the counters; bucket index, buffer size, message size, 1 if an
        encoder input follows), then a tick's message: the buffer, and the
        temperatures' f32 bits; then, for an encoder-decoder whose entering
        batch holds prefill rows, every replica's encoder input
        (`_enc_all`)."""
        msg = None
        if cmd == 1:
            msg = body.clone() if temps is None else torch.cat(
                [body, torch.from_numpy(temps.view(np.int32))])
        self.link.send(cmd, index, 0 if body is None else body.numel(),
                       0 if msg is None else msg.numel(), int(enc),
                       self.engine)
        if msg is not None:
            self.link.bcast(msg)
        if enc:
            coll.broadcast(self._enc_all, self.world, 0, kind="meta")

    def _load(self, prog: _BucketProgram, fields: Dict[str, np.ndarray],
              entering: Optional[ScheduledBatch] = None) -> None:
        """`TorchBackend._load` of the buffer, every replica's encoder
        input of the entering prefill rows (zeros past a short input and
        on rows without a request), then the tick's message to every
        rank."""
        super()._load(prog, fields)
        enc = self._enc_all is not None and entering is not None \
            and bool(entering.prefill)
        if enc:
            self._enc_all.zero_()
            for r, sub in enumerate(self._splits[entering.batch_id]):
                for i, seq in enumerate(sub.prefill):
                    src = self.enc_embeds.get(seq.request.request_id)
                    if src is not None:
                        self._enc_all[r, i, :src.shape[0]].copy_(src)
        temps = self._exit_temps(prog.bucket)
        self._temps = None if temps is None else serve_lib.host_to_device(
            torch.from_numpy(temps), self.device)
        self._send(1, self.ladder.index(prog.bucket),
                   self._staging[self._ring_slot][:prog.size], temps, enc)

    def _exit_temps(self, bucket: ServeDims) -> Optional[np.ndarray]:
        """The exiting rows' temperatures, replica by replica; None when
        every row is greedy."""
        batch = (self.scheduler.get_batch(self._exiting)
                 if self._exiting is not None else None)
        if batch is None:
            return None
        rows = bucket.Sp + bucket.Sd
        temps = np.zeros(self.replicas * rows, np.float32)
        for r, sub in enumerate(self._splits[batch.batch_id]):
            for i, seq in enumerate(sub.prefill):
                temps[r * rows + i] = seq.request.sampling.temperature
            for j, seq in enumerate(sub.decode):
                temps[r * rows + bucket.Sp + j] = \
                    seq.request.sampling.temperature
        return temps if temps.any() else None

    def _build_sampling(self, exiting_id, bucket: ServeDims):
        return None                     # the tick drew the hot rows

    @_commanded
    def execute(self, ring, exiting_id, now):
        self._exiting = exiting_id
        return super().execute(ring, exiting_id, now)

    def _run(self, prog: _BucketProgram):
        st = self.rank_stats
        t0 = time.perf_counter()
        c0, w0 = sum(coll.TRAFFIC.seconds.values()), coll.TRAFFIC.wait
        cuda = self.device.type == "cuda"
        temps = self._temps
        if temps is not None:           # this replica's rows
            rows = prog.bucket.Sp + prog.bucket.Sd
            temps = temps[self.replica * rows:(self.replica + 1) * rows]
        if cuda:
            coll.CLOCK.start(self.device)
        _, tokens = prog.tick(self.params, self.caches, prog.meta,
                              self.carry, temps, self._rank_gen)
        if cuda:
            st.device_s += coll.CLOCK.stop()
        st.ticks += 1
        st.tick_s += time.perf_counter() - t0
        st.comm_s += sum(coll.TRAFFIC.seconds.values()) - c0
        st.wait_s += coll.TRAFFIC.wait - w0
        return None, tokens

    # ------------------------------------------------------------- workers
    def _serve(self, cmd: int, index: int, n: int, size: int,
               enc: int) -> None:
        """A worker rank's part of one of this engine's commands."""
        if cmd == 2:
            self.reset_counters()
        elif cmd in (_EXPORT_KV, _IMPORT_KV):
            idx = self.link.bcast(torch.empty(size, dtype=torch.int32)).to(
                device=self.device, dtype=torch.long)
            self._kv_rows(cmd == _EXPORT_KV, index, idx[:n], idx[n:])
        elif cmd in (_EXPORT_STATE, _IMPORT_STATE):
            self._state_rows(cmd == _EXPORT_STATE, index, n)
        elif cmd == 1:
            msg = self.link.bcast(torch.empty(size, dtype=torch.int32))
            prog = self._program(self.ladder[index])
            prog.static.copy_(msg[:n])
            self._temps = (msg[n:].view(torch.float32).to(self.device)
                           if size > n else None)
            if enc:
                coll.broadcast(self._enc_all, self.world, 0, kind="meta")
            self._run(prog)
        else:
            raise ValueError(f"unknown rank command {cmd}")

    def stop(self) -> None:
        """Rank 0: end every worker's loop (`RankLink.stop`, once for all
        the link's engines)."""
        self.link.stop()

    def reset_counters(self) -> None:
        """Zero this rank's stats, traffic, kernel launch counts and peak
        memory; on rank 0, every rank's (after warm-up, before the batch
        that is measured)."""
        if self.ranks.rank == 0:
            with self.link.lock:
                self._send(2)
        self.rank_stats = RankStats()
        coll.TRAFFIC.reset()
        for mod in ops.COUNTED:
            mod.launches = 0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)

    # ------------------------------------------------- state in and out
    def _holders(self, replica: int) -> List[int]:
        """The ranks of data replica `replica`, in rank order (stage by
        stage, tensor ranks within)."""
        lay = self.ranks.layout
        return [r for r in range(lay.world)
                if lay.coords(r)["data"] == replica]

    def _gather(self, key: str, block: torch.Tensor, replica: int
                ) -> Optional[torch.Tensor]:
        """Rank 0: the whole row of leaf `key` from the replica's blocks;
        None on the other ranks."""
        got = coll.gather_rows(block, self.world, 0, self._holders(replica),
                               kind="state")
        if got is None:
            return None
        tp = self.ranks.size("tensor")
        grid = [got[s * tp:(s + 1) * tp] for s in range(self.depth)]
        return serve_lib.join_cache_rows(grid, self._tdims[key])

    def _scatter(self, key: str, whole: Optional[torch.Tensor],
                 buf: torch.Tensor, replica: int) -> None:
        """Rank 0 cuts the whole row `whole` of leaf `key` into the
        replica's blocks; each rank of the replica takes its own in
        `buf`."""
        blocks = None
        if whole is not None:
            grid = serve_lib.split_cache_rows(whole, self._tdims[key],
                                              self.depth,
                                              self.ranks.size("tensor"))
            blocks = [b for row in grid for b in row]
        coll.scatter_rows(blocks, buf, self.world, 0, self._holders(replica),
                          kind="state")

    def _whole(self, key: str, block: Tuple[int, ...]) -> Tuple[int, ...]:
        """The shape of leaf `key`'s whole row, from a rank's block."""
        shape = [block[0] * self.depth] + list(block[1:])
        if self._tdims[key] is not None:
            shape[self._tdims[key]] *= self.ranks.size("tensor")
        return tuple(shape)

    def _kv_leaves(self) -> List[Tuple[str, torch.Tensor]]:
        return [(f"{gk}/kv", grp["kv"]) for gk, grp in self.caches.items()
                if "kv" in grp]

    def _slot_leaves(self) -> List[Tuple[str, torch.Tensor, int]]:
        return [(f"{gk}/{name}", arr, self._SLOT_LEAF_AXIS[name])
                for gk, grp in self.caches.items()
                for name, arr in grp.items() if name in self._SLOT_LEAF_AXIS]

    @torch.inference_mode()
    def _kv_rows(self, export: bool, replica: int, pg: torch.Tensor,
                 off: torch.Tensor, payload: Optional[dict] = None
                 ) -> Dict[str, torch.Tensor]:
        """Every rank's part of one KV move (rank 0's `payload`, its whole
        rows, on import): the replica's ranks gather their pools at (`pg`,
        `off`) for rank 0, or write its rows there."""
        mine = self.replica == replica
        out = {}
        for key, pool in self._kv_leaves():
            shape = pool.shape[:2] + (len(pg),) + pool.shape[4:]
            if export:
                block = pool[:, :, pg, off] if mine else pool.new_empty(shape)
                row = self._gather(key, block, replica)
                if row is not None:
                    out[key] = row
            else:
                buf = pool.new_empty(shape)
                self._scatter(key, None if payload is None else payload[key],
                              buf, replica)
                if mine:
                    pool[:, :, pg, off] = buf
        return out

    @torch.inference_mode()
    def _state_rows(self, export: bool, replica: int, slot: int,
                    leaves: Optional[dict] = None) -> Dict[str, torch.Tensor]:
        """Every rank's part of one state-slot move, as `_kv_rows`."""
        mine = self.replica == replica
        out = {}
        for key, pool, ax in self._slot_leaves():
            if export:
                block = pool.select(ax, slot).clone()
                row = self._gather(key, block, replica)
                if row is not None:
                    out[key] = row
            else:
                buf = pool.select(ax, slot).clone()
                self._scatter(key, None if leaves is None else leaves[key],
                              buf, replica)
                if mine:
                    pool.select(ax, slot).copy_(buf)
        return out

    def _send_move(self, cmd: int, replica: int, n: int,
                   idx: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                   ) -> None:
        """Rank 0: the header of a state move, then its page and offset
        lists (a KV move's)."""
        msg = None if idx is None else torch.cat(idx).to(
            device="cpu", dtype=torch.int32)
        self.link.send(cmd, replica, n, 0 if msg is None else msg.numel(),
                       0, self.engine)
        if msg is not None:
            self.link.bcast(msg)

    def _replica_of(self, request_id: str) -> int:
        return self.kv.replica_of(request_id) or 0

    @_commanded
    def export_kv_pages(self, request_id: str,
                        slots: Sequence[Tuple[int, int]]) -> dict:
        """`TorchBackend.export_kv_pages` across ranks: the payload in the
        one-process engine's keys, shapes and dtype (every stage's rows,
        every KV head), gathered from the request's replica."""
        pg, off = self._page_index(slots)
        replica = self._replica_of(request_id)
        self._send_move(_EXPORT_KV, replica, len(slots), (pg, off))
        return self._kv_rows(True, replica, pg, off)

    @_commanded
    def import_kv_pages(self, request_id: str, payload: Optional[dict],
                        slots: Sequence[Tuple[int, int]]) -> None:
        """`TorchBackend.import_kv_pages` across ranks: the payload (from
        any engine, or JAX's as numpy) checked whole on rank 0, then each
        rank of the request's replica writes its block into its pools in
        place."""
        if payload is None:
            return
        pg, off = self._page_index(slots)
        leaves = self._kv_leaves()
        if set(payload) != {k for k, _ in leaves}:
            raise ValueError(f"KV payload holds {sorted(payload)}, the pools "
                             f"are {sorted(k for k, _ in leaves)}")
        whole = {}
        for key, pool in leaves:
            block = pool.shape[:2] + (len(slots),) + pool.shape[4:]
            whole[key] = self._landed(payload[key], pool,
                                      self._whole(key, block), key)
        replica = self._replica_of(request_id)
        self._send_move(_IMPORT_KV, replica, len(slots), (pg, off))
        self._kv_rows(False, replica, pg, off, whole)

    @_commanded
    def export_request_state(self, req: Request) -> dict:
        """`TorchBackend.export_request_state` across ranks: the state
        slot's rows gathered from the request's replica; its slot and
        encoder input released here."""
        rid = req.request_id
        enc = self.enc_embeds.pop(rid, None)
        state: Dict[str, Any] = {
            "enc": None if enc is None else enc.numpy(), "slot_leaves": {}}
        s = self.slots.owner.get(rid)
        if s is not None:
            if self._slot_leaves():
                replica = self._replica_of(rid)
                self._send_move(_EXPORT_STATE, replica, s)
                state["slot_leaves"] = self._state_rows(True, replica, s)
            self.slots.release(rid)
        return state

    @_commanded
    def import_request_state(self, req: Request, state: Optional[dict],
                             resident: bool = True) -> None:
        """`TorchBackend.import_request_state` across ranks: the slot rows
        checked whole on rank 0, a slot taken in the request's replica
        (`MemoryError` when none is free), then written on each of its
        ranks in place."""
        if state is None:
            return
        if state.get("enc") is not None:
            self.enc_embeds[req.request_id] = torch.as_tensor(
                np.asarray(state["enc"], np.float32)).clone()
        leaves = (state.get("slot_leaves") or {}) if resident else {}
        if not leaves:
            return
        pools = self._slot_leaves()
        if set(leaves) != {k for k, _, _ in pools}:
            raise ValueError(f"state payload holds {sorted(leaves)}, the "
                             f"pools are {sorted(k for k, _, _ in pools)}")
        whole = {}
        for key, pool, ax in pools:
            block = pool.shape[:ax] + pool.shape[ax + 1:]
            whole[key] = self._landed(leaves[key], pool,
                                      self._whole(key, block), key)
        s = self.slots.get(req.request_id)
        replica = self._replica_of(req.request_id)
        self._send_move(_IMPORT_STATE, replica, s)
        self._state_rows(False, replica, s, whole)



class PipelineEngine:
    """Single-device engine binding scheduler + KV + `TorchBackend` under
    the shared `TickLoop`.  Runs on CUDA unless `device="cpu"` is asked for;
    `params` (a `TransformerParams`) must already lie on that device.  It
    serves `cfg.plan.pp` stages on that device, as a ring of that many
    micro-batches (`configs.stage_config` stages a config, and
    `distributed.elastic.repartition_params` views its weights to match).

    `bucketed` serves the bucket ladder, `async_dispatch` retires each
    tick's tokens one tick later so that the host prepares tick N+1 while
    the device runs tick N (the JAX engine's two options).  On CUDA every
    tick replays a CUDA graph; `cuda_graphs=False` runs the ticks eagerly
    instead.  `warm_start` (capturing the graphs) runs here when the
    engine is bucketed or replays graphs.  `enable_prefix_caching` lets
    admission adopt the cached full pages of a prompt's prefix (attention
    models only: a model with recurrent blocks raises `ValueError`).
    `trace_path` records every tick to that file (`runtime/trace.py`);
    with `async_dispatch` it raises `ValueError`.

    With `ranks` (`launch.mesh.RankGroups` over more than one process),
    this is rank 0's engine over a layout of ranks (`RankBackend`): `params`
    is its shard, the other ranks run `serve_engines`, and
    `backend.stop()` ends them.  Engines built on one `link` share the
    layout's processes and weight shards (the workers serve as many
    backends).  Over dp > 1 data replicas the KV manager
    is a `ReplicaKVManager` of dp pools of `dims.pages` (`dims` are per
    replica), and the scheduler's row limits hold for each replica.  Async
    dispatch, prefix caching (one prefix index a replica), traces (their
    header and ticks name the replicas at dp > 1), migration and snapshots
    work as at one rank; CUDA graphs on CUDA raise
    (`_refuse_at_ranks`)."""

    def __init__(
        self,
        cfg: ArchConfig,
        dims: ServeDims,
        params,
        throttle: ThrottleConfig,
        *,
        device: Optional[torch.device | str] = None,
        dtype: Optional[torch.dtype] = None,
        seed: int = 0,
        bucketed: bool = False,
        async_dispatch: bool = False,
        cuda_graphs: bool = True,
        enable_prefix_caching: bool = False,
        trace_path: Optional[str] = None,
        ranks=None,
        link: Optional[RankLink] = None,
    ) -> None:
        multi = ranks is not None and ranks.layout.world > 1
        if multi:
            _refuse_at_ranks(cuda_graphs=cuda_graphs, device=device)
        if trace_path is not None and async_dispatch:
            # the recorder writes each tick's exit tokens at execute time;
            # a deferred retire would interleave records out of order and
            # break strict replay, so traced engines stay synchronous
            raise ValueError("async_dispatch is incompatible with trace_path "
                             "(traces require synchronous retirement)")
        self.device = resolve_device(device)
        if enable_prefix_caching and any(
                bs.kind in serve_lib.STATE_KINDS for bs in cfg.pattern):
            raise ValueError(
                f"{cfg.name}: prefix caching shares KV pages, but the "
                "recurrent state of its RWKV/Mamba blocks lives in slots: "
                "a request that adopted a prefix would start past position "
                "0 on state it never computed")
        if enable_prefix_caching and cfg.is_encoder_decoder:
            raise ValueError(
                f"{cfg.name}: prefix caching shares KV pages by prompt, but "
                "an encoder-decoder's decoder KV depends on the request's "
                "encoder input as well")
        wdev = params["embed"]["tok"].device
        if wdev.type != self.device.type:
            raise ValueError(f"params lie on {wdev}, the engine runs on "
                             f"{self.device}")
        self.cfg = cfg
        self.dims = dims
        self.params = params
        dp = ranks.size("data") if multi else 1
        self.kv = (ReplicaKVManager(
            dp, dims.pages, dims.page,
            enable_prefix_caching=enable_prefix_caching) if dp > 1
                   else PagedKVManager(
                       dims.pages, dims.page,
                       enable_prefix_caching=enable_prefix_caching))
        self.scheduler = PipelineScheduler(
            throttle, self.kv,
            max_model_len=dims.page * max(dims.Bp, dims.Bd),
            max_prefill_seqs=max(dims.Sp, 0),
            max_chunk_tokens=max(dims.C, 1),
            max_decode_seqs=dims.Sd)
        if multi:
            self.backend = RankBackend(cfg, dims, params, self.kv,
                                       device=self.device, dtype=dtype,
                                       seed=seed, bucketed=bucketed,
                                       ranks=ranks, link=link)
        else:
            self.backend = TorchBackend(cfg, dims, params, self.kv,
                                        device=self.device, dtype=dtype,
                                        seed=seed, bucketed=bucketed,
                                        cuda_graphs=cuda_graphs)
        # across ranks the engine is eager: no graph to capture, and the
        # kernels were built before the ranks started, so no bubble ticks
        if (bucketed or self.backend.graphs) and not multi:
            self.backend.warm_start()
        # With a trace, every tick is logged by a recorder that wraps the
        # backend as the loop's backend; warm-up, graphs, migration and
        # state release keep calling `self.backend`.  The serving layer
        # submits from client threads while a worker thread ticks, so a
        # traced engine serialises intake against the tick: a request's
        # `req` record could otherwise land after the tick that batched it.
        # Untraced engines keep the lock-free path.
        self.recorder = None
        self._trace_lock = None
        loop_backend = self.backend
        if trace_path is not None:
            from repro_torch.runtime.trace import TraceRecorder
            self.recorder = TraceRecorder(self.backend, trace_path)
            self._trace_lock = threading.Lock()
            loop_backend = self.recorder
        self.loop = TickLoop(self.scheduler, loop_backend,
                             async_dispatch=async_dispatch)
        # state slots are tied to residency: free them when the scheduler
        # evicts a request (preemption or batch abort), not only on finish
        self.scheduler.on_preempt = self.backend.release_resident_state
        self._now_fn: Callable[[], float] = time.monotonic

    # ----------------------------------------------------- delegated surfaces
    @property
    def slots(self) -> SlotAllocator:
        return self.backend.slots

    @property
    def stats(self) -> EngineStats:
        return self.backend.stats

    @property
    def enc_embeds(self) -> Dict[str, torch.Tensor]:
        return self.backend.enc_embeds

    @property
    def finished(self) -> List[Request]:
        return self.loop.finished

    @property
    def on_token(self) -> Optional[Callable[[Request, int], None]]:
        return self.loop.on_token

    @on_token.setter
    def on_token(self, fn: Optional[Callable[[Request, int], None]]) -> None:
        self.loop.on_token = fn

    # ------------------------------------------------------------------ API
    # process-wide: ids stay unique across engines in one process
    _req_counter = itertools.count()

    def add_request(self, prompt: Sequence[int],
                    sampling: Optional[SamplingParams] = None,
                    request_id: Optional[str] = None,
                    enc_embeds: Optional[np.ndarray] = None) -> Request:
        """Queue a request.  An encoder-decoder's takes its encoder input
        `enc_embeds` [<=Te, d] (zeros when None; cut to ``Te``), as the JAX
        engine does; other models ignore it."""
        rid = request_id or f"req-{next(PipelineEngine._req_counter)}"
        req = Request(rid, list(prompt), sampling or SamplingParams())
        req.metrics.arrival_time = self._now_fn()
        if self.cfg.is_encoder_decoder:
            Te = self.dims.Te
            enc = (np.zeros((Te, self.cfg.d_model), np.float32)
                   if enc_embeds is None else enc_embeds)
            self.enc_embeds[rid] = torch.as_tensor(
                np.asarray(enc, np.float32)[:Te]).clone()
        if self._trace_lock is None:
            self.scheduler.add_request(req)
        else:
            with self._trace_lock:
                self.scheduler.add_request(req)
                self.recorder.record_arrival(req)
        return req

    def abort_request(self, request_id: str) -> bool:
        """User abort: frees KV pages and the state slot.  In-flight requests
        finalize when their micro-batch retires; False when unknown."""
        now = self._now_fn()
        if self._trace_lock is None:
            req = self.scheduler.abort_request(request_id, now)
            if req is None:
                return False
        else:
            with self._trace_lock:
                req = self.scheduler.abort_request(request_id, now)
                if req is None:
                    return False
                self.recorder.record_abort(request_id, now)
        if req.is_finished:
            self.backend.finish_request(req)
            self.loop.finished.append(req)
        return True

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work

    @property
    def busy(self) -> bool:
        return self.loop.busy

    def step(self) -> List[Request]:
        """One pipeline tick.  Returns requests finishing this tick."""
        if self._trace_lock is None:
            return self.loop.step(self._now_fn())
        with self._trace_lock:
            return self.loop.step(self._now_fn())

    def settle(self) -> None:
        """Retire the tick whose readback the async loop deferred, so that
        no request is in flight until the next step (`TickLoop.settle`);
        the router settles a source before it moves a request off it."""
        self.loop.settle(self._now_fn())

    def drain(self, max_ticks: int = 100000) -> List[Request]:
        if self._trace_lock is None:
            return self.loop.drain(self._now_fn, max_ticks)
        out: List[Request] = []
        for _ in range(max_ticks):          # lock per tick, not per drain
            # the no-work check and the step share one lock acquisition: an
            # add_request between a check outside the lock and the step
            # would be missed by this drain pass
            with self._trace_lock:
                if not (self.has_work or self.busy):
                    break
                out.extend(self.loop.step(self._now_fn()))
        return out

    # -------------------------------------------------------- checkpointing
    def snapshot_state(self) -> dict:
        """Scheduler state for engine checkpoint/restart: every unfinished
        request with its prompt, emitted tokens, budget and arrival time
        (a request inside the ring is recovered by recompute: it goes back
        to the waiting queue), as the JAX engine's.  An encoder-decoder's
        requests also carry their encoder input ([Te, d] as lists)."""
        reqs = []
        seen = set()
        for group in (list(self.scheduler.waiting),
                      self.scheduler.running_prefill,
                      self.scheduler.running_decode):
            for r in group:
                if r.request_id in seen:
                    continue
                seen.add(r.request_id)
                snap = {
                    "request_id": r.request_id,
                    "prompt": list(r.prompt_token_ids),
                    "output": list(r.output_token_ids),
                    "max_new_tokens": r.sampling.max_new_tokens,
                    "arrival": r.metrics.arrival_time,
                }
                if self.cfg.is_encoder_decoder:
                    snap["enc_embeds"] = self.enc_embeds[r.request_id].tolist()
                reqs.append(snap)
        return {"requests": reqs, "ticks": self.stats.ticks}

    @staticmethod
    def restore_requests(engine: "PipelineEngine", snap: dict) -> None:
        """Queue `snap`'s requests on a fresh `engine`: each re-prefills its
        prompt and emitted tokens from scratch and keeps them."""
        for r in snap["requests"]:
            req = Request(r["request_id"], list(r["prompt"]),
                          SamplingParams(max_new_tokens=r["max_new_tokens"]))
            req.output_token_ids = list(r["output"])
            req.metrics.arrival_time = r["arrival"]
            if engine.cfg.is_encoder_decoder:
                engine.enc_embeds[req.request_id] = torch.tensor(
                    r["enc_embeds"], dtype=torch.float32)
            engine.scheduler.add_request(req)
