"""gLLM serving engine on PyTorch (``repro.runtime.engine``).

`TorchBackend` is the ExecutionBackend that runs the eager PyTorch serve
tick (`distributed.pipeline.build_serve_tick`, pp=1) on one device; it owns
the parameters, the paged KV pool and the per-request host state.
`PipelineEngine` binds scheduler + KV manager + backend under the shared
`TickLoop`, exactly as the JAX engine does.

Per tick the host builds the metadata as numpy (`prepare`, one tick ahead),
`execute` ships metadata and token ids to the device in one non-blocking
copy from pinned memory (so `host_s` counts host work, not waits for the
device), embeds on the device, launches the tick and returns a deferred
`ExecResult`: the
readback (``tokens.cpu()``) lives in its `pending` thunk and `ready()` is a
CUDA event's ``query()`` (always True on the CPU).  Bucketed shapes, CUDA
graphs, migration hooks and tracing are later slices: the migration hooks
keep the base class's no-op defaults.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import (
    PagedKVManager,
    PipelineScheduler,
    Request,
    SamplingParams,
    ScheduledBatch,
    ThrottleConfig,
)
from repro_torch.distributed.pipeline import build_serve_tick
from repro_torch.models import serve as serve_lib
from repro_torch.models.serve import ServeDims
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


class TorchBackend(ExecutionBackend):
    """ExecutionBackend running the PyTorch serve tick on `device`."""

    def __init__(self, cfg: ArchConfig, dims: ServeDims, params,
                 kv: PagedKVManager, *, device: torch.device,
                 dtype: Optional[torch.dtype] = None, seed: int = 0) -> None:
        self.cfg = cfg
        self.dims = dims
        self.device = device
        self.params = params
        self.dtype = dtype or getattr(torch, cfg.dtype)
        self.kv = kv
        self.slots = SlotAllocator(dims.slots)
        self.stats = EngineStats()
        self._tick = build_serve_tick(cfg, dims)
        self.caches = serve_lib.init_caches(cfg, dims, self.dtype, device)
        self._gen = torch.Generator(device=device)
        self._gen.manual_seed(seed)
        self._zm = serve_lib.zero_meta(dims)
        self._prep_s = 0.0          # host prepare() time since last execute

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

    @torch.inference_mode()
    def execute(self, ring: Sequence[Tuple[Optional[int], Any]],
                exiting_id: Optional[int], now: float) -> ExecResult:
        t0 = time.perf_counter()
        dims = self.dims
        entering = (self.scheduler.get_batch(ring[0][0])
                    if ring[0][0] is not None else None)
        p_tok, d_tok = self._fresh_tokens(entering)
        meta = serve_lib.meta_to_device(ring[0][1], dims, self.device,
                                        extra={"p_tok": p_tok,
                                               "d_tok": d_tok})
        fresh = self._build_fresh(meta)
        sampling = self._build_sampling(exiting_id)
        self.caches, tokens = self._tick(self.params, self.caches, meta,
                                         fresh, sampling)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()

        n_p = entering.num_prefill_tokens if entering is not None else 0
        n_d = entering.num_decode_tokens if entering is not None else 0
        self.stats.ticks += 1
        self.stats.scheduled_prefill += n_p
        self.stats.scheduled_decode += n_d
        self.stats.padded_prefill += dims.Sp * dims.C - n_p
        self.stats.padded_decode += dims.Sd - n_d
        self.stats.scanned_pages += dims.Sp * dims.Bp + dims.Sd * dims.Bd
        if entering is not None:
            page = dims.page
            live = sum(-(-(seq.start_pos + seq.num_tokens) // page)
                       for seq in entering.prefill)
            live += sum(-(-(seq.start_pos + 1) // page)
                        for seq in entering.decode)
            self.stats.live_pages += live
        host_s = self._prep_s + (time.perf_counter() - t0)
        self._prep_s = 0.0
        self.stats.host_s += host_s

        exiting = (self.scheduler.get_batch(exiting_id)
                   if exiting_id is not None else None)
        if exiting is None:
            return ExecResult(completed_at=now, host_s=host_s)

        prefill_rows = [i for i, seq in enumerate(exiting.prefill)
                        if seq.produces_token]
        n_decode = len(exiting.decode)
        d_off = dims.Sp

        def readback() -> List[int]:
            t1 = time.perf_counter()
            host = tokens.cpu().numpy()     # blocks until the tick finishes
            self.stats.device_s += time.perf_counter() - t1
            toks = [int(host[i]) for i in prefill_rows]
            toks += [int(host[d_off + j]) for j in range(n_decode)]
            self.stats.tokens_out += len(toks)
            return toks

        def probe() -> bool:
            return done is None or done.query()

        return ExecResult(completed_at=now, host_s=host_s, pending=readback,
                          ready=probe)

    def finish_request(self, req: Request) -> None:
        self.slots.release(req.request_id)

    def release_resident_state(self, req: Request) -> None:
        """Preemption/abort recovery: the request lost residency, so its
        state slot can be reassigned."""
        self.slots.release(req.request_id)

    # -------------------------------------------------------------- internals
    def _build_sampling(self, exiting_id) -> Optional[dict]:
        """Per-row temperatures for the micro-batch exiting this tick; None
        when every row is greedy."""
        dims = self.dims
        batch = (self.scheduler.get_batch(exiting_id)
                 if exiting_id is not None else None)
        if batch is None:
            return None
        temps = np.zeros(dims.Sp + dims.Sd, np.float32)
        for i, seq in enumerate(batch.prefill):
            temps[i] = seq.request.sampling.temperature
        for j, seq in enumerate(batch.decode):
            temps[dims.Sp + j] = seq.request.sampling.temperature
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
        """Host token ids of the entering micro-batch (0 on padding rows)."""
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

    def _build_fresh(self, meta: Dict[str, torch.Tensor]) -> dict:
        """Embed the entering micro-batch on the device."""
        tok = self.params["embed"]["tok"]
        xp = tok[meta["p_tok"]].to(self.dtype)            # [Sp, C, d]
        xd = tok[meta["d_tok"]].to(self.dtype)[:, None]   # [Sd, 1, d]
        return {"xp": xp, "xd": xd}


class PipelineEngine:
    """Single-device engine binding scheduler + KV + `TorchBackend` under
    the shared `TickLoop`.  Runs on CUDA unless `device="cpu"` is asked for;
    `params` (a `TransformerParams`) must already lie on that device."""

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
    ) -> None:
        self.device = resolve_device(device)
        wdev = params["embed"]["tok"].device
        if wdev.type != self.device.type:
            raise ValueError(f"params lie on {wdev}, the engine runs on "
                             f"{self.device}")
        self.cfg = cfg
        self.dims = dims
        self.params = params
        self.kv = PagedKVManager(dims.pages, dims.page)
        self.scheduler = PipelineScheduler(
            throttle, self.kv,
            max_model_len=dims.page * max(dims.Bp, dims.Bd),
            max_prefill_seqs=max(dims.Sp, 0),
            max_chunk_tokens=max(dims.C, 1),
            max_decode_seqs=dims.Sd)
        self.backend = TorchBackend(cfg, dims, params, self.kv,
                                    device=self.device, dtype=dtype, seed=seed)
        self.loop = TickLoop(self.scheduler, self.backend)
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
                    request_id: Optional[str] = None) -> Request:
        rid = request_id or f"req-{next(PipelineEngine._req_counter)}"
        req = Request(rid, list(prompt), sampling or SamplingParams())
        req.metrics.arrival_time = self._now_fn()
        self.scheduler.add_request(req)
        return req

    def abort_request(self, request_id: str) -> bool:
        """User abort: frees KV pages and the state slot.  In-flight requests
        finalize when their micro-batch retires; False when unknown."""
        req = self.scheduler.abort_request(request_id, self._now_fn())
        if req is None:
            return False
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
        return self.loop.step(self._now_fn())

    def drain(self, max_ticks: int = 100000) -> List[Request]:
        return self.loop.drain(self._now_fn, max_ticks)
