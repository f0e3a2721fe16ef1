"""Collectives across ranks (``repro.distributed.collectives``): gradient
sync, optionally compressed; the two Megatron operators of tensor
parallelism; the stage hop; expert parallelism's all-to-all
(`all_to_all`, `exchange_rows`); and the gather of row blocks to one rank
and the scatter from it (`gather_rows`, `scatter_rows`) that move a
request's KV and state between the ranks and rank 0, counted under the
kind ``state``.

An axis here is a `launch.mesh.AxisGroup`, one rank's line of a mesh axis
(its process group, its index on it).  JAX's ``psum`` over a tuple of axes
runs as one all-reduce per axis, one after the other: a sum over the
product of the axes.  An axis of size 1 is no axis: with none, each mode
computes what the JAX module computes on its ``(1, 1, 1)`` mesh.

Gradient modes (`compressed_psum`), as in the JAX module:

  None     — f32 sum (`psum_f32`).
  "int8"   — quantise with the global absmax / 127 scale (an all-reduce of
             max), sum exactly in int32, dequantise (`int8_psum`):
             identical on every rank, bit for bit JAX's.
  "ring8"  — a ring all-reduce with an int8 wire format over each axis in
             turn (`ring_psum_int8`): N-1 reduce-scatter hops, the chunk in
             hand requantised at ``scale0 * (hop + 1)`` per hop, then N-1
             all-gather hops of the reduced chunks at ``scale0 * N``.  JAX
             keeps each rank's own reduced chunk unquantised, so the
             replicas of one leaf end up with different gradients (and
             their copies of the leaf drift apart); here the own chunk is
             quantised too, so every replica holds the same sum.

Leaves with ``ndim == 0`` or fewer than 4,096 elements are never
compressed.

**Megatron operators.**  `copy_to_tensor` (identity forward, all-reduce of
the gradient over `tensor` backward) enters a column-parallel product;
`reduce_from_tensor` (all-reduce forward, identity backward) leaves a
row-parallel one.  ``torch.distributed.nn.functional.all_reduce`` is not
the second: its backward all-reduces the gradient again, which scales the
gradient of every replicated leaf by tp.  `gather_from_tensor` (all-gather
of the last dim forward, this rank's slice of the gradient backward) reads
the embedding, whose width is split over `tensor`; `slice_for_tensor` (the
rank's block of a replicated tensor forward, the gradient all-reduced
backward) hands a replicated leaf's columns to the rank's channels.

**Transport.**  On ``nccl`` every tensor moves as it lies.  ``gloo`` sums
and gathers CPU tensors, and its point-to-point ``send``/``recv`` take no
CUDA tensor: a CUDA tensor under gloo is staged through host memory (one
copy out, the collective, one copy back), a transport of the backend,
counted in `TRAFFIC` (``staged`` bytes) beside each kind's payload bytes
and the seconds spent inside the calls.  The copy out would first wait for
this rank's queued kernels, so the stream is synchronised before a staged
call's clock starts: a kind's seconds are its transport and the wait for
its peers, and the wait for the rank's own device work is counted apart
(``wait_s``).  `CLOCK`, when started, brackets the device work between
collectives with CUDA events.

**Counting.**  The dry run (`launch.dryrun`) runs one rank's program on
``meta`` tensors over counting axes (`launch.mesh.counting_groups`: the
layout's sizes, no process groups).  There every collective books its
payload bytes under the HLO name ``roofline.analysis.collective_breakdown``
keeps (`roofline.op_cost.book_collective`) and returns a ``meta`` result of
its result's shape; it never calls ``torch.distributed``.  The names:
`all_reduce` ``all-reduce``; `broadcast` ``all-reduce`` too (JAX
broadcasts by a masked ``psum``); `all_gather` ``all-gather``;
`all_to_all` ``all-to-all``; `exchange` ``collective-permute`` (JAX's
``ppermute``), the bytes it sends (or receives, on a rank that only
receives).
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class Traffic:
    """Payload bytes, calls and seconds of this process's collectives, by
    kind (``hop``, ``tp``, ``grad``, ``head``, ``meta``, ...), and the
    bytes staged through host memory."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.bytes = defaultdict(int)
        self.calls = defaultdict(int)
        self.seconds = defaultdict(float)
        self.staged = 0
        self.wait = 0.0

    def snapshot(self) -> dict:
        return {"bytes": dict(self.bytes), "calls": dict(self.calls),
                "seconds": dict(self.seconds), "staged_bytes": self.staged,
                "wait_s": self.wait}


TRAFFIC = Traffic()


class DeviceClock:
    """The device time of a rank's compute: between `start` and `stop`,
    a CUDA event pair brackets each stretch of work between two
    collectives (every collective call cuts the current stretch and opens
    the next), so the time the device spends inside a collective, or
    waiting for one, is not counted.  A stretch includes any idle gaps
    inside it.  Inactive (every call a no-op) until started."""

    def __init__(self) -> None:
        self.device = None
        self.open = None
        self.spans: list = []

    def start(self, device: torch.device) -> None:
        self.device, self.spans = device, []
        self.resume()

    def resume(self) -> None:
        if self.device is not None:
            self.open = torch.cuda.Event(enable_timing=True)
            self.open.record(torch.cuda.current_stream(self.device))

    def cut(self) -> None:
        if self.open is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            self.spans.append((self.open, end))
            self.open = None

    def stop(self) -> float:
        """Seconds of device work since `start`; the host's wait for the
        last stretch to end counts in `TRAFFIC.wait`."""
        self.cut()
        w0 = time.perf_counter()
        if self.spans:
            self.spans[-1][1].synchronize()
        TRAFFIC.wait += time.perf_counter() - w0
        total = sum(a.elapsed_time(b) for a, b in self.spans) / 1e3
        self.device, self.spans = None, []
        return total


CLOCK = DeviceClock()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _booked(name: str, t: torch.Tensor) -> None:
    """A collective on ``meta`` tensors: `t`'s bytes booked under `name`."""
    from repro_torch.roofline import op_cost

    op_cost.book_collective(name, _nbytes(t))


def _staged(t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend() == "gloo"


class _Timed:
    """One collective call of `kind` on tensor `t`, into `TRAFFIC`: a staged
    call first waits for the device (``wait_s``), then its clock starts."""

    def __init__(self, kind: str, nbytes: int, t: torch.Tensor) -> None:
        self.kind, self.nbytes, self.t = kind, nbytes, t

    def __enter__(self):
        CLOCK.cut()
        if _staged(self.t):
            w0 = time.perf_counter()
            torch.cuda.current_stream(self.t.device).synchronize()
            TRAFFIC.wait += time.perf_counter() - w0
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        TRAFFIC.seconds[self.kind] += time.perf_counter() - self.t0
        TRAFFIC.bytes[self.kind] += self.nbytes
        TRAFFIC.calls[self.kind] += 1
        CLOCK.resume()


def _host(t: torch.Tensor) -> torch.Tensor:
    TRAFFIC.staged += _nbytes(t)
    return t.detach().to("cpu")


def _back(t: torch.Tensor, host: torch.Tensor) -> None:
    TRAFFIC.staged += _nbytes(host)
    t.copy_(host)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, axis, op: str = "sum",
               kind: str = "reduce") -> torch.Tensor:
    """`t` reduced over `axis` in place (and returned); a no-op for no
    axis."""
    if axis is None or axis.size == 1:
        return t
    if t.is_meta:
        _booked("all-reduce", t)
        return t
    with _Timed(kind, _nbytes(t), t):
        if _staged(t):
            host = _host(t)
            dist.all_reduce(host, op=_OPS[op], group=axis.group)
            _back(t, host)
        else:
            dist.all_reduce(t, op=_OPS[op], group=axis.group)
    return t


def all_gather(t: torch.Tensor, axis, kind: str = "gather"
               ) -> List[torch.Tensor]:
    """Every rank's `t` along `axis`, in axis order."""
    if axis is None or axis.size == 1:
        return [t]
    if t.is_meta:
        _booked("all-gather", t)
        return [torch.empty_like(t) for _ in range(axis.size)]
    with _Timed(kind, _nbytes(t), t):
        src = _host(t) if _staged(t) else t.contiguous()
        out = [torch.empty_like(src) for _ in range(axis.size)]
        dist.all_gather(out, src, group=axis.group)
        if src.device != t.device:
            TRAFFIC.staged += _nbytes(t) * axis.size
            out = [o.to(t.device) for o in out]
    return out


def broadcast(t: torch.Tensor, axis, src: int, kind: str = "broadcast"
              ) -> torch.Tensor:
    """`t` of the rank at index `src` of `axis`, in place on every rank of
    it."""
    if axis is None or axis.size == 1:
        return t
    if t.is_meta:
        _booked("all-reduce", t)
        return t
    with _Timed(kind, _nbytes(t), t):
        if _staged(t):
            host = _host(t) if axis.index == src else torch.empty(
                t.shape, dtype=t.dtype)
            dist.broadcast(host, src=axis.ranks[src], group=axis.group)
            if axis.index != src:
                _back(t, host)
        else:
            dist.broadcast(t, src=axis.ranks[src], group=axis.group)
    return t


def exchange(send: Optional[Tuple[torch.Tensor, int]] = None,
             recv: Optional[Tuple[torch.Tensor, int]] = None,
             kind: str = "hop") -> None:
    """One point-to-point step: `send` = (tensor, global rank) goes out
    while `recv` = (tensor, global rank) is filled in place, both posted
    together (``batch_isend_irecv``) so that a ring of such steps cannot
    deadlock.  Under gloo a CUDA tensor travels through a host copy."""
    if send is None and recv is None:
        return
    if (send or recv)[0].is_meta:
        _booked("collective-permute", (send or recv)[0])
        return
    nbytes = (_nbytes(send[0]) if send else 0) + (
        _nbytes(recv[0]) if recv else 0)
    with _Timed(kind, nbytes, (send or recv)[0]):
        ops, back = [], None
        if send is not None:
            t, peer = send
            t = _host(t) if _staged(t) else t.contiguous()
            ops.append(dist.P2POp(dist.isend, t, peer))
        if recv is not None:
            t, peer = recv
            buf = torch.empty(t.shape, dtype=t.dtype) if _staged(t) else t
            if buf is not t:
                back = (t, buf)
            ops.append(dist.P2POp(dist.irecv, buf, peer))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if back is not None:
            _back(*back)


def all_to_all(t: torch.Tensor, axis, kind: str = "ep") -> torch.Tensor:
    """JAX's ``all_to_all(split_axis=0, concat_axis=0, tiled=True)`` over
    `axis`: axis 0 of `t` cut into ``axis.size`` equal chunks, chunk i sent
    to the rank at index i, the chunks received concatenated on axis 0 in
    axis order (a new tensor).  Under gloo a CUDA tensor travels through a
    host copy; under nccl ``all_to_all_single`` moves device tensors (that
    branch is written and has not run: the card machine has one card).
    `t` itself for no axis."""
    if axis is None or axis.size == 1:
        return t
    if t.shape[0] % axis.size:
        raise ValueError(f"all_to_all: {t.shape[0]} rows do not split over "
                         f"{axis.size} ranks")
    if t.is_meta:
        _booked("all-to-all", t)
        return torch.empty_like(t)
    with _Timed(kind, _nbytes(t), t):
        src = _host(t) if _staged(t) else t.contiguous()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=axis.group)
        if src.device != t.device:
            TRAFFIC.staged += _nbytes(out)
            out = out.to(t.device)
    return out


def _posted(ops: list) -> None:
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def gather_rows(t: torch.Tensor, axis, dst: int = 0,
                among: Optional[Sequence[int]] = None,
                kind: str = "state") -> Optional[List[torch.Tensor]]:
    """Row blocks to one rank: the `t` of each rank at the indices `among`
    of `axis` (every index when None), on the rank at index `dst`, in the
    order of `among` (its own block is `t` itself); None on the others.
    Every block has `t`'s shape and dtype: a `dst` outside `among` passes
    a `t` that gives them.  Point to point (`batch_isend_irecv`), so only
    the ranks of `among` and `dst` call it, and an axis may be the world
    (`RankGroups.world_axis`).  Under gloo a CUDA tensor travels through a
    host copy; the nccl branch moves device tensors (written, and not
    run: the card machine has one card)."""
    among = list(range(axis.size)) if among is None else list(among)
    me = axis.index
    with _Timed(kind, _nbytes(t) * (len(among) - (me in among)
                                    if me == dst else 1), t):
        if me != dst:
            if me in among:
                src = _host(t) if _staged(t) else t.contiguous()
                _posted([dist.P2POp(dist.isend, src, axis.ranks[dst])])
            return None
        staged = _staged(t)
        bufs, ops = [], []
        for i in among:
            if i == me:
                bufs.append(None)
                continue
            buf = torch.empty(t.shape, dtype=t.dtype,
                              device="cpu" if staged else t.device)
            bufs.append(buf)
            ops.append(dist.P2POp(dist.irecv, buf, axis.ranks[i]))
        _posted(ops)
        out = []
        for i, buf in zip(among, bufs):
            if buf is None:
                out.append(t)
            elif staged:
                TRAFFIC.staged += _nbytes(buf)
                out.append(buf.to(t.device))
            else:
                out.append(buf)
        return out


def scatter_rows(blocks: Optional[Sequence[torch.Tensor]], t: torch.Tensor,
                 axis, src: int = 0, among: Optional[Sequence[int]] = None,
                 kind: str = "state") -> torch.Tensor:
    """Row blocks from one rank: the rank at index `src` of `axis` sends
    ``blocks[j]`` to the rank at index ``among[j]`` (every index when
    None), which writes it into its `t` in place (`src`'s own block
    included); `gather_rows`'s inverse, point to point as it is, so only
    the ranks of `among` and `src` call it.  Returns `t`."""
    among = list(range(axis.size)) if among is None else list(among)
    me = axis.index
    with _Timed(kind, _nbytes(t) * (len(among) - (me in among)
                                    if me == src else 1), t):
        if me != src:
            if me in among:
                staged = _staged(t)
                buf = torch.empty(t.shape, dtype=t.dtype) if staged else t
                _posted([dist.P2POp(dist.irecv, buf, axis.ranks[src])])
                if staged:
                    _back(t, buf)
            return t
        if len(blocks) != len(among):
            raise ValueError(f"scatter_rows: {len(blocks)} blocks for "
                             f"{len(among)} ranks")
        ops = []
        for i, b in zip(among, blocks):
            if tuple(b.shape) != tuple(t.shape):
                raise ValueError(f"scatter_rows: block of shape "
                                 f"{tuple(b.shape)}, the ranks take "
                                 f"{tuple(t.shape)}")
            if i == me:
                t.copy_(b)
                continue
            b = b.to(t.dtype)
            b = (_host(b) if b.is_cuda else b.contiguous()) if _staged(t) \
                else b.to(t.device).contiguous()
            ops.append(dist.P2POp(dist.isend, b, axis.ranks[i]))
        _posted(ops)
    return t


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, kind):
        ctx.axis, ctx.kind = axis, kind
        return all_to_all(x, axis, kind)

    @staticmethod
    def backward(ctx, g):
        # the exchange is its own transpose: the gradient of the chunk
        # received from rank j goes back to rank j as the gradient of the
        # chunk it sent
        return all_to_all(g.contiguous(), ctx.axis, ctx.kind), None, None


def exchange_rows(x: torch.Tensor, axis, kind: str = "ep") -> torch.Tensor:
    """`all_to_all`, differentiable: its backward is the same exchange of
    the gradient (expert parallelism's dispatch and return)."""
    return _AllToAll.apply(x, axis, kind) if _split(axis) else x


# ----------------------------------------------------------------------------
# Gradient sync
# ----------------------------------------------------------------------------

def psum_f32(x: torch.Tensor, axes: Sequence = ()) -> torch.Tensor:
    out = x.float()
    if axes and out is x:               # the sum runs in place
        out = out.clone()
    for ax in axes:
        all_reduce(out, ax, kind="grad")
    return out


def _absmax(x: torch.Tensor, axes: Sequence) -> torch.Tensor:
    m = torch.max(torch.abs(x))
    for ax in axes:
        all_reduce(m, ax, op="max", kind="grad")
    return m


def _quantise(v: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)


def int8_psum(x: torch.Tensor, axes: Sequence = ()) -> torch.Tensor:
    """Quantise with the global absmax / 127 scale, sum exactly in int32,
    dequantise: the same on every rank."""
    x = x.float()
    scale = torch.clamp(_absmax(x, axes) / 127.0, min=1e-30)
    s = _quantise(x, scale).to(torch.int32)
    for ax in axes:
        all_reduce(s, ax, kind="grad")
    return s.float() * scale


def ring_psum_int8(x: torch.Tensor, axis=None) -> torch.Tensor:
    """Ring all-reduce over one axis with an int8 wire format: N-1
    reduce-scatter hops (the partial chunk requantised at ``scale0 * (hop
    + 1)``), then N-1 all-gather hops of the reduced chunks at
    ``scale0 * N``; every rank, its own chunk included, ends with the
    dequantised chunks."""
    n = 1 if axis is None else axis.size
    if n == 1:
        return x.float()
    idx = axis.index
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % n
    acc = torch.nn.functional.pad(flat, (0, pad)).reshape(n, -1).clone()
    scale0 = torch.clamp(_absmax(flat, [axis]) / 127.0, min=1e-30)
    right, left = axis.peer(1), axis.peer(-1)
    got = torch.empty(acc.shape[1], dtype=torch.int8, device=acc.device)
    for hop in range(n - 1):
        s = scale0 * (hop + 1.0)
        payload = _quantise(acc[(idx - hop) % n], s)
        exchange((payload, right), (got, left), kind="grad")
        acc[(idx - hop - 1) % n] += got.float() * s
    own = (idx + 1) % n
    scale_f = scale0 * n
    cur = _quantise(acc[own], scale_f)
    out = torch.empty_like(acc)
    out[own] = cur.float() * scale_f
    for hop in range(n - 1):
        nxt = torch.empty_like(cur)
        exchange((cur, right), (nxt, left), kind="grad")
        out[(own - hop - 1) % n] = nxt.float() * scale_f
        cur = nxt
    out = out.reshape(-1)
    return (out[:flat.numel()] if pad else out).reshape(x.shape)


def compressed_psum(g: torch.Tensor, mode: Optional[str] = None,
                    axes: Sequence = ()) -> torch.Tensor:
    """`g` summed in f32 over `axes` (`launch.mesh.AxisGroup`s; none at one
    rank), by `mode`."""
    axes = [a for a in axes if a is not None and a.size > 1]
    if mode is None or g.dim() == 0 or g.numel() < 4096:
        return psum_f32(g, axes)
    if mode == "int8":
        return int8_psum(g, axes)
    if mode == "ring8":
        out = g.float()
        for ax in axes:
            out = ring_psum_int8(out, ax)
        return out
    raise ValueError(f"unknown grad-compression mode {mode!r}")


# ----------------------------------------------------------------------------
# Tensor parallelism
# ----------------------------------------------------------------------------

class _CopyToTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.axis, kind="tp"), None


class _ReduceFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, kind):
        return all_reduce(x.contiguous().clone(), axis, kind=kind)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.width = axis, x.shape[-1]
        return torch.cat(all_gather(x, axis, kind="tp"), dim=-1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.axis.index * ctx.width
        return g[..., lo:lo + ctx.width], None


def _split(axis) -> bool:
    return axis is not None and axis.size > 1


def copy_to_tensor(x: torch.Tensor, axis) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over `axis` backward."""
    return _CopyToTensor.apply(x, axis) if _split(axis) else x


def reduce_from_tensor(x: torch.Tensor, axis, kind: str = "tp"
                       ) -> torch.Tensor:
    """All-reduce over `axis` forward; the gradient as it is backward."""
    return _ReduceFromTensor.apply(x, axis, kind) if _split(axis) else x


def reduce_over(x: torch.Tensor, axes: Sequence, kind: str = "reduce"
                ) -> torch.Tensor:
    """`reduce_from_tensor` over each axis of `axes` in turn: a sum whose
    gradient each rank takes as its own (the quantity it feeds is the same
    on every rank)."""
    for ax in axes:
        x = reduce_from_tensor(x, ax, kind)
    return x


def slice_for_tensor(x: torch.Tensor, axis) -> torch.Tensor:
    """This rank's block of the last dim of `x`, a tensor replicated over
    `axis` whose columns act on the rank's channels (RWKV's decay, bonus
    and group-norm gain; the decay LoRA's columns): the slice forward, and
    backward the block's gradient, zeros elsewhere, all-reduced over
    `axis` (`copy_to_tensor`), so that every replica gets the whole
    gradient."""
    if not _split(axis):
        return x
    w = x.shape[-1] // axis.size
    return copy_to_tensor(x, axis)[..., axis.index * w:(axis.index + 1) * w]


def gather_from_tensor(x: torch.Tensor, axis) -> torch.Tensor:
    """Every rank's last-dim slice concatenated in axis order forward; this
    rank's slice of the gradient backward."""
    return _GatherFromTensor.apply(x, axis) if _split(axis) else x
