"""Paged flash attention: the Hopper kernel's wrapper and its plain version.

`paged_flash_attention` launches ``csrc/paged_attention.cu`` (CUDA C++ for
``sm_90a``, built at first use by `kernels.build`, bound with ctypes).  It
replaces ``repro/kernels/paged_attention.py::paged_flash_attention``, the
Pallas TPU kernel; the source's header says what bounds it on an H100 and
what the design does about that.  A launch splits the KV pages of a row
across blocks where the rows alone do not fill the card, and merges the
splits' f32 partials in a second kernel: the wrapper asks the library's
entry point ``paged_attention_workspace_bytes`` how much f32 workspace the
launch needs (computed from shapes alone) and allocates it with
`torch.empty`.

With ``with_lse`` the kernel also writes each row's log-sum-exp of its
scaled scores (f32 [S, TQ, H]; -1e30 for a row that attends no key), so
that the normalised outputs over disjoint key sets merge exactly
(`models.attention.paged_attention`'s sequence-sharded decode).

`cost` gives a launch's flops and bytes from shapes at the full static
geometry (every table page), and `booked` stands in for a launch on
``meta`` tensors: it books that cost with `roofline.op_cost` and returns
empty results, counting no launch (the dry run, `launch.dryrun`).

`paged_flash_attention_ref` is the plain PyTorch version, mirroring
``repro/kernels/ref.py::paged_flash_attention_ref``: gather every table page,
masked softmax in f32.  The CPU path uses it; on the card only the checks
call it.  One difference: like the JAX oracle it gives rows with ctx == 0 the
mean of V, where the kernel writes zeros; compare only ctx > 0 rows.

`paged_flash_attention_partials_ref` and `merge_partials_ref` are the plain
versions of the split arithmetic: the partials (o, m, l) of a range of table
pages, and their merge, as the JAX package's ``flash_attention_blocks`` and
``merge_flash_partials`` compute them.  Only the tests call them.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

NEG_INF = -1e30

# Launches of the kernel since the count was last set to 0.
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_PAGES = (8, 16)

# Kernel against plain version, elementwise on the rows with ctx > 0:
#   |out - want| <= atol + rtol * |want| + vtol * sum_i p_i |v_i| / l
# f32: the two differ only in summation order.  bf16: each rounds its f32
# result to bf16 (one ulp apart at most, <= 2**-7 * |want|), and the
# tensor-core path rounds P to bf16 before P.V, as the JAX flash path does
# (|error| <= 2**-9 * sum_i p_i |v_i| / l; held at twice that).
TOLERANCE = {torch.float32: (2e-5, 0.0, 0.0),
             torch.bfloat16: (0.0, 2 ** -7, 2 ** -8)}


def excess(out: torch.Tensor, q, kv_pages, block_tables, context_lens,
           q_positions) -> Tuple[float, float]:
    """(excess, max_abs_err) of the kernel's `out` against the plain
    version on the same inputs, over the rows with ctx > 0: excess is the
    largest |out - want| over its bound in `TOLERANCE`, at most 1 when the
    two agree."""
    atol, rtol, vtol = TOLERANCE[out.dtype]
    live = context_lens > 0
    if not bool(live.any()):
        return 0.0, 0.0
    args = (block_tables, context_lens, q_positions)
    want = paged_flash_attention_ref(q, kv_pages, *args)[live].float()
    bound = atol + rtol * want.abs()
    if vtol:
        abs_v = kv_pages.to(torch.float32, copy=True)
        abs_v[:, :, 1] = abs_v[:, :, 1].abs()
        scale = paged_flash_attention_ref(q.float(), abs_v, *args)[live]
        bound = bound + vtol * scale
    err = (out[live].float() - want).abs()
    return float((err / bound).max()), float(err.max())


def _check(q, kv_pages, block_tables, context_lens, q_positions) -> None:
    tensors = (q, kv_pages, block_tables, context_lens, q_positions)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("paged_flash_attention: every input must lie on "
                         "the same CUDA device")
    if q.dtype not in _DTYPES or kv_pages.dtype != q.dtype:
        raise ValueError(f"paged_flash_attention: q/kv dtypes {q.dtype}/"
                         f"{kv_pages.dtype}; the kernel takes float32 or "
                         f"bfloat16, the same for both")
    for name, t in (("block_tables", block_tables),
                    ("context_lens", context_lens),
                    ("q_positions", q_positions)):
        if t.dtype != torch.int32:
            raise ValueError(f"paged_flash_attention: {name} must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_flash_attention: inputs must be contiguous")
    if q.dim() != 4 or kv_pages.dim() != 5 or kv_pages.shape[2] != 2:
        raise ValueError(f"paged_flash_attention: q {tuple(q.shape)} must be "
                         f"[S, TQ, H, D], kv_pages {tuple(kv_pages.shape)} "
                         f"[P, page, 2, KH, D]")
    S, TQ, H, D = q.shape
    _, page, _, KH, Dk = kv_pages.shape
    if Dk != D or D not in _HEAD_DIMS or page not in _PAGES:
        raise ValueError(f"paged_flash_attention: head dim {D}/{Dk} and "
                         f"page {page}; the kernel takes D in {_HEAD_DIMS} "
                         f"and page in {_PAGES}")
    if H % KH:
        raise ValueError(f"paged_flash_attention: {H} heads over {KH} KV "
                         f"heads")
    if (block_tables.dim() != 2 or block_tables.shape[0] != S
            or tuple(context_lens.shape) != (S,)
            or tuple(q_positions.shape) != (S, TQ)):
        raise ValueError("paged_flash_attention: block_tables [S, B], "
                         "context_lens [S], q_positions [S, TQ] expected")
    if kv_pages.data_ptr() % 16:
        raise ValueError("paged_flash_attention: kv_pages must be 16-byte "
                         "aligned")


def _entry_points(lib: ctypes.CDLL):
    """The C entry points ``paged_attention_launch`` and
    ``paged_attention_workspace_bytes`` of a built library."""
    fn, ws = lib.paged_attention_launch, lib.paged_attention_workspace_bytes
    if fn.argtypes is None:
        ptr = ctypes.c_void_p
        fn.argtypes = [ptr] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        ws.argtypes = [ctypes.c_int] * 9
        ws.restype = ctypes.c_longlong
    return fn, ws


def launch(library: str, q, kv_pages, block_tables, context_lens,
           q_positions, source: Optional[str] = None, with_lse: bool = False):
    """Check the inputs, then launch the entry point of kernel library
    `library` (built at first use from ``csrc/<library>.cu``, or from the
    CUDA text `source`, see `build.load`) on the current stream.  Returns
    the output, or (output, log-sum-exp f32 [S, TQ, H]) `with_lse`.
    Raises on anything the kernel does not take or on a CUDA error.  Counts
    nothing: `paged_flash_attention` is the counted path."""
    from repro_torch.kernels import build

    _check(q, kv_pages, block_tables, context_lens, q_positions)
    fn, workspace_bytes = _entry_points(build.load(library, source))
    S, TQ, H, D = q.shape
    _, page, _, KH, _ = kv_pages.shape
    shape = (S, TQ, H, KH, D, page, block_tables.shape[1], _DTYPES[q.dtype])
    out = torch.empty_like(q)
    lse = (torch.empty((S, TQ, H), dtype=torch.float32, device=q.device)
           if with_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        nbytes = workspace_bytes(*shape, int(with_lse))
        if nbytes < 0:
            raise ValueError(f"paged_attention_workspace_bytes refuses the "
                             f"shapes {shape}")
        work = (torch.empty(nbytes, dtype=torch.uint8, device=q.device)
                if nbytes else None)
        err = fn(q.data_ptr(), kv_pages.data_ptr(), block_tables.data_ptr(),
                 context_lens.data_ptr(), q_positions.data_ptr(),
                 out.data_ptr(), lse.data_ptr() if with_lse else None,
                 work.data_ptr() if nbytes else None, *shape, D ** -0.5,
                 stream)
    if err != 0:
        raise RuntimeError(f"paged_attention_launch failed: CUDA error {err}")
    return (out, lse) if with_lse else out


def paged_flash_attention(
    q: torch.Tensor,             # [S, TQ, H, D]
    kv_pages: torch.Tensor,      # [P, page, 2, KH, D]
    block_tables: torch.Tensor,  # [S, B] int32
    context_lens: torch.Tensor,  # [S] int32
    q_positions: torch.Tensor,   # [S, TQ] int32
    with_lse: bool = False,
):
    """Launch the Hopper kernel; raises on anything it does not take.
    Block-table entries below the live page count must index the pool.
    Returns the output, or (output, log-sum-exp) `with_lse`."""
    global launches
    out = launch("paged_attention", q, kv_pages, block_tables, context_lens,
                 q_positions, with_lse=with_lse)
    launches += 1
    return out


def cost(q, kv_pages, block_tables, context_lens, q_positions,
         with_lse: bool = False) -> Tuple[float, float]:
    """(flops, bytes) of one launch at the full static geometry: every
    table page's K and V read once, q, the indices, the output (and the
    log-sum-exp) written once; Q.K^T and P.V over every table key."""
    S, TQ, H, D = q.shape
    _, page, _, KH, _ = kv_pages.shape
    keys = S * block_tables.shape[1] * page
    nbytes = (2 * q.numel() * q.element_size()
              + keys * 2 * KH * D * kv_pages.element_size()
              + 4 * (block_tables.numel() + context_lens.numel()
                     + q_positions.numel())
              + (4 * S * TQ * H if with_lse else 0))
    return 4.0 * TQ * H * D * keys, float(nbytes)


def booked(q, kv_pages, block_tables, context_lens, q_positions,
           with_lse: bool = False):
    """A launch on ``meta`` tensors: its `cost` booked with
    `roofline.op_cost`, empty results of the launch's shapes."""
    from repro_torch.roofline import op_cost

    op_cost.book("paged_attention", *cost(q, kv_pages, block_tables,
                                          context_lens, q_positions,
                                          with_lse))
    out = torch.empty_like(q)
    if not with_lse:
        return out
    return out, torch.empty(q.shape[:-1], dtype=torch.float32,
                            device=q.device)


def paged_flash_attention_ref(
    q: torch.Tensor,             # [S, TQ, H, D]
    kv_pages: torch.Tensor,      # [P, page, 2, KH, D]
    block_tables: torch.Tensor,  # [S, B]
    context_lens: torch.Tensor,  # [S]
    q_positions: torch.Tensor,   # [S, TQ]
    with_lse: bool = False,
):
    """Plain version: gather all B pages, masked softmax in f32.  With
    `with_lse` also each row's log-sum-exp of its scaled scores, f32 [S,
    TQ, H], NEG_INF for a row that attends no key (as the kernel)."""
    S, TQ, H, D = q.shape
    _, page, _, KH, _ = kv_pages.shape
    B = block_tables.shape[1]
    G = H // KH
    gathered = kv_pages[block_tables]                   # [S, B, page, 2, KH, D]
    kv = gathered.reshape(S, B * page, 2, KH, D).float()
    k, v = kv[:, :, 0], kv[:, :, 1]
    kpos = torch.arange(B * page, device=q.device)
    mask = ((kpos[None, None, :] < context_lens[:, None, None])
            & (kpos[None, None, :] <= q_positions[:, :, None]))  # [S, TQ, BP]
    qf = q.float().reshape(S, TQ, KH, G, D)
    scores = torch.einsum("sqhgd,skhd->sqhgk", qf, k) * (D ** -0.5)
    scores = torch.where(mask[:, :, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("sqhgk,skhd->sqhgd", p, v)
    out = out.reshape(S, TQ, H, D).to(q.dtype)
    if not with_lse:
        return out
    lse = torch.where(mask.any(-1)[:, :, None, None],
                      torch.logsumexp(scores, dim=-1),
                      torch.full_like(scores[..., 0], NEG_INF))
    return out, lse.reshape(S, TQ, H)


def paged_flash_attention_partials_ref(
    q: torch.Tensor,             # [S, TQ, H, D]
    kv_pages: torch.Tensor,      # [P, page, 2, KH, D]
    block_tables: torch.Tensor,  # [S, B]
    context_lens: torch.Tensor,  # [S]
    q_positions: torch.Tensor,   # [S, TQ]
    page_lo: int,
    page_hi: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of one split: the flash partials of table pages
    [page_lo, page_hi), as the kernel's blocks write them.  Returns the
    unnormalised o [S, TQ, H, D], the running max m and the sum l
    [S, TQ, H], all f32 (computed in f64, so that the tests hold the JAX
    partials to a reference whose own rounding does not count).  A row that
    attends no key of the range gets o = 0, m = NEG_INF, l = 0, and
    contributes nothing to a merge."""
    S, TQ, H, D = q.shape
    _, page, _, KH, _ = kv_pages.shape
    G = H // KH
    n = page_hi - page_lo
    if n <= 0:
        zeros = torch.zeros(S, TQ, H, device=q.device)
        return (torch.zeros(S, TQ, H, D, device=q.device),
                torch.full_like(zeros, NEG_INF), zeros)
    kv = kv_pages[block_tables[:, page_lo:page_hi]].reshape(
        S, n * page, 2, KH, D).double()
    k, v = kv[:, :, 0], kv[:, :, 1]
    kpos = page_lo * page + torch.arange(n * page, device=q.device)
    mask = ((kpos[None, None, :] < context_lens[:, None, None])
            & (kpos[None, None, :] <= q_positions[:, :, None]))
    mask = mask[:, :, None, None, :]                    # [S, TQ, 1, 1, keys]
    qf = q.double().reshape(S, TQ, KH, G, D)
    scores = torch.einsum("sqhgd,skhd->sqhgk", qf, k) * (D ** -0.5)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1)
    p = torch.where(mask, torch.exp(scores - m[..., None]),
                    torch.zeros_like(scores))
    o = torch.einsum("sqhgk,skhd->sqhgd", p, v)
    return (o.reshape(S, TQ, H, D).float(), m.reshape(S, TQ, H).float(),
            p.sum(dim=-1).reshape(S, TQ, H).float())


def merge_partials_ref(parts) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Merge the (o, m, l) partials of disjoint page ranges, as the
    kernel's combine does: the common max, each split scaled by
    exp(m_i - m)."""
    ms = torch.stack([m for _, m, _ in parts])
    m = ms.amax(dim=0)
    alphas = torch.exp(ms - m)
    o = sum(po * a[..., None] for (po, _, _), a in zip(parts, alphas))
    l = sum(pl * a for (_, _, pl), a in zip(parts, alphas))
    return o, m, l


def finalize_partials_ref(o: torch.Tensor, l: torch.Tensor,
                          dtype: torch.dtype) -> torch.Tensor:
    """The output of merged partials in `dtype`: o / l, zeros where l = 0."""
    return (o / l.clamp_min(1e-20)[..., None]).to(dtype)
