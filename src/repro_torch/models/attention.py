"""Attention paths (``repro.models.attention``): the paged-KV write, paged
attention for the merged prefill/decode micro-batch (and its
sequence-sharded decode, merged over the data replicas), multi-head latent
attention (MLA) over a latent page pool, and the blockwise causal and
bidirectional attention over full sequences that training, the dense
reference, the encoder and the cross-attention use.

The KV pool of one layer is ``[pages, page, 2, KH, D]`` with K and V
interleaved, as in the JAX package; an MLA layer's is ``[pages, page,
klr + dr]``, the normed latent then the rotated shared rope key.

Only `paged_attention` has a kernel (the JAX package's Pallas kernel, ported
to CUDA C++).  MLA, the encoder's self-attention and the cross-attention run
as plain PyTorch here, as they run as ``jnp`` in the JAX package, on the
TPU too.

**Blockwise attention.**  `causal_attention` and `cross_attention` run the
JAX package's flash form over full sequences: an online softmax over KV
blocks of ``block_k`` = 512 keys (`flash_attention_blocks`), the partials
(o, m, l) normalised by `finalize_flash`, so that one [.., Tq, block_k]
block of f32 scores is live at a time instead of the whole [.., Tq, Tk]
score tensor.  Scores, softmax and both products in f32, as the dense
form took them.  Two things JAX's form does not do: a causal block of
keys [lo, hi) is computed only for the rows from lo on (the rows before
attend none of it), which halves the work at 8 blocks; and the running
max is taken without gradient (`_online_softmax_step`).  JAX asserts that
the block divides the sequence; here a ragged last block is shorter (the
whisper encoder's 1,500 frames are two blocks of 512 and one of 476).

**Sequence-sharded decode.**  At a decode cell whose batch is smaller than
the data axis (`launch.shapes.serve_cell_dims`, ``ServeDims.seq_shard``)
every data replica holds every n-th page of one sequence: local page b of
replica r holds global page b·n + r.  Each replica attends its shard and
the partials are merged over the data group (`merge_flash_partials`: the
max, each rescaled, summed), as JAX's ``merge_axis`` / ``shard_info`` do.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.distributed import collectives as coll
from repro_torch.kernels import ops

NEG_INF = -1e30


def kv_targets(valid: np.ndarray, slot_pages: np.ndarray,
               num_pages: int) -> np.ndarray:
    """Each row's KV destination page: its own where it writes (valid and
    with a page inside the pool, what JAX's ``mode="drop"`` keeps), else
    `num_pages`, the scratch page past the pool that no request owns.
    torch would wrap a -1 page to the last page and silently overwrite it;
    the targets are chosen on the host, where the tick's metadata is built,
    and keep the array's shape, so that a captured graph can replay it."""
    keep = valid & (slot_pages >= 0) & (slot_pages < num_pages)
    return np.where(keep, slot_pages, num_pages).astype(np.int32)


def valid_rows(valid: np.ndarray, slot_pages: np.ndarray,
               num_pages: int) -> np.ndarray:
    """Flat indices of the rows that write KV (`kv_targets` inside the
    pool)."""
    keep = kv_targets(valid, slot_pages, num_pages) < num_pages
    return np.flatnonzero(keep.reshape(-1)).astype(np.int32)


def write_kv_pages(
    cache: torch.Tensor,         # [Pages, page, 2, KH, D], updated in place
    new_kv: torch.Tensor,        # [S, C, 2, KH, D]
    slot_pages: torch.Tensor,    # [S, C] int32 destination page per token
    slot_offsets: torch.Tensor,  # [S, C] int32 offset within page
    rows: Optional[torch.Tensor] = None,   # [n] int32 flat rows that write
) -> torch.Tensor:
    """Scatter this step's K/V rows into their pages, in place (the JAX
    version returns a new pool and donates the old one).  With `rows`
    (`valid_rows`) only those rows write; without, every row writes, each
    to its page (`kv_targets` sends the rows that write nothing to a
    scratch page)."""
    flat_kv = new_kv.reshape((-1,) + tuple(new_kv.shape[2:]))
    pages, offs = slot_pages.reshape(-1), slot_offsets.reshape(-1)
    if rows is not None:
        flat_kv, pages, offs = flat_kv[rows], pages[rows], offs[rows]
    cache[pages, offs] = flat_kv.to(cache.dtype)
    return cache


def shard_keys(end: torch.Tensor, page: int, index: int,
               shards: int) -> torch.Tensor:
    """How many of the global key positions ``[0, end)`` lie on shard
    `index` of `shards`, where local page b of a shard holds global page
    ``b * shards + index``: the local keys of that prefix (elementwise)."""
    full, rem = end // page, end % page
    pages = (full - index + shards - 1) // shards
    return pages * page + torch.where(full % shards == index, rem,
                                      torch.zeros_like(rem))


def paged_attention(
    q: torch.Tensor,             # [S, C, H, D] (C == 1 for decode)
    cache: torch.Tensor,         # [Pages, page, 2, KH, D]
    block_tables: torch.Tensor,  # [S, Bmax] int32
    context_lens: torch.Tensor,  # [S] int32 (incl. this step's tokens)
    q_positions: torch.Tensor,   # [S, C] int32 global positions
    *,
    merge_axis=None,             # the data group: sequence-sharded KV
) -> torch.Tensor:
    """Chunked-prefill and decode attention over the paged KV pool: the
    Hopper kernel for CUDA tensors, its plain version for CPU tensors
    (`kernels.ops`).

    With `merge_axis` (a `launch.mesh.AxisGroup` of n > 1 ranks, JAX's
    ``merge_axis`` with ``shard_info`` = (its index r, n)) the block tables
    index this rank's shard of an interleaved pool, local page b holding
    global page b·n + r, and `context_lens` and `q_positions` are global.
    The keys a row attends (``kpos < ctx`` and ``kpos <= qpos``) are then a
    prefix of the shard's local keys, so the kernel runs on the local
    context and positions of that prefix (`shard_keys`), writes each row's
    log-sum-exp beside its normalised output, and the partials (o, lse, 1)
    are merged over the group (`merge_flash_partials`)."""
    if merge_axis is None or merge_axis.size == 1:
        return ops.paged_attention(q, cache, block_tables, context_lens,
                                   q_positions)
    r, n, page = merge_axis.index, merge_axis.size, cache.shape[1]
    ctx = shard_keys(context_lens, page, r, n)
    qpos = shard_keys(q_positions + 1, page, r, n) - 1
    o, lse = ops.paged_attention(q, cache, block_tables, ctx.int(),
                                 qpos.int(), with_lse=True)
    o, _, l = merge_flash_partials(o.float(), lse, torch.ones_like(lse),
                                   merge_axis)
    return finalize_flash(o, l, q.dtype)


def _online_softmax_step(carry, blk, qg: torch.Tensor):
    """One flash block.  qg [*, Tq, KH, G, D]: the queries in f32, scaled,
    grouped by KV head (GQA: q heads ``kh*G .. kh*G+G-1`` read KV head
    ``kh``); blk = (k, v, mask, row_lo): k/v [*, Bk, KH, D|Dv], the rows
    from `row_lo` on and their mask [*, Tq - row_lo, Bk] bool (True =
    attend; None: every key).  The rows before `row_lo` attend no key of
    the block (a causal block past them) and keep their partials.  The
    running max m only keeps exp in range: the output does not depend on
    it, so it is taken without gradient (its backward through amax would
    pass over every block again for a gradient that cancels)."""
    o, m, l = carry             # o [*, Tq, KH, G, Dv]; m, l [*, Tq, KH, G]
    k, v, mask, r0 = blk
    s = torch.einsum("...qhgd,...khd->...qhgk", qg[..., r0:, :, :, :],
                     k.float())
    if mask is not None:
        s = s.masked_fill(~mask[..., :, None, None, :], NEG_INF)
    m_r, l_r, o_r = m[..., r0:, :, :], l[..., r0:, :, :], o[..., r0:, :, :, :]
    with torch.no_grad():
        m_new = torch.maximum(m_r, s.amax(dim=-1))
        alpha = torch.exp(m_r - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l_r * alpha + p.sum(dim=-1)
    o_new = o_r * alpha[..., None] + torch.einsum(
        "...qhgk,...khd->...qhgd", p, v.float())
    if r0:
        return (torch.cat([o[..., :r0, :, :, :], o_new], dim=-4),
                torch.cat([m[..., :r0, :, :], m_new], dim=-3),
                torch.cat([l[..., :r0, :, :], l_new], dim=-3))
    return o_new, m_new, l_new


def flash_attention_blocks(q: torch.Tensor, kv_block_fn: Callable,
                           num_blocks: int, *, kv_heads: int,
                           v_dim: Optional[int] = None,
                           scale: Optional[float] = None):
    """Online softmax over `num_blocks` KV blocks ``kv_block_fn(i)`` = (k,
    v, mask, row_lo) of `kv_heads` heads (`_online_softmax_step`) for q
    [*, Tq, H, D]: the unnormalised partials (o [*, Tq, H, Dv], m, l [*,
    Tq, H]), all f32, for `finalize_flash` or a merge across shards
    (`merge_flash_partials`).  Scores and both products in f32, the
    queries scaled once."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    *lead, Tq, H, D = q.shape
    Dv = D if v_dim is None else v_dim
    qg = (q.float() * scale).reshape(*lead, Tq, kv_heads, H // kv_heads, D)
    shape = tuple(qg.shape[:-1])
    carry = (torch.zeros(shape + (Dv,), dtype=torch.float32,
                         device=q.device),
             torch.full(shape, NEG_INF, dtype=torch.float32,
                        device=q.device),
             torch.zeros(shape, dtype=torch.float32, device=q.device))
    for i in range(num_blocks):
        carry = _online_softmax_step(carry, kv_block_fn(i), qg)
    o, m, l = carry
    return (o.reshape(*lead, Tq, H, Dv), m.reshape(*lead, Tq, H),
            l.reshape(*lead, Tq, H))


def finalize_flash(o: torch.Tensor, l: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """The output of flash partials: o / l in `dtype`."""
    return (o / torch.clamp(l, min=1e-20)[..., None]).to(dtype)


def merge_flash_partials(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                         axis):
    """Flash-decode: the (o, m, l) partials of every rank of `axis` (a
    `launch.mesh.AxisGroup`) combined, on every rank: the max of m, each
    rank's o and l rescaled by exp(m - max) and summed (one all-reduce of
    max, one of sum)."""
    m_glob = coll.all_reduce(m.clone(), axis, op="max", kind="attn")
    alpha = torch.exp(m - m_glob)
    parts = torch.cat([(o * alpha[..., None]).reshape(-1),
                       (l * alpha).reshape(-1)])
    coll.all_reduce(parts, axis, kind="attn")
    n = o.numel()
    return parts[:n].view(o.shape), m_glob, parts[n:].view(l.shape)


def _kv_blocks(k: torch.Tensor, v: torch.Tensor, block_k: int,
               causal: bool):
    """(kv_block_fn, blocks) over k/v [B, Tk, KH, D] in blocks of
    ``min(block_k, Tk)`` keys, the last one shorter where the block does
    not divide Tk.  Causal (queries at positions 0 .. Tk - 1): a block of
    keys [lo, hi) is attended only by the rows from lo on, under the
    causal mask; otherwise every row attends every key."""
    Tk = k.shape[1]
    Bk = min(block_k, Tk)

    def block(i):
        lo, hi = i * Bk, min((i + 1) * Bk, Tk)
        if not causal:
            return k[:, lo:hi], v[:, lo:hi], None, 0
        rows = torch.arange(lo, Tk, device=k.device)
        mask = rows[:, None] >= torch.arange(lo, hi, device=k.device)[None]
        return k[:, lo:hi], v[:, lo:hi], mask, lo

    return block, -(-Tk // Bk)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     *, block_k: int = 512, causal: bool = True
                     ) -> torch.Tensor:
    """Blockwise softmax attention over full sequences, q [B, T, H, D], k/v
    [B, T, KH, D|Dv]: causal, or bidirectional with ``causal=False``."""
    block, n = _kv_blocks(k, v, block_k, causal)
    o, _, l = flash_attention_blocks(q, block, n, kv_heads=k.shape[-2],
                                     v_dim=v.shape[-1])
    return finalize_flash(o, l, q.dtype)


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, block_k: int = 512) -> torch.Tensor:
    """Blockwise bidirectional attention of q [B, Tq, H, D] over every key
    of k/v [B, Tk, KH, D], no mask: the encoder's self-attention and the
    decoder's cross-attention to the encoder stream."""
    block, n = _kv_blocks(k, v, block_k, causal=False)
    o, _, l = flash_attention_blocks(q, block, n, kv_heads=k.shape[-2],
                                     v_dim=v.shape[-1])
    return finalize_flash(o, l, q.dtype)


def paged_attention_mla(
    q: torch.Tensor,             # [S, C, H, dn + dr]
    cache: torch.Tensor,         # [Pages, page, klr + dr] (latent + rope)
    w_ukv: torch.Tensor,         # [klr, H * (dn + dv)]
    block_tables: torch.Tensor,  # [S, Bmax] int32
    context_lens: torch.Tensor,  # [S] int32 (incl. this step's tokens)
    q_positions: torch.Tensor,   # [S, C] int32 global positions
    *,
    kv_lora_rank: int,
    qk_nope_dim: int,
    v_head_dim: int,
) -> torch.Tensor:
    """MLA over the latent page pool, the same function as the JAX
    package's ``paged_attention_mla`` in its absorbed form.

    JAX expands every key's latent into per-head K and V (``c_kv @ w_ukv``)
    inside its flash scan.  Here ``w_ukv``'s K half is folded into q
    (``q_lat = q_nope . W_uk``, [S, C, H, klr]), the scores are taken
    against the latent directly (``q_lat . c_kv + q_rope . k_rope``), and
    ``w_ukv``'s V half is applied after the softmax to the attended latent:
    per key and head 2 (klr + dr) + 2 klr multiply-adds instead of the
    expansion's 2 klr (dn + dv).  At minicpm3's widths (klr 256, dn = dv =
    64, dr 32, 40 heads) a decode row over 2,048 keys costs ~90 MFLOP, the
    expansion ~5.4 GFLOP per row.  Scores, softmax and both latent
    products in float32, output in q's dtype; scale ``(dn + dr) ** -0.5``
    as JAX's."""
    S, Bmax = block_tables.shape
    page = cache.shape[1]
    klr, dn, dv = kv_lora_rank, qk_nope_dim, v_head_dim
    H = q.shape[-2]
    L = Bmax * page
    w = w_ukv.float().view(klr, H, dn + dv)
    lat = cache[block_tables.long()].reshape(S, L, -1).float()
    c_kv, k_rope = lat[..., :klr], lat[..., klr:]
    qf = q.float()
    q_lat = torch.einsum("sthn,khn->sthk", qf[..., :dn], w[..., :dn])
    scores = (torch.einsum("sthk,slk->sthl", q_lat, c_kv)
              + torch.einsum("sthr,slr->sthl", qf[..., dn:], k_rope))
    scores = scores * (q.shape[-1] ** -0.5)
    kpos = torch.arange(L, device=q.device)
    mask = ((kpos[None, None, :] < context_lens[:, None, None])
            & (kpos[None, None, :] <= q_positions[:, :, None]))
    scores = scores.masked_fill(~mask[:, :, None, :], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("sthl,slk->sthk", p, c_kv)
    out = torch.einsum("sthk,khv->sthv", o_lat, w[..., dn:])
    return out.to(q.dtype)
