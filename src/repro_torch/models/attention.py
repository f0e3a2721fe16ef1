"""Attention paths (``repro.models.attention``): the paged-KV write, paged
attention for the merged prefill/decode micro-batch, multi-head latent
attention (MLA) over a latent page pool, and the dense causal and
bidirectional attention the train-mode reference, the encoder and the
cross-attention use.

The KV pool of one layer is ``[pages, page, 2, KH, D]`` with K and V
interleaved, as in the JAX package; an MLA layer's is ``[pages, page,
klr + dr]``, the normed latent then the rotated shared rope key.

Only `paged_attention` has a kernel (the JAX package's Pallas kernel, ported
to CUDA C++).  MLA, the encoder's self-attention and the cross-attention run
as plain PyTorch here, as they run as ``jnp`` in the JAX package, on the
TPU too.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

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


def paged_attention(
    q: torch.Tensor,             # [S, C, H, D] (C == 1 for decode)
    cache: torch.Tensor,         # [Pages, page, 2, KH, D]
    block_tables: torch.Tensor,  # [S, Bmax] int32
    context_lens: torch.Tensor,  # [S] int32 (incl. this step's tokens)
    q_positions: torch.Tensor,   # [S, C] int32 global positions
) -> torch.Tensor:
    """Chunked-prefill and decode attention over the paged KV pool: the
    Hopper kernel for CUDA tensors, its plain version for CPU tensors
    (`kernels.ops`).  The JAX version's sequence-sharded ``merge_axis``
    path is not ported yet."""
    return ops.paged_attention(q, cache, block_tables, context_lens,
                               q_positions)


def _dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Softmax attention, q [B, Tq, H, D], k [B, Tk, KH, D], v [B, Tk, KH,
    Dv] (GQA: q heads ``kh*G .. kh*G+G-1`` read KV head ``kh``), keys where
    `mask` [Tq, Tk] is True (all without one).  Scores and softmax in
    float32, output in q's dtype."""
    B, T, H, D = q.shape
    KH = k.shape[-2]
    G = H // KH
    qf = q.float().reshape(B, T, KH, G, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * (D ** -0.5)
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, T, H, v.shape[-1]).to(q.dtype)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     *, causal: bool = True) -> torch.Tensor:
    """Dense softmax attention over full sequences, q [B, T, H, D], k/v
    [B, T, KH, D]: causal, or bidirectional with ``causal=False``."""
    T = q.shape[1]
    mask = (torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
            if causal else None)
    return _dense_attention(q, k, v, mask)


def cross_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Bidirectional attention of q [B, Tq, H, D] over every key of k/v
    [B, Tk, KH, D], no mask: the encoder's self-attention and the decoder's
    cross-attention to the encoder stream."""
    return _dense_attention(q, k, v, None)


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
