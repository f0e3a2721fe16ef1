"""Attention paths (``repro.models.attention``): the paged-KV write, paged
attention for the merged prefill/decode micro-batch, and the dense causal
attention the train-mode reference uses.

The KV pool of one layer is ``[pages, page, 2, KH, D]`` with K and V
interleaved, as in the JAX package.
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


def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Dense causal softmax attention, q [B, T, H, D], k/v [B, T, KH, D]
    (GQA: q heads ``kh*G .. kh*G+G-1`` read KV head ``kh``).  Scores and
    softmax in float32, output in q's dtype."""
    B, T, H, D = q.shape
    KH = k.shape[-2]
    G = H // KH
    qf = q.float().reshape(B, T, KH, G, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * (D ** -0.5)
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, T, H, D).to(q.dtype)
