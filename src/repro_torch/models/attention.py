"""Attention paths (``repro.models.attention``): the paged-KV write, paged
attention for the merged prefill/decode micro-batch, and the dense causal
attention the train-mode reference uses.

The KV pool of one layer is ``[pages, page, 2, KH, D]`` with K and V
interleaved, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops

NEG_INF = -1e30


def valid_rows(valid: np.ndarray, slot_pages: np.ndarray,
               num_pages: int) -> np.ndarray:
    """Flat indices of the rows that write KV: valid and with a page inside
    the pool.  This is what JAX's ``mode="drop"`` keeps (`write_kv_pages`
    there marks invalid rows with page -1 and drops them); torch would wrap
    a -1 index to the last page and silently overwrite it, so the rows are
    chosen on the host, where the tick's metadata is built, without a
    device sync."""
    keep = valid & (slot_pages >= 0) & (slot_pages < num_pages)
    return np.flatnonzero(keep.reshape(-1)).astype(np.int32)


def write_kv_pages(
    cache: torch.Tensor,         # [Pages, page, 2, KH, D], updated in place
    new_kv: torch.Tensor,        # [S, C, 2, KH, D]
    slot_pages: torch.Tensor,    # [S, C] int32 destination page per token
    slot_offsets: torch.Tensor,  # [S, C] int32 offset within page
    rows: torch.Tensor,          # [n] int32 flat rows that write (`valid_rows`)
) -> torch.Tensor:
    """Scatter this step's K/V rows into their pages, in place (the JAX
    version returns a new pool and donates the old one)."""
    flat_kv = new_kv.reshape((-1,) + tuple(new_kv.shape[2:]))
    pages = slot_pages.reshape(-1)[rows]
    offs = slot_offsets.reshape(-1)[rows]
    cache[pages, offs] = flat_kv[rows].to(cache.dtype)
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
