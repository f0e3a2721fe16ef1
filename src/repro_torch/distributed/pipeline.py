"""The serving tick (``repro.distributed.pipeline.build_serve_tick``) at
pp=1, at one bucket shape.

At one stage the JAX tick's ring collapses: stage 0's input is the freshly
embedded micro-batch, the stage permute is the identity, and the batch that
enters the tick is the one that exits it.  Deeper pipelines (pp>1: the carry
permutation over stages, then NCCL across cards) are a later slice of the
port.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import serve as serve_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.serve import ServeDims


def sample_tokens(logits: torch.Tensor,
                  sampling: Optional[Dict] = None) -> torch.Tensor:
    """logits [rows, V] f32 -> int32 ids: greedy argmax, or for rows with
    temperature > 0 a draw from softmax(logits / T) with the device's
    ``torch.Generator``.  The draws differ from ``jax.random.categorical``;
    they agree with it in distribution only."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if sampling is None:
        return greedy
    temps = sampling["temps"].float()
    scaled = logits / torch.clamp(temps, min=1e-3)[:, None]
    drawn = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                              generator=sampling["generator"])[:, 0]
    return torch.where(temps > 0.0, drawn.to(torch.int32), greedy)


def build_serve_tick(cfg: ArchConfig, dims: ServeDims, *,
                     carry_dims: Optional[ServeDims] = None,
                     dtype: Optional[torch.dtype] = None):
    """Returns tick_fn(params, caches, meta) -> (caches, logits) where

    meta   = the tick's device metadata at `dims`' shapes (`serve.host_meta`)
             plus the entering micro-batch's token ids ``p_tok`` [Sp, C] and
             ``d_tok`` [Sd] at `carry_dims`' shapes
    logits = [Sp+Sd, V] f32: one row per prefill row (its chunk's last
             token), then one per decode row; padding rows carry garbage
             that the engine never reads (`sample_tokens` turns them into
             tokens).

    **Bucketed programs.**  `dims` may be a bucket of `carry_dims`' ladder
    (`serve.bucket_ladder`): the tick then computes only the bucket's rows,
    over the full-dims caches (every bucket keeps the cache geometry) and
    from full-dims token buffers, which it slices, as the JAX tick slices
    its full-dims carry.  Embedding, every layer and the head run inside
    the tick, so that one CUDA graph per bucket holds all of it; the caches
    are updated in place and returned."""
    if cfg.plan.pp != 1:
        raise NotImplementedError(
            f"{cfg.name}: pp={cfg.plan.pp}; repro_torch serves pp=1 so far — "
            f"the multi-stage ring is ROADMAP Queue 1 item 6")
    full = carry_dims or dims
    if (dims.pages, dims.page, dims.slots, dims.Te) != \
            (full.pages, full.page, full.slots, full.Te) or \
            dims.Sp > full.Sp or dims.C > full.C or dims.Sd > full.Sd:
        raise ValueError(f"bucket {dims} does not fit the full dims {full}")
    dtype = dtype or getattr(torch, cfg.dtype)
    Sp, Sd, C = dims.Sp, dims.Sd, dims.C

    def tick(params, caches, meta: Mapping[str, torch.Tensor]):
        tok = params["embed"]["tok"]
        xp = tok[meta["p_tok"][:Sp, :C]].to(dtype)         # [Sp, C, d]
        xd = tok[meta["d_tok"][:Sd]].to(dtype)[:, None]    # [Sd, 1, d]
        xp2, xd2, caches = serve_lib.stage_forward_serve(
            cfg, params["stages"], caches, xp, xd, meta, dims, stage=0)

        # rows whose logits sample a token
        samples = []
        if Sp:
            idx = dims.Te + torch.clamp(meta["p_chunk_lens"] - 1, min=0)
            samples.append(xp2[torch.arange(Sp, device=xp2.device),
                               idx.long()])
        if Sd:
            samples.append(xd2[:, 0, :])
        h_last = torch.cat(samples, dim=0) if len(samples) > 1 \
            else samples[0]
        return caches, tfm.head_apply(cfg, params, h_last).float()

    return tick
