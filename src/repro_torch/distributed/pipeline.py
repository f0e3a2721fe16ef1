"""The serving tick (``repro.distributed.pipeline.build_serve_tick``) at
pp=1.

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


def build_serve_tick(cfg: ArchConfig, dims: ServeDims):
    """Returns tick_fn(params, caches, meta, fresh, sampling=None) ->
    (caches, tokens) where

    fresh    = {"xp": [Sp, W, d], "xd": [Sd, 1, d]} (embedded stage-0 inputs)
    meta     = the tick's device metadata (`serve.meta_to_device`)
    sampling = None (greedy) or {"temps": [Sp+Sd] f32 (0 => greedy),
               "generator": torch.Generator on the device}
    tokens   = [Sp+Sd] int32: one id per prefill row (its chunk's last
               token), then one per decode row; padding rows carry garbage
               that the engine never reads.
    The caches are updated in place and returned."""
    if cfg.plan.pp != 1:
        raise NotImplementedError(
            f"{cfg.name}: pp={cfg.plan.pp}; repro_torch serves pp=1 so far — "
            f"the multi-stage ring is ROADMAP Queue 1 item 6")
    Sp, Sd = dims.Sp, dims.Sd

    def tick(params, caches, meta: Mapping[str, torch.Tensor],
             fresh: Mapping[str, torch.Tensor],
             sampling: Optional[Dict] = None):
        xp2, xd2, caches = serve_lib.stage_forward_serve(
            cfg, params["stages"], caches, fresh["xp"], fresh["xd"], meta,
            dims, stage=0)

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
        logits = tfm.head_apply(cfg, params, h_last).float()
        return caches, sample_tokens(logits, sampling)

    return tick
