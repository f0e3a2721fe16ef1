"""Dense (non-pipelined, non-paged) reference forward and greedy generation
(``repro.models.reference``): the oracle the serving engine is held to.

Identical parameters and stage-ordered layer application (padded layers
skipped), executed as one dense causal forward over the full sequence — no
paged KV, no chunking.  For an encoder-decoder the encoder stream
(`enc_embeds` [B, Te, d]) is prepended to the token embeddings, and every
decoder layer cross-attends to the encoder stream as it stands at that
layer's depth.  Runs on the CPU and on the card.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.transformer import _block_key


def dense_hidden(cfg: ArchConfig, params, tokens: torch.Tensor,
                 enc_embeds: Optional[torch.Tensor] = None,
                 enc_width: int = 0) -> torch.Tensor:
    """tokens [B, T] -> final hidden states [B, (Te +) T, d] (before the
    head), the encoder stream `enc_embeds` [B, Te, d] first when given."""
    h = tfm.embed_apply(cfg, params, tokens)
    if enc_embeds is not None:
        h = torch.cat([enc_embeds.to(h.dtype), h], dim=1)
        enc_width = enc_embeds.shape[1]
    Lps = cfg.layers_per_stage
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for s in range(cfg.plan.pp):
        off = 0
        for i, bs in enumerate(cfg.pattern):
            p = params["stages"][_block_key(i, bs)]
            for r in range(bs.repeat):
                if s * Lps + off + r < cfg.num_layers:
                    pl = {k: v[s, r] for k, v in p.items()}
                    h, _ = tfm.block_apply_train(cfg, bs.kind, pl, h, aux,
                                                 enc_width=enc_width)
            off += bs.repeat
    return h


@torch.no_grad()
def dense_forward(cfg: ArchConfig, params, tokens: torch.Tensor,
                  enc_embeds: Optional[torch.Tensor] = None,
                  enc_width: int = 0) -> torch.Tensor:
    """tokens [B, T] -> logits [B, T(+Te), V], over the concatenated
    payload for an encoder-decoder (slice the decoder half for next-token
    prediction), as the JAX package's `dense_forward`."""
    return tfm.head_apply(cfg, params, dense_hidden(
        cfg, params, tokens, enc_embeds, enc_width))


def _enc_batch(params, enc_embeds) -> Optional[torch.Tensor]:
    """One request's encoder input [Te, d] (numpy or torch) as a batch of
    one on the weights' device, f32."""
    if enc_embeds is None:
        return None
    return torch.as_tensor(enc_embeds, dtype=torch.float32,
                           device=params["embed"]["tok"].device)[None]


@torch.no_grad()
def greedy_trace(cfg: ArchConfig, params, prompt: Sequence[int],
                 max_new_tokens: int, enc_embeds=None
                 ) -> Tuple[List[int], List[float]]:
    """Greedy decoding by full recompute each step (an encoder-decoder's
    encoder input `enc_embeds` [Te, d] recomputed with it).  Returns the
    tokens and, per step, the gap between the two largest f32 logits (a gap
    near 0 is a near-tie that summation order may flip)."""
    device = params["embed"]["tok"].device
    enc = _enc_batch(params, enc_embeds)
    toks = list(prompt)
    out: List[int] = []
    gaps: List[float] = []
    for _ in range(max_new_tokens):
        ids = torch.tensor([toks], dtype=torch.long, device=device)
        h = dense_hidden(cfg, params, ids, enc)[:, -1]
        logits = tfm.head_apply(cfg, params, h)[0].float()
        top2 = torch.topk(logits, 2).values
        nxt = int(torch.argmax(logits))
        out.append(nxt)
        gaps.append(float(top2[0] - top2[1]))
        toks.append(nxt)
    return out, gaps


def greedy_generate(cfg: ArchConfig, params, prompt: Sequence[int],
                    max_new_tokens: int, enc_embeds=None) -> List[int]:
    """Greedy decoding by full recompute each step (slow, exact)."""
    return greedy_trace(cfg, params, prompt, max_new_tokens, enc_embeds)[0]
