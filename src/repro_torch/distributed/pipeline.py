"""Pipeline execution on one device, at pp = S stages: the GPipe train
step (``repro.distributed.pipeline.build_train_step``) and the serving tick
(``build_serve_tick``), at one bucket shape.

**The train step.**  JAX runs the GPipe schedule inside one ``shard_map``:
M + S - 1 ticks, stage s on micro-batch t - s, the activations hopping one
stage on per tick (`lax.ppermute`); on a bubble tick a stage computes on
zeros and masks the result.  Here the same ticks run the S stages one
after the other (last to first, so that stage s reads the carry slot that
stage s-1 wrote on the tick before), and a bubble tick does no work.  The
loss is the cross-entropy over all T positions of every micro-batch: the
sum of nll over the micro-batches over the count of unmasked labels, each
micro-batch's head and loss recomputed in backward so that one
``[mbg, T, V]`` f32 logits tensor is live at a time.  `aux` is the MoE
load-balancing loss summed over micro-batches and layers, and the step
minimises ``loss + aux_coef * aux``.  The gradients are cast to f32 and
synced (`collectives.compressed_psum`, at one rank), their global norm taken
and Adam applied in place.

**The ring on one card.**  The JAX tick runs S stages at once, one per
device of the `stage` axis: stage s applies its `layers_per_stage` layers
to the micro-batch it holds, with that micro-batch's metadata (``meta[s]``,
the ring's entry s); stage 0 takes the freshly embedded entering batch;
the outputs rotate one stage on (`lax.ppermute`); the last stage's rows are
sampled for the exiting batch.  Here the S stages run one after the other
inside the same tick, and one CUDA graph per bucket holds all of them.

A CUDA graph holds addresses, so the activations cannot rotate between two
buffers without one graph per parity.  Instead the stages run from S-1
down to 0, and stage s writes its output into the carry slot that stage
s+1 has already read this tick.  The carry (`init_carry`) has one slot per
stage boundary: ``carry["xp"][s]`` [Sp, W, d] and ``carry["xd"][s]``
[Sd, 1, d] hold what stage s handed stage s+1 (JAX's carry has S slots; the
one its permute wraps round to stage 0 is never read, so the port keeps
S-1).  It is allocated once at the full dims and shared by every bucket
program, as the JAX carry is.  A bucket touches only ``[:Sp, :W]`` and
``[:Sd]`` of each slot: the bucket is chosen over the whole ring
(`TorchBackend._select_bucket`), so the bucket of the tick that wrote a
micro-batch's rows and the bucket of the tick that reads them both cover
its live rows; what lies past them in a slot is padding, never read into a
live row.

At one stage the ring collapses: no carry, the batch that enters the tick
is the one that exits it.  Stages on separate cards (the carry hop as a
peer copy or NCCL) are a later slice of the port.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Mapping, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.collectives import compressed_psum
from repro_torch.distributed.optimizer import (
    AdamConfig,
    AdamState,
    adam_update,
)
from repro_torch.models import serve as serve_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import apply_norm
from repro_torch.models.serve import ServeDims


# ----------------------------------------------------------------------------
# Training: the GPipe schedule, the loss, gradients and Adam
# ----------------------------------------------------------------------------

def _stage_params(stages, s: int):
    """Stage s's leaves ``[R, ...]`` of the stacked ``[S, R, ...]`` tree."""
    return {g: {k: v[s] for k, v in leaves.items()}
            for g, leaves in stages.items()}


def _pipeline_scan(cfg: ArchConfig, stages, h: torch.Tensor, *,
                   enc_width: int = 0
                   ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """GPipe schedule over h [M, mb, T, d]: (the last stage's output of
    each micro-batch, aux summed over micro-batches and stages)."""
    S, M = cfg.plan.pp, h.shape[0]
    weights = [_stage_params(stages, s) for s in range(S)]
    carry: List[Optional[torch.Tensor]] = [None] * S
    out: List[Optional[torch.Tensor]] = [None] * M
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for t in range(M + S - 1):
        for s in reversed(range(S)):
            if not 0 <= t - s < M:          # a bubble: no work on one card
                continue
            y, a = tfm.stage_forward_train(
                cfg, weights[s], h[t - s] if s == 0 else carry[s - 1],
                enc_width=enc_width, stage=s)
            aux = aux + a
            if s == S - 1:
                out[t - s] = y
            else:
                carry[s] = y
    return out, aux


def _loss_mb(cfg: ArchConfig, fn, w: torch.Tensor, h: torch.Tensor,
             labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of nll, count of unmasked labels) of one micro-batch h [mb, T,
    d]: the final norm, the head in the weights' dtype, logits in f32
    shifted by their (stop-gradient) max, the logsumexp over all padded
    vocab columns; labels < 0 are masked."""
    h = apply_norm(h, fn, "layernorm" if "b" in fn else "rmsnorm",
                   cfg.norm_eps)
    logits = (h.to(w.dtype) @ w).float()                 # [mb, T, V]
    m = torch.amax(logits.detach(), dim=-1)
    lse = m + torch.log(torch.sum(torch.exp(logits - m[..., None]), dim=-1))
    gold = torch.gather(logits, -1, torch.clamp(labels, min=0)[..., None])
    mask = (labels >= 0).float()
    return torch.sum((lse - gold[..., 0]) * mask), torch.sum(mask)


def _sharded_loss(cfg: ArchConfig, params, hid: List[torch.Tensor],
                  labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of nll, count) over every micro-batch, each recomputed in
    backward (JAX's ``jax.checkpoint(loss_mb)``).  On one card the head is
    whole: JAX shards its vocab over the stages."""
    fn = dict(params["final_norm"].items())
    w = params["embed"]["tok"].T if cfg.tie_embeddings \
        else params["lm_head"]["w"]
    loss_mb = functools.partial(_loss_mb, cfg)
    nll = cnt = torch.zeros((), dtype=torch.float32, device=labels.device)
    for h_m, lab in zip(hid, labels):
        n, c = checkpoint(loss_mb, fn, w, h_m, lab, use_reentrant=False)
        nll, cnt = nll + n, cnt + c
    return nll, cnt


def build_train_step(cfg: ArchConfig, *, adam: AdamConfig = AdamConfig(),
                     aux_coef: float = 0.01, enc_width: int = 0,
                     grad_compression: Optional[str] = None,
                     device: Optional[torch.device | str] = None):
    """Returns step(params, opt, batch) -> (params, opt, metrics), which
    updates `params` (a `TransformerParams.trainable` tree on `device`)
    and `opt` (`optimizer.adam_init`) in place.

    batch = {"tokens", "labels": [M, mbg, T] ints (labels < 0 masked),
    optional "embeds": [M, mbg, Tv, d], the vlm/audio frontend-stub rows,
    which replace the first Tv token embeddings}; numpy or tensors.
    metrics = {"loss", "aux", "total", "gnorm"}: f32 scalars on the device.
    The step runs at `cfg.plan.pp` stages on the one device; `device` is
    CUDA unless the CPU is asked for."""
    from repro_torch.runtime.engine import resolve_device

    dev = resolve_device(device)

    def step(params, opt: AdamState, batch):
        leaves = list(tfm.tree_items(params))
        if any(not t.requires_grad for _, t in leaves):
            raise ValueError("the train step updates a trainable tree: "
                             "pass params.trainable()")
        if leaves[0][1].device.type != dev.type:
            raise ValueError(f"params lie on {leaves[0][1].device}, the "
                             f"step runs on {dev}")
        tokens = torch.as_tensor(batch["tokens"], device=dev).long()
        labels = torch.as_tensor(batch["labels"], device=dev).long()
        for _, t in leaves:
            t.grad = None
        h = tfm.embed_apply(cfg, params, tokens)           # [M, mbg, T, d]
        if batch.get("embeds") is not None:
            emb = torch.as_tensor(batch["embeds"], device=dev).to(h.dtype)
            h = torch.cat([emb, h[:, :, emb.shape[2]:]], dim=2)
        hid, aux = _pipeline_scan(cfg, params["stages"], h,
                                  enc_width=enc_width)
        nll, cnt = _sharded_loss(cfg, params, hid, labels)
        loss = nll / torch.clamp(cnt, min=1.0)
        total = loss + aux_coef * aux
        total.backward()
        del hid, h

        def sync(t):
            g = t.grad if t.grad is not None else torch.zeros_like(t)
            t.grad = None
            return compressed_psum(g, grad_compression)

        grads = tfm.tree_map(sync, params)      # f32; the bf16 grads freed
        params, opt, gnorm = adam_update(adam, grads, params, opt)
        metrics = {"loss": loss.detach(), "aux": aux.detach(),
                   "total": total.detach(), "gnorm": gnorm}
        return params, opt, metrics

    return step


# ----------------------------------------------------------------------------
# Serving: one pipeline tick
# ----------------------------------------------------------------------------

# meta fields of the entering batch alone (its token ids, and an
# encoder-decoder's encoder input); every other field is stacked over
# stages at pp > 1
TOKEN_FIELDS = ("p_tok", "d_tok", "p_enc")


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


def init_carry(cfg: ArchConfig, dims: ServeDims, dtype: torch.dtype,
               device: torch.device | str
               ) -> Optional[Dict[str, torch.Tensor]]:
    """The ring's activation carry at the full `dims`: ``xp`` [S-1, Sp, W,
    d] and ``xd`` [S-1, Sd, 1, d], zeros; None at one stage."""
    S = cfg.plan.pp
    if S == 1:
        return None
    return {"xp": torch.zeros((S - 1, dims.Sp, dims.prefill_width,
                               cfg.d_model), dtype=dtype, device=device),
            "xd": torch.zeros((S - 1, dims.Sd, 1, cfg.d_model), dtype=dtype,
                              device=device)}


def build_serve_tick(cfg: ArchConfig, dims: ServeDims, *,
                     carry_dims: Optional[ServeDims] = None,
                     dtype: Optional[torch.dtype] = None):
    """Returns tick_fn(params, caches, meta, carry=None) -> (caches, logits)
    where

    meta   = the tick's device metadata at `dims`' shapes (`serve.host_meta`),
             each field stacked over the S stages at pp > 1 (entry s: the
             micro-batch at stage s), plus the entering micro-batch's token
             ids ``p_tok`` [Sp, C] and ``d_tok`` [Sd] at `carry_dims`' shapes
             and, for an encoder-decoder (``Te`` > 0), its encoder input
             ``p_enc`` [Sp, Te, d] (model dtype), which becomes the
             prefill payload's first ``Te`` rows
    carry  = `init_carry`'s buffers at pp > 1, read and written in place
    logits = [Sp+Sd, V] f32 for the micro-batch exiting the last stage: one
             row per prefill row (its chunk's last token), then one per
             decode row; padding rows carry garbage that the engine never
             reads (`sample_tokens` turns them into tokens).

    **Bucketed programs.**  `dims` may be a bucket of `carry_dims`' ladder
    (`serve.bucket_ladder`): the tick then computes only the bucket's rows,
    over the full-dims caches (every bucket keeps the cache geometry), the
    full-dims carry and full-dims token buffers, which it slices, as the
    JAX tick slices its full-dims carry.  Embedding, every stage's layers
    and the head run inside the tick, so that one CUDA graph per bucket
    holds all of it; the caches are updated in place and returned."""
    full = carry_dims or dims
    if (dims.pages, dims.page, dims.slots, dims.Te) != \
            (full.pages, full.page, full.slots, full.Te) or \
            dims.Sp > full.Sp or dims.C > full.C or dims.Sd > full.Sd:
        raise ValueError(f"bucket {dims} does not fit the full dims {full}")
    dtype = dtype or getattr(torch, cfg.dtype)
    Sp, Sd, C, W = dims.Sp, dims.Sd, dims.C, dims.prefill_width
    S = cfg.plan.pp

    def tick(params, caches, meta: Mapping[str, torch.Tensor],
             carry: Optional[Dict[str, torch.Tensor]] = None):
        if S > 1 and carry is None:
            raise ValueError(f"{cfg.name}: a tick at pp={S} needs the "
                             f"carry (init_carry)")
        logits = None
        for s in reversed(range(S)):
            m = meta if S == 1 else {k: v if k in TOKEN_FIELDS else v[s]
                                     for k, v in meta.items()}
            if s == 0:
                tok = params["embed"]["tok"]
                xp = tok[meta["p_tok"][:Sp, :C]].to(dtype)     # [Sp, C, d]
                if dims.Te:                                # [Sp, Te + C, d]
                    xp = torch.cat([meta["p_enc"][:Sp].to(dtype), xp], dim=1)
                xd = tok[meta["d_tok"][:Sd]].to(dtype)[:, None]  # [Sd, 1, d]
            else:
                xp = carry["xp"][s - 1, :Sp, :W]
                xd = carry["xd"][s - 1, :Sd]
            xp2, xd2, caches = serve_lib.stage_forward_serve(
                cfg, params["stages"], caches, xp, xd, m, dims, stage=s)
            if s < S - 1:
                # stage s+1 read this slot earlier in the tick
                carry["xp"][s, :Sp, :W].copy_(xp2)
                carry["xd"][s, :Sd].copy_(xd2)
                continue
            # the exiting micro-batch: rows whose logits sample a token
            samples = []
            if Sp:
                idx = dims.Te + torch.clamp(m["p_chunk_lens"] - 1, min=0)
                samples.append(xp2[torch.arange(Sp, device=xp2.device),
                                   idx.long()])
            if Sd:
                samples.append(xd2[:, 0, :])
            h_last = torch.cat(samples, dim=0) if len(samples) > 1 \
                else samples[0]
            logits = tfm.head_apply(cfg, params, h_last).float()
        return caches, logits

    return tick
