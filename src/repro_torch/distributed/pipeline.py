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
is the one that exits it.

**Across ranks.**  With `ranks` (`launch.mesh.RankGroups` of more than one
process), each rank holds one stage's leaves at its tensor shard
(`transformer.shard_params`) and both programs run as JAX's ``shard_map``
programs do, one stage a rank: `build_rank_serve_tick` runs the rank's
stage on its micro-batch and hands the output one stage on (the stage
hop, `collectives.exchange`, JAX's ``ppermute``), so that all stages run at
once on different micro-batches; the train step runs the GPipe schedule
with the hop forward and an explicit reverse schedule backward, the
vocab-sharded loss, the gradient sync over the axes each leaf is
replicated on and the global norm over the axes that split it.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Mapping, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import collectives as coll
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
                   enc_width: int = 0, remat: str = "full"
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
                enc_width=enc_width, stage=s, remat=remat)
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
                     device: Optional[torch.device | str] = None,
                     ranks=None, remat: str = "full"):
    """Returns step(params, opt, batch) -> (params, opt, metrics), which
    updates `params` (a `TransformerParams.trainable` tree on `device`)
    and `opt` (`optimizer.adam_init`) in place.

    batch = {"tokens", "labels": [M, mbg, T] ints (labels < 0 masked),
    optional "embeds": [M, mbg, Tv, d], the vlm/audio frontend-stub rows,
    which replace the first Tv token embeddings}; numpy or tensors.
    metrics = {"loss", "aux", "total", "gnorm"}: f32 scalars on the device.
    The step runs at `cfg.plan.pp` stages on the one device; `device` is
    CUDA unless the CPU is asked for.  `remat`: the recompute policy of
    each layer (`transformer.stage_forward_train`: "full" or "dots").

    With `ranks` (`launch.mesh.RankGroups` over more than one process),
    each rank runs `_rank_train_step` on its shard (`shard_params` /
    `init_params(layout=)`): stage ``ranks.index("stage")`` of `cfg`, at
    its tensor shard, on the batch's micro-batch rows of its data index;
    every rank passes the whole batch."""
    from repro_torch.runtime.engine import resolve_device

    dev = resolve_device(device)
    if ranks is not None and ranks.layout.world > 1:
        return _rank_train_step(cfg, ranks, adam=adam, aux_coef=aux_coef,
                                enc_width=enc_width,
                                grad_compression=grad_compression, dev=dev,
                                remat=remat)

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
                                  enc_width=enc_width, remat=remat)
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
# Training across ranks
# ----------------------------------------------------------------------------

MANUAL_AXES = ("data", "stage")     # JAX's manual axes; `tensor` is GSPMD's


def expert_group(cfg: ArchConfig, ranks):
    """The rank's data group when `cfg`'s experts are split over it
    (`transformer.expert_parts`), else None: the group `moe_apply(ep=)`
    exchanges rows over."""
    dp = ranks.size("data")
    return ranks["data"] if tfm.expert_parts(cfg, dp) > 1 else None


def grad_sync_axes(spec) -> Tuple[str, ...]:
    """JAX's ``_grad_sync_axes``: the manual axes a leaf is replicated on,
    over which its gradient is summed.  Over `tensor` the Megatron
    operators already leave every replica the whole gradient."""
    used = set(tfm.spec_axes(spec))
    return tuple(a for a in MANUAL_AXES if a not in used)


def _rank_loss(params, hn: Optional[torch.Tensor],
               shape, labels: torch.Tensor, cnt: torch.Tensor, ranks,
               dev: torch.device) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """JAX's ``_sharded_loss`` for one micro-batch, its backward run here:
    the last stage's normed hidden state `hn` [mb, T, d] is broadcast in f32
    over the stage group; every (stage, tensor) rank takes its vocab slice
    of the logits; the max, the sum of exp and the gold logit are reduced
    over the slices; ``sum(nll) / cnt`` is differentiated, the head's
    gradient accumulated in place, and the gradient of the hidden state
    summed over the slices.  Returns (sum of nll, that gradient in f32 on
    the last stage, else None)."""
    stage, tensor = ranks["stage"], ranks["tensor"]
    S, last = stage.size, stage.index == stage.size - 1
    h32 = hn.detach().float() if last else torch.empty(
        shape, dtype=torch.float32, device=dev)
    coll.broadcast(h32, stage, S - 1, kind="loss")
    hb = h32.requires_grad_(True)
    w = params["lm_head"]["w"]
    vs = w.shape[-1]
    off = (stage.index * tensor.size + tensor.index) * vs
    slices = [tensor, stage]
    logits = (hb.to(w.dtype) @ w).float()                     # [mb, T, Vs]
    m = torch.amax(logits.detach(), dim=-1)
    for ax in slices:
        coll.all_reduce(m, ax, op="max", kind="loss")
    se = coll.reduce_over(torch.sum(torch.exp(logits - m[..., None]), -1),
                          slices, kind="loss")
    lab = torch.clamp(labels, min=0)
    inside = (lab >= off) & (lab < off + vs)
    gold = torch.gather(logits, -1, torch.clamp(lab - off, 0, vs - 1)[..., None])
    gold = coll.reduce_over(torch.where(inside, gold[..., 0], 0.0), slices,
                            kind="loss")
    nll = torch.sum((m + torch.log(se) - gold) * (labels >= 0).float())
    (nll / cnt).backward()
    g = hb.grad
    for ax in slices:
        coll.all_reduce(g, ax, kind="loss")
    return nll.detach(), (g if last else None)


def _rank_train_step(cfg: ArchConfig, ranks, *, adam: AdamConfig,
                     aux_coef: float, enc_width: int,
                     grad_compression: Optional[str], dev: torch.device,
                     remat: str = "full"):
    """One rank's GPipe train step (see `build_train_step`)."""
    layout = ranks.layout
    tfm.check_shardable(cfg, layout)
    S, dp = layout.size("stage"), layout.size("data")
    s, d = ranks.index("stage"), ranks.index("data")
    stage = ranks["stage"]
    tp = ranks["tensor"] if ranks.size("tensor") > 1 else None
    ep = expert_group(cfg, ranks)
    local = tfm.shard_config(cfg, layout.size("tensor"),
                             tfm.expert_parts(cfg, dp))
    specs = dict(tfm.tree_items(tfm.param_pspecs(cfg)))
    sync_axes = {p: [ranks[a] for a in grad_sync_axes(sp)]
                 for p, sp in specs.items()}
    # the axes that split a leaf, by which its squares are summed once
    norm_axes = {p: tuple(a for a in ranks.layout.names
                          if a in tfm.spec_axes(sp))
                 for p, sp in specs.items()}

    def step(params, opt: AdamState, batch):
        leaves = dict(tfm.tree_items(params))
        if any(not t.requires_grad for t in leaves.values()):
            raise ValueError("the train step updates a trainable tree: "
                             "pass params.trainable()")
        tokens = torch.as_tensor(batch["tokens"]).long()
        labels = torch.as_tensor(batch["labels"]).long()
        M, mbg, T = tokens.shape
        if mbg % dp:
            raise ValueError(f"{mbg} sequences a micro-batch do not split "
                             f"over dp={dp}")
        # a 0-dim tensor, not a host read: the dry run runs on meta
        cnt = (labels >= 0).sum().float()
        rows = slice(d * mbg // dp, (d + 1) * mbg // dp)
        tokens, labels = tokens[:, rows].to(dev), labels[:, rows].to(dev)
        for t in leaves.values():
            t.grad = None
        shape = tuple(tokens.shape[1:]) + (cfg.d_model,)
        dtype = getattr(torch, cfg.dtype)
        weights = _stage_params(params["stages"], 0)
        xs, ys, auxes = [], [], []
        # the GPipe schedule: stage s takes micro-batch t - s at tick t;
        # its input hops from stage s-1, its output on to stage s+1
        for t in range(M + S - 1):
            mi = t - s
            if not 0 <= mi < M:
                continue
            if s == 0:
                x = tfm.embed_apply(cfg, params, tokens[mi], tp)
                if batch.get("embeds") is not None:
                    emb = torch.as_tensor(batch["embeds"])[mi, rows]
                    emb = emb.to(device=dev, dtype=x.dtype)
                    x = torch.cat([emb, x[:, emb.shape[1]:]], dim=1)
            else:
                x = torch.empty(shape, dtype=dtype, device=dev)
                coll.exchange(recv=(x, stage.peer(-1)))
                x.requires_grad_(True)
            y, a = tfm.stage_forward_train(local, weights, x,
                                           enc_width=enc_width, stage=s,
                                           tp=tp, ep=ep, remat=remat)
            if s < S - 1:
                coll.exchange(send=(y.detach(), stage.peer(1)))
            xs.append(x)
            ys.append(y)
            auxes.append(a)
        # the loss, micro-batch by micro-batch, on every (stage, tensor)
        nll = torch.zeros((), dtype=torch.float32, device=dev)
        dys: List[Optional[torch.Tensor]] = [None] * M
        for mi in range(M):
            hn = None
            if s == S - 1:
                yd = ys[mi].detach().requires_grad_(True)
                fn = dict(params["final_norm"].items())
                hn = apply_norm(yd, fn, "layernorm" if "b" in fn
                                else "rmsnorm", cfg.norm_eps)
            n, g = _rank_loss(params, hn, shape, labels[mi], cnt, ranks,
                              dev)
            nll = nll + n
            if s == S - 1:
                hn.backward(g.to(hn.dtype))
                dys[mi] = yd.grad
        # the reverse schedule: dL/dy from stage s+1, backward through the
        # stage's micro-batch, dL/dx on to stage s-1
        coef = aux_coef / dp
        for mi in reversed(range(M)):
            dy = dys[mi]
            if dy is None:
                dy = torch.empty(shape, dtype=dtype, device=dev)
                coll.exchange(recv=(dy, stage.peer(1)))
            outs, grads = [ys[mi]], [dy]
            if auxes[mi].requires_grad and coef:
                outs.append(auxes[mi])
                grads.append(torch.full((), coef, device=dev))
            torch.autograd.backward(outs, grads)
            if s > 0:
                coll.exchange(send=(xs[mi].grad, stage.peer(-1)))
        del xs, ys, dys
        aux = torch.stack([a.detach() for a in auxes]).sum() if auxes \
            else torch.zeros((), device=dev)
        coll.all_reduce(nll, ranks["data"], kind="metrics")
        for ax in (stage, ranks["data"]):
            coll.all_reduce(aux, ax, kind="metrics")
        loss = nll / torch.clamp(cnt, min=1.0)
        aux = aux / dp
        total = loss + aux_coef * aux

        grads = {}
        for path, t in leaves.items():
            g = t.grad if t.grad is not None else torch.zeros_like(t)
            t.grad = None
            grads[path] = compressed_psum(g, grad_compression,
                                          sync_axes[path])
        by_axes: Dict[Tuple[str, ...], torch.Tensor] = {}
        for path, g in grads.items():
            key = norm_axes[path]
            sq = torch.sum(torch.square(g))
            by_axes[key] = by_axes[key] + sq if key in by_axes else sq
        gsq = torch.zeros((), dtype=torch.float32, device=dev)
        for key, sq in sorted(by_axes.items()):
            for a in key:
                coll.all_reduce(sq, ranks[a], kind="metrics")
            gsq = gsq + sq
        gnorm = torch.sqrt(gsq)
        params, opt, _ = adam_update(adam, _unflatten(grads, params),
                                     params, opt, gnorm=gnorm)
        return params, opt, {"loss": loss, "aux": aux, "total": total,
                             "gnorm": gnorm}

    return step


def _unflatten(flat: Dict[str, torch.Tensor], like) -> Dict:
    """`flat` (path -> tensor, `tree_items` paths) as `like`'s nesting."""
    def walk(t, prefix):
        return {k: (walk(t[k], f"{prefix}/{k}" if prefix else k)
                    if tfm.is_node(t[k]) else
                    flat[f"{prefix}/{k}" if prefix else k])
                for k in t.keys()}
    return walk(like, "")


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


# ----------------------------------------------------------------------------
# Serving across ranks: one stage a rank
# ----------------------------------------------------------------------------

def init_rank_carry(cfg: ArchConfig, dims: ServeDims, ranks,
                    dtype: torch.dtype, device: torch.device | str
                    ) -> Optional[Dict[str, torch.Tensor]]:
    """A rank's activation carry: what stage s-1 handed it on the last
    tick, ``xp`` [Sp, W, d] and ``xd`` [Sd, 1, d] at the full dims, and
    ``buf``, one flat buffer the hop lands in; None on stage 0."""
    if ranks.index("stage") == 0:
        return None
    d, W = cfg.d_model, dims.prefill_width
    return {"xp": torch.zeros((dims.Sp, W, d), dtype=dtype, device=device),
            "xd": torch.zeros((dims.Sd, 1, d), dtype=dtype, device=device),
            "buf": torch.zeros((dims.Sp * W + dims.Sd) * d, dtype=dtype,
                               device=device)}


def vocab_argmax(scores: torch.Tensor, offset: int, axes) -> torch.Tensor:
    """The first index of the largest score over the vocab split across
    `axes`: scores [rows, Vs] is this rank's slice, starting at global
    column `offset`.  Each axis gathers every slice's (max, index) pairs
    and keeps the larger, the lower index on a tie: ``torch.argmax`` of
    the whole row."""
    v, i = torch.max(scores, dim=-1)
    v, i = v.double(), (i + offset).double()
    for ax in axes:
        if ax is None or ax.size == 1:
            continue
        parts = torch.stack(coll.all_gather(torch.stack([v, i], dim=-1), ax,
                                            kind="head"))
        v = parts[..., 0].max(dim=0).values
        i = torch.where(parts[..., 0] == v, parts[..., 1],
                        torch.full_like(parts[..., 1], float("inf"))
                        ).min(dim=0).values
    return i.to(torch.int32)


def build_rank_serve_tick(cfg: ArchConfig, dims: ServeDims, ranks, *,
                          carry_dims: Optional[ServeDims] = None,
                          dtype: Optional[torch.dtype] = None):
    """One rank's part of the serve tick of `build_serve_tick`: returns
    tick_fn(params, caches, meta, carry, temps=None, gen=None) -> (caches,
    tokens), on every rank the same int32 [dp * (Sp+Sd)] tokens of the
    micro-batches exiting the ring, replica by replica (JAX's
    ``P("data")`` layout of its tick's tokens).

    `params` is the rank's shard, `caches` its stage's pools at its KV
    heads (`serve.init_caches` of `shard_config`), `carry` its
    `init_rank_carry`; `meta` as `build_serve_tick`'s, every stage's entry
    (each rank reads its own), for the rank's data replica, which runs
    its own rows at its own `dims` (its slots, pages and rows; JAX's
    ``ServeDims`` are per replica) and, where the experts are split over
    the replicas (`expert_group`), exchanges MoE rows with them in every
    MoE layer, so that every replica runs every tick.  At
    ``dims.seq_shard`` (a decode cell of fewer sequences than replicas)
    every replica runs the same decode rows over its shard of their KV,
    local page b holding global page b·dp + r, and the attention partials
    are merged over the data group (`attention.paged_attention`'s
    ``merge_axis``); the metadata is each replica's own (its tables, and
    its KV write, on the scratch page where another replica holds the
    row's page).  Stage 0 embeds the entering rows (the width gathered
    over `tensor`); every stage applies its layers to its
    micro-batch (its tensor group reducing the row-parallel products); the
    outputs hop one stage on (stage s-1's arrive in `carry` for the next
    tick); the last stage's sample rows are broadcast over the stage
    group, every (stage, tensor) rank takes its vocab slice of the logits,
    and `vocab_argmax` combines the slices: greedy rows get the whole
    row's argmax; rows with ``temps`` > 0 an exact draw from
    softmax(logits / T) by Gumbel-max (each slice's noise from `gen`, a
    generator seeded per rank), a different draw from the one-device
    engine's ``multinomial``."""
    full = carry_dims or dims
    if (dims.pages, dims.page, dims.slots, dims.Te) != \
            (full.pages, full.page, full.slots, full.Te) or \
            dims.Sp > full.Sp or dims.C > full.C or dims.Sd > full.Sd:
        raise ValueError(f"bucket {dims} does not fit the full dims {full}")
    dtype = dtype or getattr(torch, cfg.dtype)
    Sp, Sd, C, W = dims.Sp, dims.Sd, dims.C, dims.prefill_width
    S, s = ranks.size("stage"), ranks.index("stage")
    stage, tensor, data = ranks["stage"], ranks["tensor"], ranks["data"]
    tp = tensor if tensor.size > 1 else None
    ep = expert_group(cfg, ranks)
    seq = data if dims.seq_shard and data.size > 1 else None
    local = tfm.shard_config(cfg, tensor.size,
                             tfm.expert_parts(cfg, data.size))
    d = cfg.d_model
    rows = Sp + Sd

    def tick(params, caches, meta: Mapping[str, torch.Tensor],
             carry: Optional[Dict[str, torch.Tensor]] = None,
             temps: Optional[torch.Tensor] = None,
             gen: Optional[torch.Generator] = None):
        m = meta if S == 1 else {k: v if k in TOKEN_FIELDS else v[s]
                                 for k, v in meta.items()}
        if s == 0:
            tok = params["embed"]["tok"]
            xp = coll.gather_from_tensor(tok[meta["p_tok"][:Sp, :C]],
                                         tp).to(dtype)
            if dims.Te:
                xp = torch.cat([meta["p_enc"][:Sp].to(dtype), xp], dim=1)
            xd = coll.gather_from_tensor(tok[meta["d_tok"][:Sd]],
                                         tp).to(dtype)[:, None]
        else:
            xp = carry["xp"][:Sp, :W]
            xd = carry["xd"][:Sd]
        xp2, xd2, caches = serve_lib.stage_forward_serve(
            local, params["stages"], caches, xp, xd, m, dims, stage=s,
            index=0, tp=tp, ep=ep, seq=seq)
        if S > 1:                       # the hop: JAX's ppermute
            n = Sp * W * d
            send = recv = None
            if s < S - 1:
                send = (torch.cat([xp2.reshape(-1), xd2.reshape(-1)]),
                        stage.peer(1))
            if s > 0:
                recv = (carry["buf"][:n + Sd * d], stage.peer(-1))
            coll.exchange(send, recv, kind="hop")
            if s > 0:
                carry["xp"][:Sp, :W].copy_(carry["buf"][:n].view(Sp, W, d))
                carry["xd"][:Sd].copy_(
                    carry["buf"][n:n + Sd * d].view(Sd, 1, d))
        if s == S - 1:
            samples = []
            if Sp:
                idx = dims.Te + torch.clamp(m["p_chunk_lens"] - 1, min=0)
                samples.append(xp2[torch.arange(Sp, device=xp2.device),
                                   idx.long()])
            if Sd:
                samples.append(xd2[:, 0, :])
            h = torch.cat(samples, dim=0) if len(samples) > 1 \
                else samples[0]
        else:
            h = torch.empty((rows, d), dtype=dtype, device=xp2.device)
        coll.broadcast(h, stage, S - 1, kind="head")
        scores = tfm.head_apply(cfg, params, h).float()      # [rows, Vs]
        vs = scores.shape[-1]
        if temps is not None:
            u = torch.rand(scores.shape, generator=gen,
                           device=scores.device).clamp_(min=1e-20)
            hot = temps > 0.0
            scaled = scores / torch.clamp(temps, min=1e-3)[:, None] \
                - torch.log(-torch.log(u))
            scores = torch.where(hot[:, None], scaled, scores)
        tokens = vocab_argmax(
            scores, (s * tensor.size + tensor.index) * vs, (tensor, stage))
        if data.size > 1:               # every replica's, replica-major
            tokens = torch.cat(coll.all_gather(tokens, data, kind="head"))
        return caches, tokens

    return tick
