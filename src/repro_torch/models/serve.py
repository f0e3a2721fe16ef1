"""Serve-mode model execution (``repro.models.serve``): one pipeline stage's
forward over a micro-batch of prefill chunks and decode rows, with the paged
KV cache (ATTN_MLP, ATTN_MOE and DEC_LAYER blocks; MLA_MLP's latent pool),
per-sequence recurrent state slots (RWKV, MAMBA_MLP and MAMBA_MOE blocks)
and an encoder-decoder's encoder snapshots; one engine holds both kinds of
cache for a hybrid model (jamba).

Layouts (per stage, as in the JAX package):
  prefill payload  xp [Sp, C, d]   (whisper: [Sp, Te + C, d], enc slice first)
  decode payload   xd [Sd, 1, d]
  paged KV         [S, R, pages, page, 2, KH, hd] (S stages, R block repeat)
  MLA latent KV    [S, R, pages, page, klr + dr]
  RWKV state       tm_x, cm_x [S, R, slots, d]; wkv [S, R, slots, H, hd, hd]
  Mamba state      conv [S, R, slots, dc-1, di]; ssm [S, R, slots, di, ds]
  whisper encoder  h [S, slots, Te, d] per ENC_LAYER group

**Encoder snapshots.**  A prefill chunk carries its request's encoder
stream through the encoder layers; after each ENC_LAYER group the stream
is written into that group's snapshot ``h`` at the request's slot, and the
decode rows of the DEC_LAYER group after it cross-attend to that snapshot.
The JAX package keeps one snapshot per stage (its stage pattern is one
encoder group then one decoder group); the port keeps one per encoder
group, so that a model folded into one stage (`single_stage`: whisper's
``ENC3 DEC3`` four times over) still gives each decoder group the encoder
hidden at its own depth, as the dense reference does.

The tick's metadata is built on the host as numpy (`zero_meta`, the JAX
field names and shapes; `host_meta` adds what the tick computes from it)
and reaches the device in one copy, into one int32 buffer the tick reads
as views (`unpack_meta`).  The KV pool is updated in place: each layer works on the
contiguous view ``cache[s, r]`` (the JAX version donates the buffer), and
so are the recurrent state slots.

Every array a tick reads has a shape fixed by its bucket (`bucket_ladder`),
so that one CUDA graph per bucket can replay it.  Rows that write nothing
(padding, pages off the pool) write into a scratch page at index ``pages``
of the KV pool and a scratch slot at index ``slots`` of each state pool,
which no request is ever handed (`init_caches` allocates both).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, BlockKind
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (
    apply_norm,
    layernorm,
    mlp_apply,
    mlp_partial,
    mrope_tables,
    rmsnorm,
    rope_tables,
    rotate,
)
from repro_torch.distributed import collectives as coll
from repro_torch.models.transformer import (
    ENC_DEC_KINDS,
    MAMBA_KINDS,
    MOE_KINDS,
    _block_key,
    _heads,
    cross_attend,
    cross_kv,
)

# kinds whose layers attend over the paged pool with RoPE'd positions
PAGED_KINDS = (BlockKind.ATTN_MLP, BlockKind.ATTN_MOE, BlockKind.MLA_MLP,
               BlockKind.DEC_LAYER)

# Flash KV-block granularity (pages per gather step) and the KV-depth bucket
# divisors: the JAX package's defaults (its REPRO_PAGES_PER_BLOCK and
# REPRO_DEPTH_STEPS), taken here as constants.
PAGES_PER_BLOCK = 8
DEPTH_DIVISORS: Tuple[int, ...] = (4, 2, 1)
STATE_KINDS = (BlockKind.RWKV,) + MAMBA_KINDS


@dataclass(frozen=True)
class ServeDims:
    """Static bucket sizes for one serving cell, per replica."""

    Sp: int              # prefill sequences per tick (0 for decode-only cells)
    C: int               # prefill chunk bucket (tokens per prefill seq)
    Sd: int              # decode rows per tick
    pages: int           # KV pool size (pages) per replica, per layer
    page: int            # page size in tokens
    Bp: int              # max pages per prefill seq's block table
    Bd: int              # max pages per decode seq's block table
    slots: int           # recurrent-state / enc-cache sequence slots
    Te: int = 0          # whisper encoder bucket (0 for non-enc-dec)
    seq_shard: bool = False   # decode KV sequence-sharded over `data`

    @property
    def prefill_width(self) -> int:
        return self.Te + self.C

    @property
    def rows(self) -> int:
        return self.Sp * self.prefill_width + self.Sd


def depth_steps(B: int, *, pages_per_block: Optional[int] = None,
                divisors: Optional[Sequence[int]] = None) -> Tuple[int, ...]:
    """Block-table depth buckets for a phase whose full table is `B` pages:
    {⌈B/k⌉ for k in `divisors`} rounded up to multiples of the flash gather
    granularity (`pages_per_block`), deduplicated, always including B.  A
    full width not divisible by `pages_per_block` gets no sub-buckets."""
    ppb = PAGES_PER_BLOCK if pages_per_block is None else pages_per_block
    if B <= 0 or ppb <= 0 or B % ppb != 0:
        return (B,)
    divisors = DEPTH_DIVISORS if divisors is None else tuple(divisors)
    steps = {B}
    for k in divisors:
        if k > 0:
            need = -(-B // k)                         # ⌈B/k⌉ pages demanded
            steps.add(min(B, ppb * -(-need // ppb)))  # …rounded to blocks
    return tuple(sorted(steps))


def bucket_ladder(dims: ServeDims,
                  depth_divisors: Optional[Sequence[int]] = None
                  ) -> Tuple[ServeDims, ...]:
    """Fixed ladder of serve shapes for bucketed execution: prefill-chunk
    buckets {0, ⌈C/4⌉, ⌈C/2⌉, C} × decode-row buckets {⌈Sd/4⌉, ⌈Sd/2⌉, Sd}
    × KV depth (the block-table widths Bp/Bd stepped per `depth_steps`, one
    shared depth index for both phases), deduplicated.  A phase with no
    rows in an entry keeps its full table width.  Every entry keeps the full
    `dims` cache geometry (pages/page/slots/Te), so one KV pool, one state
    pool and one parameter tree serve the whole ladder.  The fully empty
    (Sp=0, Sd=0) shape is excluded: bubble ticks run in the smallest
    non-empty bucket."""
    def ceil_div(a: int, b: int) -> int:
        return -(-a // b)

    c_steps = sorted({max(1, ceil_div(dims.C, 4)),
                      max(1, ceil_div(dims.C, 2)), dims.C})
    d_steps = ([0] if dims.Sd == 0 else
               sorted({max(1, ceil_div(dims.Sd, 4)),
                       max(1, ceil_div(dims.Sd, 2)), dims.Sd}))
    bp_steps = depth_steps(dims.Bp, divisors=depth_divisors)
    bd_steps = depth_steps(dims.Bd, divisors=depth_divisors)
    depth_pairs = []
    for i in range(max(len(bp_steps), len(bd_steps))):
        pair = (bp_steps[min(i, len(bp_steps) - 1)],
                bd_steps[min(i, len(bd_steps) - 1)])
        if pair not in depth_pairs:
            depth_pairs.append(pair)
    ladder, seen = [], set()
    for Sd_b in d_steps:
        variants = [(0, dims.C)]
        if dims.Sp > 0:
            variants += [(dims.Sp, c) for c in c_steps]
        for Sp_b, C_b in variants:
            for Bp_b, Bd_b in depth_pairs:
                bp = Bp_b if Sp_b > 0 else dims.Bp
                bd = Bd_b if Sd_b > 0 else dims.Bd
                key = (Sp_b, C_b, Sd_b, bp, bd)
                if key in seen or (Sp_b == 0 and Sd_b == 0):
                    continue
                seen.add(key)
                ladder.append(replace(dims, Sp=Sp_b, C=C_b, Sd=Sd_b,
                                      Bp=bp, Bd=bd))
    return tuple(ladder)


def select_bucket(ladder: Sequence[ServeDims], need_c: int, need_d: int,
                  need_bp: int = 0, need_bd: int = 0) -> ServeDims:
    """Smallest ladder entry covering a tick whose widest prefill chunk is
    `need_c` tokens, whose decode rows number `need_d`, and whose deepest
    prefill/decode block tables hold `need_bp`/`need_bd` live pages.
    Minimality is by padded row count (`rows`); ties break toward the
    narrower prefill bucket, the smaller decode bucket, then the shallower
    block tables.  Depth demands bind only for phases with rows.  Raises
    ValueError when no entry covers the demand."""
    best: Optional[ServeDims] = None
    for b in ladder:
        covers = ((need_c == 0 or (b.Sp > 0 and b.C >= need_c
                                   and b.Bp >= need_bp))
                  and b.Sd >= need_d
                  and (need_d == 0 or b.Bd >= need_bd))
        if not covers:
            continue
        key = (b.rows, b.C, b.Sd, b.Bp, b.Bd)
        if best is None or key < (best.rows, best.C, best.Sd,
                                  best.Bp, best.Bd):
            best = b
    if best is None:
        raise ValueError(
            f"no bucket covers need_c={need_c}, need_d={need_d}, "
            f"need_bp={need_bp}, need_bd={need_bd} "
            f"(ladder max C={max(b.C for b in ladder)}, "
            f"Sd={max(b.Sd for b in ladder)}, "
            f"Bp={max(b.Bp for b in ladder)}, "
            f"Bd={max(b.Bd for b in ladder)})")
    return best


def _meta_field_defs(dims: ServeDims) -> Dict[str, Tuple[int, ...]]:
    Sp, C, Sd = dims.Sp, dims.C, dims.Sd
    return {
        "p_positions": (Sp, C),
        "p_chunk_lens": (Sp,),
        "p_context_lens": (Sp,),
        "p_block_tables": (Sp, dims.Bp),
        "p_slot_pages": (Sp, C),
        "p_slot_offsets": (Sp, C),
        "p_state_slots": (Sp,),
        "p_sample": (Sp,),            # 1 if chunk finishes prefill
        "d_positions": (Sd,),
        "d_context_lens": (Sd,),
        "d_block_tables": (Sd, dims.Bd),
        "d_slot_pages": (Sd,),
        "d_slot_offsets": (Sd,),
        "d_state_slots": (Sd,),
        "d_valid": (Sd,),
    }


def zero_meta(dims: ServeDims) -> Dict[str, np.ndarray]:
    """The empty tick's host metadata (int32; padding rows write to page -1)."""
    out = {}
    for k, shape in _meta_field_defs(dims).items():
        fill = -1 if k in ("p_slot_pages", "d_slot_pages") else 0
        out[k] = np.full(shape, fill, np.int32)
    return out


def host_to_device(t: torch.Tensor, device: torch.device | str
                   ) -> torch.Tensor:
    """Copy host tensor `t` to `device`.  On CUDA the copy goes through
    pinned memory and does not block the host: it queues behind the device's
    earlier work instead of waiting for it."""
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def host_meta(meta: Mapping[str, np.ndarray], dims: ServeDims,
              extra: Optional[Mapping[str, np.ndarray]] = None
              ) -> Dict[str, np.ndarray]:
    """One tick's host metadata (at `dims`' shapes) with the fields the tick
    needs computed from it, every array int32 and of a shape fixed by
    `dims`, then the `extra` arrays (e.g. the fresh token ids):

    ``p_kv_pages`` [Sp, C] / ``d_kv_pages`` [Sd], each row's KV destination
    page: its own where it writes (valid, inside the pool), else
    ``dims.pages``, the scratch page (`attention.kv_targets`);
    ``p_write_slots`` [Sp] / ``d_write_slots`` [Sd], where each row's
    shift/conv state is written back: its own slot for a live row, else
    ``dims.slots``, the scratch slot (padding rows carry slot 0, which a
    live row may hold); ``p_fresh`` / ``d_fresh``, 1 where a row's state
    starts from zero (a prefill chunk at position 0: a new request, or a
    recompute after preemption, on a slot another request may have left
    state in)."""
    fields = dict(meta)
    p_valid = np.arange(dims.C)[None, :] < meta["p_chunk_lens"][:, None]
    fields["p_kv_pages"] = attn.kv_targets(p_valid, meta["p_slot_pages"],
                                           dims.pages)
    fields["d_kv_pages"] = attn.kv_targets(meta["d_valid"] > 0,
                                           meta["d_slot_pages"], dims.pages)
    p_live = meta["p_chunk_lens"] > 0
    fields["p_write_slots"] = np.where(p_live, meta["p_state_slots"],
                                       dims.slots)
    # a decode-only cell (Sp = C = 0) has no first column to read
    first = (meta["p_positions"][:, 0] if dims.C
             else np.zeros(dims.Sp, np.int32))
    fields["p_fresh"] = p_live & (first == 0)
    fields["d_write_slots"] = np.where(meta["d_valid"] > 0,
                                       meta["d_state_slots"], dims.slots)
    fields["d_fresh"] = np.zeros(dims.Sd, np.int32)
    fields.update(extra or {})
    return {k: np.asarray(a, np.int32) for k, a in fields.items()}


def unpack_meta(flat: torch.Tensor, shapes: Mapping[str, Tuple[int, ...]]
                ) -> Dict[str, torch.Tensor]:
    """Views of the one int32 buffer `flat` as the fields `shapes` names,
    laid out one after the other in that order."""
    out, off = {}, 0
    for k, shape in shapes.items():
        n = int(np.prod(shape))
        out[k] = flat[off:off + n].view(shape)
        off += n
    return out


# ----------------------------------------------------------------------------
# Cache construction
# ----------------------------------------------------------------------------

def block_cache_defs(cfg: ArchConfig, kind: BlockKind, dims: ServeDims,
                     repeat: int) -> Dict[str, Tuple[int, ...]]:
    """Shape per cache array of one block group (no stage dim): the JAX
    package's, plus the scratch page or slot at the end of each pool.  An
    ENC_LAYER group holds its encoder snapshot ``h`` [slots, Te, d] (one
    for the group, not per layer).  At a tensor rank's widths
    (`transformer.shard_config`) each is the rank's block of JAX's cache
    spec: the KV heads, the WKV heads and Mamba's channels split; the MLA
    latent pool, the RWKV shift states and the encoder snapshot, which
    hold d_model or the latent, whole."""
    R, slots = repeat, dims.slots + 1
    if kind == BlockKind.ENC_LAYER:
        return {"h": (slots, dims.Te, cfg.d_model)}
    if kind == BlockKind.MLA_MLP:
        return {"kv": (R, dims.pages + 1, dims.page,
                       cfg.kv_lora_rank + cfg.qk_rope_dim)}
    if kind == BlockKind.RWKV:
        H, hd = cfg.num_rwkv_heads, cfg.rwkv_head_dim
        return {"tm_x": (R, slots, cfg.d_model),
                "cm_x": (R, slots, cfg.d_model),
                "wkv": (R, slots, H, hd, hd)}
    if kind in MAMBA_KINDS:
        di = cfg.mamba_d_inner
        return {"conv": (R, slots, cfg.mamba_d_conv - 1, di),
                "ssm": (R, slots, di, cfg.mamba_d_state)}
    return {"kv": (R, dims.pages + 1, dims.page, 2,
                   max(1, cfg.num_kv_heads), cfg.head_dim)}


def cache_defs(cfg: ArchConfig, dims: ServeDims) -> Dict[str, Dict[str, tuple]]:
    """Cache tree of shapes with the leading stage dim (same leaf names as
    the JAX package, but for the per-group encoder snapshots).  Raises
    when a DEC_LAYER group has no ENC_LAYER group before it in the stage
    pattern, or the encoder width ``dims.Te`` is 0."""
    S = cfg.plan.pp
    kinds = [bs.kind for bs in cfg.pattern]
    if BlockKind.DEC_LAYER in kinds and (
            BlockKind.ENC_LAYER not in kinds[:kinds.index(BlockKind.DEC_LAYER)]
            or dims.Te <= 0):
        raise ValueError(f"{cfg.name}: a decoder group needs an encoder "
                         f"group before it in the stage pattern and Te > 0 "
                         f"(pattern {[k.value for k in kinds]}, Te {dims.Te})")
    return {_block_key(i, bs): {
        name: (S,) + shape for name, shape in
        block_cache_defs(cfg, bs.kind, dims, bs.repeat).items()}
        for i, bs in enumerate(cfg.pattern)}


F32_STATE_LEAVES = ("wkv", "ssm")      # recurrent states carry in f32


def init_caches(cfg: ArchConfig, dims: ServeDims,
                dtype: Optional[torch.dtype] = None,
                device: torch.device | str = "cpu"):
    dtype = dtype or getattr(torch, cfg.dtype)
    return {gk: {name: torch.zeros(
        shape, dtype=torch.float32 if name in F32_STATE_LEAVES else dtype,
        device=device) for name, shape in grp.items()}
        for gk, grp in cache_defs(cfg, dims).items()}


def cache_tensor_dims(cfg: ArchConfig, local: ArchConfig, dims: ServeDims
                      ) -> Dict[str, Optional[int]]:
    """For each cache leaf ``"{group}/{name}"``, the dim that a tensor
    rank's pool splits (where `block_cache_defs` at the rank's widths,
    `local` = `transformer.shard_config`, differs from `cfg`'s), counted
    without the stage dim; None for a leaf each tensor rank holds whole
    (MLA's latent, RWKV's shift states, encoder snapshots).  It is also
    the dim of a migration row of the leaf: a KV leaf's [S, R, n, 2, KH,
    hd], a slot leaf's slot [S, R, ...] or [S, Te, d]."""
    out: Dict[str, Optional[int]] = {}
    for i, bs in enumerate(cfg.pattern):
        whole = block_cache_defs(cfg, bs.kind, dims, bs.repeat)
        part = block_cache_defs(local, bs.kind, dims, bs.repeat)
        for name, shape in whole.items():
            diff = [d for d, (a, b) in enumerate(zip(shape, part[name]))
                    if a != b]
            out[f"{_block_key(i, bs)}/{name}"] = diff[0] if diff else None
    return out


def join_cache_rows(grid: Sequence[Sequence[torch.Tensor]],
                    dim: Optional[int]) -> torch.Tensor:
    """A whole migration row of one cache leaf from its rank blocks,
    ``grid[stage][tensor]``: the tensor blocks side by side on `dim`
    (`cache_tensor_dims`; tensor rank 0's block for a leaf held whole),
    then the stages on dim 0, in the one-process pool's layout."""
    return torch.cat([row[0] if dim is None else torch.cat(list(row), dim)
                      for row in grid], 0)


def split_cache_rows(whole: torch.Tensor, dim: Optional[int], stages: int,
                     tp: int) -> List[List[torch.Tensor]]:
    """`join_cache_rows`'s inverse: ``grid[stage][tensor]``, each stage's
    block of dim 0 cut on `dim` into `tp` blocks (the whole stage block on
    every tensor rank for a leaf held whole)."""
    out = []
    for st in whole.chunk(stages, 0):
        out.append([st] * tp if dim is None else list(st.chunk(tp, dim)))
    return out


# ----------------------------------------------------------------------------
# Serve-mode attention
# ----------------------------------------------------------------------------

def _qkv_rows(cfg: ArchConfig, p, x: torch.Tensor, rope):
    """x [S, T, d], rope = (cos, sin) of the rows' positions
    (`layers.rope_tables`) -> q [S,T,H,hd], k/v [S,T,KH,hd]."""
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = rotate(_heads(q, cfg.num_heads, cfg.head_dim), *rope)
    k = rotate(_heads(k, cfg.num_kv_heads, cfg.head_dim), *rope)
    v = _heads(v, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def _phase_rows(meta: Mapping[str, torch.Tensor], is_prefill: bool):
    """One phase's (positions [S, T], block tables, context lengths, KV
    destination pages and offsets [S, T], RoPE tables)."""
    if is_prefill:
        positions = meta["p_positions"]
        tables, ctx = meta["p_block_tables"], meta["p_context_lens"]
        pages, offs = meta["p_kv_pages"], meta["p_slot_offsets"]
        rope = meta["p_rope"]
    else:
        positions = meta["d_positions"][:, None]
        tables, ctx = meta["d_block_tables"], meta["d_context_lens"]
        pages = meta["d_kv_pages"][:, None]
        offs = meta["d_slot_offsets"][:, None]
        rope = meta["d_rope"]
    return positions, tables, ctx, pages, offs, rope


def _paged_self_attention(cfg: ArchConfig, p, xs: torch.Tensor,
                          cache: torch.Tensor, meta: Mapping[str, torch.Tensor],
                          is_prefill: bool, tp=None, seq=None) -> torch.Tensor:
    """Project, write pages (in place), attend.  Returns the attention
    output; at a tensor rank `tp` (the heads, the pool's KV heads and the
    out-projection's rows the rank's) the rank's partial sum of it, which
    the caller reduces over the group (`_reduce_rows`).  `seq`: the data
    group over which a decode row's KV is sequence-sharded
    (``ServeDims.seq_shard``; `attention.paged_attention`'s
    ``merge_axis``): the pool and the tables are this replica's shard, and
    the metadata sends the row's new K/V to the replica that holds its
    page (the scratch page on the others).  Decode rows only: JAX shards
    only decode cells, which have no prefill rows."""
    if is_prefill and seq is not None:
        raise ValueError("sequence-sharded KV is for decode rows only: a "
                         "seq_shard cell has Sp = 0")
    positions, tables, ctx, pages, offs, rope = _phase_rows(meta,
                                                            is_prefill)

    q, k, v = _qkv_rows(cfg, p, coll.copy_to_tensor(xs, tp), rope)
    new_kv = torch.stack([k, v], dim=2)                   # [S, T, 2, KH, hd]
    attn.write_kv_pages(cache, new_kv, pages, offs)
    o = attn.paged_attention(q, cache, tables, ctx, positions,
                             merge_axis=seq)
    return o.reshape(o.shape[:-2] + (-1,)) @ p["wo"]


def _reduce_rows(tp, *parts: torch.Tensor):
    """`parts` summed over the tensor group in one all-reduce (the
    prefill and decode phases' partial attention outputs of a layer)."""
    if tp is None:
        return parts
    flat = coll.reduce_from_tensor(
        torch.cat([t.reshape(-1) for t in parts]), tp)
    out, off = [], 0
    for t in parts:
        out.append(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return out


def _paged_mla_attention(cfg: ArchConfig, p, xs: torch.Tensor,
                         cache: torch.Tensor, meta: Mapping[str, torch.Tensor],
                         is_prefill: bool, tp=None) -> torch.Tensor:
    """MLA: project, write the normed latent and the rotated rope key into
    the latent pool (in place), attend (`attention.paged_attention_mla`).
    Returns the attention output; at a tensor rank `tp`, where the
    down-projections and the latent pool are replicated and the heads the
    rank's, its partial sum, which the caller reduces (`_reduce_rows`)."""
    S, T, _ = xs.shape
    H = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    klr = cfg.kv_lora_rank
    positions, tables, ctx, pages, offs, rope = _phase_rows(meta,
                                                            is_prefill)
    cq = rmsnorm(xs @ p["w_dq"], p["q_norm_g"], cfg.norm_eps)
    q = (cq @ p["w_uq"]).reshape(S, T, H, dn + dr)
    q = torch.cat([q[..., :dn], rotate(q[..., dn:], *rope)], dim=-1)
    ckv_full = xs @ p["w_dkv"]
    ckv = rmsnorm(ckv_full[..., :klr], p["kv_norm_g"], cfg.norm_eps)
    k_rope = rotate(ckv_full[..., None, klr:], *rope)[..., 0, :]
    attn.write_kv_pages(cache, torch.cat([ckv, k_rope], dim=-1), pages, offs)
    o = attn.paged_attention_mla(q, cache, p["w_ukv"], tables, ctx,
                                 positions, kv_lora_rank=klr,
                                 qk_nope_dim=dn, v_head_dim=dv)
    return o.reshape(S, T, H * dv) @ p["wo"]


# ----------------------------------------------------------------------------
# Serve-mode RWKV
# ----------------------------------------------------------------------------

def _rwkv_serve(cfg: ArchConfig, p, rows: Dict[str, torch.Tensor],
                cache: Dict[str, torch.Tensor],
                meta: Mapping[str, torch.Tensor], tp=None
                ) -> Dict[str, torch.Tensor]:
    """One RWKV block over each phase's rows (`rows`: "p" and/or "d" to
    the phase's [rows, T, d]), from and back into the rows' state slots:
    the time mix of every phase, then the channel mix of every phase, so
    that at a tensor rank `tp` each mixer's partial sums of both phases are
    reduced in one all-reduce (`_reduce_rows`).  Fresh rows start from
    zero state whatever their slot holds; the WKV pool is advanced in place
    by the scan (live tokens only); the shift states of padding rows go to
    the scratch slot (`host_meta`).  Padding positions come out as zeros,
    as the JAX mask makes them.  Prefill runs before decode in each mixer,
    and the two phases hold different slots."""
    hd, eps = cfg.rwkv_head_dim, cfg.norm_eps
    states, lens, valid = {}, {}, {}
    for ph in rows:
        slots, fresh = meta[f"{ph}_state_slots"], meta[f"{ph}_fresh"]
        zero = (fresh > 0)[:, None]
        states[ph] = ssm_lib.RWKVState(
            tm_x=cache["tm_x"][slots].masked_fill(zero, 0),
            cm_x=cache["cm_x"][slots].masked_fill(zero, 0),
            wkv=cache["wkv"], slots=slots, fresh=fresh)
        lens[ph] = meta["p_chunk_lens"] if ph == "p" else meta["d_valid"]
        valid[ph] = meta[f"{ph}_mask"][..., None]
    att = []
    for ph, x in rows.items():
        out, tm_x, _ = ssm_lib.rwkv_time_mix(
            layernorm(x, p["ln1_g"], p["ln1_b"], eps), p, head_dim=hd,
            state=states[ph], chunk_lens=lens[ph], tp=tp)
        cache["tm_x"][meta[f"{ph}_write_slots"]] = tm_x
        att.append(out)
    rows = {ph: x + a.masked_fill(~valid[ph], 0)
            for (ph, x), a in zip(rows.items(), _reduce_rows(tp, *att))}
    recept, value = [], []
    for ph, x in rows.items():
        r, kv, cm_x = ssm_lib.rwkv_channel_mix_parts(
            layernorm(x, p["ln2_g"], p["ln2_b"], eps), p, state=states[ph],
            chunk_lens=lens[ph], tp=tp)
        cache["cm_x"][meta[f"{ph}_write_slots"]] = cm_x
        recept.append(r)
        value.append(kv)
    return {ph: (x + r * kv).masked_fill(~valid[ph], 0)
            for (ph, x), r, kv in zip(rows.items(), recept,
                                      _reduce_rows(tp, *value))}


def _mamba_serve(cfg: ArchConfig, p, xs: torch.Tensor,
                 cache: Dict[str, torch.Tensor],
                 meta: Mapping[str, torch.Tensor], phase: str,
                 tp=None) -> torch.Tensor:
    """One Mamba mixer over one phase's rows (`phase` "p" or "d"), from and
    back into the rows' state slots.  Fresh rows start from zero conv and
    scan state whatever their slot holds; the scan advances the `ssm` pool
    in place (live tokens only); the conv state of padding rows goes to
    the scratch slot (`host_meta`).  Padding positions come out as zeros,
    as the JAX mask makes them.  At a tensor rank `tp` (its channels and
    their state) the rank's partial sum, which the caller reduces."""
    slots, fresh = meta[f"{phase}_state_slots"], meta[f"{phase}_fresh"]
    lens = meta["p_chunk_lens"] if phase == "p" else meta["d_valid"]
    valid = meta[f"{phase}_mask"]
    conv = cache["conv"][slots].masked_fill((fresh > 0)[:, None, None], 0)
    state = ssm_lib.MambaState(conv=conv, ssm=cache["ssm"], slots=slots,
                               fresh=fresh)
    out, new_conv = ssm_lib.mamba_mixer(
        xs, p, d_state=cfg.mamba_d_state, d_conv=cfg.mamba_d_conv,
        state=state, chunk_lens=lens, tp=tp)
    cache["conv"][meta[f"{phase}_write_slots"]] = new_conv
    return out.masked_fill(~valid[..., None], 0)


def _mlp_rows(cfg: ArchConfig, p, tp, *hs: torch.Tensor):
    """The MLP of each of `hs`; at a tensor rank `tp` their partial sums
    reduced in one all-reduce (`_reduce_rows`), then the output bias
    added."""
    if tp is None:
        return [mlp_apply(h, p, cfg.act) for h in hs]
    outs = _reduce_rows(tp, *(mlp_partial(h, p, cfg.act) for h in hs))
    return [o + p["b2"] if "b2" in p else o for o in outs]


def _enc_dec_serve(cfg: ArchConfig, kind: BlockKind, p, norm,
                   xp: torch.Tensor, xd: torch.Tensor,
                   cache: Optional[Dict[str, torch.Tensor]],
                   meta: Mapping[str, torch.Tensor], dims: ServeDims,
                   enc_h: Optional[torch.Tensor], tp=None):
    """One whisper block.  ENC_LAYER: bidirectional self-attention and MLP
    over the prefill payload's encoder slice; decode rows pass through.
    DEC_LAYER: paged causal self-attention, cross-attention and MLP over the
    payload's decoder slice (to the encoder slice beside it) and over the
    decode rows (to their snapshot `enc_h` [Sd, Te, d]), each sublayer of
    both phases before the next, so that at a tensor rank `tp` (the heads
    and the MLP's columns the rank's) both phases' partial sums are
    reduced in one all-reduce."""
    Sp, Sd, Te = dims.Sp, dims.Sd, dims.Te
    if kind == BlockKind.ENC_LAYER:
        if Sp:
            enc = xp[:, :Te]
            q, k, v = _qkv_rows(cfg, p, norm("ln1", enc), meta["e_rope"])
            o = attn.cross_attention(q, k, v)            # bidirectional
            o, = _reduce_rows(tp, o.reshape(Sp, Te, -1) @ p["wo"])
            enc = enc + o
            enc = enc + _mlp_rows(cfg, p, tp, norm("ln2", enc))[0]
            xp = torch.cat([enc, xp[:, Te:]], dim=1)
        return xp, xd
    rows, ctx = [], []
    if Sp:
        rows.append(("p", xp[:, Te:]))
        ctx.append(xp[:, :Te])
    if Sd:
        rows.append(("d", xd))
        ctx.append(enc_h)
    outs = _reduce_rows(tp, *(_paged_self_attention(
        cfg, p, norm("ln1", x), cache["kv"], meta, ph == "p", tp=tp)
        for ph, x in rows))
    rows = [(ph, x + o) for (ph, x), o in zip(rows, outs)]
    outs = _reduce_rows(tp, *(cross_attend(
        cfg, p, norm("ln3", x), *cross_kv(cfg, p, enc), tp=tp)
        for (ph, x), enc in zip(rows, ctx)))
    rows = [(ph, x + o) for (ph, x), o in zip(rows, outs)]
    outs = _mlp_rows(cfg, p, tp, *(norm("ln2", x) for _, x in rows))
    for (ph, x), o in zip(rows, outs):
        if ph == "p":
            xp = torch.cat([xp[:, :Te], x + o], dim=1)
        else:
            xd = x + o
    return xp, xd


def block_apply_serve(cfg: ArchConfig, kind: BlockKind, p,
                      xp: torch.Tensor, xd: torch.Tensor,
                      cache: Optional[Dict[str, torch.Tensor]],
                      meta: Mapping[str, torch.Tensor], dims: ServeDims,
                      enc_h: Optional[torch.Tensor] = None, tp=None,
                      ep=None, seq=None):
    """One block over the stage's micro-batch: xp [Sp, W, d] prefill
    payload (W = Te + C for whisper, C otherwise), xd [Sd, 1, d] decode
    rows.  Both phases run whenever their bucket is non-empty
    (`dims.Sp`/`dims.Sd`), whatever rows are live.  A recurrent block runs
    prefill first, and decode reads the state prefill left.  A DEC_LAYER's
    decode rows cross-attend to `enc_h` [Sd, Te, d], their encoder
    snapshots.
    The MoE FFN routes only the live rows (``meta["row_valid"]``, see
    `stage_forward_serve`): padding rows consume no expert capacity; with
    `ep` (the rank's data group) its experts are split over the data
    replicas, and every replica's rows, live or not, join the exchanges.
    `tp`: the block at a tensor rank (the widths of `cfg`,
    `transformer.shard_config`): every mixer and FFN returns the rank's
    partial sums, and each sublayer's of both phases are reduced in one
    all-reduce (`_reduce_rows`; the FFN runs over both phases' rows at
    once).  `seq`: the data group of a sequence-sharded decode
    (`_paged_self_attention`).  Returns (xp, xd, cache); the cache is
    updated in place."""
    if tp is not None and tp.size == 1:
        tp = None
    if kind == BlockKind.RWKV:
        rows = {}
        if dims.Sp:
            rows["p"] = xp
        if dims.Sd:
            rows["d"] = xd
        rows = _rwkv_serve(cfg, p, rows, cache, meta, tp)
        return rows.get("p", xp), rows.get("d", xd), cache

    def norm(name, h):
        keys = {"g": p[f"{name}_g"]}
        if f"{name}_b" in p:
            keys["b"] = p[f"{name}_b"]
        return apply_norm(h, keys, cfg.norm, cfg.norm_eps)

    if kind in ENC_DEC_KINDS:
        xp, xd = _enc_dec_serve(cfg, kind, p, norm, xp, xd, cache, meta,
                                dims, enc_h, tp)
        return xp, xd, cache

    Sp, Sd = dims.Sp, dims.Sd
    outs = []
    if kind in MAMBA_KINDS:
        if Sp:
            outs.append(_mamba_serve(cfg, p, norm("ln1", xp), cache, meta,
                                     "p", tp))
        if Sd:
            outs.append(_mamba_serve(cfg, p, norm("ln1", xd), cache, meta,
                                     "d", tp))
    elif kind == BlockKind.MLA_MLP:
        if Sp:
            outs.append(_paged_mla_attention(cfg, p, norm("ln1", xp),
                                             cache["kv"], meta, True, tp=tp))
        if Sd:
            outs.append(_paged_mla_attention(cfg, p, norm("ln1", xd),
                                             cache["kv"], meta, False, tp=tp))
    else:
        if Sp:
            outs.append(_paged_self_attention(cfg, p, norm("ln1", xp),
                                              cache["kv"], meta, True, tp=tp,
                                              seq=seq))
        if Sd:
            outs.append(_paged_self_attention(cfg, p, norm("ln1", xd),
                                              cache["kv"], meta, False, tp=tp,
                                              seq=seq))
    outs = list(_reduce_rows(tp, *outs))
    if Sp:
        xp = xp + outs.pop(0)
    if Sd:
        xd = xd + outs.pop(0)

    # ffn over all rows (flattened)
    parts = []
    if Sp:
        parts.append(norm("ln2", xp).reshape(-1, cfg.d_model))
    if Sd:
        parts.append(norm("ln2", xd).reshape(-1, cfg.d_model))
    flat = torch.cat(parts, dim=0) if len(parts) > 1 else parts[0]
    if kind in MOE_KINDS:
        y, _ = moe_lib.moe_apply(flat, p, top_k=cfg.num_experts_per_tok,
                                 capacity_factor=cfg.moe_capacity_factor,
                                 row_valid=meta["row_valid"], tp=tp, ep=ep)
    else:
        y = mlp_apply(flat, p, cfg.act, tp)
    n = Sp * xp.shape[1] if Sp else 0
    if Sp:
        xp = xp + y[:n].reshape(xp.shape)
    if Sd:
        xd = xd + y[n:].reshape(xd.shape)
    return xp, xd, cache


def _rope_for(cfg: ArchConfig, positions: torch.Tensor, dim: int):
    """(cos, sin) for `positions` [..., T]: RoPE, or M-RoPE with the three
    position streams equal (text tokens)."""
    if cfg.mrope:
        pos3 = positions.expand((3,) + tuple(positions.shape))
        return mrope_tables(pos3, cfg.mrope_sections, dim, cfg.rope_theta)
    return rope_tables(positions, dim, cfg.rope_theta)


def stage_forward_serve(cfg: ArchConfig, stage_params, caches, xp, xd, meta,
                        dims: ServeDims, *, stage: int = 0,
                        index: Optional[int] = None, tp=None, ep=None,
                        seq=None):
    """Apply one stage's blocks to its micro-batch, a Python loop over the
    repeats.  `stage_params` leaves are ``[S, R, ...]``; layer ``(stage, r)``
    uses the views ``p[i, r]`` and ``cache[i, r]``, the latter updated in
    place, at ``i = index`` (a rank that holds only its stage's leaves and
    caches passes 0), else ``i = stage``.  `tp`: the rank's tensor group,
    `ep`: its data group when the experts are split over it, `seq`: its
    data group when the decode KV is sequence-sharded over it
    (`block_apply_serve`).  Padded layers (global index >= num_layers) are the
    identity, as the JAX mask makes them.  Returns (xp, xd, caches).

    The loop runs eagerly, one launch per op, so per-tick work that every
    layer shares is done once here: the RoPE tables of both phases (added
    to `meta` as ``p_rope``/``d_rope``, at the MLA rope width for MLA; the
    encoder's as ``e_rope``), the MoE blocks' live-row mask
    (``row_valid``: prefill rows inside their chunk, then live decode rows,
    in the order the FFN flattens them) and the per-layer views (one
    ``unbind`` per leaf).  Recurrent blocks (RWKV, Mamba) use no RoPE; they
    share each phase's [rows, T] live-position mask (``p_mask``/``d_mask``).
    The RoPE tables are built only when the pattern has an attention
    block.  After each ENC_LAYER group a prefill row's encoder slice is
    written into the group's snapshot at its slot (padding rows: the
    scratch slot, `host_meta`'s ``p_write_slots``); each DEC_LAYER group's
    decode rows read the snapshot of the encoder group before it, gathered
    once for the group."""
    meta = dict(meta)
    at = stage if index is None else index
    kinds = {bs.kind for bs in cfg.pattern}
    if kinds & set(PAGED_KINDS):
        dim = cfg.qk_rope_dim if cfg.mla else cfg.head_dim
        if dims.Sp:
            meta["p_rope"] = _rope_for(cfg, meta["p_positions"], dim)
        if dims.Sd:
            meta["d_rope"] = _rope_for(cfg, meta["d_positions"][:, None],
                                       dim)
    if BlockKind.ENC_LAYER in kinds and dims.Sp:
        meta["e_rope"] = _rope_for(
            cfg, torch.arange(dims.Te, device=xp.device), cfg.head_dim)
    if kinds & set(STATE_KINDS):
        if dims.Sp:
            cols = torch.arange(dims.C, device=xp.device)
            meta["p_mask"] = cols[None, :] < meta["p_chunk_lens"][:, None]
        if dims.Sd:
            meta["d_mask"] = (meta["d_valid"] > 0)[:, None]
    if cfg.is_moe:
        valid = []
        if dims.Sp:
            cols = torch.arange(xp.shape[1], device=xp.device)
            valid.append((cols[None, :] < (dims.Te + meta["p_chunk_lens"])
                          [:, None]).reshape(-1))
        if dims.Sd:
            valid.append(meta["d_valid"] > 0)
        meta["row_valid"] = torch.cat(valid)
    off = 0
    enc_snapshot = None
    for i, bs in enumerate(cfg.pattern):
        key = _block_key(i, bs)
        layers = {name: t[at].unbind(0)
                  for name, t in stage_params[key].items()}
        enc_h = None
        if bs.kind == BlockKind.ENC_LAYER:
            states = {}
        else:
            states = {name: t[at].unbind(0)
                      for name, t in caches[key].items()}
            if bs.kind == BlockKind.DEC_LAYER and dims.Sd:
                enc_h = enc_snapshot[meta["d_state_slots"]]
        for r in range(bs.repeat):
            if stage * cfg.layers_per_stage + off + r >= cfg.num_layers:
                continue
            pr = {name: views[r] for name, views in layers.items()}
            cr = {name: views[r] for name, views in states.items()}
            xp, xd, _ = block_apply_serve(cfg, bs.kind, pr, xp, xd, cr,
                                          meta, dims, enc_h, tp, ep, seq)
        off += bs.repeat
        if bs.kind == BlockKind.ENC_LAYER:
            enc_snapshot = caches[key]["h"][at]
            if dims.Sp:
                enc_snapshot[meta["p_write_slots"]] = xp[:, :dims.Te]
    return xp, xd, caches
