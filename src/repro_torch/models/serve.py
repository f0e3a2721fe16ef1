"""Serve-mode model execution (``repro.models.serve``): one pipeline stage's
forward over a micro-batch of prefill chunks and decode rows, with the paged
KV cache (ATTN_MLP and ATTN_MOE blocks) or per-sequence recurrent state
slots (RWKV, MAMBA_MLP and MAMBA_MOE blocks); one engine holds both for a
hybrid model (jamba).

Layouts (per stage, as in the JAX package):
  prefill payload  xp [Sp, C, d]
  decode payload   xd [Sd, 1, d]
  paged KV         [S, R, pages, page, 2, KH, hd] (S stages, R block repeat)
  RWKV state       tm_x, cm_x [S, R, slots, d]; wkv [S, R, slots, H, hd, hd]
  Mamba state      conv [S, R, slots, dc-1, di]; ssm [S, R, slots, di, ds]

The tick's metadata is built on the host as numpy (`zero_meta`, the JAX
field names and shapes) and reaches the device in one copy
(`meta_to_device`).  The KV pool is updated in place: each layer works on the
contiguous view ``cache[s, r]`` (the JAX version donates the buffer), and
so are the recurrent state slots.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, BlockKind
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import apply_norm, mlp_apply, rope_tables, rotate
from repro_torch.models.transformer import (
    MAMBA_KINDS,
    MOE_KINDS,
    _block_key,
    _check_kind,
    _heads,
)

ATTN_KINDS = (BlockKind.ATTN_MLP, BlockKind.ATTN_MOE)
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

    @property
    def prefill_width(self) -> int:
        return self.Te + self.C

    @property
    def rows(self) -> int:
        return self.Sp * self.prefill_width + self.Sd


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


def meta_to_device(meta: Mapping[str, np.ndarray], dims: ServeDims,
                   device: torch.device | str,
                   extra: Optional[Mapping[str, np.ndarray]] = None
                   ) -> Dict[str, torch.Tensor]:
    """Move one tick's metadata (plus `extra` int arrays, e.g. the fresh
    token ids) to `device` in a single non-blocking copy, as int32 views of
    one buffer.

    Adds, computed here on the host: ``p_rows``/``d_rows``, the flat
    indices of the rows that write KV (`attention.valid_rows`); for the
    recurrent state, ``p_live``/``d_live``, the live rows of each phase,
    and ``p_live_slots``/``d_live_slots``, their state slots (only these
    are written back: padding rows carry slot 0, which a live row may
    hold); and ``p_fresh``/``d_fresh``, 1 where a row's state starts from
    zero (a prefill chunk at position 0: a new request, or a recompute
    after preemption, on a slot another request may have left state in)."""
    fields = dict(meta)
    p_valid = np.arange(dims.C)[None, :] < meta["p_chunk_lens"][:, None]
    fields["p_rows"] = attn.valid_rows(p_valid, meta["p_slot_pages"],
                                       dims.pages)
    fields["d_rows"] = attn.valid_rows(meta["d_valid"] > 0,
                                       meta["d_slot_pages"], dims.pages)
    p_live = meta["p_chunk_lens"] > 0
    fields["p_live"] = np.flatnonzero(p_live)
    fields["p_live_slots"] = meta["p_state_slots"][p_live]
    fields["p_fresh"] = p_live & (meta["p_positions"][:, 0] == 0)
    d_live = meta["d_valid"] > 0
    fields["d_live"] = np.flatnonzero(d_live)
    fields["d_live_slots"] = meta["d_state_slots"][d_live]
    fields["d_fresh"] = np.zeros(dims.Sd, np.int32)
    fields.update(extra or {})
    arrays = [np.asarray(a, np.int32) for a in fields.values()]
    flat = host_to_device(
        torch.from_numpy(np.concatenate([a.reshape(-1) for a in arrays])),
        device)
    out, off = {}, 0
    for k, a in zip(fields, arrays):
        out[k] = flat[off:off + a.size].view(a.shape)
        off += a.size
    return out


# ----------------------------------------------------------------------------
# Cache construction
# ----------------------------------------------------------------------------

def block_cache_defs(cfg: ArchConfig, kind: BlockKind, dims: ServeDims,
                     repeat: int) -> Dict[str, Tuple[int, ...]]:
    """Shape per cache array of one block group (no stage dim)."""
    _check_kind(kind)
    R = repeat
    if kind == BlockKind.RWKV:
        H, hd = cfg.num_rwkv_heads, cfg.rwkv_head_dim
        return {"tm_x": (R, dims.slots, cfg.d_model),
                "cm_x": (R, dims.slots, cfg.d_model),
                "wkv": (R, dims.slots, H, hd, hd)}
    if kind in MAMBA_KINDS:
        di = cfg.mamba_d_inner
        return {"conv": (R, dims.slots, cfg.mamba_d_conv - 1, di),
                "ssm": (R, dims.slots, di, cfg.mamba_d_state)}
    return {"kv": (R, dims.pages, dims.page, 2, max(1, cfg.num_kv_heads),
                   cfg.head_dim)}


def cache_defs(cfg: ArchConfig, dims: ServeDims) -> Dict[str, Dict[str, tuple]]:
    """Cache tree of shapes with the leading stage dim (same leaf names as
    the JAX package)."""
    S = cfg.plan.pp
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


def _paged_self_attention(cfg: ArchConfig, p, xs: torch.Tensor,
                          cache: torch.Tensor, meta: Mapping[str, torch.Tensor],
                          is_prefill: bool) -> torch.Tensor:
    """Project, write pages (in place), attend.  Returns the attention
    output."""
    if is_prefill:
        positions = meta["p_positions"]
        tables, ctx = meta["p_block_tables"], meta["p_context_lens"]
        pages, offs = meta["p_slot_pages"], meta["p_slot_offsets"]
        rows, rope = meta["p_rows"], meta["p_rope"]
    else:
        positions = meta["d_positions"][:, None]
        tables, ctx = meta["d_block_tables"], meta["d_context_lens"]
        pages = meta["d_slot_pages"][:, None]
        offs = meta["d_slot_offsets"][:, None]
        rows, rope = meta["d_rows"], meta["d_rope"]

    q, k, v = _qkv_rows(cfg, p, xs, rope)
    new_kv = torch.stack([k, v], dim=2)                   # [S, T, 2, KH, hd]
    attn.write_kv_pages(cache, new_kv, pages, offs, rows)
    o = attn.paged_attention(q, cache, tables, ctx, positions)
    return o.reshape(o.shape[:-2] + (-1,)) @ p["wo"]


# ----------------------------------------------------------------------------
# Serve-mode RWKV
# ----------------------------------------------------------------------------

def _rwkv_serve(cfg: ArchConfig, p, xs: torch.Tensor,
                cache: Dict[str, torch.Tensor],
                meta: Mapping[str, torch.Tensor], phase: str) -> torch.Tensor:
    """One RWKV block over one phase's rows (`phase` "p" or "d"), from and
    back into the rows' state slots.  Fresh rows start from zero state
    whatever their slot holds; the WKV pool is advanced in place by the
    scan (live tokens only); the shift states are written back for the live
    rows only (`meta_to_device`).  Padding positions come out as zeros, as
    the JAX mask makes them."""
    slots, fresh = meta[f"{phase}_state_slots"], meta[f"{phase}_fresh"]
    lens = meta["p_chunk_lens"] if phase == "p" else meta["d_valid"]
    valid = meta[f"{phase}_mask"]
    zero = (fresh > 0)[:, None]
    state = ssm_lib.RWKVState(tm_x=cache["tm_x"][slots].masked_fill(zero, 0),
                              cm_x=cache["cm_x"][slots].masked_fill(zero, 0),
                              wkv=cache["wkv"], slots=slots, fresh=fresh)
    out, new = ssm_lib.rwkv_block(xs, p, head_dim=cfg.rwkv_head_dim,
                                  norm_eps=cfg.norm_eps, state=state,
                                  valid=valid, chunk_lens=lens)
    live, live_slots = meta[f"{phase}_live"], meta[f"{phase}_live_slots"]
    cache["tm_x"][live_slots] = new.tm_x[live]
    cache["cm_x"][live_slots] = new.cm_x[live]
    return out.masked_fill(~valid[..., None], 0)


def _mamba_serve(cfg: ArchConfig, p, xs: torch.Tensor,
                 cache: Dict[str, torch.Tensor],
                 meta: Mapping[str, torch.Tensor], phase: str) -> torch.Tensor:
    """One Mamba mixer over one phase's rows (`phase` "p" or "d"), from and
    back into the rows' state slots.  Fresh rows start from zero conv and
    scan state whatever their slot holds; the scan advances the `ssm` pool
    in place (live tokens only); the conv state is written back for the
    live rows only (`meta_to_device`).  Padding positions come out as
    zeros, as the JAX mask makes them."""
    slots, fresh = meta[f"{phase}_state_slots"], meta[f"{phase}_fresh"]
    lens = meta["p_chunk_lens"] if phase == "p" else meta["d_valid"]
    valid = meta[f"{phase}_mask"]
    conv = cache["conv"][slots].masked_fill((fresh > 0)[:, None, None], 0)
    state = ssm_lib.MambaState(conv=conv, ssm=cache["ssm"], slots=slots,
                               fresh=fresh)
    out, new_conv = ssm_lib.mamba_mixer(
        xs, p, d_state=cfg.mamba_d_state, d_conv=cfg.mamba_d_conv,
        state=state, chunk_lens=lens)
    live, live_slots = meta[f"{phase}_live"], meta[f"{phase}_live_slots"]
    cache["conv"][live_slots] = new_conv[live]
    return out.masked_fill(~valid[..., None], 0)


def block_apply_serve(cfg: ArchConfig, kind: BlockKind, p,
                      xp: torch.Tensor, xd: torch.Tensor,
                      cache: Dict[str, torch.Tensor],
                      meta: Mapping[str, torch.Tensor], dims: ServeDims):
    """One block over the stage's micro-batch: xp [Sp, C, d] prefill
    payload, xd [Sd, 1, d] decode rows.  Both phases run whenever their
    bucket is non-empty (`dims.Sp`/`dims.Sd`), whatever rows are live.  A
    recurrent block runs prefill first, and decode reads the state prefill
    left.
    The MoE FFN routes only the live rows (``meta["row_valid"]``, see
    `stage_forward_serve`): padding rows consume no expert capacity.
    Returns (xp, xd, cache); the cache is updated in place."""
    _check_kind(kind)
    if kind == BlockKind.RWKV:
        if dims.Sp:
            xp = _rwkv_serve(cfg, p, xp, cache, meta, "p")
        if dims.Sd:
            xd = _rwkv_serve(cfg, p, xd, cache, meta, "d")
        return xp, xd, cache

    def norm(name, h):
        keys = {"g": p[f"{name}_g"]}
        if f"{name}_b" in p:
            keys["b"] = p[f"{name}_b"]
        return apply_norm(h, keys, cfg.norm, cfg.norm_eps)

    Sp, Sd = dims.Sp, dims.Sd
    if kind in MAMBA_KINDS:
        if Sp:
            xp = xp + _mamba_serve(cfg, p, norm("ln1", xp), cache, meta, "p")
        if Sd:
            xd = xd + _mamba_serve(cfg, p, norm("ln1", xd), cache, meta, "d")
    else:
        if Sp:
            xp = xp + _paged_self_attention(cfg, p, norm("ln1", xp),
                                            cache["kv"], meta, True)
        if Sd:
            xd = xd + _paged_self_attention(cfg, p, norm("ln1", xd),
                                            cache["kv"], meta, False)

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
                                 row_valid=meta["row_valid"])
    else:
        y = mlp_apply(flat, p, cfg.act)
    n = Sp * xp.shape[1] if Sp else 0
    if Sp:
        xp = xp + y[:n].reshape(xp.shape)
    if Sd:
        xd = xd + y[n:].reshape(xd.shape)
    return xp, xd, cache


def stage_forward_serve(cfg: ArchConfig, stage_params, caches, xp, xd, meta,
                        dims: ServeDims, *, stage: int = 0):
    """Apply one stage's blocks to its micro-batch, a Python loop over the
    repeats.  `stage_params` leaves are ``[S, R, ...]``; layer ``(stage, r)``
    uses the views ``p[stage, r]`` and ``cache[stage, r]``, the latter
    updated in place.  Padded layers (global index >= num_layers) are the
    identity, as the JAX mask makes them.  Returns (xp, xd, caches).

    The loop runs eagerly, one launch per op, so per-tick work that every
    layer shares is done once here: the RoPE tables of both phases (added
    to `meta` as ``p_rope``/``d_rope``), the MoE blocks' live-row mask
    (``row_valid``: prefill rows inside their chunk, then live decode rows,
    in the order the FFN flattens them) and the per-layer views (one
    ``unbind`` per leaf).  Recurrent blocks (RWKV, Mamba) use no RoPE; they
    share each phase's [rows, T] live-position mask (``p_mask``/``d_mask``).
    The RoPE tables are built only when the pattern has an attention
    block."""
    head_dim, theta = cfg.head_dim, cfg.rope_theta
    meta = dict(meta)
    kinds = {bs.kind for bs in cfg.pattern}
    if kinds & set(ATTN_KINDS):
        if dims.Sp:
            meta["p_rope"] = rope_tables(meta["p_positions"], head_dim,
                                         theta)
        if dims.Sd:
            meta["d_rope"] = rope_tables(meta["d_positions"][:, None],
                                         head_dim, theta)
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
    for i, bs in enumerate(cfg.pattern):
        key = _block_key(i, bs)
        layers = {name: t[stage].unbind(0)
                  for name, t in stage_params[key].items()}
        states = {name: t[stage].unbind(0)
                  for name, t in caches[key].items()}
        for r in range(bs.repeat):
            if stage * cfg.layers_per_stage + off + r >= cfg.num_layers:
                continue
            pr = {name: views[r] for name, views in layers.items()}
            cr = {name: views[r] for name, views in states.items()}
            xp, xd, _ = block_apply_serve(cfg, bs.kind, pr, xp, xd, cr,
                                          meta, dims)
        off += bs.repeat
    return xp, xd, caches
