"""The stacked transformer (``repro.models.transformer``): every block kind
of the JAX package (ATTN_MLP, ATTN_MOE, MLA_MLP, RWKV, MAMBA_MLP,
MAMBA_MOE, and whisper's ENC_LAYER and DEC_LAYER).

Parameters are *stacked* as in the JAX package: every block leaf carries
leading dims ``[S, R, ...]`` (S = pipeline stages, R = the block's repeat
count inside a stage).  The tree is held as nested modules
(`TransformerParams`: ``nn.ModuleDict`` of ``nn.ParameterDict``) whose keys
are the JAX tree's keys, so ``params["stages"]["b0_attn_mlp"]["wq"]`` names
the same array in both packages and carrying weights across needs no
transposes (``x @ w``, ``w`` is ``[d_in, d_out]``).

Train mode (`block_apply_train`, `stage_forward_train`) runs full
sequences with a plain causal softmax; the dense reference
(`models/reference.py`) and the train step (`distributed/pipeline.py`) are
built on it, the train step with the RWKV and Mamba recurrences in their
differentiable train forms (`models/ssm.py`).  An encoder-decoder's
blocks work on the two halves of one payload, the encoder stream first
(`enc_width` rows), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import (
    ArchConfig,
    BlockKind,
    BlockSpec,
    ParallelPlan,
    RankConfig,
)
from repro_torch.distributed import collectives as coll
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (
    apply_mrope,
    apply_norm,
    apply_rope,
    mlp_apply,
    rmsnorm,
)

Leaf = Tuple[Tuple[int, ...], str]      # (shape, init kind)

MAMBA_KINDS = (BlockKind.MAMBA_MLP, BlockKind.MAMBA_MOE)
MOE_KINDS = (BlockKind.ATTN_MOE, BlockKind.MAMBA_MOE)
ENC_DEC_KINDS = (BlockKind.ENC_LAYER, BlockKind.DEC_LAYER)


def _norm_defs(cfg: ArchConfig, name: str) -> Dict[str, Leaf]:
    d = {f"{name}_g": ((cfg.d_model,), "ones")}
    if cfg.norm == "layernorm":
        d[f"{name}_b"] = ((cfg.d_model,), "zeros")
    return d


def _mlp_defs(cfg: ArchConfig) -> Dict[str, Leaf]:
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.act == "gelu":
        return {"w1": ((d, ff), "normal"), "b1": ((ff,), "zeros"),
                "w2": ((ff, d), "residual"), "b2": ((d,), "zeros")}
    return {"w_gate": ((d, ff), "normal"), "w_up": ((d, ff), "normal"),
            "w_down": ((ff, d), "residual")}


def _attn_defs(cfg: ArchConfig, prefix: str = "") -> Dict[str, Leaf]:
    d, q, kv = cfg.d_model, cfg.q_dim, cfg.kv_dim
    out: Dict[str, Leaf] = {
        f"{prefix}wq": ((d, q), "normal"), f"{prefix}wk": ((d, kv), "normal"),
        f"{prefix}wv": ((d, kv), "normal"),
        f"{prefix}wo": ((q, d), "residual"),
    }
    if cfg.qkv_bias:
        out[f"{prefix}bq"] = ((q,), "zeros")
        out[f"{prefix}bk"] = ((kv,), "zeros")
        out[f"{prefix}bv"] = ((kv,), "zeros")
    return out


def _mla_defs(cfg: ArchConfig) -> Dict[str, Leaf]:
    d, H = cfg.d_model, cfg.num_heads
    qlr, klr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "w_dq": ((d, qlr), "normal"),
        "q_norm_g": ((qlr,), "ones"),
        "w_uq": ((qlr, H * (dn + dr)), "normal"),
        "w_dkv": ((d, klr + dr), "normal"),
        "kv_norm_g": ((klr,), "ones"),
        "w_ukv": ((klr, H * (dn + dv)), "normal"),
        "wo": ((H * dv, d), "residual"),
    }


def _moe_defs(cfg: ArchConfig) -> Dict[str, Leaf]:
    d, ff, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    out: Dict[str, Leaf] = {
        "router": ((d, E), "normal"),
        "w_gate": ((E, d, ff), "normal"),
        "w_up": ((E, d, ff), "normal"),
        "w_down": ((E, ff, d), "residual"),
    }
    if cfg.num_shared_experts:
        ffs = ff * cfg.num_shared_experts
        out["s_gate"] = ((d, ffs), "normal")
        out["s_up"] = ((d, ffs), "normal")
        out["s_down"] = ((ffs, d), "residual")
    return out


def _mamba_defs(cfg: ArchConfig) -> Dict[str, Leaf]:
    d = cfg.d_model
    di, ds, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    dtr = max(8, d // 16)
    return {
        "in_proj": ((d, 2 * di), "normal"),
        "conv_w": ((dc, di), "normal"),
        "conv_b": ((di,), "zeros"),
        "x_proj": ((di, dtr + 2 * ds), "normal"),
        "dt_proj": ((dtr, di), "normal"),
        "dt_bias": ((di,), "zeros"),
        "A_log": ((di, ds), "a_log"),
        "D": ((di,), "ones"),
        "out_proj": ((di, d), "residual"),
    }


def _rwkv_defs(cfg: ArchConfig) -> Dict[str, Leaf]:
    d, ff = cfg.d_model, cfg.d_ff
    lora = 64
    return {
        "ln1_g": ((d,), "ones"), "ln1_b": ((d,), "zeros"),
        "ln2_g": ((d,), "ones"), "ln2_b": ((d,), "zeros"),
        "mu_r": ((d,), "mu"), "mu_k": ((d,), "mu"),
        "mu_v": ((d,), "mu"), "mu_g": ((d,), "mu"),
        "mu_w": ((d,), "mu"),
        "w_r": ((d, d), "normal"),
        "w_k": ((d, d), "normal"),
        "w_v": ((d, d), "normal"),
        "w_g": ((d, d), "normal"),
        "w_o": ((d, d), "residual"),
        "w0": ((d,), "decay"),
        "w_lora_a": ((d, lora), "normal"),
        "w_lora_b": ((lora, d), "zeros"),
        "u": ((d,), "mu"),
        "ln_x_g": ((d,), "ones"),
        "cm_mu_k": ((d,), "mu"), "cm_mu_r": ((d,), "mu"),
        "cm_k": ((d, ff), "normal"),
        "cm_v": ((ff, d), "residual"),
        "cm_r": ((d, d), "normal"),
    }


def block_param_defs(cfg: ArchConfig, kind: BlockKind) -> Dict[str, Leaf]:
    if kind == BlockKind.RWKV:
        return _rwkv_defs(cfg)
    defs: Dict[str, Leaf] = {}
    defs.update(_norm_defs(cfg, "ln1"))
    defs.update(_norm_defs(cfg, "ln2"))
    if kind in MAMBA_KINDS:
        defs.update(_mamba_defs(cfg))
    elif kind == BlockKind.MLA_MLP:
        defs.update(_mla_defs(cfg))
    else:
        defs.update(_attn_defs(cfg))
    if kind == BlockKind.DEC_LAYER:
        defs.update(_attn_defs(cfg, prefix="x_"))
        defs.update(_norm_defs(cfg, "ln3"))
    if kind in MOE_KINDS:
        defs.update(_moe_defs(cfg))
    else:
        defs.update(_mlp_defs(cfg))
    return defs


def _block_key(i: int, spec: BlockSpec) -> str:
    return f"b{i}_{spec.kind.value}"


def model_param_defs(cfg: ArchConfig) -> Dict[str, Dict[str, Any]]:
    """Full parameter tree of (shape, init) leaves, keyed as the JAX tree."""
    S = cfg.plan.pp
    stages = {
        _block_key(i, bs): {k: ((S, bs.repeat) + shape, init)
                            for k, (shape, init) in
                            block_param_defs(cfg, bs.kind).items()}
        for i, bs in enumerate(cfg.pattern)
    }
    V = cfg.padded_vocab
    tree: Dict[str, Dict[str, Any]] = {
        "embed": {"tok": ((V, cfg.d_model), "normal")},
        "stages": stages,
        "final_norm": {k.split("final_")[-1]: v
                       for k, v in _norm_defs(cfg, "final").items()},
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"w": ((cfg.d_model, V), "normal")}
    return tree


# ----------------------------------------------------------------------------
# Sharding: which dims of each leaf are split over which mesh axes
# ----------------------------------------------------------------------------

Spec = Tuple[Any, ...]    # per dim: None, an axis name, or a tuple of names

_COL, _ROW, _VEC = (None, "tensor"), ("tensor", None), ("tensor",)
# JAX's specs by leaf name (`repro.models.transformer`'s ``_*_defs``):
# column-parallel products split their output dim over `tensor`,
# row-parallel ones their input dim; norms, mixing coefficients, the MLA
# down-projections and the router are replicated
_LEAF_SPECS: Dict[str, Spec] = {
    **{k: _COL for k in ("wq", "wk", "wv", "w1", "w_gate", "w_up", "w_uq",
                         "w_ukv", "s_gate", "s_up", "in_proj", "conv_w",
                         "dt_proj", "w_r", "w_k", "w_v", "w_g", "cm_k")},
    **{k: _ROW for k in ("wo", "w2", "w_down", "s_down", "x_proj", "A_log",
                         "out_proj", "w_o", "cm_v")},
    **{k: _VEC for k in ("bq", "bk", "bv", "b1", "conv_b", "dt_bias", "D")},
}


def _leaf_spec(cfg: ArchConfig, kind: BlockKind, name: str) -> Spec:
    base = name[2:] if kind == BlockKind.DEC_LAYER and \
        name.startswith("x_") else name
    if kind in MOE_KINDS and base in ("w_gate", "w_up", "w_down"):
        ep = "data" if cfg.plan.ep_over_data else None
        return (ep,) + _LEAF_SPECS[base]
    return _LEAF_SPECS.get(base, ())


def param_pspecs(cfg: ArchConfig) -> Dict[str, Any]:
    """Each leaf's split, as JAX's ``param_pspecs``: a tuple with one entry
    per dim, None or the mesh axis (or tuple of axes, major first) that dim
    is split over.  Stage leaves ``[S, R, ...]`` split S over `stage`; the
    embedding splits d over `tensor`; the head splits the vocab over
    ``(stage, tensor)``; whatever a leaf's spec does not name, it is
    replicated over."""
    defs = model_param_defs(cfg)
    stages = {g: {k: ("stage", None) + _leaf_spec(cfg, bs.kind, k)
                  for k in defs["stages"][g]}
              for g, bs in zip(defs["stages"], cfg.pattern)}
    tree: Dict[str, Any] = {
        "embed": {"tok": (None, "tensor")},
        "stages": stages,
        "final_norm": {k: () for k in defs["final_norm"]},
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"w": (None, ("stage", "tensor"))}
    return tree


# Leaves whose split dim holds equal parts side by side, each part split
# over the dim's axes on its own: a rank holds its block of every part, the
# parts in order.  Mamba's fused in_proj [d, 2 di] is x then z, and the
# mixer cuts the product in halves, so the rank's [d, 2 di / tp] must be its
# x columns then its z columns, not a contiguous block of the fused dim.
# JAX's spec is the same column split (its GSPMD program computes the
# unsharded function whatever the layout); `shard_block` reads this for
# the rank's copy of a whole tree and `init_params` for the rank draw.
PAIRED_LEAVES: Dict[str, int] = {"in_proj": 2}


def leaf_parts(path: str) -> int:
    """The parts of the leaf at `path` (its name, or a ``/``-joined
    path): `PAIRED_LEAVES`, else 1."""
    return PAIRED_LEAVES.get(path.rsplit("/", 1)[-1], 1)


def _parts_dim(spec: Spec, ndim: int) -> int:
    """The dim a leaf's parts lie along: its last split dim."""
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    return max(i for i, e in enumerate(spec) if e is not None)


def parted(spec: Spec, shape: Tuple[int, ...], parts: int
           ) -> Tuple[Spec, Tuple[int, ...]]:
    """(spec, shape) with the parts' dim (`_parts_dim`) cut into
    ``(parts, n / parts)``, the new parts dim replicated: `shard_slices` of
    it takes the rank's block of each part.  Unchanged at one part."""
    if parts == 1:
        return spec, shape
    j = _parts_dim(spec, len(shape))
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    if shape[j] % parts:
        raise ValueError(f"dim {shape[j]} does not hold {parts} parts")
    return (spec[:j] + (None,) + spec[j:],
            shape[:j] + (parts, shape[j] // parts) + shape[j + 1:])


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """The mesh axes a spec splits over."""
    out = []
    for e in spec:
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None:
                out.append(a)
    return tuple(out)


def shard_slices(spec: Spec, shape: Tuple[int, ...], layout,
                 rank: int) -> Tuple[slice, ...]:
    """Rank `rank`'s block of a leaf of `shape` split by `spec` over
    `layout` (`launch.mesh.Layout`): a dim split over axes (a, b) has
    ``size(a) * size(b)`` blocks, block ``i_a * size(b) + i_b`` on the rank
    at ``(i_a, i_b)``.  Raises where a dim does not divide."""
    coords = layout.coords(rank)
    out = []
    for n, e in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        parts, i = 1, 0
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None:
                parts, i = parts * layout.size(a), i * layout.size(a) + \
                    coords.get(a, 0)
        if n % parts:
            raise ValueError(f"dim {n} does not split into {parts} over "
                             f"{e}")
        w = n // parts
        out.append(slice(i * w, (i + 1) * w))
    return tuple(out)


def shard_block(t: torch.Tensor, spec: Spec, layout, rank: int,
                parts: int = 1) -> torch.Tensor:
    """Rank `rank`'s block of the leaf `t` split by `spec` over `layout`:
    a view (`shard_slices`), or for a leaf of several parts
    (`PAIRED_LEAVES`) its block of each part side by side, a copy."""
    if parts == 1:
        return t[shard_slices(spec, tuple(t.shape), layout, rank)]
    vspec, vshape = parted(spec, tuple(t.shape), parts)
    j = _parts_dim(spec, t.dim())
    return t.view(vshape)[shard_slices(vspec, vshape, layout, rank)] \
        .flatten(j, j + 1)


def block_slices(spec: Spec, shape: Tuple[int, ...], layout, rank: int,
                 parts: int = 1
                 ) -> List[Tuple[Tuple[slice, ...], Tuple[slice, ...]]]:
    """Where rank `rank`'s block (`shard_block`) lies in the whole leaf:
    ``(whole slices, block slices)`` pairs, one per part of a leaf of
    several parts (`PAIRED_LEAVES`), one pair of the whole block else."""
    if parts == 1:
        return [(shard_slices(spec, shape, layout, rank),
                 (slice(None),) * len(shape))]
    vspec, vshape = parted(spec, shape, parts)
    j = _parts_dim(spec, len(shape))
    vsl = shard_slices(vspec, vshape, layout, rank)
    seg, own = shape[j] // parts, vsl[j + 1]
    w = own.stop - own.start
    out = []
    for p in range(parts):
        whole = vsl[:j] + (slice(p * seg + own.start, p * seg + own.stop),) \
            + vsl[j + 2:]
        block = [slice(None)] * len(shape)
        block[j] = slice(p * w, (p + 1) * w)
        out.append((whole, tuple(block)))
    return out


def check_shardable(cfg: ArchConfig, layout) -> None:
    """Raise unless `cfg` splits over `layout` (`launch.mesh.Layout`): its
    stage count, `shard_config`'s widths and expert counts (`ValueError`),
    and no tied head across ranks (not yet ported)."""
    tp = layout.size("tensor")
    if layout.size("stage") != cfg.plan.pp:
        raise ValueError(f"{cfg.name}: layout of {layout.size('stage')} "
                         f"stages, config of pp={cfg.plan.pp}")
    shard_config(cfg, tp, expert_parts(cfg, layout.size("data")))
    if cfg.tie_embeddings and layout.world > 1:
        raise NotImplementedError(
            f"{cfg.name}: a tied head across ranks is not yet ported "
            f"(ROADMAP Queue 1 item 6)")


def expert_parts(cfg: ArchConfig, dp: int) -> int:
    """The ranks `cfg`'s experts are split over at `dp` data replicas: dp
    for an MoE model whose plan sets ``ep_over_data`` (expert parallelism,
    the expert leaves' ``data`` split in `param_pspecs`), else 1."""
    return dp if cfg.plan.ep_over_data and cfg.is_moe else 1


def shard_config(cfg: ArchConfig, tp: int, ep: int = 1) -> RankConfig:
    """The widths one tensor rank of one stage computes at (a
    `RankConfig`): heads, KV heads, d_ff, the experts' and the shared
    experts' ff, Mamba's d_inner and RWKV's heads over `tp`; d_model
    whole; the experts over `ep` ranks (`expert_parts`: `local_experts`
    a rank, the router's `num_experts` whole); one stage (its caches and
    carry have one stage slot).  Raises `ValueError` where a width or the
    expert count does not divide."""
    kinds = {bs.kind for bs in cfg.pattern}
    widths = [("num_heads", cfg.num_heads),
              ("num_kv_heads", cfg.num_kv_heads), ("d_ff", cfg.d_ff)]
    if kinds & set(MOE_KINDS):
        widths.append(("moe_d_ff", cfg.moe_d_ff))
    if kinds & set(MAMBA_KINDS):
        widths.append(("mamba_d_inner", cfg.mamba_d_inner))
    if BlockKind.RWKV in kinds:
        widths.append(("num_rwkv_heads", cfg.num_rwkv_heads))
    for what, n in widths:
        if n % tp:
            raise ValueError(f"{cfg.name}: {what}={n} does not split over "
                             f"tp={tp}")
    if ep > 1 and cfg.num_experts % ep:
        raise ValueError(f"{cfg.name}: num_experts={cfg.num_experts} does "
                         f"not split over dp={ep}")
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields.update(num_heads=cfg.num_heads // tp,
                  num_kv_heads=cfg.num_kv_heads // tp, d_ff=cfg.d_ff // tp,
                  moe_d_ff=cfg.moe_d_ff // tp, plan=ParallelPlan(pp=1, tp=1),
                  tensor_parts=tp, expert_parts=ep)
    return RankConfig(**fields)


def shard_views(tree, cfg: ArchConfig, layout, rank: int
                ) -> "TransformerParams":
    """Rank `rank`'s block (`shard_slices` of `param_pspecs`) of every leaf
    of `tree` (`cfg`'s whole tree, a `TransformerParams` or nested dict of
    tensors, at `layout`'s stage count), as views of the same storage: the
    stage's weights at its tensor shard; a leaf of several parts
    (`PAIRED_LEAVES`) is a copy."""
    def walk(t, s, name=""):
        if not is_node(t):
            return shard_block(t.detach(), s, layout, rank, leaf_parts(name))
        return {k: walk(t[k], s[k], k) for k in t.keys()}

    return TransformerParams(walk(tree, param_pspecs(cfg)))


def shard_params(cfg: ArchConfig, tree, layout, rank: int, *,
                 device: torch.device | str = "cpu") -> "TransformerParams":
    """`shard_views` of the full tree `tree`, as contiguous copies on
    `device`."""
    check_shardable(cfg, layout)
    return TransformerParams(tree_map(
        lambda t: t.to(device).contiguous(),
        shard_views(tree, cfg, layout, rank)))


class TransformerParams(nn.ModuleDict):
    """The parameter tree as modules: a dict of tensors becomes an
    ``nn.ParameterDict``, a dict of dicts an ``nn.ModuleDict``.  Parameters
    do not require gradients: engines serve from a frozen tree, and the
    train step takes a `trainable` copy."""

    def __init__(self, tree: Mapping[str, Any]) -> None:
        super().__init__({k: _as_module(v) for k, v in tree.items()})

    def trainable(self) -> "TransformerParams":
        """A copy whose every leaf requires grad (new storage: an engine
        serving from this tree keeps its weights while the copy trains)."""
        return TransformerParams(tree_map(
            lambda t: t.detach().clone().requires_grad_(True), self))


def _as_module(tree: Mapping[str, Any]) -> nn.Module:
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v, requires_grad=v.requires_grad)
                                 for k, v in tree.items()})
    return nn.ModuleDict({k: _as_module(v) for k, v in tree.items()})


def is_node(x: Any) -> bool:
    return isinstance(x, (Mapping, nn.ModuleDict, nn.ParameterDict))


def tree_items(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of a nested mapping (dicts, `TransformerParams`), keys
    sorted and the path ``/``-joined: the order and the names of
    ``jax.tree_util.tree_flatten_with_path`` on the JAX tree."""
    for k in sorted(tree.keys()):
        path = f"{prefix}/{k}" if prefix else k
        if is_node(tree[k]):
            yield from tree_items(tree[k], path)
        else:
            yield path, tree[k]


def tree_map(fn, tree, *rest) -> Dict[str, Any]:
    """`fn` over the leaves of `tree` (and the same leaves of `rest`), as
    nested dicts."""
    return {k: (tree_map(fn, v, *(r[k] for r in rest)) if is_node(v)
                else fn(v, *(r[k] for r in rest)))
            for k, v in tree.items()}


# the largest float32 draw `init_params` makes at once
_F32_DRAW_BYTES = 1 << 30


def _draw(cfg: ArchConfig, leaf: Leaf, gen: torch.Generator,
          dtype: torch.dtype, device, idx: Optional[Tuple[slice, ...]]
          ) -> torch.Tensor:
    """Block `idx` (all of it when None) of the leaf `init_params` draws
    next from `gen`: the same draws in the same order whatever the block,
    so that every rank's block is the slice of the one-process leaf.  A
    leaf of several parts comes with its parted shape (`parted`): the same
    draws, in the same memory order."""
    shape, init = leaf
    idx = idx or tuple(slice(0, n) for n in shape)
    out_shape = tuple(s.stop - s.start for s in idx)
    if init == "zeros":
        return torch.zeros(out_shape, dtype=dtype, device=device)
    if init == "ones":
        return torch.ones(out_shape, dtype=dtype, device=device)
    if init == "mu":
        return torch.rand(shape, generator=gen, dtype=torch.float32,
                          device=device)[idx].to(dtype).contiguous()
    if init == "decay":
        return torch.full(out_shape, -1.0, dtype=dtype, device=device)
    if init == "a_log":              # correctly rounded log(1..d_state)
        base = torch.log(torch.arange(1, shape[-1] + 1,
                                      dtype=torch.float64, device=device))
        return base.to(dtype).expand(shape)[idx].contiguous()
    scale = 0.02
    if init == "residual":
        scale = 0.02 / math.sqrt(max(1, 2 * cfg.num_layers))
    elif init != "normal":
        raise NotImplementedError(f"init {init!r} is not yet ported")
    if math.prod(shape) * 4 <= _F32_DRAW_BYTES:
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return w[idx].mul_(scale).to(dtype).contiguous()
    # a large leaf is drawn in parts, each in f32 at most _F32_DRAW_BYTES
    # (qwen2.5-32b's stacked w_gate is 36 GB in f32 beside 66 GB of bf16
    # weights): for each index of its leading dims, runs of `step` rows of
    # dim k; a block keeps its part of each
    k = next(i for i in range(len(shape))
             if math.prod(shape[i + 1:]) * 4 <= _F32_DRAW_BYTES)
    inner = tuple(shape[k + 1:])
    step = max(1, _F32_DRAW_BYTES // (math.prod(inner) * 4))
    out = torch.empty(out_shape, dtype=dtype, device=device)
    for lead in itertools.product(*(range(n) for n in shape[:k])):
        keep = all(s.start <= i < s.stop for i, s in zip(lead, idx))
        at = tuple(i - s.start for i, s in zip(lead, idx))
        for lo in range(0, shape[k], step):
            hi = min(lo + step, shape[k])
            w = torch.randn((hi - lo,) + inner, generator=gen,
                            dtype=torch.float32, device=device)
            a, b = max(lo, idx[k].start), min(hi, idx[k].stop)
            if keep and a < b:
                rows = slice(a - idx[k].start, b - idx[k].start)
                out[at + (rows,)].copy_(
                    w[(slice(a - lo, b - lo),) + idx[k + 1:]].mul_(scale))
    return out


def init_params(cfg: ArchConfig, seed: int = 0, *,
                dtype: Optional[torch.dtype] = None,
                device: torch.device | str = "cpu",
                layout=None, rank: int = 0) -> TransformerParams:
    """Random weights from `seed`, drawn on `device` with an explicit
    ``torch.Generator`` (the JAX package's kinds: normal at 0.02,
    0.02/sqrt(2L) for residual projections, RWKV's mixing coefficients
    uniform in [0, 1) and decay base -1, Mamba's A_log = log(1..d_state)
    on every channel).  The draws differ from
    ``jax.random``; tests carry the JAX weights across with
    `repro_torch.models.convert.params_from_numpy` instead.

    With a `layout` (`launch.mesh.Layout`), rank `rank`'s shard only
    (`shard_params` of the whole tree, which is never built): every leaf
    is drawn as the whole tree draws it, a large one in parts, and only
    the rank's block of each is kept (of a leaf of several parts,
    `PAIRED_LEAVES`, its block of each part)."""
    dtype = dtype or getattr(torch, cfg.dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if layout is not None:
        check_shardable(cfg, layout)

    def walk(tree, spec, name=""):
        if isinstance(tree, tuple):
            vspec, vshape = parted(spec, tree[0], leaf_parts(name))
            idx = None if layout is None else shard_slices(
                vspec, vshape, layout, rank)
            out = _draw(cfg, (vshape, tree[1]), gen, dtype, device, idx)
            if vshape != tree[0]:
                j = _parts_dim(spec, len(tree[0]))
                out = out.flatten(j, j + 1)
            return out
        return {k: walk(v, spec[k], k) for k, v in tree.items()}

    return TransformerParams(walk(model_param_defs(cfg), param_pspecs(cfg)))


def abstract_params(cfg: ArchConfig, dtype: Optional[torch.dtype] = None
                    ) -> TransformerParams:
    """`cfg`'s parameter tree of shapes only (meta tensors): the target a
    checkpoint restores into."""
    dtype = dtype or getattr(torch, cfg.dtype)

    def walk(tree):
        if isinstance(tree, tuple):
            return torch.empty(tree[0], dtype=dtype, device="meta")
        return {k: walk(v) for k, v in tree.items()}

    return TransformerParams(walk(model_param_defs(cfg)))


# ----------------------------------------------------------------------------
# Embedding / head
# ----------------------------------------------------------------------------

def embed_apply(cfg: ArchConfig, params, tokens: torch.Tensor,
                tp=None) -> torch.Tensor:
    """Token embeddings; a tensor rank holds d / tp of the width, and the
    tensor group gathers the rest (`collectives.gather_from_tensor`)."""
    return coll.gather_from_tensor(params["embed"]["tok"][tokens], tp)


def head_apply(cfg: ArchConfig, params, h: torch.Tensor) -> torch.Tensor:
    fn = params["final_norm"]
    h = apply_norm(h, fn, "layernorm" if "b" in fn else "rmsnorm",
                   cfg.norm_eps)
    w = params["embed"]["tok"].T if cfg.tie_embeddings \
        else params["lm_head"]["w"]
    return h @ w


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy in f32 (over `mask`'s ones when
    given), as the JAX package's `cross_entropy`."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


# ----------------------------------------------------------------------------
# Train-mode block application
# ----------------------------------------------------------------------------

def _heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, hd))


def _rope(cfg: ArchConfig, x: torch.Tensor,
          positions: torch.Tensor) -> torch.Tensor:
    """RoPE, or M-RoPE with the three position streams equal (text)."""
    if cfg.mrope:
        pos3 = positions.expand((3,) + tuple(positions.shape))
        return apply_mrope(x, pos3, cfg.mrope_sections, cfg.rope_theta)
    return apply_rope(x, positions, cfg.rope_theta)


def _attn_train(cfg: ArchConfig, p, x: torch.Tensor, positions: torch.Tensor,
                *, causal: bool = True, prefix: str = "",
                tp=None) -> torch.Tensor:
    """x [B, T, d] -> self-attention output [B, T, d].  At tensor rank
    `tp` the heads are the rank's (`cfg` at local widths, `shard_config`)
    and the out-projection's partial sums are reduced over the group."""
    x = coll.copy_to_tensor(x, tp)
    q = x @ p[f"{prefix}wq"]
    k = x @ p[f"{prefix}wk"]
    v = x @ p[f"{prefix}wv"]
    if cfg.qkv_bias and f"{prefix}bq" in p:
        q = q + p[f"{prefix}bq"]
        k = k + p[f"{prefix}bk"]
        v = v + p[f"{prefix}bv"]
    q = _rope(cfg, _heads(q, cfg.num_heads, cfg.head_dim), positions)
    k = _rope(cfg, _heads(k, cfg.num_kv_heads, cfg.head_dim), positions)
    v = _heads(v, cfg.num_kv_heads, cfg.head_dim)
    o = attn.causal_attention(q, k, v, causal=causal)
    return coll.reduce_from_tensor(
        o.reshape(o.shape[:-2] + (-1,)) @ p[f"{prefix}wo"], tp)


def _mla_train(cfg: ArchConfig, p, x: torch.Tensor,
               positions: torch.Tensor, tp=None) -> torch.Tensor:
    """MLA over full sequences, with the latent expanded into per-head K
    and V as the JAX package's train path does.  At tensor rank `tp` the
    down-projections and norms are replicated and the heads the rank's:
    the latent, the query's latent and the shared rope key enter the
    rank's columns (`copy_to_tensor` on each, not on x, which also feeds
    the replicated work), and the out-projection's partial sums are
    reduced over the group."""
    B, T, _ = x.shape
    H = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    klr = cfg.kv_lora_rank
    cq = rmsnorm(x @ p["w_dq"], p["q_norm_g"], cfg.norm_eps)
    q = (coll.copy_to_tensor(cq, tp) @ p["w_uq"]).reshape(B, T, H, dn + dr)
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    ckv_full = x @ p["w_dkv"]                              # [B, T, klr + dr]
    ckv = rmsnorm(ckv_full[..., :klr], p["kv_norm_g"], cfg.norm_eps)
    k_rope = coll.copy_to_tensor(apply_rope(
        ckv_full[..., None, klr:], positions, cfg.rope_theta), tp)
    kv = (coll.copy_to_tensor(ckv, tp) @ p["w_ukv"]).reshape(B, T, H,
                                                             dn + dv)
    q = torch.cat([q[..., :dn], q_rope], dim=-1)
    k = torch.cat([kv[..., :dn], k_rope.expand(B, T, H, dr)], dim=-1)
    o = attn.causal_attention(q, k, kv[..., dn:])
    return coll.reduce_from_tensor(o.reshape(B, T, H * dv) @ p["wo"], tp)


def cross_kv(cfg: ArchConfig, p, enc: torch.Tensor):
    """The cross-attention's K and V from the encoder stream enc [B, Te,
    d]: [B, Te, KH, hd] each (at a tensor rank, its KV heads: the caller
    passes the encoder stream through `copy_to_tensor`)."""
    k, v = enc @ p["x_wk"], enc @ p["x_wv"]
    if "x_bk" in p:
        k, v = k + p["x_bk"], v + p["x_bv"]
    return (_heads(k, cfg.num_kv_heads, cfg.head_dim),
            _heads(v, cfg.num_kv_heads, cfg.head_dim))


def cross_attend(cfg: ArchConfig, p, h: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, tp=None) -> torch.Tensor:
    """The decoder's cross-attention: h [B, T, d] (normed) over the
    encoder's K and V (`cross_kv`), projected out: [B, T, d].  At tensor
    rank `tp` (the heads the rank's), the rank's partial sum of it."""
    q = coll.copy_to_tensor(h, tp) @ p["x_wq"]
    if "x_bq" in p:
        q = q + p["x_bq"]
    o = attn.cross_attention(_heads(q, cfg.num_heads, cfg.head_dim), k, v)
    return o.reshape(o.shape[:-2] + (-1,)) @ p["x_wo"]


def block_apply_train(cfg: ArchConfig, kind: BlockKind, p,
                      x: torch.Tensor, aux: torch.Tensor,
                      enc_width: int = 0, *, train_forms: bool = False,
                      tp=None, ep=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block over full sequences: x [B, T, d] -> (x, aux), the MoE
    load-balancing loss of an MoE block added to `aux` (f32 scalar), as in
    the JAX package.  Whisper's blocks work on the encoder half
    ``x[:, :enc_width]`` (ENC_LAYER: bidirectional self-attention) or the
    decoder half (DEC_LAYER: causal self-attention, then cross-attention to
    the encoder half as it stands), the other half passed through.  RWKV
    and Mamba blocks run their recurrences through the differentiable
    train forms with `train_forms` (the train step), else through the
    serve scans from a zero state (the dense reference: the Hopper kernels
    on the card, which have no backward).  `tp` (a `launch.mesh.AxisGroup`
    of more than one rank) runs the block tensor-parallel at the widths of
    `cfg` (`shard_config`): each column-parallel product's input passes
    through `copy_to_tensor` (only a tensor that feeds nothing
    replicated), each row-parallel product's partial sums are reduced over
    the group, and a replicated leaf that acts on the rank's channels is
    sliced through `collectives.slice_for_tensor`, so that every replica
    of every leaf ends the backward with its whole gradient.  `ep` (the
    rank's data group, `moe.moe_apply`'s) runs an MoE block's experts
    split over it: `p` holds the rank's block of them."""
    if kind == BlockKind.RWKV:
        x, _ = ssm_lib.rwkv_block(x, p, head_dim=cfg.rwkv_head_dim,
                                  norm_eps=cfg.norm_eps, train=train_forms,
                                  tp=tp)
        return x, aux

    def norm(name, h):
        keys = {"g": p[f"{name}_g"]}
        if f"{name}_b" in p:
            keys["b"] = p[f"{name}_b"]
        return apply_norm(h, keys, cfg.norm, cfg.norm_eps)

    positions = torch.arange(x.shape[1], device=x.device)
    if kind in ENC_DEC_KINDS:
        Te = enc_width
        enc, dec = x[:, :Te], x[:, Te:]
        if kind == BlockKind.ENC_LAYER:
            enc = enc + _attn_train(cfg, p, norm("ln1", enc), positions[:Te],
                                    causal=False, tp=tp)
            enc = enc + mlp_apply(norm("ln2", enc), p, cfg.act, tp)
        else:
            dec = dec + _attn_train(cfg, p, norm("ln1", dec),
                                    positions[:dec.shape[1]], tp=tp)
            # the encoder half enters the rank's KV heads; as it stands it
            # also passes through the block, replicated
            kv = cross_kv(cfg, p, coll.copy_to_tensor(enc, tp))
            dec = dec + coll.reduce_from_tensor(
                cross_attend(cfg, p, norm("ln3", dec), *kv, tp=tp), tp)
            dec = dec + mlp_apply(norm("ln2", dec), p, cfg.act, tp)
        return torch.cat([enc, dec], dim=1), aux

    if kind in MAMBA_KINDS:
        mix, _ = ssm_lib.mamba_mixer(norm("ln1", x), p,
                                     d_state=cfg.mamba_d_state,
                                     d_conv=cfg.mamba_d_conv,
                                     train=train_forms, tp=tp)
        mix = coll.reduce_from_tensor(mix, tp)
    elif kind == BlockKind.MLA_MLP:
        mix = _mla_train(cfg, p, norm("ln1", x), positions, tp)
    else:
        mix = _attn_train(cfg, p, norm("ln1", x), positions, tp=tp)
    x = x + mix
    h = norm("ln2", x)
    if kind in MOE_KINDS:
        y, a = moe_lib.moe_apply(h.reshape(-1, cfg.d_model), p,
                                 top_k=cfg.num_experts_per_tok,
                                 capacity_factor=cfg.moe_capacity_factor,
                                 tp=tp, ep=ep)
        return x + y.reshape(x.shape), aux + a
    return x + mlp_apply(h, p, cfg.act, tp), aux


_WEIGHT_GEMMS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
REMAT_POLICIES = ("full", "dots")


def _save_weight_gemms(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep
    the outputs of matrix products with no batch dimension (the weight
    GEMMs, ``mm`` / ``addmm``), recompute the rest (the batched attention
    products among them)."""
    return (CheckpointPolicy.MUST_SAVE if op in _WEIGHT_GEMMS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_save_weight_gemms)


def stage_forward_train(cfg: ArchConfig, stage_params, x: torch.Tensor, *,
                        enc_width: int = 0, stage: int = 0,
                        tp=None, ep=None, remat: str = "full"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pipeline stage `stage`'s layers over x [B, T, d] -> (x, aux).
    `stage_params` holds that stage's leaves, ``[R, ...]`` per block group
    (the JAX package's stage-local view).  A padded layer (global index >=
    ``num_layers``) is the identity and adds no aux.  RWKV and Mamba
    blocks run the train forms.  Each layer is recomputed in backward
    (`torch.utils.checkpoint`): with ``remat="full"`` (the JAX package's
    plain ``jax.checkpoint``) only the layer inputs stay live; with
    ``"dots"`` (its ``REPRO_REMAT_POLICY=dots``, an argument here) the
    weight GEMMs' outputs are saved too and only the rest is recomputed
    (`_save_weight_gemms`).  `tp`, `ep`: as `block_apply_train`."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat {remat!r}: one of {REMAT_POLICIES}")
    kw = {"context_fn": _dots_context} if remat == "dots" else {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    off = stage * cfg.layers_per_stage
    for i, bs in enumerate(cfg.pattern):
        p = stage_params[_block_key(i, bs)]
        fn = functools.partial(block_apply_train, cfg, bs.kind,
                               enc_width=enc_width, train_forms=True, tp=tp,
                               ep=ep)
        for r in range(bs.repeat):
            if off + r < cfg.num_layers:
                pl = {k: v[r] for k, v in p.items()}
                x, aux = checkpoint(fn, pl, x, aux, use_reentrant=False,
                                    **kw)
        off += bs.repeat
    return x, aux
