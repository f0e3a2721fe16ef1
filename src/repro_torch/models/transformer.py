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
built on it.  An encoder-decoder's blocks work on the two halves of one
payload, the encoder stream first (`enc_width` rows), as in the JAX
package.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, BlockKind, BlockSpec
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


def init_params(cfg: ArchConfig, seed: int = 0, *,
                dtype: Optional[torch.dtype] = None,
                device: torch.device | str = "cpu") -> TransformerParams:
    """Random weights from `seed`, drawn on `device` with an explicit
    ``torch.Generator`` (the JAX package's kinds: normal at 0.02,
    0.02/sqrt(2L) for residual projections, RWKV's mixing coefficients
    uniform in [0, 1) and decay base -1, Mamba's A_log = log(1..d_state)
    on every channel).  The draws differ from
    ``jax.random``; tests carry the JAX weights across with
    `repro_torch.models.convert.params_from_numpy` instead."""
    dtype = dtype or getattr(torch, cfg.dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def make(leaf: Leaf) -> torch.Tensor:
        shape, init = leaf
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=device)
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=device)
        if init == "mu":
            return torch.rand(shape, generator=gen, dtype=torch.float32,
                              device=device).to(dtype)
        if init == "decay":
            return torch.full(shape, -1.0, dtype=dtype, device=device)
        if init == "a_log":          # correctly rounded log(1..d_state)
            base = torch.log(torch.arange(1, shape[-1] + 1,
                                          dtype=torch.float64, device=device))
            return base.to(dtype).expand(shape).contiguous()
        scale = 0.02
        if init == "residual":
            scale = 0.02 / math.sqrt(max(1, 2 * cfg.num_layers))
        elif init != "normal":
            raise NotImplementedError(f"init {init!r} is not yet ported")
        if math.prod(shape) * 4 <= _F32_DRAW_BYTES:
            w = torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device)
            return w.mul_(scale).to(dtype)
        # a large leaf is drawn in slices over its leading dims, each in
        # f32 at most _F32_DRAW_BYTES (qwen2.5-32b's stacked w_gate is
        # 36 GB in f32 beside 66 GB of bf16 weights)
        k = next(i for i in range(len(shape))
                 if math.prod(shape[i:]) * 4 <= _F32_DRAW_BYTES)
        out = torch.empty(shape, dtype=dtype, device=device)
        for part in out.view((-1,) + tuple(shape[k:])):
            w = torch.randn(part.shape, generator=gen, dtype=torch.float32,
                            device=device)
            part.copy_(w.mul_(scale))
        return out

    def walk(tree):
        if isinstance(tree, tuple):
            return make(tree)
        return {k: walk(v) for k, v in tree.items()}

    return TransformerParams(walk(model_param_defs(cfg)))


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

def embed_apply(cfg: ArchConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"]["tok"][tokens]


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
                *, causal: bool = True, prefix: str = "") -> torch.Tensor:
    """x [B, T, d] -> self-attention output [B, T, d]."""
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
    return o.reshape(o.shape[:-2] + (-1,)) @ p[f"{prefix}wo"]


def _mla_train(cfg: ArchConfig, p, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """MLA over full sequences, with the latent expanded into per-head K
    and V as the JAX package's train path does."""
    B, T, _ = x.shape
    H = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    klr = cfg.kv_lora_rank
    cq = rmsnorm(x @ p["w_dq"], p["q_norm_g"], cfg.norm_eps)
    q = (cq @ p["w_uq"]).reshape(B, T, H, dn + dr)
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    ckv_full = x @ p["w_dkv"]                              # [B, T, klr + dr]
    ckv = rmsnorm(ckv_full[..., :klr], p["kv_norm_g"], cfg.norm_eps)
    k_rope = apply_rope(ckv_full[..., None, klr:], positions, cfg.rope_theta)
    kv = (ckv @ p["w_ukv"]).reshape(B, T, H, dn + dv)
    q = torch.cat([q[..., :dn], q_rope], dim=-1)
    k = torch.cat([kv[..., :dn], k_rope.expand(B, T, H, dr)], dim=-1)
    o = attn.causal_attention(q, k, kv[..., dn:])
    return o.reshape(B, T, H * dv) @ p["wo"]


def cross_kv(cfg: ArchConfig, p, enc: torch.Tensor):
    """The cross-attention's K and V from the encoder stream enc [B, Te,
    d]: [B, Te, KH, hd] each."""
    k, v = enc @ p["x_wk"], enc @ p["x_wv"]
    if "x_bk" in p:
        k, v = k + p["x_bk"], v + p["x_bv"]
    return (_heads(k, cfg.num_kv_heads, cfg.head_dim),
            _heads(v, cfg.num_kv_heads, cfg.head_dim))


def cross_attend(cfg: ArchConfig, p, h: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """The decoder's cross-attention: h [B, T, d] (normed) over the
    encoder's K and V (`cross_kv`), projected out: [B, T, d]."""
    q = h @ p["x_wq"]
    if "x_bq" in p:
        q = q + p["x_bq"]
    o = attn.cross_attention(_heads(q, cfg.num_heads, cfg.head_dim), k, v)
    return o.reshape(o.shape[:-2] + (-1,)) @ p["x_wo"]


def block_apply_train(cfg: ArchConfig, kind: BlockKind, p,
                      x: torch.Tensor, aux: torch.Tensor,
                      enc_width: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block over full sequences: x [B, T, d] -> (x, aux), the MoE
    load-balancing loss of an MoE block added to `aux` (f32 scalar), as in
    the JAX package.  Whisper's blocks work on the encoder half
    ``x[:, :enc_width]`` (ENC_LAYER: bidirectional self-attention) or the
    decoder half (DEC_LAYER: causal self-attention, then cross-attention to
    the encoder half as it stands), the other half passed through."""
    if kind == BlockKind.RWKV:
        x, _ = ssm_lib.rwkv_block(x, p, head_dim=cfg.rwkv_head_dim,
                                  norm_eps=cfg.norm_eps)
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
                                    causal=False)
            enc = enc + mlp_apply(norm("ln2", enc), p, cfg.act)
        else:
            dec = dec + _attn_train(cfg, p, norm("ln1", dec),
                                    positions[:dec.shape[1]])
            dec = dec + cross_attend(cfg, p, norm("ln3", dec),
                                     *cross_kv(cfg, p, enc))
            dec = dec + mlp_apply(norm("ln2", dec), p, cfg.act)
        return torch.cat([enc, dec], dim=1), aux

    if kind in MAMBA_KINDS:
        mix, _ = ssm_lib.mamba_mixer(norm("ln1", x), p,
                                     d_state=cfg.mamba_d_state,
                                     d_conv=cfg.mamba_d_conv)
    elif kind == BlockKind.MLA_MLP:
        mix = _mla_train(cfg, p, norm("ln1", x), positions)
    else:
        mix = _attn_train(cfg, p, norm("ln1", x), positions)
    x = x + mix
    h = norm("ln2", x)
    if kind in MOE_KINDS:
        y, a = moe_lib.moe_apply(h.reshape(-1, cfg.d_model), p,
                                 top_k=cfg.num_experts_per_tok,
                                 capacity_factor=cfg.moe_capacity_factor)
        return x + y.reshape(x.shape), aux + a
    return x + mlp_apply(h, p, cfg.act), aux


def stage_forward_train(cfg: ArchConfig, stage_params, x: torch.Tensor, *,
                        enc_width: int = 0,
                        stage: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pipeline stage `stage`'s layers over x [B, T, d] -> (x, aux).
    `stage_params` holds that stage's leaves, ``[R, ...]`` per block group
    (the JAX package's stage-local view).  A padded layer (global index >=
    ``num_layers``) is the identity and adds no aux.  Each layer is
    recomputed in backward (`torch.utils.checkpoint`, the JAX package's
    full ``jax.checkpoint``): only the layer inputs stay live."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    off = stage * cfg.layers_per_stage
    for i, bs in enumerate(cfg.pattern):
        p = stage_params[_block_key(i, bs)]
        fn = functools.partial(block_apply_train, cfg, bs.kind,
                               enc_width=enc_width)
        for r in range(bs.repeat):
            if off + r < cfg.num_layers:
                pl = {k: v[r] for k, v in p.items()}
                x, aux = checkpoint(fn, pl, x, aux, use_reentrant=False)
        off += bs.repeat
    return x, aux
