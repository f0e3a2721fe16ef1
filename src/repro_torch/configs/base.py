"""Architecture + shape + parallelism configuration.

A copy of ``repro.configs.base`` (the port imports nothing of the JAX
package), plus the port's one-card helpers: `single_stage`, which folds the
pipeline into one stage so a whole model runs on one card, `stage_config`,
which stages it again at pp = S on that card, and `cut_to_kinds`, a depth
cut for a model whose weights do not fit one card.

Every assigned architecture gets one module in ``repro_torch/configs`` exporting
``CONFIG: ArchConfig``.  A stage's layer structure is a *stage-local pattern*
(list of ``BlockSpec``), identical on every pipeline stage — the SPMD pipeline
requires a uniform per-stage program; heterogeneity (jamba's mamba/attn
interleave, whisper's enc/dec split) is expressed inside the pattern.
DESIGN.md §3 records where this shifts a published layer order.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass
from typing import Dict, List, Tuple


class BlockKind(enum.Enum):
    ATTN_MLP = "attn_mlp"        # self-attention + dense MLP
    ATTN_MOE = "attn_moe"        # self-attention + MoE FFN
    MLA_MLP = "mla_mlp"          # multi-head latent attention + dense MLP
    MAMBA_MLP = "mamba_mlp"      # mamba mixer + dense MLP
    MAMBA_MOE = "mamba_moe"      # mamba mixer + MoE FFN
    RWKV = "rwkv"                # rwkv6 time-mix + channel-mix
    ENC_LAYER = "enc_layer"      # bidirectional self-attn + MLP (whisper enc)
    DEC_LAYER = "dec_layer"      # causal self-attn + cross-attn + MLP


@dataclass(frozen=True)
class BlockSpec:
    kind: BlockKind
    repeat: int                  # stacked (scanned) repetitions per stage


@dataclass(frozen=True)
class ParallelPlan:
    """How the production mesh maps onto this architecture.

    ``pp * tp`` must equal the `model` axis size (16).  ``ep_over_data`` turns
    on expert-parallelism over the `data` axis (kimi, jamba); otherwise MoE
    experts are replicated over `data` and sharded over `tensor` only.
    """

    pp: int                      # pipeline stages (paper's #PP_depth)
    tp: int                      # tensor-parallel degree inside a stage
    ep_over_data: bool = False
    # long-context decode: shard the KV sequence over `data` (flash-decode
    # partial-softmax merge).  Only used by the long_500k shape.
    seq_shard_kv: bool = False


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | vlm | audio | hybrid | ssm
    num_layers: int              # published layer count (pre-padding)
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # stage-local structure; len == layers per stage after padding
    pattern: Tuple[BlockSpec, ...] = ()
    plan: ParallelPlan = ParallelPlan(pp=4, tp=4)

    # attention details
    qkv_bias: bool = False
    rope_theta: float = 1e6
    mrope: bool = False                     # qwen2-vl 3-axis M-RoPE
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    causal: bool = True

    # MLA (minicpm3)
    mla: bool = False
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_head_dim: int = 64

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0                       # per-expert hidden dim
    num_shared_experts: int = 0
    moe_capacity_factor: float = 1.25

    # SSM (mamba / rwkv6)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    rwkv_head_dim: int = 64

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False

    # misc
    norm: str = "rmsnorm"                   # rmsnorm | layernorm
    act: str = "silu"                       # silu | gelu
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    # which assigned shapes apply (DESIGN.md §3)
    supports_long_context: bool = False     # run long_500k?

    # ------------------------------------------------------------------ derived
    @property
    def layers_per_stage(self) -> int:
        return sum(b.repeat for b in self.pattern)

    @property
    def padded_layers(self) -> int:
        return self.layers_per_stage * self.plan.pp

    @property
    def layer_padding(self) -> int:
        return self.padded_layers - self.num_layers

    @property
    def padded_vocab(self) -> int:
        """Vocab padded so the lm_head shards evenly over stage x tensor
        (e.g. whisper 51865 -> 51872).  Token ids never reach the pad rows."""
        m = max(16, self.plan.pp * self.plan.tp)
        return (self.vocab_size + m - 1) // m * m

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def kv_cache_dim_per_token(self) -> int:
        """KV bytes-per-token driver (per attention layer), in elements."""
        if self.mla:
            return self.kv_lora_rank + self.qk_rope_dim
        return 2 * self.num_kv_heads * self.head_dim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def num_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def with_plan(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, plan=dataclasses.replace(self.plan, **kw))

    def params_per_layer_estimate(self) -> Dict[str, float]:
        """Rough analytic parameter counts (used by roofline MODEL_FLOPS)."""
        d = self.d_model
        counts: Dict[str, float] = {}
        counts["attn"] = d * self.q_dim + self.q_dim * d + 2 * d * self.kv_dim
        if self.mla:
            counts["attn"] = (
                d * self.q_lora_rank
                + self.q_lora_rank * self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
                + d * (self.kv_lora_rank + self.qk_rope_dim)
                + self.kv_lora_rank * self.num_heads * (self.qk_nope_dim + self.v_head_dim)
                + self.num_heads * self.v_head_dim * d
            )
        counts["mlp"] = 3 * d * self.d_ff
        if self.is_moe:
            counts["moe"] = 3 * d * self.moe_d_ff * self.num_experts
            counts["moe_active"] = 3 * d * self.moe_d_ff * (
                self.num_experts_per_tok + self.num_shared_experts
            ) + d * self.num_experts
        counts["mamba"] = (
            2 * d * self.mamba_d_inner                      # in_proj (x, gate)
            + self.mamba_d_inner * self.mamba_d_conv        # conv
            + self.mamba_d_inner * (self.mamba_d_state * 2 + 1 + self.mamba_d_state)
            + self.mamba_d_inner * d                        # out_proj
        )
        counts["rwkv"] = 4 * d * d + d * d + 2 * d * self.d_ff  # tm(r,k,v,o,g) + cm
        return counts


@dataclass(frozen=True)
class RankConfig(ArchConfig):
    """`cfg` at the widths one tensor rank of one stage computes at
    (`models.transformer.shard_config`): the head counts and FFN widths
    already divided over the ranks, and `tensor_parts`, the ranks the widths
    derived from the whole ``d_model`` are divided over (Mamba's d_inner,
    RWKV's heads), since ``d_model`` itself, the residual stream's width,
    stays whole on every rank; and `expert_parts`, the data ranks the
    experts are split over (`num_experts` stays whole: the router's
    width)."""

    tensor_parts: int = 1
    expert_parts: int = 1

    @property
    def local_experts(self) -> int:
        """The experts a rank holds: `num_experts` over the data ranks they
        are split over (expert parallelism)."""
        return self.num_experts // self.expert_parts

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model // self.tensor_parts

    @property
    def num_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim // self.tensor_parts


@dataclass(frozen=True)
class ShapeSpec:
    """An assigned input shape: a cell's sequence length, global batch
    and kind (the JAX package's ``ShapeSpec``)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


ASSIGNED_SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig) -> List[ShapeSpec]:
    """The assigned shape cells that run for this arch."""
    out = [ASSIGNED_SHAPES["train_4k"], ASSIGNED_SHAPES["prefill_32k"],
           ASSIGNED_SHAPES["decode_32k"]]
    if cfg.supports_long_context:
        out.append(ASSIGNED_SHAPES["long_500k"])
    return out


def make_reduced(cfg: ArchConfig, *, d_model: int = 64, d_ff: int = 128,
                 vocab: int = 256) -> ArchConfig:
    """A tiny same-family variant for CPU smoke tests (one block per kind)."""
    head_dim = 16
    heads = max(2, d_model // head_dim)
    kv_heads = min(cfg.num_kv_heads, heads) or heads
    while heads % kv_heads:
        kv_heads -= 1
    pattern = tuple(BlockSpec(b.kind, 1) for b in cfg.pattern)
    return dataclasses.replace(
        cfg,
        d_model=d_model,
        d_ff=d_ff,
        vocab_size=vocab,
        num_heads=heads,
        num_kv_heads=kv_heads,
        head_dim=head_dim,
        num_layers=len(pattern) * 2,
        pattern=pattern,
        plan=ParallelPlan(pp=2, tp=1, ep_over_data=cfg.plan.ep_over_data,
                          seq_shard_kv=False),
        num_experts=min(cfg.num_experts, 4),
        num_experts_per_tok=min(cfg.num_experts_per_tok, 2),
        moe_d_ff=min(cfg.moe_d_ff, 64) if cfg.moe_d_ff else 0,
        num_shared_experts=min(cfg.num_shared_experts, 1),
        q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
        v_head_dim=16,
        mamba_d_state=8, mamba_d_conv=4, mamba_expand=2,
        rwkv_head_dim=16,
        mrope_sections=(4, 2, 2),
    )


def _layer_kinds(cfg: ArchConfig) -> Tuple[BlockKind, ...]:
    """The kind of every layer in stage order, padding layers dropped."""
    stage = tuple(b.kind for b in cfg.pattern for _ in range(b.repeat))
    return (stage * cfg.plan.pp)[:cfg.num_layers]


def _merged(kinds) -> Tuple[BlockSpec, ...]:
    """Runs of one kind as one `BlockSpec` each."""
    out = []
    for kind in kinds:
        if out and out[-1].kind == kind:
            out[-1] = BlockSpec(kind, out[-1].repeat + 1)
        else:
            out.append(BlockSpec(kind, 1))
    return tuple(out)


def single_stage(cfg: ArchConfig) -> ArchConfig:
    """Fold the pipeline into one stage at pp=1, tp=1, layer order kept.

    qwen1.5-0.5b publishes pp=8 x 3 layers; on one card the whole depth is
    one stage: ``BlockSpec(ATTN_MLP, 24)``.  An interleaved pattern becomes
    the stage-local pattern repeated pp times (jamba: 72 single-layer
    entries); runs of one kind merge into one entry.  The plan keeps
    ``ep_over_data``: the experts split over a data axis of more than one
    rank (`models.transformer.expert_parts`), whatever the stages."""
    return dataclasses.replace(cfg, pattern=_merged(_layer_kinds(cfg)),
                               plan=ParallelPlan(
                                   pp=1, tp=1,
                                   ep_over_data=cfg.plan.ep_over_data))


def stage_config(cfg: ArchConfig, pp: int) -> ArchConfig:
    """`cfg` served in `pp` pipeline stages on one card, tp=1
    (`distributed.elastic.replan`): a uniform pattern's stacked layers
    re-tile into `pp` stages (qwen2.5-14b's 16 x 3 into 4 x 12); a count
    they do not divide, and a heterogeneous pattern at another stage count
    than its own (jamba; any depth cut of several kinds, which is one
    stage), raise `ValueError` as the JAX package refuses them."""
    from repro_torch.distributed.elastic import replan
    return replan(cfg, pp, 1)


def cut_to_depth(cfg: ArchConfig, layers: int) -> ArchConfig:
    """A depth cut: the first `layers` layers in the folded layer order, as
    one stage (`single_stage`); widths stay.  qwen2.5-14b cut to 4 is
    ``(ATTN_MLP, 4)``, ``num_layers=4``."""
    order = _layer_kinds(cfg)
    if not 0 < layers <= len(order):
        raise ValueError(f"{cfg.name} has {len(order)} layers, not "
                         f"{layers}")
    return dataclasses.replace(cfg, pattern=_merged(order[:layers]),
                               num_layers=layers,
                               plan=ParallelPlan(
                                   pp=1, tp=1,
                                   ep_over_data=cfg.plan.ep_over_data))


def cut_to_kinds(cfg: ArchConfig, kinds) -> ArchConfig:
    """A depth cut that fits one card: the first layer of each kind in
    `kinds`, in the folded layer order, as one stage (`single_stage`).
    jamba with (MAMBA_MLP, MAMBA_MOE, ATTN_MOE) keeps its layers 0, 1 and 8:
    ``(MAMBA_MLP, 1), (MAMBA_MOE, 1), (ATTN_MOE, 1)``, ``num_layers=3``.
    Widths and expert counts stay; the model computes what those layers
    compute."""
    want = set(kinds)
    order = _layer_kinds(cfg)
    missing = want - set(order)
    if missing:
        raise ValueError(f"{cfg.name} has no layer of kind "
                         f"{sorted(k.value for k in missing)}")
    kept = tuple(k for i, k in enumerate(order)
                 if k in want and k not in order[:i])
    return dataclasses.replace(cfg, pattern=_merged(kept),
                               num_layers=len(kept),
                               plan=ParallelPlan(
                                   pp=1, tp=1,
                                   ep_over_data=cfg.plan.ep_over_data))
