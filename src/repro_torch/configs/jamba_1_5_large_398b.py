"""Jamba-1.5-Large — hybrid Mamba+attention with MoE [arXiv:2403.19887].
72 layers over 8 stages (9/stage). Stage-local pattern: 4x(mamba-dense,
mamba-MoE) + 1 attn-MoE => attn:mamba = 1:8 (published 1:7 cannot tile an
SPMD-uniform 9-layer stage; DESIGN.md §7). 16 experts top-2, EP over `data`;
long_500k runs with sequence-sharded KV (flash-decode merge)."""
from repro_torch.configs.base import ArchConfig, BlockKind, BlockSpec, ParallelPlan

_pair = (BlockSpec(BlockKind.MAMBA_MLP, 1), BlockSpec(BlockKind.MAMBA_MOE, 1))
CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536,
    pattern=_pair * 4 + (BlockSpec(BlockKind.ATTN_MOE, 1),),
    plan=ParallelPlan(pp=8, tp=2, ep_over_data=True, seq_shard_kv=True),
    num_experts=16, num_experts_per_tok=2, moe_d_ff=24576,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
    rope_theta=1e6, supports_long_context=True,
)
