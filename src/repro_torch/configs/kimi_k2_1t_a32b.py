"""Kimi K2 — trillion-parameter MoE, 384 experts top-8 [arXiv:2501.kimi2].
61 published layers padded to 64 (8 stages x 8); pad layers are
residual-identity (zero out-projections). Experts sharded over data x tensor
(EP=32) — the only way 2 TB of bf16 weights fit a 256-chip v5e pod."""
from repro_torch.configs.base import ArchConfig, BlockKind, BlockSpec, ParallelPlan

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=2048, vocab_size=163840,
    pattern=(BlockSpec(BlockKind.ATTN_MOE, 8),),
    plan=ParallelPlan(pp=8, tp=2, ep_over_data=True),
    num_experts=384, num_experts_per_tok=8, moe_d_ff=2048, num_shared_experts=1,
    rope_theta=5e4, supports_long_context=False,
)
