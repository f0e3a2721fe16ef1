"""OLMoE-1B-7B — 64 experts top-8 [arXiv:2409.02060]."""
from repro_torch.configs.base import ArchConfig, BlockKind, BlockSpec, ParallelPlan

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1024, vocab_size=50304,
    pattern=(BlockSpec(BlockKind.ATTN_MOE, 4),),
    plan=ParallelPlan(pp=4, tp=4),
    num_experts=64, num_experts_per_tok=8, moe_d_ff=1024,
    rope_theta=1e4, supports_long_context=False,
)
