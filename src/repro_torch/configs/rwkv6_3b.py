"""RWKV6-3B (Finch) — attention-free, data-dependent decay [arXiv:2404.05892].
O(1)-state decode: long_500k runs natively."""
from repro_torch.configs.base import ArchConfig, BlockKind, BlockSpec, ParallelPlan

CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm",
    num_layers=32, d_model=2560, num_heads=40, num_kv_heads=40, head_dim=64,
    d_ff=8960, vocab_size=65536,
    pattern=(BlockSpec(BlockKind.RWKV, 4),),
    plan=ParallelPlan(pp=8, tp=2),
    rwkv_head_dim=64, norm="layernorm",
    supports_long_context=True,
)
