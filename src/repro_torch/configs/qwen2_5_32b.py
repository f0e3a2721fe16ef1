"""Qwen2.5-32B — the paper's mid-size evaluation model [arXiv:2412.15115]."""
from repro_torch.configs.base import ArchConfig, BlockKind, BlockSpec, ParallelPlan

CONFIG = ArchConfig(
    name="qwen2.5-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=27648, vocab_size=152064,
    pattern=(BlockSpec(BlockKind.ATTN_MLP, 4),),
    plan=ParallelPlan(pp=16, tp=1),
    qkv_bias=True, rope_theta=1e6, supports_long_context=False,
)
