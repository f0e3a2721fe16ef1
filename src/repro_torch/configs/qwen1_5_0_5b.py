"""Qwen1.5-0.5B — QKV bias [hf:Qwen/Qwen1.5-0.5B]."""
from repro_torch.configs.base import ArchConfig, BlockKind, BlockSpec, ParallelPlan

CONFIG = ArchConfig(
    name="qwen1.5-0.5b", family="dense",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=2816, vocab_size=151936,
    pattern=(BlockSpec(BlockKind.ATTN_MLP, 3),),
    plan=ParallelPlan(pp=8, tp=2),
    qkv_bias=True, rope_theta=1e4, supports_long_context=False,
)
