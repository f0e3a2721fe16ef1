"""Qwen2.5-14B — GQA + QKV bias [arXiv:2412.15115]. The paper's own
evaluation family; deepest pipeline (pp=16) to showcase the technique."""
from repro_torch.configs.base import ArchConfig, BlockKind, BlockSpec, ParallelPlan

CONFIG = ArchConfig(
    name="qwen2.5-14b", family="dense",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=13824, vocab_size=152064,
    pattern=(BlockSpec(BlockKind.ATTN_MLP, 3),),
    plan=ParallelPlan(pp=16, tp=1),
    qkv_bias=True, rope_theta=1e6, supports_long_context=False,
)
