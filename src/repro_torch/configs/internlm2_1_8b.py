"""InternLM2-1.8B — GQA [arXiv:2403.17297]."""
from repro_torch.configs.base import ArchConfig, BlockKind, BlockSpec, ParallelPlan

CONFIG = ArchConfig(
    name="internlm2-1.8b", family="dense",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=92544,
    pattern=(BlockSpec(BlockKind.ATTN_MLP, 3),),
    plan=ParallelPlan(pp=8, tp=2),
    rope_theta=1e6, supports_long_context=False,
)
