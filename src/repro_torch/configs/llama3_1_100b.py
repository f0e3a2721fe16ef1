"""Llama-3.1-100B proxy — the paper's largest model is a 100B downscale of
Llama-3.1-405B (paper §4.1 footnote 2). We proxy with 96 layers x d=8192
(~84B + embeddings), same family (GQA kv=8, SwiGLU)."""
from repro_torch.configs.base import ArchConfig, BlockKind, BlockSpec, ParallelPlan

CONFIG = ArchConfig(
    name="llama3.1-100b", family="dense",
    num_layers=96, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256,
    pattern=(BlockSpec(BlockKind.ATTN_MLP, 12),),
    plan=ParallelPlan(pp=8, tp=2),
    rope_theta=5e5, supports_long_context=False,
)
