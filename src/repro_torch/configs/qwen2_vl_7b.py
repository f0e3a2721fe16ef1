"""Qwen2-VL-7B backbone [arXiv:2409.12191] — M-RoPE, dynamic-resolution ViT
frontend stubbed (input_specs provides precomputed patch embeddings)."""
from repro_torch.configs.base import ArchConfig, BlockKind, BlockSpec, ParallelPlan

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4, head_dim=128,
    d_ff=18944, vocab_size=152064,
    pattern=(BlockSpec(BlockKind.ATTN_MLP, 7),),
    plan=ParallelPlan(pp=4, tp=4),
    qkv_bias=True, mrope=True, mrope_sections=(16, 24, 24),
    rope_theta=1e6, supports_long_context=False,  # full attention -> no 500k
)
