"""MiniCPM3-4B — multi-head latent attention (MLA) [hf:openbmb/MiniCPM3-4B].
62 published layers padded to 64 (8 stages x 8)."""
from repro_torch.configs.base import ArchConfig, BlockKind, BlockSpec, ParallelPlan

CONFIG = ArchConfig(
    name="minicpm3-4b", family="dense",
    num_layers=62, d_model=2560, num_heads=40, num_kv_heads=40, head_dim=96,
    d_ff=6400, vocab_size=73448,
    pattern=(BlockSpec(BlockKind.MLA_MLP, 8),),
    plan=ParallelPlan(pp=8, tp=2),
    mla=True, q_lora_rank=768, kv_lora_rank=256,
    qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64,
    rope_theta=1e4, supports_long_context=False,
)
