"""Whisper-small backbone [arXiv:2212.04356] — encoder-decoder; the conv
frontend is a STUB (input_specs provides precomputed frame embeddings).
12 enc + 12 dec layers over 4 stages: each stage runs 3 enc + 3 dec layers;
the final encoder states ride the pipeline payload for cross-attention."""
from repro_torch.configs.base import ArchConfig, BlockKind, BlockSpec, ParallelPlan

CONFIG = ArchConfig(
    name="whisper-small", family="audio",
    num_layers=24, d_model=768, num_heads=12, num_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=51865,
    pattern=(BlockSpec(BlockKind.ENC_LAYER, 3), BlockSpec(BlockKind.DEC_LAYER, 3)),
    plan=ParallelPlan(pp=4, tp=4),
    is_encoder_decoder=True, norm="layernorm", act="gelu",
    rope_theta=1e4, supports_long_context=False,
)
