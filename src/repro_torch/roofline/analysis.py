"""Roofline constants of the card the port serves on, and the analytic
parameter count (``repro.roofline.analysis``).

Only what the simulator's cost model needs (`runtime/simulator.py`): the
NVIDIA H100 SXM's rates from its data sheet, in place of the JAX module's
TPU constants, and a copy of `param_count`.  The JAX module's HLO parsing
has no counterpart here: on the card, `launch/profile.py` reads device time
by kernel from the profiler instead.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 data sheet: bf16 tensor cores, dense (989 TFLOP/s; the
# sheet's 1,979 counts 2:4 sparsity)
PEAK_FLOPS = 989e12          # bf16 per card
# NVIDIA H100 SXM5 data sheet: HBM3, 3.35 TB/s
HBM_BW = 3.35e12             # bytes/s per card
# NVLink 4 (18 links per H100 SXM5): 900 GB/s in both directions together,
# 450 GB/s each way; the card-to-card link in place of the TPU's ICI link
NVLINK_BW = 450e9            # bytes/s per direction


def param_count(cfg, active_only: bool = False) -> float:
    """Analytic parameter count from the config (MoE: active experts only
    when `active_only`).  The stage pattern times `cfg.plan.pp`, as the JAX
    module counts: the published config and every `stage_config` staging
    of it give one count; its `single_stage` fold drops the padding layers
    (kimi-k2-1t-a32b: 61 of 64, minicpm3-4b: 62 of 64) and counts only the
    layers that exist."""
    from repro_torch.configs.base import BlockKind
    per = cfg.params_per_layer_estimate()
    total = 0.0
    for bs in cfg.pattern:
        for _ in range(bs.repeat):
            k = bs.kind
            if k in (BlockKind.ATTN_MLP, BlockKind.ENC_LAYER):
                total += per["attn"] + per["mlp"]
            elif k == BlockKind.DEC_LAYER:
                total += 2 * per["attn"] + per["mlp"]
            elif k == BlockKind.MLA_MLP:
                total += per["attn"] + per["mlp"]
            elif k == BlockKind.ATTN_MOE:
                total += per["attn"] + (per["moe_active"] if active_only
                                        else per["moe"])
            elif k == BlockKind.MAMBA_MLP:
                total += per["mamba"] + per["mlp"]
            elif k == BlockKind.MAMBA_MOE:
                total += per["mamba"] + (per["moe_active"] if active_only
                                         else per["moe"])
            elif k == BlockKind.RWKV:
                total += per["rwkv"]
    total *= cfg.plan.pp
    total += 2 * cfg.vocab_size * cfg.d_model
    return total
