"""Roofline terms of the card the port serves on (``repro.roofline.analysis``).

Three terms per (arch, shape, layout), all *per rank* (one rank's program,
as the JAX module's are per chip: the SPMD program XLA compiles):

    compute    = flops / PEAK_FLOPS
    memory     = bytes / HBM_BW
    collective = collective payload bytes / NVLINK_BW

The constants are the NVIDIA H100 SXM's data-sheet rates, in place of the
JAX module's TPU constants; every time the terms give is a prediction at
those rates.  `RooflineCell`, `model_flops`, `param_count` and
`render_table` are the JAX module's; a cell's dict has the schema
``benchmarks/roofline_report.py`` loads, and adds whether the rank's memory
fits the card (``fits_hbm``, against `HBM_BYTES`).

The JAX module's `parse_collective_bytes` parses the collectives of an
optimised HLO module, which PyTorch does not produce.  Its counterpart is
the count of `roofline.op_cost`: the dry run (`launch.dryrun`) runs one
rank's program on ``meta`` tensors, and each collective books its payload
bytes under the same HLO names (`COLLECTIVES`), which `RooflineCell`'s
``collective_breakdown`` keeps.  The simulator's cost model
(`runtime/simulator.py`) takes the rates and `param_count`; on the card,
`launch/profile.py` reads device time by kernel from the profiler.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict

from repro_torch.roofline.op_cost import COLLECTIVES

# NVIDIA H100 SXM5 data sheet: bf16 tensor cores, dense (989 TFLOP/s; the
# sheet's 1,979 counts 2:4 sparsity)
PEAK_FLOPS = 989e12          # bf16 per card
# NVIDIA H100 SXM5 data sheet: HBM3, 3.35 TB/s
HBM_BW = 3.35e12             # bytes/s per card
# NVLink 4 (18 links per H100 SXM5): 900 GB/s in both directions together,
# 450 GB/s each way; the card-to-card link in place of the TPU's ICI link
NVLINK_BW = 450e9            # bytes/s per direction
# NVIDIA H100 SXM5 data sheet: 80 GB of HBM3 (the card reports a little
# more, ~85.0e9 bytes; the sheet's figure is the budget a rank is held to)
HBM_BYTES = 80e9


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


@dataclass
class RooflineCell:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float             # per rank
    hlo_bytes: float             # per rank
    collective_bytes: float      # per rank
    collective_breakdown: Dict[str, int]
    model_flops_per_chip: float  # analytic "useful" flops
    per_device_memory_bytes: float
    notes: str = ""

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        if self.hlo_flops <= 0:
            return 0.0
        return self.model_flops_per_chip / self.hlo_flops

    @property
    def roofline_fraction(self) -> float:
        """Achievable fraction of compute roofline: time the card *must*
        spend on useful math over the time the program takes at the
        bound (dominant term), assuming perfect overlap of the rest."""
        t_bound = max(self.t_compute, self.t_memory, self.t_collective)
        if t_bound <= 0:
            return 0.0
        return (self.model_flops_per_chip / PEAK_FLOPS) / t_bound

    @property
    def fits_hbm(self) -> bool:
        return self.per_device_memory_bytes <= HBM_BYTES

    def to_dict(self) -> dict:
        d = asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, bottleneck=self.bottleneck,
                 useful_ratio=self.useful_ratio,
                 roofline_fraction=self.roofline_fraction,
                 fits_hbm=self.fits_hbm)
        return d


def collective_breakdown(collectives: Dict[str, float]) -> Dict[str, int]:
    """A count's collective bytes under every HLO name (`COLLECTIVES`)."""
    return {k: int(collectives.get(k, 0)) for k in COLLECTIVES}


def model_flops(cfg, shape, chips: int, kind: str) -> float:
    """6·N_active·tokens (train) or 2·N_active·tokens (serve fwd), per
    chip, as the JAX module computes it, with its fixed 16 data replicas
    and prefill chunk of 2,048.

    Decode cells process one token per resident sequence per *pipeline
    traversal*; a single tick advances 1/pp of the sequences, so per-tick
    useful flops = 2·N·(batch/pp) — which is what one tick does."""
    n_active = param_count(cfg, active_only=True)
    if kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n_active * tokens / chips
    data = 16
    if kind == "prefill":
        tokens_per_tick = 2048 * data          # C per replica x replicas
        return 2.0 * n_active * tokens_per_tick / chips
    per_replica = max(1, -(-shape.global_batch // data))
    sd = max(1, -(-per_replica // cfg.plan.pp))
    tokens_per_tick = sd * cfg.plan.pp * data   # all stages advance their mb
    return 2.0 * n_active * tokens_per_tick / chips


def render_table(cells) -> str:
    hdr = (f"| arch | shape | mesh | t_comp(ms) | t_mem(ms) | t_coll(ms) | "
           f"bound | useful | roofline |")
    sep = "|" + "---|" * 9
    rows = [hdr, sep]
    for c in cells:
        rows.append(
            f"| {c.arch} | {c.shape} | {c.mesh} | {c.t_compute*1e3:.3f} | "
            f"{c.t_memory*1e3:.3f} | {c.t_collective*1e3:.3f} | "
            f"{c.bottleneck} | {c.useful_ratio:.2f} | "
            f"{c.roofline_fraction:.2%} |")
    return "\n".join(rows)
