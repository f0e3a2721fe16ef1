"""Cell geometry (``repro.launch.shapes``): maps each assigned (architecture
x input shape) pair to the static tick or batch layout it runs at, and the
abstract inputs of one rank's program for the dry run (`launch.dryrun`).

`serve_cell_dims` and `train_cell_dims` give the JAX module's numbers
exactly: the per-replica `models.serve.ServeDims` of a serving cell (a
decode cell has no prefill phase, ``Sp = C = 0``, and a decode cell of
fewer sequences than replicas shards its KV over them, ``seq_shard``) and
the `TrainDims` of a training cell.

The abstract inputs are ``meta`` tensors (shapes and dtypes, no storage)
of one rank's shapes: the rank's share of every dimension the layout
splits (what JAX's ``_scale_replica`` multiplies back for its global
arrays), its stage's pools at its tensor widths.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import serve as serve_lib
from repro_torch.models.serve import ServeDims

PAGE_SIZE = 16
PAGES_PER_BLOCK = 8
META = torch.device("meta")


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _round_mult(x: int, m: int) -> int:
    return _ceil(x, m) * m


# ----------------------------------------------------------------------------
# Serving cells
# ----------------------------------------------------------------------------

def serve_cell_dims(cfg: ArchConfig, shape: ShapeSpec, data: int = 16,
                    *, max_prefill: int = 2048) -> ServeDims:
    """Static per-replica tick geometry for a serving cell."""
    pp = cfg.plan.pp
    page = PAGE_SIZE
    Te = 1536 if cfg.is_encoder_decoder else 0
    pages_per_seq = _round_mult(_ceil(shape.seq_len, page), PAGES_PER_BLOCK)
    uses_pages = cfg.family not in ("ssm",)

    if shape.kind == "prefill":
        seqs_rep = max(1, _ceil(shape.global_batch, data))
        Sp, C = 1, max_prefill
        Sd = 8                                # decode rows forming behind prefill
        pool = seqs_rep * pages_per_seq + 16 * PAGES_PER_BLOCK if uses_pages else 8
        return ServeDims(Sp=Sp, C=C, Sd=Sd, pages=pool, page=page,
                         Bp=pages_per_seq, Bd=pages_per_seq,
                         slots=max(8, seqs_rep + Sd), Te=Te)

    # decode cells
    seqs_rep = max(1, _ceil(shape.global_batch, data))
    seq_shard = cfg.plan.seq_shard_kv and shape.global_batch < data \
        and cfg.family != "ssm"
    if seq_shard:
        # sequence-sharded KV: each replica holds an interleaved 1/data slice
        local_pages = _round_mult(_ceil(shape.seq_len, page * data),
                                  PAGES_PER_BLOCK)
        pool = local_pages + 2 * PAGES_PER_BLOCK
        Bd = local_pages
    else:
        pool = seqs_rep * pages_per_seq + 2 * PAGES_PER_BLOCK if uses_pages else 8
        Bd = pages_per_seq if uses_pages else 8
    Sd = max(1, _ceil(seqs_rep, pp))
    return ServeDims(Sp=0, C=0, Sd=Sd, pages=pool if uses_pages else 8,
                     page=page, Bp=8, Bd=Bd,
                     slots=max(1, seqs_rep), Te=Te, seq_shard=seq_shard)


# ----------------------------------------------------------------------------
# Training cells
# ----------------------------------------------------------------------------

@dataclass(frozen=True)
class TrainDims:
    M: int               # total micro-batches (sharded over pod)
    mbg: int             # sequences per micro-batch (sharded over data)
    T: int
    enc_width: int = 0   # whisper payload split
    stub_width: int = 0  # frontend-stub embedding rows (vlm/audio)


def train_cell_dims(cfg: ArchConfig, shape: ShapeSpec, data: int = 16,
                    pods: int = 1) -> TrainDims:
    B, T = shape.global_batch, shape.seq_len
    mbg = data                                   # 1 sequence per replica per mb
    M = B // (mbg * 1)
    enc_width = T // 2 if cfg.is_encoder_decoder else 0
    stub = 0
    if cfg.family == "vlm":
        stub = 256
    elif cfg.family == "audio":
        stub = enc_width                          # precomputed frame embeddings
    return TrainDims(M=M, mbg=mbg, T=T, enc_width=enc_width, stub_width=stub)


# ----------------------------------------------------------------------------
# Abstract inputs (dry run): one rank's, on the meta device
# ----------------------------------------------------------------------------

def train_batch_specs(cfg: ArchConfig, dims: TrainDims, data: int,
                      pods: int = 1) -> Dict[str, torch.Tensor]:
    """One rank's batch: ``tokens`` and ``labels`` [M / pods, mbg / data,
    T] int32 (JAX's ``P("pod", "data", None)``) and, for a vlm or audio
    config, the frontend-stub rows ``embeds`` [.., stub_width, d] in the
    model's dtype."""
    M, mbg = dims.M // pods, dims.mbg // data
    batch = {k: torch.empty((M, mbg, dims.T), dtype=torch.int32,
                            device=META) for k in ("tokens", "labels")}
    if dims.stub_width:
        batch["embeds"] = torch.empty((M, mbg, dims.stub_width, cfg.d_model),
                                      dtype=getattr(torch, cfg.dtype),
                                      device=META)
    return batch


def meta_field_shapes(dims: ServeDims) -> Dict[str, tuple]:
    """The shape of every field of one tick's device metadata at `dims`
    (`serve.host_meta` of the empty tick)."""
    return {k: v.shape for k, v in
            serve_lib.host_meta(serve_lib.zero_meta(dims), dims).items()}


def serve_input_specs(cfg: ArchConfig, dims: ServeDims, ranks,
                      dtype: torch.dtype) -> Dict[str, Any]:
    """One rank's abstract inputs of the serve tick
    (`pipeline.build_rank_serve_tick`) at `ranks` (a `mesh.RankGroups`):
    ``caches`` (its stage's pools at its tensor widths,
    `transformer.shard_config`), ``carry`` (`pipeline.init_rank_carry`'s,
    None on stage 0), ``meta`` (every field of `meta_field_shapes`,
    stacked over the stages at more than one, then the entering
    micro-batch's token ids ``p_tok`` [Sp, C], ``d_tok`` [Sd] and an
    encoder-decoder's ``p_enc`` [Sp, Te, d]) and ``temps`` [Sp + Sd] f32
    (JAX's sampling temperatures)."""
    from repro_torch.distributed.pipeline import init_rank_carry
    from repro_torch.models.transformer import expert_parts, shard_config

    local = shard_config(cfg, ranks.size("tensor"),
                         expert_parts(cfg, ranks.size("data")))
    stages = ranks.size("stage")
    lead = (stages,) if stages > 1 else ()
    meta = {k: torch.empty(lead + tuple(shape), dtype=torch.int32,
                           device=META)
            for k, shape in meta_field_shapes(dims).items()}
    meta["p_tok"] = torch.empty((dims.Sp, dims.C), dtype=torch.int32,
                                device=META)
    meta["d_tok"] = torch.empty((dims.Sd,), dtype=torch.int32, device=META)
    if dims.Te:
        meta["p_enc"] = torch.empty((dims.Sp, dims.Te, cfg.d_model),
                                    dtype=dtype, device=META)
    return {"caches": serve_lib.init_caches(local, dims, dtype, META),
            "carry": init_rank_carry(cfg, dims, ranks, dtype, META),
            "meta": meta,
            "temps": torch.empty((dims.Sp + dims.Sd,), dtype=torch.float32,
                                 device=META)}


def nbytes(tree: Optional[Any]) -> int:
    """Bytes of every tensor in a nested dict (or module dict) or list of
    tensors; 0 for None."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if hasattr(tree, "items"):
        return sum(nbytes(v) for _, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(nbytes(v) for v in tree)
    return 0
