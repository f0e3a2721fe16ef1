"""Multi-pod dry run (``repro.launch.dryrun``): every (architecture x input
shape) cell at its production layout, counted on the ``meta`` device, to
show whether a rank's memory fits the card and to predict the roofline
terms of its program.

The JAX module lowers and compiles each cell's program for a 512-device
mesh and reads XLA's memory and cost analyses.  PyTorch compiles no
program, so here one rank of every stage runs its own program eagerly on
``meta`` tensors (shapes, no storage: nothing is allocated, on any card):
`pipeline.build_rank_serve_tick` for a serving cell, at the cell's
geometry (`launch.shapes.serve_cell_dims`), or `pipeline._rank_train_step`
for a training cell (`train_cell_dims`), on the rank's shard of
`transformer.abstract_params` (`shard_params`) over counting axes
(`mesh.counting_groups`), under `roofline.op_cost.OpCounter`.  Tensor and
data ranks of a stage are symmetric, so one of each stage stands for its
stage.  A cell reports the slowest stage's terms (the largest of its
compute, memory and collective times) and the largest per-rank memory:
the arguments (the rank's parameters; Adam's moments when training;
caches, carry and metadata when serving; its share of the inputs) plus the
peak of the temporaries the program allocates (gradients among them).

Every time it prints is a prediction at the H100 SXM data sheet's rates
(`roofline.analysis`); memory is held to the sheet's 80 GB.

The layout is the production one (`mesh.make_production_mesh`,
`derive_pipeline_mesh`): ``(16, 16)`` over (data, model), the model axis
factored into the arch's (stage, tensor).  Stages whose programs are the
same (`_stage_role`: neither first nor last, the same layers present) are
counted once: an eager count on ``meta`` tensors takes ~0.3 ms of host
time an op, and a training cell's stage runs some 50,000.  JAX's environment reads
(``REPRO_PP``, ``REPRO_TP``, ``REPRO_GRAD_COMPRESSION``) are the options
``--pp``, ``--tp`` and ``--grad-compression`` here.  The port's rank
layout has no ``pod`` axis: with ``--multi-pod`` the two pods' data
replicas form one data axis of 32 (an expert-parallel arch's experts then
split 32 ways, where JAX splits them over ``data`` alone).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-14b \\
        --shape decode_32k [--multi-pod] [--out results.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --single-pod-only --out build/dryrun.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs import (
    ASSIGNED_ARCHS,
    ASSIGNED_SHAPES,
    applicable_shapes,
    get_config,
)
from repro_torch.distributed.optimizer import AdamConfig, adam_init
from repro_torch.distributed.pipeline import (
    _rank_train_step,
    build_rank_serve_tick,
)
from repro_torch.launch import shapes
from repro_torch.launch.mesh import (
    counting_groups,
    derive_pipeline_mesh,
    make_production_mesh,
    rank_layout,
)
from repro_torch.models import transformer as tfm
from repro_torch.roofline.analysis import (
    HBM_BW,
    HBM_BYTES,
    NVLINK_BW,
    PEAK_FLOPS,
    RooflineCell,
    collective_breakdown,
    model_flops,
    param_count,
    render_table,
)
from repro_torch.roofline.op_cost import OpCounter

META = shapes.META


def cell_layout(cfg, multi_pod: bool = False):
    """(the rank layout of `cfg`'s production mesh, pods): ``(data,
    stage, tensor)`` at the plan's pp and tp, the pods folded into
    ``data``."""
    prod = derive_pipeline_mesh(make_production_mesh(multi_pod=multi_pod),
                                cfg.plan.pp, cfg.plan.tp)
    pods = prod.size("pod")
    return rank_layout(prod.size("data") * pods, cfg.plan.pp,
                       cfg.plan.tp), pods


def rank_params(cfg, layout, rank: int):
    """Rank `rank`'s shard of `cfg`'s parameters on the meta device."""
    whole = tfm.abstract_params(cfg, getattr(torch, cfg.dtype))
    return tfm.shard_params(cfg, whole, layout, rank, device=META)


def _summary(counter: OpCounter, args: int, params) -> dict:
    """A count's flops, bytes, collectives and peak temporaries, with the
    rank's argument and parameter bytes, the memory they need together
    (``memory_bytes``) and the bound of its terms (``bound_s``)."""
    out = dict(counter.summary(), argument_bytes=args,
               param_bytes=shapes.nbytes(params))
    out["memory_bytes"] = args + out["peak_live_bytes"]
    out["bound_s"] = stage_time(out)
    return out


def count_serve(cfg, dims, layout, rank: int) -> dict:
    """One serve tick (`pipeline.build_rank_serve_tick`) of rank `rank` of
    `layout` at `dims`, counted on meta (`_summary`'s keys)."""
    ranks = counting_groups(layout, rank)
    params = rank_params(cfg, layout, rank)
    dtype = getattr(torch, cfg.dtype)
    x = shapes.serve_input_specs(cfg, dims, ranks, dtype)
    tick = build_rank_serve_tick(cfg, dims, ranks, dtype=dtype)
    args = shapes.nbytes(params) + shapes.nbytes(x)
    with torch.inference_mode(), OpCounter() as counter:
        tick(params, x["caches"], x["meta"], x["carry"])
    return _summary(counter, args, params)


def count_train(cfg, dims, layout, rank: int, *, pods: int = 1,
                grad_compression: Optional[str] = None) -> dict:
    """One train step (`pipeline._rank_train_step`) of rank `rank` of
    `layout` at `dims` (`shapes.TrainDims`; the pods folded into the data
    axis), with Adam, counted on meta (`_summary`'s keys)."""
    ranks = counting_groups(layout, rank)
    params = rank_params(cfg, layout, rank).trainable()
    dp = layout.size("data")
    opt = adam_init(params)
    mine = shapes.train_batch_specs(cfg, dims, dp // pods, pods)
    # the step takes the whole batch of its pod and keeps its rows: the
    # rank's share, laid side by side for every data index
    whole = {k: torch.empty((t.shape[0], dp * t.shape[1]) + t.shape[2:],
                            dtype=t.dtype, device=META)
             for k, t in mine.items()}
    step = _rank_train_step(cfg, ranks, adam=AdamConfig(), aux_coef=0.01,
                            enc_width=dims.enc_width,
                            grad_compression=grad_compression, dev=META)
    args = shapes.nbytes(params) + shapes.nbytes(opt) + shapes.nbytes(mine)
    with OpCounter() as counter:
        step(params, opt, whole)
    return _summary(counter, args, params)


def stage_time(st: dict) -> float:
    """A count's bound in seconds: the largest of its three roofline
    terms at the data sheet's rates."""
    return max(st["flops"] / PEAK_FLOPS, st["bytes"] / HBM_BW,
               st["collective_bytes"] / NVLINK_BW)


def _stage_role(cfg, s: int, stages: int) -> tuple:
    """What sets stage `s`'s program apart: whether it embeds (the first),
    whether it holds the final norm (the last), and which of its layers
    exist (the padded ones past ``num_layers`` are the identity).  Stages
    of one role run the same program on tensors of the same shapes, so one
    count stands for all of them."""
    off = s * cfg.layers_per_stage
    live = tuple(off + i < cfg.num_layers
                 for i in range(cfg.layers_per_stage))
    return s == 0, s == stages - 1, live


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False, *,
               pp: Optional[int] = None, tp: Optional[int] = None,
               grad_compression: Optional[str] = None) -> dict:
    """Count one cell: one rank of every stage runs its program on meta.
    Returns {"cfg", "shape", "layout", "chips", "dims", "stages": [per
    stage: flops, bytes, collectives, peak temporaries, argument bytes],
    "t_count" (host seconds)}.  `pp` and `tp` re-plan the arch
    (`elastic.replan`, JAX's ``REPRO_PP`` / ``REPRO_TP``)."""
    cfg = get_config(arch)
    if pp and tp:
        from repro_torch.distributed.elastic import replan
        cfg = replan(cfg, pp, tp)
    shape = ASSIGNED_SHAPES[shape_name]
    layout, pods = cell_layout(cfg, multi_pod)
    data = layout.size("data") // pods
    t0 = time.perf_counter()
    if shape.kind == "train":
        dims = shapes.train_cell_dims(cfg, shape, data=data, pods=pods)
    else:
        dims = shapes.serve_cell_dims(cfg, shape, data=data)
    S, counted, stages = layout.size("stage"), {}, []
    for s in range(S):
        role = _stage_role(cfg, s, S)
        if role not in counted:
            rank = layout.rank_of({"stage": s})
            if shape.kind == "train":
                st = count_train(cfg, dims, layout, rank, pods=pods,
                                 grad_compression=grad_compression)
            else:
                st = count_serve(cfg, dims, layout, rank)
            counted[role] = dict(st, counted_at=s)
        stages.append(dict(counted[role], stage=s))
    return dict(cfg=cfg, shape=shape, layout=layout, chips=layout.world,
                dims=dims, stages=stages, t_count=time.perf_counter() - t0)


def analyse_cell(arch: str, shape_name: str, multi_pod: bool = False,
                 verbose: bool = True, **kw) -> dict:
    """`lower_cell`, then the cell's `RooflineCell` dict (JAX's schema,
    plus ``fits_hbm`` and the per-stage counts)."""
    info = lower_cell(arch, shape_name, multi_pod, **kw)
    cfg, shape, chips = info["cfg"], info["shape"], info["chips"]
    slow = max(info["stages"], key=stage_time)
    memory = max(st["memory_bytes"] for st in info["stages"])
    cell = RooflineCell(
        arch=arch, shape=shape_name,
        mesh="2x16x16" if multi_pod else "16x16", chips=chips,
        hlo_flops=float(slow["flops"]), hlo_bytes=float(slow["bytes"]),
        collective_bytes=float(slow["collective_bytes"]),
        collective_breakdown=collective_breakdown(slow["collectives"]),
        model_flops_per_chip=model_flops(cfg, shape, chips, shape.kind),
        per_device_memory_bytes=float(memory),
        notes=f"count={info['t_count']:.1f}s "
              f"params={param_count(cfg)/1e9:.1f}B "
              f"active={param_count(cfg, True)/1e9:.1f}B "
              f"slowest_stage={slow['stage']} "
              f"predicted at the H100 SXM data sheet's rates")
    d = cell.to_dict()
    d["stages"] = info["stages"]
    if verbose:
        print(json.dumps({k: d[k] for k in (
            "arch", "shape", "mesh", "t_compute", "t_memory", "t_collective",
            "bottleneck", "useful_ratio", "roofline_fraction",
            "per_device_memory_bytes", "fits_hbm", "notes")}, indent=1))
        print(f"  per-rank memory {memory / 1e9:.2f} GB "
              f"{'fits' if cell.fits_hbm else 'does NOT fit'} the "
              f"{HBM_BYTES / 1e9:.0f} GB of one H100 (predicted)",
              flush=True)
    return d


def cells_table(dicts) -> str:
    """`render_table` of cell dicts (the times predicted at the H100
    SXM data sheet's rates), with each cell's per-rank memory and fit."""
    keys = ("arch", "shape", "mesh", "chips", "hlo_flops", "hlo_bytes",
            "collective_bytes", "collective_breakdown",
            "model_flops_per_chip", "per_device_memory_bytes")
    cells = [RooflineCell(**{k: d[k] for k in keys}) for d in dicts]
    lines = render_table(cells).split("\n")
    lines[0] += " memory (GB) | fits 80 GB |"
    lines[1] += "---|---|"
    for i, c in enumerate(cells):
        lines[i + 2] += (f" {c.per_device_memory_bytes / 1e9:.2f} | "
                         f"{'yes' if c.fits_hbm else 'no'} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--pp", type=int, default=None,
                    help="re-plan every arch at this many stages (with --tp)")
    ap.add_argument("--tp", type=int, default=None)
    ap.add_argument("--grad-compression", default=None,
                    choices=[None, "int8", "ring8"])
    args = ap.parse_args(argv)

    if args.all:
        meshes = (False,) if args.single_pod_only else (False, True)
        todo = [(a, s.name, mp)
                for a in ASSIGNED_ARCHS
                for s in applicable_shapes(get_config(a))
                for mp in meshes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        todo = [(args.arch, args.shape, args.multi_pod)]

    # order small-to-large so results stream in early
    size_order = {"qwen1.5-0.5b": 0, "whisper-small": 1, "internlm2-1.8b": 2,
                  "rwkv6-3b": 3, "minicpm3-4b": 4, "olmoe-1b-7b": 5,
                  "qwen2-vl-7b": 6, "qwen2.5-14b": 7,
                  "jamba-1.5-large-398b": 8, "kimi-k2-1t-a32b": 9}
    todo.sort(key=lambda t: (size_order.get(t[0], 99), t[2], t[1]))

    kw = dict(pp=args.pp, tp=args.tp, grad_compression=args.grad_compression)
    cells, failures = [], []
    for arch, shape, mp in todo:
        tag = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
        print(f"=== {tag} ===", flush=True)
        try:
            cells.append(analyse_cell(arch, shape, mp, **kw))
        except Exception as e:  # noqa: BLE001 — report all failures at the end
            failures.append((tag, repr(e)))
            traceback.print_exc()
        if args.out:   # incremental flush: long sweeps stream results
            with open(args.out, "w") as f:
                json.dump(cells, f, indent=1)
    if cells:
        print(cells_table(cells))
    if failures:
        print("FAILURES:")
        for tag, err in failures:
            print(" ", tag, err)
        return 1
    print(f"OK: {len(cells)} cells counted on the meta device (times "
          f"predicted at the H100 SXM data sheet's rates)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
