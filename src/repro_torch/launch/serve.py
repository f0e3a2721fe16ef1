"""Serving launcher of the port (``repro.launch.serve``).

On the card it builds the published width and depth of the arch (folded to
one stage by `single_stage`, bf16, random weights from `--seed`):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --requests 16 --max-new 16

``--reduced --device cpu`` runs the same path on the CPU at a tiny width,
through the kernels' plain versions.  A model whose weights do not fit the
card is served as a depth cut, the first layer of each named block kind
(`configs.cut_to_kinds`); jamba-1.5-large-398b at full width is 870 GB in
bf16, its cut to one layer of each kind 44 GB:

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch jamba-1.5-large-398b --cut mamba_mlp,mamba_moe,attn_moe

On the card every tick replays a CUDA graph (``--eager`` runs it eagerly);
``--bucketed`` serves the bucket ladder, ``--async`` overlaps the host's
work on tick N+1 with tick N on the device:

    PYTHONPATH=src python -m repro_torch.launch.serve --bucketed --async

`build_engine` is the entry point `chip_smoke.py` and the tests call.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import (
    BlockKind,
    cut_to_kinds,
    get_config,
    make_reduced,
    single_stage,
)
from repro_torch.core import SamplingParams, ThrottleConfig
from repro_torch.models.serve import ServeDims
from repro_torch.models.transformer import init_params, model_param_defs
from repro_torch.runtime.engine import PipelineEngine, resolve_device

# Full width on one H100: one prefill chunk of 512 tokens and 32 decode rows
# per tick, 2048 pages of 16 tokens (launch/shapes.py's page) per layer.
FULL_DIMS = ServeDims(Sp=1, C=512, Sd=32, pages=2048, page=16, Bp=128,
                      Bd=128, slots=64)
# Reduced mode: the JAX package's CPU-sized defaults (serving/build.py).
REDUCED_DIMS = ServeDims(Sp=1, C=32, Sd=8, pages=512, page=8, Bp=64, Bd=64,
                         slots=16)
REDUCED_THROTTLE = dict(num_iters_T=4, max_prefill_tokens=32,
                        min_prefill_tokens=4)


def weight_bytes(cfg, dtype: torch.dtype) -> int:
    """Bytes of `cfg`'s parameters in `dtype`."""
    def walk(tree) -> int:
        if isinstance(tree, tuple):
            return math.prod(tree[0])
        return sum(walk(v) for v in tree.values())
    return walk(model_param_defs(cfg)) * dtype.itemsize


def build_engine(arch: str = "qwen1.5-0.5b", *, reduced: bool = False,
                 device: Optional[torch.device | str] = None,
                 dtype: Optional[torch.dtype] = None,
                 dims: Optional[ServeDims] = None,
                 throttle: Optional[ThrottleConfig] = None,
                 cut: Optional[Sequence[BlockKind]] = None,
                 seed: int = 0, bucketed: bool = False,
                 async_dispatch: bool = False,
                 cuda_graphs: bool = True) -> PipelineEngine:
    """A ready engine for `arch`: full width and depth in one stage (bf16
    by default), or the reduced CPU-sized variant (f32).  `cut` names block
    kinds: the model is then cut in depth to the first layer of each
    (`cut_to_kinds`).  On the card, weights that exceed its memory raise
    before anything is allocated.  `bucketed`, `async_dispatch` and
    `cuda_graphs` go to `PipelineEngine`."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = make_reduced(cfg).with_plan(pp=1, tp=1)
        cfg = dataclasses.replace(cfg, dtype="float32")
        dims = dims or REDUCED_DIMS
        throttle = throttle or ThrottleConfig(pipeline_depth=1,
                                              **REDUCED_THROTTLE)
    else:
        cfg = single_stage(cfg)
        dims = dims or FULL_DIMS
        throttle = throttle or ThrottleConfig(pipeline_depth=1)
    if cut:
        cfg = cut_to_kinds(cfg, cut)
    dtype = dtype or getattr(torch, cfg.dtype)
    cfg = dataclasses.replace(cfg, dtype=str(dtype).split(".")[-1])
    if dev.type == "cuda":
        need = weight_bytes(cfg, dtype)
        have = torch.cuda.get_device_properties(dev).total_memory
        if need > have:
            raise ValueError(
                f"{cfg.name}: {cfg.num_layers} layers need {need:,} bytes "
                f"of {cfg.dtype} weights, more than the card's {have:,}; "
                f"serve a depth cut (cut=, --cut), e.g. one layer of each "
                f"block kind: {sorted({b.kind.value for b in cfg.pattern})}")
    params = init_params(cfg, seed, dtype=dtype, device=dev)
    return PipelineEngine(cfg, dims, params, throttle, device=dev,
                          dtype=dtype, seed=seed, bucketed=bucketed,
                          async_dispatch=async_dispatch,
                          cuda_graphs=cuda_graphs)


def add_cut_argument(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--cut", default=None,
                    help="comma-separated block kinds (e.g. "
                    "mamba_mlp,mamba_moe,attn_moe): serve the first layer "
                    "of each")


def add_engine_arguments(ap: argparse.ArgumentParser) -> None:
    """`--bucketed`, `--async` and `--eager`, `build_engine`'s options."""
    ap.add_argument("--bucketed", action="store_true",
                    help="serve the bucket ladder (each tick in the "
                    "smallest shape that covers it)")
    ap.add_argument("--async", dest="async_dispatch", action="store_true",
                    help="double-buffered dispatch: the host prepares tick "
                    "N+1 while the device runs tick N")
    ap.add_argument("--eager", dest="cuda_graphs", action="store_false",
                    help="on CUDA, run every tick eagerly instead of "
                    "replaying one CUDA graph per bucket")


def parse_cut(text: Optional[str]) -> Optional[list]:
    """`--cut`'s block kinds, or None to serve every layer."""
    return [BlockKind(k) for k in text.split(",")] if text else None


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (f32) instead of the "
                    "published width and depth")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--dtype", default=None, choices=["float32", "bfloat16"])
    add_cut_argument(ap)
    add_engine_arguments(ap)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    dtype = getattr(torch, args.dtype) if args.dtype else None
    eng = build_engine(args.arch, reduced=args.reduced, device=args.device,
                       dtype=dtype, cut=parse_cut(args.cut), seed=args.seed,
                       bucketed=args.bucketed,
                       async_dispatch=args.async_dispatch,
                       cuda_graphs=args.cuda_graphs)
    cfg = eng.cfg
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    reqs = []
    for _ in range(args.requests):
        n = int(np.clip(rng.lognormal(3.0, 0.8), 4, 300))
        reqs.append(eng.add_request(
            [int(t) for t in rng.integers(0, cfg.vocab_size, n)],
            SamplingParams(max_new_tokens=args.max_new)))
    eng.drain()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = sum(r.num_output_tokens for r in reqs)
    done = sum(r.is_finished for r in reqs)
    st = eng.stats
    print(f"[{cfg.name} | {eng.device} {cfg.dtype}] {done}/{len(reqs)} "
          f"requests, {toks} tokens in {wall:.2f}s; ticks={st.ticks} "
          f"host_s={st.host_s:.3f} device_s={st.device_s:.3f} "
          f"buckets={len(eng.backend.ladder)} "
          f"graphs={eng.backend.graph_count()}")
    if done != len(reqs):
        raise SystemExit("not every request finished")


if __name__ == "__main__":
    main()
