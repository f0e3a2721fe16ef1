"""Where a serving tick's time goes: serve an offline batch under
``torch.profiler`` and print, as one JSON line, the device time by kernel
and the device's busy and idle share of the profiled window.

    PYTHONPATH=src python -m repro_torch.launch.profile --requests 16

Full width and depth in bf16 on the card by default; ``--cut`` serves the
first layer of each named block kind, as in ``launch/serve.py`` (the jamba
cut: ``--arch jamba-1.5-large-398b --cut mamba_mlp,mamba_moe,attn_moe``);
``--reduced --device cpu`` runs the same code on the CPU (host activity
only, no device rows).  ``--bucketed``, ``--async``, ``--eager`` and
``--pp`` are `launch/serve.py`'s.  A first, unprofiled batch warms the kernels and the
allocator.  At ``--reduced`` the prompts are at most two prefill chunks
long: the profiler records every op of every tick.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import SamplingParams
from repro_torch.launch.serve import (
    add_cut_argument,
    add_engine_arguments,
    build_engine,
    parse_cut,
)


def _serve(eng, rng, n: int, max_new: int, reduced: bool) -> None:
    """Prompt lengths uniform in [16, 1500] (at the reduced dims, in [16,
    two prefill chunks]), capped by the model length."""
    max_len = eng.dims.page * max(eng.dims.Bp, eng.dims.Bd) - max_new
    top = 2 * eng.dims.C if reduced else 1500
    for _ in range(n):
        L = int(rng.integers(16, max(16, min(top, max_len)) + 1))
        eng.add_request([int(t) for t in rng.integers(0, eng.cfg.vocab_size,
                                                      L)],
                        SamplingParams(max_new_tokens=max_new))
    eng.drain()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()


def device_time(prof):
    """(busy_us, {kernel name: us}) of a finished `torch.profiler` run: the
    union of the device's activity intervals, and the time by name.  Read
    from the profiler's raw activity records: building its `events()` tree
    takes tens of seconds for a few hundred ticks of a 48-layer model."""
    by_kernel = defaultdict(float)
    spans = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            a, b = ev.start_ns() / 1e3, ev.end_ns() / 1e3
            by_kernel[ev.name()] += b - a
            spans.append((a, b))
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy, by_kernel


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=12)
    add_cut_argument(ap)
    add_engine_arguments(ap)
    args = ap.parse_args()

    eng = build_engine(args.arch, reduced=args.reduced, device=args.device,
                       cut=parse_cut(args.cut), seed=args.seed,
                       bucketed=args.bucketed,
                       async_dispatch=args.async_dispatch,
                       cuda_graphs=args.cuda_graphs, pp=args.pp)
    rng = np.random.default_rng(args.seed)
    _serve(eng, rng, max(2, args.requests // 4), args.max_new,
           args.reduced)                                         # warm-up
    ticks0 = eng.stats.ticks
    cuda = eng.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        _serve(eng, rng, args.requests, args.max_new, args.reduced)
    wall_us = (time.perf_counter() - t0) * 1e6

    busy_us, by_kernel = device_time(prof)
    ticks = eng.stats.ticks - ticks0
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[: args.top]
    print(json.dumps({
        "arch": eng.cfg.name, "device": str(eng.device),
        "kinds": [b.kind.value for b in eng.cfg.pattern],
        "dtype": eng.cfg.dtype, "bucketed": args.bucketed,
        "async_dispatch": args.async_dispatch,
        "cuda_graphs": eng.backend.graphs, "pp": eng.cfg.plan.pp,
        "requests": args.requests,
        "ticks": ticks,
        "wall_ms": wall_us / 1e3, "ms_per_tick": wall_us / 1e3 / ticks,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": (1.0 - busy_us / wall_us) if cuda else None,
        "kernels_ms": [{"name": k[:120], "ms": v / 1e3,
                        "share_of_busy": v / busy_us if busy_us else None}
                       for k, v in top]}))


if __name__ == "__main__":
    main()
