#!/usr/bin/env python3
"""Check `repro_torch.launch.profile.device_time` (which reads the
profiler's raw activity records) against the same sums over the profiler's
`events()` tree, on one profiled batch, and time both readings:

    python3 tools/device_time_check.py [arch] [pp]

Run from the repository root on a machine with one CUDA card and ``nvcc``.
The batch is chip_smoke.py's serve-bf16 batch (32 requests, prompts 16-1500
tokens from seed 12, 16 new tokens each, greedy) on the bucketed async graph
engine in bf16 (default qwen1.5-0.5b at pp=1).  Prints one JSON line: busy
ms and the six largest kernels by each reading, and the seconds each took.
"""

from __future__ import annotations

import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import SamplingParams  # noqa: E402
from repro_torch.launch.profile import device_time  # noqa: E402
from repro_torch.launch.serve import build_engine  # noqa: E402


def tree_time(prof):
    """The same sums over `prof.events()`."""
    by_kernel = defaultdict(float)
    spans = []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[ev.name] += ev.time_range.end - ev.time_range.start
            spans.append((ev.time_range.start, ev.time_range.end))
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy, by_kernel


def serve(eng, prompts) -> None:
    for p in prompts:
        eng.add_request(p, SamplingParams(max_new_tokens=16))
    eng.drain()
    torch.cuda.synchronize()


def main() -> None:
    arch = sys.argv[1] if len(sys.argv) > 1 else "qwen1.5-0.5b"
    pp = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    eng = build_engine(arch, device="cuda", dtype=torch.bfloat16,
                       bucketed=True, async_dispatch=True, pp=pp)
    rng = np.random.default_rng(12)
    lens = [int(x) for x in rng.integers(16, 1501, 32)]
    lens[0], lens[1] = 16, 1500
    prompts = [[int(t) for t in rng.integers(0, eng.cfg.vocab_size, L)]
               for L in lens]
    serve(eng, prompts)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        serve(eng, prompts)
    out = {"arch": arch, "pp": pp}
    for name, fn in (("raw_records", device_time), ("events_tree", tree_time)):
        t0 = time.perf_counter()
        busy, by_kernel = fn(prof)
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
        out[name] = {"seconds": time.perf_counter() - t0,
                     "busy_ms": busy / 1e3, "kernels": len(by_kernel),
                     "top_ms": [[k[:60], v / 1e3] for k, v in top]}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
