#!/usr/bin/env python3
"""Where a train step's time goes on the card: the port's GPipe train step
(`repro_torch.distributed.pipeline.build_train_step`) under torch.profiler.

    python3 tools/train_profile.py [--arch qwen1.5-0.5b] [--layers N]
        [--seq 4096] [--lr 3e-4] [--pp 1]

Run from the repository root on a machine with one CUDA card and ``nvcc``.
The arch is built at full width in bf16, folded to one stage (or staged in
``--pp`` stages), cut to its first ``--layers`` layers when given, with
random weights from seed 0; each step takes 2 micro-batches of one
``--seq``-token sequence from `data.tokens.batches`, as `launch.train`
does.  Three warm steps, then two steps timed by the host clock and two
more under the profiler (device activity only).  Prints one JSON line:
wall ms per step, device busy ms per step (the union of the device's
activity, `launch.profile.device_time`), the idle share, device ms per
step by class of kernel (`CLASSES`, from the kernels' names), and the
twelve kernels with the most device time, per step.  RWKV and Mamba
archs train through the train forms of `models/ssm.py`, e.g.

    python3 tools/train_profile.py --arch rwkv6-3b --lr 1e-4
    python3 tools/train_profile.py --arch jamba-1.5-large-398b --layers 2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import (  # noqa: E402
    BlockSpec,
    get_config,
    single_stage,
    stage_config,
)
from repro_torch.data.tokens import batches  # noqa: E402
from repro_torch.distributed.optimizer import AdamConfig, adam_init  # noqa: E402
from repro_torch.distributed.pipeline import build_train_step  # noqa: E402
from repro_torch.launch.profile import device_time  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402


# (class, substrings of the kernel names it takes), first match wins: the
# port's kernels, cuBLAS GEMMs (`nvjet_*` among them), cumulative sums,
# reductions, copies and concatenations, then the elementwise kernels
CLASSES = (("port kernels", ("moe_", "wkv6_", "mamba_", "paged_attention")),
           ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "sm90_",
                     "ampere_")),
           ("scan", ("scan",)),
           ("reduce", ("reduce", "Reduce")),
           ("copy", ("copy", "Copy", "Memcpy", "CatArray", "cat_")),
           ("elementwise", ("elementwise", "vectorized", "Elementwise")))


def by_class(by_kernel) -> dict:
    """Device us by `CLASSES` (the rest as "other")."""
    out = {name: 0.0 for name, _ in CLASSES}
    out["other"] = 0.0
    for kernel, us in by_kernel.items():
        cls = next((name for name, keys in CLASSES
                    if any(k in kernel for k in keys)), "other")
        out[cls] += us
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--pp", type=int, default=1)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = single_stage(get_config(args.arch))
    if args.layers:
        cfg = dataclasses.replace(
            cfg, num_layers=args.layers,
            pattern=(BlockSpec(cfg.pattern[0].kind, args.layers),))
    if args.pp > 1:
        cfg = stage_config(cfg, args.pp)
    params = init_params(cfg, 0, dtype=torch.bfloat16,
                         device="cuda").trainable()
    opt = adam_init(params)
    step = build_train_step(cfg, adam=AdamConfig(lr=args.lr), device="cuda")
    data = batches(cfg.vocab_size, 2, 1, args.seq, seed=0)

    def run(n: int) -> float:
        nonlocal params, opt
        t0 = time.perf_counter()
        for _ in range(n):
            params, opt, m = step(params, opt, next(data))
        float(m["loss"])
        return (time.perf_counter() - t0) * 1e3 / n

    run(3)
    wall_ms = run(2)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(2)
    busy_us, by_kernel = device_time(prof)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    busy_ms = busy_us / 2e3
    print(json.dumps({
        "arch": cfg.name, "layers": cfg.num_layers, "pp": cfg.plan.pp,
        "seq": args.seq, "lr": args.lr,
        "nvidia_smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(),
        "wall_ms_per_step": wall_ms, "busy_ms_per_step": busy_ms,
        "idle_share": 1 - busy_ms / wall_ms,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "class_ms_per_step": {k: us / 2e3 for k, us in
                              by_class(by_kernel).items()},
        "top_kernels_ms_per_step": [[name[:120], us / 2e3]
                                    for name, us in top]}), flush=True)


if __name__ == "__main__":
    main()
