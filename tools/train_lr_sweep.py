#!/usr/bin/env python3
"""Adam's rate against the weights' dtype: the port's train launcher
(`repro_torch.launch.train.train`) on one arch at full width and depth,
once per (dtype, lr), from random weights of seed 0 and the same
`SyntheticLM` batches.

    python3 tools/train_lr_sweep.py [--arch qwen1.5-0.5b] [--seq 4096]
        [--steps 30] [--lrs 1e-3,1e-4] [--dtypes float32,bfloat16]

Run from the repository root on a machine with one CUDA card and ``nvcc``;
f32 runs with TF32 off.  A loss that rises at a rate in both dtypes is
Adam at that rate; one that rises in bf16 only points at the bf16 path
(bf16 weights updated in place with no f32 master copy, as in the JAX
package).  Prints one JSON line per run (the loss and gradient norm of
every step, the median ms a step over the steps after the fifth), then the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.serve import serve_config  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--lrs", default="1e-3,1e-4")
    ap.add_argument("--dtypes", default="float32,bfloat16")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg, _ = serve_config(args.arch)
    for dtype in args.dtypes.split(","):
        for lr in map(float, args.lrs.split(",")):
            torch.cuda.reset_peak_memory_stats()
            run = train(dataclasses.replace(cfg, dtype=dtype),
                        steps=args.steps, seq=args.seq, lr=lr, device="cuda")
            steps = sorted(run["step_s"][5:])
            print(json.dumps({
                "arch": cfg.name, "layers": cfg.num_layers, "dtype": dtype,
                "lr": lr, "seq": args.seq, "loss": run["loss"],
                "gnorm": run["gnorm"],
                "median_ms_per_step": steps[len(steps) // 2] * 1e3,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}),
                flush=True)
            del run
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
