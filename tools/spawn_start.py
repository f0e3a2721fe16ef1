#!/usr/bin/env python3
"""Time how long a layout of ranks takes to start: the seconds from the
launch to each rank's entry into its function, with a small argument and
with a served batch's prompts (chip_smoke.py's serve-bf16 batch: 32 prompts
of 16-1,500 tokens, ~90 KiB pickled), through `launch.ranks.spawn` and
through `torch.multiprocessing.start_processes` handing the same call to
each process as its argument (through the pipe each process starts from):

    python3 tools/spawn_start.py [world] [device]

Run from the repository root; `world` ranks (default 4) under gloo,
`device` "cuda" (default: each rank makes one tensor on the card before it
reports) or "cpu".  Prints one JSON line per launch: its route, the
argument, the seconds to each rank's entry and to the launch's return.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import ranks as rk  # noqa: E402
from repro_torch.launch.mesh import rank_layout  # noqa: E402


def entered(ranks, job) -> float:
    """`spawn`'s fn: the wall clock at entry, after one tensor on the
    rank's device."""
    t = time.time()
    torch.ones(4, device=job["device"]).sum().item()
    return t


def _piped(rank, job, out) -> None:
    """A rank started with the call as its argument: its entry time."""
    t = time.time()
    torch.ones(4, device=job["device"]).sum().item()
    with open(os.path.join(out, f"t-{rank}"), "w") as f:
        f.write(repr(t))


def prompts(seed: int = 12, n: int = 32, vocab: int = 151936) -> list:
    rng = np.random.default_rng(seed)
    lens = [int(x) for x in rng.integers(16, 1501, n)]
    lens[0], lens[1] = 16, 1500
    return [[int(t) for t in rng.integers(0, vocab, L)] for L in lens]


def main() -> int:
    world = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    device = sys.argv[2] if len(sys.argv) > 2 else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        print("spawn_start: no CUDA device", file=sys.stderr)
        return 1
    layout = rank_layout(1, 1, world)
    scratch = Path(__file__).resolve().parents[1] / "build"
    scratch.mkdir(exist_ok=True)
    for name, extra in (("small", None), ("batch", prompts())):
        job = {"device": device, "prompts": extra}
        for route in ("spawn", "pipe"):
            store = tempfile.mkdtemp(prefix="spawn-start-", dir=scratch)
            t0 = time.time()
            if route == "spawn":
                ts = rk.spawn(entered, layout, (job,), store_dir=store,
                              threads=1, timeout_s=300)
            else:
                torch.multiprocessing.start_processes(
                    _piped, args=(job, store), nprocs=world,
                    start_method="spawn")
                ts = [float(open(os.path.join(store, f"t-{r}")).read())
                      for r in range(world)]
            done = time.time() - t0
            shutil.rmtree(store, ignore_errors=True)
            print(json.dumps({"route": route, "argument": name,
                              "world": world, "device": device,
                              "entry_s": [round(t - t0, 3) for t in ts],
                              "launch_s": round(done, 3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
