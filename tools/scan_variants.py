#!/usr/bin/env python3
"""Time variants of the port's WKV6 and Mamba scan kernels on one NVIDIA
H100.

    python3 tools/scan_variants.py [--shapes "rwkv6-3b prefill,jamba prefill"]

Run from the repository root on a machine with the card and ``nvcc``.
Each variant is ``src/repro_torch/kernels/csrc/rwkv6_scan.cu`` or
``mamba_scan.cu`` with one text substitution, built under a name of its
own and launched through the module's ``launch`` at chip_smoke.py's kernel
shapes (its `_rwkv_case` / `_mamba_case` inputs, seed 7).  For every
(shape, dtype, variant) one JSON line: the call's time (CUDA events over 20
calls, chip_smoke's `time_ms`), the device time and grid of each of its
launches (a torch.profiler trace of 5 calls), the check's excess against
the plain version, and the bound beside.  The variants:

  base           the source as it is
  recurrent      T > 1 sent to the recurrent kernel (the recurrent-only form)
  tf32_single    WKV's chunked products as one TF32 product (not a
                 candidate: it fails the f32 check; its time says what the
                 split costs)
  mamba_bounds2  the segmented Mamba kernel at __launch_bounds__(256, 2)
                 (128 registers, 16 warps an SM) in place of 3 (80
                 registers, 24 warps)
  mamba_bounds4  the same at __launch_bounds__(256, 4) (64 registers, 32
                 warps)
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import mamba_scan as s6  # noqa: E402
from repro_torch.kernels import rwkv6_scan as wkv  # noqa: E402

BOUNDS3 = "__global__ void __launch_bounds__(kSegThreads, 3)"
BOUNDS2 = "__global__ void __launch_bounds__(kSegThreads, 2)"
BOUNDS4 = "__global__ void __launch_bounds__(kSegThreads, 4)"

# name -> (kernel source, [(text, replacement)])
VARIANTS = {
    "rwkv6_scan_base": ("rwkv6_scan", []),
    "rwkv6_scan_recurrent": ("rwkv6_scan", [
        (cs.RWKV_DISPATCH, "bool chunked(int T) {\n  return false;\n}")]),
    "rwkv6_scan_tf32_single": ("rwkv6_scan", [(cs.MOE_TF32_MARK, "")]),
    "mamba_scan_base": ("mamba_scan", []),
    "mamba_scan_recurrent": ("mamba_scan", [
        (cs.MAMBA_DISPATCH, "bool segmented(int T) {\n  return false;\n}")]),
    "mamba_scan_bounds2": ("mamba_scan", [(BOUNDS3, BOUNDS2)]),
    "mamba_scan_bounds4": ("mamba_scan", [(BOUNDS3, BOUNDS4)]),
}

SHAPES = {  # name: (kernel, case arguments, decay or dt range)
    "rwkv6-3b prefill": ("rwkv6_scan", (1, 512, 40, [300], [0], 64),
                         cs.RWKV_DECAY),
    "rwkv6-3b decode": ("rwkv6_scan", (32, 1, 40, [1] * 28 + [0] * 4,
                                       [0] * 32, 64), cs.RWKV_DECAY),
    "small ragged wkv": ("rwkv6_scan", (3, 70, 2, [70, 33, 0], [1, 0, 0], 4),
                         cs.RWKV_DECAY),
    "jamba prefill": ("mamba_scan", (1, 512, 16384, 16, [300], [0], 64),
                      cs.MAMBA_DT),
    "jamba decode": ("mamba_scan", (32, 1, 16384, 16, [1] * 28 + [0] * 4,
                                    [0] * 32, 64), cs.MAMBA_DT),
    "small ragged mamba": ("mamba_scan", (3, 70, 200, 16, [70, 33, 0],
                                          [1, 0, 0], 4), cs.MAMBA_DT),
}


def variant_source(kernel: str, subs) -> str:
    text = (build.CSRC / f"{kernel}.cu").read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise AssertionError(f"variant text no longer in {kernel}.cu: "
                                 f"{old[:60]!r}")
        text = text.replace(old, new)
    return text


def per_launch(fn, calls: int = 5) -> dict:
    """Mean device time (us) and grid of each of the call's launches."""
    out = {}
    for a, b, name, grid in cs._device_spans(fn, calls):
        if "(anonymous namespace)::" not in name:
            continue
        key = name.split("::")[1].split("(")[0]
        d = out.setdefault(key, {"us": 0.0, "n": 0, "grid": grid})
        d["us"] += b - a
        d["n"] += 1
    return {k: {"us": v["us"] / v["n"], "grid": v["grid"]}
            for k, v in out.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default=",".join(SHAPES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_variants: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    sources = {name: variant_source(kernel, subs)
               for name, (kernel, subs) in VARIANTS.items()}
    build.build_all(list(sources), sources)
    for shape in args.shapes.split(","):
        kernel, case, spread = SHAPES[shape]
        mod = wkv if kernel == "rwkv6_scan" else s6
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            if mod is wkv:
                inputs = cs._rwkv_case(*case, dtype, seed=7, decay=spread)
                bound = cs._rwkv_bound(inputs[0], inputs[7], inputs[8])[0]
            else:
                inputs = cs._mamba_case(*case, dtype, seed=7,
                                        dt_range=spread)
                bound = cs._mamba_bound(inputs[1], inputs[4], inputs[7],
                                        inputs[8])[0]
            before = inputs[5]
            for name, (vk, _) in VARIANTS.items():
                if vk != kernel:
                    continue
                state = before.clone()

                def fn():
                    return mod.launch(name, *inputs[:5], state, *inputs[6:],
                                      source=sources[name])
                out = fn()
                torch.cuda.synchronize()
                row = {"shape": shape, "dtype": dt,
                       "variant": name.split("_", 2)[-1],
                       "excess": mod.excess(out, state, *inputs[:5], before,
                                            *inputs[6:])[0],
                       "ms": cs.time_ms(fn, 20), "launches": per_launch(fn),
                       "bound_ms": bound}
                print(json.dumps(row), flush=True)
                del out, state
            del inputs, before
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
