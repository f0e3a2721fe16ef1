#!/usr/bin/env python3
"""Time variants of the port's fused-MoE kernel on one NVIDIA H100.

    python3 tools/moe_variants.py [--shapes "olmoe serve,jamba serve"]

Run from the repository root on a machine with the card and ``nvcc``.
Each variant is ``src/repro_torch/kernels/csrc/moe_ffn.cu`` with one text
substitution, built under a name of its own and launched through
``moe_gemm.launch`` at chip_smoke.py's moe-kernel shapes (its `_moe_case`
inputs, seed 7).  For every (shape, variant) one JSON line: the call's time
(CUDA events over 10 calls, chip_smoke's `time_ms`), the device time of its
gate/up and down launches and their grids (a torch.profiler trace of 5
calls), the check's excess against the plain version, and the torch.bmm
sequence's time and the bound beside.  The variants:

  base             the source as it is
  no_products      the consumers wait for each stage and release it
                   without a product or an epilogue (bf16: what the TMA
                   ring streams alone; the output is not checked)
  release_cluster  the peer's ring slot released with
                   mbarrier.arrive.release.cluster (compiles to a GPU-scope
                   MEMBAR on every stage)
  stages3          a ring of 3 stages in place of 4
  evict_first      the weight copies carry an L2 evict-first hint
  cvt_rna          split TF32 formed with cvt.rna.tf32.f32 (f32 shapes)

It also counts ``MEMBAR.ALL.GPU`` in each variant's SASS (cuobjdump).
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import moe_gemm as mg  # noqa: E402

TMA_LOAD = '''      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\\n" ::"r"(smem_u32(dst)),'''
TMA_LOAD_EVICT_FIRST = '''      "{\\n.reg .b64 pol;\\n"
      "createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\\n"
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%3, %4, %5}], [%2], pol;\\n}\\n" ::"r"(smem_u32(dst)),'''
SPLIT = '''  hi = __float_as_uint(v) + 0x1000u;
  lo = __float_as_uint(v - __uint_as_float(hi & 0xffffe000u)) + 0x1000u;'''
SPLIT_CVT = '''  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(v - __uint_as_float(hi)));'''

# name -> (dtypes it applies to, [(text, replacement)])
VARIANTS = {
    "base": (("bfloat16", "float32"), []),
    "no_products": (("bfloat16",), [
        ("const bool idle = t.ghost || col0 >= ncols;",
         "const bool idle = true;")]),
    "release_cluster": (("bfloat16",), [
        ("mbarrier.arrive.shared::cluster.b64 _, [%0];",
         "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];")]),
    "stages3": (("bfloat16",), [
        ("constexpr int kStages = 4;", "constexpr int kStages = 3;")]),
    "evict_first": (("bfloat16",), [(TMA_LOAD, TMA_LOAD_EVICT_FIRST)]),
    "cvt_rna": (("float32",), [(SPLIT, SPLIT_CVT)]),
}

SHAPES = {  # name: (E, C, d, ff, decode-tick top_k, dtypes)
    "olmoe serve": (64, 88, 2048, 1024, 0, ("bfloat16", "float32")),
    "olmoe decode tick": (64, 88, 2048, 1024, 8, ("bfloat16", "float32")),
    "small": (8, 16, 256, 256, 0, ("bfloat16", "float32")),
    "jamba serve": (16, 88, 8192, 24576, 0, ("bfloat16",)),
    "jamba decode tick": (16, 88, 8192, 24576, 2, ("bfloat16",)),
}


def variant_source(base: str, subs) -> str:
    for old, new in subs:
        if base.count(old) != 1:
            raise AssertionError(f"variant text no longer in moe_ffn.cu: "
                                 f"{old[:60]!r}")
        base = base.replace(old, new)
    return base


def per_launch(fn, calls: int = 5) -> dict:
    """Mean device time (us) and grid of each of the kernel's launches."""
    out = {}
    for a, b, name, grid in cs._device_spans(fn, calls):
        if "(anonymous namespace)::moe_" not in name:
            continue
        key = name.split("::")[1].split("(")[0]
        d = out.setdefault(key, {"us": 0.0, "n": 0, "grid": grid})
        d["us"] += b - a
        d["n"] += 1
    return {k: {"us": v["us"] / v["n"], "grid": v["grid"]}
            for k, v in out.items()}


def membar_gpu(name: str, source: str):
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = build._target(name, source.encode())
    try:
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, timeout=120, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return sass.count("MEMBAR.ALL.GPU")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default=",".join(SHAPES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("moe_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    base = (build.CSRC / "moe_ffn.cu").read_text()
    sources = {f"moe_ffn_{v}": variant_source(base, subs)
               for v, (_, subs) in VARIANTS.items()}
    build.build_all(list(sources), sources)
    print(json.dumps({"membar_all_gpu": {n: membar_gpu(n, s)
                                         for n, s in sources.items()}}),
          flush=True)
    for shape in args.shapes.split(","):
        E, C, d, ff, top_k, dtypes = SHAPES[shape]
        for dt in dtypes:
            inputs = cs._moe_case(E, C, d, ff, getattr(torch, dt), seed=7,
                                  top_k=top_k)
            for v, (applies, _) in VARIANTS.items():
                if dt not in applies:
                    continue
                name = f"moe_ffn_{v}"

                def fn():
                    return mg.launch(name, *inputs, source=sources[name])
                row = {"shape": shape, "dtype": dt, "variant": v}
                if v != "no_products":
                    out = fn()
                    torch.cuda.synchronize()
                    row["excess"] = cs._moe_excess(mg, out, inputs)[0]
                    del out
                row["ms"] = cs.time_ms(fn, 10)
                row["launches"] = per_launch(fn)
                print(json.dumps(row), flush=True)
            print(json.dumps({
                "shape": shape, "dtype": dt, "variant": "torch.bmm sequence",
                "ms": cs.time_ms(cs._moe_library_fn(*inputs), 10),
                "bound_ms": cs._moe_bound(*inputs)[0]}), flush=True)
            del inputs
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
