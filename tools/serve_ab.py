#!/usr/bin/env python3
"""Time chip_smoke's serve-bf16 batch on the bucketed async graph engine
(engine-direct, `build_engine`) of the port found under a given ``src``
directory, so that two trees can be compared in one call on one card:

    git archive <parent> | tar -x -C build/parent
    for s in build/parent/src src src build/parent/src; do
        python3 tools/serve_ab.py $s; done

Run from the repository root on a machine with one NVIDIA H100 and
``nvcc``; each tree builds its kernels under its own ``build/``.  The batch
is chip_smoke.py's (32 requests, prompts 16-1500 tokens from seed 12, 16
new tokens each, every eighth at temperature 0.8), served once to warm up
and then four times.  Prints one JSON line: per serve the wall time, ticks,
ms per tick and host ms per tick, and where the backend has `_on_stream`,
the host cost of entering and leaving it.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch


def main() -> None:
    src = sys.argv[1]
    sys.path.insert(0, src)
    from repro_torch.core import SamplingParams
    from repro_torch.launch.serve import build_engine

    torch.backends.cuda.matmul.allow_tf32 = False
    eng = build_engine("qwen1.5-0.5b", device="cuda", dtype=torch.bfloat16,
                       bucketed=True, async_dispatch=True)
    rng = np.random.default_rng(12)
    lens = [int(x) for x in rng.integers(16, 1501, 32)]
    lens[0], lens[1] = 16, 1500
    prompts = [[int(t) for t in rng.integers(0, eng.cfg.vocab_size, n)]
               for n in lens]

    def serve() -> None:
        for i, p in enumerate(prompts):
            eng.add_request(p, SamplingParams(
                max_new_tokens=16, temperature=0.8 if i % 8 == 7 else 0.0))
        eng.drain()
        torch.cuda.synchronize()

    serve()
    runs = []
    for _ in range(4):
        st = eng.stats
        ticks, host = st.ticks, st.host_s
        t0 = time.perf_counter()
        serve()
        wall = time.perf_counter() - t0
        n = st.ticks - ticks
        runs.append({"wall_s": wall, "ticks": n,
                     "ms_per_tick": wall / n * 1e3,
                     "host_ms_per_tick": (st.host_s - host) / n * 1e3})
    out = {"src": src, "device": torch.cuda.get_device_name(0),
           "runs": runs}
    enter = getattr(eng.backend, "_on_stream", None)
    if enter is not None:
        calls = 20000
        t0 = time.perf_counter()
        for _ in range(calls):
            with enter():
                pass
        out["on_stream_us"] = (time.perf_counter() - t0) / calls * 1e6
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
