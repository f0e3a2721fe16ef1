"""Training launcher of the port (``repro.launch.train``): the GPipe train
step with Adam on one device, async checkpointing and restart.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --full --seq 4096 --steps 30 [--ckpt DIR --resume] [--pp 4]

Without ``--full`` it trains the reduced f32 config (``--device cpu`` runs
it on the CPU, through the kernels' plain versions); with it, the published
config in its dtype, folded to one stage (`configs.single_stage`) or staged
in ``--pp`` stages on the one card.  Each step takes M = 2 micro-batches of
one sequence of ``--seq`` tokens from `data.tokens.batches` (the JAX
launcher's one data rank); vlm and audio configs get zero frontend rows
(``embeds``), an encoder-decoder an encoder half of ``--seq // 2``.  A
checkpoint holds the parameters (`runtime.checkpoint`, the JAX package's
layout); ``--resume`` restarts from it with fresh Adam moments, as the JAX
launcher does.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.data.tokens import batches
from repro_torch.distributed.optimizer import AdamConfig, adam_init
from repro_torch.distributed.pipeline import build_train_step
from repro_torch.launch.serve import build_params, serve_config
from repro_torch.models.transformer import abstract_params
from repro_torch.runtime.checkpoint import (
    AsyncCheckpointer,
    restore_checkpoint,
)
from repro_torch.runtime.engine import resolve_device

M, MBG = 2, 1          # micro-batches a step, sequences each


def train(cfg, *, steps: int, seq: int, lr: float = 1e-3,
          ckpt: Optional[str] = None, ckpt_every: int = 25,
          resume: bool = False, grad_compression: Optional[str] = None,
          device: Optional[torch.device | str] = None) -> dict:
    """Train `cfg` for `steps` steps from random weights (seed 0) or the
    checkpoint.  Returns {"loss", "gnorm", "step_s" (per step, host wall
    time to the loss's readback), "params", "tokens_per_step",
    "resumed"}."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    ew = seq // 2 if cfg.is_encoder_decoder else 0
    step = build_train_step(cfg, adam=AdamConfig(lr=lr), enc_width=ew,
                            grad_compression=grad_compression, device=dev)
    resumed = bool(resume and ckpt and os.path.exists(
        os.path.join(ckpt, "manifest.json")))
    if resumed:
        params = restore_checkpoint(ckpt, abstract_params(cfg, dtype),
                                    device=dev)
        print(f"resumed from {ckpt}")
    else:
        params = build_params(cfg, dtype, dev)
    params = params.trainable()
    opt = adam_init(params)
    ck = AsyncCheckpointer() if ckpt else None
    data = batches(cfg.vocab_size, M, MBG, seq, seed=0)
    out = {"loss": [], "gnorm": [], "step_s": [], "resumed": resumed,
           "tokens_per_step": M * MBG * seq}
    t0 = time.perf_counter()
    for i in range(steps):
        ts = time.perf_counter()
        b = next(data)
        if cfg.family in ("vlm", "audio"):
            b["embeds"] = np.zeros((M, MBG, max(ew, 4), cfg.d_model),
                                   np.float32)
        params, opt, m = step(params, opt, b)
        loss, gnorm = float(m["loss"]), float(m["gnorm"])
        out["step_s"].append(time.perf_counter() - ts)
        out["loss"].append(loss)
        out["gnorm"].append(gnorm)
        if i % 10 == 0 or i == steps - 1:
            print(f"step {i:4d} loss={loss:.4f} gnorm={gnorm:.3f} "
                  f"({(i + 1) / (time.perf_counter() - t0):.2f} it/s)",
                  flush=True)
        if ck and i % ckpt_every == ckpt_every - 1:
            ck.submit(ckpt, params, extra={"step": i})
    if ck:
        ck.wait()
        ck.close()
        print(f"checkpointed to {ckpt}")
    out["params"] = params
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-compression", default=None,
                    choices=[None, "int8", "ring8"])
    ap.add_argument("--full", action="store_true",
                    help="the published config in its dtype (default: the "
                    "reduced f32 config)")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline stages on the one device")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg, _ = serve_config(args.arch, reduced=not args.full, pp=args.pp)
    return train(cfg, steps=args.steps, seq=args.seq, lr=args.lr,
                 ckpt=args.ckpt, ckpt_every=args.ckpt_every,
                 resume=args.resume, grad_compression=args.grad_compression,
                 device=args.device)


if __name__ == "__main__":
    main()
