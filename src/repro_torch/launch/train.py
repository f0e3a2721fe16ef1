"""Training launcher of the port (``repro.launch.train``): the GPipe train
step with Adam on one device, async checkpointing and restart.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --full --seq 4096 --steps 30 [--ckpt DIR --resume] [--pp 4]

``--dp D --tp T`` trains over D x pp x T processes (`train_rank`,
`launch.ranks`; gloo on the CPU and on a shared card; kimi-k2's and
jamba's experts split over the D data ranks), and so does ``--pp`` alone
when every stage has a card of its own (`mesh.use_ranks`); ``--ckpt`` saves
the whole tree across the ranks in the same files as one process, and
``--resume`` restarts from one saved at any ``--dp``/``--tp`` (or in one
process), at the same ``--pp``:

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --steps 4 --dp 2 --pp 2 --tp 2

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
from repro_torch.launch.serve import (
    add_rank_arguments,
    build_params,
    rank_launch,
    ranks_asked,
    serve_config,
)
from repro_torch.models.transformer import abstract_params, tree_items
from repro_torch.runtime.checkpoint import (
    AsyncCheckpointer,
    leaf_digest,
    restore_checkpoint,
)
from repro_torch.runtime.engine import resolve_device

M, MBG = 2, 1          # micro-batches a step, sequences each


def train(cfg, *, steps: int, seq: int, lr: float = 1e-3,
          ckpt: Optional[str] = None, ckpt_every: int = 25,
          resume: bool = False, grad_compression: Optional[str] = None,
          device: Optional[torch.device | str] = None,
          remat: str = "full") -> dict:
    """Train `cfg` for `steps` steps from random weights (seed 0) or the
    checkpoint.  Returns {"loss", "gnorm", "step_s" (per step, host wall
    time to the loss's readback), "params", "tokens_per_step",
    "resumed"}."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    ew = seq // 2 if cfg.is_encoder_decoder else 0
    step = build_train_step(cfg, adam=AdamConfig(lr=lr), enc_width=ew,
                            grad_compression=grad_compression, device=dev,
                            remat=remat)
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


def train_rank(ranks, job: dict) -> dict:
    """One rank of a training run (`launch.ranks.spawn`'s `fn`).  `job`:
    ``cfg`` (at pp = the layout's stages), ``steps``, ``batches`` (a list of
    batches, taken in turn) or ``seq`` (then `data.tokens.batches` of ``M``
    micro-batches of ``mbg`` sequences, with zero frontend rows for a vlm or
    audio config, as `train` makes them), ``lr``, optional
    ``grad_compression``, ``remat`` (`build_train_step`), ``aux_coef``, ``enc_width`` (an encoder-decoder's
    encoder half), ``device``, ``dtype``, ``seed`` or ``npz``
    (`launch.serve.rank_params`), ``keep`` (a step count: return the shard's
    leaves after that many steps, as numpy), ``digest`` (a step count: their
    `checkpoint.leaf_digest`s then), ``ckpt`` (a directory: the whole tree
    is saved there across the ranks, `checkpoint.AsyncCheckpointer(ranks=)`,
    every ``ckpt_every`` steps, by default after the last), ``resume``
    (restart from ``ckpt``'s parameters, saved at any data or tensor
    factoring, `elastic.rank_restore`, with fresh Adam moments, as `train`
    does).  Returns the per-step loss, gnorm and seconds, the seconds the
    shard took to draw (or to restore), whether it resumed, the seconds and
    bytes of its checkpoint writes (``ckpt_s``, ``ckpt_bytes``: its own
    blocks), the traffic, the kernels' launches over the steps and peak
    memory."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import rank_device
    from repro_torch.launch.serve import rank_params

    cfg = job["cfg"]
    dtype = getattr(torch, job.get("dtype", cfg.dtype))
    cuda = job.get("device", "cuda") == "cuda"
    dev = torch.device(rank_device(
        ranks.rank, "cuda" if cuda else "cpu",
        torch.cuda.device_count() if cuda else 0))
    if cuda:
        torch.cuda.set_device(dev)
    ckpt = job.get("ckpt")
    resumed = bool(job.get("resume") and ckpt and os.path.exists(
        os.path.join(ckpt, "manifest.json")))
    t0 = time.perf_counter()
    if resumed:
        from repro_torch.distributed.elastic import rank_restore
        params = rank_restore(ckpt, cfg, ranks.layout, ranks.rank,
                              device=dev, dtype=dtype)
    else:
        params = rank_params(cfg, ranks, dtype=dtype, device=dev,
                             seed=job.get("seed", 0), npz=job.get("npz"))
    params = params.trainable()
    params_s = time.perf_counter() - t0
    opt = adam_init(params)
    ew = job.get("enc_width", 0)
    step = build_train_step(
        cfg, adam=AdamConfig(lr=job.get("lr", 1e-3)),
        aux_coef=job.get("aux_coef", 0.01), enc_width=ew,
        grad_compression=job.get("grad_compression"), device=dev,
        ranks=ranks, remat=job.get("remat", "full"))
    if "batches" in job:
        data = iter(job["batches"])
    else:
        m, mbg = job.get("M", M), job.get("mbg", 2)
        data = batches(cfg.vocab_size, m, mbg, job["seq"], seed=0)
        if cfg.family in ("vlm", "audio"):
            rows = np.zeros((m, mbg, max(ew, 4), cfg.d_model), np.float32)
            data = ({**b, "embeds": rows} for b in data)
    coll.TRAFFIC.reset()
    for mod in ops.COUNTED:
        mod.launches = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    out = {"rank": ranks.rank, "coords": ranks.coords, "loss": [],
           "gnorm": [], "step_s": [], "params_s": params_s,
           "resumed": resumed, "ckpt_s": 0.0}
    ck = AsyncCheckpointer(ranks=ranks, cfg=cfg) if ckpt else None
    every = job.get("ckpt_every", job["steps"])
    for i in range(job["steps"]):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, next(data))
        out["loss"].append(float(m["loss"]))
        out["gnorm"].append(float(m["gnorm"]))
        out["step_s"].append(time.perf_counter() - t0)
        if job.get("keep") == i + 1:
            out["params"] = {k: t.detach().float().cpu().numpy().copy()
                             for k, t in tree_items(params)}
        if job.get("digest") == i + 1:
            out["digests"] = {k: leaf_digest(t)
                              for k, t in tree_items(params)}
        if ck and i % every == every - 1:
            t0 = time.perf_counter()
            ck.submit(ckpt, params, extra={"step": i})
            out["ckpt_s"] += time.perf_counter() - t0
    if ck:
        t0 = time.perf_counter()
        ck.wait()
        ck.close()
        out["ckpt_s"] += time.perf_counter() - t0
        out["ckpt_bytes"] = _own_bytes(cfg, params, ranks)
    out["traffic"] = coll.TRAFFIC.snapshot()
    out["launches"] = {m.__name__.split(".")[-1]: m.launches
                       for m in ops.COUNTED}
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if cuda \
        else None
    out["weight_bytes"] = sum(t.numel() * t.element_size()
                              for t in params.parameters())
    return out


def _own_bytes(cfg, params, ranks) -> int:
    """The bytes of the blocks this rank writes to a checkpoint."""
    from repro_torch.models.transformer import param_pspecs
    from repro_torch.runtime.checkpoint import writes_block

    specs = dict(tree_items(param_pspecs(cfg)))
    return sum(t.numel() * t.element_size()
               for k, t in tree_items(params)
               if writes_block(specs[k], ranks.layout, ranks.rank))


def _train_ranks(cfg, args) -> Optional[dict]:
    """The launcher's run over dp x pp x tp ranks (`train_rank`): M = 2
    micro-batches of dp sequences a step, one a data rank; an MoE model
    whose plan sets ``ep_over_data`` (kimi-k2, jamba) splits its experts
    over the dp ranks (expert parallelism)."""
    from repro_torch.launch.mesh import rank_layout

    dev = resolve_device(args.device)
    cfg = cfg.with_plan(tp=args.tp)
    layout = rank_layout(args.dp, args.pp, args.tp)
    job = dict(cfg=cfg, steps=args.steps, seq=args.seq, M=M, mbg=args.dp,
               lr=args.lr, grad_compression=args.grad_compression,
               enc_width=args.seq // 2 if cfg.is_encoder_decoder else 0,
               device=dev.type, ckpt=args.ckpt, ckpt_every=args.ckpt_every,
               resume=args.resume, remat=args.remat)
    out = rank_launch(train_rank, layout, job, args)
    if out is None:
        return None
    head = out[0]
    if head["resumed"]:
        print(f"resumed from {args.ckpt}")
    for i, (loss, gnorm) in enumerate(zip(head["loss"], head["gnorm"])):
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={loss:.4f} gnorm={gnorm:.3f}")
    print(f"[{cfg.name} | {dev.type} {cfg.dtype}] ranks={layout.world} "
          f"(dp={args.dp} pp={args.pp} tp={args.tp})", flush=True)
    if args.ckpt:
        print(f"checkpointed to {args.ckpt}")
    return head


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
    ap.add_argument("--remat", default="full", choices=["full", "dots"],
                    help="recompute in backward: every layer whole (full) "
                    "or all but its weight GEMMs' outputs (dots)")
    ap.add_argument("--full", action="store_true",
                    help="the published config in its dtype (default: the "
                    "reduced f32 config)")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline stages: one process each with a card "
                    "each or with --tp / --dp, else on the one device")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel ranks (one process each)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    add_rank_arguments(ap)
    args = ap.parse_args(argv)
    cfg, _ = serve_config(args.arch, reduced=not args.full, pp=args.pp)
    if ranks_asked(args, args.dp):
        return _train_ranks(cfg, args)
    return train(cfg, steps=args.steps, seq=args.seq, lr=args.lr,
                 ckpt=args.ckpt, ckpt_every=args.ckpt_every,
                 resume=args.resume, grad_compression=args.grad_compression,
                 device=args.device, remat=args.remat)


if __name__ == "__main__":
    main()
