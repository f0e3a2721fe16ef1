"""Serving launcher of the port (``repro.launch.serve``).

On the card it builds the published width and depth of the arch (folded to
one stage by `single_stage` unless ``--pp`` asks for more, bf16, random
weights from `--seed`):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --requests 16 --max-new 16

``--reduced --device cpu`` runs the same path on the CPU at a tiny width,
through the kernels' plain versions.  A model whose weights do not fit the
card is served as a depth cut, the first layer of each named block kind
(`configs.cut_to_kinds`); jamba-1.5-large-398b at full width is 870 GB in
bf16, its cut to one layer of each kind 44 GB:

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch jamba-1.5-large-398b --cut mamba_mlp,mamba_moe,attn_moe

``--pp S`` serves the model in S pipeline stages on the one card, S
micro-batches in flight (Token Throttling at depth S): qwen2.5-14b, the
paper's model, at full width and depth in four stages of 12 layers:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \
        --pp 4 --bucketed --async

On the card every tick replays a CUDA graph (``--eager`` runs it eagerly);
``--bucketed`` serves the bucket ladder, ``--async`` overlaps the host's
work on tick N+1 with tick N on the device:

    PYTHONPATH=src python -m repro_torch.launch.serve --bucketed --async

Every flag combination is one `ServeSpec` (the JAX launcher's format),
served by `repro_torch.serving.build`: ``--dump-spec`` prints it,
``--spec FILE`` serves a dumped one.  ``--replicas N`` puts N engines, which
share one set of weights, behind the balanced `ReplicaRouter`;
``--rebalance-interval`` runs its control plane and ``--migrate`` lets it
live-migrate running requests with their KV and state.  ``--http PORT``
serves the spec over HTTP instead of running the synthetic workload:

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --device cpu --replicas 2 --route balanced \
        --rebalance-interval 0.05 --migrate
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --device cpu --http 0

Over ranks (``--tp`` or ``--dp`` > 1, or ``--pp`` with a card a stage)
the same spec is served by rank engines (`serving.build(spec, ranks=)`):
``--replicas N`` puts N engines on the one layout of ranks behind the
router, and ``--http`` serves them while the worker ranks wait:

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --device cpu --pp 2 --tp 2 --replicas 2 --http 0

``--trace-out PATH`` records a replayable tick trace of the run (the JAX
package's schema; per replica PATH.replicaN and PATH.router with
``--replicas N``; traced engines are synchronous, so it refuses
``--async``).  ``--trace-replay PATH`` replays a recorded trace strictly
through the scheduler and builds no model, so it runs on any box:

    PYTHONPATH=src python -m repro_torch.launch.serve --bucketed \
        --trace-out serve.trace.jsonl
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --trace-replay serve.trace.jsonl

Every arch of the JAX registry serves: whisper-small (an encoder-decoder:
each request brings its encoder input, here seeded, ``Te`` = 1,500 frames),
minicpm3-4b (MLA), qwen2-vl-7b (M-RoPE), kimi-k2-1t-a32b (as a depth cut:
``--cut attn_moe``), and llama3.1-100b, whose 168 GB of bf16 weights the
card refuses whole:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \
        --reduced --device cpu --requests 3 --max-new 4

`serve_config`, `build_params` and `build_engine` are the entry points
`chip_smoke.py` and the tests call.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import (
    BlockKind,
    cut_to_depth,
    cut_to_kinds,
    get_config,
    make_reduced,
    single_stage,
    stage_config,
)
from repro_torch.core import SamplingParams, ThrottleConfig
from repro_torch.models.serve import ServeDims
from repro_torch.models.transformer import (
    init_params,
    leaf_parts,
    model_param_defs,
    param_pspecs,
    parted,
    shard_slices,
    tree_items,
)
from repro_torch.runtime.engine import PipelineEngine, resolve_device

# Full width on one H100: one prefill chunk of 512 tokens and 32 decode rows
# per tick, 2048 pages of 16 tokens (launch/shapes.py's page) per layer.
FULL_DIMS = ServeDims(Sp=1, C=512, Sd=32, pages=2048, page=16, Bp=128,
                      Bd=128, slots=64)
# Reduced mode: the JAX package's CPU-sized defaults (serving/build.py).
REDUCED_DIMS = ServeDims(Sp=1, C=32, Sd=8, pages=512, page=8, Bp=64, Bd=64,
                         slots=16)
# An encoder-decoder's encoder width: whisper's 1,500 frames (a 30-s
# window after the conv front end, which is a stub in both packages:
# requests bring their encoder input), or the JAX reduced build's 16.
ENC_FRAMES = 1500
REDUCED_ENC_FRAMES = 16
REDUCED_THROTTLE = dict(num_iters_T=4, max_prefill_tokens=32,
                        min_prefill_tokens=4)


def serve_dims(cfg, reduced: bool = False) -> ServeDims:
    """`FULL_DIMS` or `REDUCED_DIMS`, with the encoder width for an
    encoder-decoder."""
    dims = REDUCED_DIMS if reduced else FULL_DIMS
    if cfg.is_encoder_decoder:
        dims = dataclasses.replace(
            dims, Te=REDUCED_ENC_FRAMES if reduced else ENC_FRAMES)
    return dims


def enc_inputs(cfg, dims: ServeDims, rng: np.random.Generator):
    """Keyword arguments of a request's submission: a seeded encoder input
    [Te, d] (normal, scale 0.05, as the JAX launcher draws it) for an
    encoder-decoder, else none."""
    if not cfg.is_encoder_decoder:
        return {}
    return {"enc_embeds": (rng.normal(size=(dims.Te, cfg.d_model))
                           * 0.05).astype(np.float32)}


def weight_bytes(cfg, dtype: torch.dtype) -> int:
    """Bytes of `cfg`'s parameters in `dtype`."""
    def walk(tree) -> int:
        if isinstance(tree, tuple):
            return math.prod(tree[0])
        return sum(walk(v) for v in tree.values())
    return walk(model_param_defs(cfg)) * dtype.itemsize


def rank_weight_bytes(cfg, layout, rank: int, dtype: torch.dtype) -> int:
    """Bytes of rank `rank`'s shard of `cfg`'s parameters over `layout`
    (`launch.mesh.Layout`) in `dtype`: its stage's leaves at its tensor
    shard's widths."""
    specs = dict(tree_items(param_pspecs(cfg)))
    n = 0
    for path, (shape, _) in tree_items(model_param_defs(cfg)):
        vspec, vshape = parted(specs[path], shape, leaf_parts(path))
        n += math.prod(s.stop - s.start
                       for s in shard_slices(vspec, vshape, layout, rank))
    return n * dtype.itemsize


def serve_config(arch: str = "qwen1.5-0.5b", *, reduced: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 cut: Optional[Sequence[BlockKind]] = None,
                 reduced_overrides: Optional[dict] = None, pp: int = 1,
                 layers: int = 0):
    """(config, dtype) of the model `arch` serves: full width and depth in
    one stage (bf16 by default), or the reduced CPU-sized variant (f32,
    `make_reduced(**reduced_overrides)`).  `cut` names block kinds: the
    model is then cut in depth to the first layer of each
    (`cut_to_kinds`); `layers` > 0 cuts it to its first `layers` layers
    (`cut_to_depth`).  `pp` > 1 stages the model again in `pp` stages
    (`stage_config`): the folded depth for the published model, the
    reduced config's two stacked layers for the reduced one; a cut of
    several kinds, and a count that does not divide the stacked layers,
    raise `ValueError`."""
    cfg = get_config(arch)
    if reduced:
        cfg = make_reduced(cfg, **(reduced_overrides or {}))
        if pp == 1:
            cfg = cfg.with_plan(pp=1, tp=1)
        cfg = dataclasses.replace(cfg, dtype="float32")
    else:
        if reduced_overrides:
            raise ValueError("reduced_overrides only applies to reduced mode")
        cfg = single_stage(cfg)
    if cut:
        cfg = cut_to_kinds(cfg, cut)
    if layers:
        cfg = cut_to_depth(cfg, layers)
    if pp != cfg.plan.pp:
        cfg = stage_config(cfg, pp)
    dtype = dtype or getattr(torch, cfg.dtype)
    return dataclasses.replace(cfg, dtype=str(dtype).split(".")[-1]), dtype


def build_params(cfg, dtype: torch.dtype, device: torch.device,
                 seed: int = 0):
    """`cfg`'s random weights from `seed` on `device`: one read-only set
    that any number of engine replicas share.  On the card, weights that
    exceed its memory raise before anything is allocated."""
    if device.type == "cuda":
        need = weight_bytes(cfg, dtype)
        have = torch.cuda.get_device_properties(device).total_memory
        if need > have:
            raise ValueError(
                f"{cfg.name}: {cfg.num_layers} layers need {need:,} bytes "
                f"of {cfg.dtype} weights, more than the card's {have:,}; "
                f"serve a depth cut (cut=, --cut), e.g. one layer of each "
                f"block kind: {sorted({b.kind.value for b in cfg.pattern})}")
    return init_params(cfg, seed, dtype=dtype, device=device)


def build_engine(arch: str = "qwen1.5-0.5b", *, reduced: bool = False,
                 device: Optional[torch.device | str] = None,
                 dtype: Optional[torch.dtype] = None,
                 dims: Optional[ServeDims] = None,
                 throttle: Optional[ThrottleConfig] = None,
                 cut: Optional[Sequence[BlockKind]] = None,
                 seed: int = 0, bucketed: bool = False,
                 async_dispatch: bool = False,
                 cuda_graphs: bool = True, pp: int = 1) -> PipelineEngine:
    """A ready engine for `arch` (`serve_config`, `build_params`) at
    `FULL_DIMS`, or `REDUCED_DIMS` when `reduced` (`serve_dims`: with the
    encoder width for an encoder-decoder), in `pp` pipeline stages
    with Token Throttling at that depth.  `bucketed`, `async_dispatch` and
    `cuda_graphs` go to `PipelineEngine`."""
    dev = resolve_device(device)
    cfg, dtype = serve_config(arch, reduced=reduced, dtype=dtype, cut=cut,
                              pp=pp)
    dims = dims or serve_dims(cfg, reduced)
    if reduced:
        throttle = throttle or ThrottleConfig(pipeline_depth=pp,
                                              **REDUCED_THROTTLE)
    else:
        throttle = throttle or ThrottleConfig(pipeline_depth=pp)
    params = build_params(cfg, dtype, dev, seed)
    return PipelineEngine(cfg, dims, params, throttle, device=dev,
                          dtype=dtype, seed=seed, bucketed=bucketed,
                          async_dispatch=async_dispatch,
                          cuda_graphs=cuda_graphs)


# ----------------------------------------------------------------------------
# Serving across ranks
# ----------------------------------------------------------------------------

def rank_params(cfg, ranks, *, dtype: torch.dtype, device,
                seed: int = 0, npz: Optional[str] = None):
    """The rank's shard: drawn from `seed` as `init_params` draws the whole
    tree (`init_params(layout=)`), or cut from the numpy tree saved at
    `npz` (``/``-joined paths, `convert.shard_from_numpy`).  On the card,
    the shards of every rank that shares it (`mesh.rank_device`) must fit
    its memory together, else it raises before anything is drawn."""
    device = torch.device(device)
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        lay = ranks.layout
        mine = [r for r in range(lay.world)
                if r % cards == ranks.rank % cards]
        need = sum(rank_weight_bytes(cfg, lay, r, dtype) for r in mine)
        have = torch.cuda.get_device_properties(device).total_memory
        if need > have:
            raise ValueError(
                f"{cfg.name}: the shards of ranks {mine} need {need:,} "
                f"bytes of {dtype} weights on one card of {have:,}; cut "
                f"the depth (cut=, --cut) or give each rank a card")
    if npz is None:
        return init_params(cfg, seed, dtype=dtype, device=device,
                           layout=ranks.layout, rank=ranks.rank)
    from repro_torch.models.convert import shard_from_numpy
    return shard_from_numpy(cfg, npz_tree(npz), ranks.layout, ranks.rank,
                            device=device, dtype=dtype)


def npz_tree(path: str) -> dict:
    """The numpy tree saved at `path` (``/``-joined paths)."""
    with np.load(path) as f:
        tree: dict = {}
        for key in f.files:
            node = tree
            *heads, leaf = key.split("/")
            for h in heads:
                node = node.setdefault(h, {})
            node[leaf] = f[key]
    return tree


def move_out(eng: PipelineEngine, rid: str) -> Optional[dict]:
    """Take request `rid` off `eng` mid-flight by the router's own export
    half (`router.take_out`: settle an async engine, drain the request,
    gather its KV pages and state, free them).  None while it holds no KV
    yet or its micro-batch is in flight.  Returns a picklable move: the
    `Request`, its `KVExport`, and the payloads as host tensors."""
    from repro_torch.runtime.router import take_out

    if not eng.scheduler.kv.has_request(rid):
        return None
    taken = take_out(eng, rid)
    if taken is None:
        return None
    req, export, payload, state = taken
    if export is None:          # its KV went while the engine settled
        eng.scheduler.adopt_request(req)
        return None
    return {"request": req, "export": export,
            "kv": {k: v.cpu() for k, v in payload.items()},
            "state": {"enc": state["enc"], "slot_leaves": {
                k: v.cpu() for k, v in state["slot_leaves"].items()}}}


def move_in(eng: PipelineEngine, moved: dict):
    """Resume a `move_out` move on `eng` at its position by the router's
    delivery half (`router.put_in`), and adopt the request.  Returns the
    `Request`; raises `MemoryError` when `eng` has no room for it."""
    from repro_torch.runtime.router import put_in

    req = moved["request"]
    if not put_in(eng, req, moved["export"], moved["kv"], moved["state"]):
        raise MemoryError(f"{req.request_id}: no room to resume its move")
    eng.scheduler.adopt_request(req)
    return req


def rank_shard(ranks, cfg, *, device, dtype: torch.dtype, seed: int = 0,
               npz: Optional[str] = None, params=None) -> tuple:
    """This rank's device and its shard of `cfg`'s weights: on CUDA the
    rank's own card (`mesh.rank_device`) unless `device` names one, made
    the current device; `params` when given, else `rank_params`'s (drawn
    from `seed`, or cut from the numpy tree at `npz`).  ``(device,
    params)``."""
    from repro_torch.launch.mesh import rank_device

    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device(rank_device(ranks.rank, "cuda",
                                           torch.cuda.device_count()))
        torch.cuda.set_device(dev)
    if params is None:
        params = rank_params(cfg, ranks, dtype=dtype, device=dev, seed=seed,
                             npz=npz)
    return dev, params


def add_cut_argument(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--cut", default=None,
                    help="comma-separated block kinds (e.g. "
                    "mamba_mlp,mamba_moe,attn_moe): serve the first layer "
                    "of each")


def add_engine_arguments(ap: argparse.ArgumentParser) -> None:
    """`--bucketed`, `--async`, `--eager` and `--pp`, `build_engine`'s
    options."""
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline stages (micro-batches in flight; Token "
                    "Throttling at that depth): one process each with a "
                    "card each or with --tp, else a ring on one device")
    ap.add_argument("--bucketed", action="store_true",
                    help="serve the bucket ladder (each tick in the "
                    "smallest shape that covers it)")
    ap.add_argument("--async", dest="async_dispatch", action="store_true",
                    help="double-buffered dispatch: the host prepares tick "
                    "N+1 while the device runs tick N")
    ap.add_argument("--eager", dest="cuda_graphs", action="store_false",
                    help="on CUDA, run every tick eagerly instead of "
                    "replaying one CUDA graph per bucket")


def add_rank_arguments(ap: argparse.ArgumentParser) -> None:
    """`--tp`, `--backend` and `--store`: a layout of processes
    (`launch.ranks`), one a stage and tensor shard (`mesh.use_ranks`)."""
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks a stage (one process each)")
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                    help="the process group's backend (default: nccl when "
                    "every rank has a card of its own, else gloo)")
    ap.add_argument("--store", default=None, metavar="DIR",
                    help="the ranks' FileStore directory (default: a fresh "
                    "temporary one)")


def ranks_asked(args, dp: int = 1) -> bool:
    """`mesh.use_ranks` for the launcher's flags: processes at tp or dp >
    1, or at pp > 1 with a card a stage."""
    from repro_torch.launch.mesh import use_ranks

    cuda = (args.device or "cuda") != "cpu"
    return use_ranks(dp, args.pp, args.tp, "cuda" if cuda else "cpu",
                     torch.cuda.device_count() if cuda else 0)


def rank_launch(fn, layout, job: dict, args,
                timeout_s: float = 600.0) -> list:
    """Run ``fn(ranks, job)`` on every rank of `layout`: under torchrun
    (``RANK`` set) as this process's rank, whose result alone is returned
    (None on the other ranks), else one spawned process a rank, which
    `timeout_s` ends."""
    import os

    from repro_torch.launch import ranks as rk
    from repro_torch.launch.mesh import choose_backend

    cuda = job["device"] == "cuda"
    backend = choose_backend(layout.world, "cuda" if cuda else "cpu",
                             torch.cuda.device_count() if cuda else 0,
                             args.backend)
    if "RANK" in os.environ:
        import torch.distributed as dist
        ranks = rk.from_env(layout, backend)
        try:
            out = fn(ranks, job)
        finally:
            dist.destroy_process_group()
        return [out] if ranks.rank == 0 else None
    return rk.spawn(fn, layout, (job,), backend=backend,
                    store_dir=args.store, threads=None if cuda else 1,
                    timeout_s=timeout_s)


def serve_spec_rank(ranks, job: dict) -> dict:
    """One rank of the launcher's spec over a layout of ranks
    (`rank_launch`'s fn).  `job`: ``spec`` (its JSON), ``device``,
    ``dtype`` (a name or None), ``cut`` (`--cut`'s text), ``pp``,
    ``http`` (a port or None) and the synthetic workload's ``requests``,
    ``max_new`` and ``seed``.  Rank 0 builds the server
    (`serving.build(spec, ranks=)`, eager) and serves the workload
    (`serve_workload`: its finished and submitted requests) or HTTP
    (`serve_http`) and closes it, which ends the others, which serve
    through `serving.serve_worker` (their rank stats)."""
    from repro_torch.serving import ServeSpec, build
    from repro_torch.serving.build import serve_worker

    spec = ServeSpec.from_json(job["spec"])
    kw = dict(device=job["device"], cut=parse_cut(job.get("cut")),
              pp=job["pp"],
              dtype=getattr(torch, job["dtype"]) if job.get("dtype")
              else None)
    if ranks.rank:
        return {"rank_stats": serve_worker(spec, ranks, **kw)}
    server = build(spec, ranks=ranks, cuda_graphs=False, **kw)
    with server:
        if job.get("http") is not None:
            serve_http(server, spec, job["http"])
            return {}
        done, total = serve_workload(server, spec, job["requests"],
                                     job["max_new"], job["seed"])
    return {"done": done, "total": total}


def _serve_ranks(args, spec) -> None:
    """The launcher's spec over dp x pp x tp ranks (`serve_spec_rank`):
    the synthetic workload or HTTP, as in one process, on rank engines;
    ``--async`` with ``--trace-out`` is refused as there."""
    from repro_torch.launch.mesh import rank_layout

    if args.trace_out and args.async_dispatch:
        raise SystemExit("--trace-out records a synchronous engine: drop "
                         "--async")
    if spec.backend != "engine":
        raise SystemExit(f"a {spec.backend!r} spec touches no device: "
                         "serve it in one process (without --tp, --dp and "
                         "--pp), not over ranks")
    dev = resolve_device(args.device)
    layout = rank_layout(args.dp, args.pp, args.tp)
    job = dict(spec=spec.to_json(), device=dev.type, dtype=args.dtype,
               cut=args.cut, pp=args.pp, http=args.http,
               requests=args.requests, max_new=args.max_new, seed=args.seed)
    out = rank_launch(serve_spec_rank, layout, job, args,
                      timeout_s=math.inf if args.http is not None else 600.0)
    if out is None or args.http is not None:
        return
    if out[0]["done"] != out[0]["total"]:
        raise SystemExit("not every request finished")


def parse_cut(text: Optional[str]) -> Optional[list]:
    """`--cut`'s block kinds, or None to serve every layer."""
    return [BlockKind(k) for k in text.split(",")] if text else None


def _spec(*, arch: str, reduced: bool, policy: str, seed: int,
          replicas: int, route: str, rebalance_interval: Optional[float],
          migrate: bool, bucketed: bool, async_dispatch: bool,
          trace_out: Optional[str]):
    from repro_torch.serving import (ClusterSpec, EngineSpec,
                                     RebalancePolicy, ServeSpec, TraceSpec)
    cluster = None
    if replicas > 1 or rebalance_interval is not None:
        rebalance = None
        if rebalance_interval is not None:
            rebalance = RebalancePolicy(interval=rebalance_interval,
                                        migrate=migrate)
        cluster = ClusterSpec(replicas=max(replicas, 1), route=route,
                              rebalance=rebalance)
    return ServeSpec(
        backend="engine",
        engine=EngineSpec(arch=arch, reduced=reduced, policy=policy,
                          seed=seed, bucketed=bucketed,
                          dispatch="async" if async_dispatch else "sync"),
        cluster=cluster,
        trace=TraceSpec(record=trace_out) if trace_out is not None else None)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--policy", default="gllm",
                    choices=["gllm", "sarathi", "no_wt", "no_ut"])
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (f32) instead of the "
                    "published width and depth")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--dtype", default=None, choices=["float32", "bfloat16"])
    add_cut_argument(ap)
    add_engine_arguments(ap)
    add_rank_arguments(ap)
    ap.add_argument("--dp", type=int, default=1,
                    help="data replicas of one engine, one process each "
                    "(the serve tick's data axis; an MoE model whose plan "
                    "sets ep_over_data splits its experts over them)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replicas", type=int, default=1,
                    help="data-parallel engine replicas behind the router "
                    "(one shared set of weights)")
    ap.add_argument("--route", default="balanced", choices=["balanced", "rr"],
                    help="request placement policy across replicas")
    ap.add_argument("--rebalance-interval", type=float, default=None,
                    metavar="SECONDS",
                    help="run the periodic control plane: steal waiting "
                    "requests off saturated replicas every SECONDS")
    ap.add_argument("--migrate", action="store_true",
                    help="with --rebalance-interval: also live-migrate "
                    "running requests (their KV and state move, no "
                    "recompute)")
    ap.add_argument("--spec", default=None, metavar="FILE",
                    help="serve from a ServeSpec JSON file (the JAX "
                    "launcher's --dump-spec loads too) instead of the "
                    "engine/cluster flags above")
    ap.add_argument("--dump-spec", action="store_true",
                    help="print the ServeSpec these flags translate to "
                    "(JSON) and exit")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record a replayable tick trace of the run "
                    "(per-replica PATH.replicaN + PATH.router when N>1; "
                    "synchronous engines only); with --spec it replaces "
                    "the file's trace")
    ap.add_argument("--trace-replay", default=None, metavar="PATH",
                    help="strict-replay a recorded trace through the "
                    "scheduler instead of serving (builds no model)")
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="serve the spec over HTTP on PORT (0 = ephemeral) "
                    "instead of running the synthetic workload")
    args = ap.parse_args()

    from repro_torch.serving import ServeSpec, TraceSpec, build

    if args.trace_replay is not None:
        # replay needs only the scheduler and the recorded events: it never
        # builds the model, so it runs on any box
        server = build(ServeSpec(backend="trace",
                                 trace=TraceSpec(replay=args.trace_replay)))
        server.replay()
        print(f"[replay {args.trace_replay}] {server.last_report.summary()} "
              f"— decisions match the recording")
        return

    if args.spec is not None:
        with open(args.spec) as fh:
            spec = ServeSpec.from_json(fh.read())
        if args.trace_out is not None:
            spec = dataclasses.replace(
                spec, trace=TraceSpec(record=args.trace_out))
    else:
        spec = _spec(arch=args.arch, reduced=args.reduced,
                     policy=args.policy, seed=args.seed,
                     replicas=args.replicas, route=args.route,
                     rebalance_interval=args.rebalance_interval,
                     migrate=args.migrate, bucketed=args.bucketed,
                     async_dispatch=args.async_dispatch,
                     trace_out=args.trace_out)
    if args.dump_spec:
        print(spec.to_json(indent=2))
        return
    if ranks_asked(args, args.dp):
        _serve_ranks(args, spec)
        return

    dtype = getattr(torch, args.dtype) if args.dtype else None
    server = build(spec, device=args.device, dtype=dtype,
                   cuda_graphs=args.cuda_graphs, cut=parse_cut(args.cut),
                   pp=args.pp)
    if args.http is not None:
        serve_http(server, spec, args.http)
        return
    done, total = serve_workload(server, spec, args.requests, args.max_new,
                                 args.seed)
    server.close()
    if done != total:
        raise SystemExit("not every request finished")


def serve_http(server, spec, port: int) -> None:
    """Serve `server` over HTTP on `port` (0: an ephemeral one) until
    Ctrl-C; the front end's shutdown closes the server, also when serving
    raises."""
    from repro_torch.serving.http import HTTPFrontend

    frontend = HTTPFrontend(server, port=port)
    where = getattr(server.replicas[0], "device", spec.backend)
    print(f"[{spec.engine.arch} | {where}] serving "
          f"on {frontend.url} — POST /v1/generate[?stream=1], "
          f"DELETE /v1/requests/{{rid}}, GET /v1/stats  (Ctrl-C stops)",
          flush=True)
    try:
        frontend.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        frontend.shutdown()


def serve_workload(server, spec, requests: int, max_new: int,
                   seed: int) -> tuple:
    """The launcher's synthetic workload on `server`: `requests` seeded
    prompts (log-normal lengths), `max_new` tokens each, drained; prints
    one summary line.  Returns (finished, submitted)."""
    cfg = server.cfg
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    rids = []
    dims = getattr(server.replicas[0], "dims", None)
    for _ in range(requests):
        n = int(np.clip(rng.lognormal(3.0, 0.8), 4, 300))
        prompt = [int(t) for t in rng.integers(0, cfg.vocab_size, n)]
        rids.append(server.submit(
            prompt, SamplingParams(max_new_tokens=max_new),
            **(enc_inputs(cfg, dims, rng) if dims is not None else {})))
    server.drain()
    engines = server.replicas
    if spec.backend == "engine" and engines[0].device.type == "cuda":
        torch.cuda.synchronize(engines[0].device)
    wall = time.perf_counter() - t0
    outs = server.outputs(rids)
    toks = sum(len(o.token_ids) for o in outs)
    done = sum(o.finish_reason is not None for o in outs)
    stats = server.stats()
    routed = ""
    if stats.routed_counts is not None:
        routed = (f" routed={'/'.join(map(str, stats.routed_counts))}"
                  f" ({server.router.policy.value})")
        if stats.rebalance is not None:
            routed += (f" rebalance[stolen={stats.rebalance.stolen} "
                       f"migrated={stats.rebalance.migrated}]")
    if spec.backend == "engine":
        where = f"{engines[0].device} {cfg.dtype}"
        detail = (f"ticks={sum(e.stats.ticks for e in engines)} "
                  f"host_s={sum(e.stats.host_s for e in engines):.3f} "
                  f"device_s={sum(e.stats.device_s for e in engines):.3f} "
                  f"buckets={len(engines[0].backend.ladder)} graphs="
                  f"{'/'.join(str(e.backend.graph_count()) for e in engines)}"
                  f" pp={cfg.plan.pp}")
        lay = getattr(getattr(engines[0].backend, "ranks", None), "layout",
                      None)
        if lay is not None:
            detail += (f" ranks={lay.world} (dp={lay.size('data')} "
                       f"pp={lay.size('stage')} tp={lay.size('tensor')})")
    else:                           # the simulator's clock is virtual
        where = spec.backend
        detail = (f"ticks={sum(r.ticks for r in stats.replicas)} "
                  f"pp={'/'.join(str(e.pp) for e in engines)}")
    print(f"[{cfg.name} | {where}] {done}/{len(outs)} requests, {toks} "
          f"tokens in {wall:.2f}s; {detail}{routed}", flush=True)
    return done, len(outs)


if __name__ == "__main__":
    main()
