"""`build(spec) -> LLMServer`: materialize a `ServeSpec`
(``repro.serving.build``).

The four shapes, one factory:

  * engine, 1 replica      -> `PipelineEngine` (`TorchBackend`)
  * engine, N replicas     -> `ReplicaRouter` over N engines sharing one
                              read-only parameter set; each owns its KV
                              pool, state slots and CUDA graphs
  * sim, 1 or N replicas   -> `PipelineSimulator` / `SimCluster` on the
                              roofline cost model at the card's rates
  * trace replay           -> the recorded stream (strict bit-identity via
                              `LLMServer.replay()`, or a timing-only engine
                              that serves new requests at recorded costs)

The spec is the JAX package's, field for field, so that a spec dumped by
either launcher serves in the other.  What the port builds but the spec
does not say (the device, the dtype, graphs or eager ticks, a depth cut,
the pipeline stages on the card, the layout of ranks) are arguments of
`build`; they apply to engine builds.  Sim and trace-replay builds touch no
tensor and no device, so they run on any box.

Over a layout of ranks (``ranks=``, this process's
`launch.mesh.RankGroups`, as JAX's `build` serves on a mesh) rank 0's
`build` returns the server over rank engines (`PipelineEngine(ranks=)`):
the spec's N replicas are N engines on the one layout, which share every
rank's weight shard and the worker processes (one `RankLink`); each owns
its pools, carry, slots, scheduler and `TickLoop`.  Every other rank calls
`serve_worker` with the same spec and arguments: it builds the same N
backends and serves rank 0's commands until the server closes.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.serving.server import LLMServer
from repro_torch.serving.spec import ServeSpec


def build(spec: ServeSpec, *, device: Optional[torch.device | str] = None,
          dtype: Optional[torch.dtype] = None, cuda_graphs: bool = True,
          cut: Optional[Sequence[Any]] = None, pp: int = 1, layers: int = 0,
          ranks=None, params=None, npz: Optional[str] = None,
          idle_s: Optional[float] = None) -> LLMServer:
    """The one public entry point: every serving scenario starts here.
    Engines run on CUDA unless `device` asks for the CPU; `dtype` defaults
    to f32 for a reduced spec and bf16 for the published config;
    `cuda_graphs=False` runs every tick eagerly; `cut` serves the first
    layer of each named block kind (`configs.cut_to_kinds`), `layers` the
    first that many layers; `pp` serves each engine in that many pipeline
    stages on its card, with Token Throttling at that depth
    (`configs.stage_config`).  A sim spec takes its stages from
    `SimSpec.pp`.

    With `ranks` (rank 0's `RankGroups` of a layout of more than one rank)
    the engines are rank engines over that layout, its stages the
    pipeline's (`pp` must be 1 or equal them), on this rank's card and
    shard of the weights (`launch.serve.rank_shard`): `params` when given,
    else cut from the numpy tree at `npz`, else drawn from the spec's
    seed.  CUDA graphs on CUDA raise (pass
    `cuda_graphs=False`).  The server sends the idle command every
    `idle_s` seconds of silence (default: a quarter of the group's
    timeout, `LLMServer(idle_s=)`); its `close()` ends the workers, which
    `serve_worker` runs on every other rank."""
    if ranks is not None and ranks.layout.world > 1:
        if ranks.rank != 0:
            raise ValueError("rank 0 builds the server; the other ranks "
                             "call serve_worker")
        return _build_rank_server(
            spec, ranks, device=device, dtype=dtype, cuda_graphs=cuda_graphs,
            cut=cut, pp=pp, layers=layers, params=params, npz=npz,
            idle_s=idle_s)
    if spec.backend == "trace":
        return _build_trace_server(spec)
    if spec.backend == "sim":
        engine, cfg = _build_sim(spec)
    else:
        engine, cfg = _build_engine(spec, device=device, dtype=dtype,
                                    cuda_graphs=cuda_graphs, cut=cut, pp=pp,
                                    layers=layers)
    return LLMServer(engine, spec=spec, cfg=cfg)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

def _throttle_config(spec: ServeSpec, pipeline_depth: int, *,
                     reduced: bool):
    from repro_torch.core import PrefillPolicy, ThrottleConfig
    from repro_torch.launch.serve import REDUCED_THROTTLE
    kw = dict(REDUCED_THROTTLE) if reduced else {}
    kw.update(pipeline_depth=pipeline_depth,
              policy=PrefillPolicy(spec.engine.policy))
    kw.update(spec.engine.throttle or {})
    return ThrottleConfig(**kw)


def _engine_parts(spec: ServeSpec, *, device, dtype, cut, pp: int,
                  layers: int = 0, tp: int = 1):
    """(cfg, dims, throttle, device, dtype) of the spec's engines: the
    config at `pp` stages planned at `tp`, the serve dims, the throttle."""
    from repro_torch.launch.serve import serve_config, serve_dims
    from repro_torch.runtime.engine import resolve_device

    es = spec.engine
    dev = resolve_device(device)
    cfg, dtype = serve_config(es.arch, reduced=es.reduced, dtype=dtype,
                              cut=cut,
                              reduced_overrides=es.reduced_overrides, pp=pp,
                              layers=layers)
    if es.reduced:
        # dropless, as the JAX builder makes the reduced MoE
        cfg = dataclasses.replace(
            cfg, moe_capacity_factor=float(max(cfg.num_experts, 1)))
    if tp > 1:
        cfg = cfg.with_plan(tp=tp)
    dims = serve_dims(cfg, es.reduced)     # Te = 16 reduced, as JAX's
    if es.dims:
        dims = dataclasses.replace(dims, **es.dims)
    th = _throttle_config(spec, cfg.plan.pp, reduced=es.reduced)
    return cfg, dims, th, dev, dtype


def _engine_kwargs(spec: ServeSpec, i: int) -> dict:
    """`PipelineEngine`'s options of the spec's engine `i`."""
    es = spec.engine
    record = spec.trace.record if spec.trace is not None else None
    return dict(seed=es.seed, bucketed=es.bucketed,
                async_dispatch=es.dispatch == "async",
                enable_prefix_caching=es.enable_prefix_caching,
                trace_path=_replica_trace(record, i, spec.num_replicas))


def _cluster(spec: ServeSpec, engines: List[Any], cfg) -> Tuple[Any, Any]:
    """One engine, or the router over them."""
    if spec.cluster is None and len(engines) == 1:
        return engines[0], cfg
    record = spec.trace.record if spec.trace is not None else None
    return _wrap_router(spec, engines, record), cfg


def _build_engine(spec: ServeSpec, *, device, dtype, cuda_graphs: bool,
                  cut, pp: int = 1, layers: int = 0) -> Tuple[Any, Any]:
    from repro_torch.launch.serve import build_params
    from repro_torch.runtime.engine import PipelineEngine

    cfg, dims, th, dev, dtype = _engine_parts(
        spec, device=device, dtype=dtype, cut=cut, pp=pp, layers=layers)
    # replicas share the (read-only) parameters; each owns its KV pool,
    # state slots, scheduler, TickLoop and CUDA graphs
    params = build_params(cfg, dtype, dev, spec.engine.seed)
    engines = [PipelineEngine(cfg, dims, params, th, device=dev, dtype=dtype,
                              cuda_graphs=cuda_graphs,
                              **_engine_kwargs(spec, i))
               for i in range(spec.num_replicas)]
    return _cluster(spec, engines, cfg)


# ---------------------------------------------------------------------------
# engines over a layout of ranks
# ---------------------------------------------------------------------------

def _rank_parts(spec: ServeSpec, ranks, *, device, dtype, cut, pp: int,
                layers: int, params, npz: Optional[str]):
    """`_engine_parts` at the layout's stages and tensor ranks, and this
    rank's device and shard (`launch.serve.rank_shard`): (cfg, dims,
    throttle, device, dtype, params)."""
    from repro_torch.launch.serve import rank_shard

    if spec.backend != "engine":
        raise ValueError(f"a {spec.backend!r} spec touches no device: it "
                         "serves in one process, not over ranks")
    stages = ranks.size("stage")
    if pp not in (1, stages):
        raise ValueError(f"pp={pp}, but the layout has {stages} stages")
    cfg, dims, th, dev, dtype = _engine_parts(
        spec, device=device, dtype=dtype, cut=cut, pp=stages,
        layers=layers, tp=ranks.size("tensor"))
    dev, params = rank_shard(ranks, cfg, device=dev, dtype=dtype,
                             seed=spec.engine.seed, npz=npz, params=params)
    return cfg, dims, th, dev, dtype, params


def _idle_interval(ranks, idle_s: Optional[float]) -> float:
    if idle_s is not None:
        return idle_s
    return (ranks.timeout_s or 60.0) / 4


def _build_rank_server(spec: ServeSpec, ranks, *, device, dtype,
                       cuda_graphs: bool, cut, pp: int, layers: int, params,
                       npz: Optional[str], idle_s: Optional[float]
                       ) -> LLMServer:
    from repro_torch.runtime.engine import PipelineEngine, RankLink

    cfg, dims, th, dev, dtype, params = _rank_parts(
        spec, ranks, device=device, dtype=dtype, cut=cut, pp=pp,
        layers=layers, params=params, npz=npz)
    link = RankLink(ranks, dev)
    try:
        engines = [PipelineEngine(cfg, dims, params, th, device=dev,
                                  dtype=dtype, cuda_graphs=cuda_graphs,
                                  ranks=ranks, link=link,
                                  **_engine_kwargs(spec, i))
                   for i in range(spec.num_replicas)]
        engine, cfg = _cluster(spec, engines, cfg)
    except BaseException:
        link.stop()             # the workers wait for a command
        raise
    return LLMServer(engine, spec=spec, cfg=cfg,
                     idle_s=_idle_interval(ranks, idle_s))


def serve_worker(spec: ServeSpec, ranks, *,
                 device: Optional[torch.device | str] = None,
                 dtype: Optional[torch.dtype] = None, cut=None, pp: int = 1,
                 layers: int = 0, params=None,
                 npz: Optional[str] = None) -> List[dict]:
    """A rank other than 0's part of `build(spec, ranks=)`, called with the
    same spec and arguments: the same N engines' backends on this rank's
    shard, serving rank 0's commands until its server closes
    (`runtime.engine.serve_engines`).  Returns each engine's rank stats
    (`RankStats.as_dict`)."""
    from repro_torch.runtime.engine import serve_engines

    if ranks.rank == 0:
        raise ValueError("rank 0 builds the server (build(spec, ranks=))")
    cfg, dims, _, dev, dtype, params = _rank_parts(
        spec, ranks, device=device, dtype=dtype, cut=cut, pp=pp,
        layers=layers, params=params, npz=npz)
    stats = serve_engines(cfg, dims, params, ranks=ranks, device=dev,
                          dtype=dtype, engines=spec.num_replicas,
                          seed=spec.engine.seed,
                          bucketed=spec.engine.bucketed)
    return [st.as_dict() for st in stats]


def _replica_trace(record: Optional[str], i: int, n: int) -> Optional[str]:
    if record is None:
        return None
    return record if n == 1 else f"{record}.replica{i}"


def _wrap_router(spec: ServeSpec, replicas: List[Any],
                 record: Optional[str],
                 replica_factory: Optional[Any] = None):
    from repro_torch.runtime.router import BalanceWeights, ReplicaRouter
    cl = spec.cluster
    weights = None
    if cl.cache_affinity is not None:
        weights = BalanceWeights(cache_affinity=cl.cache_affinity)
    return ReplicaRouter(
        replicas,
        policy=cl.route,
        weights=weights,
        rebalance=cl.rebalance,
        capacities=cl.capacities,
        roles=cl.roles,
        handoff=cl.handoff,
        autoscale=cl.autoscale,
        replica_factory=replica_factory,
        trace_path=None if record is None else f"{record}.router",
    )


# ---------------------------------------------------------------------------
# sim
# ---------------------------------------------------------------------------

def _build_sim(spec: ServeSpec) -> Tuple[Any, Any]:
    from repro_torch.configs import get_config
    from repro_torch.core import PagedKVManager, PipelineScheduler
    from repro_torch.runtime.router import SimCluster
    from repro_torch.runtime.simulator import (PipelineSimulator,
                                               RuntimeModel, cost_model_for)

    cfg = get_config(spec.engine.arch)
    n = spec.num_replicas
    record = spec.trace.record if spec.trace is not None else None
    overrides = (spec.cluster.sim_overrides
                 if spec.cluster is not None else None)

    def replica_sim_spec(i: int):
        """The i-th replica's geometry: the base `SimSpec` with that
        replica's sparse overrides applied (spec-declared heterogeneity)."""
        ov = overrides[i] if overrides is not None else None
        return dataclasses.replace(spec.sim, **ov) if ov else spec.sim

    def one(i: int) -> PipelineSimulator:
        # ordinals >= the initial fleet size are autoscaler-added replicas:
        # they take the base geometry (sim_overrides shape the initial
        # fleet only — the elastic pool is homogeneous)
        ss = replica_sim_spec(i) if i < n else spec.sim
        th = _throttle_config(spec, ss.pp, reduced=False)
        runtime = (RuntimeModel.vllm_like() if ss.runtime == "vllm"
                   else RuntimeModel.gllm())
        kv = PagedKVManager(num_pages=ss.pages, page_size=ss.page_size,
                            enable_prefix_caching=ss.enable_prefix_caching)
        sched = PipelineScheduler(th, kv,
                                  max_model_len=ss.pages * ss.page_size)
        return PipelineSimulator(
            sched, ss.pp,
            cost_model_for(cfg, chips_per_stage=ss.chips_per_stage,
                           pp=ss.pp),
            runtime,
            straggler_stage=ss.straggler_stage,
            straggler_factor=ss.straggler_factor,
            # clusters record via SimCluster's trace_dir layout instead
            trace_path=record if spec.cluster is None else None)

    sims = [one(i) for i in range(n)]
    if spec.cluster is None and n == 1:
        return sims[0], cfg
    router = _wrap_router(spec, sims, None, replica_factory=one)
    # SimCluster owns cluster trace layout: one tick trace per replica plus
    # the router placement stream, under `record` as a directory
    return SimCluster(sims, router, trace_dir=record), cfg


# ---------------------------------------------------------------------------
# trace replay
# ---------------------------------------------------------------------------

class TraceReplayEngine:
    """Engine-surface adapter over a recorded trace in *timing-only* mode:
    new requests are welcome, the scheduler decides freely, and each tick
    costs what the recorded tick cost — the what-if serving substrate.
    Once the recording's ticks are exhausted, further ticks advance a
    fixed 1ms synthetic clock (matching `replay_trace`)."""

    def __init__(self, trace) -> None:
        from repro_torch.runtime.core import TickLoop
        from repro_torch.runtime.trace import (TraceBackend,
                                               scheduler_from_header)

        self.trace = trace
        self.scheduler = scheduler_from_header(trace.header)
        self.backend = TraceBackend(trace, TraceBackend.TIMING)
        self.loop = TickLoop(self.scheduler, self.backend)
        self._now = 0.0
        self._seq = itertools.count()
        self.recorder = None

    # ------------------------------------------------------- engine surface
    @property
    def finished(self):
        return self.loop.finished

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work

    @property
    def busy(self) -> bool:
        return self.loop.busy

    @property
    def on_token(self):
        return self.loop.on_token

    @on_token.setter
    def on_token(self, fn) -> None:
        self.loop.on_token = fn

    def add_request(self, prompt, sampling=None, request_id=None):
        from repro_torch.core import Request, SamplingParams
        rid = request_id or f"replay-{next(self._seq)}"
        req = Request(rid, list(prompt), sampling or SamplingParams())
        req.metrics.arrival_time = self._clock()
        self.scheduler.add_request(req)
        return req

    def step(self):
        now = self._clock()
        if self.backend._k >= len(self.backend._ticks):
            now = self._now = self._now + 1e-3
        self._now = max(self._now, now)
        return self.loop.step(now)

    def abort_request(self, request_id: str) -> bool:
        req = self.scheduler.abort_request(request_id, self._clock())
        if req is None:
            return False
        if req.is_finished:
            self.loop.finished.append(req)
        return True

    def _clock(self) -> float:
        return max(self._now, self.backend.clock())


def _build_trace_server(spec: ServeSpec) -> LLMServer:
    from repro_torch.runtime.trace import Trace, TraceBackend

    trace = Trace.load(spec.trace.replay)
    if spec.trace.timing_only:
        engine = TraceReplayEngine(trace)
        return LLMServer(engine, spec=spec, replay=trace,
                         replay_mode=TraceBackend.TIMING)
    # strict replay: the workload IS the recording; LLMServer.replay()
    # reproduces it bit-for-bit (no interactive substrate to submit into)
    return LLMServer(None, spec=spec, replay=trace,
                     replay_mode=TraceBackend.STRICT)
