"""`build(spec) -> LLMServer`: materialize a `ServeSpec`
(``repro.serving.build``).

The port's shapes, one factory:

  * engine, 1 replica      -> `PipelineEngine` (`TorchBackend`)
  * engine, N replicas     -> `ReplicaRouter` over N engines sharing one
                              read-only parameter set; each owns its KV
                              pool, state slots and CUDA graphs

The spec is the JAX package's, field for field, so that a spec dumped by
either launcher serves in the other.  What the port builds but the spec
does not say (the device, the dtype, graphs or eager ticks, a depth cut,
the pipeline stages on the card) are arguments of `build`.  The simulator and trace replay are not ported
yet: ``backend="sim"`` (with it ``ClusterSpec.autoscale``, which the spec
allows on the simulator only), ``backend="trace"`` and
``TraceSpec.record`` raise `NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.serving.server import LLMServer
from repro_torch.serving.spec import ServeSpec

_NOT_PORTED = "is not ported to repro_torch yet (ROADMAP Queue 1 item 7)"


def build(spec: ServeSpec, *, device: Optional[torch.device | str] = None,
          dtype: Optional[torch.dtype] = None, cuda_graphs: bool = True,
          cut: Optional[Sequence[Any]] = None, pp: int = 1) -> LLMServer:
    """The one public entry point: every serving scenario starts here.
    Engines run on CUDA unless `device` asks for the CPU; `dtype` defaults
    to f32 for a reduced spec and bf16 for the published config;
    `cuda_graphs=False` runs every tick eagerly; `cut` serves the first
    layer of each named block kind (`configs.cut_to_kinds`); `pp` serves
    each engine in that many pipeline stages on its card, with Token
    Throttling at that depth (`configs.stage_config`)."""
    if spec.backend == "trace":
        _build_trace_server(spec)
    if spec.backend == "sim":
        _build_sim(spec)
    if spec.trace is not None and spec.trace.record is not None:
        raise NotImplementedError(f"trace recording {_NOT_PORTED}")
    engine, cfg = _build_engine(spec, device=device, dtype=dtype,
                                cuda_graphs=cuda_graphs, cut=cut, pp=pp)
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


def _build_engine(spec: ServeSpec, *, device, dtype, cuda_graphs: bool,
                  cut, pp: int = 1) -> Tuple[Any, Any]:
    from repro_torch.launch.serve import (FULL_DIMS, REDUCED_DIMS,
                                          build_params, serve_config)
    from repro_torch.runtime.engine import PipelineEngine, resolve_device

    es = spec.engine
    dev = resolve_device(device)
    cfg, dtype = serve_config(es.arch, reduced=es.reduced, dtype=dtype,
                              cut=cut,
                              reduced_overrides=es.reduced_overrides, pp=pp)
    if es.reduced:
        # dropless, as the JAX builder makes the reduced MoE
        cfg = dataclasses.replace(
            cfg, moe_capacity_factor=float(max(cfg.num_experts, 1)))
    dims = REDUCED_DIMS if es.reduced else FULL_DIMS
    if es.dims:
        dims = dataclasses.replace(dims, **es.dims)
    th = _throttle_config(spec, cfg.plan.pp, reduced=es.reduced)

    # replicas share the (read-only) parameters; each owns its KV pool,
    # state slots, scheduler, TickLoop and CUDA graphs
    params = build_params(cfg, dtype, dev, es.seed)
    engines = [PipelineEngine(cfg, dims, params, th, device=dev, dtype=dtype,
                              seed=es.seed, bucketed=es.bucketed,
                              async_dispatch=es.dispatch == "async",
                              cuda_graphs=cuda_graphs,
                              enable_prefix_caching=es.enable_prefix_caching)
               for _ in range(spec.num_replicas)]
    if spec.cluster is None and spec.num_replicas == 1:
        return engines[0], cfg
    return _wrap_router(spec, engines), cfg


def _wrap_router(spec: ServeSpec, replicas: List[Any]):
    """The JAX builder's router over `replicas`, without the trace and the
    autoscaler, which are not ported yet (`ServeSpec` allows autoscale on
    the simulator only, which `build` refuses)."""
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
    )


# ---------------------------------------------------------------------------
# sim and trace replay: later slices
# ---------------------------------------------------------------------------

def _build_sim(spec: ServeSpec):
    raise NotImplementedError(
        f'backend="sim" (the roofline simulator) {_NOT_PORTED}')


def _build_trace_server(spec: ServeSpec):
    raise NotImplementedError(f'backend="trace" (trace replay) {_NOT_PORTED}')
