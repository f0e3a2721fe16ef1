"""Declarative serving specs — the single construction language of the
public API (DESIGN.md §10).

A copy of ``repro.serving.spec``: the port keeps its own so that it imports
nothing of the JAX package.

Every serving scenario in this repo — a live engine on the card, the
calibrated discrete-event simulator, a recorded-trace replay, a
multi-replica cluster of either — is described by one `ServeSpec` value and
materialized by `repro_torch.serving.build(spec)`.  Launchers, benchmarks, and
examples translate their flags into a spec instead of wiring
scheduler/KV/backend kwargs by hand, and a spec round-trips through JSON
(`to_json`/`from_json`) so a scenario can be checked in, diffed, and
reproduced byte-for-byte.

The spec layer is *pure data*: nothing here touches a device; all
construction lives in `repro_torch.serving.build`.  The JSON is the JAX
package's byte for byte, so a spec dumped by either launcher loads in the
other.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple, Union

from repro_torch.runtime.autoscale import AutoscalePolicy
from repro_torch.runtime.disagg import HandoffPolicy, validate_roles
from repro_torch.runtime.router import RebalancePolicy, ReplicaCapacity

BACKENDS = ("engine", "sim", "trace")


@dataclass(frozen=True)
class EngineSpec:
    """What model to serve and under which throttle policy.

    `reduced=True` builds the same-family reduced config (the CPU-sized
    model every test and example runs); `reduced=False` uses the published
    config (in the port: folded to one stage at the launcher's full dims,
    or staged again at `build`'s ``pp=``).
    `throttle` / `dims` are sparse overrides onto the backend's defaults
    (`ThrottleConfig` fields, `ServeDims` fields); `reduced_overrides` is
    passed to `make_reduced` (e.g. ``{"d_model": 128}``).

    `dispatch` selects the tick driving mode: ``"sync"`` (retire each
    batch the tick it exits — required for trace recording) or ``"async"``
    (double-buffered: retirement lags one tick so host prep overlaps
    device execution, DESIGN.md §12).  `bucketed=True` compiles the
    static-shape ladder and pads each tick to the smallest covering
    bucket instead of the full serve cell.
    """

    arch: str = "qwen1.5-0.5b"
    reduced: bool = True
    policy: str = "gllm"            # gllm | sarathi | no_wt | no_ut
    seed: int = 0
    throttle: Optional[Dict[str, Any]] = None
    dims: Optional[Dict[str, Any]] = None
    reduced_overrides: Optional[Dict[str, Any]] = None
    dispatch: str = "sync"          # sync | async (double-buffered ticks)
    bucketed: bool = False
    # Hash-chained full-page prefix caching (DESIGN.md §13): admission
    # adopts the longest cached prefix of each new request, skipping its
    # prefill; freed full pages stay matchable (LRU-evicted on pressure).
    enable_prefix_caching: bool = False

    def __post_init__(self) -> None:
        if self.dispatch not in ("sync", "async"):
            raise ValueError(
                f"unknown dispatch {self.dispatch!r}; expected 'sync' or "
                "'async'")


@dataclass(frozen=True)
class SimSpec:
    """Simulator geometry: the roofline cost model comes from
    `EngineSpec.arch`; these are the per-replica pipeline/KV shapes."""

    pp: int = 4
    pages: int = 2048
    page_size: int = 16
    runtime: str = "gllm"           # gllm | vllm (driver-overhead model)
    straggler_stage: Optional[int] = None
    straggler_factor: float = 1.0
    chips_per_stage: int = 1
    # Per-replica prefix caching (overridable via ClusterSpec.sim_overrides,
    # so a cluster can mix caching and non-caching replicas).
    enable_prefix_caching: bool = False


@dataclass(frozen=True)
class ClusterSpec:
    """Multi-replica layout: how many replicas, how requests are placed,
    whether the periodic control plane runs, optional static capacity
    hints (`ReplicaCapacity` or bare throughput scalars, one per replica),
    and — for sim clusters — per-replica `SimSpec` overrides.

    `sim_overrides` declares a heterogeneous cluster in the spec itself:
    one entry per replica, each either None (use the base `ServeSpec.sim`)
    or a sparse dict of `SimSpec` fields replacing the base values for that
    replica (e.g. ``({"pp": 8}, {"straggler_stage": 1,
    "straggler_factor": 2.0})``).  Unknown field names are rejected at
    construction — the same no-silent-typo contract as the JSON decoder.
    """

    replicas: int = 1
    route: str = "balanced"         # balanced | rr
    rebalance: Optional[RebalancePolicy] = None
    capacities: Optional[Tuple[Union[ReplicaCapacity, float], ...]] = None
    sim_overrides: Optional[Tuple[Optional[Dict[str, Any]], ...]] = None
    # Cache-aware routing strength: prefill-token credit per cached prompt
    # token when scoring a candidate replica (BalanceWeights.cache_affinity).
    # None keeps the router default (1.0); 0.0 routes load-only.  Inert
    # unless prefix caching is enabled on the replicas.
    cache_affinity: Optional[float] = None
    # Disaggregated serving (DESIGN.md §15): one role per replica —
    # "prefill" / "decode" / "mixed".  None means all mixed (the hybrid
    # throttled baseline).  Admission goes to prefill-capable replicas
    # only; `handoff` runs the first-decode KV transfer control plane
    # that ships freshly-prefilled requests to decode replicas.
    roles: Optional[Tuple[str, ...]] = None
    handoff: Optional[HandoffPolicy] = None
    # Cluster-scale elasticity (DESIGN.md §16): when set, the router runs
    # the autoscaler pass — `replicas` is the *initial* fleet size, and the
    # fleet grows/shrinks within [min_replicas, max_replicas].  New
    # replicas are built from the base `ServeSpec.sim` geometry (elastic
    # replicas are the homogeneous pool; sim_overrides shape only the
    # initial fleet).  Sim backend only: an engine cannot conjure devices.
    autoscale: Optional[AutoscalePolicy] = None

    def __post_init__(self) -> None:
        if self.replicas < 1:
            raise ValueError("ClusterSpec.replicas must be >= 1")
        if self.autoscale is not None and not (
                self.autoscale.min_replicas <= self.replicas
                <= self.autoscale.max_replicas):
            raise ValueError(
                f"ClusterSpec.replicas={self.replicas} must start inside "
                f"the autoscale range [{self.autoscale.min_replicas}, "
                f"{self.autoscale.max_replicas}]")
        if self.roles is not None:
            object.__setattr__(self, "roles",
                               validate_roles(self.roles, self.replicas))
        if self.capacities is not None:
            object.__setattr__(self, "capacities", tuple(self.capacities))
            if len(self.capacities) != self.replicas:
                raise ValueError("one capacity per replica")
        if self.sim_overrides is not None:
            object.__setattr__(self, "sim_overrides",
                               tuple(self.sim_overrides))
            if len(self.sim_overrides) != self.replicas:
                raise ValueError("one sim_overrides entry (dict or None) "
                                 "per replica")
            valid = {f.name for f in dataclasses.fields(SimSpec)}
            for i, ov in enumerate(self.sim_overrides):
                if ov is None:
                    continue
                unknown = sorted(set(ov) - valid)
                if unknown:
                    raise ValueError(
                        f"sim_overrides[{i}]: unknown SimSpec fields "
                        f"{unknown}")


@dataclass(frozen=True)
class TraceSpec:
    """Recording / replay of the run (DESIGN.md §8).

    `record` — path to record a replayable tick trace to (multi-replica
    engine runs write ``PATH.replicaN`` + ``PATH.router``; sim clusters
    treat it as a directory).  `replay` — path of a recorded trace to drive
    instead of a model: strict mode reproduces the recorded run
    bit-for-bit via `LLMServer.replay()`; `timing_only=True` serves *new*
    requests with the recorded per-tick costs (the what-if server).
    """

    record: Optional[str] = None
    replay: Optional[str] = None
    timing_only: bool = False


@dataclass(frozen=True)
class ServeSpec:
    """One serving scenario, fully specified.

    `backend` selects the execution substrate: ``"engine"`` (exact serve
    tick), ``"sim"`` (calibrated roofline), ``"trace"`` (a recording).
    `cluster=None` means one replica.  All four acceptance shapes are
    spellable:

        ServeSpec()                                            # one engine
        ServeSpec(backend="sim")                               # one sim
        ServeSpec(cluster=ClusterSpec(replicas=4))             # engine cluster
        ServeSpec(backend="trace",
                  trace=TraceSpec(replay="run.jsonl"))         # replay
    """

    backend: str = "engine"
    engine: EngineSpec = field(default_factory=EngineSpec)
    sim: SimSpec = field(default_factory=SimSpec)
    cluster: Optional[ClusterSpec] = None
    trace: Optional[TraceSpec] = None

    def __post_init__(self) -> None:
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; expected one of "
                f"{BACKENDS}")
        if self.backend == "trace":
            if self.trace is None or self.trace.replay is None:
                raise ValueError(
                    'backend="trace" needs trace=TraceSpec(replay=...)')
            if self.cluster is not None:
                raise ValueError("trace replay is per-replica; replay each "
                                 "recorded trace with its own spec")
        if (self.backend != "sim" and self.cluster is not None
                and self.cluster.sim_overrides is not None):
            raise ValueError(
                'ClusterSpec.sim_overrides applies to backend="sim" only '
                "(engine replicas take their geometry from EngineSpec)")
        if (self.backend != "sim" and self.cluster is not None
                and self.cluster.autoscale is not None):
            raise ValueError(
                'ClusterSpec.autoscale applies to backend="sim" only '
                "(an engine fleet cannot conjure replicas; drive elastic "
                "studies in sim)")

    @property
    def num_replicas(self) -> int:
        return self.cluster.replicas if self.cluster is not None else 1

    # ------------------------------------------------------------------- json
    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(_encode(self), indent=indent,
                          separators=None if indent else (",", ":"))

    @staticmethod
    def from_json(text: str) -> "ServeSpec":
        return spec_from_dict(json.loads(text))


# ---------------------------------------------------------------------------
# JSON (de)serialization — the round trip is exact: from_json(to_json(s)) == s
# ---------------------------------------------------------------------------

def _encode(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _encode(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_encode(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    return obj


def _decode_capacity(c: Any) -> Union[ReplicaCapacity, float]:
    if isinstance(c, dict):
        return ReplicaCapacity(**c)
    return float(c)


def spec_from_dict(d: Dict[str, Any]) -> ServeSpec:
    """Rebuild a `ServeSpec` from its JSON object form.  Unknown keys raise
    (a spec is a contract — silently dropping a typo'd field would serve a
    different scenario than the one written down)."""
    d = dict(d)
    kw: Dict[str, Any] = {}
    if "backend" in d:
        kw["backend"] = d.pop("backend")
    if d.get("engine") is not None:
        kw["engine"] = EngineSpec(**d.pop("engine"))
    else:
        d.pop("engine", None)
    if d.get("sim") is not None:
        kw["sim"] = SimSpec(**d.pop("sim"))
    else:
        d.pop("sim", None)
    cluster = d.pop("cluster", None)
    if cluster is not None:
        cluster = dict(cluster)
        if cluster.get("rebalance") is not None:
            cluster["rebalance"] = RebalancePolicy(**cluster["rebalance"])
        if cluster.get("handoff") is not None:
            cluster["handoff"] = HandoffPolicy(**cluster["handoff"])
        if cluster.get("autoscale") is not None:
            cluster["autoscale"] = AutoscalePolicy(**cluster["autoscale"])
        if cluster.get("capacities") is not None:
            cluster["capacities"] = tuple(
                _decode_capacity(c) for c in cluster["capacities"])
        if cluster.get("roles") is not None:
            cluster["roles"] = tuple(cluster["roles"])
        kw["cluster"] = ClusterSpec(**cluster)
    trace = d.pop("trace", None)
    if trace is not None:
        kw["trace"] = TraceSpec(**trace)
    if d:
        raise ValueError(f"unknown ServeSpec fields: {sorted(d)}")
    return ServeSpec(**kw)
