"""The port's public serving API (`repro_torch.serving`) on the CPU: the
engine-backed twins of tests/test_serving_api.py.

The same generate / stream / abort / stop-token scenarios run through the
one `LLMServer` surface over one reduced `TorchBackend` engine and over two
behind the balanced `ReplicaRouter` (the `engine` and `engine2`
parametrisations of the JAX suite).  Also here: the abort and preemption
cases that run on an engine, the spec's JSON round trip (a spec dumped by
the JAX launcher loads and round-trips unchanged), the disaggregated
prefill -> decode cluster, prefix caching through the spec, and the sim,
trace and autoscale specs, which build (tests/test_torch_sim_serving.py
holds their scenarios).
"""

import asyncio
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.serving import ClusterSpec as JClusterSpec
from repro.serving import ServeSpec as JServeSpec
from repro_torch.runtime.autoscale import AutoscalePolicy
from repro_torch.runtime.trace import Trace, replay_trace
from repro_torch.serving import (
    EVENT_PREEMPT,
    EVENT_PREEMPT_RESUMED,
    FINISH_ABORT,
    FINISH_LENGTH,
    FINISH_STOP,
    ClusterSpec,
    EngineSpec,
    HandoffPolicy,
    RebalancePolicy,
    ReplicaCapacity,
    SamplingParams,
    ServeSpec,
    SimSpec,
    TraceSpec,
    build,
)

ROOT = Path(__file__).resolve().parents[1]
TOY_ENGINE = EngineSpec(
    arch="qwen1.5-0.5b",
    throttle=dict(num_iters_T=2, max_prefill_tokens=16,
                  min_prefill_tokens=4),
    dims=dict(C=16, pages=256, Bp=32, Bd=32))

BACKENDS = ["engine", "engine2"]


def make_spec(kind, engine=TOY_ENGINE):
    if kind == "engine":
        return ServeSpec(engine=engine)
    if kind == "engine2":
        return ServeSpec(engine=engine, cluster=ClusterSpec(replicas=2))
    raise ValueError(kind)


@pytest.fixture(scope="module", params=BACKENDS)
def server(request):
    return build(make_spec(request.param), device="cpu")


def prompt(server, n, seed=0):
    rng = np.random.default_rng(seed)
    return [int(t) for t in rng.integers(0, server.cfg.vocab_size, n)]


# ---------------------------------------------------------------------------
# the shared scenarios
# ---------------------------------------------------------------------------

class TestConformance:
    def test_generate_runs_to_length(self, server):
        out = server.generate(prompt(server, 11),
                              SamplingParams(max_new_tokens=4))
        assert out.finish_reason == FINISH_LENGTH
        assert len(out.token_ids) == 4
        assert out.metrics.ttft() is not None and out.metrics.ttft() >= 0
        assert out.metrics.e2el() >= out.metrics.ttft()

    def test_generate_is_deterministic(self, server):
        p = prompt(server, 9, seed=1)
        a = server.generate(p, SamplingParams(max_new_tokens=4))
        b = server.generate(p, SamplingParams(max_new_tokens=4))
        assert a.token_ids == b.token_ids

    def test_stop_token_truncates(self, server):
        p = prompt(server, 8, seed=2)
        ref = server.generate(p, SamplingParams(max_new_tokens=6))
        stop = ref.token_ids[1]
        cut = ref.token_ids.index(stop)
        out = server.generate(p, SamplingParams(max_new_tokens=6,
                                                stop_token_ids=(stop,)))
        assert out.finish_reason == FINISH_STOP
        assert out.token_ids == ref.token_ids[:cut + 1]

    def test_stream_deltas_are_contiguous_and_terminated(self, server):
        async def run():
            deltas = []
            async for d in server.generate_stream(
                    prompt(server, 7, seed=3),
                    SamplingParams(max_new_tokens=3)):
                deltas.append(d)
            return deltas

        deltas = asyncio.run(run())
        tokens = [d for d in deltas if d.token is not None]
        assert [d.index for d in tokens] == [1, 2, 3]
        assert deltas[-1].finish_reason == FINISH_LENGTH
        assert all(d.finish_reason is None for d in deltas[:-1])

    def test_abort_mid_queue(self, server):
        long_rid = server.submit(prompt(server, 10, seed=4),
                                 SamplingParams(max_new_tokens=6))
        rid = server.submit(prompt(server, 10, seed=5),
                            SamplingParams(max_new_tokens=6))
        assert server.abort(rid)                 # still waiting: immediate
        out = server.get(rid)
        assert out.finish_reason == FINISH_ABORT
        assert out.token_ids == []
        server.drain()
        assert server.get(long_rid).finish_reason == FINISH_LENGTH
        self._assert_no_leak(server, rid)

    def test_abort_mid_decode(self, server):
        rid = server.submit(prompt(server, 10, seed=6),
                            SamplingParams(max_new_tokens=64))
        req = server._requests[rid]
        for _ in range(200):
            if req.num_output_tokens >= 1:
                break
            server.step()
        assert req.num_output_tokens >= 1, "request never started decoding"
        assert server.abort(rid)
        server.drain()
        out = server.get(rid)
        assert out.finish_reason == FINISH_ABORT
        assert len(out.token_ids) < 64
        self._assert_no_leak(server, rid)
        assert server.abort(rid) is False        # already finished

    def test_stats_expose_service_rate(self, server):
        server.generate(prompt(server, 8, seed=7),
                        SamplingParams(max_new_tokens=4))
        stats = server.stats()
        assert stats.tokens_retired > 0
        assert any(r.service_rate is not None and r.service_rate > 0
                   for r in stats.replicas)
        for r in stats.replicas:
            assert 0.0 <= r.kv_free_rate <= 1.0
            assert 0 <= r.live_pages <= r.scanned_pages
        if server.router is not None:
            assert stats.routed_counts is not None
            assert sum(stats.routed_counts) > 0

    @staticmethod
    def _assert_no_leak(server, rid):
        for replica in server.replicas:
            sched = replica.scheduler
            assert not sched.kv.has_request(rid)
            assert all(r.request_id != rid for r in sched.waiting)
            assert all(r.request_id != rid for r in sched.running_decode)
            assert all(r.request_id != rid for r in sched.running_prefill)
            assert rid not in replica.slots.owner


# ---------------------------------------------------------------------------
# abort and preemption on an engine
# ---------------------------------------------------------------------------

def test_abort_in_flight_finalizes_at_retire():
    """Scheduler-level: an abort landing while the request is inside an
    in-flight micro-batch defers to complete(), which discards the sampled
    token, frees the KV, and reports the request finished."""
    from repro_torch.core import (PagedKVManager, PipelineScheduler,
                                  Request, ThrottleConfig)
    sched = PipelineScheduler(ThrottleConfig(pipeline_depth=2),
                              PagedKVManager(64, 8))
    req = Request("r1", [1] * 12, SamplingParams(max_new_tokens=8))
    sched.add_request(req)
    batch = sched.schedule(0.0)
    assert [s.request.request_id for s in batch.seqs] == ["r1"]
    got = sched.abort_request("r1", 0.5)
    assert got is req and not req.is_finished    # deferred
    assert sched.kv.has_request("r1")
    finished = sched.complete(batch.batch_id, [7], 1.0)
    assert finished == [req]
    assert req.finish_reason == FINISH_ABORT
    assert req.output_token_ids == []
    assert not sched.kv.has_request("r1")
    assert not sched.has_work
    sched.check_invariants()


def test_abort_in_flight_on_the_async_engine_ends_its_stream():
    """On the async engine a decode is in flight between steps: aborting it
    finalizes when its tick retires, and its stream ends with the abort
    delta, pages and slot freed."""
    spec = ServeSpec(engine=EngineSpec(
        arch="rwkv6-3b", dispatch="async", bucketed=True,
        throttle=TOY_ENGINE.throttle, dims=TOY_ENGINE.dims))
    srv = build(spec, device="cpu")
    deltas = []
    rid = "victim"
    srv.subscribe(rid, deltas.append)
    srv.submit([3] * 10, SamplingParams(max_new_tokens=64), request_id=rid)
    req = srv._requests[rid]
    while req.num_output_tokens < 2:
        srv.step()
    assert srv.abort(rid)
    srv.drain()
    assert deltas[-1].finish_reason == FINISH_ABORT
    assert sum(d.finish_reason is not None for d in deltas) == 1
    eng = srv.replicas[0]
    assert not eng.scheduler.kv.has_request(rid)
    assert eng.slots.owner == {}


def test_preemption_surfaces_stream_events():
    """A preempted-then-recovered request's stream carries the
    event="preempt" delta and tags the first recomputed token."""
    engine = EngineSpec(arch="qwen1.5-0.5b", throttle=TOY_ENGINE.throttle,
                        dims=dict(C=16, pages=10, Bp=32, Bd=32))
    srv = build(ServeSpec(engine=engine), device="cpu")

    async def run():
        return await asyncio.gather(*[
            _collect(srv.generate_stream([i + 1] * 16,
                                         SamplingParams(max_new_tokens=18)))
            for i in range(3)])

    deltas = [d for out in asyncio.run(run()) for d in out]
    assert srv.stats().replicas[0].preemptions >= 1, "needs KV pressure"
    events = [d.event for d in deltas if d.event is not None]
    assert EVENT_PREEMPT in events
    assert EVENT_PREEMPT_RESUMED in events
    finals = [d for d in deltas if d.finish_reason is not None]
    assert len(finals) == 3
    assert all(d.finish_reason == FINISH_LENGTH for d in finals)


async def _collect(stream):
    return [d async for d in stream]


# ---------------------------------------------------------------------------
# clusters: disaggregated hand-off, prefix caching
# ---------------------------------------------------------------------------

def _outputs(srv, prompts, max_new=6):
    rids = [srv.submit(p, SamplingParams(max_new_tokens=max_new))
            for p in prompts]
    srv.drain()
    return [srv.get(r) for r in rids]


def test_disaggregated_prefill_decode_hands_every_request_off_once():
    """roles=("prefill", "decode"): every request is admitted on the
    prefill replica, handed off once at its first decode (its KV moves),
    and its tokens equal the one-engine run's."""
    rng = np.random.default_rng(31)
    prompts = [[int(t) for t in rng.integers(0, 256, n)]
               for n in (9, 23, 14, 40, 6)]
    want = [o.token_ids for o in _outputs(
        build(make_spec("engine"), device="cpu"), prompts)]
    srv = build(ServeSpec(engine=TOY_ENGINE, cluster=ClusterSpec(
        replicas=2, roles=("prefill", "decode"),
        handoff=HandoffPolicy(interval=1e-6))), device="cpu")
    outs = _outputs(srv, prompts)
    assert [o.token_ids for o in outs] == want
    st = srv.stats()
    assert st.routed_counts == [len(prompts), 0]
    assert st.disagg.handoffs == len(prompts)
    assert st.disagg.fallbacks == 0
    assert sorted(r.request_id for r in srv.replicas[1].finished) == sorted(
        o.request_id for o in outs)
    srv.router.check_invariants()


def test_prefix_caching_through_the_spec():
    """EngineSpec(enable_prefix_caching=True) reaches the engine's KV
    manager: a shared prefix is adopted and the tokens do not change."""
    engine = EngineSpec(arch="qwen1.5-0.5b", throttle=TOY_ENGINE.throttle,
                        dims=TOY_ENGINE.dims, enable_prefix_caching=True)
    rng = np.random.default_rng(37)
    shared = [int(t) for t in rng.integers(0, 256, 24)]
    prompts = [shared + [int(t) for t in rng.integers(0, 256, k)]
               for k in (5, 9, 3)]
    plain = build(make_spec("engine"), device="cpu")
    want = [plain.generate(p, SamplingParams(max_new_tokens=5)).token_ids
            for p in prompts]
    srv = build(ServeSpec(engine=engine), device="cpu")
    got = [srv.generate(p, SamplingParams(max_new_tokens=5)).token_ids
           for p in prompts]
    assert got == want
    rep = srv.stats().replicas[0]
    assert rep.prefix_hits == 2 and rep.prefix_tokens_avoided == 48
    with pytest.raises(ValueError, match="prefix caching"):
        build(ServeSpec(engine=EngineSpec(arch="rwkv6-3b",
                                          enable_prefix_caching=True)),
              device="cpu")


# ---------------------------------------------------------------------------
# the sim, trace and autoscale specs (refused until the simulator and the
# trace were ported; each now builds and serves)
# ---------------------------------------------------------------------------

FIXTURE = str(ROOT / "tests" / "fixtures" / "traces" /
              "prefill_heavy.trace.jsonl")


@pytest.mark.parametrize("kind", [
    "sim", "sim2", "trace", "trace-timing", "record", "autoscale"])
def test_unported_specs_raise(kind, tmp_path):
    """Every spec that once raised `NotImplementedError` here builds:
    sim and trace builds touch no device, a recording engine writes a trace
    that replays strictly, and the elastic fleet grows on the simulator.
    (The name and ids are kept from when these specs were refused.)"""
    record = str(tmp_path / "out.jsonl")
    spec = {
        "sim": ServeSpec(backend="sim"),
        "sim2": ServeSpec(backend="sim", cluster=ClusterSpec(replicas=2)),
        "trace": ServeSpec(backend="trace", trace=TraceSpec(replay=FIXTURE)),
        "trace-timing": ServeSpec(backend="trace", trace=TraceSpec(
            replay=FIXTURE, timing_only=True)),
        "record": ServeSpec(engine=TOY_ENGINE,
                            trace=TraceSpec(record=record)),
        "autoscale": ServeSpec(backend="sim", sim=SimSpec(
            pp=2, pages=256, page_size=8), cluster=ClusterSpec(
            replicas=1, autoscale=AutoscalePolicy(
                interval=0.05, max_replicas=4, target_queue=2.0,
                up_cooldown=0.1, down_cooldown=0.5))),
    }[kind]
    srv = build(spec, device="cpu")
    if kind == "trace":
        outs = srv.replay()
        assert len(outs) == 28 and srv.last_report.ticks == 76
        return
    n, max_new = (40, 64) if kind == "autoscale" else (3, 8)
    rids = [srv.submit([i + 1] * 64, SamplingParams(max_new_tokens=max_new))
            for i in range(n)]
    srv.drain()
    outs = srv.outputs(rids)
    assert all(o.finish_reason == FINISH_LENGTH
               and len(o.token_ids) == max_new for o in outs)
    srv.close()
    if kind == "record":
        report = replay_trace(Trace.load(record))
        assert report.outputs() == {o.request_id: o.token_ids for o in outs}
    if kind == "autoscale":
        assert srv.stats().autoscale.replicas_added > 0


def test_router_trace_and_server_replay_raise(tmp_path):
    """The router's `gllm-route` stream opens on an engine cluster and logs
    each placement; `replay` raises only on a server that is not a trace
    replay, and replays one that is.  (The name is kept from when both
    raised `NotImplementedError`.)"""
    srv = build(make_spec("engine2"), device="cpu")
    path = str(tmp_path / "route.jsonl")
    srv.router.open_trace(path)
    for i in range(3):
        srv.generate([i + 1] * 6, SamplingParams(max_new_tokens=2))
    srv.router.close_trace()
    route = Trace.load(path, expect="gllm-route")
    assert route.header["replicas"] == 2
    assert [r["kind"] for r in route.records].count("route") == 3
    with pytest.raises(RuntimeError, match="not a trace-replay server"):
        srv.replay()
    replay = build(ServeSpec(backend="trace", trace=TraceSpec(
        replay=FIXTURE)))
    assert len(replay.replay()) == 28


# ---------------------------------------------------------------------------
# spec JSON round trip
# ---------------------------------------------------------------------------

ROUND_TRIP = [
    ServeSpec(),
    ServeSpec(backend="sim", sim=SimSpec(pp=8, straggler_stage=2,
                                         straggler_factor=1.5)),
    ServeSpec(backend="trace", trace=TraceSpec(replay="x.jsonl",
                                               timing_only=True)),
    ServeSpec(engine=EngineSpec(arch="qwen2.5-14b", policy="sarathi",
                                throttle={"num_iters_T": 2},
                                dims={"Sd": 16}),
              cluster=ClusterSpec(
                  replicas=3, route="rr",
                  rebalance=RebalancePolicy(interval=0.5, migrate=False),
                  capacities=(1.0, ReplicaCapacity.straggler(4, 2.0),
                              ReplicaCapacity.scaled(1.5))),
              trace=TraceSpec(record="out.jsonl")),
    ServeSpec(backend="sim",
              cluster=ClusterSpec(
                  replicas=3,
                  sim_overrides=(None,
                                 {"straggler_stage": 1,
                                  "straggler_factor": 2.0},
                                 {"pp": 8, "pages": 512}))),
    ServeSpec(engine=EngineSpec(dispatch="async", bucketed=True)),
    ServeSpec(engine=EngineSpec(enable_prefix_caching=True),
              cluster=ClusterSpec(replicas=2, roles=("prefill", "decode"),
                                  handoff=HandoffPolicy(interval=0.1),
                                  cache_affinity=0.5)),
    ServeSpec(backend="sim", cluster=ClusterSpec(
        replicas=2, autoscale=AutoscalePolicy(interval=0.2,
                                              max_replicas=32))),
]


@pytest.mark.parametrize("spec", ROUND_TRIP)
def test_spec_json_round_trip(spec):
    assert ServeSpec.from_json(spec.to_json()) == spec
    assert ServeSpec.from_json(spec.to_json(indent=2)) == spec


@pytest.mark.parametrize("spec", ROUND_TRIP)
def test_spec_json_is_the_jax_packages(spec):
    """A port spec's JSON loads in the JAX package and comes back byte for
    byte, and the other way round."""
    text = spec.to_json(indent=2)
    jspec = JServeSpec.from_json(text)
    assert jspec.to_json(indent=2) == text
    assert ServeSpec.from_json(jspec.to_json()).to_json() == spec.to_json()


def test_spec_dumped_by_the_jax_launcher_loads_and_round_trips():
    """`python -m repro.launch.serve ... --dump-spec` loads in the port,
    round-trips unchanged, and serves there; so does the port launcher's
    own dump, which equals the JAX one for the same flags."""
    flags = ["--replicas", "2", "--route", "rr", "--rebalance-interval",
             "0.1", "--migrate", "--dump-spec"]
    env = {"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "PATH": "/usr/bin:/bin"}
    text = subprocess.run(
        [sys.executable, "-m", "repro.launch.serve", *flags], cwd=ROOT,
        env=env, capture_output=True, text=True, check=True).stdout
    spec = ServeSpec.from_json(text)
    assert spec.to_json(indent=2) == text.rstrip("\n")
    assert spec.num_replicas == 2 and spec.cluster.rebalance.migrate
    port = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         *flags], cwd=ROOT, env=env, capture_output=True, text=True,
        check=True).stdout
    assert port == text
    srv = build(spec, device="cpu")
    out = srv.generate([1, 2, 3], SamplingParams(max_new_tokens=3))
    assert out.finish_reason == FINISH_LENGTH
    assert srv.router.policy.value == "rr"


def test_spec_rejects_unknown_fields():
    with pytest.raises(ValueError, match="unknown"):
        ServeSpec.from_json('{"backend": "sim", "typo": 1}')


def test_spec_rejects_unknown_dispatch():
    with pytest.raises(ValueError, match="dispatch"):
        EngineSpec(dispatch="eager")
    with pytest.raises(ValueError, match="dispatch"):
        ServeSpec.from_json('{"engine": {"dispatch": "eager"}}')


def test_spec_validates_shapes():
    with pytest.raises(ValueError):
        ServeSpec(backend="trace")               # replay path required
    with pytest.raises(ValueError):
        ServeSpec(backend="nope")
    with pytest.raises(ValueError):
        ClusterSpec(replicas=0)
    with pytest.raises(ValueError):
        ClusterSpec(replicas=2, capacities=(1.0,))
    with pytest.raises(ValueError, match="decode-capable"):
        ClusterSpec(replicas=2, roles=("prefill", "prefill"))
    with pytest.raises(ValueError, match='backend="sim"'):
        ServeSpec(backend="engine", cluster=ClusterSpec(
            replicas=2, autoscale=AutoscalePolicy()))
    with pytest.raises(ValueError, match='backend="sim"'):
        ServeSpec(backend="engine",
                  cluster=ClusterSpec(replicas=2,
                                      sim_overrides=(None, {"pp": 4})))


def test_slo_class_and_priority_serve_on_an_engine():
    with pytest.raises(ValueError, match="slo_class"):
        SamplingParams(slo_class="platinum")
    srv = build(make_spec("engine"), device="cpu")
    out = srv.generate([3] * 16, SamplingParams(max_new_tokens=4,
                                                slo_class="batch",
                                                priority=7))
    assert out.finish_reason == FINISH_LENGTH
    assert len(out.token_ids) == 4
    assert "batch" in srv.stats().attainment_by_class


def test_jax_cluster_spec_validation_agrees():
    """The copied spec validates as the JAX one does."""
    for kw in (dict(replicas=0), dict(replicas=2, capacities=(1.0,)),
               dict(replicas=2, roles=("decode", "decode"))):
        with pytest.raises(ValueError):
            JClusterSpec(**kw)
        with pytest.raises(ValueError):
            ClusterSpec(**kw)


# ---------------------------------------------------------------------------
# the workload and token generators: copies of repro.data
# ---------------------------------------------------------------------------

WORKLOADS = {
    "sharegpt": lambda w: w.sample_requests(w.get_workload("sharegpt"), 20,
                                            4.0, seed=3, vocab=1000),
    "azure": lambda w: w.sample_requests(w.get_workload("azure"), 20, 4.0,
                                         seed=4, vocab=1000),
    "shared_prefix": lambda w: w.shared_prefix_requests(30, 8.0, seed=5,
                                                        vocab=1000),
    "diurnal": lambda w: w.diurnal_requests(30.0, base_rate=1.0,
                                            peak_rate=6.0, seed=6),
    "flash_crowd": lambda w: w.flash_crowd_requests(
        30.0, base_rate=1.0, spike_rate=10.0, spike_start=10.0,
        spike_len=5.0, seed=7),
    "multi_turn": lambda w: w.multi_turn_requests(6, 1.0, seed=8),
}


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_workload_generators_match_jax(name):
    """The same seed gives the same arrivals, prompts and output lengths
    as the JAX package's generators."""
    from repro.data import workload as jax_workload
    from repro_torch.data import workload
    got, want = WORKLOADS[name](workload), WORKLOADS[name](jax_workload)
    assert len(got) > 0 and got == want


def test_token_batches_match_jax():
    from repro.data import tokens as jax_tokens
    from repro_torch.data import tokens
    a = tokens.batches(97, 2, 3, 16, seed=1)
    b = jax_tokens.batches(97, 2, 3, 16, seed=1)
    for _ in range(3):
        x, y = next(a), next(b)
        assert set(x) == set(y) == {"tokens", "labels"}
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def test_build_defaults_to_cuda_and_raises_without_it(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build(make_spec("engine"))
    with pytest.raises(RuntimeError, match="CUDA"):
        build(make_spec("engine2"))
