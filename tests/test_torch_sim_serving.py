"""The port's simulator, trace and autoscale serving paths on the CPU.

`repro_torch.serving.build` serves every spec the JAX package's does: the
roofline simulator (one replica and a `SimCluster`), trace replay (strict
through `LLMServer.replay`, and timing-only as an interactive substrate),
trace recording (`TraceSpec.record`, engine and sim, one replica and a
cluster with its router stream) and the elastic fleet
(`ClusterSpec.autoscale`).  Sim and replay builds touch no tensor and no
device.

Twins of tests/test_serving_api.py's conformance scenarios on the sim,
sim-cluster and timing-only replay substrates and its sim-driven cases
(strict replay of a recorded scenario, rebuild determinism, aborts through
the router's steal queue and in-transit migrations, per-replica
`sim_overrides`, SLO-ordered admission, faults, preemption events), of
tests/test_http.py's cases on a sim spec, and of tests/test_autoscale.py's
sim-driven lifecycle cases: scale-up under a flash crowd, drains that
conserve every request, in-transit re-homes, ordinal accounting, the
auditor's teeth, and strict replay through the scale records.
"""

import asyncio
import json
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import (
    PagedKVManager,
    PipelineScheduler,
    PrefillPolicy,
    Request,
    ThrottleConfig,
)
from repro_torch.data.workload import flash_crowd_requests
from repro_torch.runtime.autoscale import AutoscalePolicy
from repro_torch.runtime.disagg import (
    ROLE_DECODE,
    ROLE_MIXED,
    ROLE_PREFILL,
    HandoffPolicy,
    retirable,
)
from repro_torch.runtime.router import ReplicaRouter, SimCluster
from repro_torch.runtime.simulator import PipelineSimulator, cost_model_for
from repro_torch.runtime.trace import (SCHEMA_MAJOR, Trace, TraceDivergence,
                                       check_trace, replay_trace)
from repro_torch.serving import (
    FINISH_ABORT,
    FINISH_LENGTH,
    FINISH_STOP,
    ClusterSpec,
    EngineSpec,
    HTTPFrontend,
    SamplingParams,
    ServeSpec,
    SimSpec,
    TraceSpec,
    build,
)

CFG = get_config("qwen2.5-14b")
SIM_ENGINE = EngineSpec(arch="qwen2.5-14b")
SIM = SimSpec(pp=2, pages=256, page_size=8)
TOY_ENGINE = EngineSpec(
    arch="qwen1.5-0.5b",
    throttle=dict(num_iters_T=2, max_prefill_tokens=16,
                  min_prefill_tokens=4),
    dims=dict(C=16, pages=256, Bp=32, Bd=32))

BACKENDS = ["sim", "sim2", "replay"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the few engine cases: their tensors are tiny,
    and under the suite's parallel workers torch's default threads spin
    against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_card(monkeypatch):
    """Sim and trace builds never ask for a device: with CUDA reported
    absent they still build (an engine build would raise)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def make_spec(kind, record=None):
    trace = TraceSpec(record=record) if record else None
    if kind == "sim":
        return ServeSpec(backend="sim", engine=SIM_ENGINE, sim=SIM,
                         trace=trace)
    if kind == "sim2":
        return ServeSpec(backend="sim", engine=SIM_ENGINE, sim=SIM,
                         cluster=ClusterSpec(replicas=2), trace=trace)
    if kind == "engine":
        return ServeSpec(engine=TOY_ENGINE, trace=trace)
    if kind == "engine2":
        return ServeSpec(engine=TOY_ENGINE,
                         cluster=ClusterSpec(replicas=2), trace=trace)
    raise ValueError(kind)


@pytest.fixture(scope="module")
def replay_source(tmp_path_factory):
    """A recorded sim run: the substrate of the timing-only replay server."""
    path = str(tmp_path_factory.mktemp("traces") / "source.trace.jsonl")
    srv = build(make_spec("sim", record=path))
    for i in range(4):
        srv.submit([i + 1] * 12, SamplingParams(max_new_tokens=6))
    srv.drain()
    srv.close()
    return path


@pytest.fixture(scope="module", params=BACKENDS)
def server(request, replay_source):
    if request.param == "replay":
        return build(ServeSpec(
            backend="trace",
            trace=TraceSpec(replay=replay_source, timing_only=True)))
    return build(make_spec(request.param))


def prompt(server, n, seed=0):
    rng = np.random.default_rng(seed)
    vocab = server.cfg.vocab_size if server.cfg is not None else 1000
    return [int(t) for t in rng.integers(0, vocab, n)]


# ---------------------------------------------------------------------------
# the shared scenarios, on the sim, sim-cluster and timing-only substrates
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
        assert a.token_ids == b.token_ids        # placeholder / replayed

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


def test_sim_builds_the_spec_geometry_at_the_cards_rates():
    from repro_torch.roofline import analysis
    from repro_torch.runtime import simulator
    srv = build(ServeSpec(backend="sim", engine=SIM_ENGINE,
                          sim=SimSpec(pp=4, pages=128, page_size=8,
                                      runtime="vllm", straggler_stage=1,
                                      straggler_factor=2.0)))
    sim = srv.engine
    assert isinstance(sim, PipelineSimulator) and sim.pp == 4
    assert sim.sched.kv.num_pages == 128 and sim.sched.kv.page_size == 8
    assert sim.sched.cfg.pipeline_depth == 4
    assert sim.backend.runtime == simulator.RuntimeModel.vllm_like()
    assert sim.backend.straggler == (1, 2.0)
    assert sim.backend.cost == cost_model_for(CFG, pp=4)
    assert sim.backend.cost.net_bw == analysis.NVLINK_BW
    assert srv.cfg.name == "qwen2.5-14b"


# ---------------------------------------------------------------------------
# record -> strict replay is bit-identical
# ---------------------------------------------------------------------------

def _scenario(server):
    """The canonical mixed scenario: a normal request, an aborted one, a
    stop-token one.  Returns {rid: (tokens, finish_reason)}."""
    r1 = server.submit([1] * 16, SamplingParams(max_new_tokens=6))
    r2 = server.submit([2] * 20, SamplingParams(max_new_tokens=40))
    server.step(); server.step(); server.step()
    assert server.abort(r2)
    r3 = server.submit([3] * 10, SamplingParams(max_new_tokens=4,
                                                stop_token_ids=(0,)))
    server.drain()
    return {o.request_id: (tuple(o.token_ids), o.finish_reason)
            for o in server.outputs([r1, r2, r3])}


def test_strict_replay_reproduces_recorded_scenario(tmp_path):
    path = str(tmp_path / "scenario.trace.jsonl")
    rec = build(make_spec("sim", record=path))
    want = _scenario(rec)
    rec.close()
    assert sorted(r for _, r in want.values()) == ["abort", "length", "stop"]

    replay = build(ServeSpec(backend="trace", trace=TraceSpec(replay=path)))
    outs = replay.replay()
    got = {o.request_id: (tuple(o.token_ids), o.finish_reason) for o in outs}
    assert got == want
    assert replay.last_report.ticks == len(Trace.load(path).ticks)

    # interactive calls are refused with a pointer at the right spec
    with pytest.raises(RuntimeError, match="timing_only"):
        replay.generate([1, 2, 3])


def test_engine_records_and_server_replays(tmp_path):
    """`TraceSpec.record` on an engine spec: the port's engine records the
    scenario; a trace server replays it strictly to the same tokens."""
    path = str(tmp_path / "engine.trace.jsonl")
    rec = build(make_spec("engine", record=path), device="cpu")
    want = {rid: toks for rid, (toks, _) in _scenario(rec).items()}
    rec.close()
    replay = build(ServeSpec(backend="trace", trace=TraceSpec(replay=path)))
    got = {o.request_id: tuple(o.token_ids) for o in replay.replay()}
    assert got == want
    check_trace(path)


def test_engine_cluster_records_replicas_and_router(tmp_path):
    path = str(tmp_path / "cluster")
    srv = build(make_spec("engine2", record=path), device="cpu")
    rids = [srv.submit([i + 1] * (8 + i), SamplingParams(max_new_tokens=3))
            for i in range(4)]
    srv.drain()
    want = {o.request_id: list(o.token_ids) for o in srv.outputs(rids)}
    srv.close()
    got = {}
    for i in range(2):
        report = check_trace(f"{path}.replica{i}")
        got.update(report.outputs())
    assert got == want
    route = Trace.load(f"{path}.router", expect="gllm-route")
    assert route.header["replicas"] == 2
    decisions = [r for r in route.records if r["kind"] == "route"]
    assert len(decisions) == 4


def test_sim_cluster_records_under_a_directory(tmp_path):
    d = str(tmp_path / "simcluster")
    srv = build(make_spec("sim2", record=d))
    for i in range(6):
        srv.submit([i + 1] * 12, SamplingParams(max_new_tokens=4))
    srv.drain()
    srv.close()
    names = sorted(os.listdir(d))
    assert names == ["replica0.trace.jsonl", "replica1.trace.jsonl",
                     "router.trace.jsonl"]
    assert sum(len(check_trace(os.path.join(d, n)).finished)
               for n in names[:2]) == 6


def test_strict_replay_of_a_tampered_trace_diverges(tmp_path):
    path = str(tmp_path / "s.trace.jsonl")
    rec = build(make_spec("sim", record=path))
    _scenario(rec)
    rec.close()
    lines = open(path).read().splitlines()
    k = next(i for i, l in enumerate(lines)
             if json.loads(l)["kind"] == "tick" and json.loads(l)["batch"])
    tick = json.loads(lines[k])
    tick["decode_budget"] += 1
    lines[k] = json.dumps(tick)
    bad = tmp_path / "bad.trace.jsonl"
    bad.write_text("\n".join(lines) + "\n")
    with pytest.raises(TraceDivergence, match="decode_budget"):
        build(ServeSpec(backend="trace",
                        trace=TraceSpec(replay=str(bad)))).replay()


def test_sim_rebuild_is_deterministic():
    a = build(make_spec("sim"))
    b = build(make_spec("sim"))
    wa = _scenario(a)
    wb = _scenario(b)
    assert set(wa.values()) == set(wb.values())  # fresh rid namespaces


# ---------------------------------------------------------------------------
# abort through the router: steal queues and in-transit migrations
# ---------------------------------------------------------------------------

@pytest.fixture()
def sim_cluster_server():
    return build(ServeSpec(backend="sim", engine=SIM_ENGINE,
                           sim=SimSpec(pp=2, pages=128, page_size=8),
                           cluster=ClusterSpec(replicas=2)))


def test_abort_in_transit_migration_frees_everything(sim_cluster_server):
    srv = sim_cluster_server
    cluster = srv.engine
    router = cluster.router
    rid = srv.submit([1] * 24, SamplingParams(max_new_tokens=64))
    for _ in range(8):
        srv.step()
    src = next(i for i, s in enumerate(cluster.sims)
               if s.scheduler.kv.has_request(rid))
    assert router.migrate_request(rid, src, 1 - src)
    assert router.has_in_transit                 # modeled transfer latency
    assert srv.abort(rid)
    assert not router.has_in_transit
    assert srv.get(rid).finish_reason == FINISH_ABORT
    srv.drain()
    for s in cluster.sims:
        assert not s.scheduler.kv.has_request(rid)
        assert s.scheduler.kv.kv_free_rate == 1.0
    assert rid not in router._migrations_of
    assert rid in {r.request_id for r in router.finished}


def test_abort_stolen_waiting_request(sim_cluster_server):
    srv = sim_cluster_server
    cluster = srv.engine
    router = cluster.router
    rid = srv.submit([2] * 16, SamplingParams(max_new_tokens=8))
    src = next(i for i, s in enumerate(cluster.sims)
               if any(r.request_id == rid for r in s.scheduler.waiting))
    assert router.migrate_request(rid, src, 1 - src)   # waiting => steal
    dst = cluster.sims[1 - src].scheduler
    assert any(r.request_id == rid for r in dst.waiting)
    assert srv.abort(rid)
    assert srv.get(rid).finish_reason == FINISH_ABORT
    assert not any(r.request_id == rid for r in dst.waiting)
    assert dst.kv.kv_free_rate == 1.0


def test_cluster_drain_reports_each_finish_exactly_once():
    srv = build(ServeSpec(backend="sim", engine=SIM_ENGINE, sim=SIM,
                          cluster=ClusterSpec(replicas=2)))
    rids = [srv.submit([i + 1] * 12, SamplingParams(max_new_tokens=4))
            for i in range(6)]
    seen = [o.request_id for o in srv.drain()]
    assert sorted(seen) == sorted(rids), seen
    assert min(srv.stats().routed_counts) >= 1, "needs both replicas used"


def test_fault_finalizes_pending_abort():
    srv = build(ServeSpec(backend="sim", engine=SIM_ENGINE,
                          sim=SimSpec(pp=2, pages=256, page_size=8)))
    sim = srv.engine
    rid = srv.submit([1] * 12, SamplingParams(max_new_tokens=8))
    srv.step()                        # micro-batch in flight (depth 2)
    req = srv._requests[rid]
    assert srv.abort(rid) and not req.is_finished     # deferred
    sim.inject_failure(sim.backend.time, downtime=0.5)
    srv.drain()
    out = srv.get(rid)
    assert out.finish_reason == FINISH_ABORT
    assert out.metrics.finish_time >= out.metrics.arrival_time
    assert rid in {r.request_id for r in sim.metrics.finished}
    assert sim.scheduler.kv.kv_free_rate == 1.0
    assert not sim.scheduler.has_work


def test_preemption_surfaces_stream_events_on_the_sim():
    from repro_torch.serving import EVENT_PREEMPT, EVENT_PREEMPT_RESUMED
    srv = build(ServeSpec(backend="sim", engine=SIM_ENGINE,
                          sim=SimSpec(pp=1, pages=8, page_size=4)))

    async def collect(stream):
        return [d async for d in stream]

    async def run():
        return await asyncio.gather(*[
            collect(srv.generate_stream([i + 1] * 8,
                                        SamplingParams(max_new_tokens=16)))
            for i in range(2)])

    deltas = [d for out in asyncio.run(run()) for d in out]
    assert srv.stats().replicas[0].preemptions >= 1, "needs KV pressure"
    events = [d.event for d in deltas if d.event is not None]
    assert EVENT_PREEMPT in events
    assert EVENT_PREEMPT_RESUMED in events
    finals = [d for d in deltas if d.finish_reason is not None]
    assert len(finals) == 2


# ---------------------------------------------------------------------------
# per-request SLO class + per-replica overrides through the public surface
# ---------------------------------------------------------------------------

def test_slo_class_and_priority_serve_on_the_sim():
    srv = build(make_spec("sim"))
    out = srv.generate([3] * 16, SamplingParams(max_new_tokens=4,
                                                slo_class="batch",
                                                priority=7))
    assert out.finish_reason == FINISH_LENGTH
    assert len(out.token_ids) == 4


def test_sim_overrides_build_heterogeneous_replicas():
    spec = ServeSpec(backend="sim", engine=SIM_ENGINE, sim=SIM,
                     cluster=ClusterSpec(replicas=2, sim_overrides=(
                         None, {"pp": 4, "pages": 64})))
    srv = build(spec)
    assert srv.replicas[0].pp == 2 and srv.replicas[1].pp == 4
    assert srv.replicas[0].sched.kv.num_pages == 256
    assert srv.replicas[1].sched.kv.num_pages == 64
    for _ in range(4):
        srv.generate([1] * 32, SamplingParams(max_new_tokens=2))
    assert sum(srv.stats().routed_counts) == 4
    srv.close()


def test_interactive_beats_equal_arrival_batch_on_ttft():
    spec = ServeSpec(backend="sim",
                     engine=EngineSpec(arch="qwen2.5-14b",
                                       throttle=dict(max_prefill_tokens=64)),
                     sim=SimSpec(pp=4, pages=1024, page_size=8))
    srv = build(spec)
    for _ in range(10):     # ~960 pending prefill tokens: budget saturated
        srv.submit([1] * 96, SamplingParams(max_new_tokens=8))
    rid_batch = srv.submit([2] * 64, SamplingParams(max_new_tokens=8,
                                                    slo_class="batch"))
    rid_inter = srv.submit([2] * 64, SamplingParams(max_new_tokens=8))
    srv.drain()
    ttft_batch = srv.get(rid_batch).metrics.ttft()
    ttft_inter = srv.get(rid_inter).metrics.ttft()
    assert ttft_inter is not None and ttft_batch is not None
    assert ttft_inter < ttft_batch
    srv.close()


def test_sim_overrides_validation():
    with pytest.raises(ValueError, match="one sim_overrides"):
        ClusterSpec(replicas=2, sim_overrides=({"pp": 4},))
    with pytest.raises(ValueError, match="unknown SimSpec fields"):
        ClusterSpec(replicas=1, sim_overrides=({"nope": 1},))
    with pytest.raises(ValueError, match='backend="sim"'):
        ServeSpec(backend="engine",
                  cluster=ClusterSpec(replicas=2,
                                      sim_overrides=(None, {"pp": 4})))


# ---------------------------------------------------------------------------
# the launcher's trace flags
# ---------------------------------------------------------------------------

def test_launcher_replays_a_trace_without_a_model(capsys, monkeypatch):
    from repro_torch.launch import serve as launcher
    fixture = os.path.join(os.path.dirname(__file__), "fixtures", "traces",
                           "prefill_heavy.trace.jsonl")
    monkeypatch.setattr(launcher, "build_params", None)   # never called
    monkeypatch.setattr("sys.argv", ["serve", "--trace-replay", fixture])
    launcher.main()
    out = capsys.readouterr().out
    assert "strict replay — 76 ticks, 28 requests" in out
    assert "decisions match the recording" in out


def test_launcher_records_with_trace_out(tmp_path, capsys, monkeypatch):
    from repro_torch.launch import serve as launcher
    path = str(tmp_path / "run.trace.jsonl")
    monkeypatch.setattr("sys.argv", [
        "serve", "--reduced", "--device", "cpu", "--requests", "3",
        "--max-new", "3", "--trace-out", path])
    launcher.main()
    assert "3/3 requests" in capsys.readouterr().out
    report = check_trace(path)
    assert len(report.finished) == 3
    monkeypatch.setattr("sys.argv", [
        "serve", "--reduced", "--dump-spec", "--trace-out", path])
    launcher.main()
    assert json.loads(capsys.readouterr().out)["trace"]["record"] == path


# ---------------------------------------------------------------------------
# HTTP on a sim spec (twins of tests/test_http.py)
# ---------------------------------------------------------------------------

HTTP_SPEC = ServeSpec(backend="sim", engine=EngineSpec(arch="qwen2.5-14b"),
                      sim=SimSpec(pp=2, pages=256, page_size=8))


@pytest.fixture()
def frontend():
    fe = HTTPFrontend(build(HTTP_SPEC), port=0).start()
    yield fe
    fe.shutdown()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST")
    return urllib.request.urlopen(req, timeout=30)


def _json(resp):
    return json.loads(resp.read())


def _sse_frames(resp):
    for line in resp:
        line = line.decode().strip()
        if line.startswith("data: "):
            yield json.loads(line[len("data: "):])


def test_http_generate_on_the_sim(frontend):
    out = _json(_post(frontend.url + "/v1/generate",
                      {"prompt": [1, 2, 3, 4], "max_new_tokens": 5}))
    assert out["finish_reason"] == "length"
    assert len(out["token_ids"]) == 5
    assert out["prompt_tokens"] == 4
    assert out["metrics"]["e2el"] >= out["metrics"]["ttft"]


def test_http_stream_on_the_sim(frontend):
    resp = _post(frontend.url + "/v1/generate?stream=1",
                 {"prompt": [5, 6, 7], "max_new_tokens": 4})
    assert resp.headers["Content-Type"] == "text/event-stream"
    frames = list(_sse_frames(resp))
    tokens = [f for f in frames if f["token"] is not None]
    assert [f["index"] for f in tokens] == [1, 2, 3, 4]
    assert frames[-1]["finish_reason"] == "length"


def test_http_stats_on_the_sim(frontend):
    _json(_post(frontend.url + "/v1/generate",
                {"prompt": [1] * 16, "max_new_tokens": 6}))
    stats = _json(urllib.request.urlopen(frontend.url + "/v1/stats",
                                         timeout=30))
    assert len(stats["replicas"]) == 1
    rep = stats["replicas"][0]
    assert rep["tokens_retired"] >= 6 and rep["ticks"] > 0


def test_http_heterogeneous_sim_cluster():
    spec = ServeSpec(backend="sim", engine=EngineSpec(arch="qwen2.5-14b"),
                     sim=SimSpec(pp=2, pages=256, page_size=8),
                     cluster=ClusterSpec(replicas=2, sim_overrides=(
                         None,
                         {"straggler_stage": 0, "straggler_factor": 8.0})))
    fe = HTTPFrontend(build(spec), port=0).start()
    try:
        for i in range(6):
            out = _json(_post(fe.url + "/v1/generate",
                              {"prompt": [i + 1] * 24,
                               "max_new_tokens": 4}))
            assert out["finish_reason"] == "length"
        stats = _json(urllib.request.urlopen(fe.url + "/v1/stats",
                                             timeout=30))
        assert len(stats["replicas"]) == 2
        assert sum(stats["routed_counts"]) == 6
        assert stats["routed_counts"][0] >= stats["routed_counts"][1]
    finally:
        fe.shutdown()


def test_http_concurrent_streams_on_the_sim():
    fe = HTTPFrontend(build(HTTP_SPEC), port=0).start()
    results = {}

    def one(name, n):
        resp = _post(fe.url + "/v1/generate?stream=1",
                     {"prompt": [1, 2, 3], "max_new_tokens": n})
        results[name] = list(_sse_frames(resp))

    try:
        threads = [threading.Thread(target=one, args=(f"c{i}", 3 + i))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert results["c0"][-1]["finish_reason"] == "length"
        assert results["c1"][-1]["finish_reason"] == "length"
        assert len([f for f in results["c1"] if f["token"] is not None]) == 4
    finally:
        fe.shutdown()


# ---------------------------------------------------------------------------
# the elastic fleet on the simulator (twins of tests/test_autoscale.py)
# ---------------------------------------------------------------------------

def make_sim(pp=2, pages=512, page_size=8, caching=False):
    th = ThrottleConfig(pipeline_depth=pp, policy=PrefillPolicy.GLLM)
    kv = PagedKVManager(num_pages=pages, page_size=page_size,
                        enable_prefix_caching=caching)
    sched = PipelineScheduler(th, kv, max_model_len=pages * page_size)
    return PipelineSimulator(sched, pp, cost_model_for(CFG, pp=pp))


def elastic_cluster(n=1, *, policy=None, roles=None, trace_dir=None,
                    pages=512, caching=False):
    """`n` mixed sims behind an autoscaling router whose factory mints more
    of the same geometry."""
    pol = policy or AutoscalePolicy(interval=0.05, max_replicas=6,
                                    up_cooldown=0.1, down_cooldown=0.5,
                                    target_queue=2.0)
    sims = [make_sim(pages=pages, caching=caching) for _ in range(n)]
    router = ReplicaRouter(
        sims, policy="balanced", roles=roles, autoscale=pol,
        replica_factory=lambda o: make_sim(pages=pages, caching=caching))
    return SimCluster(sims, router, trace_dir=trace_dir)


# requests in the one-second spike: at the card's rates a replica serves
# the JAX suite's 40-60 without pressure, so the crowd here is 120
CROWD = 120


def flash_crowd(num=CROWD, seed=0):
    return flash_crowd_requests(4.0, base_rate=1e-9, spike_rate=num / 1.0,
                                spike_start=0.5, spike_len=1.0,
                                mean_input=64.0, mean_output=16.0, seed=seed)


def alive_rids(router):
    """Every live request id in the cluster, including mid-tick in-flight
    ones that have left `waiting` but not yet entered a running list."""
    out = []
    for r in router.replicas:
        sched = r.scheduler
        seen = set()
        for group in (sched.waiting, sched.running_prefill,
                      sched.running_decode):
            for req in group:
                seen.add(req.request_id)
        for bid in sched.active_batch_ids():
            for seq in sched.get_batch(bid).seqs:
                seen.add(seq.request.request_id)
        out.extend(seen)
    return out


def run_ticks(sched, n, clock_start=0.0):
    """Drive a bare scheduler loop: schedule+complete with dummy tokens."""
    now = clock_start
    for _ in range(n):
        batch = sched.schedule(now)
        toks = [7] * sum(1 for s in batch.seqs if s.produces_token)
        sched.complete(batch.batch_id, toks, now)
        now += 0.01
    return now


# ---------------------------------------------------------------------------
# lifecycle: scale-up, drain, retire
# ---------------------------------------------------------------------------

class TestScaleUp:
    def test_add_replica_requires_factory(self):
        router = ReplicaRouter([make_sim()])
        with pytest.raises(RuntimeError, match="replica_factory"):
            router.add_replica()

    def test_flash_crowd_grows_fleet_and_conserves_requests(self):
        cluster = elastic_cluster(1)
        router = cluster.router
        reqs = flash_crowd()
        fin = cluster.run(reqs, until=120.0)
        st = router.autoscale_stats
        assert st.replicas_added > 0, "flash crowd must trigger scale-up"
        assert len(fin) == len(reqs)
        router.check_invariants(
            expected_rids=[r.request_id for r in fin])
        # the burst absorbed, underload drains the fleet back down
        assert st.retired > 0
        assert len(router.replicas) < 1 + st.replicas_added
        up_sizes = [s for _, k, s in st.events if k == "scale_up"]
        assert up_sizes == sorted(up_sizes)

    def test_newborn_replicas_get_namespaced_rid_streams(self):
        cluster = elastic_cluster(1)
        cluster.run(flash_crowd(), until=120.0)
        fin = cluster.finished
        assert len(fin) == len({r.request_id for r in fin})

    def test_up_cooldown_rate_limits_growth(self):
        pol = AutoscalePolicy(interval=0.05, up_cooldown=1e9,
                              max_replicas=6, target_queue=2.0)
        cluster = elastic_cluster(1, policy=pol)
        cluster.run(flash_crowd(), until=120.0)
        assert cluster.router.autoscale_stats.scale_ups <= 1


class TestDrain:
    def _loaded_cluster(self):
        """3 mixed replicas, replica 0 holding waiting + resident work."""
        sims = [make_sim() for _ in range(3)]
        router = ReplicaRouter(sims, policy="balanced")
        for k in range(6):
            sims[0].inject_request(0.0, [1] * 64, 8)
        sims[0].run_until(0.05)  # some admitted + resident, some waiting
        return SimCluster(sims, router), router

    def test_drain_conserves_and_retires_with_empty_pool(self):
        cluster, router = self._loaded_cluster()
        victim = router.replicas[0]
        rids = alive_rids(router)
        assert len(rids) == 6
        router.start_drain(0, now=0.05)
        cluster.drain()
        assert victim in router.retired
        assert sorted(r.request_id for r in cluster.finished) == sorted(rids)
        router.check_invariants(expected_rids=rids)
        # no KV leaked on retire: the victim's pool is fully free
        kv = victim.sched.kv
        assert kv.num_free_pages == kv.num_pages
        assert router.autoscale_stats.drain_moves > 0
        assert router.autoscale_stats.retired == 1

    def test_draining_replica_masked_from_admission(self):
        cluster, router = self._loaded_cluster()
        router.start_drain(0, now=0.05)
        assert 0 not in router._admissible
        for _ in range(8):
            assert router.select(16) != 0

    def test_drain_refuses_to_break_role_cover(self):
        sims = [make_sim(), make_sim()]
        router = ReplicaRouter(sims, roles=(ROLE_PREFILL, ROLE_DECODE),
                               handoff=HandoffPolicy(interval=0.01))
        for i in range(2):  # each is the last of its kind
            with pytest.raises(ValueError, match="cover"):
                router.start_drain(i)
        single = ReplicaRouter([make_sim()])
        with pytest.raises(ValueError, match="cover"):
            single.start_drain(0)

    def test_double_drain_rejected(self):
        cluster, router = self._loaded_cluster()
        router.start_drain(0, now=0.05)
        with pytest.raises(ValueError, match="already draining"):
            router.start_drain(0, now=0.06)

    def test_retirable_keeps_prefill_and_decode_cover(self):
        assert retirable((ROLE_MIXED, ROLE_MIXED), 0)
        assert not retirable((ROLE_PREFILL, ROLE_DECODE), 0)
        assert not retirable((ROLE_PREFILL, ROLE_DECODE), 1)
        assert retirable((ROLE_PREFILL, ROLE_MIXED, ROLE_DECODE), 0)
        assert not retirable((ROLE_MIXED,), 0)

    def test_autoscaler_never_drains_last_role_holder(self):
        """Underload on a disaggregated fleet: the scale-down pass must
        skip the lowest-pressure victim when removing it would break role
        cover — the pure-prefill replica survives every drain because it
        is the fleet's only prefill capability."""
        pol = AutoscalePolicy(interval=0.05, min_replicas=1,
                              down_cooldown=0.0, target_queue=2.0)
        sims = [make_sim() for _ in range(3)]
        router = ReplicaRouter(sims, roles=(ROLE_PREFILL, ROLE_DECODE,
                                            ROLE_DECODE),
                               handoff=HandoffPolicy(interval=0.01),
                               autoscale=pol)
        for t in range(1, 40):  # idle fleet, many passes: EWMA decays to 0
            router.control_tick(t * 0.05)
        # one redundant decode replica retired; the survivors are exactly
        # the minimal role cover, which no further pass may shrink
        assert router.autoscale_stats.retired == 1
        assert sims[0] in router.replicas, "last prefill must survive"
        assert router.roles == (ROLE_PREFILL, ROLE_DECODE)
        assert router.retired[0] in (sims[1], sims[2])


# ---------------------------------------------------------------------------
# in-transit deliveries across fleet changes (re-home, §15/§13 composition)
# ---------------------------------------------------------------------------

class TestInTransitRehome:
    def _resident_on(self, sim, rid="mig", tokens=64, out=32):
        """Drive the bare scheduler to a clean tick boundary with `rid`
        resident in decode (no sim-loop tick in flight, so the control
        plane may drain it)."""
        req = Request(rid, [1] * tokens, SamplingParams(max_new_tokens=out))
        sim.sched.add_request(req)
        run_ticks(sim.sched, 4)
        assert req in sim.sched.running_decode
        return req

    def test_delivery_to_draining_dst_is_rehomed_not_dropped(self):
        sims = [make_sim() for _ in range(3)]
        router = ReplicaRouter(sims, policy="balanced")
        req = self._resident_on(sims[0])
        assert router.migrate_request(req.request_id, 0, 1, now=0.1)
        assert router.has_in_transit
        router.start_drain(1, now=0.1)
        # flush past the transfer delay: dst is draining -> re-homed
        router.control_tick(10.0)
        assert not router.has_in_transit
        assert router.autoscale_stats.rehomed == 1
        assert not any(r.request_id == req.request_id
                       for r in sims[1].sched.waiting)
        assert not sims[1].sched.kv.has_request(req.request_id)
        assert req in sims[2].sched.running_decode or any(
            r.request_id == req.request_id for r in sims[2].sched.waiting
        ) or req in sims[0].sched.running_decode
        router.check_invariants(expected_rids=[req.request_id])

    def test_retire_waits_for_in_transit_toward_victim(self):
        """Satellite regression: drain a replica that is mid-handoff
        *destination* — the victim cannot retire while a payload is on the
        wire toward it, and the flush re-homes instead of delivering into
        a draining replica (no request is double-moved)."""
        sims = [make_sim() for _ in range(3)]
        router = ReplicaRouter(sims, policy="balanced",
                               roles=(ROLE_PREFILL, ROLE_DECODE, ROLE_MIXED),
                               handoff=HandoffPolicy(interval=0.05,
                                                     max_decode_tokens=4))
        req = self._resident_on(sims[0], rid="hand")
        # ship the first-decode request prefill -> decode (§15)
        assert router._move_request("hand", 0, 1, now=0.1, kind="handoff")
        assert router.has_in_transit
        dst_ord = router._in_transit[0][2]
        assert dst_ord == router.replica_ids[1]
        router.start_drain(1, now=0.1)
        assert not router._try_retire(dst_ord, 0.1)
        assert router._index_of(dst_ord) is not None
        router.control_tick(10.0)
        st = router.autoscale_stats
        assert st.rehomed == 1
        # re-homed to the only serving decode-capable replica: the mixed one
        assert req in sims[2].sched.running_decode or any(
            r.request_id == "hand" for r in sims[2].sched.waiting)
        assert sims[1] in router.retired
        # moved exactly once per plane: the handoff happened, then the
        # re-home redirected the same delivery — no second export
        assert router.disagg_stats.handoffs == 1
        router.check_invariants(expected_rids=["hand"])

    def test_drain_of_prefix_adopted_head_is_plain_steal(self):
        """Satellite regression (§13 x §16): a waiting request whose block
        table is an adopted prefix head drains as a steal — the head is
        released at the source (no page leak at retire), no KV crosses the
        wire, and the destination re-admits from scratch."""
        sims = [make_sim(caching=True, pages=256), make_sim(caching=True,
                                                            pages=256)]
        router = ReplicaRouter(sims, policy="balanced")
        src = sims[0].sched
        shared = list(range(16))
        warm = Request("warm", shared + [77],
                       SamplingParams(max_new_tokens=2))
        src.add_request(warm)
        sims[0].run_until(0.5)
        assert warm.is_finished
        victim = Request("victim", shared + [90, 91, 92],
                         SamplingParams(max_new_tokens=3))
        cached, pages = src.kv.match_prefix(victim.effective_prompt[:-1])
        assert cached == len(shared)
        src.kv.adopt_prefix("victim", cached, pages)
        victim.num_prefilled = cached
        src.waiting.append(victim)

        router.start_drain(0, now=0.5)
        router.control_tick(0.6)
        assert router.rebalance_stats.stolen == 1
        assert router.rebalance_stats.migrated == 0  # no KV on the wire
        assert victim in sims[1].sched.waiting
        assert victim.num_prefilled == 0
        assert sims[0] in router.retired
        # the adopted head was released at drain: no page pinned to the rid
        assert not sims[0].sched.kv.has_request("victim")
        router.check_invariants(expected_rids=["victim"])


# ---------------------------------------------------------------------------
# ordinal-keyed accounting across fleet-size changes
# ---------------------------------------------------------------------------

class TestElasticAccounting:
    def test_routed_counts_survive_add_and_retire(self):
        """Regression: per-replica counters are keyed by ordinal, so a
        retire must shift positions without reassigning history."""
        cluster = elastic_cluster(2)
        router = cluster.router
        for _ in range(6):
            router.select(16)
        before = dict(zip(router.replica_ids, router.routed_counts))
        new_i = router.add_replica(now=0.0)
        assert router.routed_counts[new_i] == 0
        router.start_drain(0, now=0.0)
        router.control_tick(0.1)   # empty victim retires immediately
        assert len(router.replicas) == 2
        after = dict(zip(router.replica_ids, router.routed_counts))
        for ordinal, count in after.items():
            assert count == before.get(ordinal, 0)

    def test_stats_and_scores_tolerate_fleet_changes_between_passes(self):
        """Regression: `scores`/`_calibrate` must not assume the fleet size
        they saw last pass — every per-replica list is rebuilt per call and
        keyed bookkeeping follows the ordinal."""
        from repro_torch.runtime.router import RebalancePolicy
        sims = [make_sim() for _ in range(3)]
        router = ReplicaRouter(sims, rebalance=RebalancePolicy(interval=0.1),
                               replica_factory=lambda o: make_sim())
        sims[0].inject_request(0.0, [1] * 32, 4)
        sims[0].run(1.0)
        router.control_tick(0.1)    # calibration pass at fleet size 3
        router.add_replica(now=0.2)
        router.start_drain(0, now=0.2)
        router.control_tick(0.3)    # pass across add + retire
        assert len(router.scores(16)) == len(router.replicas) == 3
        assert len(router._caps_eff) == len(router.replicas)
        router.control_tick(0.4)
        assert router.rebalance_stats.passes >= 2

    def test_finished_history_survives_retirement(self):
        cluster, router = TestDrain()._loaded_cluster()
        router.start_drain(0, now=0.05)
        cluster.drain()
        assert router.autoscale_stats.retired == 1
        assert len(cluster.finished) == 6  # includes work the victim did

    def test_server_stats_expose_live_fleet_ordinals(self):
        """The stats surface stays position-aligned with the live fleet and
        names each row's stable ordinal, so consumers can join counters
        across scale events (retired ordinals leave the list, newborns get
        fresh ones)."""
        from repro_torch.serving import ClusterSpec, SamplingParams, ServeSpec, \
            SimSpec, build
        srv = build(ServeSpec(
            backend="sim",
            sim=SimSpec(pp=2, pages=256, page_size=8),
            cluster=ClusterSpec(replicas=1, autoscale=AutoscalePolicy(
                interval=0.05, max_replicas=4, target_queue=2.0,
                up_cooldown=0.1, down_cooldown=0.5))))
        try:
            for i in range(40):
                srv.submit([100 + i] * 64,
                           SamplingParams(max_new_tokens=64))
            srv.drain()
            s = srv.stats()
            assert s.autoscale is not None
            assert s.autoscale.replicas_added > 0
            assert (len(s.replica_ordinals) == len(s.replicas)
                    == len(s.routed_counts))
            assert len(set(s.replica_ordinals)) == len(s.replica_ordinals)
            assert s.fleet_size + s.draining == len(s.replicas)
            if s.autoscale.retired:
                # retired ordinals are gone from the live view but their
                # work is not: total placements still cover every request
                assert s.retired == s.autoscale.retired
            from repro_torch.serving.http import stats_to_json
            doc = stats_to_json(s)
            assert doc["replica_ordinals"] == list(s.replica_ordinals)
        finally:
            srv.close()


# ---------------------------------------------------------------------------
# the auditor has teeth: a broken drain must be caught
# ---------------------------------------------------------------------------

class TestAuditorTeeth:
    def test_lossy_drain_is_caught(self, monkeypatch):
        """Deliberately break `_drain_move` to drop requests on the floor
        (drain from the source, never deliver): `check_invariants` with the
        submitted rid set must fail with "lost". If this test ever passes
        silently the whole chaos layer is decorative."""
        cluster, router = TestDrain()._loaded_cluster()
        rids = alive_rids(router)

        def lossy(victim_i, dst_i, req, now):
            sched = router.replicas[victim_i].scheduler
            drained = sched.drain_request(req.request_id)
            if drained is None:
                return False
            if sched.kv.has_request(req.request_id):
                sched.kv.free(req.request_id)
            return True     # "moved" — but nobody received it

        monkeypatch.setattr(router, "_drain_move", lossy)
        router.start_drain(0, now=0.05)
        router.control_tick(0.1)
        assert router.autoscale_stats.drain_moves > 0
        with pytest.raises(AssertionError, match="lost"):
            router.check_invariants(expected_rids=rids)

    def test_duplicating_drain_is_caught(self):
        """A drain that delivers without removing from the source leaves
        the rid alive in two schedulers — the other failure mode the
        auditor must see."""
        sims = [make_sim(), make_sim()]
        router = ReplicaRouter(sims)
        req = Request("dup", [1] * 16, SamplingParams(max_new_tokens=2))
        sims[0].sched.add_request(req)
        sims[1].sched.adopt_request(
            Request("dup", [1] * 16, SamplingParams(max_new_tokens=2)))
        with pytest.raises(AssertionError, match="both"):
            router.check_invariants()


# ---------------------------------------------------------------------------
# recording: elastic runs replay; old traces still load
# ---------------------------------------------------------------------------

class TestElasticTraces:
    def test_strict_replay_through_scale_records(self, tmp_path):
        d = str(tmp_path / "elastic")
        cluster = elastic_cluster(1, trace_dir=d)
        cluster.run(flash_crowd(), until=120.0)
        st = cluster.router.autoscale_stats
        assert st.replicas_added > 0 and st.retired > 0
        for s in cluster.sims:
            if s.recorder is not None:
                s.recorder.close()
        cluster.router.close_trace()
        names = sorted(n for n in os.listdir(d) if n.startswith("replica"))
        assert len(names) == 1 + st.replicas_added
        saw_scale = 0
        for name in names:
            path = os.path.join(d, name)
            kinds = [json.loads(l)["kind"] for l in open(path)]
            saw_scale += sum(k in ("scale_up", "drain", "retire")
                             for k in kinds)
            check_trace(path)   # raises on any byte divergence
        assert saw_scale >= st.replicas_added + 2 * st.retired

    def test_newborn_stream_opens_with_scale_up_and_retires_closed(
            self, tmp_path):
        d = str(tmp_path / "elastic")
        cluster = elastic_cluster(1, trace_dir=d)
        cluster.run(flash_crowd(), until=120.0)
        router = cluster.router
        assert router.retired, "test needs at least one retirement"
        # a retired newborn's stream: header, scale_up first, retire last
        for n in sorted(os.listdir(d)):
            if not n.startswith("replica") or n == "replica0.trace.jsonl":
                continue
            recs = [json.loads(l) for l in open(os.path.join(d, n))]
            assert recs[0]["kind"] == "header"
            assert recs[1]["kind"] == "scale_up"
            if any(r["kind"] == "retire" for r in recs):
                assert recs[-1]["kind"] == "retire"

    def test_pre_16_traces_still_load(self):
        fixture = os.path.join(os.path.dirname(__file__), "fixtures",
                               "traces", "prefill_heavy.trace.jsonl")
        lines = open(fixture).read().splitlines()
        header = json.loads(lines[0])
        header["version"] = [SCHEMA_MAJOR, 5]
        old = "\n".join([json.dumps(header)] + lines[1:])
        trace = Trace.loads(old)    # no scale records, older minor: fine
        assert trace.header["version"] == [SCHEMA_MAJOR, 5]
        replay_trace(trace)

    def test_scale_event_validates_kind(self, tmp_path):
        sim = make_sim()
        sim.attach_trace(str(tmp_path / "t.jsonl"))
        with pytest.raises(ValueError, match="unknown scale event"):
            sim.recorder.record_scale_event("shrink", 0.0)
