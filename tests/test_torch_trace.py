"""Trace record/replay of the port (`repro_torch.runtime.trace`) on the CPU.

Twins of tests/test_trace.py and tests/test_trace_compact.py: the two
golden fixtures under tests/fixtures/traces/ (read, never rewritten) replay
strictly through the port's scheduler and round-trip byte for byte; the
port's `record_sim_trace` writes both fixtures byte-identically (to
`tmp_path`, with the simulator's rates set for that case to the values read
from `repro.roofline.analysis` at run time, since the fixtures were minted
at the JAX package's rates); divergence names the tick and field; the fits,
the attention-page term, `host_s` and compaction behave as in JAX.

Across packages: the port's engine (reduced qwen1.5-0.5b, f32, CPU) records
a trace at pp=1 and at pp=2, and the JAX package's `replay_trace` replays
each strictly with no divergence, as does the port's; at pp=1 the port's
trace equals the JAX engine's trace of the same prompts record for record,
sampled tokens included, apart from the timing fields (`now`, `at`,
`exit.at`, `host_s`).
"""

import copy
import dataclasses
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAS_HYPOTHESIS = True
except ImportError:      # pragma: no cover - exercised on minimal installs
    HAS_HYPOTHESIS = False

from repro.roofline import analysis as jax_analysis
from repro.runtime import trace as jax_trace
from repro_torch.configs import get_config
from repro_torch.core import (
    PagedKVManager,
    PipelineScheduler,
    PrefillPolicy,
    SamplingParams,
    ThrottleConfig,
)
from repro_torch.data.workload import WorkloadSpec, sample_requests
from repro_torch.runtime import simulator
from repro_torch.runtime.simulator import (
    CostModel,
    cost_model_for,
    record_sim_trace,
)
from repro_torch.runtime.trace import (
    SCHEMA_MAJOR,
    Trace,
    TraceBackend,
    TraceDivergence,
    TraceSchemaError,
    calibration_error,
    check_trace,
    compact_records,
    dumps_record,
    expand_records,
    replay_trace,
    scheduler_from_header,
    tick_samples,
)

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE_DIR = os.path.join(HERE, "fixtures", "traces")
FIXTURES = ["prefill_heavy.trace.jsonl", "decode_saturated.trace.jsonl"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the engines here are tiny, and under the
    suite's parallel workers torch's default threads spin against each
    other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_rates(monkeypatch):
    """The port's simulator at the JAX package's rates, read at run time:
    the golden fixtures were minted at them."""
    monkeypatch.setattr(simulator, "HBM_BW", jax_analysis.HBM_BW)
    monkeypatch.setattr(simulator, "PEAK_FLOPS", jax_analysis.PEAK_FLOPS)


def fixture_path(name):
    return os.path.join(FIXTURE_DIR, name)


def load_fixture(name) -> Trace:
    return Trace.load(fixture_path(name))


def raw_records(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _fixture_parameters():
    """make_fixtures.py's pinned parameters, each workload as the port's
    `WorkloadSpec`."""
    spec = importlib.util.spec_from_file_location(
        "make_fixtures", os.path.join(FIXTURE_DIR, "make_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {name: {**kw, "spec": WorkloadSpec(**dataclasses.asdict(kw["spec"]))}
            for name, kw in mod.FIXTURES.items()}


# ---------------------------------------------------------------------------
# Round-trip determinism
# ---------------------------------------------------------------------------

class TestRoundTrip:
    @pytest.mark.parametrize("name", FIXTURES)
    def test_record_replay_round_trip_is_bit_identical(self, name):
        """Strict replay, itself recorded, reproduces the original file
        byte for byte — decisions, budgets, latencies, tokens, floats."""
        with open(fixture_path(name)) as fh:
            original = fh.read()
        report = replay_trace(Trace.loads(original), record=True)
        assert report.recorded.dumps() == original

    @pytest.mark.parametrize("name", FIXTURES)
    def test_two_replays_agree_exactly(self, name):
        trace = load_fixture(name)
        a = replay_trace(trace)
        b = replay_trace(trace)
        assert len(a.finished) == len(trace.requests) > 0
        assert a.request_metrics() == b.request_metrics()
        assert a.outputs() == b.outputs()

    @pytest.mark.parametrize("name", FIXTURES)
    def test_check_trace_cli_gate(self, name):
        report = check_trace(fixture_path(name))
        assert report.ticks == len(load_fixture(name).ticks)

    @pytest.mark.parametrize("name", FIXTURES)
    def test_port_mints_the_fixtures_byte_identical(self, name, tmp_path,
                                                    jax_rates):
        """The port's `record_sim_trace` with make_fixtures.py's pinned
        parameters writes the checked-in file byte for byte."""
        kw = _fixture_parameters()[name]
        path = tmp_path / name
        record_sim_trace(str(path), sample_requests(
            kw["spec"], kw["n"], kw["rate"], seed=kw["seed"]),
            pages=kw["pages"])
        with open(fixture_path(name)) as fh:
            assert path.read_text() == fh.read()


# ---------------------------------------------------------------------------
# Schema versioning
# ---------------------------------------------------------------------------

class TestSchema:
    def test_header_carries_current_version(self):
        trace = load_fixture(FIXTURES[0])
        assert trace.header["schema"] == "gllm-trace"
        assert trace.header["version"][0] == SCHEMA_MAJOR

    def test_unknown_major_rejected(self):
        text = open(fixture_path(FIXTURES[0])).read()
        lines = text.splitlines()
        header = json.loads(lines[0])
        header["version"] = [SCHEMA_MAJOR + 1, 0]
        bad = "\n".join([json.dumps(header)] + lines[1:])
        with pytest.raises(TraceSchemaError, match="major"):
            Trace.loads(bad)

    def test_newer_minor_accepted(self):
        text = open(fixture_path(FIXTURES[0])).read()
        lines = text.splitlines()
        header = json.loads(lines[0])
        header["version"] = [SCHEMA_MAJOR, 99]
        Trace.loads("\n".join([json.dumps(header)] + lines[1:]))

    def test_missing_header_rejected(self):
        with pytest.raises(TraceSchemaError):
            Trace.loads('{"kind":"tick","tick":0}')
        with pytest.raises(TraceSchemaError):
            Trace.loads("")

    def test_route_stream_is_not_a_tick_trace(self):
        with pytest.raises(TraceSchemaError):
            Trace.loads('{"kind":"header","schema":"gllm-route",'
                        '"version":[1,0]}')


# ---------------------------------------------------------------------------
# Divergence reporting
# ---------------------------------------------------------------------------

class TestDivergence:
    def _tamper(self, trace: Trace, pred, mutate) -> Trace:
        t = Trace(copy.deepcopy(trace.header), copy.deepcopy(trace.records))
        for rec in t.records:
            if rec["kind"] == "tick" and pred(rec):
                mutate(rec)
                return t
        raise AssertionError("no tick matched")

    def test_divergence_names_exact_tick_and_field(self):
        trace = load_fixture("prefill_heavy.trace.jsonl")
        # grow the recorded first prefill chunk of some mid-trace tick
        def has_prefill(rec):
            return rec["tick"] >= 5 and rec["batch"] \
                and rec["batch"]["prefill"]
        bad = self._tamper(trace, has_prefill,
                           lambda rec: rec["batch"]["prefill"][0].__setitem__(
                               2, rec["batch"]["prefill"][0][2] + 1))
        tampered_tick = next(r["tick"] for r in bad.ticks
                             if has_prefill(r))
        with pytest.raises(TraceDivergence) as ei:
            replay_trace(bad)
        assert ei.value.tick == tampered_tick
        assert any(f == "batch.prefill" for f, _, _ in ei.value.diffs)
        assert f"tick {tampered_tick}" in str(ei.value)

    def test_divergence_on_budget_field(self):
        trace = load_fixture("decode_saturated.trace.jsonl")
        bad = self._tamper(trace, lambda rec: rec["tick"] == 17,
                           lambda rec: rec.update(
                               decode_budget=rec["decode_budget"] + 3))
        with pytest.raises(TraceDivergence) as ei:
            replay_trace(bad)
        assert ei.value.tick == 17
        assert [f for f, _, _ in ei.value.diffs] == ["decode_budget"]

    def test_truncated_trace_reports_pending_work(self):
        trace = load_fixture("prefill_heavy.trace.jsonl")
        cut = Trace(trace.header, trace.records[: len(trace.records) // 2])
        with pytest.raises(TraceDivergence):
            replay_trace(cut)

    def test_timing_only_tolerates_divergence(self):
        """What-if replay: same workload and recorded latencies, different
        policy — no assertions, every request still completes."""
        trace = load_fixture("decode_saturated.trace.jsonl")
        sched = scheduler_from_header(trace.header)
        sarathi = dataclasses.replace(sched.cfg,
                                      policy=PrefillPolicy.SARATHI)
        what_if = PipelineScheduler(sarathi, sched.kv,
                                    max_model_len=sched.max_model_len)
        report = replay_trace(trace, mode=TraceBackend.TIMING,
                              scheduler=what_if)
        assert len(report.finished) == len(trace.requests)
        assert report.mode == TraceBackend.TIMING


# ---------------------------------------------------------------------------
# Golden scheduler/throttle regression (satellite: budget decisions)
# ---------------------------------------------------------------------------

class TestGoldenBudgets:
    @pytest.mark.parametrize("name", FIXTURES)
    def test_replayed_budgets_match_recording(self, name):
        """The eq. 3/4 outputs per tick are pinned by the fixtures: a change
        to core/throttle.py or core/scheduler.py that alters batching shows
        up here as a reviewed fixture diff, not a silent behavior change."""
        trace = load_fixture(name)
        report = replay_trace(trace)
        stats = report.scheduler.stats
        assert stats.prefill_budgets == [r["prefill_budget"]
                                         for r in trace.ticks]
        assert stats.decode_budgets == [r["decode_budget"]
                                        for r in trace.ticks]
        assert stats.kv_free_rate == [r["kv_free"] for r in trace.ticks]

    def test_decode_fixture_exercises_pressure_paths(self):
        """The decode-saturated fixture must keep covering the interesting
        scheduler paths (UT gating + preemption) — guard against a
        regenerated fixture silently losing coverage."""
        trace = load_fixture("decode_saturated.trace.jsonl")
        assert sum(r["preempts"] for r in trace.ticks) > 0
        assert min(r["kv_free"] for r in trace.ticks) <= \
            trace.header["throttle"]["kv_threshold"]
        assert any(r["prefill_budget"] == 0 and r["wp"] > 0
                   for r in trace.ticks), "UT gate never engaged"


# ---------------------------------------------------------------------------
# Calibration (<= 5% mean relative error)
# ---------------------------------------------------------------------------

class TestFitFromTrace:
    @pytest.mark.parametrize("name", FIXTURES)
    def test_fit_recovers_latencies_within_5pct(self, name, jax_rates):
        trace = load_fixture(name)
        base = cost_model_for(get_config("qwen2.5-14b"), pp=trace.depth)
        # start the fit far from the truth: a third the compute efficiency,
        # inflated memory efficiency, 5x the fixed floor
        perturbed = dataclasses.replace(base, mfu=base.mfu / 3,
                                        hbm_eff=min(0.99, base.hbm_eff * 1.3),
                                        fixed_us=base.fixed_us * 5)
        fitted = CostModel.fit_from_trace(trace, perturbed)
        assert calibration_error(trace, fitted) < 0.05
        assert calibration_error(trace, fitted) < \
            calibration_error(trace, perturbed)

    def test_fit_on_prefill_heavy_recovers_both_regimes(self, jax_rates):
        trace = load_fixture("prefill_heavy.trace.jsonl")
        base = cost_model_for(get_config("qwen2.5-14b"), pp=trace.depth)
        perturbed = dataclasses.replace(base, mfu=0.2, hbm_eff=0.95)
        fitted = CostModel.fit_from_trace(trace, perturbed)
        # the fixture was generated by `base`; the fit must land back on it
        assert fitted.mfu == pytest.approx(base.mfu, rel=0.05)
        assert fitted.hbm_eff == pytest.approx(base.hbm_eff, rel=0.05)

    def test_tick_samples_shape(self):
        trace = load_fixture("prefill_heavy.trace.jsonl")
        samples = tick_samples(trace)
        assert 0 < len(samples) <= len(trace.ticks)
        for s in samples:
            assert s.prefill_tokens >= 0 and s.decode_tokens >= 0
            assert s.stage_time > 0


class TestAttnPageTerm:
    """Per-scanned-page attention billing (DESIGN.md §14): the CostModel
    mirror of the depth-bucketed engine.  Disabled (attn_page_bytes=0) it is
    bit-identical to the legacy per-token formula; enabled, the sim, the
    trace fit, and `calibration_error` all share one page estimator, so a
    trace minted under the page model fits back to itself."""

    def test_disabled_term_is_legacy_formula(self):
        base = cost_model_for(get_config("qwen2.5-14b"), pp=4)
        assert base.attn_page_bytes == 0.0
        # scanned_pages must be ignored when the term is off
        assert base.stage_time(64, 8, 400, 900, scanned_pages=10_000) == \
            base.stage_time(64, 8, 400, 900)

    def test_enabled_term_tracks_pages(self):
        cfg = get_config("qwen2.5-14b")
        paged = cost_model_for(cfg, pp=4, page_size=16)
        assert paged.attn_page_bytes == pytest.approx(
            16 * paged.kv_bytes_per_ctx_token)
        # more scanned pages => strictly more memory time (decode is
        # KV-bound at long context)
        lo = paged.stage_time(0, 8, 0, 8_000, scanned_pages=100)
        hi = paged.stage_time(0, 8, 0, 8_000, scanned_pages=100_000)
        assert hi > lo
        # the estimator backs the default: explicit == estimated
        est = paged.est_scanned_pages(0, 8, 0, 8_000)
        assert paged.stage_time(0, 8, 0, 8_000) == \
            paged.stage_time(0, 8, 0, 8_000, scanned_pages=est)

    def test_fit_recovers_page_model(self, tmp_path):
        """Mint a trace under the page-billing model, perturb the
        efficiencies, fit — the fit must land back on the truth (fit and
        generation share est_scanned_pages, so the term is identified)."""
        spec = WorkloadSpec("mix", mean_input=120.0, mean_output=24.0,
                            sigma=0.6, max_input=256, max_output=48)
        path = str(tmp_path / "paged.trace.jsonl")
        sim = record_sim_trace(path, sample_requests(spec, 24, 150.0, seed=3),
                               pages=512, attn_page_billing=True)
        base = sim.backend.cost
        assert base.attn_page_bytes > 0
        trace = Trace.load(path)
        perturbed = dataclasses.replace(base, mfu=base.mfu / 3,
                                        hbm_eff=min(0.99, base.hbm_eff * 1.3),
                                        fixed_us=base.fixed_us * 5)
        fitted = CostModel.fit_from_trace(trace, perturbed)
        assert fitted.attn_page_bytes == base.attn_page_bytes
        assert calibration_error(trace, fitted) < 0.05
        assert calibration_error(trace, fitted) < \
            calibration_error(trace, perturbed)


# ---------------------------------------------------------------------------
# Per-tick host overhead (schema 1.3 `host_s`)
# ---------------------------------------------------------------------------

class TestHostOverhead:
    def test_sim_traces_record_host_s(self):
        """SimBackend models host work per non-bubble tick; the recorder
        writes it, and the golden fixtures therefore pin it."""
        from repro_torch.runtime.trace import host_overhead_samples
        trace = load_fixture(FIXTURES[0])
        samples = host_overhead_samples(trace)
        assert len(samples) == sum(1 for r in trace.ticks if r["batch"])
        assert all(s > 0 for s in samples)
        # bubble ticks cost no host work in the sim model
        assert all(r.get("host_s") == 0.0 for r in trace.ticks
                   if r["batch"] is None and "host_s" in r)

    def test_fit_from_trace_recovers_runtime_model(self):
        """The sim's host_s is deterministic per non-bubble tick, so the
        calibration recovers `host_s_per_tick` exactly and splits it by the
        requested overlap fraction."""
        from repro_torch.runtime.simulator import RuntimeModel
        trace = load_fixture(FIXTURES[0])
        truth = RuntimeModel.gllm().host_s_per_tick
        fitted = RuntimeModel.fit_from_trace(trace)
        assert fitted.host_s_per_tick == pytest.approx(truth)
        assert fitted.overhead_overlap == 0.0
        split = RuntimeModel.fit_from_trace(trace, overlap_fraction=0.75)
        assert split.host_s_per_tick == pytest.approx(truth)
        assert split.overhead_overlap == pytest.approx(0.75 * truth)
        with pytest.raises(ValueError, match="overlap_fraction"):
            RuntimeModel.fit_from_trace(trace, overlap_fraction=1.5)

    def test_fit_from_trace_rejects_legacy_traces(self):
        """A pre-1.3 trace (no host_s anywhere) cannot calibrate the host
        model — explicit error, not a silent zero."""
        from repro_torch.runtime.simulator import RuntimeModel
        trace = load_fixture(FIXTURES[0])
        legacy = Trace(copy.deepcopy(trace.header),
                       copy.deepcopy(trace.records))
        for rec in legacy.records:
            rec.pop("host_s", None)
        with pytest.raises(ValueError, match="host_s"):
            RuntimeModel.fit_from_trace(legacy)

    def test_legacy_records_round_trip_without_host_s(self):
        """Stripping host_s yields exactly the pre-1.3 byte layout: the
        field is uniformly optional, never null-filled."""
        with open(fixture_path(FIXTURES[0])) as fh:
            records = [json.loads(line) for line in fh if line.strip()]
        for rec in records:
            rec.pop("host_s", None)
        out = [dumps_record(r) for r in expand_records(compact_records(records))]
        assert out == [dumps_record(r) for r in records]
        assert all('"host_s"' not in line for line in out)



# ---------------------------------------------------------------------------
# Tracing across the runtime: live engine and multi-replica cluster
# ---------------------------------------------------------------------------

DIMS = dict(Sp=1, C=16, Sd=8, pages=256, page=8, Bp=32, Bd=32, slots=16)
THROTTLE = dict(num_iters_T=2, max_prefill_tokens=16, min_prefill_tokens=4)
PROMPT_LENS = (5, 9, 12, 23)


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(0, vocab, n)] for n in PROMPT_LENS]


def _port_engine(path, *, pp=1, params=None, **kw):
    """The port's reduced qwen1.5-0.5b engine (f32, CPU) at `pp` stages,
    recording to `path`; `params` defaults to the port's seed-0 weights."""
    from repro_torch.launch.serve import serve_config
    from repro_torch.models.serve import ServeDims
    from repro_torch.models.transformer import init_params
    from repro_torch.runtime.engine import PipelineEngine

    cfg, dtype = serve_config("qwen1.5-0.5b", reduced=True, pp=pp)
    if params is None:
        params = init_params(cfg, 0, dtype=dtype)
    return PipelineEngine(cfg, ServeDims(**DIMS), params,
                          ThrottleConfig(pipeline_depth=pp, **THROTTLE),
                          device="cpu", trace_path=path, **kw)


def _serve(eng, max_new=4):
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=max_new),
                            request_id=f"r{i}")
            for i, p in enumerate(_prompts(eng.cfg.vocab_size))]
    eng.drain()
    eng.recorder.close()
    return reqs


class TestEngineTrace:
    @pytest.mark.parametrize("pp", [1, 2])
    def test_engine_records_then_replays_offline(self, tmp_path, pp):
        """The live `TorchBackend` is traced by the same recorder, and the
        trace replays through the scheduler alone — no model — reproducing
        the engine's exact sampled tokens and decisions, in the port and in
        the JAX package."""
        path = str(tmp_path / "engine.trace.jsonl")
        eng = _port_engine(path, pp=pp)
        reqs = _serve(eng)
        assert eng.backend is not eng.loop.backend   # the recorder wraps it
        want = {r.request_id: list(r.output_token_ids) for r in reqs}

        trace = Trace.load(path)
        assert trace.depth == pp and len(trace.requests) == len(reqs)
        report = replay_trace(trace)        # strict: decisions must match
        assert report.outputs() == want
        assert check_trace(path).ticks == len(trace.ticks)
        jax_report = jax_trace.replay_trace(jax_trace.Trace.load(path))
        assert jax_report.outputs() == want
        assert jax_trace.check_trace(path).ticks == len(trace.ticks)
        # engine backends cannot attribute per-stage time: recorded as null
        assert all(r["stage_times"] is None for r in trace.ticks)
        # ...but they do measure per-tick host overhead (schema 1.3)
        assert all(r["host_s"] > 0 for r in trace.ticks)

    def test_traced_bucketed_engine_replays(self, tmp_path):
        """The bucket ladder changes no decision a trace records."""
        path = str(tmp_path / "bucketed.trace.jsonl")
        reqs = _serve(_port_engine(path, bucketed=True))
        report = replay_trace(Trace.load(path))
        assert report.outputs() == {r.request_id: list(r.output_token_ids)
                                    for r in reqs}

    def test_trace_refuses_async_dispatch(self, tmp_path):
        with pytest.raises(ValueError, match="async_dispatch"):
            _port_engine(str(tmp_path / "t.jsonl"), async_dispatch=True)

    def test_traced_abort_replays(self, tmp_path):
        """A user abort is recorded at its stream position (schema 1.1)."""
        path = str(tmp_path / "abort.trace.jsonl")
        eng = _port_engine(path)
        prompts = _prompts(eng.cfg.vocab_size)
        rids = [eng.add_request(p, SamplingParams(max_new_tokens=6)).request_id
                for p in prompts]
        for _ in range(3):
            eng.step()
        assert eng.abort_request(rids[1])
        eng.drain()
        eng.recorder.close()
        kinds = [r["kind"] for r in Trace.load(path).records]
        assert kinds.count("abort") == 1
        check_trace(path)
        jax_trace.check_trace(path)

    def test_pp1_trace_equals_jax_engine_trace(self, tmp_path):
        """The JAX engine and the port's, from the same weights and
        prompts, record the same trace record for record: the same header,
        requests, batches, budgets, signals and sampled tokens.  Only the
        wall-clock fields differ."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as P

        from repro.configs import get_config as jax_get_config
        from repro.configs import make_reduced as jax_make_reduced
        from repro.core import SamplingParams as JSamplingParams
        from repro.core import ThrottleConfig as JThrottleConfig
        from repro.models import transformer as jtfm
        from repro.models.serve import ServeDims as JServeDims
        from repro.runtime.engine import PipelineEngine as JaxEngine
        from repro_torch.launch.serve import serve_config
        from repro_torch.models.convert import params_from_numpy

        jcfg = dataclasses.replace(
            jax_make_reduced(jax_get_config("qwen1.5-0.5b")).with_plan(
                pp=1, tp=1, ep_over_data=False), dtype="float32")
        mesh = jax.make_mesh((1, 1, 1), ("data", "stage", "tensor"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 3)
        jpath = str(tmp_path / "jax.trace.jsonl")
        with jax.set_mesh(mesh):
            jparams = jtfm.init_params(jcfg, jax.random.key(0),
                                       dtype=jnp.float32)
            jparams = jax.tree.map(
                lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
                jparams, jtfm.param_pspecs(jcfg),
                is_leaf=lambda x: isinstance(x, P))
            jeng = JaxEngine(jcfg, JServeDims(**DIMS), jparams, mesh,
                             JThrottleConfig(pipeline_depth=1, **THROTTLE),
                             trace_path=jpath)
        for i, p in enumerate(_prompts(jcfg.vocab_size)):
            jeng.add_request(p, JSamplingParams(max_new_tokens=4),
                             request_id=f"r{i}")
        jeng.drain()
        jeng.recorder.close()

        cfg, _ = serve_config("qwen1.5-0.5b", reduced=True)
        params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams))
        tpath = str(tmp_path / "port.trace.jsonl")
        _serve(_port_engine(tpath, params=params))

        def untimed(rec):
            rec = {k: v for k, v in rec.items()
                   if k not in ("now", "at", "host_s")}
            if rec.get("exit") is not None:
                rec["exit"] = {k: v for k, v in rec["exit"].items()
                               if k != "at"}
            return rec

        want, got = raw_records(jpath), raw_records(tpath)
        assert len(got) == len(want)
        assert [untimed(r) for r in got] == [untimed(r) for r in want]
        # the sampled tokens are compared, not only the batch shapes
        assert sum(len(r["exit"]["tokens"]) for r in got
                   if r["kind"] == "tick" and r["exit"]) == 16

    def test_simulator_reproduces_the_engine_batches(self, tmp_path):
        """The port's simulator, given the engine trace's scheduler (its
        header) and its requests at t = 0 with their recorded output
        lengths, decides every tick's batch as the engine did."""
        from repro_torch.runtime.simulator import (PipelineSimulator,
                                                   RuntimeModel)
        path = str(tmp_path / "engine.trace.jsonl")
        _serve(_port_engine(path))
        trace = Trace.load(path)
        sim = PipelineSimulator(
            scheduler_from_header(trace.header), trace.depth,
            cost_model_for(get_config("qwen1.5-0.5b"), pp=1, page_size=8),
            RuntimeModel.fit_from_trace(trace))
        sim.attach_trace(None)
        outs = {rid: len(t) for rid, t in replay_trace(trace).outputs().items()}
        for rec in trace.requests:
            sim.inject_request(0.0, rec["prompt"], outs[rec["rid"]])
        sim.run()
        simulated = sim.recorder.trace()
        names = {s["rid"]: e["rid"]          # the same admission order
                 for s, e in zip(simulated.requests, trace.requests)}

        def batches(tr, rename):
            out = []
            for r in tr.ticks:
                b = r["batch"]
                out.append(None if b is None else (
                    [[rename.get(e[0], e[0])] + e[1:] for e in b["prefill"]],
                    [[rename.get(e[0], e[0])] + e[1:] for e in b["decode"]]))
            return out

        assert batches(simulated, names) == batches(trace, {})


class TestClusterTrace:
    def test_sim_cluster_records_replicas_and_routing(self, tmp_path):
        from repro_torch.data.workload import SHAREGPT
        from repro_torch.runtime.router import ReplicaRouter, SimCluster
        from repro_torch.runtime.simulator import PipelineSimulator

        def make_sched(pages=4096, pp=3):
            th = ThrottleConfig(pipeline_depth=pp)
            kv = PagedKVManager(num_pages=pages, page_size=16)
            return PipelineScheduler(th, kv, max_model_len=pages * 16)

        cost = cost_model_for(get_config("qwen2.5-14b"), pp=3)
        sims = [PipelineSimulator(make_sched(), 3, cost) for _ in range(2)]
        router = ReplicaRouter(sims, policy="balanced")
        cluster = SimCluster(sims, router, trace_dir=str(tmp_path))
        arrivals = sample_requests(SHAREGPT, 30, 30.0, seed=3)
        finished = cluster.run(arrivals)
        assert len(finished) == 30

        per_replica = 0
        for i in range(2):
            trace = Trace.load(str(tmp_path / f"replica{i}.trace.jsonl"))
            report = replay_trace(trace)   # each replica trace is golden
            per_replica += len(report.finished)
        assert per_replica == 30
        route = Trace.load(str(tmp_path / "router.trace.jsonl"),
                           expect="gllm-route")
        decisions = [r for r in route.records if r["kind"] == "route"]
        assert len(decisions) == 30
        assert [d["replica"] for d in decisions].count(0) == \
            router.routed_counts[0]
        assert all(len(d["scores"]) == 2 for d in decisions)



# ---------------------------------------------------------------------------
# Recorder invariants (property test; import-guarded like test_throttle)
# ---------------------------------------------------------------------------

def _check_recorder_invariants(trace: Trace) -> None:
    batches = {}
    prev_tick, prev_now, prev_rd = -1, None, None
    promotions_prev = 0      # decode promotions retired at the previous tick
    for rec in trace.records:
        if rec["kind"] != "tick":
            continue
        assert rec["tick"] == prev_tick + 1, "tick indices must be dense"
        prev_tick = rec["tick"]
        if prev_now is not None:
            assert rec["now"] >= prev_now, "time must not run backwards"
        prev_now = rec["now"]
        assert 0.0 <= rec["kv_free"] <= 1.0
        assert rec["wp"] >= 0 and rec["rd"] >= 0
        assert rec["preempts"] >= 0
        batch = rec["batch"]
        if batch is not None:
            batches[batch["id"]] = batch
            for _, start, length, _ in batch["prefill"]:
                assert start >= 0 and length > 0
            for _, pos in batch["decode"]:
                assert pos >= 0
            assert len(batch["decode"]) <= rec["rd"], \
                "cannot decode more seqs than are resident"
            assert rec["stage_times"] is not None
            assert all(t > 0 for t in rec["stage_times"])
            assert len(rec["stage_times"]) == trace.depth
        # decode population is monotone between admissions: it only grows
        # by prefills promoted at the previous tick's retirement
        if prev_rd is not None:
            assert rec["rd"] <= prev_rd + promotions_prev, \
                f"decode population jumped at tick {rec['tick']}"
        prev_rd = rec["rd"]
        exit_rec = rec["exit"]
        promotions_prev = 0
        if exit_rec is not None:
            exited = batches.get(exit_rec["id"])
            assert exited is not None, "exiting batch never entered"
            n_produce = sum(s[3] for s in exited["prefill"]) \
                + len(exited["decode"])
            assert len(exit_rec["tokens"]) == n_produce
            promotions_prev = sum(s[3] for s in exited["prefill"])


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_traces_satisfy_recorder_invariants(name):
    # non-hypothesis spot-check (requirements-dev.txt installs hypothesis)
    _check_recorder_invariants(load_fixture(name))


if HAS_HYPOTHESIS:
    @settings(max_examples=12, deadline=None)
    @given(
        seed=st.integers(0, 2**16),
        n=st.integers(3, 16),
        rate=st.floats(5.0, 60.0),
        mean_in=st.floats(8.0, 200.0),
        mean_out=st.floats(1.0, 48.0),
        pages=st.integers(48, 512),
    )
    def test_recorder_invariants_hold_on_random_workloads(
            seed, n, rate, mean_in, mean_out, pages):
        spec = WorkloadSpec("prop", mean_input=mean_in, mean_output=mean_out,
                            sigma=0.8, max_input=256, max_output=64)
        sink = io.StringIO()
        sim = record_sim_trace(sink, sample_requests(spec, n, rate,
                                                     seed=seed), pages=pages)
        trace = Trace.loads(sink.getvalue())
        assert len(trace.requests) == n
        _check_recorder_invariants(trace)
        # and every random trace must replay strictly
        report = replay_trace(trace)
        assert len(report.finished) == len(sim.metrics.finished)

# ---------------------------------------------------------------------------
# Compaction (twins of tests/test_trace_compact.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", FIXTURES)
class TestLosslessRoundTrip:
    def test_expand_inverts_compact_exactly(self, name):
        records = raw_records(fixture_path(name))
        compacted = compact_records(records)
        expanded = expand_records(compacted)
        # byte-level identity, not just ==: field order is part of the
        # round-trip guarantee (dumps_record serializes insertion order)
        want = [dumps_record(r) for r in records]
        got = [dumps_record(r) for r in expanded]
        assert got == want

    def test_compaction_actually_shrinks(self, name):
        records = raw_records(fixture_path(name))
        compacted = compact_records(records)
        raw = sum(len(dumps_record(r)) for r in records)
        small = sum(len(dumps_record(r)) for r in compacted)
        # steady-state decode ticks repeat most scalar fields AND collapse
        # their batch to the `STEADY_DECODE` marker; prefill-heavy ticks
        # change their batch every record, so less drops out
        budget = {"prefill_heavy.trace.jsonl": 0.92,
                  "decode_saturated.trace.jsonl": 0.65}[name]
        assert small < budget * raw, (small, raw)

    def test_compacted_trace_loads_transparently(self, name, tmp_path):
        records = raw_records(fixture_path(name))
        compacted = compact_records(records)
        out = tmp_path / name
        out.write_text("\n".join(dumps_record(r) for r in compacted) + "\n")
        trace = Trace.load(str(out))
        assert "compact" not in trace.header
        assert trace.dumps() == Trace.load(fixture_path(name)).dumps()

    def test_compacted_trace_passes_strict_replay_gate(self, name,
                                                       tmp_path):
        records = raw_records(fixture_path(name))
        compacted = compact_records(records)
        out = tmp_path / name
        out.write_text("\n".join(dumps_record(r) for r in compacted) + "\n")
        report = check_trace(str(out))     # the `check` CLI's gate
        assert report.ticks == len(Trace.load(fixture_path(name)).ticks)


class TestSteadyDecodeDelta:
    """Steady decode batches (same requests, one step later, `depth` ticks
    apart) collapse to the `STEADY_DECODE` marker — the decode-heavy
    fixture is dominated by them."""

    def test_markers_dominate_decode_heavy_fixture(self):
        records = raw_records(fixture_path("decode_saturated.trace.jsonl"))
        compacted = compact_records(records)
        ticks = sum(1 for r in records if r.get("kind") == "tick")
        markers = sum(1 for r in compacted if r.get("batch") == "+1")
        assert markers > 0.5 * ticks, (markers, ticks)

    def test_marker_expands_to_the_cohorts_batch(self):
        records = raw_records(fixture_path("decode_saturated.trace.jsonl"))
        depth = records[0]["depth"]
        compacted = compact_records(records)
        expanded = expand_records(compacted)
        # pair each marker with the original tick it must reconstruct
        originals = {r["tick"]: r for r in records if r.get("kind") == "tick"}
        for rec, full in zip(compacted, expanded):
            if rec.get("batch") != "+1":
                continue
            want = originals[full["tick"]]["batch"]
            assert full["batch"] == want
            prev = originals[full["tick"] - depth]["batch"]
            assert full["batch"]["decode"] == [
                [rid, s + 1] for rid, s in prev["decode"]]


class TestCompactionEdges:
    def test_compact_is_idempotent(self):
        records = raw_records(fixture_path(FIXTURES[0]))
        once = compact_records(records)
        twice = compact_records(once)
        assert twice == once

    def test_non_canonical_tick_rejected(self):
        records = raw_records(fixture_path(FIXTURES[0]))
        # re-order one tick's keys: loses the byte-identity guarantee
        for i, rec in enumerate(records):
            if rec.get("kind") == "tick":
                scrambled = dict(reversed(list(rec.items())))
                records[i] = scrambled
                break
        with pytest.raises(TraceSchemaError):
            compact_records(records)

    def test_non_tick_records_pass_through(self):
        records = raw_records(fixture_path(FIXTURES[0]))
        compacted = compact_records(records)
        want = [r for r in records if r["kind"] not in ("tick", "header")]
        got = [r for r in compacted if r["kind"] not in ("tick", "header")]
        assert got == want

    def test_cli_compact_roundtrip(self, tmp_path):
        src = fixture_path(FIXTURES[0])
        out = str(tmp_path / "c.jsonl")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.path.join(HERE, "..", "src") + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.runtime.trace", "compact", src,
             "-o", out], capture_output=True, text=True, env=env)
        assert res.returncode == 0, res.stderr
        assert os.path.getsize(out) < os.path.getsize(src)
        assert Trace.load(out).dumps() == Trace.load(src).dumps()


class TestRunLengthEncoding:
    """Schema 1.5: `stage_times` and exit token lists run-length encode to
    `{"r": [[value, count], ...]}` iff strictly shorter — deterministic, so
    the delta stream stays byte-stable through compact/expand cycles."""

    def test_rle_engages_on_repetitive_fields(self):
        from repro_torch.runtime.trace import _maybe_rle, _rle_expand
        enc = _maybe_rle([7] * 12)
        assert isinstance(enc, dict) and enc == {"r": [[7, 12]]}
        assert _rle_expand(enc["r"]) == [7] * 12

    def test_rle_declines_when_not_shorter(self):
        from repro_torch.runtime.trace import _maybe_rle
        varied = [1, 2, 3, 4, 5]
        assert _maybe_rle(varied) is varied      # raw list passes through
        assert _maybe_rle([3]) == [3]            # too short to ever win

    @pytest.mark.parametrize("name", FIXTURES)
    def test_rle_fields_expand_losslessly_on_fixtures(self, name):
        records = raw_records(fixture_path(name))
        compacted = compact_records(records)
        saw = 0
        for rec in compacted:
            if isinstance(rec.get("stage_times"), dict):
                saw += 1
            ex = rec.get("exit")
            if isinstance(ex, dict) and isinstance(ex.get("tokens"), dict):
                saw += 1
        # sim traces have uniform stage costs -> stage_times RLE must win
        # somewhere; expansion must still reproduce every original byte
        assert saw > 0
        want = [dumps_record(r) for r in records]
        got = [dumps_record(r) for r in expand_records(compacted)]
        assert got == want

    def test_synthetic_exit_tokens_round_trip(self):
        records = raw_records(fixture_path(FIXTURES[0]))
        # graft a long constant token burst onto one exit record so the
        # exit-token RLE arm is exercised even if fixtures never hit it
        for rec in records:
            if rec.get("kind") == "tick" and rec.get("exit"):
                rec["exit"]["tokens"] = [0] * 32
                break
        compacted = compact_records(records)
        assert any(isinstance(r.get("exit"), dict)
                   and isinstance(r["exit"].get("tokens"), dict)
                   for r in compacted)
        want = [dumps_record(r) for r in records]
        got = [dumps_record(r) for r in expand_records(compacted)]
        assert got == want
