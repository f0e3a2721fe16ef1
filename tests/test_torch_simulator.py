"""The port's roofline simulator (`repro_torch.runtime.simulator`) on the CPU.

Twins of tests/test_simulator.py's eight cases (policy effects in the
paper's directions, faults, stragglers, the workload ratios), run at the
port's own rates: the H100's from `repro_torch.roofline.analysis`.  Then the
same arrivals through the JAX package's `PipelineSimulator` and the port's
give equal metrics exactly, with the port's rates set, for that comparison
only, to the values the test reads from `repro.roofline.analysis` at run
time (`net_bw` is a dataclass default, which no patch reaches: the cluster
case passes JAX's explicitly).  `param_count` and `cost_model_for`'s
structural fields equal JAX's for every ported arch, and the count is one
for the published config, its single-stage fold and every staging.  A
JAX-free case pins the port's constants to the card's data sheet.
"""

import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import PagedKVManager as JPagedKVManager
from repro.core import PipelineScheduler as JPipelineScheduler
from repro.core import PrefillPolicy as JPrefillPolicy
from repro.core import ThrottleConfig as JThrottleConfig
from repro.roofline import analysis as jax_analysis
from repro.runtime import simulator as jax_simulator
from repro.runtime.router import ReplicaRouter as JReplicaRouter
from repro.runtime.router import RebalancePolicy as JRebalancePolicy
from repro.runtime.router import SimCluster as JSimCluster
from repro_torch.configs import get_config, list_archs, single_stage, stage_config
from repro_torch.core import (PagedKVManager, PipelineScheduler, PrefillPolicy,
                              ThrottleConfig)
from repro_torch.data.workload import (AZURE, SHAREGPT, get_workload,
                                       sample_requests)
from repro_torch.roofline import analysis
from repro_torch.runtime import simulator
from repro_torch.runtime.router import RebalancePolicy, ReplicaRouter, SimCluster
from repro_torch.runtime.simulator import (PipelineSimulator, RuntimeModel,
                                           cost_model_for)

CFG = get_config("qwen2.5-14b")
PP = 4


@pytest.fixture
def jax_rates(monkeypatch):
    """The port's simulator at the JAX package's rates, read at run time."""
    monkeypatch.setattr(simulator, "HBM_BW", jax_analysis.HBM_BW)
    monkeypatch.setattr(simulator, "PEAK_FLOPS", jax_analysis.PEAK_FLOPS)


def run_sim(policy, runtime, *, rate=12.0, n=150, pages=8192, seed=0,
            fail_at=None, straggler=None):
    th = ThrottleConfig(pipeline_depth=PP, policy=policy)
    kv = PagedKVManager(num_pages=pages, page_size=16)
    sched = PipelineScheduler(th, kv, max_model_len=pages * 16)
    st_stage, st_fac = straggler if straggler else (None, 1.0)
    sim = PipelineSimulator(sched, PP, cost_model_for(CFG, pp=PP), runtime,
                            straggler_stage=st_stage, straggler_factor=st_fac)
    sim.add_workload(sample_requests(SHAREGPT, n, rate, seed=seed))
    if fail_at is not None:
        sim.inject_failure(fail_at, downtime=1.0)
    return sim.run()


# ---------------------------------------------------------------------------
# twins of tests/test_simulator.py, at the card's rates
# ---------------------------------------------------------------------------

def test_all_requests_complete():
    m = run_sim(PrefillPolicy.GLLM, RuntimeModel.gllm())
    assert len(m.finished) == 150
    assert m.throughput() > 0
    assert m.ttft() > 0 and m.tpot() > 0


def test_gllm_beats_sarathi_at_saturation():
    """Higher throughput, lower TPOT/E2EL and fewer bubbles at 90 req/s, far
    above the ~10 requests a second this setup completes at the card's
    rates."""
    g = run_sim(PrefillPolicy.GLLM, RuntimeModel.gllm(), rate=90.0)
    s = run_sim(PrefillPolicy.SARATHI, RuntimeModel.vllm_like(), rate=90.0)
    assert g.throughput() > s.throughput()
    assert g.tpot() < s.tpot()
    assert g.e2el() < s.e2el()
    assert g.bubble_time < s.bubble_time


def test_runtime_alone_helps():
    ck = run_sim(PrefillPolicy.SARATHI, RuntimeModel.gllm(), rate=90.0)
    vl = run_sim(PrefillPolicy.SARATHI, RuntimeModel.vllm_like(), rate=90.0)
    assert ck.throughput() > vl.throughput()


def test_ut_matters_under_kv_pressure():
    full = run_sim(PrefillPolicy.GLLM, RuntimeModel.gllm(), rate=30.0,
                   pages=1024)
    nout = run_sim(PrefillPolicy.NO_UT, RuntimeModel.gllm(), rate=30.0,
                   pages=1024)
    assert nout.e2el() > full.e2el() * 1.1
    assert nout.tpot() > full.tpot() * 1.1


def test_slo_attainment_direction():
    g = run_sim(PrefillPolicy.GLLM, RuntimeModel.gllm(), rate=35.0)
    s = run_sim(PrefillPolicy.SARATHI, RuntimeModel.vllm_like(), rate=35.0)
    assert g.slo_attainment(2.0, 0.05) >= s.slo_attainment(2.0, 0.05)


def test_failure_recovery_completes_all():
    m = run_sim(PrefillPolicy.GLLM, RuntimeModel.gllm(), rate=20.0,
                fail_at=2.0)
    assert len(m.finished) == 150


def test_straggler_slows_but_completes():
    base = run_sim(PrefillPolicy.GLLM, RuntimeModel.gllm(), rate=20.0)
    slow = run_sim(PrefillPolicy.GLLM, RuntimeModel.gllm(), rate=20.0,
                   straggler=(2, 3.0))
    assert len(slow.finished) == 150
    assert slow.e2el() > base.e2el()


def test_workloads_match_paper_ratios():
    rng_reqs = sample_requests(AZURE, 2000, 1.0, seed=0)
    s_reqs = sample_requests(SHAREGPT, 2000, 1.0, seed=0)
    a_in = np.mean([len(p) for _, p, _ in rng_reqs])
    s_in = np.mean([len(p) for _, p, _ in s_reqs])
    a_out = np.mean([o for _, _, o in rng_reqs])
    s_out = np.mean([o for _, _, o in s_reqs])
    assert 4.0 < a_in / s_in < 6.5
    assert 1.3 < a_out / s_out < 2.1
    assert get_workload("azure") is AZURE


# ---------------------------------------------------------------------------
# the card's constants (JAX-free)
# ---------------------------------------------------------------------------

def test_constants_are_the_cards():
    """H100 SXM data sheet: bf16 dense tensor cores, HBM3, one NVLink 4
    direction; the simulator and its cost model read exactly these."""
    assert analysis.PEAK_FLOPS == 989e12
    assert analysis.HBM_BW == 3.35e12
    assert analysis.NVLINK_BW == 450e9
    assert simulator.PEAK_FLOPS is analysis.PEAK_FLOPS
    assert simulator.HBM_BW is analysis.HBM_BW
    cost = cost_model_for(get_config("qwen1.5-0.5b"), pp=1)
    assert cost.net_bw == analysis.NVLINK_BW
    # a decode-only tick: weights plus KV over the card's HBM, derated by
    # the model's `hbm_eff`, plus the fixed floor
    want = ((cost.param_bytes_stage + 8 * 100 * cost.kv_bytes_per_ctx_token)
            / (analysis.HBM_BW * cost.hbm_eff) + cost.fixed_us * 1e-6)
    assert cost.stage_time(0, 8, 0, 100) == pytest.approx(want, rel=1e-12)
    # a long chunk at no context is compute-bound at the card's bf16 peak
    comp = 4096 * cost.flops_per_token_stage / (analysis.PEAK_FLOPS
                                                * cost.mfu)
    assert cost.stage_time(4096, 0, 0, 0) == pytest.approx(
        comp + cost.fixed_us * 1e-6, rel=1e-12)


# ---------------------------------------------------------------------------
# structure: equal to the JAX package's for every ported arch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_param_count_and_cost_model_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for active in (False, True):
        want = jax_analysis.param_count(jcfg, active_only=active)
        assert analysis.param_count(cfg, active_only=active) == want
        # the port's one-card forms count the same model; the fold drops
        # the padding layers (kimi-k2: 61 of 64, minicpm3: 62 of 64),
        # which JAX's count of the published stage grid includes
        fold_want = want
        if cfg.layer_padding:
            fold_want = jax_analysis.param_count(dataclasses.replace(
                jcfg.with_plan(pp=1), pattern=(dataclasses.replace(
                    jcfg.pattern[0], repeat=jcfg.num_layers),)),
                active_only=active)
            assert fold_want < want
        assert analysis.param_count(single_stage(cfg),
                                    active_only=active) == fold_want
        for pp in range(1, cfg.num_layers + 1):
            try:
                staged = stage_config(cfg, pp)
            except ValueError:
                continue                      # a count the pattern refuses
            assert analysis.param_count(staged, active_only=active) == want
    assert cfg.params_per_layer_estimate() == jcfg.params_per_layer_estimate()
    for kw in (dict(pp=1), dict(pp=4), dict(pp=2, page_size=16),
               dict(pp=1, chips_per_stage=2)):
        got = cost_model_for(cfg, **kw)
        want = jax_simulator.cost_model_for(jcfg, **kw)
        for f in ("flops_per_token_stage", "param_bytes_stage",
                  "kv_bytes_per_ctx_token", "chips_per_stage",
                  "attn_page_bytes", "page_size", "mfu", "hbm_eff",
                  "fixed_us", "comm_bytes_per_token", "comm_latency"):
            assert getattr(got, f) == getattr(want, f), (arch, kw, f)


def test_runtime_presets_match_jax():
    for name in ("gllm", "vllm_like"):
        got = getattr(RuntimeModel, name)()
        want = getattr(jax_simulator.RuntimeModel, name)()
        assert (got.overhead_serial, got.overhead_overlap) == (
            want.overhead_serial, want.overhead_overlap)


# ---------------------------------------------------------------------------
# the same arrivals through both simulators, rates aligned: equal metrics
# ---------------------------------------------------------------------------

def _metrics(m, sched):
    per = sorted((r.request_id, r.metrics.ttft(), r.metrics.e2el(),
                  r.metrics.tpot(r.num_output_tokens), r.num_output_tokens)
                 for r in m.finished)
    return {"ttft": m.ttft(), "tpot": m.tpot(), "e2el": m.e2el(),
            "throughput": m.throughput(), "sim_time": m.sim_time,
            "bubble": m.bubble_time, "busy": m.busy_time,
            "ticks": sched.stats.ticks,
            "preemptions": sched.stats.preemptions, "per_request": per}


def _both(policy, runtime, *, pp=PP, pages=2048, n=60, rate=40.0,
          page_billing=False, fail_at=None, straggler=None):
    arrivals = sample_requests(SHAREGPT, n, rate, seed=5)
    st_stage, st_fac = straggler or (None, 1.0)
    out = []
    for mod, cfg, th_cls, kv_cls, sc_cls, pol_cls in (
            (jax_simulator, jax_get_config("qwen2.5-14b"), JThrottleConfig,
             JPagedKVManager, JPipelineScheduler, JPrefillPolicy),
            (simulator, CFG, ThrottleConfig, PagedKVManager,
             PipelineScheduler, PrefillPolicy)):
        sched = sc_cls(th_cls(pipeline_depth=pp, policy=pol_cls(policy)),
                       kv_cls(num_pages=pages, page_size=16),
                       max_model_len=pages * 16)
        rt = getattr(mod.RuntimeModel, runtime)()
        cost = mod.cost_model_for(cfg, pp=pp,
                                  page_size=16 if page_billing else None)
        sim = mod.PipelineSimulator(sched, pp, cost, rt,
                                    straggler_stage=st_stage,
                                    straggler_factor=st_fac)
        sim.add_workload(arrivals)
        if fail_at is not None:
            sim.inject_failure(fail_at, downtime=0.5)
        out.append(_metrics(sim.run(), sched))
    return out


@pytest.mark.parametrize("case", [
    dict(policy="gllm", runtime="gllm"),
    dict(policy="sarathi", runtime="vllm_like", rate=90.0),
    dict(policy="no_ut", runtime="gllm", pages=256),
    dict(policy="gllm", runtime="gllm", pp=1),
    dict(policy="gllm", runtime="gllm", page_billing=True),
    dict(policy="gllm", runtime="gllm", fail_at=1.0),
    dict(policy="gllm", runtime="vllm_like", straggler=(2, 3.0)),
], ids=["gllm", "sarathi-vllm", "no_ut-tight", "pp1", "page-billing",
        "failure", "straggler"])
def test_same_arrivals_same_metrics_as_jax(jax_rates, case):
    want, got = _both(**case)
    assert got["per_request"] and got == want


def test_cluster_with_migration_matches_jax(jax_rates):
    """Two replicas behind the balanced router with live migration: the
    move's modeled cost reads `net_bw`, so both sides take JAX's value."""
    arrivals = sample_requests(SHAREGPT, 40, 40.0, seed=9)
    jcost = jax_simulator.cost_model_for(jax_get_config("qwen2.5-14b"), pp=2)
    cost = dataclasses.replace(cost_model_for(CFG, pp=2), net_bw=jcost.net_bw)
    out = []
    for mod, c, th_cls, kv_cls, sc_cls, rr, rb, sc in (
            (jax_simulator, jcost, JThrottleConfig, JPagedKVManager,
             JPipelineScheduler, JReplicaRouter, JRebalancePolicy,
             JSimCluster),
            (simulator, cost, ThrottleConfig, PagedKVManager,
             PipelineScheduler, ReplicaRouter, RebalancePolicy, SimCluster)):
        sims = [mod.PipelineSimulator(
            sc_cls(th_cls(pipeline_depth=2),
                   kv_cls(num_pages=pages, page_size=16),
                   max_model_len=pages * 16), 2, c)
            for pages in (96, 2048)]
        router = rr(sims, policy="balanced",
                    rebalance=rb(interval=0.05, migrate=True))
        finished = sc(sims, router).run(arrivals)
        st = router.rebalance_stats
        out.append((sorted((r.request_id, r.metrics.ttft(), r.metrics.e2el(),
                            r.num_output_tokens) for r in finished),
                    router.routed_counts, st.stolen, st.migrated))
    assert len(out[1][0]) == 40
    assert out[1] == out[0]
