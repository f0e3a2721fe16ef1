"""The port's copies of the router, disaggregation and autoscale modules,
on the CPU.

Their pure functions are held to the JAX package's on the same seeded
inputs: `balance_score`, `kv_activation`, `discovered_capacities`,
`ReplicaSnapshot.of` on the port's engines, `validate_roles` /
`handoff_candidates`, and the autoscale policy and pressure cases of
tests/test_autoscale.py (TestPolicy, TestPressure), with the port's
scheduler behind a replica stand-in.  Then a two-engine router whose
control plane steals waiting requests and live-migrates running ones off a
saturated replica with a tight KV pool: every request finishes exactly
once, the cluster invariants hold, and the tokens equal one engine's.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from repro.runtime import autoscale as jax_autoscale
from repro.runtime import disagg as jax_disagg
from repro.runtime import router as jax_router
from repro_torch.configs import get_config, make_reduced
from repro_torch.core import (PagedKVManager, PipelineScheduler, Request,
                              SamplingParams, ThrottleConfig)
from repro_torch.models.serve import ServeDims
from repro_torch.models.transformer import init_params
from repro_torch.runtime import autoscale, disagg, router
from repro_torch.runtime.engine import PipelineEngine
from repro_torch.runtime.router import RebalancePolicy, ReplicaRouter

THROTTLE = dict(pipeline_depth=1, max_prefill_tokens=16,
                min_prefill_tokens=4, num_iters_T=2)


def _snapshots(rng, n, cls=router.ReplicaSnapshot):
    out = []
    for _ in range(n):
        free = float(rng.uniform(0, 1))
        out.append(cls(
            waiting_prefill_tokens=int(rng.integers(0, 4000)),
            running_decode=int(rng.integers(0, 64)),
            kv_free_rate=free,
            kv_threshold=float(rng.uniform(0.01, 0.2)),
            projected_kv_free=(None if rng.uniform() < 0.3
                               else free - float(rng.uniform(0, 0.5))),
            service_rate=(None if rng.uniform() < 0.2
                          else float(rng.uniform(1, 500))),
            waiting_interactive=int(rng.integers(0, 20)),
            waiting_batch=int(rng.integers(0, 20)),
            cached_prefix_tokens=int(rng.integers(0, 300))))
    return out


def _weights(rng, cls):
    return cls(decode_tokens=float(rng.uniform(16, 256)),
               kv_pressure=float(rng.uniform(0, 8)),
               kv_activation_margin=float(rng.uniform(1, 6)),
               cache_affinity=float(rng.uniform(0, 1.5)),
               interactive_queue=float(rng.uniform(0, 8)),
               batch_queue=float(rng.uniform(0, 2)),
               discovered_rate=float(rng.uniform(0, 1)))


@pytest.mark.parametrize("seed", range(4))
def test_balance_score_and_kv_activation_match_jax(seed):
    rng = np.random.default_rng(seed)
    w = _weights(np.random.default_rng(seed), router.BalanceWeights)
    jw = _weights(np.random.default_rng(seed), jax_router.BalanceWeights)
    snaps = _snapshots(rng, 32)
    jsnaps = [jax_router.ReplicaSnapshot(**dataclasses.asdict(s))
              for s in snaps]
    caps = rng.uniform(0.2, 4, len(snaps))
    prompts = rng.integers(0, 2000, len(snaps))
    for s, js, c, p in zip(snaps, jsnaps, caps, prompts):
        assert router.balance_score(s, int(p), w, float(c)) == \
            jax_router.balance_score(js, int(p), jw, float(c))
        assert router.kv_activation(w, s.kv_threshold) == \
            jax_router.kv_activation(jw, s.kv_threshold)


@pytest.mark.parametrize("blend", [0.0, 0.25, 1.0])
@pytest.mark.parametrize("seed", range(3))
def test_discovered_capacities_match_jax(seed, blend):
    rng = np.random.default_rng(seed)
    snaps = _snapshots(rng, 4)
    jsnaps = [jax_router.ReplicaSnapshot(**dataclasses.asdict(s))
              for s in snaps]
    static = list(rng.uniform(0.5, 2, 4))
    assert router.discovered_capacities(snaps, static, blend) == \
        jax_router.discovered_capacities(jsnaps, static, blend)
    rated = [dataclasses.replace(s, service_rate=float(r))
             for s, r in zip(snaps, rng.uniform(1, 100, 4))]
    jrated = [jax_router.ReplicaSnapshot(**dataclasses.asdict(s))
              for s in rated]
    assert router.discovered_capacities(rated, static, blend) == \
        jax_router.discovered_capacities(jrated, static, blend)


def _engine(prefix=False):
    """A reduced qwen1.5-0.5b engine on the CPU."""
    cfg = make_reduced(get_config("qwen1.5-0.5b")).with_plan(pp=1, tp=1)
    cfg = dataclasses.replace(cfg, dtype="float32")
    dims = ServeDims(Sp=1, C=16, Sd=8, pages=256, page=8, Bp=32, Bd=32,
                     slots=16)
    return PipelineEngine(cfg, dims, init_params(cfg, 0),
                          ThrottleConfig(**THROTTLE), device="cpu",
                          enable_prefix_caching=prefix)


def test_replica_snapshot_of_an_engine_matches_jax():
    """`ReplicaSnapshot.of` of the port's engine at several instants of a
    served workload (waiting, mid-prefill, decoding, a cached prefix, batch
    class requests) equals the JAX function's on the same engine."""
    eng = _engine(prefix=True)
    rng = np.random.default_rng(5)
    shared = [int(t) for t in rng.integers(0, 256, 24)]
    for i in range(6):
        eng.add_request(shared + [int(t) for t in rng.integers(0, 256, 7)],
                        SamplingParams(max_new_tokens=5 + i,
                                       slo_class=("batch" if i % 2
                                                  else "interactive")))
    probe = shared + [1, 2, 3]
    seen = 0
    for _ in range(40):
        got = router.ReplicaSnapshot.of(eng, probe)
        want = jax_router.ReplicaSnapshot.of(eng, probe)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        seen += got.cached_prefix_tokens > 0
        eng.step()
    assert seen > 0
    eng.drain()


def test_roles_and_handoff_candidates_match_jax():
    for roles in [("prefill", "decode"), ("mixed",), ("mixed", "decode"),
                  ("prefill", "decode", "decode")]:
        assert disagg.validate_roles(roles, len(roles)) == \
            jax_disagg.validate_roles(roles, len(roles))
    for roles, n in [(("prefill", "prefill"), 2), (("decode",), 1),
                     (("prefill",), 2), (("nope", "decode"), 2)]:
        with pytest.raises(ValueError):
            disagg.validate_roles(roles, n)
        with pytest.raises(ValueError):
            jax_disagg.validate_roles(roles, n)
    for roles in [("prefill", "decode"), ("prefill", "mixed", "decode")]:
        for i in range(len(roles)):
            assert disagg.retirable(roles, i) == \
                jax_disagg.retirable(roles, i)
    eng = _engine()
    rng = np.random.default_rng(9)
    for n in (5, 12, 30, 8):
        eng.add_request([int(t) for t in rng.integers(0, 256, n)],
                        SamplingParams(max_new_tokens=9))
    pol = disagg.HandoffPolicy(max_decode_tokens=2)
    jpol = jax_disagg.HandoffPolicy(max_decode_tokens=2)
    assert dataclasses.asdict(pol) == dataclasses.asdict(jpol)
    for _ in range(30):
        eng.step()
        ids = [r.request_id for r in
               disagg.handoff_candidates(eng, pol, {})]
        assert ids == [r.request_id for r in
                       jax_disagg.handoff_candidates(eng, jpol, {})]
    eng.drain()


# ---------------------------------------------------------------------------
# autoscale: the policy and the pressure signal (tests/test_autoscale.py)
# ---------------------------------------------------------------------------

def make_replica(pages=256, page_size=8):
    """A replica stand-in: the port's scheduler, as the autoscale functions
    read it."""
    sched = PipelineScheduler(ThrottleConfig(pipeline_depth=2),
                              PagedKVManager(pages, page_size),
                              max_model_len=pages * page_size)
    return SimpleNamespace(scheduler=sched)


class TestPolicy:
    def test_defaults_are_sane(self):
        pol = autoscale.AutoscalePolicy()
        assert pol.down_threshold < pol.up_threshold
        assert pol.min_replicas >= 1 and pol.max_replicas >= pol.min_replicas
        assert pol.interval > 0 and pol.max_step_up >= 1
        assert dataclasses.asdict(pol) == dataclasses.asdict(
            jax_autoscale.AutoscalePolicy())

    @pytest.mark.parametrize("kw", [
        dict(min_replicas=0),
        dict(min_replicas=4, max_replicas=2),
        dict(down_threshold=1.0, up_threshold=1.0),
        dict(interval=0.0),
    ])
    def test_validation(self, kw):
        with pytest.raises(ValueError):
            autoscale.AutoscalePolicy(**kw)

    def test_spec_round_trip_exact(self):
        from repro_torch.serving import ClusterSpec, ServeSpec
        spec = ServeSpec(
            backend="sim",
            cluster=ClusterSpec(
                replicas=2,
                autoscale=autoscale.AutoscalePolicy(
                    interval=0.2, max_replicas=32, target_queue=6.0)))
        again = ServeSpec.from_json(spec.to_json())
        assert again == spec
        assert again.cluster.autoscale == autoscale.AutoscalePolicy(
            interval=0.2, max_replicas=32, target_queue=6.0)

    def test_spec_rejects_fleet_outside_policy_bounds(self):
        from repro_torch.serving import ClusterSpec
        with pytest.raises(ValueError, match="autoscale range"):
            ClusterSpec(replicas=2,
                        autoscale=autoscale.AutoscalePolicy(
                            min_replicas=3, max_replicas=8))
        with pytest.raises(ValueError, match="autoscale range"):
            ClusterSpec(replicas=9,
                        autoscale=autoscale.AutoscalePolicy(max_replicas=8))

    def test_spec_rejects_autoscale_off_sim(self):
        from repro_torch.serving import ClusterSpec, ServeSpec
        with pytest.raises(ValueError, match="sim"):
            ServeSpec(backend="engine",
                      cluster=ClusterSpec(
                          replicas=2, autoscale=autoscale.AutoscalePolicy()))


class TestPressure:
    def test_idle_replica_has_zero_pressure(self):
        pol = autoscale.AutoscalePolicy()
        assert autoscale.replica_pressure(make_replica(), pol) == 0.0
        assert autoscale.fleet_pressure([make_replica(), make_replica()],
                                        pol) == 0.0

    def test_queue_depth_normalizes_to_target(self):
        pol = autoscale.AutoscalePolicy(target_queue=4.0)
        rep = make_replica()
        for k in range(8):
            rep.scheduler.add_request(
                Request(f"q{k}", [1] * 16, SamplingParams(max_new_tokens=4)))
        assert autoscale.replica_pressure(rep, pol) == pytest.approx(2.0)
        assert autoscale.replica_pressure(rep, pol) == \
            jax_autoscale.replica_pressure(
                rep, jax_autoscale.AutoscalePolicy(target_queue=4.0))

    def test_kv_shortfall_matches_jax(self):
        """A replica whose resident decodes will outgrow its pool: the
        projected-KV shortfall term, against the JAX function."""
        rep = make_replica(pages=12, page_size=4)
        sched = rep.scheduler
        for k in range(4):
            sched.add_request(Request(f"d{k}", [1] * 8,
                                      SamplingParams(max_new_tokens=30)))
        for t in range(6):
            batch = sched.schedule(float(t))
            toks = [7] * sum(s.produces_token for s in batch.seqs)
            sched.complete(batch.batch_id, toks, float(t) + 0.5)
        assert sched.running_decode, "needs resident decodes"
        pol = autoscale.AutoscalePolicy()
        got = autoscale.replica_pressure(rep, pol)
        assert got > 0.0
        assert got == jax_autoscale.replica_pressure(
            rep, jax_autoscale.AutoscalePolicy())

    def test_scale_up_step_is_proportional_and_clamped(self):
        pol = autoscale.AutoscalePolicy(max_replicas=32, max_step_up=8)
        assert autoscale.scale_up_step(4, 1.01, pol) == 1
        assert autoscale.scale_up_step(4, 2.0, pol) == 4
        assert autoscale.scale_up_step(4, 10.0, pol) == 8
        assert autoscale.scale_up_step(30, 10.0, pol) == 2
        assert autoscale.scale_up_step(32, 10.0, pol) == 0
        jpol = jax_autoscale.AutoscalePolicy(max_replicas=32, max_step_up=8)
        for n in range(1, 33):
            for ewma in (0.5, 1.01, 2.0, 3.7, 10.0):
                assert autoscale.scale_up_step(n, ewma, pol) == \
                    jax_autoscale.scale_up_step(n, ewma, jpol)


# ---------------------------------------------------------------------------
# the control plane over two engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["eager", "bucketed_async"])
def test_rebalance_steals_and_migrates_and_tokens_hold(mode):
    """Every request is placed on replica 0, whose pool is tight; the
    control plane steals waiting requests and live-migrates running ones to
    replica 1.  Each request finishes exactly once, the invariants hold
    throughout, and every token equals one engine's run of the same
    prompts."""
    kw = dict(bucketed=True, async_dispatch=True) \
        if mode == "bucketed_async" else {}
    cfg = make_reduced(get_config("qwen1.5-0.5b")).with_plan(pp=1, tp=1)
    cfg = dataclasses.replace(cfg, dtype="float32")
    params = init_params(cfg, 3)

    def engine(pages):
        dims = ServeDims(Sp=1, C=16, Sd=8, pages=pages, page=8, Bp=32,
                         Bd=32, slots=16)
        return PipelineEngine(cfg, dims, params, ThrottleConfig(**THROTTLE),
                              device="cpu", **kw)

    rng = np.random.default_rng(21)
    prompts = [[int(t) for t in rng.integers(0, 256, n)]
               for n in rng.integers(6, 30, 10)]
    single = engine(256)
    want = [single.add_request(p, SamplingParams(max_new_tokens=24))
            for p in prompts]
    single.drain()

    pol = RebalancePolicy(interval=1e-6, trigger_ratio=1.2,
                          min_score_gap=1.0, steal_batch=2,
                          migrate_trigger_ratio=1.2, migrate_batch=2,
                          min_remaining_tokens=4)
    a, b = engine(24), engine(256)
    rt = ReplicaRouter([a, b], rebalance=pol)
    reqs = [a.add_request(p, SamplingParams(max_new_tokens=24))
            for p in prompts]
    rids = [r.request_id for r in reqs]
    for _ in range(2000):
        if not (rt.has_work or rt.busy):
            break
        rt.step()
        rt.check_invariants(expected_rids=rids)
    assert all(r.is_finished for r in reqs)
    st = rt.rebalance_stats
    assert st.stolen >= 1 and st.migrated >= 1, st
    assert st.migrated_tokens > 0
    done = [r.request_id for r in rt.finished]
    assert sorted(done) == sorted(rids)
    assert [r.output_token_ids for r in reqs] == \
        [r.output_token_ids for r in want]
    assert a.slots.owner == {} and b.slots.owner == {}
    assert a.kv.kv_free_rate == 1.0 and b.kv.kv_free_rate == 1.0
