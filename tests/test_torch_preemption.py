"""Preemption, abort and scheduling-policy twins of the port's engine, on
the CPU: the counterparts of
tests/test_engine_equivalence.py::test_preemption_recompute_equivalence and
::test_sarathi_policy_same_outputs, and of
tests/test_system.py::test_state_slots_released_on_preemption and
::test_state_slots_released_on_abort_batch.

Each runs on the reduced qwen1.5-0.5b, rwkv6-3b and the jamba cut (one layer
of each kind), f32, dropless, on the eager engine (sync, unbucketed) and on
the bucketed async one.  They pin `release_resident_state` behind the
scheduler's `on_preempt` hook (a preempted or aborted request gives its
state slot back) and the recompute path: a preempted request re-prefills
from position 0, so its recurrent rows start from zero state (`p_fresh`)
on whatever slot they get.  The reference is the port's dense
`greedy_generate`, which tests/test_torch_engine.py, test_torch_rwkv.py and
test_torch_mamba.py hold to the JAX package's.
"""

import dataclasses

import numpy as np
import pytest

from repro_torch.configs import BlockKind, cut_to_kinds, get_config, make_reduced
from repro_torch.core import PrefillPolicy, SamplingParams, ThrottleConfig
from repro_torch.models.reference import greedy_generate
from repro_torch.models.serve import ServeDims
from repro_torch.models.transformer import init_params
from repro_torch.runtime.engine import PipelineEngine

JAMBA = "jamba-1.5-large-398b"
ARCHS = ["qwen1.5-0.5b", "rwkv6-3b", JAMBA]
MODES = {"eager": {}, "bucketed_async": dict(bucketed=True,
                                             async_dispatch=True)}
THROTTLE = dict(pipeline_depth=1, max_prefill_tokens=16,
                min_prefill_tokens=4, num_iters_T=2)


def _cfg(arch: str):
    """Reduced, f32, pp=1, dropless MoE; jamba cut to one layer a kind."""
    cfg = make_reduced(get_config(arch))
    if arch == JAMBA:
        cfg = cut_to_kinds(cfg, [BlockKind.MAMBA_MLP, BlockKind.MAMBA_MOE,
                                 BlockKind.ATTN_MOE])
    cfg = cfg.with_plan(pp=1, tp=1)
    return dataclasses.replace(
        cfg, dtype="float32",
        moe_capacity_factor=float(max(cfg.num_experts, 1)))


_PARAMS = {}


def build(arch: str, mode: str, pages: int = 256, **th_kw):
    cfg = _cfg(arch)
    if arch not in _PARAMS:
        _PARAMS[arch] = init_params(cfg, 0)
    dims = ServeDims(Sp=1, C=16, Sd=8, pages=pages, page=8, Bp=32, Bd=32,
                     slots=16)
    eng = PipelineEngine(cfg, dims, _PARAMS[arch],
                         ThrottleConfig(**THROTTLE, **th_kw), device="cpu",
                         **MODES[mode])
    return cfg, _PARAMS[arch], eng


@pytest.fixture(scope="module", params=[(a, m) for a in ARCHS for m in MODES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def preempted(request):
    """Three requests that admit while small and then outgrow a 10-page
    pool (decode-heavy growth), stepped one tick at a time: the streamed
    tokens, and after every tick the waiting requests that still held a
    state slot."""
    arch, mode = request.param
    cfg, params, eng = build(arch, mode, pages=10)
    streamed = {}
    eng.on_token = lambda req, tok: streamed.setdefault(
        req.request_id, []).append(tok)
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, 16)]
               for _ in range(3)]
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=18))
            for p in prompts]
    leaks = []
    steps = 0
    while (eng.has_work or eng.busy) and steps < 900:
        eng.step()
        steps += 1
        waiting = {r.request_id for r in eng.scheduler.waiting}
        leaks.append(set(eng.slots.owner) & waiting)
    return dict(cfg=cfg, params=params, eng=eng, prompts=prompts, reqs=reqs,
                streamed=streamed, leaks=leaks)


def test_preemption_recompute_equivalence(preempted):
    """Recompute never rewrites an already-streamed token, and requests that
    were never preempted equal the dense reference; a preempted request's
    tokens after its recompute may differ only at an argmax near-tie
    (chunked re-prefill sums in another order), so at least 5 agree."""
    eng = preempted["eng"]
    assert eng.scheduler.stats.preemptions >= 1, "test needs KV pressure"
    for p, r in zip(preempted["prompts"], preempted["reqs"]):
        assert r.is_finished and r.num_output_tokens == 18
        assert preempted["streamed"][r.request_id] == r.output_token_ids
        want = greedy_generate(preempted["cfg"], preempted["params"], p, 18)
        if r.metrics.num_preemptions == 0:
            assert r.output_token_ids == want
        else:
            agree = sum(a == b for a, b in zip(r.output_token_ids, want))
            assert agree >= 5, (r.output_token_ids, want)


def test_state_slots_released_on_preemption(preempted):
    """A preempted request gives its state slot back while it waits, and
    every slot is free after the drain."""
    eng = preempted["eng"]
    assert eng.scheduler.stats.preemptions >= 1, "test needs KV pressure"
    assert not any(preempted["leaks"]), [s for s in preempted["leaks"] if s]
    assert all(r.is_finished for r in preempted["reqs"])
    assert eng.slots.owner == {}
    assert sorted(eng.slots.free) == list(range(eng.dims.slots))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_state_slots_released_on_abort_batch(arch, mode):
    """abort_batch (worker-death recovery) releases the slots of the
    affected in-flight requests, which then recompute to the dense
    reference's tokens."""
    cfg, params, eng = build(arch, mode)
    prompt = [1] * 30
    r = eng.add_request(prompt, SamplingParams(max_new_tokens=4))
    batch = eng.scheduler.schedule(0.0)
    eng.backend.prepare(batch)            # tick metadata assigns the slot
    assert r.request_id in eng.slots.owner
    eng.scheduler.abort_batch(batch.batch_id)
    assert r.request_id not in eng.slots.owner
    assert r in eng.scheduler.waiting
    eng.drain(max_ticks=300)              # recompute completes normally
    assert r.is_finished and eng.slots.owner == {}
    assert r.output_token_ids == greedy_generate(cfg, params, prompt, 4)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sarathi_policy_same_outputs(arch, mode):
    """Policies change scheduling, never results."""
    outs = {}
    for pol in (PrefillPolicy.GLLM, PrefillPolicy.SARATHI):
        cfg, _, eng = build(arch, mode, policy=pol)
        rng = np.random.default_rng(7)
        prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
                   for n in (11, 19)]
        reqs = [eng.add_request(p, SamplingParams(max_new_tokens=5))
                for p in prompts]
        eng.drain(max_ticks=400)
        assert all(r.is_finished for r in reqs)
        outs[pol] = [r.output_token_ids for r in reqs]
    assert outs[PrefillPolicy.GLLM] == outs[PrefillPolicy.SARATHI]
