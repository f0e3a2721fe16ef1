"""Prefix caching in the port's engine, on the CPU: the twins of
tests/test_engine_prefix.py.

A request that adopts a cached prefix resumes its first chunk at
`num_prefilled = cached`, over KV pages an earlier request wrote; its greedy
tokens must equal the dense reference's (the port's `greedy_generate` on
the JAX package's parameters, carried across with `params_from_numpy`), and
the scheduler's prefix counters must equal the JAX engine's on the same
workload.  Rotary positions make this sharp: the adopted pages must hold the
prefix at positions 0..cached-1.  Adopted pages are read by several block
tables at once, so nothing may write them: their bytes are the same after
the adopting request has run.  qwen1.5-0.5b (ATTN_MLP) and olmoe-1b-7b
(ATTN_MOE, dropless), on the eager engine and on the bucketed async one.

The port refuses prefix caching for a pattern with RWKV or Mamba blocks
(`ValueError`): their state lives in slots, not pages, and a first chunk
that starts past position 0 runs on state it never computed.  The JAX
engine accepts it; the last test pins what it then does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.configs import make_reduced as jax_make_reduced
from repro.core import SamplingParams as JSamplingParams
from repro.core import ThrottleConfig as JThrottleConfig
from repro.jax_compat import ensure_jax_compat
from repro.models import transformer as jtfm
from repro.models.reference import dense_forward as jax_dense_forward
from repro.models.serve import ServeDims as JServeDims
from repro.runtime.engine import PipelineEngine as JaxEngine
from repro_torch.configs import BlockKind, cut_to_kinds, get_config, make_reduced
from repro_torch.core import SamplingParams, ThrottleConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.reference import greedy_generate
from repro_torch.models.serve import ServeDims
from repro_torch.models.transformer import init_params
from repro_torch.runtime.engine import PipelineEngine

ensure_jax_compat()   # jax may be imported after repro in combined runs

ARCHS = ["qwen1.5-0.5b", "olmoe-1b-7b"]
MODES = {"eager": {}, "bucketed_async": dict(bucketed=True,
                                             async_dispatch=True)}
DIMS = dict(Sp=1, C=16, Sd=8, pages=256, page=8, Bp=32, Bd=32, slots=16)
THROTTLE = dict(pipeline_depth=1, max_prefill_tokens=16,
                min_prefill_tokens=4, num_iters_T=2)
MAX_NEW = 6


def _jax_cfg(arch):
    cfg = jax_make_reduced(jax_get_config(arch)).with_plan(
        pp=1, tp=1, ep_over_data=False)
    return dataclasses.replace(
        cfg, dtype="float32",
        moe_capacity_factor=float(max(cfg.num_experts, 1)))


def _mesh():
    return jax.make_mesh((1, 1, 1), ("data", "stage", "tensor"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)


def _jax_params(cfg, mesh, seed=0):
    with jax.set_mesh(mesh):
        params = jtfm.init_params(cfg, jax.random.key(seed),
                                  dtype=jnp.float32)
        return jax.tree.map(
            lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
            params, jtfm.param_pspecs(cfg),
            is_leaf=lambda x: isinstance(x, P))


def _prompts(vocab):
    """Scenario 1: two prompts sharing 24 tokens (3 full pages); scenario
    2: one prompt of 32 tokens (4 full pages), asked twice."""
    rng = np.random.default_rng(7)
    shared = [int(t) for t in rng.integers(0, vocab, 24)]
    tail_a = [int(t) for t in rng.integers(0, vocab, 9)]
    tail_b = [int(t) for t in rng.integers(0, vocab, 5)]
    same = [int(t) for t in np.random.default_rng(11).integers(0, vocab, 32)]
    return [shared + tail_a, shared + tail_b, same, list(same)]


def _stats(sched):
    st = sched.stats
    return (st.prefix_lookups, st.prefix_hits, st.prefix_tokens_avoided)


def _serve(eng, prompts, sampling):
    """Each prompt alone, to completion, in order; the scheduler's prefix
    counters after each."""
    reqs, stats = [], []
    for p in prompts:
        reqs.append(eng.add_request(p, sampling(max_new_tokens=MAX_NEW)))
        eng.drain(max_ticks=500)
        assert reqs[-1].is_finished
        stats.append(_stats(eng.scheduler))
    return reqs, stats


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX engine with prefix caching on the same workload, per arch:
    (params as numpy, prefix counters after each request)."""
    out = {}
    mesh = _mesh()
    for arch in ARCHS:
        cfg = _jax_cfg(arch)
        params = _jax_params(cfg, mesh)
        with jax.set_mesh(mesh):
            eng = JaxEngine(cfg, JServeDims(**DIMS, Te=0), params, mesh,
                            JThrottleConfig(**THROTTLE),
                            enable_prefix_caching=True)
            _, stats = _serve(eng, _prompts(cfg.vocab_size), JSamplingParams)
        out[arch] = (jax.tree.map(np.asarray, params), stats)
    return out


@pytest.fixture(scope="module",
                params=[(a, m) for a in ARCHS for m in MODES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def served(request, jax_runs):
    arch, mode = request.param
    cfg = make_reduced(get_config(arch)).with_plan(pp=1, tp=1)
    cfg = dataclasses.replace(
        cfg, dtype="float32",
        moe_capacity_factor=float(max(cfg.num_experts, 1)))
    params = params_from_numpy(cfg, jax_runs[arch][0])
    eng = PipelineEngine(cfg, ServeDims(**DIMS), params,
                         ThrottleConfig(**THROTTLE), device="cpu",
                         enable_prefix_caching=True, **MODES[mode])
    # the bytes of every page a request adopts, as it adopts them
    adopted, seen = {}, set()
    inner = eng.backend.prepare

    def prepare(batch):
        if batch is not None:
            for seq in batch.prefill:
                rid = seq.request.request_id
                if rid in seen:
                    continue
                seen.add(rid)
                if seq.start_pos > 0:       # its first chunk: it adopted
                    pages = eng.kv.block_table(rid)[:seq.start_pos // 8]
                    adopted[rid] = {
                        gk: grp["kv"][:, :, pages].clone()
                        for gk, grp in eng.backend.caches.items()}, pages
        return inner(batch)

    eng.backend.prepare = prepare
    prompts = _prompts(cfg.vocab_size)
    reqs, stats = _serve(eng, prompts, SamplingParams)
    return dict(cfg=cfg, params=params, eng=eng, prompts=prompts, reqs=reqs,
                stats=stats, jax_stats=jax_runs[arch][1], adopted=adopted)


def test_prefix_adopted_request_matches_dense_reference(served):
    cfg, params = served["cfg"], served["params"]
    (p1, p2, _, _), (r1, r2, _, _) = served["prompts"], served["reqs"]
    (_, hits1, _), (_, hits2, avoided2) = served["stats"][:2]
    assert r1.output_token_ids == greedy_generate(cfg, params, p1, MAX_NEW)
    assert hits2 == hits1 + 1
    assert avoided2 >= 24
    assert r2.output_token_ids == greedy_generate(cfg, params, p2, MAX_NEW)
    served["eng"].scheduler.check_invariants()


def test_identical_prompt_reuses_all_but_last_token(served):
    """The probe drops the final prompt token (the first chunk must consume
    it to sample from), so an identical re-ask reuses 3 of its 4 pages."""
    cfg, params = served["cfg"], served["params"]
    p3 = served["prompts"][2]
    r3, r4 = served["reqs"][2:]
    assert served["stats"][3][2] == served["stats"][2][2] + 24
    assert r4.output_token_ids == r3.output_token_ids
    assert r3.output_token_ids == greedy_generate(cfg, params, p3, MAX_NEW)


def test_prefix_counters_equal_the_jax_engine(served):
    """prefix_lookups, prefix_hits and prefix_tokens_avoided after each
    request equal the JAX engine's on the same workload."""
    assert served["stats"] == served["jax_stats"]
    assert served["stats"][-1][1] >= 2


def test_adopted_pages_are_never_written(served):
    """The pages a request adopted hold the same bytes after it has run:
    its prefill and decode write only past the adopted head."""
    eng, adopted = served["eng"], served["adopted"]
    assert len(adopted) == 2, adopted.keys()
    for before, pages in adopted.values():
        assert len(pages) == 3
        for gk, grp in eng.backend.caches.items():
            assert torch.equal(grp["kv"][:, :, pages], before[gk])


def _recurrent_cfg(arch):
    cfg = make_reduced(get_config(arch))
    if arch == "jamba-1.5-large-398b":
        cfg = cut_to_kinds(cfg, [BlockKind.MAMBA_MLP, BlockKind.MAMBA_MOE,
                                 BlockKind.ATTN_MOE])
    return dataclasses.replace(cfg.with_plan(pp=1, tp=1), dtype="float32")


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-1.5-large-398b"])
def test_prefix_caching_refused_for_recurrent_patterns(arch):
    cfg = _recurrent_cfg(arch)
    params = init_params(cfg, 0)
    with pytest.raises(ValueError, match="prefix caching"):
        PipelineEngine(cfg, ServeDims(**DIMS), params,
                       ThrottleConfig(**THROTTLE), device="cpu",
                       enable_prefix_caching=True)
    eng = PipelineEngine(cfg, ServeDims(**DIMS), params,
                         ThrottleConfig(**THROTTLE), device="cpu")
    assert not eng.kv.enable_prefix_caching


def test_jax_prefix_caching_on_rwkv_resumes_on_state_it_never_computed():
    """The JAX engine accepts prefix caching on rwkv6-3b.  A request that
    adopts a 24-token prefix starts its first chunk at position 24 on a
    fresh slot, so its recurrent state lacks the prefix: after its prefill,
    its `wkv` and `cm_x` slots differ from those of the same request served
    with caching off (on the same slot, with a request holding slot 0 so
    that the JAX padding fault of ROADMAP Queue 3 stays out of the way).
    The reduced model's greedy tokens do not show it: both engines give
    the request the same tokens, since its dense logits move by less than
    0.1 when the whole prefix is replaced (zeros), and the argmax survives.
    """
    cfg = _jax_cfg("rwkv6-3b")
    mesh = _mesh()
    params = _jax_params(cfg, mesh)
    rng = np.random.default_rng(7)
    shared = [int(t) for t in rng.integers(0, cfg.vocab_size, 24)]
    tail_a = [int(t) for t in rng.integers(0, cfg.vocab_size, 9)]
    tail_b = [int(t) for t in rng.integers(0, cfg.vocab_size, 5)]
    states, hits, tokens = [], [], []
    with jax.set_mesh(mesh):
        for caching in (False, True):
            eng = JaxEngine(cfg, JServeDims(**DIMS, Te=0), params, mesh,
                            JThrottleConfig(**THROTTLE),
                            enable_prefix_caching=caching)
            eng.add_request([1, 2, 3], JSamplingParams(max_new_tokens=60))
            eng.step()
            r1 = eng.add_request(shared + tail_a,
                                 JSamplingParams(max_new_tokens=40))
            while r1.num_output_tokens < 1:
                eng.step()
            r2 = eng.add_request(shared + tail_b,
                                 JSamplingParams(max_new_tokens=4))
            while r2.num_output_tokens < 1:
                eng.step()
            slot = eng.slots.owner[r2.request_id]
            states.append({name: np.asarray(arr[:, :, slot])
                           for grp in eng.backend.caches.values()
                           for name, arr in grp.items()})
            hits.append(eng.scheduler.stats.prefix_hits)
            eng.drain(max_ticks=500)
            tokens.append(r2.output_token_ids)
        last = [len(shared + tail_b) - 1]
        logits = [jax_dense_forward(cfg, params, jnp.asarray([ids]))[0, last]
                  for ids in (shared + tail_b, [0] * 24 + tail_b)]
    assert hits == [0, 1]
    assert tokens[0] == tokens[1]
    shift = float(jnp.abs(logits[0] - logits[1]).max())
    assert shift < 0.1, shift
    assert int(jnp.argmax(logits[0])) == int(jnp.argmax(logits[1]))
    plain, cached = states
    assert np.abs(plain["tm_x"] - cached["tm_x"]).max() == 0.0
    for name in ("wkv", "cm_x"):
        gap = np.abs(plain[name] - cached[name]).max()
        assert gap > 1e-3 * np.abs(plain[name]).max(), (name, gap)
