"""Live migration between two of the port's engines, on the CPU: the twins
of tests/test_engine_migration.py, and hand-offs between the two packages.

Two port replicas share one read-only parameter set, as
`repro_torch.serving.build` builds them (the JAX launcher's --replicas
topology).  A request is moved by `ReplicaRouter.migrate_request` mid-decode,
or mid-prefill by the hand-off mechanism, and must finish with exactly the
greedy tokens of the dense reference: `greedy_generate` on the same
parameters (for qwen1.5-0.5b the JAX package's, carried across with
`params_from_numpy`; for rwkv6-3b and the jamba cut, one layer of each kind,
the port's own, since their JAX engine misses its dense reference: ROADMAP
Queue 3, the slot-0 fault).  On rwkv6-3b and the jamba cut the recurrent
state slots move with the request; on jamba the KV pages move too.

Each case runs on the eager engine and on the bucketed async one.  An async
engine holds every running request in flight between its steps; the router
settles the source (retires its deferred tick) before it moves one.

The `"{group}/kv"` payload is the JAX engine's wire format: a payload
exported by the JAX engine mid-decode (as numpy) imports into a port engine,
and one exported by the port imports into a JAX engine; either way the
request finishes with the JAX reference's tokens.
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
from repro_torch.runtime.router import ReplicaRouter

ensure_jax_compat()   # jax may be imported after repro in combined runs

QWEN, RWKV, JAMBA = "qwen1.5-0.5b", "rwkv6-3b", "jamba-1.5-large-398b"
ARCHS = [QWEN, RWKV, JAMBA]
MODES = {"eager": {}, "bucketed_async": dict(bucketed=True,
                                             async_dispatch=True)}
DIMS = dict(Sp=1, C=16, Sd=8, pages=256, page=8, Bp=32, Bd=32, slots=16)
THROTTLE = dict(pipeline_depth=1, max_prefill_tokens=16,
                min_prefill_tokens=4, num_iters_T=2)


def _jax_setup():
    """The JAX reduced qwen (f32, pp=1) as tests/test_engine_migration.py
    builds it: (cfg, params, mesh)."""
    cfg = jax_make_reduced(jax_get_config(QWEN)).with_plan(
        pp=1, tp=1, ep_over_data=False)
    cfg = dataclasses.replace(cfg, dtype="float32")
    mesh = jax.make_mesh((1, 1, 1), ("data", "stage", "tensor"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)
    with jax.set_mesh(mesh):
        params = jtfm.init_params(cfg, jax.random.key(0), dtype=jnp.float32)
        params = jax.tree.map(
            lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
            params, jtfm.param_pspecs(cfg),
            is_leaf=lambda x: isinstance(x, P))
    return cfg, params, mesh


_JAX = {}


def jax_qwen():
    if not _JAX:
        _JAX["cfg"], _JAX["params"], _JAX["mesh"] = _jax_setup()
    return _JAX["cfg"], _JAX["params"], _JAX["mesh"]


def _cfg(arch: str):
    cfg = make_reduced(get_config(arch))
    if arch == JAMBA:
        cfg = cut_to_kinds(cfg, [BlockKind.MAMBA_MLP, BlockKind.MAMBA_MOE,
                                 BlockKind.ATTN_MOE])
    cfg = cfg.with_plan(pp=1, tp=1)
    return dataclasses.replace(
        cfg, dtype="float32",
        moe_capacity_factor=float(max(cfg.num_experts, 1)))


def build_pair(arch: str, mode: str):
    """Two port replicas sharing one parameter set, and the reference
    `want(prompt, n)`: the port's `greedy_generate` on the same parameters
    (for qwen, the JAX package's carried across; tests/test_torch_engine.py
    holds the two packages' references equal, and the cross-package tests
    below use the JAX one)."""
    cfg = _cfg(arch)
    if arch == QWEN:
        jcfg, jparams, mesh = jax_qwen()
        params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams))
    else:
        if arch not in _PARAMS:
            _PARAMS[arch] = init_params(cfg, 0)
        params = _PARAMS[arch]

    def want(prompt, n):
        return greedy_generate(cfg, params, prompt, n)
    engines = [PipelineEngine(cfg, ServeDims(**DIMS), params,
                              ThrottleConfig(**THROTTLE), device="cpu",
                              **MODES[mode]) for _ in range(2)]
    return cfg, want, engines


def jax_want(prompt, n, width=64):
    """The JAX package's `greedy_generate` on the reduced qwen, with its
    dense forward jitted at one padded width so that it compiles once: the
    forward is causal, so the padding after the last token moves no logit
    before it."""
    jcfg, jparams, mesh = jax_qwen()
    if "forward" not in _JAX:
        _JAX["forward"] = jax.jit(
            lambda p, t: jax_dense_forward(jcfg, p, t))
    toks, out = list(prompt), []
    with jax.set_mesh(mesh):
        for _ in range(n):
            ids = np.zeros((1, width), np.int32)
            ids[0, :len(toks)] = toks
            logits = _JAX["forward"](jparams, jnp.asarray(ids))
            out.append(int(jnp.argmax(logits[0, len(toks) - 1])))
            toks.append(out[-1])
    return out


_PAIRS, _PARAMS = {}, {}


def get_pair(arch: str, mode: str):
    if (arch, mode) not in _PAIRS:
        _PAIRS[arch, mode] = build_pair(arch, mode)
    return _PAIRS[arch, mode]


@pytest.fixture(scope="module",
                params=[(a, m) for a in ARCHS for m in MODES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    return get_pair(*request.param)


def _stateful(eng) -> bool:
    """Whether the engine's model holds recurrent state slots."""
    return any(name in eng.backend._SLOT_LEAF_AXIS
               for grp in eng.backend.caches.values() for name in grp)


def test_migrated_request_matches_dense_reference(pair):
    cfg, want, (eng_a, eng_b) = pair
    router = ReplicaRouter([eng_a, eng_b])
    rng = np.random.default_rng(3)
    prompt = [int(t) for t in rng.integers(0, cfg.vocab_size, 21)]
    max_new = 8

    req = eng_a.add_request(prompt, SamplingParams(max_new_tokens=max_new))
    for _ in range(200):
        eng_a.step()
        if req.num_output_tokens >= 3:
            break
    out_before = list(req.output_token_ids)
    assert router.migrate_request(req.request_id, 0, 1)
    assert 0 < req.num_output_tokens < max_new
    assert router.rebalance_stats.migrated == 1
    assert not eng_a.scheduler.kv.has_request(req.request_id)
    assert eng_b.scheduler.kv.has_request(req.request_id)
    assert req.request_id not in eng_a.slots.owner

    eng_b.drain(max_ticks=300)
    assert req.is_finished
    assert req.output_token_ids[:len(out_before)] == out_before
    assert req.output_token_ids == want(prompt, max_new)
    assert eng_a.slots.owner == {} and eng_b.slots.owner == {}


def test_mid_prefill_handoff_matches_dense_reference(pair):
    """A request moved between prefill chunks (cursor and prefilled KV or
    state in flight, no decode token yet) finishes its remaining chunks and
    its decode on the destination with the reference's tokens."""
    cfg, want, (eng_a, eng_b) = pair
    router = ReplicaRouter([eng_a, eng_b])
    rng = np.random.default_rng(7)
    prompt = [int(t) for t in rng.integers(0, cfg.vocab_size, 45)]
    max_new = 6

    req = eng_a.add_request(prompt, SamplingParams(max_new_tokens=max_new))
    moved = False
    for _ in range(200):
        eng_a.step()
        if 0 < req.num_prefilled < req.num_effective_prompt_tokens \
                and req.num_output_tokens == 0:
            if router._move_request(req.request_id, 0, 1, kind="handoff"):
                moved = True
                break
    assert moved, "never caught the request between prefill chunks"
    assert router.disagg_stats.handoffs == 1
    assert not eng_a.scheduler.kv.has_request(req.request_id)
    assert eng_b.scheduler.kv.num_tokens(req.request_id) == req.num_prefilled

    eng_b.drain(max_ticks=300)
    assert req.is_finished
    assert req.output_token_ids == want(prompt, max_new)


def test_unmigrated_and_migrated_runs_agree(pair):
    cfg, want, (eng_a, eng_b) = pair
    router = ReplicaRouter([eng_a, eng_b])
    rng = np.random.default_rng(11)
    prompt = [int(t) for t in rng.integers(0, cfg.vocab_size, 13)]
    max_new = 6

    stay = eng_a.add_request(prompt, SamplingParams(max_new_tokens=max_new))
    eng_a.drain(max_ticks=300)
    assert stay.is_finished

    move = eng_a.add_request(prompt, SamplingParams(max_new_tokens=max_new))
    for _ in range(200):
        eng_a.step()
        if move.num_output_tokens >= 2:
            break
    assert router.migrate_request(move.request_id, 0, 1)
    eng_b.drain(max_ticks=300)
    assert move.is_finished
    assert move.output_token_ids == stay.output_token_ids


def _mid_decode(eng, cfg, seed, n_out=4):
    rng = np.random.default_rng(seed)
    prompt = [int(t) for t in rng.integers(0, cfg.vocab_size, 19)]
    req = eng.add_request(prompt, SamplingParams(max_new_tokens=12))
    for _ in range(200):
        eng.step()
        if req.num_output_tokens >= n_out:
            break
    eng.settle()                       # retire a deferred (async) tick
    assert eng.scheduler.drain_request(req.request_id) is req
    return req


def test_pages_and_state_bit_identical_across_transfer(pair):
    """KV gathered at the source slots equals the destination's pools at the
    re-mapped slots after the import, and the state slots' leaves equal the
    destination slot's; every pool keeps its address (the CUDA graphs replay
    on these tensors)."""
    cfg, want, (eng_a, eng_b) = pair
    req = _mid_decode(eng_a, cfg, 5)
    rid = req.request_id
    ptrs = {(gk, n): a.data_ptr() for gk, grp in eng_b.backend.caches.items()
            for n, a in grp.items()}
    export = eng_a.scheduler.kv.export_kv(rid)
    payload = eng_a.backend.export_kv_pages(rid, export.slots)
    state = eng_a.backend.export_request_state(req)
    has_kv = any("kv" in grp for grp in eng_a.backend.caches.values())
    assert bool(payload) == has_kv
    assert bool(state["slot_leaves"]) == _stateful(eng_a)

    dst_slots = eng_b.scheduler.kv.import_kv(export)
    eng_b.backend.import_kv_pages(rid, payload, dst_slots)
    eng_b.backend.import_request_state(req, state)
    after = eng_b.backend.export_kv_pages(rid, dst_slots)
    assert set(payload) == set(after)
    for key in payload:
        assert torch.equal(payload[key], after[key])
    back = eng_b.backend.export_request_state(req)["slot_leaves"]
    assert set(back) == set(state["slot_leaves"])
    for key, leaf in state["slot_leaves"].items():
        assert torch.equal(leaf, back[key])
    assert ptrs == {(gk, n): a.data_ptr()
                    for gk, grp in eng_b.backend.caches.items()
                    for n, a in grp.items()}
    # cleanup so the module-scoped pair stays reusable
    eng_b.scheduler.kv.free(rid)
    eng_a.scheduler.kv.free(rid)
    eng_a.backend.finish_request(req)
    assert eng_b.slots.owner == {} and eng_a.slots.owner == {}


def test_import_raises_on_a_payload_that_does_not_fit(pair):
    """A payload of the wrong shape or group, or slots on the scratch page,
    raise; nothing is written."""
    cfg, want, (eng_a, eng_b) = pair
    be = eng_b.backend
    slots = [(3, 0), (3, 1)]
    kv_groups = [gk for gk, grp in be.caches.items() if "kv" in grp]
    if kv_groups:
        pool = be.caches[kv_groups[0]]["kv"]
        good = {f"{gk}/kv": torch.zeros(pool.shape[:2] + (2,)
                                        + pool.shape[4:])
                for gk in kv_groups}
        with pytest.raises(ValueError, match="shape"):
            be.import_kv_pages("x", {k: v[:, :, :1] for k, v in good.items()},
                               slots)
        with pytest.raises(ValueError, match="payload holds"):
            be.import_kv_pages("x", dict(good, **{"nope/kv": good[
                f"{kv_groups[0]}/kv"]}), slots)
        with pytest.raises(ValueError, match="outside"):
            be.import_kv_pages("x", good, [(DIMS["pages"], 0), (0, 0)])
        with pytest.raises(ValueError, match="outside"):
            be.export_kv_pages("x", [(DIMS["pages"], 0)])
    state = {"enc": None, "slot_leaves": {"nope/wkv": torch.zeros(1)}}
    req = eng_b.add_request([1, 2, 3], SamplingParams(max_new_tokens=1))
    eng_b.abort_request(req.request_id)
    if _stateful(eng_b):
        with pytest.raises(ValueError, match="state payload"):
            be.import_request_state(req, state)
    assert req.request_id not in eng_b.slots.owner


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", [RWKV, JAMBA])
def test_delivery_without_a_free_slot_falls_back_to_recompute(arch, mode):
    """When the destination has no state slot left, `import_request_state`
    raises `MemoryError` and the router re-admits the request by recompute:
    it still finishes with the reference's tokens."""
    cfg, want, (eng_a, eng_b) = get_pair(arch, mode)
    router = ReplicaRouter([eng_a, eng_b])
    rng = np.random.default_rng(13)
    prompt = [int(t) for t in rng.integers(0, cfg.vocab_size, 17)]
    req = eng_a.add_request(prompt, SamplingParams(max_new_tokens=6))
    for _ in range(200):
        eng_a.step()
        if req.num_output_tokens >= 2:
            break
    hogs = [f"hog-{i}" for i in range(len(eng_b.slots.free))]
    for h in hogs:
        eng_b.slots.get(h)
    assert router.migrate_request(req.request_id, 0, 1)
    assert router.rebalance_stats.migration_fallbacks == 1
    assert not eng_b.scheduler.kv.has_request(req.request_id)
    for h in hogs:
        eng_b.slots.release(h)
    eng_b.drain(max_ticks=300)
    assert req.is_finished
    assert req.output_token_ids == want(prompt, 6)
    assert eng_b.slots.owner == {}


# ---------------------------------------------------------------------------
# across the two packages: the same wire format
# ---------------------------------------------------------------------------

def _jax_engine():
    jcfg, jparams, mesh = jax_qwen()
    with jax.set_mesh(mesh):
        return JaxEngine(jcfg, JServeDims(**DIMS, Te=0), jparams, mesh,
                         JThrottleConfig(**THROTTLE))


_JAX_ENGINE = []


@pytest.fixture(scope="module", params=list(MODES))
def cross(request):
    """The port's engine (eager or bucketed async) and one JAX engine."""
    cfg, _, (eng, _) = get_pair(QWEN, request.param)
    if not _JAX_ENGINE:
        _JAX_ENGINE.append(_jax_engine())
    return cfg, jax_want, eng, _JAX_ENGINE[0]


def _adopt(dst, req, export, payload, state):
    """What the router's `_deliver` does on the destination."""
    slots = dst.scheduler.kv.import_kv(export)
    dst.backend.import_kv_pages(req.request_id, payload, slots)
    dst.backend.import_request_state(req, state)
    dst.scheduler.adopt_request(req)


def _handed_off(src, dst, prompt, sampling, to_numpy):
    """Serve `prompt` on `src` to mid-decode, move it to `dst` (the payload
    through numpy when `to_numpy`), finish it there."""
    req = src.add_request(prompt, sampling)
    for _ in range(200):
        src.step()
        if req.num_output_tokens >= 3:
            break
    assert 0 < req.num_output_tokens < sampling.max_new_tokens
    rid = req.request_id
    if hasattr(src, "settle"):
        src.settle()                   # the port's async engine
    assert src.scheduler.drain_request(rid) is req
    export = src.scheduler.kv.export_kv(rid)
    payload = src.backend.export_kv_pages(rid, export.slots)
    state = src.backend.export_request_state(req)
    if to_numpy:
        payload = {k: np.asarray(v) for k, v in payload.items()}
    src.scheduler.kv.free(rid)
    _adopt(dst, req, export, payload, state)
    dst.drain(max_ticks=300)
    assert req.is_finished
    return req


def test_jax_to_torch_handoff(cross):
    """Exported by the JAX engine mid-decode, `np.asarray`'d, imported into
    the port's engine, finished there: the JAX reference's tokens."""
    cfg, want, teng, jeng = cross
    rng = np.random.default_rng(17)
    prompt = [int(t) for t in rng.integers(0, cfg.vocab_size, 27)]
    jcfg, jparams, mesh = jax_qwen()
    with jax.set_mesh(mesh):
        req = _handed_off(jeng, teng, prompt,
                          JSamplingParams(max_new_tokens=8), to_numpy=True)
    assert req.output_token_ids == want(prompt, 8)
    assert teng.slots.owner == {}


def test_torch_to_jax_handoff(cross):
    """Exported by the port's engine mid-decode, imported into the JAX
    engine as numpy, finished there: the JAX reference's tokens."""
    cfg, want, teng, jeng = cross
    rng = np.random.default_rng(19)
    prompt = [int(t) for t in rng.integers(0, cfg.vocab_size, 27)]
    jcfg, jparams, mesh = jax_qwen()
    with jax.set_mesh(mesh):
        req = _handed_off(teng, jeng, prompt,
                          SamplingParams(max_new_tokens=8), to_numpy=True)
    assert req.output_token_ids == want(prompt, 8)


def test_payloads_of_both_packages_are_equal(cross):
    """The same prompt prefilled on both engines: the port's payload and the
    JAX engine's have the same keys and layout, and agree in value over the
    prompt's positions."""
    cfg, want, teng, jeng = cross
    rng = np.random.default_rng(23)
    prompt = [int(t) for t in rng.integers(0, cfg.vocab_size, 20)]
    jcfg, jparams, mesh = jax_qwen()
    got = []
    with jax.set_mesh(mesh):
        for eng, sp in ((teng, SamplingParams), (jeng, JSamplingParams)):
            req = eng.add_request(prompt, sp(max_new_tokens=4))
            for _ in range(200):
                eng.step()
                if req.num_output_tokens >= 1:
                    break
            rid = req.request_id
            if hasattr(eng, "settle"):
                eng.settle()
            assert eng.scheduler.drain_request(rid) is req
            export = eng.scheduler.kv.export_kv(rid)
            got.append({k: np.asarray(v) for k, v in
                        eng.backend.export_kv_pages(rid,
                                                    export.slots).items()})
            eng.scheduler.kv.free(rid)
            eng.backend.finish_request(req)
    port, ref = got
    assert set(port) == set(ref)
    n = len(prompt)     # the async engine may hold one decode token more
    for k in ref:
        assert port[k].shape[3:] == ref[k].shape[3:]
        assert port[k].shape[2] >= n and ref[k].shape[2] >= n
        np.testing.assert_allclose(port[k][:, :, :n], ref[k][:, :, :n],
                                   atol=1e-5, rtol=1e-5)
