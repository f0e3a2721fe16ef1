"""The encoder-decoder (whisper-small) in the port, on the CPU, against the
JAX package.

`attention.cross_attention` (bidirectional, unmasked) equals JAX's at atol
1e-6.  Reduced whisper (Te = 16 encoder frames, as the JAX build makes it),
f32, pp=1: the port's engine gives the JAX engine's greedy tokens, its
per-tick batches and the JAX dense reference's tokens (the encoder input
prepended, the logits read on the decoder half), on the eager and the
bucketed async engine; dense logits agree at atol 1e-4.

**Folded stages.**  JAX's reduced whisper is ``(ENC, DEC)`` a stage over
two stages; `single_stage` folds it into ``ENC DEC ENC DEC``, two encoder
groups in one stage.  The port keeps one encoder snapshot per group, so
that decoder layer 1 cross-attends to the encoder after two layers, as the
dense reference does.  Two waves of requests (the second on the first's
slots) on the folded engine, eager and bucketed async, and on the port's
pp=2 engine, give the JAX dense reference's tokens.

**The last slot.**  JAX writes a padding prefill row's encoder snapshot at
``where(p_chunk_lens > 0, slots, -1)`` with ``mode="drop"``, and JAX
normalises -1 to the last slot: every tick with a padding prefill row
overwrites slot ``slots - 1``'s snapshot.  With 4 slots and 4 residents
(and the cross-attention's out-projection scaled so that the encoder moves
tokens at random init) the request on slot 3 misses the dense reference on
the JAX engine (pinned here, ROADMAP Queue 3) and matches it on the port,
whose padding rows write the scratch slot.

A request migrated mid-decode (its KV pages, its snapshots and its encoder
input move) finishes with the unmigrated run's tokens; `LLMServer` passes
``enc_embeds`` through to the engine.
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
from repro.models import attention as jattn
from repro.models import reference as jax_reference
from repro.models import transformer as jtfm
from repro.models.serve import ServeDims as JServeDims
from repro.runtime.engine import PipelineEngine as JaxEngine
from repro_torch.configs import BlockKind, get_config, make_reduced, single_stage
from repro_torch.core import SamplingParams, ThrottleConfig
from repro_torch.models import attention as attn
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.reference import dense_forward
from repro_torch.models.serve import ServeDims
from repro_torch.models.transformer import _block_key
from repro_torch.runtime.engine import PipelineEngine
from repro_torch.runtime.router import ReplicaRouter

ARCH = "whisper-small"
DIMS = dict(Sp=1, C=16, Sd=8, pages=256, page=8, Bp=32, Bd=32, slots=16,
            Te=16)
THROTTLE = dict(pipeline_depth=1, max_prefill_tokens=16,
                min_prefill_tokens=4, num_iters_T=2)
PROMPT_LENS = (7, 23, 12)
MAX_NEW = 5
MODES = {"eager": {}, "bucketed_async": dict(bucketed=True,
                                             async_dispatch=True)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh():
    return jax.make_mesh((1, 1, 1), ("data", "stage", "tensor"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)


def _jax_params(jcfg):
    mesh = _mesh()
    with jax.set_mesh(mesh):
        jparams = jtfm.init_params(jcfg, jax.random.key(0), dtype=jnp.float32)
        jparams = jax.tree.map(
            lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
            jparams, jtfm.param_pspecs(jcfg),
            is_leaf=lambda x: isinstance(x, P))
    return mesh, jparams


def _jax_engine(jcfg, jparams, mesh, **dims):
    with jax.set_mesh(mesh):
        return JaxEngine(jcfg, JServeDims(**{**DIMS, **dims}), jparams, mesh,
                         JThrottleConfig(**THROTTLE))


def _requests(seed, n, vocab, d, lens=None):
    rng = np.random.default_rng(seed)
    lens = lens or [int(x) for x in rng.integers(5, 30, n)]
    prompts = [[int(t) for t in rng.integers(0, vocab, L)] for L in lens]
    encs = [(rng.normal(size=(DIMS["Te"], d)) * 0.05).astype(np.float32)
            for _ in lens]
    return prompts, encs


def _serve(eng, prompts, encs, sampling, max_new=MAX_NEW, prefix="r"):
    reqs = [eng.add_request(p, sampling(max_new_tokens=max_new),
                            request_id=f"{prefix}{i}", enc_embeds=e)
            for i, (p, e) in enumerate(zip(prompts, encs))]
    eng.drain(max_ticks=800)
    assert all(r.is_finished for r in reqs)
    return [r.output_token_ids for r in reqs]


def _jax_greedy(jcfg, jparams, prompts, encs, outs):
    """JAX's dense reference's greedy tokens along `outs`: one jitted
    `dense_forward` over every prompt and its output (padded at the end;
    causal), each request's encoder input prepended, read on the decoder
    half at the positions that predict each output token."""
    rows = [list(p) + list(o) for p, o in zip(prompts, outs)]
    ids = np.zeros((len(rows), max(map(len, rows))), np.int32)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
    logits = np.asarray(jax.jit(jax_reference.dense_forward,
                                static_argnums=0)(
        jcfg, jparams, jnp.asarray(ids), jnp.asarray(np.stack(encs))))
    Te = encs[0].shape[0]
    return [[int(np.argmax(logits[i, Te + len(p) - 1 + k]))
             for k in range(len(o))]
            for i, (p, o) in enumerate(zip(prompts, outs))]


def _fold(tree, cfg, folded):
    """A numpy tree of `cfg` ([S, R, ...] stage leaves) re-laid for the
    folded config: its layers in stage order, grouped as `folded.pattern`
    groups them."""
    order = [(_block_key(i, bs), s, r) for s in range(cfg.plan.pp)
             for i, bs in enumerate(cfg.pattern) for r in range(bs.repeat)]
    order = order[:cfg.num_layers]
    stages, at = {}, 0
    for i, bs in enumerate(folded.pattern):
        group = order[at:at + bs.repeat]
        at += bs.repeat
        stages[_block_key(i, bs)] = {
            name: np.stack([tree["stages"][k][name][s, r]
                            for k, s, r in group])[None]
            for name in tree["stages"][group[0][0]]}
    return {**tree, "stages": stages}


# -------------------------------------------------------------- attention

def test_cross_attention_matches_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 3, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 24, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 24, 2, 16)).astype(np.float32)
    want = np.asarray(jattn.cross_attention(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v)))
    got = attn.cross_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# ------------------------------------------------------ one stage, pp = 1

@pytest.fixture(scope="module")
def served():
    jcfg = dataclasses.replace(
        jax_make_reduced(jax_get_config(ARCH)).with_plan(pp=1, tp=1),
        dtype="float32")
    tcfg = dataclasses.replace(
        make_reduced(get_config(ARCH)).with_plan(pp=1, tp=1),
        dtype="float32")
    mesh, jparams = _jax_params(jcfg)
    prompts, encs = _requests(42, 3, jcfg.vocab_size, jcfg.d_model,
                              list(PROMPT_LENS))
    jeng = _jax_engine(jcfg, jparams, mesh)
    jticks = _record_ticks(jeng.backend)
    jtoks = _serve(jeng, prompts, encs, JSamplingParams)
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    out = dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
               mesh=mesh, prompts=prompts, encs=encs, jtoks=jtoks,
               jticks=jticks)
    for mode, kw in MODES.items():
        eng = PipelineEngine(tcfg, ServeDims(**DIMS), tparams,
                             ThrottleConfig(**THROTTLE), device="cpu", **kw)
        ticks = _record_ticks(eng.backend)
        out[mode] = _serve(eng, prompts, encs, SamplingParams)
        out[f"{mode}_ticks"] = ticks
    out["greedy"] = _jax_greedy(jcfg, jparams, prompts, encs, out["eager"])
    return out


def _record_ticks(backend):
    ticks = []
    inner = backend.prepare

    def prepare(batch):
        if batch is not None:
            ticks.append((
                tuple((s.request.request_id, s.num_tokens)
                      for s in batch.prefill),
                tuple(s.request.request_id for s in batch.decode)))
        return inner(batch)

    backend.prepare = prepare
    return ticks


def test_tokens_match_jax_engine_and_dense_reference(served):
    assert served["eager"] == served["jtoks"] == served["greedy"]
    assert served["bucketed_async"] == served["eager"]


def test_tick_composition_matches(served):
    assert served["eager_ticks"] == served["jticks"]


def test_dense_forward_logits_match(served):
    ids = np.asarray([served["prompts"][1]], np.int32)
    enc = served["encs"][1][None]
    want = np.asarray(jax_reference.dense_forward(
        served["jcfg"], served["jparams"], jnp.asarray(ids),
        jnp.asarray(enc)))
    got = dense_forward(served["tcfg"], served["tparams"],
                        torch.from_numpy(ids).long(),
                        torch.from_numpy(enc)).numpy()
    assert got.shape == want.shape == (1, 16 + ids.shape[1],
                                       served["tcfg"].padded_vocab)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


# ------------------------------------------------------------ last slot

def test_request_on_the_last_slot_matches_dense_reference(served):
    """Four slots, four residents: the request on slot 3 shares its ticks
    with padding prefill rows.  At random init the cross-attention barely
    moves a token, so its out-projection is scaled by 30 (in both
    packages' weights).  The port matches the dense reference on every
    request and keeps slot 3's snapshot; the JAX engine zeroes slot 3's
    snapshot (a padding row's encoder output, on a zero payload) and misses
    the dense reference on slot 3 only."""
    jcfg, tcfg = served["jcfg"], served["tcfg"]
    tree = jax.tree.map(np.array, served["jparams"])
    tree["stages"]["b1_dec_layer"]["x_wo"] *= 30.0
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_numpy(tcfg, tree)
    prompts, encs = _requests(8, 4, jcfg.vocab_size, jcfg.d_model,
                              [6, 9, 5, 7])

    def serve(eng, sampling, snapshot):
        slots, get = {}, eng.slots.get
        eng.slots.get = lambda rid: slots.setdefault(rid, get(rid))
        reqs = [eng.add_request(p, sampling(max_new_tokens=8),
                                request_id=f"r{i}", enc_embeds=e)
                for i, (p, e) in enumerate(zip(prompts, encs))]
        kept = []
        while eng.has_work or eng.busy:
            eng.step()
            if reqs[3].num_output_tokens and not reqs[3].is_finished:
                kept.append(float(np.abs(snapshot(eng)).sum()) > 0)
        toks = [r.output_token_ids for r in reqs]
        assert sorted(slots.values()) == [0, 1, 2, 3]
        assert slots["r3"] == 3
        want = _jax_greedy(jcfg, jparams, prompts, encs, toks)
        return [t == w for t, w in zip(toks, want)], kept

    eng = PipelineEngine(tcfg, ServeDims(**{**DIMS, "slots": 4}), tparams,
                         ThrottleConfig(**THROTTLE), device="cpu")
    match, kept = serve(eng, SamplingParams, lambda e: e.backend.caches[
        "b0_enc_layer"]["h"][0, 3].numpy())
    assert match == [True] * 4 and kept and all(kept)
    jeng = _jax_engine(jcfg, jparams, served["mesh"], slots=4)
    match, kept = serve(jeng, JSamplingParams, lambda e: np.asarray(
        e.backend.caches["enc_h"]["h"][0, 3]))
    assert match == [True, True, True, False]
    assert not all(kept)


# -------------------------------------------------------- folded stages

@pytest.fixture(scope="module")
def folded():
    """JAX's reduced whisper at pp=2 (its weights, its dense reference)
    and the port's folded config with those weights laid out for it."""
    jcfg = dataclasses.replace(jax_make_reduced(jax_get_config(ARCH)),
                               dtype="float32")
    staged = dataclasses.replace(make_reduced(get_config(ARCH)),
                                 dtype="float32")
    one = single_stage(staged)
    assert [b.kind for b in one.pattern] == [BlockKind.ENC_LAYER,
                                            BlockKind.DEC_LAYER] * 2
    _, jparams = _jax_params(jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return dict(jcfg=jcfg, jparams=jparams, staged=staged, one=one,
                staged_params=params_from_numpy(staged, tree),
                one_params=params_from_numpy(one, _fold(tree, staged, one)))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("layout", ["folded", "pp2"])
def test_two_encoder_groups_match_dense_reference(folded, layout, mode):
    """Two waves (the second on the first's slots and snapshots) of the
    folded engine (two encoder groups in one stage) and of the pp=2 engine
    (one a stage) give JAX's dense reference's tokens."""
    cfg, params = ((folded["one"], folded["one_params"])
                   if layout == "folded" else
                   (folded["staged"], folded["staged_params"]))
    assert cfg.plan.pp == (1 if layout == "folded" else 2)
    eng = PipelineEngine(cfg, ServeDims(**DIMS), params,
                         ThrottleConfig(**{**THROTTLE,
                                           "pipeline_depth": cfg.plan.pp}),
                         device="cpu", **MODES[mode])
    slots = {}
    get = eng.slots.get
    eng.slots.get = lambda rid: slots.setdefault(rid, get(rid))
    jcfg = folded["jcfg"]
    prompts, encs = _requests(21, 8, jcfg.vocab_size, jcfg.d_model)
    toks = (_serve(eng, prompts[:4], encs[:4], SamplingParams, prefix="a")
            + _serve(eng, prompts[4:], encs[4:], SamplingParams, prefix="b"))
    first = {slots[f"a{i}"] for i in range(4)}
    assert {slots[f"b{i}"] for i in range(4)} <= first
    assert toks == _jax_greedy(jcfg, folded["jparams"], prompts, encs, toks)


# ------------------------------------------------- migration and serving

@pytest.mark.parametrize("mode", list(MODES))
def test_migrated_request_matches_unmigrated_run(folded, mode):
    """A whisper request moved mid-decode between two folded engines (its
    KV pages, both encoder snapshots and its encoder input move) finishes
    with the tokens of the same request served without a move."""
    cfg, params = folded["one"], folded["one_params"]
    engines = [PipelineEngine(cfg, ServeDims(**DIMS), params,
                              ThrottleConfig(**THROTTLE), device="cpu",
                              **MODES[mode]) for _ in range(2)]
    router = ReplicaRouter(engines)
    prompts, encs = _requests(5, 1, cfg.vocab_size, cfg.d_model, [13])
    stay = _serve(engines[0], prompts, encs, SamplingParams, max_new=8,
                  prefix="stay")[0]
    req = engines[0].add_request(prompts[0], SamplingParams(max_new_tokens=8),
                                 enc_embeds=encs[0])
    for _ in range(200):
        engines[0].step()
        if req.num_output_tokens >= 3:
            break
    assert router.migrate_request(req.request_id, 0, 1)
    assert 0 < req.num_output_tokens < 8
    assert req.request_id not in engines[0].enc_embeds
    assert req.request_id in engines[1].enc_embeds
    engines[1].drain(max_ticks=300)
    assert req.is_finished and req.output_token_ids == stay
    assert engines[1].enc_embeds == {} and engines[1].slots.owner == {}


def test_request_state_carries_encoder_input_and_snapshots(folded):
    cfg, params = folded["one"], folded["one_params"]
    eng = PipelineEngine(cfg, ServeDims(**DIMS), params,
                         ThrottleConfig(**THROTTLE), device="cpu")
    prompts, encs = _requests(6, 1, cfg.vocab_size, cfg.d_model, [9])
    req = eng.add_request(prompts[0], SamplingParams(max_new_tokens=6),
                          enc_embeds=encs[0])
    for _ in range(50):
        eng.step()
        if req.num_output_tokens >= 2:
            break
    slot = eng.slots.owner[req.request_id]
    state = eng.backend.export_request_state(req)
    np.testing.assert_array_equal(state["enc"], encs[0])
    assert sorted(state["slot_leaves"]) == ["b0_enc_layer/h",
                                            "b2_enc_layer/h"]
    h = eng.backend.caches["b2_enc_layer"]["h"]
    assert torch.equal(state["slot_leaves"]["b2_enc_layer/h"], h[:, slot])
    assert tuple(h.shape) == (1, DIMS["slots"] + 1, DIMS["Te"], cfg.d_model)


def test_llm_server_passes_enc_embeds_through():
    """`LLMServer.submit(..., enc_embeds=)` reaches the engine: the reduced
    build serves two requests with different encoder inputs and the same
    prompt, and each equals the engine served directly."""
    from repro_torch.serving import EngineSpec, ServeSpec, build

    server = build(ServeSpec(backend="engine",
                             engine=EngineSpec(arch=ARCH, reduced=True)),
                   device="cpu")
    eng = server.replicas[0]
    assert eng.dims.Te == 16
    cfg = eng.cfg
    prompts, encs = _requests(9, 2, cfg.vocab_size, cfg.d_model, [8, 8])
    prompts[1] = prompts[0]
    rids = [server.submit(p, SamplingParams(max_new_tokens=4), enc_embeds=e)
            for p, e in zip(prompts, encs)]
    server.drain()
    got = [o.token_ids for o in server.outputs(rids)]
    direct = PipelineEngine(cfg, eng.dims, eng.params, eng.scheduler.cfg,
                            device="cpu")
    assert got == _serve(direct, prompts, encs, SamplingParams, max_new=4)
    server.close()


def test_traced_whisper_engine_replays_in_both_packages(folded, tmp_path):
    """A folded whisper engine's tick trace (the JAX schema) replays
    strictly in the port and in the JAX package."""
    from repro.runtime.trace import check_trace as jax_check_trace
    from repro_torch.runtime.trace import check_trace

    cfg, params = folded["one"], folded["one_params"]
    path = str(tmp_path / "whisper.jsonl")
    eng = PipelineEngine(cfg, ServeDims(**DIMS), params,
                         ThrottleConfig(**THROTTLE), device="cpu",
                         trace_path=path)
    prompts, encs = _requests(4, 3, cfg.vocab_size, cfg.d_model)
    toks = _serve(eng, prompts, encs, SamplingParams, max_new=4)
    eng.recorder.close()
    for check in (check_trace, jax_check_trace):
        report = check(path)
        assert report.ticks == eng.stats.ticks
        assert sorted(report.outputs().values()) == sorted(toks)
