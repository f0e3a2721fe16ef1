"""The port's architecture registry against the JAX package's, M-RoPE, and
the dense, GQA, M-RoPE and MoE archs this slice adds (qwen2-vl-7b,
internlm2-1.8b, kimi-k2-1t-a32b, qwen2.5-32b, llama3.1-100b) served on the
CPU against the JAX engine: the twin of
tests/test_engine_equivalence.py::test_engine_matches_dense_reference.

Each arch runs reduced (`make_reduced`), f32, pp=1 and dropless (capacity
factor = number of experts), as that test builds it; the JAX parameters
are carried across with `params_from_numpy`.  Greedy tokens must equal the
JAX engine's and JAX `greedy_generate`'s; the per-tick batch composition
must be equal tick by tick; dense logits agree at atol 1e-4 (f32,
different summation order); the port's bucketed async engine gives the
same tokens.  Padded layers (kimi: 61 of 64, minicpm3: 62 of 64) are
identity: a config with one layer slot past `num_layers` serves the JAX
engine's and the dense reference's tokens.  JAX's greedy tokens are read
off one teacher-forced dense forward (`_jax_greedy`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import BlockSpec as JBlockSpec
from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.configs import make_reduced as jax_make_reduced
from repro.core import SamplingParams as JSamplingParams
from repro.core import ThrottleConfig as JThrottleConfig
from repro.models import layers as jlayers
from repro.models import reference as jax_reference
from repro.models import transformer as jtfm
from repro.models.serve import ServeDims as JServeDims
from repro.runtime.engine import PipelineEngine as JaxEngine
from repro_torch.configs import (
    BlockSpec,
    get_config,
    list_archs,
    make_reduced,
)
from repro_torch.core import SamplingParams, ThrottleConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import apply_mrope, apply_rope
from repro_torch.models.reference import dense_forward
from repro_torch.models.serve import ServeDims
from repro_torch.runtime.engine import PipelineEngine

DIMS = dict(Sp=1, C=16, Sd=8, pages=256, page=8, Bp=32, Bd=32, slots=16)
THROTTLE = dict(pipeline_depth=1, max_prefill_tokens=16,
                min_prefill_tokens=4, num_iters_T=2)
PROMPT_LENS = (7, 23, 12)            # 23 exceeds C=16
MAX_NEW = 5
NEW_ARCHS = ("qwen2-vl-7b", "internlm2-1.8b", "kimi-k2-1t-a32b",
             "qwen2.5-32b", "llama3.1-100b")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tensors here are tiny, and when the suite
    runs a process per core several threads per op only spin against each
    other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _asdict(cfg) -> dict:
    def plain(v):
        if isinstance(v, dict):
            return {k: plain(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [plain(x) for x in v]
        return getattr(v, "value", v)
    return plain(dataclasses.asdict(cfg))


def _cfgs(arch, layers=None):
    """(jax cfg, port cfg): reduced, f32, pp=1, dropless; with `layers`
    (slots, live) one block kind stacked `slots` deep of which the first
    `live` are layers and the rest padding."""
    jcfg = jax_make_reduced(jax_get_config(arch))
    tcfg = make_reduced(get_config(arch))
    if layers is not None:
        slots, live = layers
        jcfg = dataclasses.replace(
            jcfg, pattern=(JBlockSpec(jcfg.pattern[0].kind, slots),),
            num_layers=live)
        tcfg = dataclasses.replace(
            tcfg, pattern=(BlockSpec(tcfg.pattern[0].kind, slots),),
            num_layers=live)
    cf = float(max(jcfg.num_experts, 1))
    jcfg = dataclasses.replace(
        jcfg.with_plan(pp=1, tp=1, ep_over_data=False), dtype="float32",
        moe_capacity_factor=cf)
    tcfg = dataclasses.replace(
        tcfg.with_plan(pp=1, tp=1, ep_over_data=False), dtype="float32",
        moe_capacity_factor=cf)
    return jcfg, tcfg


def _record_ticks(backend):
    """Wrap `backend.prepare` to log each tick's batch composition."""
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


def _jax_engine(jcfg):
    mesh = jax.make_mesh((1, 1, 1), ("data", "stage", "tensor"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)
    with jax.set_mesh(mesh):
        jparams = jtfm.init_params(jcfg, jax.random.key(0), dtype=jnp.float32)
        jparams = jax.tree.map(
            lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
            jparams, jtfm.param_pspecs(jcfg),
            is_leaf=lambda x: isinstance(x, P))
        jeng = JaxEngine(jcfg, JServeDims(**DIMS), jparams, mesh,
                         JThrottleConfig(**THROTTLE))
    return jparams, jeng


def _serve(eng, prompts):
    reqs = [eng.add_request(p, (JSamplingParams if isinstance(eng, JaxEngine)
                                else SamplingParams)(max_new_tokens=MAX_NEW),
                            request_id=f"r{i}")
            for i, p in enumerate(prompts)]
    eng.drain(max_ticks=500)
    assert all(r.is_finished for r in reqs)
    return [r.output_token_ids for r in reqs]


def _jax_greedy(jcfg, jparams, prompts, outs):
    """JAX's dense reference's greedy tokens along `outs`: one jitted
    `dense_forward` over every prompt followed by its output, padded at the
    end (causal: the padding changes no earlier logit), read at the
    positions that predict each output token.  Equal to `outs` exactly
    when `outs` is what JAX `greedy_generate` decodes, at one compile
    instead of one per length."""
    rows = [list(p) + list(o) for p, o in zip(prompts, outs)]
    width = max(len(r) for r in rows)
    ids = np.zeros((len(rows), width), np.int32)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
    fwd = jax.jit(jax_reference.dense_forward, static_argnums=0)
    logits = np.asarray(fwd(jcfg, jparams, jnp.asarray(ids)))
    return [[int(np.argmax(logits[i, len(p) - 1 + k]))
             for k in range(len(o))]
            for i, (p, o) in enumerate(zip(prompts, outs))]


@pytest.fixture(scope="module", params=NEW_ARCHS)
def served(request):
    jcfg, tcfg = _cfgs(request.param)
    rng = np.random.default_rng(42)
    prompts = [[int(t) for t in rng.integers(0, jcfg.vocab_size, n)]
               for n in PROMPT_LENS]
    jparams, jeng = _jax_engine(jcfg)
    jticks = _record_ticks(jeng.backend)
    jtoks = _serve(jeng, prompts)
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    teng = PipelineEngine(tcfg, ServeDims(**DIMS), tparams,
                          ThrottleConfig(**THROTTLE), device="cpu")
    tticks = _record_ticks(teng.backend)
    ttoks = _serve(teng, prompts)
    bucketed = PipelineEngine(tcfg, ServeDims(**DIMS), tparams,
                              ThrottleConfig(**THROTTLE), device="cpu",
                              bucketed=True, async_dispatch=True)
    return dict(jcfg=jcfg, tcfg=tcfg, prompts=prompts, jparams=jparams,
                tparams=tparams, jtoks=jtoks, ttoks=ttoks, jticks=jticks,
                tticks=tticks, btoks=_serve(bucketed, prompts),
                greedy=_jax_greedy(jcfg, jparams, prompts, ttoks))


# ---------------------------------------------------------------- registry

def test_every_jax_arch_resolves_and_an_unknown_name_raises():
    """The twelve archs of the JAX registry, in its order, field for
    field."""
    assert list_archs() == jax_list_archs()
    for arch in jax_list_archs():
        assert _asdict(get_config(arch)) == _asdict(jax_get_config(arch))
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")


@pytest.mark.parametrize("arch", NEW_ARCHS + ("minicpm3-4b",
                                              "whisper-small"))
def test_make_reduced_matches_jax(arch):
    t = make_reduced(get_config(arch))
    j = jax_make_reduced(jax_get_config(arch))
    assert _asdict(t) == _asdict(j)
    assert t.mrope_sections == (4, 2, 2) and t.num_shared_experts <= 1
    assert (t.q_lora_rank, t.kv_lora_rank, t.qk_nope_dim, t.qk_rope_dim,
            t.v_head_dim) == (32, 16, 16, 8, 16)


# ------------------------------------------------------------------ M-RoPE

@pytest.mark.parametrize("sections,dim", [((4, 2, 2), 16),
                                          ((16, 24, 24), 128)])
def test_apply_mrope_matches_jax_on_distinct_streams(sections, dim):
    """Three distinct position streams rotate the three frequency sections
    each by its own stream; equal streams are RoPE."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 3, dim)).astype(np.float32)
    pos3 = rng.integers(0, 4000, size=(3, 2, 5)).astype(np.int32)
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), sections,
                      1e6).numpy()
    want = np.asarray(jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos3),
                                          sections, 1e6))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # each section follows its own stream: moving one stream moves only
    # its section's bands
    moved = pos3.copy()
    moved[1] += 7
    diff = apply_mrope(torch.from_numpy(x), torch.from_numpy(moved),
                       sections, 1e6).numpy() - got
    half = dim // 2
    band = np.concatenate([np.full(n, i) for i, n in enumerate(sections)])
    changed = (np.abs(diff[..., :half]) > 0).any(axis=(0, 1, 2))
    assert np.array_equal(changed, band == 1)
    same = np.broadcast_to(pos3[0], pos3.shape)
    np.testing.assert_array_equal(
        apply_mrope(torch.from_numpy(x), torch.from_numpy(same.copy()),
                    sections, 1e6).numpy(),
        apply_rope(torch.from_numpy(x), torch.from_numpy(pos3[0]),
                   1e6).numpy())


# ------------------------------------------------------------------ engine

def test_tokens_match_jax_engine(served):
    assert served["ttoks"] == served["jtoks"]


def test_tokens_match_jax_greedy_reference(served):
    assert served["ttoks"] == served["greedy"]


def test_tick_composition_matches(served):
    assert served["tticks"] == served["jticks"]
    assert len(served["tticks"]) > len(PROMPT_LENS)


def test_bucketed_async_engine_gives_the_same_tokens(served):
    assert served["btoks"] == served["ttoks"]


def test_dense_forward_logits_match(served):
    ids = np.asarray([served["prompts"][1]], np.int32)
    want = np.asarray(jax_reference.dense_forward(
        served["jcfg"], served["jparams"], jnp.asarray(ids)))
    got = dense_forward(served["tcfg"], served["tparams"],
                        torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "minicpm3-4b"])
def test_padded_layers_are_identity(arch):
    """Two layer slots, one layer (as kimi pads 61 to 64 and minicpm3 62
    to 64): the port's engine serves the JAX engine's tokens and the
    JAX dense reference's (which skips the padded slot)."""
    jcfg, tcfg = _cfgs(arch, layers=(2, 1))
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(0, jcfg.vocab_size, n)]
               for n in (9, 20)]
    jparams, jeng = _jax_engine(jcfg)
    jtoks = _serve(jeng, prompts)
    tree = jax.tree.map(np.array, jparams)
    # the padded slot's weights are garbage that must not reach the output
    for leaves in tree["stages"].values():
        for name, a in leaves.items():
            a[:, 1] = 1e3
    tparams = params_from_numpy(tcfg, tree)
    teng = PipelineEngine(tcfg, ServeDims(**DIMS), tparams,
                          ThrottleConfig(**THROTTLE), device="cpu")
    ttoks = _serve(teng, prompts)
    assert ttoks == jtoks == _jax_greedy(jcfg, jparams, prompts, ttoks)


def test_weight_bytes_admit_32b_and_refuse_llama_on_one_card():
    """qwen2.5-32b's bf16 weights (65.5 GB) fit an 80 GB card whole;
    llama3.1-100b's (168.5 GB) do not, so the card serves it as a depth
    cut (`build_params` raises on the whole model)."""
    from repro_torch.launch.serve import serve_config, weight_bytes

    big, dtype = serve_config("qwen2.5-32b")
    assert big.num_layers == big.layers_per_stage == 64
    assert 65.0e9 < weight_bytes(big, dtype) < 66.0e9
    llama, dtype = serve_config("llama3.1-100b")
    assert weight_bytes(llama, dtype) > 160e9
