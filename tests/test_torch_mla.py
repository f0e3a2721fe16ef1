"""Multi-head latent attention (minicpm3-4b) in the port, on the CPU,
against the JAX package.

`attention.paged_attention_mla` computes the JAX function in its absorbed
form (``w_ukv``'s K half folded into q, the V half applied after the
softmax; JAX expands every key's latent into per-head K and V): held to
JAX's `paged_attention_mla` at atol 2e-6 in f32 over ragged contexts,
prefill and decode rows, a ctx=0 row and dead pages holding garbage.  The
serve path writes the latent pool ``[pages + 1, page, klr + dr]`` (padding
rows into the scratch page past the pool).  minicpm3-4b reduced, f32, pp=1
on the port's engine gives the JAX engine's greedy tokens, its per-tick
batches and JAX's dense reference's tokens, on the eager and the bucketed
async engine; dense logits agree at atol 1e-4; a request moved mid-decode
to a second engine (its latent pages move) finishes with the unmoved run's
tokens.
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
from repro_torch.configs import get_config, make_reduced
from repro_torch.core import SamplingParams, ThrottleConfig
from repro_torch.models import attention as attn
from repro_torch.models import serve as serve_lib
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.reference import dense_forward
from repro_torch.models.serve import ServeDims
from repro_torch.runtime.engine import PipelineEngine
from repro_torch.runtime.router import ReplicaRouter

ARCH = "minicpm3-4b"
DIMS = dict(Sp=1, C=16, Sd=8, pages=256, page=8, Bp=32, Bd=32, slots=16)
THROTTLE = dict(pipeline_depth=1, max_prefill_tokens=16,
                min_prefill_tokens=4, num_iters_T=2)
PROMPT_LENS = (7, 23, 12)
MAX_NEW = 5
ATOL = 2e-6          # f32; the absorbed and expanded forms sum differently


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    jcfg = jax_make_reduced(jax_get_config(ARCH))
    tcfg = make_reduced(get_config(ARCH))
    jcfg = dataclasses.replace(jcfg.with_plan(pp=1, tp=1), dtype="float32")
    tcfg = dataclasses.replace(tcfg.with_plan(pp=1, tp=1), dtype="float32")
    return jcfg, tcfg


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


def _serve(eng, prompts, sampling):
    reqs = [eng.add_request(p, sampling(max_new_tokens=MAX_NEW),
                            request_id=f"r{i}")
            for i, p in enumerate(prompts)]
    eng.drain(max_ticks=500)
    assert all(r.is_finished for r in reqs)
    return [r.output_token_ids for r in reqs]


@pytest.fixture(scope="module")
def served():
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(42)
    prompts = [[int(t) for t in rng.integers(0, jcfg.vocab_size, n)]
               for n in PROMPT_LENS]
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
    jticks = _record_ticks(jeng.backend)
    jtoks = _serve(jeng, prompts, JSamplingParams)
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    teng = PipelineEngine(tcfg, ServeDims(**DIMS), tparams,
                          ThrottleConfig(**THROTTLE), device="cpu")
    tticks = _record_ticks(teng.backend)
    ttoks = _serve(teng, prompts, SamplingParams)
    bucketed = PipelineEngine(tcfg, ServeDims(**DIMS), tparams,
                              ThrottleConfig(**THROTTLE), device="cpu",
                              bucketed=True, async_dispatch=True)
    # JAX's dense reference along the port's tokens, one jitted forward
    rows = [p + o for p, o in zip(prompts, ttoks)]
    ids = np.zeros((len(rows), max(map(len, rows))), np.int32)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
    logits = np.asarray(jax.jit(jax_reference.dense_forward,
                                static_argnums=0)(jcfg, jparams,
                                                  jnp.asarray(ids)))
    greedy = [[int(np.argmax(logits[i, len(p) - 1 + k]))
               for k in range(MAX_NEW)] for i, p in enumerate(prompts)]
    return dict(jcfg=jcfg, tcfg=tcfg, prompts=prompts, jparams=jparams,
                tparams=tparams, jtoks=jtoks, ttoks=ttoks, jticks=jticks,
                tticks=tticks, btoks=_serve(bucketed, prompts, SamplingParams),
                greedy=greedy, logits=logits, ids=ids, engine=teng)


# -------------------------------------------------------------- attention

def _mla_case(seed, S, C, ctx, *, H=4, klr=16, dn=16, dr=8, dv=16, page=8,
              B=6):
    rng = np.random.default_rng(seed)
    pages = S * B + 3
    q = rng.normal(size=(S, C, H, dn + dr)).astype(np.float32)
    cache = rng.normal(size=(pages, page, klr + dr)).astype(np.float32)
    w_ukv = (rng.normal(size=(klr, H * (dn + dv))) * 0.3).astype(np.float32)
    tables = rng.permutation(pages)[:S * B].reshape(S, B).astype(np.int32)
    ctx = np.asarray(ctx, np.int32)
    qpos = (np.maximum(ctx, C)[:, None] - C + np.arange(C)[None, :])
    return q, cache, w_ukv, tables, ctx, qpos.astype(np.int32)


@pytest.mark.parametrize("S,C,ctx", [
    (3, 1, [1, 17, 48]),          # decode rows, one on a page boundary
    (2, 5, [5, 31]),              # prefill chunks, one from position 0
    (3, 1, [0, 9, 40]),           # a ctx=0 (padding) row
], ids=["decode", "prefill", "ctx0"])
def test_paged_attention_mla_matches_jax(S, C, ctx):
    q, cache, w_ukv, tables, ctx_a, qpos = _mla_case(S + C, S, C, ctx)
    kw = dict(kv_lora_rank=16, qk_nope_dim=16, v_head_dim=16)
    want = np.asarray(jattn.paged_attention_mla(
        jnp.asarray(q), jnp.asarray(cache), jnp.asarray(w_ukv),
        jnp.asarray(tables), jnp.asarray(ctx_a), jnp.asarray(qpos),
        pages_per_block=2, **kw))
    got = attn.paged_attention_mla(
        torch.from_numpy(q), torch.from_numpy(cache),
        torch.from_numpy(w_ukv), torch.from_numpy(tables),
        torch.from_numpy(ctx_a), torch.from_numpy(qpos), **kw).numpy()
    assert got.shape == want.shape == (S, C, 4, 16)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_latent_pool_and_scratch_page():
    """The MLA layer's cache is a latent pool with the scratch page past
    its end; a padding row's latent lands there and nowhere else."""
    _, tcfg = _cfgs()
    dims = ServeDims(**DIMS)
    caches = serve_lib.init_caches(tcfg, dims)
    (grp,) = caches.values()
    assert tuple(grp["kv"].shape) == (1, 1, dims.pages + 1, dims.page,
                                      tcfg.kv_lora_rank + tcfg.qk_rope_dim)
    pool = grp["kv"][0, 0]
    valid = np.array([[True, True, False]])
    pages = np.array([[4, 4, -1]], np.int32)
    tgt = torch.from_numpy(attn.kv_targets(valid, pages, dims.pages))
    lat = torch.arange(3 * pool.shape[-1], dtype=torch.float32).view(
        1, 3, -1) + 1
    attn.write_kv_pages(pool, lat, tgt, torch.tensor([[0, 1, 2]]))
    assert torch.equal(pool[4, :2], lat[0, :2])
    assert torch.equal(pool[dims.pages, 2], lat[0, 2])
    assert int((pool[:dims.pages] != 0).sum()) == 2 * pool.shape[-1]


# ----------------------------------------------------------------- engine

def test_tokens_match_jax_engine_and_dense_reference(served):
    assert served["ttoks"] == served["jtoks"] == served["greedy"]


def test_tick_composition_matches(served):
    assert served["tticks"] == served["jticks"]


def test_bucketed_async_engine_gives_the_same_tokens(served):
    assert served["btoks"] == served["ttoks"]


def test_dense_forward_logits_match(served):
    got = dense_forward(served["tcfg"], served["tparams"],
                        torch.from_numpy(served["ids"]).long()).numpy()
    np.testing.assert_allclose(got, served["logits"], atol=1e-4, rtol=0)


def test_migrated_request_matches_unmoved_run(served):
    """A request moved mid-decode to a second engine (its latent pages
    re-mapped into the destination's pool) finishes with the tokens of the
    same request served without a move."""
    tcfg, params = served["tcfg"], served["tparams"]
    engines = [PipelineEngine(tcfg, ServeDims(**DIMS), params,
                              ThrottleConfig(**THROTTLE), device="cpu")
               for _ in range(2)]
    router = ReplicaRouter(engines)
    prompt = served["prompts"][1]
    req = engines[0].add_request(prompt, SamplingParams(max_new_tokens=8))
    for _ in range(200):
        engines[0].step()
        if req.num_output_tokens >= 3:
            break
    assert router.migrate_request(req.request_id, 0, 1)
    assert 0 < req.num_output_tokens < 8
    engines[1].drain(max_ticks=300)
    stay = served["engine"].add_request(prompt,
                                        SamplingParams(max_new_tokens=8))
    served["engine"].drain(max_ticks=300)
    assert req.is_finished and stay.is_finished
    assert req.output_token_ids == stay.output_token_ids
    assert req.output_token_ids[:MAX_NEW] == served["ttoks"][1]
