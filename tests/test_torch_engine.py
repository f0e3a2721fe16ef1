"""The port's whole serving slice on the CPU against the JAX package: the
twin of tests/test_engine_equivalence.py::test_engine_matches_dense_reference.

The JAX `PipelineEngine` is built as that test builds it (1-device mesh,
pp=1, f32); its parameters are carried across with `params_from_numpy`; the
same prompts (one longer than the chunk, so prefill runs in several chunks)
are served by both engines.  Greedy tokens must be equal to both the JAX
engine's and JAX `greedy_generate`'s; the per-tick batch composition must be
equal tick by tick; dense logits agree at atol 1e-4 (f32, different
summation order).  The olmoe variant (ATTN_MOE) is dropless, as
tests/test_engine_equivalence.py builds it: capacity drops depend on the
batch, so a serving engine matches the dense reference only without them.
At the config's capacity factor (1.25) the two engines still agree with
each other, because both drop the same rows of the same batches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import BlockKind as JBlockKind
from repro.configs import BlockSpec as JBlockSpec
from repro.configs import get_config as jax_get_config
from repro.configs import make_reduced as jax_make_reduced
from repro.core import SamplingParams as JSamplingParams
from repro.core import ThrottleConfig as JThrottleConfig
from repro.models import transformer as jtfm
from repro.models import reference as jax_reference
from repro.models.serve import ServeDims as JServeDims
from repro.runtime.engine import PipelineEngine as JaxEngine
from repro_torch.configs import BlockKind, BlockSpec, get_config, make_reduced
from repro_torch.core import SamplingParams, ThrottleConfig
from repro_torch.distributed.pipeline import sample_tokens
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.reference import dense_forward
from repro_torch.models.serve import ServeDims
from repro_torch.runtime.engine import PipelineEngine

DIMS = dict(Sp=1, C=16, Sd=8, pages=256, page=8, Bp=32, Bd=32, slots=16)
THROTTLE = dict(pipeline_depth=1, max_prefill_tokens=16,
                min_prefill_tokens=4, num_iters_T=2)
PROMPT_LENS = (7, 23, 12, 41)        # 23 and 41 exceed C=16
MAX_NEW = 5


def _cfgs(variant, capacity_factor=None):
    """(jax cfg, port cfg) for one of the four variants, f32 at pp=1.  MoE
    variants are dropless unless `capacity_factor` is given."""
    arch = {"gqa": "qwen2.5-14b", "olmoe": "olmoe-1b-7b"}.get(
        variant, "qwen1.5-0.5b")
    jcfg = jax_make_reduced(jax_get_config(arch))
    tcfg = make_reduced(get_config(arch))
    if variant == "olmoe":
        cf = capacity_factor or float(jcfg.num_experts)
        jcfg = dataclasses.replace(jcfg, moe_capacity_factor=cf)
        tcfg = dataclasses.replace(tcfg, moe_capacity_factor=cf)
    if variant == "stacked3":
        jcfg = dataclasses.replace(
            jcfg, pattern=(JBlockSpec(JBlockKind.ATTN_MLP, 3),), num_layers=3)
        tcfg = dataclasses.replace(
            tcfg, pattern=(BlockSpec(BlockKind.ATTN_MLP, 3),), num_layers=3)
    if variant == "gqa":
        jcfg = dataclasses.replace(jcfg, num_kv_heads=2)
        tcfg = dataclasses.replace(tcfg, num_kv_heads=2)
    jcfg = dataclasses.replace(jcfg.with_plan(pp=1, tp=1, ep_over_data=False),
                               dtype="float32")
    tcfg = dataclasses.replace(tcfg.with_plan(pp=1, tp=1), dtype="float32")
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


def _serve_both(jcfg, tcfg, prompt_lens=PROMPT_LENS):
    """Serve the same prompts on the JAX engine and the port's, from the
    same parameters; returns (prompts, jparams, tparams, jreqs, treqs,
    jticks, tticks, port engine)."""
    mesh = jax.make_mesh((1, 1, 1), ("data", "stage", "tensor"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)
    rng = np.random.default_rng(42)
    prompts = [[int(t) for t in rng.integers(0, jcfg.vocab_size, n)]
               for n in prompt_lens]
    with jax.set_mesh(mesh):
        jparams = jtfm.init_params(jcfg, jax.random.key(0), dtype=jnp.float32)
        jparams = jax.tree.map(
            lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
            jparams, jtfm.param_pspecs(jcfg),
            is_leaf=lambda x: isinstance(x, P))
        jeng = JaxEngine(jcfg, JServeDims(**DIMS), jparams, mesh,
                         JThrottleConfig(**THROTTLE))
    jticks = _record_ticks(jeng.backend)
    jreqs = [jeng.add_request(p, JSamplingParams(max_new_tokens=MAX_NEW),
                              request_id=f"r{i}")
             for i, p in enumerate(prompts)]
    jeng.drain(max_ticks=500)

    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    teng = PipelineEngine(tcfg, ServeDims(**DIMS), tparams,
                          ThrottleConfig(**THROTTLE), device="cpu")
    tticks = _record_ticks(teng.backend)
    treqs = [teng.add_request(p, SamplingParams(max_new_tokens=MAX_NEW),
                              request_id=f"r{i}")
             for i, p in enumerate(prompts)]
    teng.drain(max_ticks=500)
    return prompts, jparams, tparams, jreqs, treqs, jticks, tticks, teng


@pytest.fixture(scope="module", params=["qwen1.5", "stacked3", "gqa",
                                        "olmoe"])
def served(request):
    jcfg, tcfg = _cfgs(request.param)
    (prompts, jparams, tparams, jreqs, treqs, jticks, tticks,
     teng) = _serve_both(jcfg, tcfg)

    # JAX greedy_generate itself, with its dense_forward jitted (one
    # compile per length instead of op-by-op dispatch)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_reference, "dense_forward",
                   jax.jit(jax_reference.dense_forward, static_argnums=0))
        greedy = [jax_reference.greedy_generate(jcfg, jparams, p, MAX_NEW)
                  for p in prompts]
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                prompts=prompts, jreqs=jreqs, treqs=treqs, jticks=jticks,
                tticks=tticks, teng=teng, greedy=greedy)


def test_tokens_match_jax_engine(served):
    for j, t in zip(served["jreqs"], served["treqs"]):
        assert j.is_finished and t.is_finished
        assert t.output_token_ids == j.output_token_ids, t.request_id


def test_tokens_match_jax_greedy_reference(served):
    for want, t in zip(served["greedy"], served["treqs"]):
        assert t.output_token_ids == want, t.request_id


def test_tick_composition_matches(served):
    assert served["tticks"] == served["jticks"]
    # prefill really ran in several chunks for the long prompts
    chunks = {}
    for prefill, _ in served["tticks"]:
        for rid, _n in prefill:
            chunks[rid] = chunks.get(rid, 0) + 1
    assert chunks["r3"] >= 3 and chunks["r1"] >= 2


def test_dense_forward_logits_match(served):
    toks = np.asarray([served["prompts"][1]], np.int32)
    want = np.asarray(jax_reference.dense_forward(
        served["jcfg"], served["jparams"], jnp.asarray(toks)))
    got = dense_forward(served["tcfg"], served["tparams"],
                        torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_kernel_counter_untouched_on_cpu(served):
    from repro_torch.kernels import moe_gemm
    from repro_torch.kernels import paged_attention as pa
    assert served["teng"].stats.ticks == len(served["tticks"])
    assert pa.launches == 0 and moe_gemm.launches == 0


def test_olmoe_engines_agree_at_config_capacity_factor(monkeypatch):
    """At capacity factor 1.25 rows may drop; the drops are a function of
    the batch, and both engines form the same batches, so their tokens and
    per-tick compositions are equal.  Eight experts and ten prompts fill
    the ticks enough that the capacity bites (counted on the port's side)."""
    from repro_torch.models import moe
    jcfg, tcfg = _cfgs("olmoe", capacity_factor=1.25)
    assert get_config("olmoe-1b-7b").moe_capacity_factor == 1.25
    jcfg = dataclasses.replace(jcfg, num_experts=8)
    tcfg = dataclasses.replace(tcfg, num_experts=8)
    dropped = []
    group_rows = moe._group_rows

    def counting(values, group_ids, num_groups, capacity):
        out = group_rows(values, group_ids, num_groups, capacity)
        sg, pos = out[2], out[3]
        dropped.append(int(((pos >= capacity) & (sg < num_groups)).sum()))
        return out

    monkeypatch.setattr(moe, "_group_rows", counting)
    _, _, _, jreqs, treqs, jticks, tticks, _ = _serve_both(
        jcfg, tcfg, prompt_lens=(7, 23, 12, 41, 9, 30, 15, 5, 26, 11))
    assert sum(dropped) > 0
    assert tticks == jticks
    for j, t in zip(jreqs, treqs):
        assert j.is_finished and t.is_finished
        assert t.output_token_ids == j.output_token_ids, t.request_id


def _jax_tree(cfg):
    return jax.tree.map(np.asarray, jtfm.init_params(
        cfg, jax.random.key(1), dtype=jnp.float32))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "kimi-k2-1t-a32b"])
def test_params_from_numpy_carries_moe_tree(arch):
    """Router, expert and (kimi-k2) shared-expert leaves carry across key
    for key, unchanged.  The port config is built from the JAX one field
    by field (the port's registry holds the same configs:
    tests/test_torch_archs.py)."""
    import repro_torch.configs.base as tbase
    jcfg = jax_make_reduced(jax_get_config(arch)).with_plan(
        pp=1, tp=1, ep_over_data=False)
    jcfg = dataclasses.replace(jcfg, dtype="float32")
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(tbase.ArchConfig)}
    fields["pattern"] = tuple(BlockSpec(BlockKind(b.kind.value), b.repeat)
                              for b in jcfg.pattern)
    fields["plan"] = tbase.ParallelPlan(pp=1, tp=1)
    tcfg = tbase.ArchConfig(**fields)
    tree = _jax_tree(jcfg)
    got = params_from_numpy(tcfg, tree)
    block = tree["stages"]["b0_attn_moe"]
    want_keys = {"router", "w_gate", "w_up", "w_down"}
    if jcfg.num_shared_experts:
        want_keys |= {"s_gate", "s_up", "s_down"}
    assert want_keys <= set(block)
    for k, a in block.items():
        np.testing.assert_array_equal(
            got["stages"]["b0_attn_moe"][k].numpy(), a)
    np.testing.assert_array_equal(got["embed"]["tok"].numpy(),
                                  tree["embed"]["tok"])


def test_params_from_numpy_raises_on_missing_key():
    jcfg, tcfg = _cfgs("qwen1.5")
    tree = _jax_tree(jcfg)
    del tree["stages"]["b0_attn_mlp"]["bq"]
    with pytest.raises(KeyError, match="missing.*bq"):
        params_from_numpy(tcfg, tree)


def test_params_from_numpy_raises_on_extra_key():
    jcfg, tcfg = _cfgs("qwen1.5")
    tree = _jax_tree(jcfg)
    tree["final_norm"]["b"] = np.zeros(jcfg.d_model, np.float32)
    with pytest.raises(KeyError, match="extra.*'b'"):
        params_from_numpy(tcfg, tree)


def test_params_from_numpy_raises_on_shape_mismatch():
    jcfg, tcfg = _cfgs("qwen1.5")
    tree = _jax_tree(jcfg)
    tree["embed"]["tok"] = tree["embed"]["tok"][:-1]
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(tcfg, tree)


def test_temperature_sampling_matches_softmax_in_distribution():
    """Temperature draws follow softmax(logits / T) (the distribution of
    jax.random.categorical; the draws themselves differ); T = 0 rows stay
    greedy."""
    n = 40000
    logits = torch.tensor([[1.0, 0.0, -1.0, 2.0]]).repeat(n, 1)
    temps = torch.full((n,), 0.7)
    temps[: n // 4] = 0.0
    gen = torch.Generator().manual_seed(0)
    toks = sample_tokens(logits, {"temps": temps, "generator": gen})
    assert toks.dtype == torch.int32
    assert torch.all(toks[: n // 4] == 3)
    freq = np.bincount(toks[n // 4:].numpy(), minlength=4) / (n - n // 4)
    want = torch.softmax(logits[0] / 0.7, dim=0).numpy()
    np.testing.assert_allclose(freq, want, atol=0.01)


def test_engine_serves_temperature_requests():
    _, tcfg = _cfgs("qwen1.5")
    from repro_torch.models.transformer import init_params
    eng = PipelineEngine(tcfg, ServeDims(**DIMS), init_params(tcfg, 0),
                         ThrottleConfig(**THROTTLE), device="cpu")
    reqs = [eng.add_request(list(range(1, 10 + i)),
                            SamplingParams(max_new_tokens=4, temperature=t))
            for i, t in enumerate((0.0, 0.8, 1.5))]
    eng.drain(max_ticks=200)
    for r in reqs:
        assert r.is_finished and r.num_output_tokens == 4
        assert all(0 <= t < tcfg.vocab_size for t in r.output_token_ids)


def test_meta_to_device_one_buffer_round_trip():
    """One tick's metadata and token ids reach the device as int32 views of
    one buffer, the bucket program's static input, every field unchanged,
    plus each row's KV destination page: its own for the rows that write,
    the scratch page past the pool for the others."""
    from repro_torch.models import serve as tserve
    from repro_torch.models.attention import valid_rows
    from repro_torch.models.transformer import init_params
    _, tcfg = _cfgs("qwen1.5")
    dims = ServeDims(**DIMS)
    eng = PipelineEngine(tcfg, dims, init_params(tcfg, 0),
                         ThrottleConfig(**THROTTLE), device="cpu")
    rng = np.random.default_rng(4)
    meta = tserve.zero_meta(dims)
    meta["p_chunk_lens"][0] = 5
    meta["p_slot_pages"][0, :5] = rng.integers(0, dims.pages, 5)
    meta["d_valid"][:2] = 1
    meta["d_slot_pages"][:2] = rng.integers(0, dims.pages, 2)
    meta["d_block_tables"][:] = rng.integers(0, dims.pages,
                                             meta["d_block_tables"].shape)
    extra = {"p_tok": rng.integers(0, 100, (dims.Sp, dims.C)),
             "d_tok": rng.integers(0, 100, (dims.Sd,))}
    prog = eng.backend._program(dims)
    eng.backend._load(prog, tserve.host_meta(meta, dims, extra))
    out = prog.meta
    for k, a in {**meta, **extra}.items():
        assert out[k].dtype == torch.int32
        np.testing.assert_array_equal(out[k].numpy(), a)
    assert len({t.untyped_storage().data_ptr() for t in out.values()}) == 1
    assert out["p_tok"].untyped_storage().data_ptr() == \
        prog.static.untyped_storage().data_ptr()
    p_valid = np.arange(dims.C)[None, :] < meta["p_chunk_lens"][:, None]
    p_pages = out["p_kv_pages"].numpy()
    assert p_pages.shape == (dims.Sp, dims.C)
    np.testing.assert_array_equal(
        np.flatnonzero(p_pages.reshape(-1) < dims.pages),
        valid_rows(p_valid, meta["p_slot_pages"], dims.pages))
    np.testing.assert_array_equal(p_pages[p_valid],
                                  meta["p_slot_pages"][p_valid])
    assert out["d_kv_pages"].tolist() == (
        meta["d_slot_pages"][:2].tolist() + [dims.pages] * (dims.Sd - 2))


def test_deferred_result_is_ready_on_cpu():
    """Each tick's readback is deferred to `resolve()`; on the CPU its
    `ready()` probe reports True before the readback is forced."""
    _, tcfg = _cfgs("qwen1.5")
    from repro_torch.models.transformer import init_params
    eng = PipelineEngine(tcfg, ServeDims(**DIMS), init_params(tcfg, 0),
                         ThrottleConfig(**THROTTLE), device="cpu")
    eng.add_request([1, 2, 3], SamplingParams(max_new_tokens=2))
    seen = []
    execute = eng.backend.execute

    def probe(*args):
        res = execute(*args)
        seen.append((res.pending is not None, res.is_ready()))
        return res

    eng.backend.execute = probe
    eng.drain(max_ticks=20)
    assert seen and all(s == (True, True) for s in seen)
