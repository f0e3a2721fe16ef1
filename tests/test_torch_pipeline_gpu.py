"""The port's pipeline ring on the card: pp=2 and pp=4 engines whose S
stages run inside one CUDA graph per ladder bucket.  Every test carries the
``gpu`` marker and skips without a card; this file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_pipeline_gpu.py

The configurations are published widths cut in depth to a few layers, f32,
at small serve dims whose ladder has 12 buckets:
  * the bucketed graph engines, sync and async, and the eager sync engine
    serve one batch at pp = S from one set of weights (a view of the pp=1
    weights, `repartition_params`): identical greedy tokens, equal to the
    dense reference up to its first near-tie; each kernel launches S times
    its stage's layers per phase a tick runs (per replay), and the graph
    count, the pools' and the carry's addresses stay what `warm_start` left;
  * a pp=2 engine and a pp=1 engine on the same weights give the same
    tokens, the dense reference's up to its first near-tie.
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch

from repro_torch.configs import BlockSpec, get_config, single_stage, stage_config
from repro_torch.core import SamplingParams, ThrottleConfig
from repro_torch.distributed.elastic import repartition_params
from repro_torch.kernels import ops
from repro_torch.models.reference import greedy_trace
from repro_torch.models.serve import ServeDims
from repro_torch.models.transformer import init_params
from repro_torch.runtime.engine import PipelineEngine

DIMS = ServeDims(Sp=1, C=32, Sd=8, pages=64, page=16, Bp=8, Bd=8, slots=16)
NEAR_TIE = 1e-3
# name: (arch, layers in all, stages)
CASES = {"qwen1.5-0.5b-pp2": ("qwen1.5-0.5b", 4, 2),
         "qwen1.5-0.5b-pp4": ("qwen1.5-0.5b", 4, 4),
         "rwkv6-3b-pp2": ("rwkv6-3b", 2, 2),
         "olmoe-1b-7b-pp2": ("olmoe-1b-7b", 2, 2)}
MODES = {"eager": dict(cuda_graphs=False),
         "graphs": dict(bucketed=True),
         "graphs_async": dict(bucketed=True, async_dispatch=True)}


@pytest.fixture
def cuda_device():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    return torch.device("cuda")


def _one_stage(arch: str, layers: int):
    cfg = single_stage(get_config(arch))
    cfg = dataclasses.replace(
        cfg, num_layers=layers,
        pattern=(BlockSpec(cfg.pattern[0].kind, layers),), dtype="float32")
    return dataclasses.replace(
        cfg, moe_capacity_factor=(float(cfg.num_experts) if cfg.is_moe
                                  else cfg.moe_capacity_factor))


def _launch_want(cfg, st):
    kinds = [b.kind.value for b in cfg.pattern
             for _ in range(b.repeat)] * cfg.plan.pp
    kinds = kinds[:cfg.num_layers]
    phases = st.prefill_ticks + st.decode_ticks
    return {ops.pa: phases * sum(k.startswith("attn") for k in kinds),
            ops.moe_gemm: st.ticks * sum(k.endswith("_moe") for k in kinds),
            ops.wkv: phases * kinds.count("rwkv"),
            ops.s6: phases * sum(k.startswith("mamba") for k in kinds)}


def _addresses(backend) -> dict:
    out = {(g, n): t.data_ptr() for g, grp in backend.caches.items()
           for n, t in grp.items()}
    out.update({("carry", k): t.data_ptr()
                for k, t in (backend.carry or {}).items()})
    return out


def _serve(eng, prompts, max_new):
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=max_new))
            for p in prompts]
    eng.drain(max_ticks=2000)
    torch.cuda.synchronize()
    assert all(r.is_finished for r in reqs)
    return [r.output_token_ids for r in reqs]


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CASES))
def test_ring_graphs_match_eager_and_reference(cuda_device, name):
    arch, layers, S = CASES[name]
    one = _one_stage(arch, layers)
    cfg = stage_config(one, S)
    params1 = init_params(one, 0, dtype=torch.float32, device=cuda_device)
    params = repartition_params(params1, one, cfg)
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in (5, 40, 17, 70, 9, 33, 2, 24)]
    outs = {}
    for mode, kw in MODES.items():
        eng = PipelineEngine(cfg, DIMS, params,
                             ThrottleConfig(pipeline_depth=S), device="cuda",
                             dtype=torch.float32, **kw)
        graphs = eng.backend.graph_count()
        assert graphs == (12 if eng.backend.graphs else 0)
        addresses = _addresses(eng.backend)
        for mod in ops.COUNTED:
            mod.launches = 0
        outs[mode] = _serve(eng, prompts, 6)
        got = {mod: mod.launches for mod in ops.COUNTED}
        assert got == _launch_want(cfg, eng.stats), mode
        assert eng.backend.graph_count() == graphs
        assert _addresses(eng.backend) == addresses
        assert eng.stats.bubble_stage_ticks > 0
        del eng
    assert outs["graphs"] == outs["eager"] == outs["graphs_async"]
    for i, p in enumerate(prompts):
        want, gaps = greedy_trace(cfg, params, p, 6)
        stop = next((k for k, g in enumerate(gaps) if g < NEAR_TIE), 6)
        assert outs["eager"][i][:stop] == want[:stop], i
    del params, params1
    gc.collect()
    torch.cuda.empty_cache()


@pytest.mark.gpu
def test_pp2_and_pp1_serve_the_same_tokens_from_one_set_of_weights(
        cuda_device):
    one = _one_stage("qwen1.5-0.5b", 4)
    two = stage_config(one, 2)
    params1 = init_params(one, 0, dtype=torch.float32, device=cuda_device)
    params2 = repartition_params(params1, one, two)
    assert params2["stages"]["b0_attn_mlp"]["wq"].data_ptr() == \
        params1["stages"]["b0_attn_mlp"]["wq"].data_ptr()
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(0, one.vocab_size, n)]
               for n in (12, 50, 3)]
    outs = []
    for cfg, params in ((one, params1), (two, params2)):
        eng = PipelineEngine(cfg, DIMS, params,
                             ThrottleConfig(pipeline_depth=cfg.plan.pp),
                             device="cuda", dtype=torch.float32,
                             bucketed=True, async_dispatch=True)
        outs.append(_serve(eng, prompts, 5))
        del eng
    for i, p in enumerate(prompts):
        want, gaps = greedy_trace(one, params1, p, 5)
        stop = next((k for k, g in enumerate(gaps) if g < NEAR_TIE), 5)
        assert outs[0][i][:stop] == outs[1][i][:stop] == want[:stop], i
    gc.collect()
    torch.cuda.empty_cache()
