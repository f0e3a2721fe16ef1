"""Live migration between the port's CUDA-graph engines on the card.  Every
test carries the ``gpu`` marker; whether a card is present is decided in a
fixture at run time, so they skip without one.  This file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_router_gpu.py

Two bucketed async graph engines share one set of weights (published widths
cut in depth, f32, small serve dims) behind the `ReplicaRouter`; requests
are moved between them mid-decode and mid-prefill.  Imports write into the
pools in place, so every pool keeps its address and the graph count stays
what `warm_start` captured; every moved request's tokens equal those of an
eager single engine serving the same prompts, up to the dense reference's
first near-tie (top-2 logit gap < 1e-3).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import BlockSpec, get_config, single_stage
from repro_torch.core import SamplingParams, ThrottleConfig
from repro_torch.models.reference import greedy_trace
from repro_torch.models.serve import ServeDims
from repro_torch.models.transformer import init_params
from repro_torch.runtime.engine import PipelineEngine
from repro_torch.runtime.router import ReplicaRouter

DIMS = ServeDims(Sp=1, C=32, Sd=8, pages=64, page=16, Bp=8, Bd=8, slots=16)
NEAR_TIE = 1e-3
MAX_NEW = 10


@pytest.fixture
def cuda_device():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    return torch.device("cuda")


def _cfg(arch):
    cfg = single_stage(get_config(arch))
    return dataclasses.replace(
        cfg, num_layers=2, pattern=(BlockSpec(cfg.pattern[0].kind, 2),),
        dtype="float32")


def _engine(cfg, params, device, **kw):
    return PipelineEngine(cfg, DIMS, params, ThrottleConfig(pipeline_depth=1),
                          device=device, dtype=torch.float32, **kw)


def _pools(eng):
    return {f"{gk}/{n}": a.data_ptr()
            for gk, grp in eng.backend.caches.items()
            for n, a in grp.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "rwkv6-3b"])
def test_migration_between_graph_engines(cuda_device, arch):
    cfg = _cfg(arch)
    params = init_params(cfg, 0, dtype=torch.float32, device=cuda_device)
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in (70, 12, 40, 25, 9)]

    eager = _engine(cfg, params, cuda_device, cuda_graphs=False)
    want = [eager.add_request(p, SamplingParams(max_new_tokens=MAX_NEW))
            for p in prompts]
    eager.drain()
    del eager

    engines = [_engine(cfg, params, cuda_device, bucketed=True,
                       async_dispatch=True) for _ in range(2)]
    graphs = [e.backend.graph_count() for e in engines]
    pools = [_pools(e) for e in engines]
    assert all(g > 1 for g in graphs)
    router = ReplicaRouter(engines)
    reqs = [engines[0].add_request(p, SamplingParams(max_new_tokens=MAX_NEW))
            for p in prompts]
    moved = {"prefill": 0, "decode": 0}
    for _ in range(500):
        if not (router.has_work or router.busy):
            break
        router.step()
        for req in reqs:
            rid = req.request_id
            if not engines[0].kv.has_request(rid):
                continue
            if (moved["prefill"] < 1 and req.num_output_tokens == 0
                    and 0 < req.num_prefilled
                    < req.num_effective_prompt_tokens):
                moved["prefill"] += router.migrate_request(rid, 0, 1)
            elif moved["decode"] < 2 and 2 <= req.num_output_tokens <= 6:
                moved["decode"] += router.migrate_request(rid, 0, 1)
    assert moved == {"prefill": 1, "decode": 2}
    assert router.rebalance_stats.migrated == 3
    assert all(r.is_finished for r in reqs)
    assert [e.backend.graph_count() for e in engines] == graphs
    assert [_pools(e) for e in engines] == pools
    for p, got, ref in zip(prompts, reqs, want):
        _, gaps = greedy_trace(cfg, params, p, MAX_NEW)
        stop = next((k for k, g in enumerate(gaps) if g < NEAR_TIE), MAX_NEW)
        assert got.output_token_ids[:stop] == ref.output_token_ids[:stop]
    assert engines[0].slots.owner == {} and engines[1].slots.owner == {}


@pytest.mark.gpu
def test_cuda_import_refuses_a_payload_that_does_not_fit(cuda_device):
    cfg = _cfg("qwen1.5-0.5b")
    params = init_params(cfg, 0, dtype=torch.float32, device=cuda_device)
    eng = _engine(cfg, params, cuda_device, bucketed=True)
    gk, grp = next(iter(eng.backend.caches.items()))
    pool = grp["kv"]
    slots = [(1, 0), (1, 1)]
    good = {f"{gk}/kv": torch.ones(pool.shape[:2] + (2,) + pool.shape[4:],
                                   device=cuda_device)}
    eng.backend.import_kv_pages("r", good, slots)
    assert torch.equal(eng.backend.export_kv_pages("r", slots)[f"{gk}/kv"],
                       good[f"{gk}/kv"])
    with pytest.raises(ValueError, match="shape"):
        eng.backend.import_kv_pages("r", {f"{gk}/kv": good[f"{gk}/kv"][0]},
                                    slots)
    with pytest.raises(ValueError, match="payload holds"):
        eng.backend.import_kv_pages("r", {"b9_attn_mlp/kv": good[
            f"{gk}/kv"]}, slots)
    with pytest.raises(ValueError, match="outside"):
        eng.backend.import_kv_pages("r", good, [(DIMS.pages, 0), (0, 0)])
