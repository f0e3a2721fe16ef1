"""Tick traces of the port's engine on the card.  Every test carries the
``gpu`` marker and skips without a card; this file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_trace_gpu.py

A reduced f32 engine (qwen1.5-0.5b at published width, cut to 4 layers, at
small serve dims), bucketed and replaying one CUDA graph per bucket, sync,
records a trace: strict replay reproduces its tokens with no divergence,
`check_trace` round-trips the file byte for byte, and the traced engine's
tokens equal an untraced twin's from the same weights while the kernel
launches as often (counted per replay).  A trace with async dispatch
raises.
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import BlockSpec, get_config, single_stage
from repro_torch.core import SamplingParams, ThrottleConfig
from repro_torch.kernels import paged_attention
from repro_torch.models.serve import ServeDims
from repro_torch.models.transformer import init_params
from repro_torch.runtime.engine import PipelineEngine
from repro_torch.runtime.trace import Trace, check_trace, replay_trace

DIMS = ServeDims(Sp=1, C=32, Sd=8, pages=64, page=16, Bp=8, Bd=8, slots=16)
LAYERS = 4


@pytest.fixture
def cuda_device():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    return torch.device("cuda")


def _engine(dev, params=None, **kw):
    cfg = single_stage(get_config("qwen1.5-0.5b"))
    cfg = dataclasses.replace(
        cfg, num_layers=LAYERS, dtype="float32",
        pattern=(BlockSpec(cfg.pattern[0].kind, LAYERS),))
    if params is None:
        params = init_params(cfg, 0, dtype=torch.float32, device=dev)
    return PipelineEngine(cfg, DIMS, params, ThrottleConfig(pipeline_depth=1),
                          device=dev, dtype=torch.float32, **kw)


def _serve(eng):
    g = torch.Generator().manual_seed(3)
    reqs = [eng.add_request(
        torch.randint(0, eng.cfg.vocab_size, (n,), generator=g).tolist(),
        SamplingParams(max_new_tokens=6), request_id=f"r{i}")
        for i, n in enumerate((5, 40, 17, 70))]
    eng.drain()
    torch.cuda.synchronize()
    return {r.request_id: list(r.output_token_ids) for r in reqs}


@pytest.mark.gpu
def test_traced_graph_engine_replays_strictly(cuda_device, tmp_path):
    path = str(tmp_path / "card.trace.jsonl")
    traced = _engine(cuda_device, bucketed=True, trace_path=path)
    assert traced.backend.graphs and traced.backend.graph_count() > 0
    graphs = traced.backend.graph_count()
    paged_attention.launches = 0
    got = _serve(traced)
    traced_launches = paged_attention.launches
    traced.recorder.close()
    assert traced.backend.graph_count() == graphs
    assert traced_launches > 0

    trace = Trace.load(path)
    assert len(trace.requests) == 4
    assert all(r["host_s"] > 0 for r in trace.ticks)
    assert replay_trace(trace).outputs() == got
    assert check_trace(path).ticks == len(trace.ticks)

    plain = _engine(cuda_device, params=traced.params, bucketed=True)
    paged_attention.launches = 0
    assert _serve(plain) == got
    assert paged_attention.launches == traced_launches
    assert plain.stats.ticks == traced.stats.ticks


@pytest.mark.gpu
def test_trace_with_async_dispatch_raises(cuda_device, tmp_path):
    with pytest.raises(ValueError, match="async_dispatch"):
        _engine(cuda_device, bucketed=True, async_dispatch=True,
                trace_path=str(tmp_path / "t.jsonl"))
