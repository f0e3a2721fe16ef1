"""The port's CUDA-graph serving on the card: one graph per ladder bucket,
captured at `warm_start`, replayed every tick.  Every test carries the
``gpu`` marker; whether a card is present is decided in a fixture at run
time, so they skip without one.  This file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_graphs_gpu.py

The configurations are the published widths cut in depth (the kernels take
only published head and state sizes), f32, at small serve dims whose
ladder has 12 buckets:
  * every bucket: a graph engine and an eager one (`cuda_graphs=False`)
    from the same weights run the same synthetic tick at every bucket, in
    ladder order, on their own caches; greedy tokens are equal wherever the
    eager logits' top-2 gap exceeds 1e-3 (a near-tie may flip under another
    summation order), logits agree to 1e-4;
  * serving: the bucketed async graph engine and the eager sync unbucketed
    one serve one batch; both give the port's dense reference tokens up to
    its first near-tie; the graph count stays what `warm_start` captured,
    and each kernel's launches, counted per replay, are its layers times
    the ticks that ran its phase;
  * a capture that fails raises out of the engine's constructor.
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch

from repro_torch.configs import (
    BlockKind,
    BlockSpec,
    cut_to_kinds,
    get_config,
    single_stage,
)
from repro_torch.core import SamplingParams, ThrottleConfig
from repro_torch.kernels import ops
from repro_torch.models import serve as serve_lib
from repro_torch.models.reference import greedy_trace
from repro_torch.models.serve import ServeDims
from repro_torch.models.transformer import init_params
from repro_torch.runtime.engine import PipelineEngine

DIMS = ServeDims(Sp=1, C=32, Sd=8, pages=64, page=16, Bp=8, Bd=8, slots=16)
NEAR_TIE = 1e-3
# name: (arch, layers of its first block kind, or block kinds to keep)
CONFIGS = {
    "qwen1.5-0.5b": ("qwen1.5-0.5b", 2),
    "olmoe-1b-7b": ("olmoe-1b-7b", 1),
    "rwkv6-3b": ("rwkv6-3b", 2),
    "jamba-mamba": ("jamba-1.5-large-398b", (BlockKind.MAMBA_MLP,)),
}


@pytest.fixture
def cuda_device():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    return torch.device("cuda")


def _cfg(name):
    arch, cut = CONFIGS[name]
    cfg = single_stage(get_config(arch))
    if isinstance(cut, tuple):
        cfg = cut_to_kinds(cfg, list(cut))
    else:
        cfg = dataclasses.replace(
            cfg, num_layers=cut, pattern=(BlockSpec(cfg.pattern[0].kind, cut),))
    return dataclasses.replace(
        cfg, dtype="float32",
        moe_capacity_factor=(float(cfg.num_experts) if cfg.is_moe
                             else cfg.moe_capacity_factor))


def _engine(cfg, params, **kw):
    return PipelineEngine(cfg, DIMS, params, ThrottleConfig(pipeline_depth=1),
                          device="cuda", dtype=torch.float32, **kw)


def _synthetic_fields(backend, bucket, rng, vocab):
    """A tick that fills `bucket`: one prefill chunk of C tokens at position
    0 on slot 0 (pages 0, 1, ...), and Sd live decode rows at positions
    3 + j, each on its own page and slot."""
    m = {k: v.copy() for k, v in backend._zm.items()}
    page = DIMS.page
    if bucket.Sp:
        L = bucket.C
        m["p_positions"][0, :L] = np.arange(L)
        m["p_chunk_lens"][0] = m["p_context_lens"][0] = L
        n = -(-L // page)
        m["p_block_tables"][0, :n] = np.arange(n)
        m["p_slot_pages"][0, :L] = np.arange(L) // page
        m["p_slot_offsets"][0, :L] = np.arange(L) % page
        m["p_sample"][0] = 1
    for j in range(bucket.Sd):
        pos = 3 + j
        m["d_positions"][j] = pos
        m["d_context_lens"][j] = pos + 1
        m["d_block_tables"][j, 0] = m["d_slot_pages"][j] = 10 + j
        m["d_slot_offsets"][j] = pos
        m["d_state_slots"][j] = 1 + j
        m["d_valid"][j] = 1
    meta = {k: v[0] for k, v in backend._stack_meta(((None, m),),
                                                    bucket).items()}
    extra = {"p_tok": rng.integers(0, vocab, (DIMS.Sp, DIMS.C)),
             "d_tok": rng.integers(0, vocab, (DIMS.Sd,))}
    return serve_lib.host_meta(meta, bucket, extra=extra)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CONFIGS))
def test_graph_replay_equals_eager_at_every_bucket(cuda_device, name):
    cfg = _cfg(name)
    params = init_params(cfg, 0, dtype=torch.float32, device=cuda_device)
    graph = _engine(cfg, params, bucketed=True)
    eager = _engine(cfg, params, bucketed=True, cuda_graphs=False)
    assert graph.backend.graph_count() == len(graph.backend.ladder) == 12
    assert eager.backend.graph_count() == 0
    rng = np.random.default_rng(3)
    with torch.inference_mode():
        for bucket in graph.backend.ladder:
            fields = _synthetic_fields(graph.backend, bucket, rng,
                                       cfg.vocab_size)
            out = []
            for eng in (graph, eager):
                prog = eng.backend._program(bucket)
                eng.backend._load(prog, fields)
                logits, tokens = eng.backend._run(prog)
                out.append((logits.clone(), tokens.clone()))
            (lg, tg), (le, te) = out
            torch.testing.assert_close(lg, le, rtol=1e-4, atol=1e-4)
            top2 = torch.topk(le, 2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > NEAR_TIE
            assert torch.equal(tg[clear], te[clear]), bucket
    for grp in graph.backend.caches:
        for leaf, t in graph.backend.caches[grp].items():
            torch.testing.assert_close(t, eager.backend.caches[grp][leaf],
                                       rtol=1e-4, atol=1e-4)
    assert graph.backend.graph_count() == 12
    del graph, eager, params
    gc.collect()
    torch.cuda.empty_cache()


def _launch_want(cfg, st):
    """Launches per kernel for stats `st`: a phase's kernels once per
    layer per tick that ran the phase, the MoE kernel once per MoE layer
    per tick."""
    kinds = [b.kind for b in cfg.pattern for _ in range(b.repeat)]
    phases = st.prefill_ticks + st.decode_ticks
    attn = sum(k in (BlockKind.ATTN_MLP, BlockKind.ATTN_MOE) for k in kinds)
    moe = sum(k in (BlockKind.ATTN_MOE, BlockKind.MAMBA_MOE) for k in kinds)
    mamba = sum(k in (BlockKind.MAMBA_MLP, BlockKind.MAMBA_MOE)
                for k in kinds)
    rwkv = sum(k == BlockKind.RWKV for k in kinds)
    return {ops.pa: attn * phases, ops.moe_gemm: moe * st.ticks,
            ops.s6: mamba * phases, ops.wkv: rwkv * phases}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CONFIGS))
def test_graph_serving_matches_reference_and_counts(cuda_device, name):
    cfg = _cfg(name)
    params = init_params(cfg, 0, dtype=torch.float32, device=cuda_device)
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in (5, 40, 17, 70, 9, 33)]
    outs = {}
    for mode, kw in (("eager", dict(cuda_graphs=False)),
                     ("graphs", dict(bucketed=True, async_dispatch=True))):
        eng = _engine(cfg, params, **kw)
        graphs = eng.backend.graph_count()
        for mod in ops.COUNTED:
            mod.launches = 0
        reqs = [eng.add_request(p, SamplingParams(max_new_tokens=6))
                for p in prompts]
        eng.drain(max_ticks=500)
        torch.cuda.synchronize()
        assert all(r.is_finished for r in reqs)
        got = {mod: mod.launches for mod in ops.COUNTED}
        assert got == _launch_want(cfg, eng.stats), mode
        assert eng.backend.graph_count() == graphs
        outs[mode] = [r.output_token_ids for r in reqs]
        del eng
    for i, p in enumerate(prompts):
        want, gaps = greedy_trace(cfg, params, p, 6)
        stop = next((k for k, g in enumerate(gaps) if g < NEAR_TIE), 6)
        for mode in outs:
            assert outs[mode][i][:stop] == want[:stop], (mode, i)
    del params
    gc.collect()
    torch.cuda.empty_cache()


@pytest.mark.gpu
def test_capture_failure_raises(cuda_device, monkeypatch):
    """A host sync inside the tick is legal eagerly and illegal in a
    capture: the engine's constructor raises, nothing runs eagerly in its
    place."""
    cfg = _cfg("qwen1.5-0.5b")
    params = init_params(cfg, 0, dtype=torch.float32, device=cuda_device)
    forward = serve_lib.stage_forward_serve

    def syncing(*args, **kw):
        xp, xd, caches = forward(*args, **kw)
        float(xd.sum())                 # a device-to-host read
        return xp, xd, caches

    monkeypatch.setattr(serve_lib, "stage_forward_serve", syncing)
    with pytest.raises(RuntimeError):
        _engine(cfg, params)
    monkeypatch.undo()
    torch.cuda.synchronize()
    eng = _engine(cfg, params)          # the card still captures
    assert eng.backend.graph_count() == 1
