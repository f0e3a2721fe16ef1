"""This slice's archs on the card: the paged-attention kernel at the new
head geometries and the MoE kernel at kimi-k2's widths against their plain
versions, and CUDA-graph replay of whisper-small (encoder-decoder) and
minicpm3-4b (MLA) buckets against eager.  Every test carries the ``gpu``
marker; whether a card is present is decided in a fixture at run time, so
they skip without one.  This file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_archs_gpu.py

  * attention: qwen2-vl-7b's 28:4 heads of 128 (G = 7) and internlm2-1.8b's
    16:8 (G = 2), decode and a 64-row prefill chunk, f32 and bf16, dead
    pages NaN-poisoned and one ctx = 0 row, within the kernel module's
    TOLERANCE, zeros on the ctx = 0 row;
  * MoE: kimi-k2's d = 7168 and ff = 2048 at 16 of its 384 experts, C = 16,
    bf16, all rows live and as a decode tick with most experts empty (the
    rows past `counts` NaN, which must come out as exact zeros), within
    moe_gemm.TOLERANCE;
  * graphs: whisper-small cut to one ENC_LAYER and one DEC_LAYER (64
    encoder frames) and minicpm3-4b cut to 2 layers, f32, at every bucket
    of a 12-bucket ladder: graph replay and eager from the same weights,
    the same synthetic tick and encoder input, logits within 1e-4, greedy
    tokens equal away from near-ties.
"""

import dataclasses

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
from repro_torch.core import ThrottleConfig
from repro_torch.kernels import moe_gemm as mg
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import serve as serve_lib
from repro_torch.models.serve import ServeDims
from repro_torch.models.transformer import init_params
from repro_torch.runtime.engine import PipelineEngine

NEAR_TIE = 1e-3


@pytest.fixture
def cuda_device():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    return torch.device("cuda")


# --------------------------------------------------------------- attention

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("TQ", [1, 64], ids=["decode", "prefill"])
@pytest.mark.parametrize("H,KH", [(28, 4), (16, 8)], ids=["G7", "G2"])
def test_attention_at_new_head_geometries(cuda_device, H, KH, TQ, dtype):
    S, D, page, B = (8, 128, 16, 16) if TQ == 1 else (2, 128, 16, 16)
    g = torch.Generator(device=cuda_device).manual_seed(H * TQ + KH)
    q = torch.randn(S, TQ, H, D, generator=g, device=cuda_device).to(dtype)
    kv = torch.randn(S * B, page, 2, KH, D, generator=g,
                     device=cuda_device).to(dtype)
    tables = torch.randperm(S * B, generator=g, device=cuda_device)
    tables = tables.view(S, B).to(torch.int32).contiguous()
    rng = np.random.default_rng(H + TQ)
    ctx = [int(c) for c in rng.integers(TQ, B * page + 1, S)]
    ctx[-1] = 0
    ctx = torch.tensor(ctx, dtype=torch.int32, device=cuda_device)
    qpos = (torch.clamp(ctx, min=TQ)[:, None] - TQ
            + torch.arange(TQ, device=cuda_device)[None, :]).to(torch.int32)
    live = (ctx + page - 1) // page
    dead = torch.arange(B, device=cuda_device)[None, :] >= live[:, None]
    clean = kv.clone()
    kv[tables[dead].long()] = float("nan")
    out = pa.paged_flash_attention(q, kv, tables, ctx, qpos.contiguous())
    excess, _ = pa.excess(out, q, clean, tables, ctx, qpos)
    assert excess <= 1.0
    assert torch.isfinite(out).all()
    assert torch.all(out[ctx == 0] == 0)


# --------------------------------------------------------------------- MoE

@pytest.mark.gpu
@pytest.mark.parametrize("decode_tick", [False, True],
                         ids=["serve", "decode_tick"])
def test_moe_at_kimi_widths(cuda_device, decode_tick):
    E, C, d, ff = 16, 16, 7168, 2048
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn(E, C, d, generator=g, device=cuda_device).to(
        torch.bfloat16)
    ws = [(torch.randn(*s, generator=g, device=cuda_device) * 0.02).to(
        torch.bfloat16) for s in ((E, d, ff), (E, d, ff), (E, ff, d))]
    counts = None
    if decode_tick:
        rng = np.random.default_rng(5)
        c = np.zeros(E, np.int32)
        c[rng.choice(E, 5, replace=False)] = rng.integers(1, C + 1, 5)
        counts = torch.from_numpy(c).to(cuda_device)
        dead = torch.arange(C, device=cuda_device)[None, :] >= \
            counts[:, None].long()
        x[dead] = float("nan")
    out = mg.fused_moe_ffn(x, *ws, counts)
    args = [x] + ws + ([counts] if counts is not None else [])
    excess, _ = mg.excess(out, *args)
    assert excess <= 1.0
    if counts is not None:
        live = torch.arange(C, device=cuda_device)[None, :] < counts[:, None]
        assert torch.all(out[~live] == 0)
        assert torch.isfinite(out[live]).all()


# ------------------------------------------------------------------ graphs

DIMS = ServeDims(Sp=1, C=32, Sd=8, pages=64, page=16, Bp=8, Bd=8, slots=16)


def _cfg(arch):
    cfg = single_stage(get_config(arch))
    if cfg.is_encoder_decoder:
        cfg = cut_to_kinds(cfg, [BlockKind.ENC_LAYER, BlockKind.DEC_LAYER])
    else:
        cfg = dataclasses.replace(
            cfg, num_layers=2, pattern=(BlockSpec(cfg.pattern[0].kind, 2),))
    return dataclasses.replace(cfg, dtype="float32")


def _synthetic_fields(backend, bucket, rng, vocab):
    """A tick that fills `bucket`: one prefill chunk of C tokens at position
    0 on slot 0, and Sd live decode rows, each on its own page and slot."""
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
@pytest.mark.parametrize("arch", ["whisper-small", "minicpm3-4b"])
def test_graph_replay_equals_eager_at_every_bucket(cuda_device, arch):
    cfg = _cfg(arch)
    dims = dataclasses.replace(DIMS, Te=64 if cfg.is_encoder_decoder else 0)
    params = init_params(cfg, 0, dtype=torch.float32, device=cuda_device)
    engines = [PipelineEngine(cfg, dims, params,
                              ThrottleConfig(pipeline_depth=1), device="cuda",
                              dtype=torch.float32, bucketed=True,
                              cuda_graphs=graphs) for graphs in (True, False)]
    graph, eager = engines
    assert graph.backend.graph_count() == len(graph.backend.ladder) == 12
    rng = np.random.default_rng(3)
    enc = None
    if dims.Te:
        enc = torch.randn(dims.Sp, dims.Te, cfg.d_model, device=cuda_device,
                          generator=torch.Generator(
                              device=cuda_device).manual_seed(1)) * 0.05
    with torch.inference_mode():
        for bucket in graph.backend.ladder:
            fields = _synthetic_fields(graph.backend, bucket, rng,
                                       cfg.vocab_size)
            out = []
            for eng in engines:
                if enc is not None:
                    eng.backend._enc.copy_(enc)
                prog = eng.backend._program(bucket)
                eng.backend._load(prog, fields)
                logits, tokens = eng.backend._run(prog)
                out.append((logits.clone(), tokens.clone()))
            (lg, tg), (le, te) = out
            torch.testing.assert_close(lg, le, rtol=1e-4, atol=1e-4)
            top2 = torch.topk(le, 2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > NEAR_TIE
            assert torch.equal(tg[clear], te[clear]), bucket
    for grp, leaves in graph.backend.caches.items():
        for leaf, t in leaves.items():
            torch.testing.assert_close(t, eager.backend.caches[grp][leaf],
                                       rtol=1e-4, atol=1e-4)
