"""The port's Hopper paged-attention kernel against its plain PyTorch
version, on the card.  Every test carries the ``gpu`` marker; whether a card
is present is decided in a fixture at run time, so they skip without one.
This file imports no JAX, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernel_gpu.py

Tolerance: the kernel module's ``TOLERANCE`` (f32 2e-5; bf16 one output
ulp, 2**-7 * |want|, plus twice the bound of P's rounding to bf16,
2**-8 * sum p|v| / l).  Dead pages are
NaN-poisoned and, where there are several sequences, the last has
ctx == 0, whose rows the kernel writes as exact zeros.  The kernel picks its
path from the TQ * H/KH rows of one (sequence, KV head): decode up to 16
rows (held in registers as 1, 8 or 16), else the f32 or the bf16 (wgmma)
prefill in 64-row tiles; the shapes cross each boundary (1, 8, 9, 16 and
17 rows, 64-row tiles) so every path is held to the plain version.  The last shapes leave the card short of row
tiles, so the kernel splits each row's pages across blocks and merges the
splits' partials; their contexts spread over the whole table.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa

SHAPES = [
    (2, 1, 4, 2, 64, 8, 4),        # decode, GQA
    (1, 16, 4, 4, 128, 8, 4),      # prefill chunk, MHA
    (3, 8, 8, 2, 64, 16, 8),       # prefill, deep tables
    (2, 1, 8, 8, 128, 8, 8),       # decode, MHA, D=128
    (2, 4, 40, 8, 128, 16, 4),     # qwen2.5-14b heads, 40:8 (G=5)
    (3, 1, 16, 16, 64, 16, 128),   # qwen1.5-0.5b decode, deep tables
    (2, 37, 16, 16, 64, 16, 8),    # ragged prefill tile
    (2, 40, 8, 8, 128, 8, 16),     # prefill, page 8, D=128
    (1, 100, 10, 2, 64, 8, 32),    # prefill, page 8, G=5 rows across tiles
    (2, 1, 8, 1, 64, 16, 8),       # 8 rows: one warp group, pages split 4 ways
    (2, 3, 12, 4, 64, 16, 8),      # 9 rows: two row groups, pages split 2 ways
    (2, 4, 16, 4, 128, 16, 8),     # 16 rows: the last split-page tile
    (2, 17, 4, 4, 64, 16, 8),      # 17 rows: one row group per warp
    (1, 65, 8, 8, 64, 16, 8),      # 65 rows: a 64-row tensor-core tile + 1
    # shapes whose rows do not fill the card: the KV pages of a row are
    # split across blocks and the splits' partials merged
    (128, 1, 16, 16, 64, 16, 128),  # decode, contexts from 1 to 2,048
    (64, 1, 64, 8, 128, 16, 128),   # decode at jamba's heads, 64:8 (G=8)
    (32, 1, 40, 8, 128, 8, 256),    # decode at qwen2.5-14b's heads, page 8
    (1, 512, 16, 16, 64, 16, 128),  # a qwen1.5-0.5b prefill chunk
    (1, 256, 64, 8, 128, 16, 64),   # prefill at 64:8, D=128
    (1, 300, 8, 8, 128, 8, 256),    # prefill, page 8, deep tables
    (2, 96, 40, 8, 128, 16, 32),    # prefill at 40:8, ragged row tiles
]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _case(S, TQ, H, KH, D, page, B, seed, device):
    rng = np.random.default_rng(seed)
    P = S * B + 2
    q = rng.normal(size=(S, TQ, H, D)).astype(np.float32)
    kv = rng.normal(size=(P, page, 2, KH, D)).astype(np.float32)
    tables = rng.permutation(P)[: S * B].reshape(S, B).astype(np.int32)
    ctx = rng.integers(TQ, B * page + 1, S).astype(np.int32)
    if S > 1:
        ctx[-1] = 0
    qpos = (np.maximum(ctx, TQ)[:, None] - TQ
            + np.arange(TQ)[None, :]).astype(np.int32)
    return [torch.from_numpy(a).to(device) for a in (q, kv, tables, ctx, qpos)]


@pytest.fixture
def cuda_device():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_on_card(cuda_device, shape, dtype):
    tdtype = DTYPES[dtype]
    q, kv, tables, ctx, qpos = _case(*shape, seed=sum(shape),
                                     device=cuda_device)
    q, kv = q.to(tdtype), kv.to(tdtype)
    live = -(-ctx.cpu().numpy() // shape[5])
    for s in range(shape[0]):               # poison every dead page
        kv[tables[s, live[s]:].long()] = float("nan")
    out = pa.paged_flash_attention(q, kv, tables, ctx, qpos)
    excess, err = pa.excess(out, q, kv.nan_to_num(0.0), tables, ctx, qpos)
    assert excess <= 1.0, f"max abs err {err}"
    assert torch.all(out[ctx == 0] == 0)


@pytest.mark.gpu
def test_ops_sends_cuda_tensors_to_the_kernel(cuda_device):
    q, kv, tables, ctx, qpos = _case(2, 1, 4, 2, 64, 8, 4, seed=1,
                                     device=cuda_device)
    pa.launches = 0
    ops.paged_attention(q, kv, tables, ctx, qpos)
    assert pa.launches == 1
    with pytest.raises(ValueError):                 # no silent fallback
        ops.paged_attention(q.double(), kv.double(), tables, ctx, qpos)
    assert pa.launches == 1


# the log-sum-exp output: |lse - plain lse| on rows that attend a key
LSE_TOL = 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_lse_matches_plain_on_card(cuda_device, shape, dtype):
    """`with_lse` at every path and split: the output as without it, each
    row's log-sum-exp the plain version's (-1e30 for a row with no key),
    whether the launch splits the pages or not (one split writes partials
    for the combine too)."""
    tdtype = DTYPES[dtype]
    q, kv, tables, ctx, qpos = _case(*shape, seed=sum(shape) + 1,
                                     device=cuda_device)
    q, kv = q.to(tdtype), kv.to(tdtype)
    out, lse = ops.paged_attention(q, kv, tables, ctx, qpos, with_lse=True)
    excess, err = pa.excess(out, q, kv, tables, ctx, qpos)
    assert excess <= 1.0, f"max abs err {err}"
    _, want = pa.paged_flash_attention_ref(q, kv, tables, ctx, qpos,
                                           with_lse=True)
    keys = torch.minimum(ctx[:, None], qpos + 1) > 0
    assert float((lse[keys] - want[keys]).abs().max()) <= LSE_TOL
    assert torch.all(lse[~keys] == pa.NEG_INF)
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:-1]
