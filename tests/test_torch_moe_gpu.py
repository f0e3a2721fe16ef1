"""The port's Hopper fused-MoE kernel against its plain PyTorch version, on
the card.  Every test carries the ``gpu`` marker; whether a card is present
is decided in a fixture at run time, so they skip without one.  This file
imports no JAX, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_moe_gpu.py

Tolerance: the kernel module's ``TOLERANCE`` (f32: summation order, from the
plain version on absolute values; bf16 adds one output ulp and twice the
bound of the hidden's rounding to bf16).  The shapes are chip_smoke.py's
(olmoe-1b-7b's serve shapes, a ragged C=24, a small one) plus ones that
cross the kernel's tiles: token tiles of 96 rows (bf16) and 64 (f32) and
their edges, products 16 to 96 tokens wide, C not a multiple of 8, column
tiles of 128 ff / 256 d columns (bf16, in clusters of two, so an odd count
leaves a block of a cluster without columns) and 64 ff / 128 d (f32), the
smallest d and ff it takes, one expert, and kimi-k2's widths (d=7168,
ff=2048) at small E.  The `counts` cases hold rows past each expert's count
at NaN, which must come out as exact zeros.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import moe_gemm, ops

SHAPES = [
    (64, 88, 2048, 1024),      # olmoe-1b-7b serve shapes (FULL_DIMS)
    (8, 24, 2048, 1024),       # ragged C
    (2, 16, 128, 128),         # small
    (1, 1, 128, 128),          # one row, one expert
    (3, 63, 256, 384),         # f32 token tile - 1; 3 gate/up column tiles
    (3, 65, 384, 256),         # f32 token tile + 1; d = 1.5 down tiles
    (2, 95, 384, 640),         # bf16 token tile - 1; 5 gate/up column tiles
    (2, 96, 256, 256),         # one full bf16 token tile
    (2, 97, 256, 128),         # bf16 token tile + 1
    (2, 129, 256, 128),        # two f32 tiles + 1, a bf16 tile + 33
    (3, 13, 256, 256),         # C not a multiple of 8
    (2, 300, 512, 640),        # several token tiles of both
    (2, 88, 7168, 2048),       # kimi-k2-1t-a32b's widths
]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _case(E, C, d, ff, seed, device, dtype, counts=None):
    """Unit-variance rows and the serve path's weight scale (0.02); the
    last row of every expert is an empty capacity slot (zeros).  With
    `counts`, the rows past each expert's count are NaN instead, and the
    counts tensor (int32, on the device) is appended."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(E, C, d)).astype(np.float32)
    if counts is not None:
        x[np.arange(C)[None, :] >= np.asarray(counts)[:, None]] = np.nan
    elif C > 1:
        x[:, -1] = 0.0
    ws = [rng.normal(size=s).astype(np.float32) * 0.02
          for s in ((E, d, ff), (E, d, ff), (E, ff, d))]
    out = [torch.from_numpy(a).to(device, dtype) for a in [x] + ws]
    if counts is not None:
        out.append(torch.tensor(counts, dtype=torch.int32, device=device))
    return out


@pytest.fixture
def cuda_device():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_on_card(cuda_device, shape, dtype):
    args = _case(*shape, seed=sum(shape), device=cuda_device,
                 dtype=DTYPES[dtype])
    out = moe_gemm.fused_moe_ffn(*args)
    torch.cuda.synchronize()
    excess, err = moe_gemm.excess(out, *args)
    assert excess <= 1.0, f"max abs err {err}"
    if shape[1] > 1:
        assert torch.all(out[:, -1] == 0)          # empty slots stay zero


# (E, C, d, ff, counts): empty, partial and full experts; a token tile
# edge; C=1096 (the f32 serve's dropless capacity at olmoe) with 17 live
# rows; decode ticks with a few live rows per expert
COUNT_CASES = [
    (4, 88, 256, 384, [0, 5, 88, 40]),
    (3, 200, 256, 256, [96, 97, 0]),
    (3, 1096, 256, 256, [17, 0, 17]),
    (6, 88, 512, 1024, [4, 3, 0, 6, 1, 4]),
    (2, 64, 128, 128, [0, 0]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", COUNT_CASES,
                         ids=lambda c: "x".join(map(str, c[:4])) + "-"
                         + ".".join(map(str, c[4])))
def test_kernel_counts_skip_rows_on_card(cuda_device, case, dtype):
    """Rows past counts[e] hold NaN and come out as exact zeros; the rows
    below agree with the plain version (which masks the same rows)."""
    *shape, counts = case
    args = _case(*shape, seed=sum(shape), device=cuda_device,
                 dtype=DTYPES[dtype], counts=counts)
    out = moe_gemm.fused_moe_ffn(*args)
    torch.cuda.synchronize()
    rows = torch.arange(shape[1], device=cuda_device)
    live = rows[None, :] < args[4][:, None]
    assert torch.all(out[~live] == 0)
    excess, err = moe_gemm.excess(out, *args)
    assert excess <= 1.0, f"max abs err {err}"
    want = moe_gemm.fused_moe_ffn_ref(*args)
    assert torch.isfinite(want.float()).all()


@pytest.mark.gpu
def test_ops_sends_cuda_tensors_to_the_kernel(cuda_device):
    args = _case(2, 24, 128, 128, seed=1, device=cuda_device,
                 dtype=torch.bfloat16)
    moe_gemm.launches = 0
    ops.fused_moe_ffn(*args)
    assert moe_gemm.launches == 1
    with pytest.raises(ValueError):                 # no silent fallback
        ops.fused_moe_ffn(*(a.double() for a in args))
    with pytest.raises(ValueError):                 # d not a whole tile
        ops.fused_moe_ffn(*_case(2, 24, 96, 128, seed=1, device=cuda_device,
                                 dtype=torch.bfloat16))
    x, wg, wu, wd = args
    with pytest.raises(ValueError):                 # not contiguous
        ops.fused_moe_ffn(x, wg.transpose(1, 2).contiguous().transpose(1, 2),
                          wu, wd)
    with pytest.raises(ValueError):                 # counts not int32 [E]
        ops.fused_moe_ffn(x, wg, wu, wd,
                          torch.ones(2, dtype=torch.int64, device=x.device))
    assert moe_gemm.launches == 1


@pytest.mark.gpu
def test_moe_apply_makes_no_host_sync(cuda_device):
    """The MoE layer of the serve tick reads nothing back to the host: no
    ``.item()``, ``nonzero`` or boolean-mask indexing (checked with
    torch.cuda.set_sync_debug_mode, which raises on a synchronising call),
    and it goes through the kernel once."""
    from repro_torch.models import moe

    rng = np.random.default_rng(2)
    T, d, E, ff, k = 544, 256, 8, 128, 2
    x = torch.from_numpy(rng.normal(size=(T, d)).astype(np.float32))
    params = {"router": rng.normal(size=(d, E)) * 0.5,
              "w_gate": rng.normal(size=(E, d, ff)) * 0.02,
              "w_up": rng.normal(size=(E, d, ff)) * 0.02,
              "w_down": rng.normal(size=(E, ff, d)) * 0.02}
    params = {n: torch.from_numpy(a.astype(np.float32)).to(
        cuda_device, torch.bfloat16) for n, a in params.items()}
    x = x.to(cuda_device, torch.bfloat16)
    valid = torch.arange(T, device=cuda_device) % 5 != 0
    moe.moe_apply(x, params, top_k=k, row_valid=valid)     # build first
    torch.cuda.synchronize()
    moe_gemm.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, _ = moe.moe_apply(x, params, top_k=k, row_valid=valid)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert moe_gemm.launches == 1
    assert torch.isfinite(out.float()).all()
    assert not out[~valid].any()
