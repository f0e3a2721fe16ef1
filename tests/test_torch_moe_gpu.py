"""The port's Hopper fused-MoE kernel against its plain PyTorch version, on
the card.  Every test carries the ``gpu`` marker; whether a card is present
is decided in a fixture at run time, so they skip without one.  This file
imports no JAX, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_moe_gpu.py

Tolerance: the kernel module's ``TOLERANCE`` (f32: summation order, from the
plain version on absolute values; bf16 adds one output ulp and twice the
bound of the hidden's rounding to bf16).  The shapes are chip_smoke.py's
(olmoe-1b-7b's serve shapes, a ragged C=24, a small one) plus ones that
cross the kernel's tile edges: 128-row tiles in bf16 and 64-row tiles in
f32, 64/128-column tiles, the smallest d and ff it takes, and one expert.
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
    (3, 63, 256, 384),         # f32 row tile - 1
    (3, 65, 384, 256),         # f32 row tile + 1
    (2, 128, 256, 256),        # one full bf16 row tile
    (2, 129, 256, 128),        # bf16 row tile + 1
    (2, 300, 512, 640),        # several row tiles of both
]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _case(E, C, d, ff, seed, device, dtype):
    """Unit-variance rows and the serve path's weight scale (0.02); the
    last row of every expert is an empty capacity slot (zeros)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(E, C, d)).astype(np.float32)
    if C > 1:
        x[:, -1] = 0.0
    ws = [rng.normal(size=s).astype(np.float32) * 0.02
          for s in ((E, d, ff), (E, d, ff), (E, ff, d))]
    return [torch.from_numpy(a).to(device, dtype) for a in [x] + ws]


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
