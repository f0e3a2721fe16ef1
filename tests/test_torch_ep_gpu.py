"""Expert parallelism's pieces on the card: the fused-MoE kernel at the
shapes one expert-parallel rank sees, and the all-to-all of CUDA tensors
between ranks that share the card.  Every test carries the ``gpu`` marker
and skips without a card; this file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_ep_gpu.py

* The kernel against its plain version (the kernel module's ``TOLERANCE``)
  in bf16 at one rank of dp=2 x tp=2: kimi-k2-1t-a32b's 192 local experts
  (d=7168, ff=1,024 of 2,048) and jamba-1.5-large-398b's 8 (d=8192,
  ff=12,288 of 24,576), every expert full and as a decode tick with a few
  live rows per expert (rows past `counts` NaN, which come out zero).
* `collectives.exchange_rows` of a CUDA tensor at 2 ranks under gloo
  (staged through host memory): the chunks transposed, its backward the
  same exchange of the gradient, the result on the card, the staged bytes
  counted.
"""

import numpy as np
import pytest
import torch

from repro_torch.distributed import collectives as coll
from repro_torch.kernels import moe_gemm
from repro_torch.launch import ranks as rk
from repro_torch.launch.mesh import rank_layout

# (name, E_loc, C, d, ff a rank)
EP_SHAPES = [
    ("kimi dp=2 tp=2", 192, 16, 7168, 1024),
    ("jamba dp=2 tp=2", 8, 88, 8192, 12288),
]


@pytest.fixture
def cuda_device():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(E, C, d, ff, seed, device, live=None):
    """bf16 rows at unit variance, weights at the serve path's 0.02; with
    `live`, that many rows an expert (from the seed) and NaN past them."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randn((E, C, d), generator=gen, device=device)
    counts = None
    if live is not None:
        counts = torch.randint(0, live + 1, (E,), generator=gen,
                               device=device, dtype=torch.int32)
        rows = torch.arange(C, device=device)
        x[rows[None, :] >= counts[:, None]] = float("nan")
    ws = [torch.randn(s, generator=gen, device=device).mul_(0.02)
          for s in ((E, d, ff), (E, d, ff), (E, ff, d))]
    return [t.to(torch.bfloat16) for t in [x] + ws] + [counts]


@pytest.mark.gpu
@pytest.mark.parametrize("live", [None, 3], ids=["full", "decode"])
@pytest.mark.parametrize("shape", EP_SHAPES, ids=lambda s: s[0])
def test_kernel_matches_plain_at_an_ep_rank(cuda_device, shape, live):
    _, E, C, d, ff = shape
    args = _case(E, C, d, ff, seed=E + C, device=cuda_device, live=live)
    out = moe_gemm.fused_moe_ffn(*args)
    torch.cuda.synchronize()
    if live is not None:
        rows = torch.arange(C, device=cuda_device)
        assert torch.all(out[rows[None, :] >= args[4][:, None]] == 0)
    excess, err = moe_gemm.excess(out, *args)
    assert excess <= 1.0, f"max abs err {err}"


def _a2a_rank(ranks, job):
    dev = torch.device("cuda")
    r = ranks.index("data")
    coll.TRAFFIC.reset()
    x = torch.from_numpy(job["x"][r]).to(dev).requires_grad_(True)
    y = coll.exchange_rows(x, ranks["data"])
    (y * torch.from_numpy(job["w"][r]).to(dev)).sum().backward()
    return {"y": y.detach().cpu().numpy(), "gx": x.grad.cpu().numpy(),
            "on_card": y.is_cuda and x.grad.is_cuda,
            "staged": coll.TRAFFIC.staged}


@pytest.mark.gpu
def test_all_to_all_of_cuda_tensors_under_gloo(cuda_device, tmp_path):
    rng = np.random.default_rng(0)
    x, w = rng.normal(size=(2, 8, 5)), rng.normal(size=(2, 8, 5))
    out = rk.spawn(_a2a_rank, rank_layout(2, 1, 1), ({"x": x, "w": w},),
                   backend="gloo", store_dir=str(tmp_path / "store"),
                   threads=1, timeout_s=300, group_timeout_s=300)
    for r, o in enumerate(out):
        np.testing.assert_array_equal(
            o["y"], x.reshape(2, 2, 4, 5)[:, r].reshape(8, 5))
        np.testing.assert_array_equal(
            o["gx"], w.reshape(2, 2, 4, 5)[:, r].reshape(8, 5))
        assert o["on_card"]
        assert o["staged"] == 4 * x[r].nbytes    # out and back, twice
