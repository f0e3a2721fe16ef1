"""The port's Hopper WKV6 kernel against its plain PyTorch version, on the
card.  Every test carries the ``gpu`` marker; whether a card is present is
decided in a fixture at run time, so they skip without one.  This file
imports no JAX, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_rwkv_gpu.py

Tolerance: the kernel module's ``TOLERANCE`` (both versions compute in f32
from the same inputs and differ only in rounding order; the bound scales
the plain version run on absolute values).  The inputs carry a
data-dependent decay (log w = -exp(U(-6, 3)), so w spans ~0 to ~1), NaN
poison in the pool slots of fresh rows and in slots no live row owns, and
padding rows (lens == 0) on slot 0, which a live row may own: the kernel
must read no poison and leave every slot it does not own bit-identical.
The shapes are rwkv6-3b's serve shapes (32 decode rows over a pool of 64
slots; one 512-token prefill chunk with 300 live tokens) and ragged ones
that cross the recurrent form's 32-token runs; for the chunked form (every
T > 1, chunks of 16 tokens) one chunk less a token, exactly and plus a
token, and several prefill rows with ragged lengths (0 among them).  The
"strong decay" cases draw log w = -exp(U(-20, 10)), the serve path's whole
clamp: w holds exact 0, exact 1 and subnormals.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6_scan as wkv

D = 64
SERVE = (-6, 3)           # log w = -exp(U(lo, hi)): w from ~2e-9 to ~0.998
STRONG = (-20, 10)        # the serve clamp's whole range
# name: (S, T, H, lens, fresh, slots in the pool, decay range)
CASES = {
    "decode": (32, 1, 40, [1] * 28 + [0] * 4, [0] * 32, 64, SERVE),
    "prefill": (1, 512, 40, [300], [0], 64, SERVE),
    "prefill fresh": (1, 512, 40, [512], [1], 64, SERVE),
    "ragged": (4, 70, 3, [70, 33, 0, 32], [1, 0, 0, 0], 6, SERVE),
    "one token": (1, 1, 1, [1], [0], 1, SERVE),
    "chunk - 1": (1, 15, 4, [15], [0], 2, SERVE),
    "chunk": (1, 16, 4, [16], [0], 2, SERVE),
    "chunk + 1": (1, 17, 4, [17], [0], 2, SERVE),
    "prefill rows": (3, 40, 5, [40, 0, 23], [0, 0, 1], 5, SERVE),
    "strong decay prefill": (1, 512, 40, [300], [0], 64, STRONG),
    "strong decay rows": (3, 40, 5, [33, 0, 40], [1, 0, 0], 5, STRONG),
    "strong decay decode": (32, 1, 40, [1] * 28 + [0] * 4, [0] * 32, 64,
                            STRONG),
}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _case(S, T, H, lens, fresh, n, decay, dtype, seed, device):
    """Unit-normal r, k, v (in `dtype`), u uniform in [0, 1), decay
    exp(-exp(U(*decay))); live rows on distinct random slots, padding rows
    on slot 0; the pool is NaN except the non-fresh live rows' slots."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    r, k, v = (normal(S, T, H, D).to(dtype) for _ in range(3))
    w = torch.from_numpy(np.exp(-np.exp(
        rng.uniform(*decay, (S, T, H, D)))).astype(np.float32))
    u = torch.from_numpy(rng.uniform(0, 1, (H, D)).astype(np.float32))
    state = torch.full((n, H, D, D), float("nan"))
    slots = rng.permutation(n)[:S].astype(np.int32)
    for s in range(S):
        if lens[s] == 0:
            slots[s] = 0
        elif not fresh[s]:
            state[slots[s]] = normal(H, D, D) * 3
    ints = [torch.tensor(a, dtype=torch.int32) for a in (slots, lens, fresh)]
    return [t.to(device) for t in (r, k, v, w, u, state, *ints)]


@pytest.fixture
def cuda_device():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_plain_on_card(cuda_device, name, dtype):
    args = _case(*CASES[name], DTYPES[dtype], seed=len(name),
                 device=cuda_device)
    r, k, v, w, u, state, slots, lens, fresh = args
    before = state.clone()
    wkv.launches = 0
    out = wkv.rwkv6_chunked_scan(*args)
    torch.cuda.synchronize()
    assert wkv.launches == 1
    excess, err = wkv.excess(out, state, r, k, v, w, u, before, slots, lens,
                             fresh)
    assert excess <= 1.0, f"max abs err {err}"
    assert torch.isfinite(out).all()
    for s, n in enumerate(lens.tolist()):
        assert not out[s, n:].any()              # zeros past the live tokens


def _unaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of `x` whose storage starts one element past a
    16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_takes_unaligned_inputs(cuda_device, dtype):
    """r, k, v, w that are contiguous but not 16-byte aligned go through the
    chunked form (its scalar loads) and agree with the plain version."""
    args = _case(*CASES["prefill rows"], DTYPES[dtype], seed=5,
                 device=cuda_device)
    r, k, v, w, u, state, slots, lens, fresh = args
    r, k, v, w = (_unaligned(x) for x in (r, k, v, w))
    assert all(x.data_ptr() % 16 for x in (r, k, v, w))
    before = state.clone()
    out = wkv.rwkv6_chunked_scan(r, k, v, w, u, state, slots, lens, fresh)
    torch.cuda.synchronize()
    excess, err = wkv.excess(out, state, r, k, v, w, u, before, slots, lens,
                             fresh)
    assert excess <= 1.0, f"max abs err {err}"


@pytest.mark.gpu
def test_ops_sends_cuda_tensors_to_the_kernel(cuda_device, monkeypatch):
    """A CUDA tensor reaches the kernel or an exception, never the plain
    version."""
    args = _case(*CASES["ragged"], torch.bfloat16, seed=1,
                 device=cuda_device)

    def refuse(*a, **kw):
        raise AssertionError("plain version called with CUDA tensors")

    monkeypatch.setattr(wkv, "rwkv6_scan_ref", refuse)
    wkv.launches = 0
    ops.rwkv6_scan(*args)
    assert wkv.launches == 1
    r, k, v, w, u, state, slots, lens, fresh = args
    with pytest.raises(ValueError):              # no silent fallback
        ops.rwkv6_scan(r.double(), k.double(), v.double(), w, u, state,
                       slots, lens, fresh)
    with pytest.raises(ValueError):              # head size the kernel lacks
        ops.rwkv6_scan(r[..., :32].contiguous(), k[..., :32].contiguous(),
                       v[..., :32].contiguous(), w[..., :32].contiguous(),
                       u[:, :32].contiguous(),
                       state[:, :, :32, :32].contiguous(), slots, lens,
                       fresh)
    with pytest.raises(ValueError):              # int64 lengths
        ops.rwkv6_scan(r, k, v, w, u, state, slots, lens.long(), fresh)
    torch.cuda.synchronize()
    assert wkv.launches == 1


@pytest.mark.gpu
def test_time_mix_goes_through_the_kernel_once(cuda_device):
    """One RWKV time-mix on the card launches the kernel once and advances
    the pool only at its rows' slots."""
    from repro_torch.models import ssm

    rng = np.random.default_rng(3)
    B, T, d, H = 2, 9, 128, 2
    p = {name: torch.from_numpy(
        (rng.normal(size=shape) * 0.1).astype(np.float32)).to(cuda_device)
        for name, shape in [
            ("mu_r", (d,)), ("mu_k", (d,)), ("mu_v", (d,)), ("mu_g", (d,)),
            ("mu_w", (d,)), ("w_r", (d, d)), ("w_k", (d, d)),
            ("w_v", (d, d)), ("w_g", (d, d)), ("w_o", (d, d)),
            ("w0", (d,)), ("w_lora_a", (d, 64)), ("w_lora_b", (64, d)),
            ("u", (d,)), ("ln_x_g", (d,))]}
    x = torch.from_numpy(rng.normal(size=(B, T, d)).astype(np.float32)).to(
        cuda_device)
    pool = torch.full((4, H, D, D), float("nan"), device=cuda_device)
    pool[3] = 0.5
    state = ssm.RWKVState(
        tm_x=torch.zeros(B, d, device=cuda_device),
        cm_x=torch.zeros(B, d, device=cuda_device), wkv=pool,
        slots=torch.tensor([3, 1], dtype=torch.int32, device=cuda_device),
        fresh=torch.tensor([0, 1], dtype=torch.int32, device=cuda_device))
    lens = torch.tensor([T, 4], dtype=torch.int32, device=cuda_device)
    wkv.launches = 0
    out, _, _ = ssm.rwkv_time_mix(x, p, head_dim=D, state=state,
                                  chunk_lens=lens)
    torch.cuda.synchronize()
    assert wkv.launches == 1
    assert torch.isfinite(out[0]).all() and torch.isfinite(out[1, :4]).all()
    assert torch.isfinite(pool[[1, 3]]).all()
    assert torch.isnan(pool[[0, 2]]).all()
