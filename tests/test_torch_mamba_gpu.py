"""The port's Hopper Mamba selective-scan kernel against its plain PyTorch
version, on the card.  Every test carries the ``gpu`` marker; whether a
card is present is decided in a fixture at run time, so they skip without
one.  This file imports no JAX, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_mamba_gpu.py

Tolerance: the kernel module's ``TOLERANCE`` (both versions compute in f32
from the same inputs and differ only in rounding order and in their
exponentials, each within 2 ulp; the bound scales the plain version run on
absolute values).  The inputs carry step sizes dt from 1e-3 to 3 (decays
exp(dt A) from ~1 to ~1e-21), NaN poison in the pool slots of fresh rows and
in slots no live row owns, and padding rows (lens == 0) on slot 0, which a
live row may own: the kernel must read no poison and leave every slot it
does not own bit-identical.  The shapes are jamba's serve shapes (32 decode
rows over a pool of 64 slots; one 512-token prefill chunk with 300 live
tokens; di = 16384, ds = 16) and ragged ones that cross the recurrent
form's 32-token runs and channel blocks; for the segmented form (every
T > 1, runs of 32 tokens cut into 4 segments of 8) a segment and a run less
a token, exactly and plus a token, and several prefill rows with ragged
lengths (0 among them).  The "strong decay" cases draw dt log-uniform in
[1e-4, 100], so that exp(dt A) is exactly 0 for many channels.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import mamba_scan as s6
from repro_torch.kernels import ops

SERVE = (1e-3, 3.0)       # dt log-uniform: exp(dt A) from ~1 to ~1e-21
STRONG = (1e-4, 100.0)    # exp(dt A) exactly 0 for many channels
# name: (S, T, di, ds, lens, fresh, slots in the pool, dt range)
CASES = {
    "decode": (32, 1, 16384, 16, [1] * 28 + [0] * 4, [0] * 32, 64, SERVE),
    "prefill": (1, 512, 16384, 16, [300], [0], 64, SERVE),
    "prefill fresh": (1, 512, 16384, 16, [512], [1], 64, SERVE),
    "ragged": (4, 70, 200, 16, [70, 33, 0, 32], [1, 0, 0, 0], 6, SERVE),
    "ragged narrow": (3, 40, 96, 16, [40, 7, 0], [1, 0, 0], 4, SERVE),
    "one token": (1, 1, 32, 16, [1], [0], 1, SERVE),
    "segment - 1": (1, 7, 64, 16, [7], [0], 2, SERVE),
    "segment": (1, 8, 64, 16, [8], [0], 2, SERVE),
    "segment + 1": (1, 9, 64, 16, [9], [0], 2, SERVE),
    "run - 1": (1, 31, 64, 16, [31], [0], 2, SERVE),
    "run": (1, 32, 64, 16, [32], [0], 2, SERVE),
    "run + 1": (1, 33, 64, 16, [33], [0], 2, SERVE),
    "prefill rows": (3, 40, 200, 16, [40, 0, 23], [0, 0, 1], 5, SERVE),
    "unaligned rows": (2, 20, 42, 16, [20, 13], [0, 1], 3, SERVE),
    "strong decay prefill": (1, 512, 16384, 16, [300], [0], 64, STRONG),
    "strong decay rows": (3, 40, 200, 16, [33, 0, 40], [1, 0, 0], 5,
                          STRONG),
    "strong decay decode": (32, 1, 16384, 16, [1] * 28 + [0] * 4, [0] * 32,
                            64, STRONG),
}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _case(S, T, di, ds, lens, fresh, n, dt_range, dtype, seed, device):
    """Unit-normal x (in `dtype`), B and C; dt log-uniform in `dt_range`;
    A = -exp(log(1..ds) + 0.3 N); live rows on distinct random slots,
    padding rows on slot 0; the pool is NaN except the non-fresh live rows'
    slots."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    lo, hi = np.log(dt_range)
    dt = torch.from_numpy(np.exp(rng.uniform(lo, hi, (S, T, di)))
                          .astype(np.float32))
    x = normal(S, T, di).to(dtype)
    B, C = normal(S, T, ds), normal(S, T, ds)
    A = -torch.exp(torch.log(torch.arange(1, ds + 1).float())[None, :]
                   + 0.3 * normal(di, ds))
    state = torch.full((n, di, ds), float("nan"))
    slots = rng.permutation(n)[:S].astype(np.int32)
    for s in range(S):
        if lens[s] == 0:
            slots[s] = 0
        elif not fresh[s]:
            state[slots[s]] = normal(di, ds) * 3
    ints = [torch.tensor(a, dtype=torch.int32) for a in (slots, lens, fresh)]
    return [t.to(device) for t in (dt, x, B, C, A, state, *ints)]


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
    dt, x, B, C, A, state, slots, lens, fresh = args
    before = state.clone()
    s6.launches = 0
    out = s6.mamba_chunked_scan(*args)
    torch.cuda.synchronize()
    assert s6.launches == 1
    excess, err = s6.excess(out, state, dt, x, B, C, A, before, slots, lens,
                            fresh)
    assert excess <= 1.0, f"max abs err {err}"
    assert torch.isfinite(out).all()
    for s, n in enumerate(lens.tolist()):
        assert not out[s, n:].any()              # zeros past the live tokens


@pytest.mark.gpu
def test_ops_sends_cuda_tensors_to_the_kernel(cuda_device, monkeypatch):
    """A CUDA tensor reaches the kernel or an exception, never the plain
    version."""
    args = _case(*CASES["ragged"], torch.bfloat16, seed=1,
                 device=cuda_device)

    def refuse(*a, **kw):
        raise AssertionError("plain version called with CUDA tensors")

    monkeypatch.setattr(s6, "mamba_scan_ref", refuse)
    s6.launches = 0
    ops.mamba_scan(*args)
    assert s6.launches == 1
    dt, x, B, C, A, state, slots, lens, fresh = args
    with pytest.raises(ValueError):              # no silent fallback
        ops.mamba_scan(dt, x.double(), B, C, A, state, slots, lens, fresh)
    with pytest.raises(ValueError):              # a state size it lacks
        ops.mamba_scan(dt, x, B[..., :4].contiguous(),
                       C[..., :4].contiguous(), A[:, :4].contiguous(),
                       state[..., :4].contiguous(), slots, lens, fresh)
    with pytest.raises(ValueError):              # int64 lengths
        ops.mamba_scan(dt, x, B, C, A, state, slots, lens.long(), fresh)
    torch.cuda.synchronize()
    assert s6.launches == 1


@pytest.mark.gpu
def test_mixer_goes_through_the_kernel_once(cuda_device):
    """One Mamba mixer on the card launches the kernel once and advances
    the pool only at its rows' slots."""
    from repro_torch.models import ssm

    rng = np.random.default_rng(3)
    Bn, T, d, di, ds, dc = 2, 9, 64, 128, 16, 4
    dtr = max(8, d // 16)
    p = {name: torch.from_numpy(
        (rng.normal(size=shape) * 0.1).astype(np.float32)).to(cuda_device)
        for name, shape in [
            ("in_proj", (d, 2 * di)), ("conv_w", (dc, di)), ("conv_b", (di,)),
            ("x_proj", (di, dtr + 2 * ds)), ("dt_proj", (dtr, di)),
            ("dt_bias", (di,)), ("D", (di,)), ("out_proj", (di, d))]}
    p["A_log"] = torch.log(torch.arange(1, ds + 1, device=cuda_device)
                           .float()).expand(di, ds).contiguous()
    x = torch.from_numpy(rng.normal(size=(Bn, T, d)).astype(np.float32)).to(
        cuda_device)
    pool = torch.full((4, di, ds), float("nan"), device=cuda_device)
    pool[3] = 0.5
    state = ssm.MambaState(
        conv=torch.zeros(Bn, dc - 1, di, device=cuda_device), ssm=pool,
        slots=torch.tensor([3, 1], dtype=torch.int32, device=cuda_device),
        fresh=torch.tensor([0, 1], dtype=torch.int32, device=cuda_device))
    lens = torch.tensor([T, 4], dtype=torch.int32, device=cuda_device)
    s6.launches = 0
    out, conv = ssm.mamba_mixer(x, p, d_state=ds, d_conv=dc, state=state,
                                chunk_lens=lens)
    torch.cuda.synchronize()
    assert s6.launches == 1
    assert torch.isfinite(out[0]).all() and torch.isfinite(out[1, :4]).all()
    assert torch.isfinite(pool[[1, 3]]).all()
    assert torch.isnan(pool[[0, 2]]).all()
    assert conv.shape == (Bn, dc - 1, di)
