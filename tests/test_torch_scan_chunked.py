"""The chunked WKV6 and segmented Mamba forms of the port's scan kernels, on
the CPU: their plain PyTorch mirrors (`rwkv6_scan.rwkv6_chunked_ref`,
`mamba_scan.mamba_segmented_ref`, the algebra the Hopper kernels run for
T > 1) against the JAX package's Pallas kernels (interpret mode) and its
oracles, and against the port's sequential plain versions over the whole
range of decays the serve path produces.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances:
  * against the JAX oracles and Pallas kernels at tests/test_kernels.py's
    inputs: tests/test_kernels.py's own bounds, 1e-5 (oracle) and 1e-4
    (Pallas, chunked) times max(|oracle|, 1) in f32, as
    tests/test_torch_rwkv.py and tests/test_torch_mamba.py hold the plain
    versions;
  * against the port's plain versions: the kernel modules' `excess` under
    their unchanged `TOLERANCE` (at most 1), which also requires slots that
    no live row owns to come out bit-identical.

The JAX package's chunked WKV (the Pallas kernel and the dense model's
`_wkv_chunked`) divides by the cumulative decay; below w ~ 0.25 over a
64-token chunk that overflows f32.  The serve path's decays reach exact 0,
so the port's chunked form multiplies interval products only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.mamba_scan import mamba_chunked_scan as jax_mamba_kernel
from repro.kernels.rwkv6_scan import rwkv6_chunked_scan as jax_wkv_kernel
from repro.models import ssm as jssm
from repro_torch.kernels import mamba_scan as s6
from repro_torch.kernels import rwkv6_scan as wkv

ATOL = 1e-5


def _normal(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


# --------------------------------------------------------------- WKV6

def _wkv_jax_inputs(B, T, H, D, seed):
    """tests/test_kernels.py's inputs (f32 numpy): w in [0.8, 0.999]."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=(B, T, H, D)).astype(f) * 0.5,
            rng.normal(size=(B, T, H, D)).astype(f) * 0.5,
            rng.normal(size=(B, T, H, D)).astype(f),
            rng.uniform(0.8, 0.999, size=(B, T, H, D)).astype(f),
            rng.normal(size=(H, D)).astype(f) * 0.3)


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_wkv_chunked_ref_matches_jax_pallas_and_oracle(chunk):
    """At zero state and full lengths, in chunks of 8, 16 and 64 tokens."""
    B, T, H, D = 2, 128, 2, 64
    arrs = _wkv_jax_inputs(B, T, H, D, seed=chunk)
    jargs = [jnp.asarray(a) for a in arrs]
    r, k, v, w, u = (torch.from_numpy(a) for a in arrs)
    state = torch.zeros(B, H, D, D)
    ones = torch.ones(B, dtype=torch.int32)
    got = wkv.rwkv6_chunked_ref(r, k, v, w, u, state,
                                torch.arange(B, dtype=torch.int32), ones * T,
                                ones, chunk=chunk).numpy()
    want_ref = np.asarray(jref.rwkv6_scan_ref(*jargs))
    want_pallas = np.asarray(jax_wkv_kernel(*jargs, chunk=chunk,
                                            interpret=True))
    scale = max(float(np.abs(want_ref).max()), 1.0)
    np.testing.assert_allclose(got, want_ref, atol=ATOL * scale, rtol=0)
    np.testing.assert_allclose(got, want_pallas, atol=1e-4 * scale, rtol=0)
    assert torch.isfinite(state).all() and state.abs().max() > 0


def _wkv_serve_case(decay, seed, dtype=torch.float32, S=5, T=37, H=2, D=64):
    """Rows: a carried state over all T tokens, a fresh row, a padding row
    (lens 0, on slot 0, which a live row holds), a carried row of 16 tokens
    and one of 9 (T is a multiple of no chunk tested); the pool is NaN
    except the carried rows' slots.  `decay`: "zero" (w = 0), "one" (w = 1)
    or "clamp" (log w = -exp(U(-20, 10)), the serve path's clamp, which
    holds exact 0, exact 1 and subnormals)."""
    rng = np.random.default_rng(seed)
    r, k, v = (_normal(rng, S, T, H, D).to(dtype) for _ in range(3))
    if decay == "clamp":
        w = torch.from_numpy(np.exp(-np.exp(
            rng.uniform(-20, 10, (S, T, H, D)))).astype(np.float32))
    else:
        w = torch.full((S, T, H, D), 0.0 if decay == "zero" else 1.0)
    u = torch.from_numpy(rng.uniform(0, 1, (H, D)).astype(np.float32))
    lens = [T, 23, 0, 16, 9]
    fresh = [0, 1, 0, 0, 0]
    slots = [3, 1, 0, 0, 5]
    state = torch.full((7, H, D, D), float("nan"))
    for s in (0, 3, 4):
        state[slots[s]] = _normal(rng, H, D, D) * 3
    ints = [torch.tensor(a, dtype=torch.int32) for a in (slots, lens, fresh)]
    return [r, k, v, w, u, state, *ints]


@pytest.mark.parametrize("decay", ["zero", "one", "clamp"])
@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_wkv_chunked_ref_holds_to_plain_over_the_serve_clamp(chunk, decay):
    """Nonzero initial state, ragged lengths, fresh and padding rows: the
    chunked form's output and state are finite, zero past each row's
    length, and within the plain version's bound."""
    args = _wkv_serve_case(decay, seed=chunk)
    r, k, v, w, u, before, slots, lens, fresh = args
    if decay == "clamp":
        assert (w == 0).any() and (w == 1).any()
        assert ((w > 0) & (w < torch.finfo(torch.float32).tiny)).any()
    state = before.clone()
    out = wkv.rwkv6_chunked_ref(r, k, v, w, u, state, slots, lens, fresh,
                                chunk=chunk)
    assert torch.isfinite(out).all()
    assert torch.isfinite(state[slots[lens > 0].long()]).all()
    for s, n in enumerate(lens.tolist()):
        assert not out[s, n:].any()
    excess, err = wkv.excess(out, state, r, k, v, w, u, before, slots, lens,
                             fresh)
    assert excess <= 1.0, f"max abs err {err}"


def test_wkv_chunked_ref_holds_to_plain_with_bf16_inputs():
    args = _wkv_serve_case("clamp", seed=3, dtype=torch.bfloat16)
    r, k, v, w, u, before, slots, lens, fresh = args
    state = before.clone()
    out = wkv.rwkv6_chunked_ref(r, k, v, w, u, state, slots, lens, fresh)
    excess, err = wkv.excess(out, state, r, k, v, w, u, before, slots, lens,
                             fresh)
    assert excess <= 1.0, f"max abs err {err}"


def test_jax_chunked_wkv_overflows_where_the_port_stays_finite():
    """A constant decay w = 0.19 over a 64-token chunk: -log w summed over
    the chunk is 106 > 88, so k / P_t overflows f32 in both of the JAX
    package's chunked forms (the Pallas kernel and the dense model's
    `_wkv_chunked`), while the port's sequential plain version and its
    chunked mirror stay finite and agree."""
    B, T, H, D, chunk = 1, 64, 2, 64, 64
    rng = np.random.default_rng(0)
    f = np.float32
    r, k, v = (rng.normal(size=(B, T, H, D)).astype(f) for _ in range(3))
    w = np.full((B, T, H, D), 0.19, f)
    u = rng.uniform(0, 1, (H, D)).astype(f)
    jargs = [jnp.asarray(a) for a in (r, k, v, w, u)]
    pallas = np.asarray(jax_wkv_kernel(*jargs, chunk=chunk, interpret=True))
    dense, _ = jssm._wkv_chunked(*jargs, jnp.zeros((B, H, D, D)), chunk)
    assert not np.isfinite(pallas).all()
    assert not np.isfinite(np.asarray(dense)).all()

    targs = [torch.from_numpy(a) for a in (r, k, v, w, u)]
    rows = [torch.zeros(B, dtype=torch.int32),
            torch.full((B,), T, dtype=torch.int32),
            torch.ones(B, dtype=torch.int32)]
    plain_state = torch.zeros(B, H, D, D)
    plain = wkv.rwkv6_scan_ref(*targs, plain_state, *rows)
    state = torch.zeros(B, H, D, D)
    chunked = wkv.rwkv6_chunked_ref(*targs, state, *rows, chunk=chunk)
    assert torch.isfinite(plain).all() and torch.isfinite(chunked).all()
    assert torch.isfinite(state).all()
    excess, err = wkv.excess(chunked, state, *targs, torch.zeros(B, H, D, D),
                             *rows)
    assert excess <= 1.0, f"max abs err {err}"


# --------------------------------------------------------------- Mamba

def _mamba_inputs(S, T, di, ds, seed, dt_hi):
    """dt log-uniform in [1e-3, dt_hi], x, B, C unit normal, A = -(1..ds)
    (jamba's init) on every channel, as f32 numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(dt_hi), (S, T, di))).astype(f)
    A = -np.broadcast_to(np.arange(1, ds + 1, dtype=f), (di, ds)).copy()
    return (dt, rng.normal(size=(S, T, di)).astype(f),
            rng.normal(size=(S, T, ds)).astype(f),
            rng.normal(size=(S, T, ds)).astype(f), A)


@pytest.mark.parametrize("segments", [1, 3, 8])
def test_mamba_segmented_ref_matches_jax_pallas_and_plain(segments):
    """At zero state and full lengths, with dt up to 200 (exp(dt A) is
    exactly 0 for most of the largest steps): against JAX's Pallas kernel
    and oracle on dA = exp(dt A) and dBx = dt B x formed in numpy, and
    against the port's sequential plain version."""
    S, T, di, ds = 2, 64, 32, 16
    dt, x, B, C, A = _mamba_inputs(S, T, di, ds, seed=segments, dt_hi=200.0)
    dA = np.exp(dt[..., None] * A)
    assert (dA == 0).any()
    dBx = dt[..., None] * B[:, :, None, :] * x[..., None]
    jargs = [jnp.asarray(a) for a in (dA, dBx, C)]
    targs = [torch.from_numpy(a) for a in (dt, x, B, C, A)]
    rows = [torch.arange(S, dtype=torch.int32),
            torch.full((S,), T, dtype=torch.int32),
            torch.ones(S, dtype=torch.int32)]
    state = torch.zeros(S, di, ds)
    got = s6.mamba_segmented_ref(*targs, state, *rows, segments=segments)
    want_ref = np.asarray(jref.mamba_scan_ref(*jargs))
    want_pallas = np.asarray(jax_mamba_kernel(*jargs, chunk=16,
                                              interpret=True))
    scale = max(float(np.abs(want_ref).max()), 1.0)
    np.testing.assert_allclose(got.numpy(), want_ref, atol=ATOL * scale,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), want_pallas, atol=1e-4 * scale,
                               rtol=0)
    excess, err = s6.excess(got, state, *targs, torch.zeros(S, di, ds),
                            *rows)
    assert excess <= 1.0, f"max abs err {err}"


@pytest.mark.parametrize("segments", [1, 3, 8])
def test_mamba_segmented_ref_holds_to_plain_with_state_and_ragged_rows(
        segments):
    """dt log-uniform in [1e-4, 100] (exact zeros in exp(dt A)), A =
    -exp(log(1..ds) + 0.3 N), bf16 x; a carried row, a fresh row, a padding
    row on slot 0 (which a live row holds) and a short carried row over a
    NaN pool: the segmented form stays within the plain version's bound."""
    rng = np.random.default_rng(10 + segments)
    S, T, di, ds = 4, 37, 24, 16
    dt = torch.from_numpy(np.exp(rng.uniform(
        np.log(1e-4), np.log(100.0), (S, T, di))).astype(np.float32))
    x = _normal(rng, S, T, di).to(torch.bfloat16)
    B, C = _normal(rng, S, T, ds), _normal(rng, S, T, ds)
    A = -torch.exp(torch.log(torch.arange(1, ds + 1).float())[None, :]
                   + 0.3 * _normal(rng, di, ds))
    assert (torch.exp(dt[..., None] * A) == 0).any()
    slots = torch.tensor([1, 2, 0, 0], dtype=torch.int32)
    lens = torch.tensor([37, 20, 0, 9], dtype=torch.int32)
    fresh = torch.tensor([0, 1, 0, 0], dtype=torch.int32)
    before = torch.full((5, di, ds), float("nan"))
    before[1], before[0] = _normal(rng, di, ds) * 3, _normal(rng, di, ds) * 3
    state = before.clone()
    y = s6.mamba_segmented_ref(dt, x, B, C, A, state, slots, lens, fresh,
                               segments=segments)
    assert torch.isfinite(y).all()
    for s, n in enumerate(lens.tolist()):
        assert not y[s, n:].any()
    excess, err = s6.excess(y, state, dt, x, B, C, A, before, slots, lens,
                            fresh)
    assert excess <= 1.0, f"max abs err {err}"
