"""Mamba (S6) selective scan: the Hopper kernel's wrapper and its plain
version.

`mamba_chunked_scan` launches ``csrc/mamba_scan.cu`` (CUDA C++ for
``sm_90a``, built at first use by `kernels.build`, bound with ctypes).  It
replaces ``repro/kernels/mamba_scan.py::mamba_chunked_scan``, the Pallas TPU
kernel, and computes its recurrence per (row, channel c, state s), with an
f32 state h [di, ds]:

    h_t = dA_t * h_{t-1} + dBx_t        y_t = sum_s C_t[s] h_t[c, s]

The discretisation goes inside the kernel: it reads dt [S, T, di] f32 (after
the softplus), the conv output x [S, T, di], B and C [S, T, ds] f32 and
A [di, ds] f32, and forms ``dA = exp(dt A)`` and ``dBx = (dt x) B`` in
registers.  Handing it dA and dBx as the Pallas kernel takes them would
write and read two [T, di, ds] f32 tensors per layer and tick (1.07 GB for
one 512-token chunk of jamba, di = 16384); the fused form reads dt, x, B
and C (~40 MB).

Serving needs what the Pallas kernel (zero initial state, full lengths)
leaves out, so this contract adds it, as `rwkv6_scan` does:

  * the state lives in the layer's slot pool ``state [slots, di, ds]`` f32;
    row s starts from ``state[slots[s]]`` (or from zeros when ``fresh[s]``),
    and the state after its last live token is written back there, in place;
  * row s runs its first ``lens[s]`` tokens (clipped to [0, T]); the output
    past them is 0.  A row with ``lens == 0``, or with a slot outside the
    pool, reads and writes no state.  Live rows must hold distinct slots.

The output is f32.  At zero state and full lengths this is the Pallas
kernel's function on dA and dBx formed the same way.  The source's header
says what bounds the kernel on an H100 and what the design does about that.

`mamba_scan_ref` is the plain PyTorch version with the same contract: the
sequential f32 recurrence of ``repro/kernels/ref.py::mamba_scan_ref`` (and
of the per-token scan in ``repro/models/ssm.py::mamba_mixer``), forming dA
and dBx a token at a time.  The CPU path uses it; on the card only the
checks call it.

The kernel runs decode (T == 1) in the recurrent form and T > 1 in a
segmented form (the source's header gives both).  `mamba_segmented_ref` is
a plain PyTorch mirror of the segmented form's algebra, with the number of
segments a parameter; only tests call it.

`cost` gives a launch's flops and bytes from shapes at the full static
geometry, and `booked` stands in for a launch on ``meta`` tensors: it books
that cost with `roofline.op_cost` and returns an empty output, counting no
launch (the dry run, `launch.dryrun`).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

# Launches of the kernel since the count was last set to 0.
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STATE_SIZE = 16          # d_state the kernel is built for (jamba's)

# Kernel against plain version.  Both read the same inputs (a bf16 x
# converts to f32 exactly) and form dt*A and (dt*x)*B with the same
# correctly rounded products, so they differ in three places per token and
# state: the exponential (the kernel's expf and torch's exp are each within
# 2 ulp, <= 4u, of exp(dt*A): at most 8u apart, counted as 8 roundings),
# the update (plain: two roundings, kernel: one fma) and the sum over the
# ds states of the output.  With A_t the state of the plain version run on
# absolute values (A_t = dA_t A_{t-1} + |dBx_t|, dA_t in (0, 1], bounds
# |h_t| and every term that made it; older errors only shrink), and Higham
# and Mary's probabilistic bound (lam * sqrt(n) * u, failing with
# probability ~exp(-lam^2 / 2); lam = 8, u = 2**-24), at the t-th live
# token of a row (t from 1) and after its last one:
#   |y - want|  <= ACC * (sqrt(11 t) + sqrt(ds + 1)) * y_abs
#   |h - h_ref| <= ACC * sqrt(11 t) * A_t
# where y_abs is the plain version's output on absolute values.  Reading
# h_{t-1} in place of h_t for y_t (the recurrence's off-by-one) misses by
# O(y_abs).
ROUNDINGS_PER_TOKEN = 11
TOLERANCE = {torch.float32: 8 * 2 ** -24, torch.bfloat16: 8 * 2 ** -24}


def _scan(dt, x, B, C, A, h0, lens):
    """The sequential f32 recurrence over every row from h0 [S, di, ds]:
    returns (y [S, T, di], h after each row's last live token)."""
    S, T, di = dt.shape
    y = torch.zeros((S, T, di), dtype=torch.float32, device=dt.device)
    h = h0
    steps = int(lens.max()) if S else 0
    for t in range(steps):
        live = (t < lens)[:, None]
        dt_t = dt[:, t].float()
        dA = torch.exp(dt_t[..., None] * A)                     # [S, di, ds]
        dBx = (dt_t * x[:, t].float())[..., None] * B[:, t, None, :]
        h_t = dA * h + dBx
        y_t = (h_t * C[:, t, None, :]).sum(-1)
        y[:, t] = torch.where(live, y_t, torch.zeros_like(y_t))
        h = torch.where(live[..., None], h_t, h)
    return y, h


def _segmented(dt, x, B, C, A, h0, lens, segments):
    """The segmented form over every row from h0 [S, di, ds]: the T tokens
    cut into `segments` runs of consecutive tokens, each scanned from a zero
    state with its decay product P_t (a product of exponentials, in [0, 1];
    nothing is divided), the carries combined in order and applied as
    h_t = h_local_t + P_t h_in.  Returns (y [S, T, di], h after each row's
    last live token)."""
    S, T, di = dt.shape
    y = torch.zeros((S, T, di), dtype=torch.float32, device=dt.device)
    carry = h0
    size = -(-T // segments)
    for t0 in range(0, T, size):
        h = torch.zeros_like(h0)
        P = torch.ones_like(h0)
        for t in range(t0, min(t0 + size, T)):
            live = (t < lens)[:, None, None]
            dt_t = dt[:, t].float()
            dA = torch.where(live, torch.exp(dt_t[..., None] * A), 1.0)
            dBx = torch.where(live, (dt_t * x[:, t].float())[..., None]
                              * B[:, t, None, :], 0.0)
            h = dA * h + dBx
            P = P * dA
            y_t = (h * C[:, t, None, :]).sum(-1) \
                + (C[:, t, None, :] * P * carry).sum(-1)
            y[:, t] = torch.where(live[..., 0], y_t, 0.0)
        carry = P * carry + h
    return y, carry


def _rows(state, slots, lens, T):
    """(slot index per row clipped into the pool, effective lens, live)."""
    n = state.shape[0]
    sl = slots.long()
    live = (lens > 0) & (sl >= 0) & (sl < n)
    eff = torch.where(live, lens.long().clamp(max=T), torch.zeros_like(sl))
    return sl.clamp(0, n - 1), eff, live


def mamba_scan_ref(dt: torch.Tensor, x: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, A: torch.Tensor, state: torch.Tensor,
                   slots: torch.Tensor, lens: torch.Tensor,
                   fresh: torch.Tensor) -> torch.Tensor:
    """Plain version: dt [S, T, di] f32, x [S, T, di] (f32 or bf16), B, C
    [S, T, ds] f32, A [di, ds] f32; `state` [slots, di, ds] f32 is read and
    written in place at `slots` [S]; `lens`, `fresh` [S] int.  Returns
    y [S, T, di] f32."""
    T = dt.shape[1]
    sl, eff, live = _rows(state, slots, lens, T)
    zero = ((fresh > 0) | ~live)[:, None, None]
    h0 = state[sl].masked_fill(zero, 0.0)      # masked_fill: NaN-safe
    y, hT = _scan(dt, x, B, C, A, h0, eff)
    rows = torch.nonzero(live)[:, 0]
    state[sl[rows]] = hT[rows]
    return y


def mamba_segmented_ref(dt: torch.Tensor, x: torch.Tensor, B: torch.Tensor,
                        C: torch.Tensor, A: torch.Tensor, state: torch.Tensor,
                        slots: torch.Tensor, lens: torch.Tensor,
                        fresh: torch.Tensor, segments: int = 4
                        ) -> torch.Tensor:
    """`mamba_scan_ref`'s contract computed in the kernel's segmented form,
    each row's T tokens cut into `segments` segments (the kernel cuts each
    run of 32 into 4 of 8): a plain mirror of the kernel's algebra for the
    tests."""
    T = dt.shape[1]
    sl, eff, live = _rows(state, slots, lens, T)
    zero = ((fresh > 0) | ~live)[:, None, None]
    h0 = state[sl].masked_fill(zero, 0.0)
    y, hT = _segmented(dt, x, B, C, A, h0, eff, segments)
    rows = torch.nonzero(live)[:, 0]
    state[sl[rows]] = hT[rows]
    return y


def _largest(ratio: torch.Tensor) -> float:
    """The largest ratio, inf where any is NaN (a NaN output or state
    never passes)."""
    return math.inf if bool(torch.isnan(ratio).any()) else float(ratio.max())


def excess(out: torch.Tensor, state_after: torch.Tensor, dt, x, B, C, A,
           state_before: torch.Tensor, slots, lens, fresh
           ) -> Tuple[float, float]:
    """(excess, max_abs_err) of the kernel's output `out` and pool
    `state_after` against the plain version run on the same inputs (the
    pool as it was before the kernel ran, `state_before`): excess is the
    largest error over its bound in `TOLERANCE`, at most 1 when the two
    agree.  Slots that no live row owns must come out bit-identical (NaN
    poison included); if one does not, excess is inf."""
    acc = TOLERANCE[x.dtype]
    S, T, di = dt.shape
    ds = A.shape[1]
    sl, eff, live = _rows(state_before, slots, lens, T)
    want_state = state_before.clone()
    want = mamba_scan_ref(dt, x, B, C, A, want_state, slots, lens, fresh)
    zero = ((fresh > 0) | ~live)[:, None, None]
    A0 = state_before[sl].abs().masked_fill(zero, 0.0)
    y_abs, A_abs = _scan(dt, x.float().abs(), B.abs(), C.abs(), A, A0, eff)

    k = ROUNDINGS_PER_TOKEN
    t = torch.arange(1, T + 1, device=dt.device, dtype=torch.float32)
    bound_y = acc * ((k * t).sqrt()[None, :, None] + math.sqrt(ds + 1)) \
        * y_abs
    err_y = (out.float() - want).abs()
    ratio = torch.where(err_y == 0, torch.zeros_like(err_y), err_y / bound_y)
    worst, max_err = _largest(ratio), float(err_y.max())

    rows = torch.nonzero(live)[:, 0]
    if rows.numel():
        bound_h = acc * (k * eff[rows].float()).sqrt()[:, None, None] \
            * A_abs[rows]
        err_h = (state_after[sl[rows]] - want_state[sl[rows]]).abs()
        rh = torch.where(err_h == 0, torch.zeros_like(err_h), err_h / bound_h)
        worst = max(worst, _largest(rh))
        max_err = max(max_err, float(err_h.max()))
    owned = torch.zeros(state_before.shape[0], dtype=torch.bool,
                        device=state_before.device)
    owned[sl[rows]] = True
    before = state_before[~owned].view(torch.int32)
    if not torch.equal(state_after[~owned].view(torch.int32), before):
        worst = math.inf
    return worst, max_err


def _check(dt, x, B, C, A, state, slots, lens, fresh) -> None:
    tensors = (dt, x, B, C, A, state, slots, lens, fresh)
    if not all(t.is_cuda and t.device == dt.device for t in tensors):
        raise ValueError("mamba_chunked_scan: every input must lie on the "
                         "same CUDA device")
    if x.dtype not in _DTYPES:
        raise ValueError(f"mamba_chunked_scan: x dtype {x.dtype}; the kernel "
                         f"takes float32 or bfloat16")
    if any(t.dtype != torch.float32 for t in (dt, B, C, A, state)):
        raise ValueError("mamba_chunked_scan: dt, B, C, A and state must be "
                         "float32")
    if any(t.dtype != torch.int32 for t in (slots, lens, fresh)):
        raise ValueError("mamba_chunked_scan: slots, lens and fresh must be "
                         "int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("mamba_chunked_scan: inputs must be contiguous")
    if dt.dim() != 3 or A.dim() != 2:
        raise ValueError(f"mamba_chunked_scan: dt {tuple(dt.shape)} and A "
                         f"{tuple(A.shape)} must be [S, T, di] and [di, ds]")
    S, T, di = dt.shape
    ds = A.shape[1]
    if tuple(x.shape) != (S, T, di) or A.shape[0] != di or \
            any(tuple(t.shape) != (S, T, ds) for t in (B, C)):
        raise ValueError("mamba_chunked_scan: x must be [S, T, di] like dt, "
                         "B and C [S, T, ds], A [di, ds]")
    if state.dim() != 3 or tuple(state.shape[1:]) != (di, ds):
        raise ValueError(f"mamba_chunked_scan: state {tuple(state.shape)} "
                         f"must be [slots, di, ds]")
    if any(tuple(t.shape) != (S,) for t in (slots, lens, fresh)):
        raise ValueError("mamba_chunked_scan: slots, lens, fresh must be [S]")
    if ds != STATE_SIZE or S < 1 or T < 1 or di < 1 or S > 65535 \
            or state.shape[0] < 1 or state.data_ptr() % 16:
        raise ValueError(f"mamba_chunked_scan: S={S}, T={T}, di={di}, "
                         f"ds={ds}, {state.shape[0]} slots; the kernel takes "
                         f"ds = {STATE_SIZE}, 1 <= S <= 65535, T, di, "
                         f"slots >= 1 and a 16-byte aligned state")


def _entry_point(lib: ctypes.CDLL):
    """The C entry point ``mamba_scan_launch`` of a built library."""
    fn = lib.mamba_scan_launch
    if fn.argtypes is None:
        ptr = ctypes.c_void_p
        fn.argtypes = [ptr] * 10 + [ctypes.c_int] * 6 + [ptr]
        fn.restype = ctypes.c_int
    return fn


def launch(library: str, dt, x, B, C, A, state, slots, lens, fresh,
           source: Optional[str] = None) -> torch.Tensor:
    """Check the inputs, then launch the entry point of kernel library
    `library` (built at first use from ``csrc/<library>.cu``, or from the
    CUDA text `source`, see `build.load`) on the current stream.  Raises on
    anything the kernel does not take or on a CUDA error.  Counts nothing:
    `mamba_chunked_scan` is the counted path."""
    from repro_torch.kernels import build

    _check(dt, x, B, C, A, state, slots, lens, fresh)
    fn = _entry_point(build.load(library, source))
    S, T, di = dt.shape
    out = torch.empty((S, T, di), dtype=torch.float32, device=dt.device)
    stream = torch.cuda.current_stream(dt.device).cuda_stream
    with torch.cuda.device(dt.device):
        err = fn(dt.data_ptr(), x.data_ptr(), B.data_ptr(), C.data_ptr(),
                 A.data_ptr(), state.data_ptr(), slots.data_ptr(),
                 lens.data_ptr(), fresh.data_ptr(), out.data_ptr(),
                 S, T, di, A.shape[1], state.shape[0], _DTYPES[x.dtype],
                 stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan_launch failed: CUDA error {err}")
    return out


def cost(dt, x, B, C, A, state, slots, lens, fresh) -> Tuple[float, float]:
    """(flops, bytes) of one launch at the full static geometry (every
    token of every row): dt, x, B, C, A and the indices read once, each
    row's [di, ds] f32 state read and written back, the f32 output
    written; 7 flops a token, channel and state (dt·A, dt·x·B, the update
    dA·h + dBx and the read-out C·h; the exponential not counted)."""
    S, T, di = dt.shape
    ds = A.shape[1]
    nbytes = (sum(t.numel() * t.element_size() for t in (dt, x, B, C, A))
              + 2 * S * di * ds * 4 + 4 * dt.numel()
              + 4 * (slots.numel() + lens.numel() + fresh.numel()))
    return 7.0 * S * T * di * ds, float(nbytes)


def booked(dt, x, B, C, A, state, slots, lens, fresh) -> torch.Tensor:
    """A launch on ``meta`` tensors: its `cost` booked with
    `roofline.op_cost`, an empty f32 output of the launch's shape."""
    from repro_torch.roofline import op_cost

    op_cost.book("mamba_scan", *cost(dt, x, B, C, A, state, slots, lens,
                                     fresh))
    return torch.empty(x.shape, dtype=torch.float32, device=x.device)


def mamba_chunked_scan(
    dt: torch.Tensor,        # [S, T, di] f32 step sizes (after the softplus)
    x: torch.Tensor,         # [S, T, di] f32 or bf16 conv output
    B: torch.Tensor,         # [S, T, ds] f32 input projection
    C: torch.Tensor,         # [S, T, ds] f32 read-out
    A: torch.Tensor,         # [di, ds] f32, -exp(A_log)
    state: torch.Tensor,     # [slots, di, ds] f32, updated in place
    slots: torch.Tensor,     # [S] int32
    lens: torch.Tensor,      # [S] int32
    fresh: torch.Tensor,     # [S] int32
) -> torch.Tensor:
    """Launch the Hopper kernel; raises on anything it does not take.
    Returns y [S, T, di] f32."""
    global launches
    out = launch("mamba_scan", dt, x, B, C, A, state, slots, lens, fresh)
    launches += 1
    return out
