"""RWKV6 (Finch) WKV recurrence: the Hopper kernel's wrapper and its plain
version.

`rwkv6_chunked_scan` launches ``csrc/rwkv6_scan.cu`` (CUDA C++ for
``sm_90a``, built at first use by `kernels.build`, bound with ctypes).  It
replaces ``repro/kernels/rwkv6_scan.py::rwkv6_chunked_scan``, the Pallas TPU
kernel, and computes its recurrence per (row, head), with an f32 [D, D]
state:

    o_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

Serving needs two things the Pallas kernel (zero initial state, full
lengths) leaves out, so this contract adds them:

  * the state lives in the layer's slot pool ``state [slots, H, D, D]`` f32;
    row s starts from ``state[slots[s]]`` (or from zeros when ``fresh[s]``),
    and the state after its last live token is written back there, in place;
  * row s runs its first ``lens[s]`` tokens (clipped to [0, T]); the output
    past them is 0.  A row with ``lens == 0``, or with a slot outside the
    pool, reads and writes no state.  Live rows must hold distinct slots.

The output is f32 (the serve path keeps the WKV output in f32 through the
group norm); the Pallas kernel writes r's dtype.  At zero state and full
lengths the two compute the same function.  The source's header says what
bounds the kernel on an H100 and what the design does about that.

`rwkv6_scan_ref` is the plain PyTorch version with the same contract: the
sequential f32 recurrence of ``repro/kernels/ref.py::rwkv6_scan_ref`` (and
of the per-token scan in ``repro/models/ssm.py::rwkv_time_mix``).  The CPU
path uses it; on the card only the checks call it.

The kernel runs decode (T == 1) in the recurrent form and T > 1 in a
chunked, division-free form (the source's header gives both).
`rwkv6_chunked_ref` is a plain PyTorch mirror of the chunked form's
algebra, with the chunk length a parameter; only tests call it.

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
HEAD_DIM = 64            # the head size of every published RWKV-6

# Kernel against plain version.  Both read the same inputs (bf16 r, k, v
# convert to f32 exactly), compute in f32 and write f32, so they differ only
# in the order and fusion of their roundings; the bound is the same for both
# input dtypes.  Per token each version rounds the state update a few times
# (kernel: k*v, then one fma; plain: k*v, w*S, the sum): at most 5 roundings
# between them, each <= u * A_t, where A_t is the state of the plain version
# run on absolute values (A_t = w_t A_{t-1} + |k_t| |v_t| bounds |S_t| and
# every term that made it, and the decay only shrinks older errors).  The
# output sums D terms r_i (S_ij + u_i k_i v_j) (plus the u-term's products).
# With Higham and Mary's probabilistic bound (lam * sqrt(n) * u, failing with
# probability ~exp(-lam^2 / 2); lam = 8, u = 2**-24), at the t-th live token
# of a row (t from 1) and after its last one:
#   |o - want|  <= ACC * (sqrt(5 t) + sqrt(D + 3)) * o_abs
#   |S - S_ref| <= ACC * sqrt(5 t) * A_t
# where o_abs is the plain version's output on absolute values.  Reading
# S_t in place of S_{t-1} (the recurrence's off-by-one) misses by O(o_abs).
TOLERANCE = {torch.float32: 8 * 2 ** -24, torch.bfloat16: 8 * 2 ** -24}


def _scan(r, k, v, w, u, S0, lens):
    """The sequential f32 recurrence over every row from S0 [S, H, D, D]:
    returns (o [S, T, H, D], S after each row's last live token)."""
    S, T, H, D = r.shape
    uf = u.float()[None, :, :, None]
    o = torch.zeros((S, T, H, D), dtype=torch.float32, device=r.device)
    state = S0
    steps = int(lens.max()) if S else 0
    for t in range(steps):
        live = (t < lens)[:, None, None]
        r_t, k_t = r[:, t].float(), k[:, t].float()
        v_t, w_t = v[:, t].float(), w[:, t].float()
        kv = k_t[..., :, None] * v_t[..., None, :]           # [S, H, D, D]
        o_t = torch.einsum("shk,shkv->shv", r_t, state + uf * kv)
        o[:, t] = torch.where(live, o_t, torch.zeros_like(o_t))
        state = torch.where(live[..., None], w_t[..., :, None] * state + kv,
                            state)
    return o, state


def _chunked(r, k, v, w, u, S0, lens, chunk):
    """The chunked form over every row from S0 [S, H, D, D], in f32 and
    with products of w over intervals only (each in [0, 1]; nothing is
    divided): returns (o [S, T, H, D], S after each row's last live
    token)."""
    S, T, H, D = r.shape
    live = (torch.arange(T, device=r.device)[None, :] < lens[:, None])
    m = live[:, :, None, None]
    rf, kf, vf = (torch.where(m, x.float(), 0.0) for x in (r, k, v))
    wf = torch.where(m, w.float(), 1.0)          # dead tokens: no decay
    uf = u.float()
    o = torch.zeros((S, T, H, D), dtype=torch.float32, device=r.device)
    state = S0
    steps = int(lens.max()) if S else 0
    for c0 in range(0, steps, chunk):
        rc, kc, vc, wc = (x[:, c0:c0 + chunk] for x in (rf, kf, vf, wf))
        n = rc.shape[1]
        a = torch.ones_like(wc[:, 0])            # prod_{m<t} w_m
        ra = torch.empty_like(rc)
        for t in range(n):
            ra[:, t] = rc[:, t] * a
            a = a * wc[:, t]
        b = torch.ones_like(wc[:, 0])            # prod_{m>j} w_m
        kb = torch.empty_like(kc)
        for j in reversed(range(n)):
            kb[:, j] = kc[:, j] * b
            b = b * wc[:, j]
        # A[t, j] = sum_i r_ti k_ji prod_{m=j+1}^{t-1} w_mi (j < t), the
        # bonus r_t . (u (.) k_t) at j = t; P[:, j] runs along t
        A = torch.zeros((S, H, n, n), dtype=torch.float32, device=r.device)
        P = torch.ones_like(kc)
        for t in range(n):
            A[:, :, t, :t] = torch.einsum("shi,sjhi->shj", rc[:, t],
                                          kc[:, :t] * P[:, :t])
            A[:, :, t, t] = (rc[:, t] * uf * kc[:, t]).sum(-1)
            P[:, :t] = P[:, :t] * wc[:, t:t + 1]
        oc = (torch.einsum("sthi,shij->sthj", ra, state)
              + torch.einsum("shtj,sjhd->sthd", A, vc))
        o[:, c0:c0 + n] = torch.where(m[:, c0:c0 + n], oc, 0.0)
        state = (a[..., :, None] * state
                 + torch.einsum("sjhi,sjhd->shid", kb, vc))
    return o, state


def _rows(state, slots, lens, T):
    """(slot index per row clipped into the pool, effective lens, live)."""
    n = state.shape[0]
    sl = slots.long()
    live = (lens > 0) & (sl >= 0) & (sl < n)
    eff = torch.where(live, lens.long().clamp(max=T), torch.zeros_like(sl))
    return sl.clamp(0, n - 1), eff, live


def rwkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                   slots: torch.Tensor, lens: torch.Tensor,
                   fresh: torch.Tensor) -> torch.Tensor:
    """Plain version: r, k, v [S, T, H, D] (f32 or bf16), w [S, T, H, D]
    f32, u [H, D] f32; `state` [slots, H, D, D] f32 is read and written in
    place at `slots` [S]; `lens`, `fresh` [S] int.  Returns o [S, T, H, D]
    f32."""
    T = r.shape[1]
    sl, eff, live = _rows(state, slots, lens, T)
    zero = ((fresh > 0) | ~live)[:, None, None, None]
    S0 = state[sl].masked_fill(zero, 0.0)      # masked_fill: NaN-safe
    o, ST = _scan(r, k, v, w, u, S0, eff)
    rows = torch.nonzero(live)[:, 0]
    state[sl[rows]] = ST[rows]
    return o


def rwkv6_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                      slots: torch.Tensor, lens: torch.Tensor,
                      fresh: torch.Tensor, chunk: int = 16) -> torch.Tensor:
    """`rwkv6_scan_ref`'s contract computed in the kernel's chunked,
    division-free form, in chunks of `chunk` tokens (the kernel's is 16):
    a plain mirror of the kernel's algebra for the tests."""
    T = r.shape[1]
    sl, eff, live = _rows(state, slots, lens, T)
    zero = ((fresh > 0) | ~live)[:, None, None, None]
    S0 = state[sl].masked_fill(zero, 0.0)
    o, ST = _chunked(r, k, v, w, u, S0, eff, chunk)
    rows = torch.nonzero(live)[:, 0]
    state[sl[rows]] = ST[rows]
    return o


def _largest(ratio: torch.Tensor) -> float:
    """The largest ratio, inf where any is NaN (a NaN output or state
    never passes)."""
    return math.inf if bool(torch.isnan(ratio).any()) else float(ratio.max())


def excess(out: torch.Tensor, state_after: torch.Tensor, r, k, v, w, u,
           state_before: torch.Tensor, slots, lens, fresh
           ) -> Tuple[float, float]:
    """(excess, max_abs_err) of the kernel's output `out` and pool
    `state_after` against the plain version run on the same inputs (the
    pool as it was before the kernel ran, `state_before`): excess is the
    largest error over its bound in `TOLERANCE`, at most 1 when the two
    agree.  Slots that no live row owns must come out bit-identical (NaN
    poison included); if one does not, excess is inf."""
    acc = TOLERANCE[r.dtype]
    S, T, H, D = r.shape
    sl, eff, live = _rows(state_before, slots, lens, T)
    want_state = state_before.clone()
    want = rwkv6_scan_ref(r, k, v, w, u, want_state, slots, lens, fresh)
    zero = ((fresh > 0) | ~live)[:, None, None, None]
    A0 = state_before[sl].abs().masked_fill(zero, 0.0)
    o_abs, A = _scan(r.float().abs(), k.float().abs(), v.float().abs(), w,
                     u.abs(), A0, eff)

    t = torch.arange(1, T + 1, device=r.device, dtype=torch.float32)
    bound_o = acc * ((5 * t).sqrt()[None, :, None, None]
                     + math.sqrt(D + 3)) * o_abs
    err_o = (out.float() - want).abs()
    ratio = torch.where(err_o == 0, torch.zeros_like(err_o), err_o / bound_o)
    worst, max_err = _largest(ratio), float(err_o.max())

    rows = torch.nonzero(live)[:, 0]
    if rows.numel():
        bound_s = acc * (5 * eff[rows].float()).sqrt()[:, None, None, None] \
            * A[rows]
        err_s = (state_after[sl[rows]] - want_state[sl[rows]]).abs()
        rs = torch.where(err_s == 0, torch.zeros_like(err_s), err_s / bound_s)
        worst = max(worst, _largest(rs))
        max_err = max(max_err, float(err_s.max()))
    owned = torch.zeros(state_before.shape[0], dtype=torch.bool,
                        device=state_before.device)
    owned[sl[rows]] = True
    before = state_before[~owned].view(torch.int32)
    if not torch.equal(state_after[~owned].view(torch.int32), before):
        worst = math.inf
    return worst, max_err


def _check(r, k, v, w, u, state, slots, lens, fresh) -> None:
    tensors = (r, k, v, w, u, state, slots, lens, fresh)
    if not all(t.is_cuda and t.device == r.device for t in tensors):
        raise ValueError("rwkv6_chunked_scan: every input must lie on the "
                         "same CUDA device")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"rwkv6_chunked_scan: r/k/v dtypes {r.dtype}/"
                         f"{k.dtype}/{v.dtype}; the kernel takes float32 or "
                         f"bfloat16, the same for all three")
    if any(t.dtype != torch.float32 for t in (w, u, state)):
        raise ValueError("rwkv6_chunked_scan: w, u and state must be float32")
    if any(t.dtype != torch.int32 for t in (slots, lens, fresh)):
        raise ValueError("rwkv6_chunked_scan: slots, lens and fresh must be "
                         "int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("rwkv6_chunked_scan: inputs must be contiguous")
    if r.dim() != 4:
        raise ValueError(f"rwkv6_chunked_scan: r {tuple(r.shape)} must be "
                         f"[S, T, H, D]")
    S, T, H, D = r.shape
    if any(tuple(t.shape) != (S, T, H, D) for t in (k, v, w)):
        raise ValueError("rwkv6_chunked_scan: r, k, v, w must share the "
                         "shape [S, T, H, D]")
    if tuple(u.shape) != (H, D) or state.dim() != 4 or \
            tuple(state.shape[1:]) != (H, D, D):
        raise ValueError(f"rwkv6_chunked_scan: u {tuple(u.shape)} and state "
                         f"{tuple(state.shape)} must be [H, D] and "
                         f"[slots, H, D, D]")
    if any(tuple(t.shape) != (S,) for t in (slots, lens, fresh)):
        raise ValueError("rwkv6_chunked_scan: slots, lens, fresh must be [S]")
    if D != HEAD_DIM or S < 1 or T < 1 or state.shape[0] < 1 or H > 65535:
        raise ValueError(f"rwkv6_chunked_scan: S={S}, T={T}, H={H}, D={D}, "
                         f"{state.shape[0]} slots; the kernel takes D = "
                         f"{HEAD_DIM} and S, T, slots >= 1")


def _entry_points(lib: ctypes.CDLL):
    """The C entry points ``rwkv6_scan_launch`` and
    ``rwkv6_scan_workspace_bytes`` of a built library."""
    fn, ws = lib.rwkv6_scan_launch, lib.rwkv6_scan_workspace_bytes
    if fn.argtypes is None:
        ptr = ctypes.c_void_p
        fn.argtypes = [ptr] * 11 + [ctypes.c_int] * 6 + [ptr]
        fn.restype = ctypes.c_int
        ws.argtypes = [ctypes.c_int] * 4
        ws.restype = ctypes.c_longlong
    return fn, ws


def launch(library: str, r, k, v, w, u, state, slots, lens, fresh,
           source: Optional[str] = None) -> torch.Tensor:
    """Check the inputs, then launch the entry point of kernel library
    `library` (built at first use from ``csrc/<library>.cu``, or from the
    CUDA text `source`, see `build.load`) on the current stream, with the
    workspace that ``rwkv6_scan_workspace_bytes`` asks for (the chunked
    form's chunk states; none for T == 1).  Raises on anything the kernel
    does not take or on a CUDA error.  Counts nothing: `rwkv6_chunked_scan`
    is the counted path."""
    from repro_torch.kernels import build

    _check(r, k, v, w, u, state, slots, lens, fresh)
    fn, workspace_bytes = _entry_points(build.load(library, source))
    S, T, H, D = r.shape
    out = torch.empty((S, T, H, D), dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        nbytes = workspace_bytes(S, T, H, D)
        if nbytes < 0:
            raise ValueError(f"rwkv6_scan_workspace_bytes refuses S={S}, "
                             f"T={T}, H={H}, D={D}")
        work = (torch.empty(nbytes, dtype=torch.uint8, device=r.device)
                if nbytes else None)
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), state.data_ptr(), slots.data_ptr(),
                 lens.data_ptr(), fresh.data_ptr(), out.data_ptr(),
                 work.data_ptr() if nbytes else None,
                 S, T, H, D, state.shape[0], _DTYPES[r.dtype], stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan_launch failed: CUDA error {err}")
    return out


def cost(r, k, v, w, u, state, slots, lens, fresh) -> Tuple[float, float]:
    """(flops, bytes) of one launch at the full static geometry (every
    token of every row): r, k, v, w, u and the indices read once, each
    row's [H, D, D] f32 state read and written back, the f32 output
    written; 6·D² flops a token and head (the outer product k v^T, the
    decayed update and the read-out r (S + u k v^T), a multiply-add
    counted as two)."""
    S, T, H, D = r.shape
    nbytes = (sum(t.numel() * t.element_size() for t in (r, k, v, w, u))
              + 2 * S * H * D * D * 4 + 4 * r.numel()
              + 4 * (slots.numel() + lens.numel() + fresh.numel()))
    return 6.0 * S * T * H * D * D, float(nbytes)


def booked(r, k, v, w, u, state, slots, lens, fresh) -> torch.Tensor:
    """A launch on ``meta`` tensors: its `cost` booked with
    `roofline.op_cost`, an empty f32 output of the launch's shape."""
    from repro_torch.roofline import op_cost

    op_cost.book("rwkv6_scan", *cost(r, k, v, w, u, state, slots, lens,
                                     fresh))
    return torch.empty(r.shape, dtype=torch.float32, device=r.device)


def rwkv6_chunked_scan(
    r: torch.Tensor,         # [S, T, H, D] f32 or bf16
    k: torch.Tensor,         # [S, T, H, D] r's dtype
    v: torch.Tensor,         # [S, T, H, D] r's dtype
    w: torch.Tensor,         # [S, T, H, D] f32 decay in [0, 1]
    u: torch.Tensor,         # [H, D] f32 bonus of the current token
    state: torch.Tensor,     # [slots, H, D, D] f32, updated in place
    slots: torch.Tensor,     # [S] int32
    lens: torch.Tensor,      # [S] int32
    fresh: torch.Tensor,     # [S] int32
) -> torch.Tensor:
    """Launch the Hopper kernel; raises on anything it does not take.
    Returns o [S, T, H, D] f32."""
    global launches
    out = launch("rwkv6_scan", r, k, v, w, u, state, slots, lens, fresh)
    launches += 1
    return out
