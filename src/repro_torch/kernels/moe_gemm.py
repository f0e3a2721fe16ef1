"""Fused grouped-expert SwiGLU: the Hopper kernel's wrapper and its plain
version.

`fused_moe_ffn` launches ``csrc/moe_ffn.cu`` (CUDA C++ for ``sm_90a``, built
at first use by `kernels.build`, bound with ctypes).  It replaces
``repro/kernels/moe_gemm.py::fused_moe_ffn``, the Pallas TPU kernel of the
MoE layer: per expert e over its capacity-padded rows,

    out[e] = (silu(x[e] @ w_gate[e]) * (x[e] @ w_up[e])) @ w_down[e]

with f32 accumulation and the hidden rounded to x's dtype before the down
projection, as the Pallas kernel does.  `counts` (int32 [E], optional) says
how many rows each expert holds: rows ``c >= counts[e]`` come out as exact
zeros whatever x holds there, and the kernel spends no load or product on
them.  The Pallas kernel computes the same function on the serve path,
where those rows of x are zeros.  bf16 runs on wgmma with TMA, f32 in split
TF32 on the tensor cores (three TF32 products per f32 product, never one);
the source's header says what bounds it on an H100 and what the design does
about that.

`fused_moe_ffn_ref` is the plain PyTorch version, mirroring
``repro/kernels/ref.py::fused_moe_ffn_ref``: f32 einsums, cast at the end
(the hidden is not rounded), rows past `counts` masked to zero.  The CPU
path uses it; on the card only the checks call it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

# Calls of `fused_moe_ffn` (each is two device launches) since the count was
# last set to 0.
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MULTIPLE = 128          # d and ff: whole tiles of the kernel's loops

# Largest |d silu(g) / dg| (at g ~ 2.4): how far an error in g moves h.
_SILU_SLOPE = 1.1

# Kernel against plain version, elementwise:
#   |out - want| <= rtol * |want| + htol * h2 + acc * (sqrt(ff) * hd + sqrt(d) * hs2)
# where the plain version, run on absolute values and squares, gives
#   hd  = |h| @ |w_down|                       (scale of the down sum)
#   h2  = sqrt(h**2 @ w_down**2)
#   hs2 = sqrt(hs**2 @ w_down**2), hs = 1.1 |u| (|x| @ |w_gate|)
#         + |silu(g)| (|x| @ |w_up|)  (scale of the error that g's and u's
#         sums carry into h).
# f32: the two differ only in summation order.  Each f32 sum of n terms is
# off by at most lam * sqrt(n) * u * sum|terms| but with probability
# ~exp(-lam^2 / 2) (Higham and Mary's probabilistic bound, lam = 8; the
# worst case n * u is ~30x looser at these widths and would pass a kernel
# that drops a tile of the ff loop); u = 2**-24 for both versions on the
# CUDA cores, 2**-23 for the tensor cores' accumulation.  An error e_f in
# h[f] reaches out through e_f * w_down[f]: the e_f depend on x, w_gate and
# w_up only, and w_down's signs are independent of them and symmetric (as
# in every check's random weights), so their sum over f is bounded by lam
# times its root-square scale (Hoeffding), not by the sum of |e_f w_down[f]|
# that grows linearly in ff: that gives hs2 with the g and u sums' own
# sqrt(d) * u.  Split TF32 (the f32 kernel) keeps each product to ~2**-22
# of itself, inside this; one TF32 product (2**-11) is not, where d and ff
# are small (tests/test_torch_moe.py simulates both).  bf16 adds: each
# version rounds its f32 result to bf16 (one
# ulp apart at most, <= 2**-7 * |want|), and the kernel rounds the hidden to
# bf16 before the down projection (|error| <= 2**-8 * |h| for each f,
# carried into out as above: lam * 2**-8 * h2).  Held linearly, as
# 2**-8 * hd, that rounding allows 0.3 of a typical output at jamba's
# ff = 24576 and passes a kernel that drops 32 of the 24,576 terms.
TOLERANCE = {torch.float32: (0.0, 0.0, 8 * 2 * 2 ** -24),
             torch.bfloat16: (2 ** -7, 8 * 2 ** -8, 8 * (2 ** -23 + 2 ** -24))}


def _parts(x, w_gate, w_up):
    """f32 (u, silu(g)) of the plain version."""
    xf = x.float()
    g = torch.einsum("ecd,edf->ecf", xf, w_gate.float())
    u = torch.einsum("ecd,edf->ecf", xf, w_up.float())
    return u, F.silu(g)


def _live(x: torch.Tensor, counts: Optional[torch.Tensor]) -> torch.Tensor:
    """[E, C, 1] bool: row c of expert e is live (c < counts[e])."""
    rows = torch.arange(x.shape[1], device=x.device)
    return (rows[None, :] < counts.to(x.device)[:, None])[..., None]


def excess(out: torch.Tensor, x, w_gate, w_up, w_down, counts=None
           ) -> Tuple[float, float]:
    """(excess, max_abs_err) of the kernel's `out` against the plain version
    on the same inputs: excess is the largest |out - want| over its bound in
    `TOLERANCE`, at most 1 when the two agree.  Rows past `counts` are held
    to exact zeros (their x is read as 0, so want and bound are 0)."""
    rtol, htol, acc = TOLERANCE[out.dtype]
    d, ff = w_gate.shape[1], w_gate.shape[2]
    if counts is not None:
        x = torch.where(_live(x, counts), x, x.new_zeros(()))
    u, s = _parts(x, w_gate, w_up)
    wd, h = w_down.float(), s * u
    want = torch.einsum("ecf,efd->ecd", h, wd).to(x.dtype).float()
    ax, awd, wd2 = x.float().abs(), wd.abs(), wd * wd
    hd = torch.einsum("ecf,efd->ecd", h.abs(), awd)
    h2 = torch.einsum("ecf,efd->ecd", h * h, wd2).sqrt()
    del h
    gs = torch.einsum("ecd,edf->ecf", ax, w_gate.float().abs())
    us = torch.einsum("ecd,edf->ecf", ax, w_up.float().abs())
    hs = _SILU_SLOPE * u.abs() * gs + s.abs() * us
    del gs, us
    hs2 = torch.einsum("ecf,efd->ecd", hs * hs, wd2).sqrt()
    bound = (rtol * want.abs() + htol * h2
             + acc * (ff ** 0.5 * hd + d ** 0.5 * hs2))
    err = (out.float() - want).abs()
    # all-zero rows (empty capacity slots) have a zero bound and must be 0
    ratio = torch.where(err == 0, torch.zeros_like(err), err / bound)
    return float(ratio.max()), float(err.max())


def _check(x, w_gate, w_up, w_down, counts) -> None:
    tensors = (x, w_gate, w_up, w_down)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("fused_moe_ffn: every input must lie on the same "
                         "CUDA device")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in tensors):
        raise ValueError(f"fused_moe_ffn: dtypes "
                         f"{[str(t.dtype) for t in tensors]}; the kernel "
                         f"takes float32 or bfloat16, the same for all four")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_moe_ffn: inputs must be contiguous")
    if x.dim() != 3 or any(t.dim() != 3 for t in tensors):
        raise ValueError("fused_moe_ffn: x [E, C, d], w_gate/w_up [E, d, ff] "
                         "and w_down [E, ff, d] expected")
    E, C, d = x.shape
    ff = w_gate.shape[2]
    if (tuple(w_gate.shape) != (E, d, ff) or tuple(w_up.shape) != (E, d, ff)
            or tuple(w_down.shape) != (E, ff, d)):
        raise ValueError(f"fused_moe_ffn: x {tuple(x.shape)}, w_gate "
                         f"{tuple(w_gate.shape)}, w_up {tuple(w_up.shape)}, "
                         f"w_down {tuple(w_down.shape)} do not fit "
                         f"[E, C, d], [E, d, ff], [E, d, ff], [E, ff, d]")
    if E < 1 or C < 1 or d % _MULTIPLE or ff % _MULTIPLE or d < 1 or ff < 1:
        raise ValueError(f"fused_moe_ffn: E={E}, C={C}, d={d}, ff={ff}; the "
                         f"kernel takes E, C >= 1 and d, ff multiples of "
                         f"{_MULTIPLE}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("fused_moe_ffn: inputs must be 16-byte aligned")
    if counts is not None and (
            counts.device != x.device or counts.dtype != torch.int32
            or tuple(counts.shape) != (E,) or not counts.is_contiguous()):
        raise ValueError(f"fused_moe_ffn: counts must be a contiguous int32 "
                         f"[{E}] tensor on {x.device}, got {counts.dtype} "
                         f"{tuple(counts.shape)} on {counts.device}")


def _entry_point(lib: ctypes.CDLL):
    """The C entry point ``moe_ffn_launch`` of a built library."""
    fn = lib.moe_ffn_launch
    if fn.argtypes is None:
        ptr = ctypes.c_void_p
        fn.argtypes = [ptr] * 7 + [ctypes.c_int] * 5 + [ptr]
        fn.restype = ctypes.c_int
    return fn


def launch(library: str, x, w_gate, w_up, w_down, counts=None,
           source: Optional[str] = None) -> torch.Tensor:
    """Check the inputs, then launch the entry point of kernel library
    `library` (built at first use from ``csrc/<library>.cu``, or from the
    CUDA text `source`, see `build.load`) on the current stream.  Raises on
    anything the kernel does not take or on a CUDA error.  Counts nothing:
    `fused_moe_ffn` is the counted path."""
    from repro_torch.kernels import build

    _check(x, w_gate, w_up, w_down, counts)
    fn = _entry_point(build.load(library, source))
    E, C, d = x.shape
    ff = w_gate.shape[2]
    hidden = torch.empty((E, C, ff), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
                 w_down.data_ptr(),
                 None if counts is None else counts.data_ptr(),
                 hidden.data_ptr(), out.data_ptr(),
                 E, C, d, ff, _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"moe_ffn_launch failed: CUDA error {err}")
    return out


def fused_moe_ffn(
    x: torch.Tensor,         # [E, C, d] capacity-padded per-expert buffers
    w_gate: torch.Tensor,    # [E, d, ff]
    w_up: torch.Tensor,      # [E, d, ff]
    w_down: torch.Tensor,    # [E, ff, d]
    counts: Optional[torch.Tensor] = None,   # [E] int32: live rows
) -> torch.Tensor:
    """Launch the Hopper kernel; raises on anything it does not take."""
    global launches
    out = launch("moe_ffn", x, w_gate, w_up, w_down, counts)
    launches += 1
    return out


def fused_moe_ffn_ref(x: torch.Tensor, w_gate: torch.Tensor,
                      w_up: torch.Tensor, w_down: torch.Tensor,
                      counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: f32 einsums, cast to x's dtype at the end; rows past
    `counts` masked to zero (the others are the full computation's)."""
    u, s = _parts(x, w_gate, w_up)
    out = torch.einsum("ecf,efd->ecd", s * u, w_down.float()).to(x.dtype)
    if counts is None:
        return out
    return torch.where(_live(x, counts), out, out.new_zeros(()))
