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
path uses it (autograd differentiates it there); on the card only the
checks call it.

Under autograd the kernel runs inside `FusedMoEFFN`, whose backward is
`fused_moe_ffn_backward`: it recomputes ``g = x Wg`` and ``u = x Wu`` in
f32, takes the hidden rounded to x's dtype as the kernel's forward rounds
it, and returns dx, dWg, dWu and dWd from batched f32 products
(``torch.bmm``); rows at or past ``counts[e]`` contribute nothing and get a
zero dx.  The JAX package has no backward kernel either (its gradient is
what autodiff derives); a hand-written one is ROADMAP Queue 2 work.
`GRAD_TOLERANCE` and `grad_excess` hold it to autograd through the plain
version.

`cost` gives a launch's flops and bytes from shapes at the full static
geometry, and `booked` stands in for a launch on ``meta`` tensors: it books
that cost with `roofline.op_cost` and returns an empty output, counting no
launch (the dry run, `launch.dryrun`).
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


def cost(x, w_gate, w_up, w_down, counts=None) -> Tuple[float, float]:
    """(flops, bytes) of one launch at the full static geometry (every
    capacity row of every expert): x, the three weights and `counts` read
    once, the output written once; three products of 2·C·d·ff flops an
    expert."""
    E, C, d = x.shape
    ff = w_gate.shape[-1]
    nbytes = (2 * x.numel() * x.element_size()
              + sum(w.numel() * w.element_size()
                    for w in (w_gate, w_up, w_down))
              + (4 * E if counts is not None else 0))
    return 6.0 * E * C * d * ff, float(nbytes)


def booked(x, w_gate, w_up, w_down, counts=None) -> torch.Tensor:
    """A launch on ``meta`` tensors: its `cost` booked with
    `roofline.op_cost`, an empty output of the launch's shape."""
    from repro_torch.roofline import op_cost

    op_cost.book("moe_ffn", *cost(x, w_gate, w_up, w_down, counts))
    return torch.empty_like(x)


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


# ------------------------------------------------------------------ backward

# Largest |d^2 silu(g) / dg^2| (at g = 0): how far an error in g moves
# silu'(g).
_DSILU_SLOPE = 0.5


def _dsilu(g: torch.Tensor) -> torch.Tensor:
    """silu'(g) = sigmoid(g) (1 + g (1 - sigmoid(g)))."""
    s = torch.sigmoid(g)
    return s * (1 + g * (1 - s))


def fused_moe_ffn_backward(x, w_gate, w_up, w_down, counts, dout, *,
                           dsilu=_dsilu):
    """(dx, dWg, dWu, dWd) of ``fused_moe_ffn`` at (x, weights) for the
    output gradient `dout` [E, C, d], each in its input's dtype.  f32
    batched products; the hidden rounded to x's dtype for dWd; rows past
    `counts` masked out of x and dout.  `dsilu` is silu's derivative (a
    check passes a wrong one to see its comparison fail)."""
    xf, dof = x.float(), dout.float()
    if counts is not None:
        live = _live(x, counts)
        xf = torch.where(live, xf, xf.new_zeros(()))
        dof = torch.where(live, dof, dof.new_zeros(()))
    wg, wu, wd = w_gate.float(), w_up.float(), w_down.float()
    g = torch.bmm(xf, wg)
    u = torch.bmm(xf, wu)
    s = F.silu(g)
    h = (s * u).to(x.dtype).float()
    dwd = torch.bmm(h.transpose(1, 2), dof)
    del h
    dh = torch.bmm(dof, wd.transpose(1, 2))
    du = dh * s
    dg = dh.mul_(u).mul_(dsilu(g))
    del g, u, s
    xt = xf.transpose(1, 2)
    dwg, dwu = torch.bmm(xt, dg), torch.bmm(xt, du)
    dx = torch.bmm(dg, wg.transpose(1, 2)).add_(
        torch.bmm(du, wu.transpose(1, 2)))
    return (dx.to(x.dtype), dwg.to(w_gate.dtype), dwu.to(w_up.dtype),
            dwd.to(w_down.dtype))


class FusedMoEFFN(torch.autograd.Function):
    """The Hopper kernel forward (`fused_moe_ffn`, counted; `booked` on
    ``meta`` tensors) and `fused_moe_ffn_backward`."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up, w_down, counts):
        ctx.save_for_backward(x, w_gate, w_up, w_down, counts)
        run = booked if x.is_meta else fused_moe_ffn
        return run(x, w_gate, w_up, w_down, counts)

    @staticmethod
    def backward(ctx, dout):
        x, w_gate, w_up, w_down, counts = ctx.saved_tensors
        grads = fused_moe_ffn_backward(x, w_gate, w_up, w_down, counts, dout)
        return grads + (None,)


# Gradients of `fused_moe_ffn_backward` against autograd through
# `fused_moe_ffn_ref` on the same inputs, elementwise:
#   |got - want| <= rtol * |want| + (the f32 terms below)
#                 + htol * sqrt(h**2 @ dout**2)            (dWd only)
# Both sides compute in f32 from the same inputs, in different orders.  The
# terms of every sum here have independent, symmetric signs (random rows,
# weights and output gradient, as in every check), so a sum's partial sums
# grow as sqrt(k), and its rounding error, a sum of n independent errors
# each <= u |partial sum|, is held by lam u sum|terms| (Hoeffding; lam = 8,
# u = 2**-24, both versions: acc = 2 lam u), not by `TOLERANCE`'s
# worst-order lam sqrt(n) u sum|terms|.  A sum's error then reaches what
# follows it; later sums add those errors with the independent signs of
# their other factor (as `TOLERANCE` carries h's error through w_down), so
# they are held by their root-square scale, with |silu'| <= 1.1 and
# |silu''| <= 0.5:
#   eg = acc |x|@|Wg|, eu = acc |x|@|Wu|, edh = acc |dout|@|Wd|^T
#   eh  = 1.1 |u| eg + |silu(g)| eu                        (h = silu(g) u)
#   edg = 1.1 |u| edh + 1.1 |dh| eu + 0.5 |dh| |u| eg      (dg = dh u silu'(g))
#   edu = |silu(g)| edh + 1.1 |dh| eg                      (du = dh silu(g))
#   dWd: acc |h|^T@|dout| + sqrt(eh^2^T @ dout^2)
#   dWg: acc |x|^T@|dg| + sqrt(x^2^T @ edg^2)              (dWu: du, edu)
#   dx:  acc (|dg|@|Wg|^T + |du|@|Wu|^T) + sqrt(edg^2 @ Wg^2^T)
#        + sqrt(edu^2 @ Wu^2^T)
# A TF32 backward (each product's operands rounded to 2**-11) is off by
# ~2**-11 of each sum's root-square scale, ~30x this at olmoe's training
# shapes, and fails; the worst-order form would pass it (excess ~0.05).
# bf16 adds: both versions round their f32 gradient to bf16 (one ulp apart
# at most, <= 2**-7 |want|: the excess reads up to ~0.995 where the two
# round a gradient just above a power of two one ulp apart, which this term
# holds exactly; two ulps fail), and dWd here takes the hidden rounded to
# bf16, as the kernel's forward holds it (|error| <= 2**-8 |h| for each term,
# independent of dout's signs: lam 2**-8 times the root-square scale, as in
# `TOLERANCE`).  A backward with silu's derivative replaced by the sigmoid
# moves dg by g sigmoid(g) (1 - sigmoid(g)) dh u, O(1) of dg where |g| ~ 1:
# far outside this.
GRAD_TOLERANCE = {torch.float32: (0.0, 0.0, 2 * 8 * 2 ** -24),
                  torch.bfloat16: (2 ** -7, 8 * 2 ** -8, 2 * 8 * 2 ** -24)}


def fused_moe_ffn_ref_grads(x, w_gate, w_up, w_down, counts, dout):
    """(dx, dWg, dWu, dWd) by autograd through `fused_moe_ffn_ref`."""
    leaves = [t.detach().requires_grad_(True)
              for t in (x, w_gate, w_up, w_down)]
    with torch.enable_grad():
        out = fused_moe_ffn_ref(*leaves, counts)
        return torch.autograd.grad(out, leaves, dout)


def grad_excess(grads, x, w_gate, w_up, w_down, counts, dout
                ) -> Tuple[float, float]:
    """(excess, max_abs_err) of `grads` (dx, dWg, dWu, dWd) against
    autograd through the plain version: excess is the largest error over
    its `GRAD_TOLERANCE` bound, at most 1 when they agree.  Each expert's
    gradients depend on its own rows and weights only, so a caller may
    check a slice of experts at a time."""
    rtol, htol, acc = GRAD_TOLERANCE[x.dtype]
    want = fused_moe_ffn_ref_grads(x, w_gate, w_up, w_down, counts, dout)
    xf, dof = x.float(), dout.float()
    if counts is not None:
        live = _live(x, counts)
        xf = torch.where(live, xf, xf.new_zeros(()))
        dof = torch.where(live, dof, dof.new_zeros(()))
    wg, wu, wd = w_gate.float(), w_up.float(), w_down.float()
    ax, ado = xf.abs(), dof.abs()
    awg, awu = wg.abs(), wu.abs()
    g, u = torch.bmm(xf, wg), torch.bmm(xf, wu)
    s, ds = F.silu(g), _dsilu(g)
    dh = torch.bmm(dof, wd.transpose(1, 2))
    dg, du = dh * u * ds, dh * s
    eg = acc * torch.bmm(ax, awg)
    eu = acc * torch.bmm(ax, awu)
    edh = acc * torch.bmm(ado, wd.abs().transpose(1, 2))
    au, as_, adh = u.abs(), s.abs(), dh.abs()
    eh = _SILU_SLOPE * au * eg + as_ * eu
    edg = _SILU_SLOPE * (au * edh + adh * eu) + _DSILU_SLOPE * adh * au * eg
    edu = as_ * edh + _SILU_SLOPE * adh * eg
    h = s * u
    axt, x2t, do2 = ax.transpose(1, 2), (xf * xf).transpose(1, 2), dof * dof

    def rs(a2, b2):
        """The root-square scale of a @ b from the squares a2, b2."""
        return torch.bmm(a2, b2).sqrt()

    bounds = (
        acc * (torch.bmm(dg.abs(), awg.transpose(1, 2))
               + torch.bmm(du.abs(), awu.transpose(1, 2)))
        + rs(edg * edg, (wg * wg).transpose(1, 2))
        + rs(edu * edu, (wu * wu).transpose(1, 2)),
        acc * torch.bmm(axt, dg.abs()) + rs(x2t, edg * edg),
        acc * torch.bmm(axt, du.abs()) + rs(x2t, edu * edu),
        acc * torch.bmm(h.abs().transpose(1, 2), ado)
        + rs((eh * eh).transpose(1, 2), do2)
        + htol * rs((h * h).transpose(1, 2), do2),
    )
    worst, err_max = 0.0, 0.0
    for got, ref, bound in zip(grads, want, bounds):
        ref = ref.float()
        err = (got.float() - ref).abs()
        bound = rtol * ref.abs() + bound
        ratio = torch.where(err == 0, torch.zeros_like(err), err / bound)
        worst = max(worst, float(ratio.max()))
        err_max = max(err_max, float(err.max()))
    return worst, err_max
