"""The check that holds the RWKV and Mamba train forms (`ssm.wkv6_train`,
`ssm.selective_scan_train`) to autograd of the sequential f32 recurrences,
and the planted copies of the train forms that it must refuse.  The CPU
tests, the card's tests and chip_smoke run it.

The sequential recurrences are the kernels' plain versions
(`rwkv6_scan.rwkv6_scan_ref`, `mamba_scan.mamba_scan_ref`) run from a zero
pool over whole rows: a token at a time, products formed by one multiply a
token, in f32.  Autograd differentiates them on either device.

Tolerance: both sides compute in f32 from the same inputs (bf16 inputs
convert to f32 exactly) and differ in the order of their roundings only,
~1e-7 of a tensor at these lengths.  Every output and every gradient must
lie within ``GRAD_TOL`` of the largest magnitude of the sequential side's
tensor.  A gradient that autograd hands back in bf16 (that of a bf16
input) is also rounded once on each side, each rounding within 2**-8 of
its magnitude: ``2**-7`` of that magnitude more, and 2**-8 more of the
f32 part.  A non-finite value never passes.
"""

from __future__ import annotations

import inspect
import math
from typing import Callable, Dict, Sequence, Tuple

import torch

from repro_torch.kernels import mamba_scan as s6
from repro_torch.kernels import rwkv6_scan as wkv
from repro_torch.models import ssm

GRAD_TOL = 1e-5
BF16_ROUNDING = 2 ** -7

# log-log decay ranges: -log w = exp(U(lo, hi)) for WKV; Mamba's dt
# log-uniform in [lo, hi] with A = -exp(A_log)
WKV_DECAYS = {
    "init": (-1.5, -0.5),     # w ~ 0.69 (w0 = -1, w_lora_b = 0 at init)
    "strong": (-20.0, 10.0),  # the clamp's whole range: -log w to 22,026,
                              # far past 88 over every 8-token sub-chunk
    "none": None,             # w = 1: the state never forgets
}
MAMBA_DECAYS = {
    "init": (1e-3, 1.0),
    "strong": (1e-4, 100.0),  # exp(dt A) exactly 0 on many channels
    "none": None,             # A = -exp(-80): exp(dt A) = 1
}

# Planted copies: (the line of `models/ssm.py` replaced, its replacement).
PLANTS = {
    # o_t reads k_t v_t^T too, as if it read S_t in place of S_{t-1}
    "wkv reads S_t": (
        "tri = torch.ones(l, l, dtype=torch.bool, device=r.device).tril(-1)",
        "tri = torch.ones(l, l, dtype=torch.bool, device=r.device).tril(0)"),
    # prod_{j<s<t} w_s as P_{t-1} / P_j (the JAX package's form), P the
    # cumulative decay from the sub-chunk's start: 0 / 0 once it underflows
    "wkv divides": (
        "dec = _between(lw).masked_fill(~tri[..., None], -math.inf).exp()",
        "dec = torch.where(tri[..., None], _prefix(lw).exp()[..., :, None, :]"
        " / torch.cumsum(lw, -2).exp()[..., None, :, :], 0.0)"),
    # y_t reads h_{t-1}
    "mamba reads h_{t-1}": (
        'return torch.einsum("blds,bls->bld", hs, C.float()), hs[:, -1]',
        'return torch.einsum("blds,bls->bld", torch.cat([h[:, None], '
        'hs[:, :-1]], dim=1), C.float()), hs[:, -1]'),
}


def sequential_wkv6(r, k, v, logw, u) -> torch.Tensor:
    """`ssm.wkv6_train`'s function through the sequential recurrence."""
    B, T, H, D = r.shape
    rows = _rows(B, T, r.device)
    pool = torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
    return wkv.rwkv6_scan_ref(r, k, v, torch.exp(logw.float()), u.float(),
                              pool, *rows)


def sequential_selective_scan(dt, x, Bm, C, A) -> torch.Tensor:
    """`ssm.selective_scan_train`'s function through the sequential
    recurrence."""
    S, T, _ = dt.shape
    pool = torch.zeros((S,) + tuple(A.shape), dtype=torch.float32,
                       device=dt.device)
    return s6.mamba_scan_ref(dt.float(), x, Bm.float(), C.float(), A.float(),
                             pool, *_rows(S, T, dt.device))


def _rows(S: int, T: int, device):
    """slots, lens, fresh of S whole rows from a zero pool."""
    return (torch.arange(S, dtype=torch.int32, device=device),
            torch.full((S,), T, dtype=torch.int32, device=device),
            torch.ones(S, dtype=torch.int32, device=device))


def wkv_case(B: int, T: int, H: int, D: int, decay: str, seed: int,
             dtype=torch.float32, device="cpu") -> Tuple[torch.Tensor, ...]:
    """(r, k, v in `dtype`, logw f32, u f32) on `device`: unit-normal r, k,
    v, u uniform in [0, 1), the decay from `WKV_DECAYS[decay]`."""
    g = torch.Generator().manual_seed(seed)
    r, k, v = (torch.randn(B, T, H, D, generator=g) for _ in range(3))
    rng = WKV_DECAYS[decay]
    if rng is None:
        logw = torch.zeros(B, T, H, D)
    else:
        lo, hi = rng
        logw = -torch.exp(lo + (hi - lo) * torch.rand(B, T, H, D, generator=g))
    u = torch.rand(H, D, generator=g)
    return (*(t.to(device, dtype) for t in (r, k, v)), logw.to(device),
            u.to(device))


def mamba_case(S: int, T: int, di: int, ds: int, decay: str, seed: int,
               dtype=torch.float32, device="cpu") -> Tuple[torch.Tensor, ...]:
    """(dt f32, x in `dtype`, B, C, A f32) on `device`: unit-normal x, B, C,
    A = -exp(A_log) about -1 (N(0, 0.5) in log), dt from
    `MAMBA_DECAYS[decay]`."""
    g = torch.Generator().manual_seed(seed)
    x, Bm, C = (torch.randn(S, T, n, generator=g) for n in (di, ds, ds))
    rng = MAMBA_DECAYS[decay]
    lo, hi = rng if rng is not None else MAMBA_DECAYS["init"]
    dt = torch.exp(math.log(lo) + (math.log(hi) - math.log(lo))
                   * torch.rand(S, T, di, generator=g))
    A_log = (torch.full((di, ds), -80.0) if rng is None
             else 0.5 * torch.randn(di, ds, generator=g))
    return (dt.to(device), x.to(device, dtype), Bm.to(device), C.to(device),
            (-torch.exp(A_log)).to(device))


def excess(got: Sequence[torch.Tensor], want: Sequence[torch.Tensor]) -> float:
    """The largest error over its bound across the tensors `got` against
    `want` (at most 1 when they agree; inf where `got` holds a
    non-finite value)."""
    worst = 0.0
    for a, b in zip(got, want):
        if not bool(torch.isfinite(a).all()):
            return math.inf
        bf = b.float()
        bound = GRAD_TOL * float(bf.abs().max())
        if a.dtype == torch.bfloat16:
            bound = bound * (1 + BF16_ROUNDING / 2) + BF16_ROUNDING * bf.abs()
        err = (a.float() - bf).abs() / torch.clamp(
            torch.as_tensor(bound, device=bf.device), min=1e-30)
        worst = max(worst, float(err.max()))
    return worst


def check(form: Callable, sequential: Callable, inputs: Sequence[torch.Tensor],
          seed: int = 0) -> Dict[str, float]:
    """`form` against `sequential` on `inputs`, a seeded unit-normal output
    gradient: {"out": the outputs' excess, "grad": the gradients' (every
    input's), "max_abs_err": of the gradients}."""
    sides = []
    for fn in (form, sequential):
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        out = fn(*leaves)
        if not sides:
            g = torch.Generator().manual_seed(seed)
            dout = torch.randn(out.shape, generator=g).to(out.device)
        sides.append((out.detach(), torch.autograd.grad(out, leaves, dout)))
    (out, grads), (want, want_grads) = sides
    return {"out": excess([out], [want]),
            "grad": excess(grads, want_grads),
            "max_abs_err": max(float((a.float() - b.float()).abs().max())
                               for a, b in zip(grads, want_grads))}


def planted(name: str) -> Callable:
    """The train form of `models/ssm.py` with the planted fault `name`
    (`PLANTS`), built from the module's source."""
    old, new = PLANTS[name]
    src = inspect.getsource(ssm)
    if src.count(old) != 1:
        raise RuntimeError(f"planted {name!r}: the line it replaces is not "
                           f"in models/ssm.py once: {old!r}")
    ns = {"__name__": "repro_torch.models.ssm_planted"}
    exec(compile(src.replace(old, new), f"{ssm.__file__} ({name})", "exec"),
         ns)
    return ns["wkv6_train" if name.startswith("wkv") else
              "selective_scan_train"]
