"""Dispatch layer (``repro.kernels.ops``): a CUDA tensor goes to the Hopper
kernel, a CPU tensor to the kernel's plain version.  There is no switch and
no fallback: a CUDA input that the kernel refuses raises.

Under autograd (grad enabled, an input that requires grad) the fused MoE
goes through `moe_gemm.FusedMoEFFN`, the kernel forward with its backward;
the other three kernels have no backward, and raise on such a CUDA input
rather than return an output that drops the gradient.  On the CPU the
plain versions are plain PyTorch, which autograd differentiates.

A ``meta`` tensor (the dry run, `launch.dryrun`) goes to the kernel
module's `booked`: the launch's cost from shapes, booked with
`roofline.op_cost`, and an empty result; under autograd the fused MoE's
`FusedMoEFFN` books its forward so and runs its backward's products.  The
plain scans read their lengths on the host, which a meta tensor cannot
give, so the meta branch never runs a plain version."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import mamba_scan as s6
from repro_torch.kernels import moe_gemm
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import rwkv6_scan as wkv


def _tracks_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _no_backward(name: str, *tensors: torch.Tensor) -> None:
    if _tracks_grad(*tensors):
        raise RuntimeError(
            f"{name}: the Hopper kernel has no backward, and an input "
            f"requires grad; run it under torch.no_grad() (serving), or "
            f"train a path that does not reach it")


def paged_attention(q: torch.Tensor, kv_pages: torch.Tensor,
                    block_tables: torch.Tensor, context_lens: torch.Tensor,
                    q_positions: torch.Tensor, with_lse: bool = False):
    """Decode/prefill paged attention over the pool; `with_lse`: also
    each row's log-sum-exp, f32 [S, TQ, H]."""
    args = (q, kv_pages, block_tables, context_lens, q_positions, with_lse)
    if q.is_meta:
        return pa.booked(*args)
    if q.is_cuda:
        _no_backward("paged_attention", q, kv_pages)
        return pa.paged_flash_attention(*args)
    return pa.paged_flash_attention_ref(*args)


def fused_moe_ffn(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor,
                  counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped-expert SwiGLU over capacity-padded buffers x [E, C, d]; rows
    at or past counts[e] (int32 [E], optional) come out as zeros."""
    if x.is_cuda or x.is_meta:
        if _tracks_grad(x, w_gate, w_up, w_down):
            return moe_gemm.FusedMoEFFN.apply(x, w_gate, w_up, w_down,
                                              counts)
        run = moe_gemm.booked if x.is_meta else moe_gemm.fused_moe_ffn
        return run(x, w_gate, w_up, w_down, counts)
    return moe_gemm.fused_moe_ffn_ref(x, w_gate, w_up, w_down, counts)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
               slots: torch.Tensor, lens: torch.Tensor,
               fresh: torch.Tensor) -> torch.Tensor:
    """WKV6 recurrence over rows r, k, v, w [S, T, H, D] from (and back
    into) the state pool at `slots`; returns o [S, T, H, D] f32
    (`rwkv6_scan.rwkv6_chunked_scan` states the contract)."""
    if r.is_meta:
        return wkv.booked(r, k, v, w, u, state, slots, lens, fresh)
    if r.is_cuda:
        _no_backward("rwkv6_scan", r, k, v, w, u, state)
        return wkv.rwkv6_chunked_scan(r, k, v, w, u, state, slots, lens,
                                      fresh)
    return wkv.rwkv6_scan_ref(r, k, v, w, u, state, slots, lens, fresh)


def mamba_scan(dt: torch.Tensor, x: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor, A: torch.Tensor, state: torch.Tensor,
               slots: torch.Tensor, lens: torch.Tensor,
               fresh: torch.Tensor) -> torch.Tensor:
    """Mamba selective scan over rows dt, x [S, T, di] from (and back into)
    the state pool at `slots`; returns y [S, T, di] f32
    (`mamba_scan.mamba_chunked_scan` states the contract)."""
    if dt.is_meta:
        return s6.booked(dt, x, B, C, A, state, slots, lens, fresh)
    if dt.is_cuda:
        _no_backward("mamba_scan", dt, x, B, C, A, state)
        return s6.mamba_chunked_scan(dt, x, B, C, A, state, slots, lens,
                                     fresh)
    return s6.mamba_scan_ref(dt, x, B, C, A, state, slots, lens, fresh)


# The kernel modules whose wrappers count their launches (``launches``).
COUNTED = (pa, moe_gemm, wkv, s6)
