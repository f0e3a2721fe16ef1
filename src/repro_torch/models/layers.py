"""Shared neural-net layers: norms, RoPE/M-RoPE, MLPs
(``repro.models.layers``).

Weights keep the JAX layout (``x @ w`` with ``w`` of shape ``[d_in, d_out]``)
and the casts follow the JAX package: norms and RoPE compute in float32 and
cast back to the input's dtype; matmuls run in the storage dtype.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as coll


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * g.float()).to(dt)


def layernorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * g.float() + b.float()).to(dt)


def apply_norm(x: torch.Tensor, p: Mapping[str, torch.Tensor], kind: str,
               eps: float) -> torch.Tensor:
    if kind == "layernorm":
        return layernorm(x, p["g"], p["b"], eps)
    return rmsnorm(x, p["g"], eps)


# ----------------------------------------------------------------------------
# Rotary embeddings
# ----------------------------------------------------------------------------

def _rope_angles(positions: torch.Tensor, dim: int,
                 theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [...] -> (cos, sin) each [..., dim/2] float32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., H, D]; cos/sin broadcastable [..., 1, D/2] (rotate-half)."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope_tables(positions: torch.Tensor, dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (cos, sin) `apply_rope` uses, [..., T, 1, dim/2]: computed once
    per tick, they serve every layer's q and k."""
    cos, sin = _rope_angles(positions, dim, theta)
    return cos[..., None, :], sin[..., None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [..., T, H, D], positions [..., T] -> rotary-embedded x."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))


def mrope_tables(positions3: torch.Tensor, sections: Tuple[int, int, int],
                 dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (cos, sin) `apply_mrope` uses, [..., T, 1, dim/2]: the dim/2
    frequency bands split into (temporal, height, width) sections of
    `sections` bands, each band at the position of its section's stream
    (`positions3` [3, ..., T])."""
    if sum(sections) != dim // 2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to "
                         f"{dim // 2}")
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions3.device) / dim
    inv = 1.0 / (theta ** exps)
    # contiguous bands, one slice each: no index tensor, so a CUDA graph
    # captures it
    bounds = [0, sections[0], sections[0] + sections[1], dim // 2]
    ang = torch.cat([positions3[i].float()[..., None] * inv[lo:hi]
                     for i, (lo, hi) in enumerate(zip(bounds, bounds[1:]))],
                    dim=-1)                                   # [..., T, D/2]
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                sections: Tuple[int, int, int], theta: float) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: x [..., T, H, D], positions3 [3, ..., T]
    (temporal, height, width).  For text tokens the three streams coincide
    and M-RoPE reduces to RoPE."""
    return rotate(x, *mrope_tables(positions3, sections, x.shape[-1], theta))


# ----------------------------------------------------------------------------
# MLPs
# ----------------------------------------------------------------------------

def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
             w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    return F.gelu(x @ w1 + b1, approximate="tanh") @ w2 + b2


def mlp_partial(x: torch.Tensor, p: Mapping[str, torch.Tensor],
                act: str) -> torch.Tensor:
    """The block's MLP without its output bias: at a tensor rank, which
    holds the columns of the first products and the rows of the last, the
    rank's partial sum."""
    if act == "gelu":
        return F.gelu(x @ p["w1"] + p["b1"], approximate="tanh") @ p["w2"]
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])


def mlp_apply(x: torch.Tensor, p: Mapping[str, torch.Tensor],
              act: str, tp=None) -> torch.Tensor:
    """The block's MLP.  At a tensor rank `tp` (a `launch.mesh.AxisGroup`
    of more than one rank) its partial sum (`mlp_partial`) is reduced over
    the group (`collectives.reduce_from_tensor`), then the replicated
    output bias added."""
    if tp is None or tp.size == 1:
        if act == "gelu":
            return gelu_mlp(x, p["w1"], p["b1"], p["w2"], p["b2"])
        return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])
    y = coll.reduce_from_tensor(
        mlp_partial(coll.copy_to_tensor(x, tp), p, act), tp)
    return y + p["b2"] if act == "gelu" else y
