"""Gradient sync, optionally compressed (``repro.distributed.collectives``),
at one rank.

The JAX module sums each gradient over the mesh axes its parameter is
replicated on.  On its ``(1, 1, 1)`` mesh every axis has size 1, and what
remains of each mode is what the port computes here:

  None     — the f32 cast (`psum_f32`).
  "int8"   — quantise with the leaf's own absmax / 127 scale and dequantise
             (`int8_psum`: the global absmax over one rank is the leaf's):
             every gradient of 4,096 elements or more is rounded to 255
             levels once, as JAX's train step does on that mesh.
  "ring8"  — the f32 cast (`ring_psum_int8` returns early for one rank).

Leaves with ``ndim == 0`` or fewer than 4,096 elements are never
compressed.  An initialised default process group of more than one rank
raises: the collectives across cards are ROADMAP Queue 1 item 6.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def _one_rank() -> None:
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            "repro_torch.distributed.collectives: gradient sync across "
            "ranks is not yet ported (ROADMAP Queue 1 item 6); the train "
            "step runs at one rank")


def psum_f32(x: torch.Tensor) -> torch.Tensor:
    _one_rank()
    return x.float()


def int8_psum(x: torch.Tensor) -> torch.Tensor:
    """Quantise with the (global) absmax / 127 scale, sum exactly in int32,
    dequantise: at one rank, the leaf rounded to 255 levels."""
    _one_rank()
    x = x.float()
    scale = torch.clamp(torch.max(torch.abs(x)) / 127.0, min=1e-30)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q.to(torch.int32).float() * scale


def ring_psum_int8(x: torch.Tensor) -> torch.Tensor:
    """Ring all-reduce with an int8 wire format: at one rank there is no
    hop, and the value is returned in f32."""
    _one_rank()
    return x.float()


def compressed_psum(g: torch.Tensor,
                    mode: Optional[str] = None) -> torch.Tensor:
    if mode is None or g.dim() == 0 or g.numel() < 4096:
        return psum_f32(g)
    if mode == "int8":
        return int8_psum(g)
    if mode == "ring8":
        return ring_psum_int8(g)
    raise ValueError(f"unknown grad-compression mode {mode!r}")
