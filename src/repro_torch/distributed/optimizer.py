"""Adam (``repro.distributed.optimizer``), in place on the parameter tree.

The arithmetic is the JAX package's: the global gradient norm clips the
step (``scale = min(1, clip / max(gnorm, 1e-9))``), the bias corrections
``1 - b ** step`` are taken in f32, and each update is computed in f32 and
cast to the parameter's dtype.  There are no f32 master weights: a bf16
tree stays bf16, as the JAX package's does.  The moments ``m`` and ``v``
are f32 trees (nested dicts) mirroring the parameters.

Where JAX returns new trees, this updates the parameters and the moments in
place under ``torch.no_grad()`` (one f32 temporary per leaf), and returns
them.  A gradient of None counts as zero (a leaf that no row reached),
which is what JAX's autodiff gives there.  The JAX module's
dry-run helpers have no counterpart: `adam_init` of a rank's tree of meta
tensors is the abstract state (`launch.dryrun`), and a rank's moments
mirror its own shard, so they need no sharding specs.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.transformer import tree_items, tree_map


class AdamConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0


class AdamState(NamedTuple):
    step: torch.Tensor          # int32 scalar on the parameters' device
    m: Any
    v: Any


def adam_init(params) -> AdamState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = next(t for _, t in tree_items(params)).device
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                     m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (None leaves add
    nothing)."""
    sq = [torch.sum(torch.square(g.float())) for _, g in tree_items(tree)
          if g is not None]
    return torch.sqrt(torch.stack(sq).sum())


@torch.no_grad()
def adam_update(cfg: AdamConfig, grads, params, state: AdamState,
                gnorm: Optional[torch.Tensor] = None
                ) -> Tuple[Any, AdamState, torch.Tensor]:
    """One Adam step: `params` and `state`'s moments updated in place.
    Returns (params, the state with its step advanced, gnorm)."""
    if gnorm is None:
        gnorm = global_norm(grads)
    if cfg.grad_clip > 0:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    else:
        scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
    step = state.step + 1
    stepf = step.float()
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=stepf.device), stepf)
    grads = dict(tree_items(grads))
    moments = zip(tree_items(params), tree_items(state.m),
                  tree_items(state.v))
    for (path, p), (_, m), (_, v) in moments:
        g = grads[path]
        g = (torch.zeros_like(m) if g is None else g.float()) * scale
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        del g
        u = (m / b1c).div_(torch.sqrt(v / b2c).add_(cfg.eps))
        if cfg.weight_decay:
            u.add_(p.float(), alpha=cfg.weight_decay)
        p.copy_(u.mul_(-cfg.lr).add_(p.float()))
    return params, AdamState(step=step, m=state.m, v=state.v), gnorm
