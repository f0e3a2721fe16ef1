"""Carry the JAX package's parameters across: numpy tree -> the port's
modules, key for key and with no transposes (both packages keep
``x @ w`` with ``w`` of shape ``[d_in, d_out]``)."""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import TransformerParams, model_param_defs


def params_from_numpy(cfg: ArchConfig, tree: Mapping[str, Any], *,
                      device: torch.device | str = "cpu",
                      dtype: Optional[torch.dtype] = None) -> TransformerParams:
    """`tree` is the JAX param tree as numpy (``jax.tree.map(np.asarray,
    params)``; stage leaves ``[S, R, ...]``).  Raises on a missing or an
    extra key and on a shape that differs from `cfg`'s."""
    defs = model_param_defs(cfg)

    def walk(d: Mapping[str, Any], t: Mapping[str, Any], path: str):
        missing = sorted(set(d) - set(t))
        extra = sorted(set(t) - set(d))
        if missing or extra:
            raise KeyError(f"params_from_numpy at {path or '/'}: missing "
                           f"{missing}, extra {extra}")
        out = {}
        for k, leaf in d.items():
            where = f"{path}/{k}"
            if isinstance(leaf, tuple):
                a = np.asarray(t[k])
                if tuple(a.shape) != tuple(leaf[0]):
                    raise ValueError(f"params_from_numpy at {where}: shape "
                                     f"{a.shape}, expected {leaf[0]}")
                ten = torch.from_numpy(np.array(a, dtype=np.float32))
                out[k] = ten.to(device=device, dtype=dtype or
                                getattr(torch, cfg.dtype))
            else:
                if not isinstance(t[k], Mapping):
                    raise KeyError(f"params_from_numpy at {where}: expected "
                                   f"a subtree")
                out[k] = walk(leaf, t[k], where)
        return out

    return TransformerParams(walk(defs, tree, ""))


def shard_from_numpy(cfg: ArchConfig, tree: Mapping[str, Any], layout,
                     rank: int, *, device: torch.device | str = "cpu",
                     dtype: Optional[torch.dtype] = None
                     ) -> TransformerParams:
    """`params_from_numpy` of the whole tree, then rank `rank`'s shard of
    it over `layout` (`transformer.shard_params`): carries the JAX
    package's ``init_params`` tree onto every rank."""
    from repro_torch.models.transformer import shard_params

    full = params_from_numpy(cfg, tree, dtype=dtype)
    return shard_params(cfg, full, layout, rank, device=device)
