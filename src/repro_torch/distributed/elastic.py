"""Re-staging a model between pipeline factorings
(``repro.distributed.elastic``: `replan` and `repartition_params`).

Parameters are stored logically, stacked ``[S, R, ...]`` per block group.
A uniform pattern (one `BlockSpec`) re-tiles its ``S * R`` stacked layers
into ``[S', R']`` by a pure reshape; a heterogeneous pattern (jamba's
interleave, a depth cut of several kinds) keeps its stage structure, so only
its tp factor may change.  On one card the reshape of a contiguous tensor
is a view: engines at pp=1 and at pp=4 serve from one set of weights.

`elastic_restore` loads a checkpoint saved under one factoring into
another: restored against the old config's tree, re-tiled, and placed on
the device.  `rank_restore` does so for one rank of a layout: only its
block of each leaf is read (`checkpoint.restore_checkpoint(layout=)`), a
stage leaf saved at another stage count seen re-tiled first.

Across ranks, `replan_to` re-plans a config onto a rank layout's stage and
tensor sizes, and `shard_views` (defined beside `transformer.shard_params`,
which copies its blocks) gives one rank's block of every leaf
(`transformer.shard_slices`) as views of a whole tree: the weights of one
stage at one tensor shard, with no copy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, BlockSpec
from repro_torch.models.transformer import (
    TransformerParams,
    abstract_params,
    check_shardable,
    param_pspecs,
    shard_views,  # noqa: F401  (re-exported)
    tree_map,
)


def replan(cfg: ArchConfig, new_pp: int, new_tp: int) -> ArchConfig:
    """A config with the same architecture on a different (pp, tp) grid."""
    if len(cfg.pattern) == 1:
        total = cfg.layers_per_stage * cfg.plan.pp
        if total % new_pp:
            raise ValueError(f"{total} stacked layers don't tile pp={new_pp}")
        pattern = (BlockSpec(cfg.pattern[0].kind, total // new_pp),)
    else:
        if new_pp != cfg.plan.pp:
            raise ValueError(
                f"{cfg.name}: heterogeneous pattern is pinned to pp={cfg.plan.pp}")
        pattern = cfg.pattern
    return dataclasses.replace(
        cfg, pattern=pattern,
        plan=dataclasses.replace(cfg.plan, pp=new_pp, tp=new_tp))


def replan_to(cfg: ArchConfig, layout) -> ArchConfig:
    """`replan` onto a rank layout (`launch.mesh.Layout`): its stage and
    tensor sizes."""
    return replan(cfg, layout.size("stage"), layout.size("tensor"))


def repartition_params(params: TransformerParams, cfg_old: ArchConfig,
                       cfg_new: ArchConfig) -> TransformerParams:
    """`params` with every stacked stage leaf ``[S, R, ...]`` seen as
    ``[S', R', ...]``: views of the same storage (no copy), the embedding,
    final norm and head shared as they are.  Unchanged when the pattern and
    the stage count are."""
    if cfg_old.pattern == cfg_new.pattern and \
            cfg_old.plan.pp == cfg_new.plan.pp:
        return params
    s2 = cfg_new.plan.pp

    def view(x: torch.Tensor) -> torch.Tensor:
        s, r = x.shape[:2]
        if (s * r) % s2:
            raise ValueError(f"{s * r} stacked layers don't tile pp={s2}")
        return x.view((s2, s * r // s2) + tuple(x.shape[2:]))

    stages = {g: {n: view(t) for n, t in leaves.items()}
              for g, leaves in params["stages"].items()}
    return TransformerParams({k: stages if k == "stages" else dict(v.items())
                              for k, v in params.items()})


def elastic_restore(ckpt_dir: str, cfg_old: ArchConfig, cfg_new: ArchConfig,
                    *, device: torch.device | str = "cpu",
                    dtype: Optional[torch.dtype] = None) -> TransformerParams:
    """The checkpoint at `ckpt_dir`, saved under `cfg_old`, as `cfg_new`'s
    parameters on `device` (in `dtype`, or as saved)."""
    from repro_torch.runtime.checkpoint import restore_checkpoint

    host = restore_checkpoint(ckpt_dir, abstract_params(cfg_old))
    host = repartition_params(host, cfg_old, cfg_new)
    return TransformerParams(tree_map(
        lambda t: t.to(device=device, dtype=dtype or t.dtype), host))


def rank_restore(ckpt_dir: str, cfg: ArchConfig, layout, rank: int, *,
                 device: torch.device | str = "cpu",
                 dtype: Optional[torch.dtype] = None) -> TransformerParams:
    """Rank `rank`'s shard of `cfg` over `layout` from the checkpoint at
    `ckpt_dir`, saved at any data and tensor factoring, and at any stage
    count that `replan` can re-tile to `cfg`'s (a uniform pattern), on
    `device` in `dtype` (or as saved)."""
    from repro_torch.runtime.checkpoint import restore_checkpoint

    check_shardable(cfg, layout)
    host = restore_checkpoint(ckpt_dir, abstract_params(cfg), layout=layout,
                              rank=rank, specs=param_pspecs(cfg),
                              retile=len(cfg.pattern) == 1)
    return TransformerParams(tree_map(
        lambda t: t.to(device=device, dtype=dtype or t.dtype), host))
