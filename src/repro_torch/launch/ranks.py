"""Start a layout of ranks as processes (the launchers' ``--pp``/``--tp``/
``--dp``): `spawn` runs ``fn(ranks, *args)`` on every rank of a
`launch.mesh.Layout`, each in a process of its own started with
``torch.multiprocessing`` (``spawn``), rendezvousing through a
``FileStore`` in a directory of the caller's (no TCP port to collide),
and returns every rank's result.  Under ``torchrun`` (its ``RANK`` /
``WORLD_SIZE`` in the environment) `from_env` joins the running group
instead.

A rank's exception fails the whole launch (`torch.multiprocessing` stops
the other ranks and raises it here); a launch that outlives `timeout_s`
is killed and raises `TimeoutError`, so a deadlock fails rather than
hangs.  Every collective has the group's timeout (`group_timeout_s`).
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import Layout, RankGroups, init_groups


def init(rank: int, layout: Layout, store_path: str, backend: str,
         group_timeout_s: float = 60.0) -> RankGroups:
    """Join the layout's default process group through the FileStore at
    `store_path` and create its axis groups."""
    timeout = datetime.timedelta(seconds=group_timeout_s)
    store = dist.FileStore(store_path, layout.world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=layout.world, timeout=timeout)
    return init_groups(layout, rank, backend, group_timeout_s)


def from_env(layout: Layout, backend: str,
             group_timeout_s: float = 60.0) -> RankGroups:
    """Under ``torchrun``: join its process group (``env://``) as rank
    ``RANK`` and create the layout's axis groups."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if world != layout.world:
        raise ValueError(f"torchrun started {world} ranks, the layout has "
                         f"{layout.world}")
    dist.init_process_group(
        backend, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=group_timeout_s))
    return init_groups(layout, rank, backend, group_timeout_s)


def _entry(rank: int, layout: Layout, store_dir: str, backend: str,
           threads: Optional[int], group_timeout_s: float) -> None:
    if threads:
        torch.set_num_threads(threads)
    with open(os.path.join(store_dir, "call.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    ranks = init(rank, layout, os.path.join(store_dir, "store"), backend,
                 group_timeout_s)
    try:
        out = fn(ranks, *args)
        with open(os.path.join(store_dir, f"result-{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, layout: Layout, args: Sequence[Any] = (), *,
          backend: str = "gloo", store_dir: Optional[str] = None,
          threads: Optional[int] = None, timeout_s: float = 600.0,
          group_timeout_s: float = 60.0) -> List[Any]:
    """Run ``fn(ranks, *args)`` on every rank of `layout`, one process
    each (`fn` a module-level function, picklable), and return the ranks'
    results in rank order.  `threads`: each rank's intra-op threads."""
    import torch.multiprocessing as mp

    own = store_dir is None
    store_dir = store_dir or tempfile.mkdtemp(prefix="ranks-")
    Path(store_dir).mkdir(parents=True, exist_ok=True)
    # `fn` and `args` go through a file, not the pipe each process is
    # started through: a start writes its arguments into that pipe, and
    # once they outgrow the pipe's buffer the write waits until the child
    # has imported its main module and reads them, which would start the
    # ranks one after the other
    with open(os.path.join(store_dir, "call.pkl"), "wb") as f:
        pickle.dump((fn, tuple(args)), f)
    ctx = mp.start_processes(
        _entry, args=(layout, store_dir, backend, threads, group_timeout_s),
        nprocs=layout.world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.1, min(
                5.0, deadline - time.monotonic()))):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{layout.world} ranks still running "
                                   f"after {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    out = []
    for r in range(layout.world):
        with open(os.path.join(store_dir, f"result-{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    if own:
        import shutil
        shutil.rmtree(store_dir, ignore_errors=True)
    return out


def run_each(ranks: RankGroups, jobs: Sequence[Tuple[Callable, Any]]
             ) -> List[Any]:
    """``fn(ranks, job)`` for each ``(fn, job)`` of `jobs` in turn on the
    same ranks (`spawn`'s `fn`, with ``args=(jobs,)``): one launch, so that
    the processes start and join their groups once for several runs.  Each
    run's device memory is returned to the card before the next."""
    import gc

    out = []
    for fn, job in jobs:
        out.append(fn(ranks, job))
        gc.collect()
        torch.cuda.empty_cache()
    return out
