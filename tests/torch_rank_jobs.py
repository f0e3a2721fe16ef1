"""Rank functions of the rank-state tests (`launch.ranks.spawn`'s `fn`),
in a module without JAX so that each spawned rank imports only the port.

* `scenario_rank` is `launch.serve.serve_rank` with scenarios the
  launcher has no use for: a snapshot mid-run, a rank -> rank move within
  one spawn, and the router over the rank engine and a one-process engine.
* `failed_save_rank` saves a checkpoint across the ranks with one rank's
  writes failing, as on a full disk.
"""

import copy
import errno
import os

from repro_torch.core import SamplingParams
from repro_torch.launch import serve


def scenario_rank(ranks, job: dict) -> dict:
    """`serve_rank` over ``runs`` (each run on the job's prompts, requests
    ``r{i}``, greedy, with its ``arrive``, ``export`` at a step,
    ``imports``, ``async_dispatch``, ``enable_prefix_caching`` and
    ``trace_out``), where a run may also take ``snapshot`` (a step:
    `snapshot_state` there, in the result's ``snapshot``), ``imports:
    "previous"`` (the run before's moves out, resumed as copies) and
    ``router`` ({"moves": [[step, request id, src, dst], ...]}: rank 0
    builds a one-process engine on the whole tree, ``npz``, and a
    `ReplicaRouter` over [the rank engine, it], whose `migrate_request`
    moves each request at its step or the first after it that it can; the
    result's ``local`` holds that engine's finished outputs and
    ``migrated`` the router's count)."""
    dev, dtype, params, keys = serve.rank_shard(ranks, job)
    results = []
    for over in job["runs"]:
        run = {**job, **over}
        results.append(
            serve.follow_run(ranks, run, params, dev, dtype) if ranks.rank
            else _lead(ranks, run, params, dev, dtype,
                       results[-1] if results else None))
    return {**keys, "runs": results}


def _local_engine(run: dict, dev, dtype):
    """A one-process engine on the whole tree the ranks' shards were cut
    from, at the same stage count."""
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.runtime.engine import PipelineEngine

    cfg = run["cfg"].with_plan(tp=1)
    params = params_from_numpy(cfg, serve.npz_tree(run["npz"]), device=dev,
                               dtype=dtype)
    return PipelineEngine(cfg, run["dims"], params, run["throttle"],
                          device=dev, dtype=dtype, cuda_graphs=False)


def _lead(ranks, run: dict, params, dev, dtype, previous) -> dict:
    from repro_torch.runtime.router import ReplicaRouter

    n = len(run["prompts"])
    arrive = list(run.get("arrive") or [0] * n)
    export = dict(run.get("export") or {})
    imports = run.get("imports") or ()
    if imports == "previous":
        # copies: a moved request shares its token list with the result of
        # the run before, which resuming it would grow
        imports = copy.deepcopy(previous["moved"])
    moves = [list(m) for m in (run.get("router") or {}).get("moves", ())]
    moved, local, router = [], None, None
    with serve.leading(ranks, run, params, dev, dtype) as (eng, reqs, out):
        if moves:
            local = _local_engine(run, dev, dtype)
            router = ReplicaRouter([eng, local])
        engines = [eng] + ([local] if local is not None else [])
        moved_in = [serve.move_in(eng, m) for m in imports]
        steps = 0
        while any(a is not None for a in arrive) or any(
                e.loop.has_work for e in engines):
            for i, a in enumerate(arrive):
                if a is not None and steps >= a:
                    reqs[i] = eng.add_request(
                        run["prompts"][i],
                        SamplingParams(max_new_tokens=run["max_new"]),
                        request_id=f"r{i}")
                    arrive[i] = None
            for m in moves:
                if m[0] is not None and steps >= m[0] and \
                        router.migrate_request(m[1], m[2], m[3]):
                    m[0] = None
            for rid, at in list(export.items()):
                m = serve.move_out(eng, rid) if steps >= at else None
                if m is not None:
                    moved.append(m)
                    del export[rid]
            if run.get("snapshot") == steps:
                out["snapshot"] = eng.snapshot_state()
            for e in engines:
                e.step()
            steps += 1
    out.update(moved=moved,
               moved_in={r.request_id: r.output_token_ids for r in moved_in})
    if router is not None:
        out["migrated"] = router.rebalance_stats.migrated
        out["local"] = {r.request_id: r.output_token_ids
                        for r in local.finished}
    return out


def failed_save_rank(ranks, job: dict) -> dict:
    """Save this rank's shard of ``cfg`` across the ranks under ``dir``,
    once by `save_checkpoint_ranks` (``dir``/sync) and once by
    `AsyncCheckpointer(ranks=)` (``dir``/async), with rank 1's block
    writes failing as on a full disk: the name of what each save raised on
    this rank (None when it returned)."""
    from repro_torch.models.transformer import init_params
    from repro_torch.runtime import checkpoint as ckpt

    cfg = job["cfg"]
    params = init_params(cfg, 0, layout=ranks.layout, rank=ranks.rank)
    if ranks.rank == 1:
        def full(*_args, **_kw):
            raise OSError(errno.ENOSPC, "No space left on device")
        ckpt._write_blocks = full

    def at_once(d):
        ckpt.save_checkpoint_ranks(d, params, cfg, ranks)

    def in_background(d):
        writer = ckpt.AsyncCheckpointer(ranks=ranks, cfg=cfg)
        try:
            writer.submit(d, params)
            writer.wait()
        finally:
            writer.close()

    out = {}
    for name, save in (("sync", at_once), ("async", in_background)):
        try:
            save(os.path.join(job["dir"], name))
            out[name] = None
        except Exception as e:  # noqa: BLE001
            out[name] = type(e).__name__
    return out
