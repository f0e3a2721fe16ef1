"""Rank functions of the rank tests and of chip_smoke's rank phases
(`launch.ranks.spawn`'s `fn`), in a module without JAX so that each
spawned rank imports only the port.

* `serve_rank` serves a batch on `PipelineEngine(ranks=)` directly, the
  engine `serving.build(spec, ranks=)` makes (rank 0 drives it through
  `leading`, which records every tick's batch and each row's data replica;
  the other ranks serve it through `runtime.engine.serve_engines`), with
  moves out and in, several runs on one shard.
* `scenario_rank` is `serve_rank` with scenarios the launcher has no use
  for: a snapshot mid-run, a rank -> rank move within one spawn, and the
  router over the rank engine and a one-process engine.
* `serving_rank` serves specs through `serving.build(spec, ranks=)`:
  one engine with its HTTP front end and an idle wait, two engines behind
  the router with a live migration, a disaggregated pair.
* `failed_save_rank` saves a checkpoint across the ranks with one rank's
  writes failing, as on a full disk.
"""

import contextlib
import copy
import dataclasses
import errno
import json
import os
import time
import urllib.request

import torch

from repro_torch.core import SamplingParams
from repro_torch.launch import serve
from repro_torch.runtime.engine import PipelineEngine


def job_shard(ranks, job: dict) -> tuple:
    """This rank's device and dtype, its shard of the job's weights
    (`launch.serve.rank_shard` of ``cfg``, ``device``, ``dtype``, ``seed``
    or ``npz``), and the keys every result of the rank carries:
    ``(device, dtype, params, keys)``."""
    cfg = job["cfg"]
    dtype = getattr(torch, job.get("dtype", cfg.dtype))
    t0 = time.perf_counter()
    dev, params = serve.rank_shard(ranks, cfg,
                                   device=job.get("device", "cuda"),
                                   dtype=dtype, seed=job.get("seed", 0),
                                   npz=job.get("npz"))
    keys = {"rank": ranks.rank, "coords": ranks.coords,
            "weight_bytes": sum(t.numel() * t.element_size()
                                for t in params.parameters()),
            "params_s": time.perf_counter() - t0}
    return dev, dtype, params, keys


def _device_counts(out: dict, dev: torch.device) -> dict:
    """`out` with the kernels' launches and the run's peak memory."""
    from repro_torch.kernels import ops

    out["launches"] = {m.__name__.split(".")[-1]: m.launches
                       for m in ops.COUNTED}
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else None)
    return out


def follow_run(ranks, run: dict, params, dev: torch.device,
               dtype: torch.dtype) -> dict:
    """A rank other than 0's part of one run: it serves rank 0's one engine
    (`runtime.engine.serve_engines`) until rank 0 stops it.  Its rank
    stats, launches and peak memory."""
    from repro_torch.runtime.engine import serve_engines

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    stats, = serve_engines(run["cfg"], run["dims"], params, ranks=ranks,
                           device=dev, dtype=dtype, seed=run.get("seed", 0),
                           bucketed=run.get("bucketed", False))
    return _device_counts({"rank_stats": stats.as_dict()}, dev)


@contextlib.contextmanager
def leading(ranks, run: dict, params, dev: torch.device,
            dtype: torch.dtype):
    """Rank 0's `PipelineEngine(ranks=)` for one run, its counters at 0,
    recording the entering batch of every tick (each prefill row's request,
    start and length; each decode row's request) and each row's data
    replica.  Yields ``(engine, requests, result)``: the caller drives the
    engine and puts each of its requests in ``requests``.  On leaving, the
    engine stops its ranks and closes its trace; on a clean exit
    ``result`` then holds the tokens, whether each request finished, the
    ticks and replicas, the engine's stats, its prefix hits and tokens,
    the rank stats, the launches, the peak memory, the seconds to build the
    engine and the wall time."""
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng = PipelineEngine(
        run["cfg"], run["dims"], params, run["throttle"], device=dev,
        dtype=dtype, seed=run.get("seed", 0),
        bucketed=run.get("bucketed", False),
        async_dispatch=run.get("async_dispatch", False),
        enable_prefix_caching=run.get("enable_prefix_caching", False),
        trace_path=run.get("trace_out"), cuda_graphs=False, ranks=ranks)
    out = {"engine_s": time.perf_counter() - t0}
    backend = eng.backend
    ticks, homes = [], []
    inner = backend.execute

    def execute(ring, exiting_id, now):
        b = (eng.scheduler.get_batch(ring[0][0])
             if ring[0][0] is not None else None)
        ticks.append(None if b is None else [
            [[q.request.request_id, q.start_pos, q.num_tokens]
             for q in b.prefill],
            [q.request.request_id for q in b.decode]])
        homes.append(None if b is None else [
            [eng.kv.replica_of(q.request.request_id) for q in rows]
            for rows in (b.prefill, b.decode)])
        return inner(ring, exiting_id, now)

    backend.execute = execute
    backend.reset_counters()
    reqs: list = [None] * len(run["prompts"])
    t0 = time.perf_counter()
    try:
        yield eng, reqs, out
    finally:
        backend.stop()
        if eng.recorder is not None:
            eng.recorder.close()
    if cuda:
        torch.cuda.synchronize(dev)
    out.update(
        tokens=[r.output_token_ids for r in reqs],
        finished=[r.is_finished for r in reqs], ticks=ticks,
        replicas=homes, wall_s=time.perf_counter() - t0,
        stats=dataclasses.asdict(eng.stats),
        prefix=dict(hits=eng.scheduler.stats.prefix_hits,
                    tokens=eng.scheduler.stats.prefix_tokens_avoided),
        rank_stats=backend.rank_stats.as_dict())
    _device_counts(out, dev)


def _lead_run(ranks, run: dict, params, dev: torch.device,
              dtype: torch.dtype) -> dict:
    """Rank 0's part of one run of `serve_rank`."""
    n = len(run["prompts"])
    temps = run.get("temps") or [0.0] * n
    encs = run.get("encs") or [None] * n
    arrive = list(run.get("arrive") or [0] * n)
    export = dict(run.get("export") or {})
    moved, move_s, moved_in = [], [], []
    with leading(ranks, run, params, dev, dtype) as (eng, reqs, out):
        for m in run.get("imports") or ():
            t1 = time.perf_counter()
            moved_in.append(serve.move_in(eng, m))
            move_s.append(("in", time.perf_counter() - t1))
        steps, limit = 0, run.get("max_ticks", 100000)
        while steps < limit and (any(a is not None for a in arrive)
                                 or eng.loop.has_work):
            for i, a in enumerate(arrive):
                if a is not None and steps >= a:
                    reqs[i] = eng.add_request(
                        run["prompts"][i], SamplingParams(
                            max_new_tokens=run["max_new"],
                            temperature=temps[i]),
                        request_id=f"r{i}", **({} if encs[i] is None
                                               else {"enc_embeds": encs[i]}))
                    arrive[i] = None
            for rid, at in list(export.items()):
                req = reqs[int(rid[1:])]
                if steps >= at if isinstance(at, int) else (
                        req is not None
                        and req.num_output_tokens >= at["tokens"]):
                    t1 = time.perf_counter()
                    m = serve.move_out(eng, rid)
                    if m is not None:
                        if dev.type == "cuda":
                            torch.cuda.synchronize(dev)
                        move_s.append(("out", time.perf_counter() - t1))
                        moved.append(m)
                        del export[rid]
            eng.step()
            steps += 1
    out.update(moved=moved, move_s=move_s,
               moved_in={r.request_id: r.output_token_ids for r in moved_in})
    return out


def serve_runs(ranks, job: dict, dev: torch.device, dtype: torch.dtype,
               params) -> list:
    """`serve_rank`'s runs on a drawn shard (`job_shard`): each run's
    result on this rank."""
    return [follow_run(ranks, {**job, **over}, params, dev, dtype)
            if ranks.rank else
            _lead_run(ranks, {**job, **over}, params, dev, dtype)
            for over in job.get("runs") or [{}]]


def serve_rank(ranks, job: dict) -> dict:
    """One rank of a served batch (`launch.ranks.spawn`'s `fn`).  `job`:
    ``cfg`` (staged at pp = the layout's stages), ``dims``, ``throttle``,
    ``prompts`` (request ``r{i}`` each), ``max_new``, optional ``temps``
    (one per prompt), ``encs`` (an encoder-decoder's encoder input [Te, d]
    per prompt) and ``arrive`` (the step each prompt is added at, default
    0), ``device`` ("cuda" or "cpu"), ``dtype``, ``seed`` or ``npz``,
    ``bucketed``, ``async_dispatch``, ``enable_prefix_caching``,
    ``trace_out`` (rank 0's trace file), and moves: ``export`` ({request
    id: step, or {"tokens": n}}: taken off the engine by `move_out` at the
    first step from that step, or from when it holds n tokens, at which it
    is not in flight) and ``imports`` (`move_out` moves, resumed by
    `move_in` before the first step).  With ``runs``, a list of dicts of
    those keys, each run overrides the job's keys and runs on the same
    shard, one engine after the other.

    Rank 0 drives a `PipelineEngine(ranks=)` over each run (`leading`) and
    returns what `leading` records, the moves out (``moved``), the outputs
    of the requests moved in (``moved_in``) and each move's seconds
    (``move_s``); every other rank serves it (`follow_run`) and returns
    its rank stats, launches and peak memory.  Every rank also returns the
    seconds its shard took to draw (`job_shard`).  With ``runs``, each
    run's result is in ``runs``."""
    dev, dtype, params, keys = job_shard(ranks, job)
    results = serve_runs(ranks, job, dev, dtype, params)
    if "runs" in job:
        return {**keys, "runs": results}
    return {**keys, **results[0]}


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
    dev, dtype, params, keys = job_shard(ranks, job)
    results = []
    for over in job["runs"]:
        run = {**job, **over}
        results.append(
            follow_run(ranks, run, params, dev, dtype) if ranks.rank
            else _lead(ranks, run, params, dev, dtype,
                       results[-1] if results else None))
    return {**keys, "runs": results}


def _local_engine(run: dict, dev, dtype):
    """A one-process engine on the whole tree the ranks' shards were cut
    from, at the same stage count."""
    from repro_torch.models.convert import params_from_numpy

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
    with leading(ranks, run, params, dev, dtype) as (eng, reqs, out):
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


def serving_rank(ranks, job: dict) -> dict:
    """The serving stack over the ranks: for each of ``runs`` (each a
    ``spec`` JSON and a scenario ``do``), rank 0 builds the server with
    `build(spec, ranks=)` on the job's ``npz`` and drives it; every other
    rank serves it through `serve_worker` (its engines' rank stats).
    Scenarios: "one" (the ``prompts`` to the end, then through
    `HTTPFrontend` a generate, a stream, an abort of a long stream and the
    stats, an idle wait of ``idle_wait`` seconds, a request served after
    it, the front end's shutdown and a second `close()`), "router" (the
    ``prompts`` behind the router, request ``migrate`` moved to the other
    engine once it holds 2 tokens) and "disagg" (the ``prompts``, handed
    off from the prefill engine to the decode engine), "stream" (the
    ``prompts`` to the end, then the first streamed through `HTTPFrontend`).
    The job may also set ``device`` (default "cpu"), ``dtype`` and
    ``layers`` (`build`'s depth cut); without ``npz`` the weights are drawn
    from the spec's seed."""
    from repro_torch.serving import ServeSpec
    from repro_torch.serving.build import build, serve_worker

    kw = dict(device=job.get("device", "cpu"), npz=job.get("npz"),
              layers=job.get("layers", 0),
              dtype=getattr(torch, job["dtype"]) if job.get("dtype")
              else None)
    results = []
    for run in job["runs"]:
        spec = ServeSpec.from_json(run["spec"])
        if ranks.rank:
            results.append(serve_worker(spec, ranks, **kw))
            continue
        server = build(spec, ranks=ranks, cuda_graphs=False, **kw)
        with server:
            results.append(_SCENARIOS[run["do"]](server, job, run))
    return {"rank": ranks.rank, "runs": results}


def _submit_all(server, prompts, max_new):
    return [server.submit(p, SamplingParams(max_new_tokens=max_new),
                          request_id=f"r{i}") for i, p in enumerate(prompts)]


def _threads_of(backend, seen: dict) -> None:
    """Record, per thread, whether each tick it ran was in inference mode
    on the backend's device and stream (`_on_stream` entered)."""
    import threading

    inner_run, inner_stream = backend._run, backend._on_stream
    depth = threading.local()

    @contextlib.contextmanager
    def on_stream():
        depth.n = getattr(depth, "n", 0) + 1
        try:
            with inner_stream():
                yield
        finally:
            depth.n -= 1

    def run(prog):
        name = threading.current_thread().name
        ok = torch.is_inference_mode_enabled() and getattr(depth, "n", 0)
        seen[name] = seen.get(name, True) and bool(ok)
        return inner_run(prog)

    backend._on_stream, backend._run = on_stream, run


def _one(server, job, run) -> dict:
    import threading
    import time

    from repro_torch.serving import HTTPFrontend

    eng = server.replicas[0]
    seen: dict = {}
    _threads_of(eng.backend, seen)
    rids = _submit_all(server, job["prompts"], job["max_new"])
    server.drain()
    out = {"tokens": [o.token_ids for o in server.outputs(rids)]}
    fe = HTTPFrontend(server, host="127.0.0.1", port=0).start()
    try:
        def post(path, body, method="POST"):
            req = urllib.request.Request(
                fe.url + path, method=method,
                data=None if body is None else json.dumps(body).encode())
            with urllib.request.urlopen(req, timeout=60) as resp:
                return json.loads(resp.read())

        def sse(body):
            req = urllib.request.Request(
                fe.url + "/v1/generate?stream=1", method="POST",
                data=json.dumps(body).encode())
            with urllib.request.urlopen(req, timeout=60) as resp:
                for line in resp:
                    line = line.decode().strip()
                    if line.startswith("data: "):
                        yield json.loads(line[len("data: "):])

        p = job["prompts"]
        out["http_generate"] = post("/v1/generate", {
            "prompt": p[0], "max_new_tokens": job["max_new"]})["token_ids"]
        frames = list(sse({"prompt": p[1], "max_new_tokens": job["max_new"]}))
        out["http_stream"] = [f["token"] for f in frames
                              if f["token"] is not None]
        out["stream_end"] = frames[-1]["finish_reason"]
        free = eng.kv.num_free_pages
        victim = sse({"prompt": p[2], "max_new_tokens": 300,
                      "request_id": "victim"})
        first = next(victim)
        aborter = threading.Thread(target=post, args=(
            "/v1/requests/victim", None, "DELETE"))
        aborter.start()
        rest = [first] + list(victim)
        aborter.join(timeout=60)
        out["abort_end"] = rest[-1]["finish_reason"]
        out["abort_frames"] = len(rest)
        out["pages_back"] = (eng.kv.num_free_pages == free
                             and not eng.kv.has_request("victim"))
        out["stats_requests"] = post("/v1/stats", None, "GET")
        sent = server.idle_sent
        time.sleep(job["idle_wait"])
        out["idle_sent"] = server.idle_sent - sent
        out["after_idle"] = post("/v1/generate", {
            "prompt": p[3], "max_new_tokens": job["max_new"]})["token_ids"]
    finally:
        fe.shutdown()               # closes the server: the workers stop
    server.close()                  # a second close does nothing
    out["threads"] = seen
    out["stopped"] = all(link.stopped for link in server.links)
    return out


def _router(server, job, run) -> dict:
    router = server.router
    rids = _submit_all(server, job["prompts"], job["max_new"])
    req = server._requests[run["migrate"]]
    moved = None
    for _ in range(400):
        if moved is None and req.num_output_tokens >= 2:
            src = next(i for i, e in enumerate(router.replicas)
                       if e.scheduler.kv.has_request(req.request_id))
            if router.migrate_request(req.request_id, src, 1 - src):
                moved = [src, 1 - src, req.num_output_tokens]
        if not server.has_work:
            break
        server.step()
    server.drain()
    return {"tokens": [o.token_ids for o in server.outputs(rids)],
            "routed": list(router.routed_counts), "moved": moved,
            "migrated": router.rebalance_stats.migrated,
            "finished_on": [sorted(r.request_id for r in e.finished)
                            for e in router.replicas]}


def _disagg(server, job, run) -> dict:
    rids = _submit_all(server, job["prompts"], job["max_new"])
    server.drain()
    st = server.stats()
    return {"tokens": [o.token_ids for o in server.outputs(rids)],
            "routed": st.routed_counts, "handoffs": st.disagg.handoffs,
            "fallbacks": st.disagg.fallbacks,
            "finished_on": [sorted(r.request_id for r in e.finished)
                            for e in server.replicas]}


def _stream(server, job, run) -> dict:
    from repro_torch.serving import HTTPFrontend

    rids = _submit_all(server, job["prompts"], job["max_new"])
    server.drain()
    out = {"tokens": [o.token_ids for o in server.outputs(rids)]}
    fe = HTTPFrontend(server, host="127.0.0.1", port=0).start()
    try:
        req = urllib.request.Request(
            fe.url + "/v1/generate?stream=1", method="POST",
            data=json.dumps({"prompt": job["prompts"][0],
                             "max_new_tokens": job["max_new"]}).encode())
        with urllib.request.urlopen(req, timeout=120) as resp:
            frames = [json.loads(line.decode().strip()[len("data: "):])
                      for line in resp
                      if line.decode().startswith("data: ")]
    finally:
        fe.shutdown()
    out["http_stream"] = [f["token"] for f in frames
                          if f["token"] is not None]
    out["stream_end"] = frames[-1]["finish_reason"]
    return out


_SCENARIOS = {"one": _one, "router": _router, "disagg": _disagg,
              "stream": _stream}
