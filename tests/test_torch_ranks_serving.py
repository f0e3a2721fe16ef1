"""The serving stack over a layout of ranks on the CPU (gloo), against the
JAX package's serving stack on the same spec JSON: `build(spec, ranks=)`,
`LLMServer` and `HTTPFrontend` over rank engines, two engines on one
layout behind the router (a live migration, a disaggregated hand-off), the
idle command that keeps the worker ranks alive, `close()` ending them, and
the launcher's spec over ranks with traces.

The reduced qwen1.5-0.5b at pp=2 x tp=2 (4 ranks, one spawn: the runs of
`torch_rank_jobs.serving_rank`) on JAX's ``init_params`` weights (saved as
npz, re-tiled for pp=2, a pure reshape).  A reduced spec serves its two
stacked layers at pp=2 but one at pp=1, where JAX's `build` serves it, so
the reference at pp=2 x tp=2 is JAX's serving stack on the same spec with
JAX engines of those two layers in one stage: JAX's `LLMServer` over one
engine or over `build`'s own `_wrap_router` of the spec's cluster.  The
greedy tokens, the router's placement (every request submitted before the
first step), the migration and the hand-offs do not depend on the depth.
The launcher's run at tp=2 (one stage, one layer) is held to JAX's
`build(spec)` itself.  The spawn's group timeout is `GROUP_TIMEOUT_S`, so
an idle wait of more than twice that fails unless the idle command keeps
the workers waiting.
"""

import importlib
import json
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from repro.core import SamplingParams as JSamplingParams
from repro.distributed.elastic import replan as jax_replan
from repro.jax_compat import ensure_jax_compat
from repro.models import transformer as jtfm
from repro.models.serve import ServeDims as JServeDims
from repro.runtime.engine import PipelineEngine as JaxEngine
from repro.serving import ClusterSpec as JClusterSpec
from repro.serving import EngineSpec as JEngineSpec
from repro.serving import HandoffPolicy as JHandoffPolicy
from repro.serving import ServeSpec as JServeSpec
from repro.serving.server import LLMServer as JLLMServer
from repro_torch.launch import ranks as rk
from repro_torch.launch import serve as launcher
from repro_torch.launch.mesh import rank_layout
from repro_torch.runtime.trace import Trace, replay_trace
from test_torch_ranks import _jax_cfg
from test_torch_ranks_state import _retile, _save_npz
from torch_rank_jobs import serving_rank

ensure_jax_compat()
# the module (the package's `build` is its function)
jb = importlib.import_module("repro.serving.build")

QWEN = "qwen1.5-0.5b"
MAX_NEW = 5
GROUP_TIMEOUT_S = 4.0
IDLE_WAIT_S = 2 * GROUP_TIMEOUT_S + 1.0
MIGRATE = "r2"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [[int(t) for t in rng.integers(0, vocab, n)]
            for n in (9, 21, 30, 5, 14, 40, 7, 26)]


def _specs():
    """The three specs, as the JAX package writes them."""
    engine = JEngineSpec(arch=QWEN, reduced=True)
    return {"one": JServeSpec(engine=engine),
            "router": JServeSpec(engine=engine, cluster=JClusterSpec(
                replicas=2, route="balanced")),
            "disagg": JServeSpec(engine=engine, cluster=JClusterSpec(
                replicas=2, roles=("prefill", "decode"),
                handoff=JHandoffPolicy(interval=1e-4)))}


def _jax_router(srv, prompts):
    """`torch_rank_jobs._router` on a JAX server."""
    router = srv.router
    rids = [srv.submit(p, JSamplingParams(max_new_tokens=MAX_NEW),
                       request_id=f"r{i}") for i, p in enumerate(prompts)]
    req = srv._requests[MIGRATE]
    moved = None
    for _ in range(400):
        if moved is None and req.num_output_tokens >= 2:
            src = next(i for i, e in enumerate(router.replicas)
                       if e.scheduler.kv.has_request(MIGRATE))
            if router.migrate_request(MIGRATE, src, 1 - src):
                moved = [src, 1 - src]
        if not srv.has_work:
            break
        srv.step()
    srv.drain()
    return {"tokens": [o.token_ids for o in srv.outputs(rids)],
            "routed": list(router.routed_counts), "moved": moved,
            "migrated": router.rebalance_stats.migrated,
            "finished_on": [sorted(r.request_id for r in e.finished)
                            for e in router.replicas]}


def _jax_server(spec, params, mesh, jcfg):
    """JAX's `build(spec)` on JAX engines of `jcfg` (`params`): the spec's
    replicas behind `_wrap_router`, or one engine."""
    th = jb._throttle_config(spec, 1, reduced=True)
    engines = [JaxEngine(jcfg, JServeDims(**jb._REDUCED_DIMS, Te=0), params,
                         mesh, th) for _ in range(spec.num_replicas)]
    if spec.cluster is None:
        return JLLMServer(engines[0], spec=spec, cfg=jcfg)
    return JLLMServer(jb._wrap_router(spec, engines, None), spec=spec,
                      cfg=jcfg)


def _jax_all(srv, prompts):
    rids = [srv.submit(p, JSamplingParams(max_new_tokens=MAX_NEW),
                       request_id=f"r{i}") for i, p in enumerate(prompts)]
    srv.drain()
    return [o.token_ids for o in srv.outputs(rids)]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """JAX's serving stack on the three specs with engines of the reduced
    config's two layers: the tokens, the router's placement and migration,
    the hand-offs; the weights as npz for pp=2."""
    specs = _specs()
    jcfg = jax_replan(_jax_cfg(QWEN, 2, 1), 1, 1)
    mesh = jax.make_mesh((1, 1, 1), ("data", "stage", "tensor"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)
    prompts = _prompts(jcfg.vocab_size)
    out = {"prompts": prompts}
    with jax.set_mesh(mesh):
        params = jtfm.init_params(jcfg, jax.random.key(0), dtype=jnp.float32)
        params = jax.tree.map(
            lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
            params, jtfm.param_pspecs(jcfg),
            is_leaf=lambda x: isinstance(x, P))
        out["tokens"] = _jax_all(_jax_server(specs["one"], params, mesh,
                                             jcfg), prompts)
        out["router"] = _jax_router(_jax_server(specs["router"], params,
                                                mesh, jcfg), prompts)
        dis = _jax_server(specs["disagg"], params, mesh, jcfg)
        toks = _jax_all(dis, prompts)
        st = dis.stats()
        out["disagg"] = {"tokens": toks, "routed": st.routed_counts,
                         "handoffs": st.disagg.handoffs,
                         "finished_on": [sorted(r.request_id
                                                for r in e.finished)
                                         for e in dis.replicas]}
    out["dir"] = tmp_path_factory.mktemp("ranks_serving")
    out["npz"] = str(out["dir"] / "w2.npz")
    _save_npz(_retile(jax.tree.map(np.asarray, params), 2), out["npz"])
    out["specs"] = {k: s.to_json() for k, s in specs.items()}
    return out


@pytest.fixture(scope="module")
def ranks(ref):
    """One spawn of pp=2 x tp=2 at a group timeout of `GROUP_TIMEOUT_S`:
    the three scenarios, each on a server of its own."""
    job = dict(npz=ref["npz"], prompts=ref["prompts"], max_new=MAX_NEW,
               idle_wait=IDLE_WAIT_S,
               runs=[dict(spec=ref["specs"]["one"], do="one"),
                     dict(spec=ref["specs"]["router"], do="router",
                          migrate=MIGRATE),
                     dict(spec=ref["specs"]["disagg"], do="disagg")])
    return rk.spawn(serving_rank, rank_layout(1, 2, 2), (job,),
                    store_dir=str(ref["dir"] / "spawn"), threads=1,
                    timeout_s=180, group_timeout_s=GROUP_TIMEOUT_S)


def test_spec_built_rank_server_gives_jax_tokens(ref, ranks):
    """(a) `build(spec, ranks=)` over pp=2 x tp=2: JAX's greedy tokens for
    the same spec JSON and prompts."""
    assert ranks[0]["runs"][0]["tokens"] == ref["tokens"]


def test_two_rank_engines_behind_the_router_and_a_migration(ref, ranks):
    """(b, c) Two engines on one layout behind the balanced router: JAX's
    placement, tokens and migration (the request finishes on the engine
    it moved to)."""
    run = ranks[0]["runs"][1]
    want = ref["router"]
    assert run["routed"] == want["routed"] and sum(run["routed"]) == 8
    assert run["tokens"] == want["tokens"] == ref["tokens"]
    assert run["migrated"] == want["migrated"] == 1
    assert run["moved"][:2] == want["moved"]
    assert run["finished_on"] == want["finished_on"]
    assert MIGRATE in run["finished_on"][run["moved"][1]]


def test_disaggregated_pair_hands_off_as_jax(ref, ranks):
    """(c) A prefill engine and a decode engine on one layout: every
    request handed off once, through the moves under each engine's index,
    and finished on the decode engine with JAX's tokens."""
    run, want = ranks[0]["runs"][2], ref["disagg"]
    assert run["tokens"] == want["tokens"] == ref["tokens"]
    assert run["handoffs"] == want["handoffs"] == 8
    assert run["fallbacks"] == 0
    assert run["routed"] == want["routed"]
    assert run["finished_on"] == want["finished_on"]
    assert run["finished_on"][1] == sorted(f"r{i}" for i in range(8))


def test_http_front_end_over_ranks(ref, ranks):
    """(d) Through `HTTPFrontend` on rank 0: a generate and a stream give
    JAX's tokens, an aborted stream ends with "abort" and its pages return
    to the pool, the stats answer; every handler thread ran its ticks in
    inference mode on the rank's device and stream."""
    run = ranks[0]["runs"][0]
    assert run["http_generate"] == ref["tokens"][0]
    assert run["http_stream"] == ref["tokens"][1]
    assert run["stream_end"] == "length"
    assert run["abort_end"] == "abort" and run["pages_back"]
    assert run["abort_frames"] < 300
    assert len(run["stats_requests"]["replicas"]) == 1
    handlers = [t for t in run["threads"] if t != "MainThread"]
    assert handlers and all(run["threads"].values())


def test_idle_server_outlives_the_group_timeout(ref, ranks):
    """(e) An idle wait of more than twice the group timeout: the idle
    command went out, and a request after it is served with JAX's
    tokens."""
    run = ranks[0]["runs"][0]
    assert run["idle_sent"] >= 2
    assert run["after_idle"] == ref["tokens"][3]


def test_close_ends_every_worker(ranks):
    """(f) The front end's shutdown closed the server (and a second close
    did nothing): the spawn returned, every worker with each engine's rank
    stats of every run."""
    assert ranks[0]["runs"][0]["stopped"]
    for o in ranks[1:]:
        assert [len(r) for r in o["runs"]] == [1, 2, 2]
        assert all(st["ticks"] > 0 for r in o["runs"] for st in r)


def test_spec_at_one_stage_gives_jax_builds_tokens(ref, tmp_path):
    """At pp=1 x tp=2 the reduced spec is JAX's one-layer model: the spec
    JSON served by `build(spec, ranks=)` on the weights JAX's
    `repro.serving.build(spec)` drew gives that server's greedy tokens,
    and streams them through HTTP."""
    from repro.serving import build as jax_build

    spec = _specs()["one"]
    srv = jax_build(spec)
    want = _jax_all(srv, ref["prompts"])
    npz = str(tmp_path / "w1.npz")
    _save_npz(jax.tree.map(np.asarray, srv.replicas[0].params), npz)
    job = dict(npz=npz, prompts=ref["prompts"], max_new=MAX_NEW,
               runs=[dict(spec=spec.to_json(), do="stream")])
    out = rk.spawn(serving_rank, rank_layout(1, 1, 2), (job,),
                   store_dir=str(tmp_path / "spawn"), threads=1,
                   timeout_s=120, group_timeout_s=60)
    run = out[0]["runs"][0]
    assert run["tokens"] == want
    assert run["http_stream"] == want[0] and run["stream_end"] == "length"


def test_launcher_spec_over_ranks_with_replicas_and_traces(
        tmp_path, monkeypatch, capfd):
    """The launcher at tp=2 (2 ranks) on a spec JSON of the JAX package's
    (two replicas, no trace) with ``--trace-out``: it serves every
    request, and each replica's trace replays strictly while the router's
    names every placement."""
    path = tmp_path / "run.trace.jsonl"
    spec = JServeSpec(engine=JEngineSpec(arch=QWEN, reduced=True),
                      cluster=JClusterSpec(replicas=2))
    spec_file = tmp_path / "spec.json"
    spec_file.write_text(spec.to_json())
    monkeypatch.setattr(sys, "argv", [
        "serve", "--spec", str(spec_file), "--device", "cpu", "--tp", "2",
        "--requests", "4", "--max-new", "3", "--trace-out", str(path),
        "--store", str(tmp_path / "store")])
    launcher.main()
    assert "4/4 requests" in capfd.readouterr().out
    served = 0
    for i in range(2):
        report = replay_trace(Trace.load(f"{path}.replica{i}"))
        served += len(report.finished)
        assert all(len(t) == 3 for t in report.outputs().values())
    assert served == 4
    with open(f"{path}.router") as fh:
        recs = [json.loads(line) for line in fh if line.strip()]
    assert recs[0]["schema"] == "gllm-route"
    assert sum(r["kind"] == "route" for r in recs) == 4
