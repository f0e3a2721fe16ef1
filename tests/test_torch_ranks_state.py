"""The rank engine's state in and out on the CPU (gloo), against the JAX
package and the port's one-process engine: prefix caching, async dispatch,
KV migration (directly through `export_*`/`import_*` and through the
router's `migrate_request`), tick traces (at dp = 1 and over dp = 2 data
replicas) and snapshots of a `PipelineEngine(ranks=)`.

The reduced qwen1.5-0.5b (two layers) at pp=2 x tp=2 (4 ranks) and at
dp=2 (2 ranks),
each layout spawned once a module (`torch_rank_jobs.scenario_rank`: a
list of runs on the same shard), on JAX's ``init_params`` weights at pp=1 (re-tiled for pp=2,
a pure reshape).  JAX's references come from one JAX `PipelineEngine` on a
1-device mesh with prefix caching: its greedy tokens on every prompt set,
its prefix counters, and a request migrated mid-decode through its own
`export_*`/`import_*` calls.  Exported payloads are held to the
one-process port engine's export of the same request at the same progress
(same keys, shapes and dtype; values within f32 rounding, since the
batches the request shared differ).
"""

import argparse

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from repro.core import SamplingParams as JSamplingParams
from repro.core import ThrottleConfig as JThrottleConfig
from repro.jax_compat import ensure_jax_compat
from repro.models import transformer as jtfm
from repro.distributed.elastic import replan as jax_replan
from repro.models.serve import ServeDims as JServeDims
from repro.runtime.engine import PipelineEngine as JaxEngine
from repro_torch.core import SamplingParams, ThrottleConfig
from repro_torch.distributed.elastic import replan
from repro_torch.launch.mesh import rank_layout
from repro_torch.launch.serve import _serve_ranks, move_in, move_out
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime.engine import PipelineEngine
from repro_torch.runtime.trace import Trace, check_trace, replay_trace
from repro_torch.serving import ServeSpec, TraceSpec, build
from test_torch_hygiene import _fake_ranks
from test_torch_ranks import _jax_cfg, _spawn
from test_torch_ranks import _port_cfg as _staged_cfg
from torch_rank_jobs import scenario_rank

ensure_jax_compat()

QWEN = "qwen1.5-0.5b"
DIMS = dict(Sp=1, C=16, Sd=8, pages=256, page=8, Bp=32, Bd=32, slots=16)
THROTTLE = dict(max_prefill_tokens=16, min_prefill_tokens=4, num_iters_T=2)
MAX_NEW = 6
F32_TOL = 1e-5
# fields of a tick record that time the host, not a decision
TIMING = ("now", "at", "host_s")


def _port_cfg(arch, pp, tp):
    """The reduced config's two layers in `pp` stages at `tp`."""
    return replan(_staged_cfg(arch, 2, 1), pp, tp)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(vocab):
    """Three prompts; three that share a 16-token prefix (2 pages), the
    first of them long, with the step each of those arrives at: the
    others come once the first's prefill has frozen its pages."""
    rng = np.random.default_rng(5)
    plain = [[int(t) for t in rng.integers(0, vocab, n)] for n in (9, 21, 30)]
    shared = [int(t) for t in rng.integers(0, vocab, 16)]
    tails = [[int(t) for t in rng.integers(0, vocab, n)] for n in (40, 5, 7)]
    short = [int(t) for t in rng.integers(0, vocab, 6)]
    return plain, [shared + t for t in tails] + [short], [0, 14, 16, 0]


def _retile(flat, pp):
    """The pp=1 numpy tree's stage leaves [1, R, ...] as [pp, R/pp, ...]."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return t
    out = walk(flat)
    for g, leaves in out["stages"].items():
        for n, a in leaves.items():
            leaves[n] = a.reshape((pp, a.shape[1] // pp) + a.shape[2:])
    return out


def _save_npz(tree, path):
    flat = {}

    def walk(t, prefix):
        for k, v in t.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, key)
            else:
                flat[key] = v
    walk(tree, "")
    np.savez(path, **flat)


def _serve_all(eng, prompts, arrive=None, sampling=SamplingParams):
    """Every prompt, each added at its step of `arrive`, to completion."""
    arrive = list(arrive or [0] * len(prompts))
    reqs, steps = [None] * len(prompts), 0
    while any(a is not None for a in arrive) or eng.loop.has_work:
        for i, a in enumerate(arrive):
            if a is not None and steps >= a:
                reqs[i] = eng.add_request(prompts[i], sampling(
                    max_new_tokens=MAX_NEW), request_id=f"r{i}")
                arrive[i] = None
        eng.step()
        steps += 1
    return reqs


def _moved_at(eng, prompts, rid, n_out):
    """The one-process move of `rid` once it holds `n_out` tokens."""
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=MAX_NEW),
                            request_id=f"r{i}")
            for i, p in enumerate(prompts)]
    req = next(r for r in reqs if r.request_id == rid)
    for _ in range(400):
        if req.num_output_tokens >= n_out:
            m = move_out(eng, rid)
            if m is not None:
                assert m["request"].num_output_tokens == n_out
                eng.drain()
                return m
        eng.step()
    raise AssertionError(f"{rid} never reached {n_out} tokens out of flight")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """JAX's engine with prefix caching on a 1-device mesh: its tokens on
    both prompt sets (the prefix set at its arrival steps), its prefix
    counters, and request r1 migrated mid-decode through its own hooks;
    the weights as numpy."""
    jcfg = jax_replan(_jax_cfg(QWEN, 2, 1), 1, 1)
    mesh = jax.make_mesh((1, 1, 1), ("data", "stage", "tensor"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)
    plain, shared, arrive = _prompts(jcfg.vocab_size)
    with jax.set_mesh(mesh):
        params = jtfm.init_params(jcfg, jax.random.key(0), dtype=jnp.float32)
        params = jax.tree.map(
            lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
            params, jtfm.param_pspecs(jcfg),
            is_leaf=lambda x: isinstance(x, P))
        eng = JaxEngine(jcfg, JServeDims(**DIMS, Te=0), params, mesh,
                        JThrottleConfig(pipeline_depth=1, **THROTTLE),
                        enable_prefix_caching=True)
        out = {"shared": [r.output_token_ids for r in _serve_all(
            eng, shared, arrive, JSamplingParams)]}
        out["hits"] = eng.scheduler.stats.prefix_hits
        reqs = [eng.add_request(p, JSamplingParams(max_new_tokens=MAX_NEW))
                for p in plain]
        mig = reqs[1]
        for _ in range(400):
            eng.step()
            if mig.num_output_tokens >= 3 and \
                    eng.scheduler.drain_request(mig.request_id) is mig:
                break
        kv = eng.scheduler.kv
        export = kv.export_kv(mig.request_id)
        payload = eng.backend.export_kv_pages(mig.request_id, export.slots)
        state = eng.backend.export_request_state(mig)
        kv.free(mig.request_id)
        slots = kv.import_kv(export)
        eng.backend.import_kv_pages(mig.request_id, payload, slots)
        eng.backend.import_request_state(mig, state)
        eng.scheduler.adopt_request(mig)
        eng.drain()
        out["plain"] = [r.output_token_ids for r in reqs]
    out["tree"] = jax.tree.map(np.asarray, params)
    out["dir"] = tmp_path_factory.mktemp("ranks_state")
    return out


def _one(ref, pp, **kw):
    """The port's one-process engine at `pp` stages on JAX's weights."""
    cfg = _port_cfg(QWEN, pp, 1)
    tree = ref["tree"] if pp == 1 else _retile(ref["tree"], pp)
    return PipelineEngine(cfg, _dims(), params_from_numpy(cfg, tree),
                          ThrottleConfig(pipeline_depth=pp, **THROTTLE),
                          device="cpu", **kw)


def _dims():
    from repro_torch.models.serve import ServeDims
    return ServeDims(**DIMS)


def _job(ref, dp, pp, tp, runs):
    cfg = _port_cfg(QWEN, pp, tp)
    npz = ref["dir"] / f"w{pp}.npz"
    if not npz.exists():
        _save_npz(ref["tree"] if pp == 1 else _retile(ref["tree"], pp), npz)
    plain, _, _ = _prompts(cfg.vocab_size)
    return dict(cfg=cfg, dims=_dims(),
                throttle=ThrottleConfig(pipeline_depth=pp, **THROTTLE),
                prompts=plain, max_new=MAX_NEW, device="cpu",
                dtype="float32", npz=str(npz), runs=runs)


@pytest.fixture(scope="module")
def pp2tp2(ref):
    """One spawn of pp=2 x tp=2, seven runs: plain sync (snapshotted at
    step 7); the prefix set,
    prefix-cached and traced; plain async; r1 moved out mid-decode; that
    move into a fresh engine (rank -> rank); a one-process move of r1 in
    (one-process -> rank); the router moving r1 to the one-process engine
    beside it and r2 back."""
    cfg = _port_cfg(QWEN, 2, 2)
    plain, shared, arrive = _prompts(cfg.vocab_size)
    into = _moved_at(_one(ref, 2), plain, "r1", 3)
    trace = str(ref["dir"] / "rank.trace.jsonl")
    runs = [dict(snapshot=7),
            dict(prompts=shared, arrive=arrive, enable_prefix_caching=True,
                 trace_out=trace),
            dict(async_dispatch=True),
            dict(export={"r1": 6}),
            dict(prompts=[], imports="previous"),
            dict(prompts=[], imports=[into]),
            dict(router={"moves": [[6, "r1", 0, 1], [6, "r2", 0, 1]]})]
    out = _spawn(scenario_rank, rank_layout(1, 2, 2),
                 _job(ref, 1, 2, 2, runs), ref["dir"], "pp2tp2")
    return out, trace, into


@pytest.fixture(scope="module")
def dp2(ref):
    """One spawn of dp=2: plain sync, traced; the prefix set,
    prefix-cached; plain async; r1 and r2 moved out (one a replica); those
    into a fresh engine.  Returns the ranks' results and the trace's
    path."""
    cfg = _port_cfg(QWEN, 1, 1)
    plain, shared, arrive = _prompts(cfg.vocab_size)
    trace = str(ref["dir"] / "dp2.trace.jsonl")
    runs = [dict(trace_out=trace),
            dict(prompts=shared, arrive=arrive, enable_prefix_caching=True),
            dict(async_dispatch=True),
            dict(export={"r1": 6, "r2": 8}),
            dict(prompts=[], imports="previous")]
    out = _spawn(scenario_rank, rank_layout(2, 1, 1),
                 _job(ref, 2, 1, 1, runs), ref["dir"], "dp2")
    return out, trace


# ----------------------------------------------------------------------------
# pp=2 x tp=2
# ----------------------------------------------------------------------------

def test_prefix_caching_at_pp2_tp2(ref, pp2tp2):
    """JAX's greedy tokens; the one-process pp=2 engine's adopted pages."""
    runs = pp2tp2[0][0]["runs"]
    assert runs[0]["tokens"] == ref["plain"]
    assert runs[1]["tokens"] == ref["shared"]
    one = _one(ref, 2, enable_prefix_caching=True)
    _, shared, arrive = _prompts(one.cfg.vocab_size)
    _serve_all(one, shared, arrive)
    st = one.scheduler.stats
    assert runs[1]["prefix"] == {"hits": st.prefix_hits,
                                 "tokens": st.prefix_tokens_avoided}
    assert runs[1]["prefix"]["hits"] == 2 and ref["hits"] == 2


def test_async_dispatch_at_pp2_tp2(ref, pp2tp2):
    """Async tokens equal sync; ticks equal the one-process async
    engine's on the same batch."""
    runs = pp2tp2[0][0]["runs"]
    assert runs[2]["tokens"] == runs[0]["tokens"]
    one = _one(ref, 2, async_dispatch=True)
    plain, _, _ = _prompts(one.cfg.vocab_size)
    _serve_all(one, plain)
    assert runs[2]["stats"]["ticks"] == one.stats.ticks


def _same_payload(got, want):
    """Same keys, shapes and dtype; values within f32 rounding."""
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and \
            got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=F32_TOL, rtol=F32_TOL, err_msg=k)


def test_kv_migration_at_pp2_tp2(ref, pp2tp2):
    """Rank -> one-process, rank -> rank, one-process -> rank: tokens equal
    the unmigrated run's and JAX's migrated run's; the payload the ranks
    export equals the one-process engine's."""
    out, _, into = pp2tp2
    runs = out[0]["runs"]
    (moved,) = runs[3]["moved"]
    n = moved["request"].num_output_tokens
    assert 0 < n < MAX_NEW
    plain, _, _ = _prompts(_port_cfg(QWEN, 2, 2).vocab_size)
    want = _moved_at(_one(ref, 2), plain, "r1", n)
    _same_payload(moved["kv"], want["kv"])
    assert moved["state"]["slot_leaves"] == {}
    assert moved["export"].slots != () and \
        moved["export"].num_tokens == want["export"].num_tokens
    # the rest of the batch is unchanged by the move
    assert [t for i, t in enumerate(runs[3]["tokens"]) if i != 1] == \
        [t for i, t in enumerate(ref["plain"]) if i != 1]
    # rank -> one-process
    eng = _one(ref, 2)
    req = move_in(eng, moved)
    eng.drain()
    assert req.output_token_ids == ref["plain"][1]
    # rank -> rank and one-process -> rank
    assert runs[4]["moved_in"] == {"r1": ref["plain"][1]}
    assert runs[5]["moved_in"] == {"r1": ref["plain"][1]}
    assert into["request"].num_output_tokens == 3
    # the moves travel as `state` traffic on every rank of the replica
    for o in out:
        assert o["runs"][3]["rank_stats"]["traffic"]["bytes"]["state"] > 0


def test_router_migrates_to_and_from_a_rank_engine(ref, pp2tp2):
    """The rank engine as replica 0 of the router beside a one-process
    engine in rank 0's process: r1 and r2 migrate mid-decode, finish
    there with JAX's tokens, and the other requests stay."""
    run = pp2tp2[0][0]["runs"][6]
    assert run["migrated"] == 2
    assert sorted(run["local"]) == ["r1", "r2"]
    assert run["tokens"] == ref["plain"]


def test_rank_trace_replays_and_equals_one_process_trace(ref, pp2tp2):
    """The traced prefix run replays strictly and equals, record for
    record outside the timing fields, the one-process pp=2 engine's trace
    of the same run."""
    _, path, _ = pp2tp2
    trace = Trace.load(path)
    report = replay_trace(trace)
    assert report.outputs() == {f"r{i}": t for i, t in
                                enumerate(ref["shared"])}
    one_path = str(ref["dir"] / "one.trace.jsonl")
    one = _one(ref, 2, enable_prefix_caching=True, trace_path=one_path)
    _, shared, arrive = _prompts(one.cfg.vocab_size)
    _serve_all(one, shared, arrive)
    one.recorder.close()

    def strip(recs):
        return [{k: strip([v])[0] if isinstance(v, dict) else v
                 for k, v in r.items() if k not in TIMING} for r in recs]
    assert strip(trace.records) == strip(Trace.load(one_path).records)
    assert strip([trace.header]) == strip([Trace.load(one_path).header])


def test_snapshot_of_a_rank_engine_restores_in_one_process(ref, pp2tp2):
    """`snapshot_state` of the rank engine mid-run (its first run, at step
    7) restores into a one-process engine, whose tokens then equal the
    uninterrupted run's: each request re-prefills its prompt and emitted
    tokens and goes on."""
    snap = pp2tp2[0][0]["runs"][0]["snapshot"]
    assert {r["request_id"] for r in snap["requests"]} == {"r0", "r1", "r2"}
    assert any(r["output"] for r in snap["requests"])
    fresh = _one(ref, 2)
    PipelineEngine.restore_requests(fresh, snap)
    fresh.drain()
    got = {r.request_id: r.output_token_ids for r in fresh.finished}
    assert got == {f"r{i}": t for i, t in enumerate(ref["plain"])}


# ----------------------------------------------------------------------------
# dp=2
# ----------------------------------------------------------------------------

def test_prefix_caching_at_dp2_places_in_the_replica_that_holds_it(
        ref, dp2):
    """The requests that share the long first request's prefix go to its
    replica (the other one, by free pages alone) and adopt its pages;
    JAX's tokens."""
    runs = dp2[0][0]["runs"]
    assert runs[0]["tokens"] == ref["plain"]
    run = runs[1]
    assert run["tokens"] == ref["shared"]
    assert run["prefix"]["hits"] == 2
    home = _homes(run)
    assert home["r0"] == home["r1"] == home["r2"] != home["r3"]


def _homes(run):
    """Each request's data replica, from its first prefill row."""
    home = {}
    for tick, reps in zip(run["ticks"], run["replicas"]):
        if tick is not None:
            for (rid, _, _), r in zip(tick[0], reps[0]):
                home.setdefault(rid, r)
    return home


def test_async_and_migration_at_dp2(ref, dp2):
    """Async tokens equal sync; r1 and r2, moved out of their replicas
    mid-decode, carry the one-process engine's payloads and finish with
    JAX's tokens in a fresh rank engine."""
    runs = dp2[0][0]["runs"]
    assert runs[2]["tokens"] == runs[0]["tokens"]
    moved = {m["request"].request_id: m for m in runs[3]["moved"]}
    assert sorted(moved) == ["r1", "r2"]
    home = _homes(runs[3])
    assert home["r1"] != home["r2"]
    plain, _, _ = _prompts(_port_cfg(QWEN, 1, 1).vocab_size)
    for rid, m in moved.items():
        n = m["request"].num_output_tokens
        assert 0 < n < MAX_NEW
        _same_payload(m["kv"], _moved_at(_one(ref, 1), plain, rid, n)["kv"])
    assert runs[4]["moved_in"] == {"r1": ref["plain"][1],
                                   "r2": ref["plain"][2]}


def test_trace_over_data_replicas_records_both_pools(ref, dp2):
    """The traced dp=2 run: its header records the two replicas and each
    pool's pages (`num_pages` their total), and every tick each row's
    replica, as the engine placed it."""
    out, path = dp2
    run = out[0]["runs"][0]
    trace = Trace.load(path)
    kv = trace.header["kv"]
    assert kv["replicas"] == 2 and kv["pool_pages"] == [DIMS["pages"]] * 2
    assert kv["num_pages"] == 2 * DIMS["pages"]
    assert [t.get("replicas") for t in trace.ticks] == run["replicas"]
    assert {r for t in run["replicas"] if t for rows in t for r in rows} \
        == {0, 1}


def test_trace_over_data_replicas_replays_strictly(ref, dp2):
    """Strict replay of the dp=2 trace on a `ReplicaKVManager` rebuilt from
    its header reproduces every batch, each row's replica and JAX's
    tokens, and re-records it byte for byte."""
    _, path = dp2
    report = replay_trace(Trace.load(path))
    assert report.outputs() == {f"r{i}": t for i, t in
                                enumerate(ref["plain"])}
    assert report.scheduler.kv.replicas == 2
    assert check_trace(path).ticks == len(Trace.load(path).ticks)


def test_trace_over_data_replicas_serves_timing_only(dp2):
    """The dp=2 trace as a timing-only replay server
    (`TraceReplayEngine`): new requests are served over the two pools at
    the recorded costs."""
    _, path = dp2
    srv = build(ServeSpec(backend="trace",
                          trace=TraceSpec(replay=path, timing_only=True)))
    outs = [srv.generate([3, 1, 4, 1, 5][:n], SamplingParams(
        max_new_tokens=4)) for n in (3, 5)]
    assert [len(o.token_ids) for o in outs] == [4, 4]
    assert all(o.finish_reason == "length" for o in outs)
    assert srv.replicas[0].scheduler.kv.replicas == 2


def test_trace_over_data_replicas_raises_and_graphs_refuse():
    """What still raises at ranks: CUDA graphs on CUDA (item 6.5), a traced
    async run, and a spec that touches no device (sim, trace) over ranks;
    traces over data replicas and the launcher's spec, HTTP and replicas
    over ranks are served (the tests above and
    tests/test_torch_ranks_serving.py)."""
    cfg = _port_cfg(QWEN, 2, 2)
    th = ThrottleConfig(pipeline_depth=2, **THROTTLE)
    with pytest.raises(ValueError, match="item 6.5"):
        PipelineEngine(cfg, _dims(), None, th, ranks=_fake_ranks(),
                       device="cuda")
    base = argparse.Namespace(trace_out=None, async_dispatch=False)
    engine = ServeSpec()
    with pytest.raises(SystemExit, match="--async"):
        _serve_ranks(argparse.Namespace(**{**vars(base), "trace_out": "t",
                                           "async_dispatch": True}), engine)
    for spec in (ServeSpec(backend="sim"), ServeSpec(
            backend="trace", trace=TraceSpec(replay="t.jsonl"))):
        with pytest.raises(SystemExit, match="touches no device"):
            _serve_ranks(base, spec)
        with pytest.raises(ValueError, match="touches no device"):
            build(spec, ranks=_fake_ranks())
