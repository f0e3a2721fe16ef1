"""The serve tick's data axis across ranks on the CPU (gloo), against the
JAX package: one engine whose scheduler places each request in one of two
data replicas (`core.ReplicaKVManager`), each replica one rank (or one
tensor pair) running its own rows, and kimi-k2's and jamba's experts split
over the replicas (expert parallelism).

* Reduced kimi-k2-1t-a32b (ATTN_MOE with its shared expert, two layers)
  and reduced jamba-1.5-large-398b (its nine block kinds) at dp=2 and at
  dp=2 x tp=2, and reduced qwen1.5-0.5b at dp=2 (the data axis without
  experts), f32, dropless (capacity factor = the expert count), with JAX's
  ``init_params`` weights (every rank cuts its shard from the saved tree):
  the ranks' greedy tokens equal JAX's one-device engine's (kimi-k2, qwen)
  or JAX's dense reference's (jamba, whose nine-kind JAX engine compiles
  too long for this file; tests/test_torch_mamba.py holds the port's jamba
  engine to JAX's), exactly.  The batch of every tick and the replica of
  every row equal a host replay of the scheduler over the same pools, every
  replica's rows stay inside its own limits, and some tick runs with one
  replica idle (no rows) while the other is busy.
* The scheduler over replicas on the host: placement by most free pages
  (the lower index on a tie) among replicas with room, finishing and
  aborting free only their replica's pages, preemption takes victims of the
  same replica only, and the KV invariants hold per replica after every
  tick.
* One dp=2 tick against JAX's ``build_serve_tick`` on a ``(2, 1, 1)`` host
  mesh (a subprocess): reduced kimi-k2 with its experts split over `data`,
  two prefill rows a replica, then a decode tick on the pages they wrote,
  the metadata laid out as JAX's ``P("stage", "data")`` specs split it
  (replica r's rows at ``[r * Sp, (r + 1) * Sp)``, page ids local to the
  replica): the same greedy tokens on every live row.

Rank launches as in tests/test_torch_ranks.py: a ``FileStore`` under
``tmp_path``, one intra-op thread a rank, a 60-s group timeout and a launch
timeout.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from repro.core import SamplingParams as JSamplingParams
from repro.core import ThrottleConfig as JThrottleConfig
from repro.models.serve import ServeDims as JServeDims
from repro.runtime.engine import PipelineEngine as JaxEngine
from repro_torch.core import (
    PagedKVManager,
    PipelineScheduler,
    PrefillPolicy,
    ReplicaKVManager,
    ThrottleConfig,
)
from repro_torch.core.request import Request, SamplingParams
from repro_torch.launch import ranks as rk
from repro_torch.launch.mesh import rank_layout
from repro_torch.models import serve as serve_lib
from repro_torch.models.serve import ServeDims
from test_torch_tp_serve import DIMS, THROTTLE, cfgs, jax_greedy, jax_params
from torch_rank_jobs import serve_rank

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT_LENS = (9, 21, 5, 30, 12)    # 21 and 30 exceed C=16
MAX_NEW = 5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(cfg, seed: int = 5):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
            for n in PROMPT_LENS]


def _jax_engine_tokens(jcfg, jparams, prompts):
    """JAX's one-device engine's greedy tokens, on a (1, 1, 1) mesh."""
    mesh = jax.make_mesh((1, 1, 1), ("data", "stage", "tensor"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)
    from repro.models import transformer as jtfm
    with jax.set_mesh(mesh):
        placed = jax.tree.map(
            lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
            jparams, jtfm.param_pspecs(jcfg),
            is_leaf=lambda x: isinstance(x, P))
        eng = JaxEngine(jcfg, JServeDims(**DIMS), placed, mesh,
                        JThrottleConfig(**THROTTLE))
    reqs = [eng.add_request(p, JSamplingParams(max_new_tokens=MAX_NEW),
                            request_id=f"r{i}")
            for i, p in enumerate(prompts)]
    eng.drain(max_ticks=500)
    assert all(r.is_finished for r in reqs)
    return [r.output_token_ids for r in reqs]


def replay(prompts, dims: ServeDims, throttle: ThrottleConfig, dp: int):
    """The scheduler over `dp` replicas' pools on the host, every sampled
    token 0 (greedy serving's batches do not depend on the tokens): the
    batch of every tick and the replica of each of its rows, as
    `serve_rank` records them, checking the KV invariants per replica
    after every tick."""
    kv = ReplicaKVManager(dp, dims.pages, dims.page)
    sched = PipelineScheduler(
        throttle, kv, max_model_len=dims.page * max(dims.Bp, dims.Bd),
        max_prefill_seqs=dims.Sp, max_chunk_tokens=dims.C,
        max_decode_seqs=dims.Sd)
    for i, p in enumerate(prompts):
        sched.add_request(Request(f"r{i}", list(p),
                                  SamplingParams(max_new_tokens=MAX_NEW)))
    ticks, homes = [], []
    while sched.has_work:
        b = sched.schedule()
        if b.is_empty:
            sched.complete(b.batch_id, [])
            ticks.append(None)
            homes.append(None)
            continue
        ticks.append([[[q.request.request_id, q.start_pos, q.num_tokens]
                       for q in b.prefill],
                      [q.request.request_id for q in b.decode]])
        homes.append([[kv.replica_of(q.request.request_id) for q in rows]
                      for rows in (b.prefill, b.decode)])
        sched.complete(b.batch_id, [0] * sum(q.produces_token
                                             for q in b.seqs))
        sched.check_invariants()
    return ticks, homes


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """Per arch: configs, JAX weights saved for the ranks, prompts and
    JAX's greedy tokens."""
    out = {}
    for arch in ("kimi-k2-1t-a32b", "jamba-1.5-large-398b", "qwen1.5-0.5b"):
        jcfg, cfg = cfgs(arch, 1, 1)
        path = tmp_path_factory.mktemp(arch) / "w.npz"
        jparams, _ = jax_params(jcfg, path)
        prompts = _prompts(cfg)
        if arch.startswith("jamba"):
            # teacher-forced along its own greedy tokens: one forward
            want = None
        else:
            want = _jax_engine_tokens(jcfg, jparams, prompts)
        out[arch] = dict(jcfg=jcfg, cfg=cfg, jparams=jparams, npz=str(path),
                         prompts=prompts, want=want)
    return out


@pytest.mark.parametrize("arch,tp", [
    ("kimi-k2-1t-a32b", 1),
    ("kimi-k2-1t-a32b", 2),
    ("jamba-1.5-large-398b", 1),
    ("jamba-1.5-large-398b", 2),
    ("qwen1.5-0.5b", 1),
])
def test_data_replicas_give_jax_greedy_tokens(references, arch, tp,
                                              tmp_path):
    ref = references[arch]
    cfg = ref["cfg"].with_plan(tp=tp)
    dims = ServeDims(**DIMS)
    throttle = ThrottleConfig(pipeline_depth=1, **THROTTLE)
    job = dict(cfg=cfg, dims=dims, throttle=throttle,
               prompts=ref["prompts"], max_new=MAX_NEW, device="cpu",
               dtype="float32", npz=ref["npz"])
    out = rk.spawn(serve_rank, rank_layout(2, 1, tp), (job,),
                   store_dir=str(tmp_path / "store"), threads=1,
                   timeout_s=180, group_timeout_s=60)
    head = out[0]
    assert all(head["finished"])
    want = ref["want"] or jax_greedy(ref["jcfg"], ref["jparams"],
                                     ref["prompts"], head["tokens"])
    assert head["tokens"] == want
    ticks, homes = replay(ref["prompts"], dims, throttle, 2)
    assert head["ticks"] == ticks and head["replicas"] == homes
    idle = 0
    for h in homes:
        if h is None:
            continue
        for r in range(2):
            assert h[0].count(r) <= dims.Sp and h[1].count(r) <= dims.Sd
        used = set(h[0]) | set(h[1])
        idle += len(used) == 1
    assert idle > 0                 # a tick with one replica idle
    for o in out:                   # every rank ran every tick
        assert o["rank_stats"]["ticks"] == head["stats"]["ticks"]
        ep = o["rank_stats"]["traffic"]["bytes"].get("ep", 0)
        assert (ep > 0) == cfg.is_moe


# ---------------------------------------------------------------- host side

def _sched(kv, Sp: int = 2):
    """A scheduler over `kv` whose prefill budget is a fixed 64 tokens
    (the Sarathi policy), so that the rows, not the budget, bind."""
    return PipelineScheduler(
        ThrottleConfig(pipeline_depth=1, policy=PrefillPolicy.SARATHI,
                       max_prefill_tokens=64),
        kv, max_prefill_seqs=Sp, max_chunk_tokens=16, max_decode_seqs=8)


def test_requests_live_in_one_replica_and_free_only_its_pages():
    kv = ReplicaKVManager(2, 16, 8)
    assert kv.place("x", [0, 1]) == 0           # a tie: the lower index
    kv.unplace("x")
    assert kv.replica_of("x") is None
    sched = _sched(kv, Sp=1)
    reqs = [Request(f"r{i}", list(range(1, 1 + n)),
                    SamplingParams(max_new_tokens=3))
            for i, n in enumerate((12, 5, 7))]
    for r in reqs:
        sched.add_request(r)
    b = sched.schedule()
    # one prefill row a replica: r0 on 0 (tie), r1 on 1, r2 waits
    assert [(q.request.request_id, kv.replica_of(q.request.request_id))
            for q in b.prefill] == [("r0", 0), ("r1", 1)]
    assert [p.num_free_pages for p in kv.pools] == [14, 15]
    assert kv.num_free_pages == 29 and kv.kv_free_rate == 29 / 32
    sched.complete(b.batch_id, [7 for q in b.seqs if q.produces_token])
    sched.check_invariants()
    # r2 goes where more pages are free: replica 1
    b = sched.schedule()
    assert kv.replica_of("r2") == 1
    sched.complete(b.batch_id, [7 for q in b.seqs if q.produces_token])
    sched.check_invariants()
    before = [p.num_free_pages for p in kv.pools]
    assert sched.abort_request("r2") is not None
    after = [p.num_free_pages for p in kv.pools]
    assert after[0] == before[0] and after[1] == before[1] + 1
    assert kv.replica_of("r2") is None
    sched.check_invariants()
    for _ in range(20):
        if not sched.has_work:
            break
        b = sched.schedule()
        before = [p.num_free_pages for p in kv.pools]
        done = sched.complete(b.batch_id,
                              [7 for q in b.seqs if q.produces_token])
        sched.check_invariants()
        for r in done:              # a finish frees its own replica only
            assert r.request_id in ("r0", "r1")
    assert [p.num_free_pages for p in kv.pools] == [16, 16]
    assert all(r.is_finished for r in reqs)


def test_preemption_stays_inside_a_replica():
    """Replica 0's pool fills up: its decode preempts its own newest
    request, never replica 1's."""
    kv = ReplicaKVManager(2, 4, 4)
    sched = _sched(kv)
    reqs = [Request(f"r{i}", [1] * 8, SamplingParams(max_new_tokens=6))
            for i in range(4)]
    for r in reqs:
        sched.add_request(r)
    preempted = []
    sched.on_preempt = lambda r: preempted.append(r.request_id)
    homes = {}
    for _ in range(40):
        if not sched.has_work:
            break
        b = sched.schedule()
        for q in b.seqs:
            homes.setdefault(q.request.request_id, set()).add(
                kv.replica_of(q.request.request_id))
        for q in b.decode:
            rid = q.request.request_id
            # the rows of one batch share no page across replicas
            assert kv.replica_of(rid) in (0, 1)
        sched.complete(b.batch_id, [3 for q in b.seqs if q.produces_token])
        sched.check_invariants()
    assert all(r.is_finished for r in reqs)
    assert preempted                              # the pools were tight
    # a one-pool manager is the one-replica case: every request on 0
    one = PagedKVManager(8, 4)
    assert one.replicas == 1 and one.place("a", [0]) == 0
    assert one.free_pages_of("a") == 8 and one.pool_pages == 8


# ------------------------------------------------------------ the JAX tick

TICK_DIMS = dict(Sp=2, C=16, Sd=2, pages=32, page=8, Bp=8, Bd=8, slots=4)
TICK_LENS = ((9, 16), (5, 12))          # each replica's two prompts


def _tick_meta(dims: ServeDims, lens, decode: bool):
    """One replica's host metadata: prefill rows of `lens` tokens from
    position 0, or decode rows at position `len` (one token each), each
    row's pages its own block of the replica's pool."""
    m = {k: v.copy() for k, v in serve_lib.zero_meta(dims).items()}
    for s, L in enumerate(lens):
        pages = [s * dims.Bp + i for i in range(dims.Bp)]
        if not decode:
            m["p_positions"][s, :L] = np.arange(L)
            m["p_chunk_lens"][s] = L
            m["p_context_lens"][s] = L
            m["p_block_tables"][s, :dims.Bp] = pages
            m["p_slot_pages"][s, :L] = [pages[i // dims.page]
                                        for i in range(L)]
            m["p_slot_offsets"][s, :L] = np.arange(L) % dims.page
            m["p_state_slots"][s] = s
            m["p_sample"][s] = 1
        else:
            m["d_positions"][s] = L
            m["d_context_lens"][s] = L + 1
            m["d_block_tables"][s, :dims.Bd] = pages
            m["d_slot_pages"][s] = pages[L // dims.page]
            m["d_slot_offsets"][s] = L % dims.page
            m["d_state_slots"][s] = s
            m["d_valid"][s] = 1
    return m


JAX_TICK = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config, make_reduced
from repro.distributed.pipeline import build_serve_tick
from repro.launch.shapes import serve_input_specs
from repro.models import transformer as tfm
from repro.models.serve import ServeDims
import dataclasses, json

path = sys.argv[1]
spec = json.load(open(path + "/spec.json"))
cfg = make_reduced(get_config("kimi-k2-1t-a32b")).with_plan(pp=1, tp=1)
cfg = dataclasses.replace(cfg, dtype="float32",
                          moe_capacity_factor=float(cfg.num_experts))
dims = ServeDims(**spec["dims"])
mesh = jax.make_mesh((2, 1, 1), ("data", "stage", "tensor"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
with jax.set_mesh(mesh):
    params = tfm.init_params(cfg, jax.random.key(0), dtype=jnp.float32)
    params = jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
        params, tfm.param_pspecs(cfg), is_leaf=lambda x: isinstance(x, P))
    tick, specs = build_serve_tick(cfg, mesh, dims)
    caches, carry, _, _, _ = serve_input_specs(cfg, dims, mesh, specs)
    zeros = lambda s: jax.device_put(jnp.zeros(s.shape, s.dtype), s.sharding)
    caches = jax.tree.map(zeros, caches)
    carry = jax.tree.map(zeros, carry)
    tok = np.asarray(params["embed"]["tok"])
    out = {}
    for phase in ("prefill", "decode"):
        f = dict(np.load(f"{path}/{phase}.npz"))
        ids = f.pop("ids")                           # [2, Sp, C] / [2, Sd]
        meta = {k: jnp.asarray(v)[None] for k, v in f.items()}
        W = dims.prefill_width
        xp = np.zeros((2 * dims.Sp, W, cfg.d_model), np.float32)
        xd = np.zeros((2 * dims.Sd, 1, cfg.d_model), np.float32)
        if phase == "prefill":
            xp[:, :dims.C] = tok[ids.reshape(2 * dims.Sp, dims.C)]
        else:
            xd[:, 0] = tok[ids.reshape(2 * dims.Sd)]
        fresh = {"xp": jnp.asarray(xp), "xd": jnp.asarray(xd)}
        carry, caches, tokens, _ = jax.jit(tick)(params, caches, carry,
                                                 meta, fresh)
        out[phase] = np.asarray(tokens)
    np.savez(path + "/jax.npz", **out)
    flat = {"/".join(str(k.key) for k in p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(path + "/w.npz", **flat)
print("JAX_TICK_DONE")
"""


def _tick_rank(ranks, job):
    """This rank's replica runs the prefill tick, then the decode tick, on
    its shard of the JAX weights."""
    from repro_torch.distributed.pipeline import build_rank_serve_tick
    from repro_torch.launch.serve import rank_params
    from repro_torch.models.transformer import expert_parts, shard_config

    cfg, dims = job["cfg"], job["dims"]
    r = ranks.index("data")
    params = rank_params(cfg, ranks, dtype=torch.float32, device="cpu",
                         npz=job["npz"])
    local = shard_config(cfg, 1, expert_parts(cfg, 2))
    caches = serve_lib.init_caches(local, dims, torch.float32, "cpu")
    tick = build_rank_serve_tick(cfg, dims, ranks)
    out = {}
    for phase in ("prefill", "decode"):
        m = serve_lib.host_meta(job[phase][r], dims)
        meta = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in m.items()}
        ids = job[phase + "_ids"][r]
        meta["p_tok"] = torch.from_numpy(
            ids if phase == "prefill" else
            np.zeros((dims.Sp, dims.C), np.int32))
        meta["d_tok"] = torch.from_numpy(
            ids if phase == "decode" else np.zeros(dims.Sd, np.int32))
        with torch.inference_mode():
            caches, tokens = tick(params, caches, meta, None)
        out[phase] = tokens.numpy()
    return out


def test_dp_tick_matches_jax_build_serve_tick(tmp_path):
    from repro_torch.configs import get_config, make_reduced

    dims = ServeDims(**TICK_DIMS)
    rng = np.random.default_rng(11)
    cfg = make_reduced(get_config("kimi-k2-1t-a32b")).with_plan(pp=1, tp=1)
    cfg = dataclasses.replace(cfg, dtype="float32",
                              moe_capacity_factor=float(cfg.num_experts))
    pre = [_tick_meta(dims, lens, False) for lens in TICK_LENS]
    ids = rng.integers(0, cfg.vocab_size, (2, dims.Sp, dims.C)) \
        .astype(np.int32)
    for r, lens in enumerate(TICK_LENS):
        for s, L in enumerate(lens):
            ids[r, s, L:] = 0
    np.savez(tmp_path / "prefill.npz", ids=ids, **{
        k: np.concatenate([m[k] for m in pre]) for k in pre[0]})
    dec = [_tick_meta(dims, lens, True) for lens in TICK_LENS]
    dec_ids = rng.integers(0, cfg.vocab_size, (2, dims.Sd)).astype(np.int32)
    np.savez(tmp_path / "decode.npz", ids=dec_ids, **{
        k: np.concatenate([m[k] for m in dec]) for k in dec[0]})
    import json
    (tmp_path / "spec.json").write_text(json.dumps({"dims": TICK_DIMS}))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.pop("REPRO_MOE_CF", None)
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_TICK),
                          str(tmp_path)], capture_output=True, text=True,
                         timeout=300, env=env)
    assert res.returncode == 0 and "JAX_TICK_DONE" in res.stdout, \
        res.stderr[-3000:]
    jx = dict(np.load(tmp_path / "jax.npz"))
    job = dict(cfg=cfg, dims=dims, npz=str(tmp_path / "w.npz"),
               prefill=pre, decode=dec, prefill_ids=ids, decode_ids=dec_ids)
    out = rk.spawn(_tick_rank, rank_layout(2, 1, 1), (job,),
                   store_dir=str(tmp_path / "store"), threads=1,
                   timeout_s=180, group_timeout_s=60)
    rows = dims.Sp + dims.Sd
    live = {"prefill": [r * rows + s for r in range(2)
                        for s in range(dims.Sp)],
            "decode": [r * rows + dims.Sp + s for r in range(2)
                       for s in range(dims.Sd)]}
    for phase, at in live.items():
        assert len(set(jx[phase][at].tolist())) > 1     # not a constant
        for o in out:               # every rank: every replica's tokens
            np.testing.assert_array_equal(o[phase][at], jx[phase][at])
