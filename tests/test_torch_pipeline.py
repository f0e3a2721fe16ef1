"""The port's pipeline ring (pp > 1 on one device) on the CPU against the
JAX package.

One subprocess (it needs ``--xla_force_host_platform_device_count=2``,
which must not leak into the other tests' single-device JAX runtime, as in
tests/test_multidevice.py) serves six prompts on the JAX `PipelineEngine`
at pp=2 on a (1, 2, 1) mesh, sync and unbucketed, for the reduced
qwen1.5-0.5b and olmoe-1b-7b (dropless, ``ep_over_data=False``), f32.  It
writes their parameters (npz), the entering micro-batch of every device
tick (each prefill request with its start and chunk; each decode request)
and every output token.  The port's pp=2 engines, carrying those
parameters across with `params_from_numpy`, sync and async, unbucketed and
bucketed, must give the JAX engine's tokens and, in sync mode, its batch
composition tick by tick; all of them give the dense `greedy_generate`'s
tokens.

Beside it: rwkv6-3b at pp=2 in two waves that reuse the first wave's state
slots (held to the port's dense reference: the JAX engine's slot-0 faults
are ROADMAP Queue 3), qwen at pp=4 (reduced to 8 layers), the scratch page
and slot taking every stage's padding rows, the bubble stage-ticks, live
migration between two pp=2 engines behind the router (refused while the
request is inside the ring), `replan` / `repartition_params` against the
JAX ones, and the entry points: `build(spec, pp=2)` and the launcher's
``--pp 2``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import make_reduced as jax_make_reduced
from repro.distributed import elastic as jax_elastic
from repro_torch.configs import (
    BlockKind,
    BlockSpec,
    cut_to_kinds,
    get_config,
    list_archs,
    make_reduced,
    single_stage,
    stage_config,
)
from repro_torch.core import SamplingParams, ThrottleConfig
from repro_torch.distributed import elastic
from repro_torch.launch.serve import serve_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.reference import greedy_generate
from repro_torch.models.serve import ServeDims
from repro_torch.models.transformer import init_params
from repro_torch.runtime.engine import PipelineEngine
from repro_torch.runtime.router import ReplicaRouter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = dict(Sp=1, C=16, Sd=8, pages=256, page=8, Bp=32, Bd=32, slots=16)
THROTTLE = dict(max_prefill_tokens=16, min_prefill_tokens=4, num_iters_T=2)
PROMPT_LENS = (7, 23, 12, 41, 3, 30)     # 23, 41 and 30 exceed C=16
MAX_NEW = 5
JAX_ARCHS = ("qwen1.5-0.5b", "olmoe-1b-7b")
MODES = {"sync": {}, "sync_bucketed": dict(bucketed=True),
         "async": dict(async_dispatch=True),
         "async_bucketed": dict(bucketed=True, async_dispatch=True)}

JAX_SCRIPT = """
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config, make_reduced
from repro.core import SamplingParams, ThrottleConfig
from repro.models import transformer as tfm
from repro.models.serve import ServeDims
from repro.runtime.engine import PipelineEngine

out_dir, archs, dims, throttle, lens, max_new = json.loads(sys.argv[1])
mesh = jax.make_mesh((1, 2, 1), ("data", "stage", "tensor"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
result = {}
for arch in archs:
    cfg = make_reduced(get_config(arch)).with_plan(pp=2, tp=1,
                                                   ep_over_data=False)
    cfg = dataclasses.replace(
        cfg, dtype="float32",
        moe_capacity_factor=float(max(cfg.num_experts, 1)))
    with jax.set_mesh(mesh):
        params = tfm.init_params(cfg, jax.random.key(0), dtype=jnp.float32)
        params = jax.tree.map(
            lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
            params, tfm.param_pspecs(cfg),
            is_leaf=lambda x: isinstance(x, P))
        eng = PipelineEngine(cfg, ServeDims(**dims), params, mesh,
                             ThrottleConfig(pipeline_depth=2, **throttle))
    ticks = []
    inner = eng.backend.execute

    def execute(ring, exiting_id, now, inner=inner, eng=eng, ticks=ticks):
        b = (eng.scheduler.get_batch(ring[0][0])
             if ring[0][0] is not None else None)
        ticks.append(None if b is None else [
            [[s.request.request_id, s.start_pos, s.num_tokens]
             for s in b.prefill],
            [s.request.request_id for s in b.decode]])
        return inner(ring, exiting_id, now)

    eng.backend.execute = execute
    rng = np.random.default_rng(42)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in lens]
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=max_new),
                            request_id=f"r{i}")
            for i, p in enumerate(prompts)]
    eng.drain(max_ticks=500)
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(f"{out_dir}/{arch}.npz", **flat)
    result[arch] = {"prompts": prompts, "ticks": ticks,
                    "tokens": [r.output_token_ids for r in reqs]}
with open(f"{out_dir}/jax_pp2.json", "w") as fh:
    json.dump(result, fh)
print("JAX_PP2_DONE")
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tensors here are tiny, and when the suite
    runs a process per core several threads per op only spin against each
    other (the module ran ~15x slower so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_pp2(tmp_path_factory):
    """The JAX pp=2 engine's run of both archs: {arch: {"prompts",
    "ticks", "tokens", "params" (the numpy tree)}}."""
    out = tmp_path_factory.mktemp("jax_pp2")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    arg = json.dumps([str(out), list(JAX_ARCHS), DIMS, THROTTLE,
                      list(PROMPT_LENS), MAX_NEW])
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_SCRIPT),
                          arg], capture_output=True, text=True, timeout=600,
                         env=env)
    assert res.returncode == 0 and "JAX_PP2_DONE" in res.stdout, \
        res.stderr[-3000:]
    with open(out / "jax_pp2.json") as fh:
        runs = json.load(fh)
    for arch in JAX_ARCHS:
        tree = {}
        with np.load(out / f"{arch}.npz") as z:
            for key in z.files:
                node = tree
                *path, leaf = key.split("/")
                for k in path:
                    node = node.setdefault(k, {})
                node[leaf] = z[key]
        runs[arch]["params"] = tree
    return runs


def _port_cfg(arch: str):
    """The port's reduced config at pp=2, as the launcher stages it,
    dropless like the JAX run's."""
    cfg, _ = serve_config(arch, reduced=True, pp=2)
    assert cfg.plan.pp == 2 and cfg.layers_per_stage == 1
    return dataclasses.replace(
        cfg, moe_capacity_factor=float(max(cfg.num_experts, 1)))


def _throttle(depth: int) -> ThrottleConfig:
    return ThrottleConfig(pipeline_depth=depth, **THROTTLE)


def _record_ticks(eng):
    """Log the entering micro-batch of every device tick, in the JAX run's
    form."""
    ticks = []
    backend = eng.backend
    inner = backend.execute

    def execute(ring, exiting_id, now):
        b = (backend.scheduler.get_batch(ring[0][0])
             if ring[0][0] is not None else None)
        ticks.append(None if b is None else [
            [[s.request.request_id, s.start_pos, s.num_tokens]
             for s in b.prefill],
            [s.request.request_id for s in b.decode]])
        return inner(ring, exiting_id, now)

    backend.execute = execute
    return ticks


def _serve(eng, prompts, max_new=MAX_NEW):
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=max_new),
                            request_id=f"r{i}")
            for i, p in enumerate(prompts)]
    eng.drain(max_ticks=900)
    assert all(r.is_finished for r in reqs)
    return [r.output_token_ids for r in reqs]


def _bubbles(ticks, depth: int) -> int:
    """Stage-ticks that held no micro-batch, from the entering batches
    (the ring starts as bubbles): the batch entering on tick t holds stage
    s on tick t + s."""
    return sum(t - s < 0 or ticks[t - s] is None
               for t in range(len(ticks)) for s in range(depth))


_PORT = {}


@pytest.fixture(scope="module", params=JAX_ARCHS)
def ported(request, jax_pp2):
    arch = request.param
    cfg = _port_cfg(arch)
    params = params_from_numpy(cfg, jax_pp2[arch]["params"])
    prompts = jax_pp2[arch]["prompts"]
    greedy = [greedy_generate(cfg, params, p, MAX_NEW) for p in prompts]
    return dict(arch=arch, cfg=cfg, params=params, prompts=prompts,
                greedy=greedy, jax=jax_pp2[arch])


@pytest.mark.parametrize("mode", list(MODES))
def test_ring_matches_jax_pp2_engine(ported, mode):
    """Tokens equal the JAX pp=2 engine's and the dense reference's; in
    sync mode every device tick admits the batch the JAX engine admitted,
    and the bubble stage-ticks are those its ring held."""
    eng = PipelineEngine(ported["cfg"], ServeDims(**DIMS), ported["params"],
                         _throttle(2), device="cpu", **MODES[mode])
    assert eng.backend.carry["xp"].shape == (1, 1, 16, ported["cfg"].d_model)
    ticks = _record_ticks(eng)
    tokens = _serve(eng, ported["prompts"])
    assert tokens == ported["jax"]["tokens"]
    assert tokens == ported["greedy"]
    if not eng.loop.async_dispatch:
        assert ticks == ported["jax"]["ticks"]
        assert eng.stats.ticks == len(ticks)
    assert eng.stats.bubble_stage_ticks == _bubbles(ticks, 2)
    assert sum(t is not None for t in ticks) < len(ticks)
    # the ring really held two micro-batches at once
    busy = [t for t in range(1, len(ticks))
            if ticks[t] is not None and ticks[t - 1] is not None]
    assert busy
    assert eng.slots.owner == {}


# ------------------------------------------------------- rwkv, and pp = 4

_PARAMS = {}


def _params(cfg, key):
    if key not in _PARAMS:
        _PARAMS[key] = init_params(cfg, 0)
    return _PARAMS[key]


@pytest.mark.parametrize("mode", ["sync", "async_bucketed"])
def test_rwkv_two_waves_pp2_match_dense_reference(mode):
    """rwkv6-3b at pp=2: each stage's state slots; the second wave takes
    over the first wave's slots and starts from zero state."""
    cfg, _ = serve_config("rwkv6-3b", reduced=True, pp=2)
    params = _params(cfg, "rwkv")
    eng = PipelineEngine(cfg, ServeDims(**DIMS), params, _throttle(2),
                         device="cpu", **MODES[mode])
    rng = np.random.default_rng(8)
    first_slots = set()
    for wave in range(2):
        prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
                   for n in (2, 19, 9, 33)]
        reqs = [eng.add_request(p, SamplingParams(max_new_tokens=4))
                for p in prompts]
        eng.step()
        eng.step()
        slots = set(eng.slots.owner.values())
        if wave == 0:
            first_slots = slots
        else:
            assert slots & first_slots          # slots reused
        eng.drain(max_ticks=400)
        for p, r in zip(prompts, reqs):
            assert r.output_token_ids == greedy_generate(cfg, params, p, 4)
    assert eng.slots.owner == {}


def _qwen_pp4():
    """The reduced qwen1.5-0.5b with 8 layers, staged at pp=4 (2 a
    stage)."""
    cfg = make_reduced(get_config("qwen1.5-0.5b")).with_plan(pp=1, tp=1)
    cfg = dataclasses.replace(cfg, dtype="float32", num_layers=8,
                              pattern=(BlockSpec(BlockKind.ATTN_MLP, 8),))
    return stage_config(cfg, 4)


@pytest.mark.parametrize("mode", ["sync", "async", "async_bucketed"])
def test_qwen_pp4_matches_dense_reference(mode):
    cfg = _qwen_pp4()
    assert cfg.plan.pp == 4 and cfg.pattern[0].repeat == 2
    params = _params(cfg, "qwen4")
    eng = PipelineEngine(cfg, ServeDims(**DIMS), params, _throttle(4),
                         device="cpu", **MODES[mode])
    assert eng.backend.carry["xd"].shape == (3, 8, 1, cfg.d_model)
    rng = np.random.default_rng(4)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in (5, 40, 17, 2, 26, 11, 3)]
    ticks = _record_ticks(eng)
    tokens = _serve(eng, prompts, max_new=6)
    for p, t in zip(prompts, tokens):
        assert t == greedy_generate(cfg, params, p, 6)
    assert eng.stats.bubble_stage_ticks == _bubbles(ticks, 4)
    # four micro-batches in flight at once, at some tick
    assert any(all(ticks[t - s] is not None for s in range(4))
               for t in range(3, len(ticks)))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "rwkv6-3b"])
def test_padding_rows_of_every_stage_go_to_the_scratch_page_and_slot(arch):
    """Mid-serve at pp=2, every KV page no request owns (the scratch page
    too) is NaN-poisoned, and so is every unowned state slot; one bucketed
    tick with both stages busy and padding rows in each then writes each
    stage's scratch page (qwen) or scratch slot (rwkv6-3b) and leaves every
    other unowned page and slot of every stage bit-identical, apart from
    the positions its own micro-batch writes."""
    cfg, _ = serve_config(arch, reduced=True, pp=2)
    dims = ServeDims(**DIMS)
    eng = PipelineEngine(cfg, dims, _params(cfg, arch + "2"), _throttle(2),
                         device="cpu", bucketed=True)
    rng = np.random.default_rng(9)
    for n in (9, 12, 4, 30):
        eng.add_request([int(t) for t in rng.integers(0, cfg.vocab_size, n)],
                        SamplingParams(max_new_tokens=8))
    backend = eng.backend
    seen = {}
    inner = backend.execute

    def execute(ring, exiting_id, now):
        seen["ring"] = ring
        return inner(ring, exiting_id, now)

    backend.execute = execute
    for _ in range(6):
        eng.step()
    assert all(bid is not None for bid, _ in seen["ring"])
    owned_pages = {p for rid in eng.slots.owner
                   for p in eng.kv.block_table(rid)}
    owned_slots = set(eng.slots.owner.values())
    dead_pages = [p for p in range(dims.pages + 1) if p not in owned_pages]
    dead_slots = [s for s in range(dims.slots + 1) if s not in owned_slots]
    assert dims.pages in dead_pages and dims.slots in dead_slots
    for grp in backend.caches.values():
        for name, t in grp.items():
            t[:, :, dead_pages if name == "kv" else dead_slots] = float("nan")
    before = {(g, n): t.clone() for g, grp in backend.caches.items()
              for n, t in grp.items()}
    eng.step()
    ring = seen["ring"]
    assert all(bid is not None for bid, _ in ring)
    for s, (_, m) in enumerate(ring):
        live_d = np.flatnonzero(m["d_valid"])
        written = {(int(m["p_slot_pages"][r, j]),
                    int(m["p_slot_offsets"][r, j]))
                   for r, n in enumerate(m["p_chunk_lens"]) for j in range(n)}
        written |= {(int(m["d_slot_pages"][r]), int(m["d_slot_offsets"][r]))
                    for r in live_d}
        live_slots = ({int(m["p_state_slots"][r])
                       for r in np.flatnonzero(m["p_chunk_lens"])}
                      | {int(m["d_state_slots"][r]) for r in live_d})
        assert live_slots <= owned_slots
        for (g, n), old in before.items():
            new = backend.caches[g][n]
            scratch = dims.pages if n == "kv" else dims.slots

            def same(idx):
                return torch.equal(new[(s, slice(None)) + idx].view(
                    torch.int32), old[(s, slice(None)) + idx].view(
                    torch.int32))
            if n in ("kv", "tm_x", "cm_x"):
                # this stage's padding rows wrote its scratch page or slot
                assert not same((scratch,)), (s, g, n)
            if n == "kv":
                for p in dead_pages[:-1]:
                    for o in range(dims.page):
                        assert (p, o) in written or same((p, o)), (s, p, o)
            else:
                for slot in dead_slots[:-1]:
                    assert same((slot,)), (s, n, slot)
    last = backend.stats.last_bucket
    assert last["Sd"] > min(int(np.count_nonzero(m["d_valid"]))
                            for _, m in ring)


# ------------------------------------------------------------- migration

@pytest.mark.parametrize("mode", ["sync", "async_bucketed"])
def test_migration_between_pp2_engines_waits_for_the_ring(mode):
    """A request inside the ring cannot move (`migrate_request` is False,
    the router may retry); once it has left the ring it moves with its KV
    pages of both stages, and finishes with the dense reference's
    tokens."""
    cfg = _port_cfg("qwen1.5-0.5b")
    params = _params(cfg, "qwen2")
    engines = [PipelineEngine(cfg, ServeDims(**DIMS), params, _throttle(2),
                              device="cpu", **MODES[mode]) for _ in range(2)]
    eng_a, eng_b = engines
    router = ReplicaRouter(engines)
    rng = np.random.default_rng(3)
    prompt = [int(t) for t in rng.integers(0, cfg.vocab_size, 21)]
    req = eng_a.add_request(prompt, SamplingParams(max_new_tokens=8))

    def in_ring() -> bool:
        for bid, _ in eng_a.loop.ring:
            b = eng_a.scheduler.get_batch(bid) if bid is not None else None
            if b is not None and any(s.request is req for s in b.seqs):
                return True
        return False

    refused = 0
    for _ in range(200):
        eng_a.step()
        if req.num_output_tokens < 2:
            continue
        eng_a.settle()
        if in_ring():
            assert not router.migrate_request(req.request_id, 0, 1)
            refused += 1
            assert eng_a.scheduler.kv.has_request(req.request_id)
            continue
        if refused:
            break
    assert refused
    assert router.migrate_request(req.request_id, 0, 1)
    assert router.rebalance_stats.migrated == 1
    assert not eng_a.scheduler.kv.has_request(req.request_id)
    eng_b.drain(max_ticks=300)
    assert req.is_finished
    assert req.output_token_ids == greedy_generate(cfg, params, prompt, 8)


def test_kv_payload_moves_every_stage():
    """The `"{group}/kv"` payload of a pp=2 engine is [S, R, n, 2, KH, hd]
    (the JAX layout): it holds both stages' KV."""
    cfg = _port_cfg("qwen1.5-0.5b")
    eng = PipelineEngine(cfg, ServeDims(**DIMS), _params(cfg, "qwen2"),
                         _throttle(2), device="cpu")
    req = eng.add_request(list(range(1, 12)), SamplingParams(max_new_tokens=9))
    for _ in range(8):
        eng.step()
    eng.settle()
    slots = eng.scheduler.kv.export_kv(req.request_id).slots
    payload = eng.backend.export_kv_pages(req.request_id, slots)
    (key, kv), = payload.items()
    assert kv.shape == (2, 1, len(slots), 2, cfg.num_kv_heads, cfg.head_dim)
    assert torch.count_nonzero(kv[0]) and torch.count_nonzero(kv[1])
    assert not torch.equal(kv[0], kv[1])


# ------------------------------------------------- replan, repartition

def _asdict(cfg) -> dict:
    def plain(v):
        if isinstance(v, dict):
            return {k: plain(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [plain(x) for x in v]
        return getattr(v, "value", v)
    return plain(dataclasses.asdict(cfg))


def _both(arch: str, reduced: bool):
    t = get_config(arch)
    j = jax_get_config(arch)
    if reduced:
        t, j = make_reduced(t), jax_make_reduced(j)
    return t, j


GRIDS = [(1, 1), (2, 1), (3, 1), (4, 1), (8, 2), (16, 1), (6, 1)]


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", list_archs())
def test_replan_matches_jax(arch, reduced):
    t, j = _both(arch, reduced)
    assert _asdict(t) == _asdict(j)
    for pp, tp in GRIDS:
        try:
            want = jax_elastic.replan(j, pp, tp)
        except ValueError as exc:
            with pytest.raises(ValueError) as got:
                elastic.replan(t, pp, tp)
            assert str(got.value) == str(exc)
            continue
        assert _asdict(elastic.replan(t, pp, tp)) == _asdict(want)


@pytest.mark.parametrize("case", ["qwen2.5-14b", "olmoe-1b-7b", "rwkv6-3b",
                                  "qwen8"])
def test_repartition_params_matches_jax(case):
    """Array by array equal to the JAX function's reshape on the same
    numpy tree, and views of the original storage."""
    if case == "qwen8":
        cfg = _qwen_pp4().with_plan(pp=1)
        cfg = dataclasses.replace(cfg, pattern=(BlockSpec(BlockKind.ATTN_MLP,
                                                          8),))
    else:
        cfg = make_reduced(get_config(case))
    cfg = dataclasses.replace(cfg, dtype="float32")
    params = init_params(cfg, 1)
    tree = {k: {n: t.numpy() for n, t in v.items()} if k != "stages" else
            {g: {n: t.numpy() for n, t in leaves.items()}
             for g, leaves in v.items()} for k, v in params.items()}
    total = cfg.layers_per_stage * cfg.plan.pp
    for pp in [p for p in (1, 2, 4, 8) if total % p == 0]:
        new = elastic.replan(cfg, pp, 1)
        got = elastic.repartition_params(params, cfg, new)
        want = jax_elastic.repartition_params(tree, cfg, new)
        for g, leaves in got["stages"].items():
            for n, ten in leaves.items():
                np.testing.assert_array_equal(ten.numpy(),
                                              want["stages"][g][n])
                assert ten.shape[:2] == (pp, total // pp)
                assert ten.untyped_storage().data_ptr() == \
                    params["stages"][g][n].untyped_storage().data_ptr()
        assert got["embed"]["tok"].data_ptr() == \
            params["embed"]["tok"].data_ptr()


def test_stage_config_refusals():
    """Non-divisors and heterogeneous patterns at another stage count are
    refused, as JAX refuses them: jamba's depth cut stays one stage."""
    jamba = get_config("jamba-1.5-large-398b")
    cut = cut_to_kinds(jamba, [BlockKind.MAMBA_MLP, BlockKind.MAMBA_MOE,
                               BlockKind.ATTN_MOE])
    with pytest.raises(ValueError, match="pinned to pp=1"):
        stage_config(cut, 2)
    with pytest.raises(ValueError, match="pinned to pp=1"):
        stage_config(single_stage(jamba), 8)
    with pytest.raises(ValueError, match="pinned"):
        serve_config("jamba-1.5-large-398b", reduced=True, pp=2,
                     cut=[BlockKind.MAMBA_MLP, BlockKind.ATTN_MOE])
    with pytest.raises(ValueError, match="don't tile pp=5"):
        serve_config("qwen1.5-0.5b", pp=5)
    with pytest.raises(ValueError, match="don't tile pp=4"):
        serve_config("qwen1.5-0.5b", reduced=True, pp=4)
    big, _ = serve_config("qwen2.5-14b", pp=4)
    assert big.plan.pp == 4 and big.pattern == (
        BlockSpec(BlockKind.ATTN_MLP, 12),) and big.num_layers == 48
    one, _ = serve_config("qwen2.5-14b")
    assert one.pattern == (BlockSpec(BlockKind.ATTN_MLP, 48),)
    assert one.padded_vocab == big.padded_vocab


# ------------------------------------------------------------ entry points

def test_build_serves_a_spec_at_pp2_on_cpu():
    from repro_torch.serving import ServeSpec, build
    server = build(ServeSpec(), pp=2, device="cpu")
    eng = server.replicas[0]
    assert eng.cfg.plan.pp == 2 and eng.scheduler.cfg.pipeline_depth == 2
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(0, eng.cfg.vocab_size, n)]
               for n in (5, 30)]
    rids = [server.submit(p, SamplingParams(max_new_tokens=4))
            for p in prompts]
    server.drain()
    outs = server.outputs(rids)
    for p, o in zip(prompts, outs):
        assert o.token_ids == greedy_generate(eng.cfg, eng.params, p, 4)
    assert eng.stats.bubble_stage_ticks > 0
    server.close()


def test_launcher_serves_pp2_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--pp", "2", "--requests", "3", "--max-new",
         "4"], env=env, cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr
    assert "3/3 requests, 12 tokens" in res.stdout
    assert res.stdout.rstrip().endswith("pp=2")
