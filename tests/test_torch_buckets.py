"""The port's bucketed serving on the CPU against the JAX package.

The ladder (`depth_steps`, `bucket_ladder`, `select_bucket`) and the
backend's metadata slicing (`_select_bucket`, `_slice_meta_field`,
`_stack_meta`) are held to the JAX functions on the same inputs: equal
shapes, equal selections, equal arrays.  The port's bucketed engine, in
sync and in async mode (its bucket programs run eagerly on the CPU), serves
the mixed two-wave workload of tests/test_async_dispatch.py on the reduced
qwen1.5-0.5b, rwkv6-3b and the jamba cut (one layer of each kind), f32:
greedy tokens equal the JAX sync unbucketed engine's exactly, and the port's
dense reference; each tick runs in the bucket JAX's `select_bucket` picks
for that tick's demands; the ladder pads strictly fewer tokens.  On rwkv6-3b
the JAX engine misses the dense reference on two of the six requests (the
first of each wave, both on slot 0: its padding rows scatter a stale copy of
slot 0's state, ROADMAP Queue 3), so there the port is held to the JAX
engine on the other four and to the dense reference on all six.  No
bucketed JAX engine is built: it compiles 36 programs.  A padding-row case pins the scratch page and slot:
with the pool's unowned pages and slots NaN-poisoned, a bucketed tick
leaves every page and slot bit-identical apart from the rows that write.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import BlockKind as JBlockKind
from repro.configs import BlockSpec as JBlockSpec
from repro.configs import get_config as jax_get_config
from repro.configs import make_reduced as jax_make_reduced
from repro.core import SamplingParams as JSamplingParams
from repro.core import ThrottleConfig as JThrottleConfig
from repro.models import serve as jserve
from repro.models import transformer as jtfm
from repro.runtime.engine import JaxBackend
from repro.runtime.engine import PipelineEngine as JaxEngine
from repro_torch.configs import BlockKind, cut_to_kinds, get_config, make_reduced
from repro_torch.core import SamplingParams, ThrottleConfig
from repro_torch.launch.serve import FULL_DIMS, REDUCED_DIMS
from repro_torch.models import serve as tserve
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.reference import greedy_generate
from repro_torch.models.serve import ServeDims
from repro_torch.runtime.engine import PipelineEngine, TorchBackend

DIMS = dict(Sp=1, C=16, Sd=8, pages=256, page=8, Bp=32, Bd=32, slots=16)
THROTTLE = dict(pipeline_depth=1, max_prefill_tokens=16,
                min_prefill_tokens=4, num_iters_T=2)
JAMBA = "jamba-1.5-large-398b"
JAMBA_KINDS = (BlockKind.MAMBA_MLP, BlockKind.MAMBA_MOE, BlockKind.ATTN_MOE)


def _jdims(d: ServeDims) -> jserve.ServeDims:
    return jserve.ServeDims(**dataclasses.asdict(d))


def _key(d) -> tuple:
    return (d.Sp, d.C, d.Sd, d.pages, d.page, d.Bp, d.Bd, d.slots, d.Te)


# ------------------------------------------------------------------ ladder

# the port's full and reduced cells, a decode-only cell, and the cells of
# tests/test_buckets.py (its default, and C=1 / Sd=1 collapsing the steps)
CELLS = {
    "full": FULL_DIMS,
    "reduced": REDUCED_DIMS,
    "decode_only": ServeDims(**{**DIMS, "Sp": 0}),
    "default": ServeDims(**DIMS),
    "c1_sd1": ServeDims(**{**DIMS, "C": 1, "Sd": 1}),
    "c2_sd1": ServeDims(**{**DIMS, "C": 2, "Sd": 1}),
    "c1_sd8": ServeDims(**{**DIMS, "C": 1}),
    "misaligned": ServeDims(**{**DIMS, "Bp": 30, "Bd": 20}),
}


@pytest.mark.parametrize("B", [0, 1, 7, 8, 24, 30, 32, 64, 128, 129])
@pytest.mark.parametrize("ppb, divisors", [(None, None), (8, (1,)),
                                           (4, (3, 2, 1)), (16, (8, 1))])
def test_depth_steps_match_jax(B, ppb, divisors):
    assert tserve.depth_steps(B, pages_per_block=ppb, divisors=divisors) == \
        jserve.depth_steps(B, pages_per_block=ppb, divisors=divisors)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_ladder_matches_jax(cell):
    dims = CELLS[cell]
    ladder = tserve.bucket_ladder(dims)
    assert [_key(b) for b in ladder] == \
        [_key(b) for b in jserve.bucket_ladder(_jdims(dims))]
    assert dims in ladder
    if cell in ("full", "reduced", "default"):
        assert len(ladder) == 36


def _demands(dims: ServeDims):
    """The demand grid: every (need_c, need_d) of a small cell, the step
    boundaries +-1 of a large one, and depth demands at the depth steps'
    boundaries +-1."""
    def axis(n):
        if n <= 32:
            return range(n + 1)
        return sorted({v for s in (1, n // 4, n // 2, n)
                       for v in (s - 1, s, s + 1) if 0 <= v <= n})

    def depth(B):
        return sorted({v for s in tserve.depth_steps(B) + (1,)
                       for v in (0, s - 1, s, s + 1) if 0 <= v <= B})

    for need_c in axis(dims.C if dims.Sp else 0):
        for need_d in axis(dims.Sd):
            if need_c == 0 and need_d == 0:
                continue
            for bp in depth(dims.Bp) if need_c else (0,):
                for bd in depth(dims.Bd) if need_d else (0,):
                    yield need_c, need_d, bp, bd


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_select_bucket_matches_jax_over_the_demand_grid(cell):
    dims = CELLS[cell]
    tl = tserve.bucket_ladder(dims)
    jl = jserve.bucket_ladder(_jdims(dims))
    n = 0
    for c, d, bp, bd in _demands(dims):
        got = tserve.select_bucket(tl, c, d, need_bp=bp, need_bd=bd)
        want = jserve.select_bucket(jl, c, d, need_bp=bp, need_bd=bd)
        assert _key(got) == _key(want), (c, d, bp, bd)
        n += 1
    assert n > 20


@pytest.mark.parametrize("cell", ["full", "default", "decode_only"])
def test_over_demand_raises_like_jax(cell):
    dims = CELLS[cell]
    tl = tserve.bucket_ladder(dims)
    jl = jserve.bucket_ladder(_jdims(dims))
    over = [(dims.C + 1, 0, 0, 0), (0, dims.Sd + 1, 0, 0),
            (1, 0, dims.Bp + 1, 0), (0, 1, 0, dims.Bd + 1)]
    for c, d, bp, bd in over:
        for fn, ladder in ((tserve.select_bucket, tl),
                           (jserve.select_bucket, jl)):
            with pytest.raises(ValueError, match="no bucket"):
                fn(ladder, c, d, need_bp=bp, need_bd=bd)


# ----------------------------------------------------------------- slicing

def _random_meta(dims: ServeDims, rng) -> dict:
    """Full-dims metadata with random contents (the chunk lengths and
    context lengths within what the cell can hold)."""
    meta = {}
    for k, a in tserve.zero_meta(dims).items():
        meta[k] = rng.integers(-1, 50, a.shape).astype(np.int32)
    meta["p_chunk_lens"] = rng.integers(0, dims.C + 1, dims.Sp).astype(
        np.int32)
    meta["p_context_lens"] = rng.integers(
        0, dims.page * dims.Bp + 1, dims.Sp).astype(np.int32)
    meta["d_valid"] = rng.integers(0, 2, dims.Sd).astype(np.int32)
    meta["d_context_lens"] = rng.integers(
        0, dims.page * dims.Bd + 1, dims.Sd).astype(np.int32)
    return meta


def _stubs(dims: ServeDims, bucketed: bool = True):
    """Minimal stand-ins for the two backends' `self`."""
    zm = tserve.zero_meta(dims)
    jax_self = types.SimpleNamespace(
        dims=_jdims(dims), bucketed=bucketed,
        ladder=jserve.bucket_ladder(_jdims(dims)),
        _zero_meta_np=lambda: zm,
        _slice_meta_field=JaxBackend._slice_meta_field)
    port_self = types.SimpleNamespace(
        dims=dims, bucketed=bucketed, ladder=tserve.bucket_ladder(dims),
        _zm=zm, _slice_meta_field=TorchBackend._slice_meta_field)
    return jax_self, port_self


@pytest.mark.parametrize("cell", ["default", "reduced", "decode_only"])
@pytest.mark.parametrize("depth", [1, 2])
def test_stack_and_slice_meta_match_jax(cell, depth):
    """For every bucket of the ladder and a ring of `depth` random entries:
    `_slice_meta_field`, `_stack_meta` and `_select_bucket` give JAX's."""
    dims = CELLS[cell]
    rng = np.random.default_rng(11 + depth)
    jax_self, port_self = _stubs(dims)
    for trial in range(3):
        ring = tuple((None, _random_meta(dims, rng)) for _ in range(depth))
        got_b = TorchBackend._select_bucket(port_self, ring)
        want_b = JaxBackend._select_bucket(jax_self, ring)
        assert _key(got_b) == _key(want_b)
        for bucket in port_self.ladder:
            got = TorchBackend._stack_meta(port_self, ring, bucket)
            want = JaxBackend._stack_meta(jax_self, ring, _jdims(bucket))
            assert list(got) == list(want)
            for k in got:
                np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                              err_msg=k)
                stacked = np.stack([m[1][k] for m in ring])
                np.testing.assert_array_equal(
                    TorchBackend._slice_meta_field(k, stacked, bucket),
                    JaxBackend._slice_meta_field(k, stacked,
                                                 _jdims(bucket)))
    # unbucketed: the full shape, whatever the demand
    jax_self, port_self = _stubs(dims, bucketed=False)
    ring = tuple((None, _random_meta(dims, rng)) for _ in range(depth))
    assert TorchBackend._select_bucket(port_self, ring) == dims


# ----------------------------------------------------------------- engines

def _cfgs(arch: str):
    """(jax cfg, port cfg), reduced, f32, pp=1; MoE dropless (capacity
    factor = number of experts), as tests/test_async_dispatch.py builds
    them; the jamba cut is one layer of each kind."""
    if arch == JAMBA:
        tcfg = cut_to_kinds(make_reduced(get_config(arch)), JAMBA_KINDS)
        jcfg = jax_make_reduced(jax_get_config(arch)).with_plan(
            pp=1, tp=1, ep_over_data=False)
        jcfg = dataclasses.replace(
            jcfg, num_layers=3, pattern=tuple(
                JBlockSpec(JBlockKind(k.value), 1) for k in JAMBA_KINDS))
    else:
        tcfg = make_reduced(get_config(arch)).with_plan(pp=1, tp=1)
        jcfg = jax_make_reduced(jax_get_config(arch)).with_plan(
            pp=1, tp=1, ep_over_data=False)
    cf = float(max(tcfg.num_experts, 1))
    return (dataclasses.replace(jcfg, dtype="float32", moe_capacity_factor=cf),
            dataclasses.replace(tcfg, dtype="float32", moe_capacity_factor=cf))


def _jax_params(jcfg):
    mesh = jax.make_mesh((1, 1, 1), ("data", "stage", "tensor"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)
    with jax.set_mesh(mesh):
        params = jtfm.init_params(jcfg, jax.random.key(0), dtype=jnp.float32)
        params = jax.tree.map(
            lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
            params, jtfm.param_pspecs(jcfg),
            is_leaf=lambda x: isinstance(x, P))
    return mesh, params


WAVES = ((7, 23, 37), (12, 5, 30))


def _prompts(vocab: int):
    rng = np.random.default_rng(5)
    return [[int(t) for t in rng.integers(0, vocab, int(n))]
            for wave in WAVES for n in wave]


def mixed_workload(eng, vocab: int, sampling_cls):
    """tests/test_async_dispatch.py's workload: two waves of single-chunk,
    multi-chunk and decode-heavy requests, interleaved with service so the
    ring sees bubbles and partial batches."""
    prompts = _prompts(vocab)
    reqs = []
    for w in range(len(WAVES)):
        for p in prompts[3 * w: 3 * w + 3]:
            reqs.append(eng.add_request(p, sampling_cls(max_new_tokens=6)))
        for _ in range(4):
            eng.step()
    eng.drain(max_ticks=2000)
    assert all(r.is_finished for r in reqs), [r.state for r in reqs]
    return [r.output_token_ids for r in reqs]


def _record_buckets(eng):
    """Log, per executed tick, the demands of the entering micro-batch (as
    JAX's `_select_bucket` reads them) and the bucket the port chose."""
    log = []
    backend = eng.backend
    inner = backend.execute
    page = backend.dims.page

    def execute(ring, exiting_id, now):
        res = inner(ring, exiting_id, now)
        m = ring[0][1]
        need = (int(m["p_chunk_lens"].max(initial=0)),
                int(np.count_nonzero(m["d_valid"])),
                -(-int(m["p_context_lens"].max(initial=0)) // page),
                -(-int(m["d_context_lens"].max(initial=0)) // page))
        b = backend.stats.last_bucket
        log.append((need, (b["Sp"], b["C"], b["Sd"], b["Bp"], b["Bd"])))
        return res

    backend.execute = execute
    return log


@pytest.fixture(scope="module", params=["qwen1.5-0.5b", "rwkv6-3b", JAMBA])
def served(request):
    """The mixed workload on the JAX sync unbucketed engine and on the
    port's bucketed engine in sync and in async mode, from one set of
    weights."""
    jcfg, tcfg = _cfgs(request.param)
    mesh, jparams = _jax_params(jcfg)
    with jax.set_mesh(mesh):
        jeng = JaxEngine(jcfg, _jdims(ServeDims(**DIMS)), jparams, mesh,
                         JThrottleConfig(**THROTTLE))
    want = mixed_workload(jeng, jcfg.vocab_size, JSamplingParams)
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    dense = [greedy_generate(tcfg, tparams, p, 6)
             for p in _prompts(tcfg.vocab_size)]
    out = {"arch": request.param, "want": want, "dense": dense,
           "jstats": jeng.stats, "tparams": tparams, "tcfg": tcfg}
    for mode in ("sync", "async"):
        eng = PipelineEngine(tcfg, ServeDims(**DIMS), tparams,
                             ThrottleConfig(**THROTTLE), device="cpu",
                             bucketed=True, async_dispatch=mode == "async")
        log = _record_buckets(eng)
        out[mode] = dict(eng=eng, log=log, tokens=mixed_workload(
            eng, tcfg.vocab_size, SamplingParams))
    return out


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_bucketed_tokens_match_jax_sync_engine(served, mode):
    got, want, dense = served[mode]["tokens"], served["want"], served["dense"]
    assert got == dense, served["arch"]
    jax_right = [i for i in range(len(want)) if want[i] == dense[i]]
    assert [got[i] for i in jax_right] == [want[i] for i in jax_right]
    if served["arch"] != "rwkv6-3b":
        assert len(jax_right) == len(want)
    else:
        assert len(jax_right) >= 4


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_each_tick_runs_in_jax_selected_bucket(served, mode):
    ladder = jserve.bucket_ladder(_jdims(ServeDims(**DIMS)))
    log = served[mode]["log"]
    assert log and len(log) == served[mode]["eng"].stats.ticks
    for (c, d, bp, bd), got in log:
        want = jserve.select_bucket(ladder, c, d, need_bp=bp if c else 0,
                                    need_bd=bd if d else 0)
        assert got == (want.Sp, want.C, want.Sd, want.Bp, want.Bd)
    assert len({b for _, b in log}) > 2          # the ladder is walked


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_bucketed_pads_fewer_tokens_than_unbucketed(served, mode):
    st, jst = served[mode]["eng"].stats, served["jstats"]
    assert st.scheduled_prefill == jst.scheduled_prefill
    assert st.scheduled_decode == jst.scheduled_decode
    assert (st.padded_prefill + st.padded_decode
            < jst.padded_prefill + jst.padded_decode)
    full = ServeDims(**DIMS)
    assert st.scanned_pages < st.ticks * (full.Sp * full.Bp
                                          + full.Sd * full.Bd)


def test_async_tick_count_equals_sync(served):
    """On the CPU `ready()` is always true: every deferred readback is
    retired at the top of the next step, and the async loop runs exactly
    the sync loop's ticks."""
    assert served["async"]["eng"].stats.ticks == \
        served["sync"]["eng"].stats.ticks


def test_bucket_programs_are_built_once(served):
    """warm_start builds every ladder program; serving builds none (on the
    CPU no graph is captured)."""
    backend = served["sync"]["eng"].backend
    assert len(backend._programs) == len(backend.ladder) == 36
    assert backend.graph_count() == 0


# ------------------------------------------------------------- padding rows

@pytest.mark.parametrize("arch", ["rwkv6-3b", JAMBA])
def test_padding_rows_leave_owned_pages_and_slots_alone(arch):
    """Mid-serve, every KV page and state slot no request owns (and the
    scratch page and slot) is NaN-poisoned; one bucketed tick with padding
    rows then leaves every page and slot bit-identical apart from the
    (page, offset) positions and slots its live rows write, and its tokens
    are valid."""
    _, tcfg = _cfgs(arch)
    from repro_torch.models.transformer import init_params
    dims = ServeDims(**DIMS)
    eng = PipelineEngine(tcfg, dims, init_params(tcfg, 0),
                         ThrottleConfig(**THROTTLE), device="cpu",
                         bucketed=True)
    rng = np.random.default_rng(9)
    for n in (9, 12, 4):         # three decode rows by the fifth tick
        eng.add_request([int(t) for t in rng.integers(0, tcfg.vocab_size, n)],
                        SamplingParams(max_new_tokens=8))
    for _ in range(4):
        eng.step()
    backend = eng.backend
    owned_pages = {p for rid in list(eng.slots.owner)
                   for p in eng.kv.block_table(rid)}
    owned_slots = set(eng.slots.owner.values())
    assert 0 in owned_pages and 0 in owned_slots
    dead_pages = [p for p in range(dims.pages + 1) if p not in owned_pages]
    dead_slots = [s for s in range(dims.slots + 1) if s not in owned_slots]
    for grp in backend.caches.values():
        for name, t in grp.items():
            if name == "kv":
                t[:, :, dead_pages] = float("nan")
            else:
                t[:, :, dead_slots] = float("nan")
    before = {(g, n): t.clone() for g, grp in backend.caches.items()
              for n, t in grp.items()}
    seen = {}
    inner = backend.execute

    def execute(ring, exiting_id, now):
        seen["meta"] = ring[0][1]
        return inner(ring, exiting_id, now)

    backend.execute = execute
    toks_before = {r.request_id: list(r.output_token_ids)
                   for r in eng.scheduler.running_decode}
    eng.step()
    m = seen["meta"]
    b = backend.stats.last_bucket
    assert b["Sd"] > int(np.count_nonzero(m["d_valid"]))   # padding rows
    written_pos = set()
    for s, n in enumerate(m["p_chunk_lens"]):
        for j in range(n):
            written_pos.add((m["p_slot_pages"][s, j], m["p_slot_offsets"][s, j]))
    live_d = np.flatnonzero(m["d_valid"])
    for s in live_d:
        written_pos.add((m["d_slot_pages"][s], m["d_slot_offsets"][s]))
    written_slots = ({int(m["p_state_slots"][s])
                      for s in np.flatnonzero(m["p_chunk_lens"])}
                     | {int(m["d_state_slots"][s]) for s in live_d})
    assert written_pos or written_slots
    checked = 0
    for (g, n), old in before.items():
        new = backend.caches[g][n]
        if n == "kv":
            for p in range(dims.pages):
                for o in range(dims.page):
                    if (p, o) in written_pos:
                        continue
                    assert torch.equal(new[:, :, p, o].view(torch.int32),
                                       old[:, :, p, o].view(torch.int32)), \
                        (g, p, o)
                    checked += 1
        else:
            for s in range(dims.slots):
                if s in written_slots:
                    continue
                assert torch.equal(new[:, :, s].view(torch.int32),
                                   old[:, :, s].view(torch.int32)), (g, n, s)
                checked += 1
    assert checked
    for r in eng.scheduler.running_decode:
        got = r.output_token_ids
        assert len(got) >= len(toks_before.get(r.request_id, []))
        assert all(0 <= t < tcfg.vocab_size for t in got)
