"""The port's Mamba slice on the CPU against the JAX package: the selective
scan's plain version, the mixer, the MAMBA_MLP and MAMBA_MOE blocks, the
dense reference and the serving engine, on the reduced jamba-1.5-large-398b
(d=64, d_inner=128, d_state=8) cut to one layer of each block kind
(MAMBA_MLP, MAMBA_MOE, ATTN_MOE), f32, dropless.

Inputs are made with numpy from a seed and handed to both packages; the
JAX weights are carried across with `params_from_numpy`.  Tolerances:
  * f32, the same sequential recurrence in another summation order:
    1e-5 absolute times max(|oracle|, 1), as tests/test_kernels.py's
    oracles;
  * the Pallas kernel (doubling scan within a chunk, interpret mode): 1e-4
    times max(|oracle|, 1), tests/test_kernels.py's bound for the chunked
    scans;
  * bf16 x: both packages convert it to f32 exactly; the JAX oracle rounds
    its result to x's dtype only when fed bf16, so it is fed f32 here;
  * mixer, blocks and logits: 1e-5 (outputs of order 1; logits 1e-4);
  * engines and greedy decoding: equal tokens.

JAX's greedy_generate recompiles per length (~50 s a request on a CPU),
so the port's engine is held to the JAX engine, the port's
dense_forward logits to JAX's at one length, and the port's own
greedy_generate serves as the token reference.  Two serving cases hold the
port to that reference where the JAX engine has latent faults (ROADMAP
Queue 3: padding rows scatter stale slot-0 state, a reused slot keeps the
previous request's state); for Mamba the tokens do not show them, so
`test_serve_block_keeps_to_its_slots` pins the port at the state itself.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

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
from repro.kernels import ref as jref
from repro.kernels.mamba_scan import mamba_chunked_scan as jax_kernel
from repro.models import reference as jax_reference
from repro.models import serve as jserve
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro.models.serve import ServeDims as JServeDims
from repro.runtime.engine import PipelineEngine as JaxEngine
from repro_torch.configs import (
    BlockKind,
    BlockSpec,
    cut_to_kinds,
    get_config,
    make_reduced,
    single_stage,
)
from repro_torch.core import SamplingParams, ThrottleConfig
from repro_torch.kernels import mamba_scan as s6
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import serve as tserve
from repro_torch.models import ssm
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.reference import dense_forward, greedy_generate
from repro_torch.models.serve import ServeDims
from repro_torch.models.transformer import init_params, model_param_defs
from repro_torch.runtime.engine import PipelineEngine

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-5
ARCH = "jamba-1.5-large-398b"
KINDS = (BlockKind.MAMBA_MLP, BlockKind.MAMBA_MOE, BlockKind.ATTN_MOE)
DIMS = dict(Sp=1, C=16, Sd=8, pages=256, page=8, Bp=32, Bd=32, slots=16)
THROTTLE = dict(pipeline_depth=1, max_prefill_tokens=16,
                min_prefill_tokens=4, num_iters_T=2)
PROMPT_LENS = (7, 23, 12, 41)        # 23 and 41 exceed C=16
MAX_NEW = 5


def _cfgs():
    """(jax cfg, port cfg): reduced jamba cut to one layer of each kind,
    f32, pp=1, dropless (capacity factor = number of experts), as
    tests/test_engine_equivalence.py::build makes its configs."""
    tcfg = cut_to_kinds(make_reduced(get_config(ARCH)), KINDS)
    cf = float(tcfg.num_experts)
    tcfg = dataclasses.replace(tcfg, dtype="float32", moe_capacity_factor=cf)
    jcfg = jax_make_reduced(jax_get_config(ARCH)).with_plan(
        pp=1, tp=1, ep_over_data=False)
    jcfg = dataclasses.replace(
        jcfg, dtype="float32", moe_capacity_factor=cf, num_layers=3,
        pattern=tuple(JBlockSpec(JBlockKind(k.value), 1) for k in KINDS))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def models():
    """Both configs, the JAX weights (seed 0) and their port copy."""
    jcfg, tcfg = _cfgs()
    mesh = jax.make_mesh((1, 1, 1), ("data", "stage", "tensor"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)
    with jax.set_mesh(mesh):
        jparams = jtfm.init_params(jcfg, jax.random.key(0), dtype=jnp.float32)
        jparams = jax.tree.map(
            lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
            jparams, jtfm.param_pspecs(jcfg),
            is_leaf=lambda x: isinstance(x, P))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                mesh=mesh)


def _port_engine(m):
    return PipelineEngine(m["tcfg"], ServeDims(**DIMS), m["tparams"],
                          ThrottleConfig(**THROTTLE), device="cpu")


def _record_ticks(backend):
    """Wrap `backend.prepare` to log each tick's batch composition."""
    ticks = []
    inner = backend.prepare

    def prepare(batch):
        if batch is not None:
            ticks.append((
                tuple((s.request.request_id, s.num_tokens)
                      for s in batch.prefill),
                tuple(s.request.request_id for s in batch.decode)))
        return inner(batch)

    backend.prepare = prepare
    return ticks


# ------------------------------------------------------- the selective scan

# B, T, di, ds, Pallas chunk: T = 40 and 70 are not multiples of the
# kernel's 32-token runs
SHAPES = [(2, 64, 32, 8, 16), (1, 128, 64, 16, 64), (1, 40, 48, 16, 8),
          (2, 70, 32, 8, 35)]


def _scan_inputs(S, T, di, ds, seed):
    """dt log-uniform in [1e-3, 1], x, B, C unit normal, A = -(1..ds)
    (jamba's init) on every channel, as f32 numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    dt = np.exp(rng.uniform(np.log(1e-3), 0.0, (S, T, di))).astype(f)
    A = -np.broadcast_to(np.arange(1, ds + 1, dtype=f), (di, ds)).copy()
    return (dt, rng.normal(size=(S, T, di)).astype(f),
            rng.normal(size=(S, T, ds)).astype(f),
            rng.normal(size=(S, T, ds)).astype(f), A)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_scan_matches_jax_oracle_and_pallas(shape, dtype):
    """At zero state and full lengths the plain version computes the Pallas
    kernel's function on dA = exp(dt A) and dBx = dt B x formed from the
    same inputs (x rounded to `dtype` first)."""
    S, T, di, ds, chunk = shape
    dt, x, B, C, A = _scan_inputs(S, T, di, ds, seed=sum(shape))
    x = np.array(jnp.asarray(x, getattr(jnp, dtype)).astype(jnp.float32))
    dA = np.exp(dt[..., None] * A)
    dBx = dt[..., None] * B[:, :, None, :] * x[..., None]
    jargs = [jnp.asarray(a) for a in (dA, dBx, C)]
    state = torch.zeros(S, di, ds)
    ones = torch.ones(S, dtype=torch.int32)
    got = s6.mamba_scan_ref(
        torch.from_numpy(dt), torch.from_numpy(x).to(getattr(torch, dtype)),
        torch.from_numpy(B), torch.from_numpy(C), torch.from_numpy(A), state,
        torch.arange(S, dtype=torch.int32), ones * T, ones).numpy()
    want_ref = np.asarray(jref.mamba_scan_ref(*jargs))
    want_pallas = np.asarray(jax_kernel(*jargs, chunk=chunk, interpret=True))
    scale = max(float(np.abs(want_ref).max()), 1.0)
    np.testing.assert_allclose(got, want_ref, atol=ATOL * scale, rtol=0)
    np.testing.assert_allclose(got, want_pallas, atol=1e-4 * scale, rtol=0)
    assert torch.isfinite(state).all() and state.abs().max() > 0


def _poisoned_case(S, T, di, ds, lens, fresh, n, dtype, seed):
    """dt log-uniform in [1e-3, 3], A = -exp(log(1..ds) + 0.3 N); live rows
    on distinct slots, padding rows on slot 0; NaN in every slot but the
    non-fresh live rows'."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    dt = torch.from_numpy(np.exp(rng.uniform(np.log(1e-3), np.log(3.0),
                                             (S, T, di))).astype(np.float32))
    x = normal(S, T, di).to(dtype)
    B, C = normal(S, T, ds), normal(S, T, ds)
    A = -torch.exp(torch.log(torch.arange(1, ds + 1).float())[None, :]
                   + 0.3 * normal(di, ds))
    state = torch.full((n, di, ds), float("nan"))
    slots = rng.permutation(n)[:S].astype(np.int32)
    for s in range(S):
        if lens[s] == 0:
            slots[s] = 0
        elif not fresh[s]:
            state[slots[s]] = normal(di, ds) * 3
    ints = [torch.tensor(a, dtype=torch.int32) for a in (slots, lens, fresh)]
    return [dt, x, B, C, A, state, *ints]


def test_plain_scan_keeps_to_its_rows_and_slots():
    """Fresh rows read none of their slot's NaN poison, padding rows (on
    slot 0, which a live row owns) and unowned slots are left bit-identical,
    the output past each row's length is 0, and a carried state is read:
    running a row in two pieces equals one pass."""
    args = _poisoned_case(5, 20, 24, 8, [20, 9, 0, 1, 0], [1, 0, 0, 0, 0], 8,
                          torch.float32, seed=3)
    state, slots = args[5], args[6]
    state[0] = state[slots[1]]              # a live row owns slot 0
    state[slots[1]] = float("nan")
    slots[1] = 0
    before = state.clone()
    out = s6.mamba_scan_ref(*args)
    assert torch.isfinite(out).all()
    lens = args[7].tolist()
    for s, n in enumerate(lens):
        assert not out[s, n:].any()
    owned = {int(args[6][s]) for s in range(5) if lens[s] > 0}
    for slot in range(8):
        same = torch.equal(state[slot].view(torch.int32),
                           before[slot].view(torch.int32))
        assert same == (slot not in owned), slot
        if slot in owned:
            assert torch.isfinite(state[slot]).all()
    # row 0 (fresh, 20 tokens) in two pieces of 12 and 8 through a carried
    # state equals the one pass above
    dt, x, B, C = (a[:1] for a in args[:4])
    A = args[4]
    pool = torch.full((2, 24, 8), float("nan"))
    one = torch.ones(1, dtype=torch.int32)
    y1 = s6.mamba_scan_ref(dt[:, :12], x[:, :12], B[:, :12], C[:, :12], A,
                           pool, one, one * 12, one)
    y2 = s6.mamba_scan_ref(dt[:, 12:], x[:, 12:], B[:, 12:], C[:, 12:], A,
                           pool, one, one * 8, one * 0)
    torch.testing.assert_close(torch.cat([y1, y2], 1), out[:1], rtol=0,
                               atol=1e-6)
    torch.testing.assert_close(pool[1], state[int(args[6][0])], rtol=0,
                               atol=1e-6)


def _simulated_kernel(dt, x, B, C, A, state, slots, lens, fresh,
                      planted=False):
    """The recurrence in float64, cast to f32 (the kernel's arithmetic up to
    its f32 roundings); `planted` reads h_{t-1} in place of h_t for y_t, the
    off-by-one chip_smoke.py plants in the kernel.  Returns (out, pool)."""
    S, T, di = dt.shape
    out = torch.zeros(S, T, di, dtype=torch.float64)
    pool = state.clone()
    for s in range(S):
        L, sl = int(lens[s]), int(slots[s])
        if L == 0:
            continue
        h = (torch.zeros(di, A.shape[1], dtype=torch.float64) if fresh[s]
             else state[sl].double())
        for t in range(L):
            d = dt[s, t].double()
            nxt = torch.exp(d[:, None] * A.double()) * h \
                + (d * x[s, t].double())[:, None] * B[s, t].double()[None]
            read = h if planted else nxt
            out[s, t] = (read * C[s, t].double()[None]).sum(-1)
            h = nxt
        pool[sl] = h.float()
    return out.float(), pool


# chip_smoke.py's mamba-kernel cases cut for the CPU: decode rows over a
# pool, a prefill chunk with a carried state and a live prefix, a ragged
# batch with ds = 8
CHECK_CASES = {
    "decode": (8, 1, 64, 16, [1] * 6 + [0] * 2, [0] * 8, 16),
    "prefill": (1, 96, 64, 16, [60], [0], 4),
    "ragged": (3, 40, 48, 8, [40, 7, 0], [1, 0, 0], 6),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CHECK_CASES))
def test_tolerance_admits_exact_arithmetic_and_rejects_off_by_one(name,
                                                                  dtype):
    args = _poisoned_case(*CHECK_CASES[name], dtype, seed=len(name))
    before = args[5]
    inputs, rows = args[:5], args[6:]
    out, pool = _simulated_kernel(*args)
    assert s6.excess(out, pool, *inputs, before, *rows)[0] <= 1.0
    out, pool = _simulated_kernel(*args, planted=True)
    assert s6.excess(out, pool, *inputs, before, *rows)[0] > 100.0
    # a kernel that writes a slot no live row owns fails outright
    owned = {int(s) for s, n in zip(rows[0], rows[1]) if n > 0}
    spare = min(set(range(before.shape[0])) - owned)
    out, pool = _simulated_kernel(*args)
    pool[spare] = 0.0
    assert s6.excess(out, pool, *inputs, before, *rows)[0] == float("inf")


def test_ops_cpu_takes_plain_path_without_launching():
    s6.launches = 0
    args = _poisoned_case(3, 10, 16, 8, [10, 4, 0], [0, 1, 0], 4,
                          torch.float32, seed=5)
    state = args[5].clone()
    out = ops.mamba_scan(*args[:5], state, *args[6:])
    want = s6.mamba_scan_ref(*args)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert torch.equal(state.view(torch.int32), args[5].view(torch.int32))
    assert s6.launches == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    args = _poisoned_case(2, 4, 16, 16, [4, 4], [1, 1], 2, torch.float32,
                          seed=6)
    with pytest.raises(ValueError, match="CUDA"):
        s6.mamba_chunked_scan(*args)
    assert s6.launches == 0


def test_kernel_modules_import_without_nvcc():
    """The Mamba kernel builds at first use: its modules import in a
    process with no nvcc on PATH and no CUDA_HOME, and build nothing."""
    code = ("import repro_torch.kernels.mamba_scan, repro_torch.models.ssm\n"
            "from repro_torch.kernels import build\n"
            "assert 'mamba_scan' in build.KERNELS\n"
            "assert build._libs == {} and build.build_log == {}\n"
            "try:\n    build.nvcc()\nexcept RuntimeError:\n    print('ok')\n")
    env = {"PATH": "", "PYTHONPATH": str(ROOT / "src"),
           "CUDA_HOME": "/nonexistent"}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


# ------------------------------------------------------------ the mixer

Bn, T, D_MODEL, DI, DS, DC = 4, 12, 64, 128, 16, 4
CHUNK_LENS = np.array([12, 5, 0, 1], np.int32)


def _mixer_params(seed):
    """numpy Mamba weights with a spread of step sizes (dt_bias in
    [-4, 1]) and a nonzero conv bias."""
    rng = np.random.default_rng(seed)
    dtr = max(8, D_MODEL // 16)
    p = {"in_proj": rng.normal(size=(D_MODEL, 2 * DI)) * 0.15,
         "conv_w": rng.normal(size=(DC, DI)) * 0.4,
         "conv_b": rng.normal(size=DI) * 0.1,
         "x_proj": rng.normal(size=(DI, dtr + 2 * DS)) * 0.15,
         "dt_proj": rng.normal(size=(dtr, DI)) * 0.3,
         "dt_bias": rng.uniform(-4, 1, DI),
         "A_log": np.log(np.arange(1, DS + 1))[None, :]
         + 0.2 * rng.normal(size=(DI, DS)),
         "D": 1 + 0.1 * rng.normal(size=DI),
         "out_proj": rng.normal(size=(DI, D_MODEL)) * 0.1}
    return {k: np.asarray(v, np.float32) for k, v in p.items()}


def _mixer_state(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(Bn, T, D_MODEL)).astype(np.float32)
    conv = rng.normal(size=(Bn, DC - 1, DI)).astype(np.float32)
    h = (rng.normal(size=(Bn, DI, DS)) * 0.5).astype(np.float32)
    return x, conv, h


def _port_state(conv, h, fresh=0):
    return ssm.MambaState(conv=torch.from_numpy(conv),
                          ssm=torch.from_numpy(h.copy()),
                          slots=torch.arange(len(conv), dtype=torch.int32),
                          fresh=torch.full((len(conv),), fresh,
                                           dtype=torch.int32))


def test_mixer_matches_jax_with_state_and_ragged_lengths():
    """Carried conv and scan state, ragged lengths (one row with none):
    equal outputs on the live positions, equal new conv and scan states."""
    p = _mixer_params(seed=1)
    x, conv, h = _mixer_state(seed=2)
    valid = np.arange(T)[None, :] < CHUNK_LENS[:, None]
    jout, jnew = jssm.mamba_mixer(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
        d_state=DS, d_conv=DC,
        state=jssm.MambaState(conv=jnp.asarray(conv), ssm=jnp.asarray(h)),
        valid=jnp.asarray(valid), chunk_lens=jnp.asarray(CHUNK_LENS))
    tstate = _port_state(conv, h)
    tout, tconv = ssm.mamba_mixer(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
        d_state=DS, d_conv=DC, state=tstate,
        chunk_lens=torch.from_numpy(CHUNK_LENS))
    tpool = tstate.ssm
    np.testing.assert_allclose(tout.numpy()[valid], np.asarray(jout)[valid],
                               atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tconv.numpy(), np.asarray(jnew.conv))
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jnew.ssm),
                               atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tpool.numpy()[2], h[2])       # len 0
    np.testing.assert_array_equal(tconv.numpy()[2], conv[2])
    # the step sizes really span short and long memories
    xt = {k: torch.from_numpy(v) for k, v in p.items()}
    assert float(torch.nn.functional.softplus(xt["dt_bias"]).min()) < 0.05


def test_mixer_in_two_pieces_equals_one_pass():
    """The twin of tests/test_ssm.py::TestMamba::test_chunked_equals_full:
    [0:T/2] then [T/2:T] with the carried state equals one pass from zero
    state, output, conv state and scan state."""
    p = {k: torch.from_numpy(v) for k, v in _mixer_params(seed=3).items()}
    x = torch.from_numpy(_mixer_state(seed=4)[0])
    one = ssm.mamba_init_state(Bn, DI, DS, DC, torch.float32)
    full, conv_full = ssm.mamba_mixer(x, p, d_state=DS, d_conv=DC, state=one)
    st = ssm.mamba_init_state(Bn, DI, DS, DC, torch.float32)
    h1, conv = ssm.mamba_mixer(x[:, :T // 2], p, d_state=DS, d_conv=DC,
                               state=st)
    st = st._replace(conv=conv, fresh=torch.zeros(Bn, dtype=torch.int32))
    h2, conv = ssm.mamba_mixer(x[:, T // 2:], p, d_state=DS, d_conv=DC,
                               state=st)
    torch.testing.assert_close(torch.cat([h1, h2], 1), full, rtol=0,
                               atol=ATOL)
    torch.testing.assert_close(conv, conv_full, rtol=0, atol=0)
    torch.testing.assert_close(st.ssm, one.ssm, rtol=0, atol=ATOL)
    # with no state the mixer runs from zeros: the same output
    torch.testing.assert_close(
        ssm.mamba_mixer(x, p, d_state=DS, d_conv=DC)[0], full, rtol=0,
        atol=0)


# ---------------------------------------------------- blocks, config, params

def _serve_block(cfg, kind, bkey, tparams, meta, dims, x, conv, h):
    """The port's one-block stage (`stage_forward_serve`) on a copy of the
    state, with the scratch slot the engine's pools end in (zeros) after
    the `dims.slots` slots given: returns (xp, xd, conv pool, ssm pool)
    without it."""
    one = dataclasses.replace(cfg, pattern=(BlockSpec(kind, 1),),
                              num_layers=1)
    key = f"b0_{kind.value}"
    params = {key: {k: v for k, v in tparams["stages"][bkey].items()}}

    def pool(a):
        return torch.from_numpy(np.concatenate(
            [a, np.zeros_like(a[:1])]))[None, None]

    caches = {key: {"conv": pool(conv), "ssm": pool(h)}}
    m = {k: torch.from_numpy(a) for k, a in tserve.host_meta(meta,
                                                             dims).items()}
    xp, xd, _ = tserve.stage_forward_serve(
        one, params, caches, torch.from_numpy(x[0]), torch.from_numpy(x[1]),
        m, dims)
    return (xp, xd, caches[key]["conv"][0, 0, :-1],
            caches[key]["ssm"][0, 0, :-1])


BLOCK_DIMS = dict(Sp=1, C=8, Sd=4, pages=8, page=8, Bp=2, Bd=2, slots=8)


def _block_inputs(cfg, seed):
    """A second prefill chunk (6 live tokens of 8, at positions 10..15, on
    slot 5) and 4 live decode rows on slots 1, 2, 3 and 7, every row on
    its own slot and none fresh; the pool carries random state."""
    rng = np.random.default_rng(seed)
    dims = ServeDims(**BLOCK_DIMS)
    meta = tserve.zero_meta(dims)
    meta["p_chunk_lens"][0] = 6
    meta["p_positions"][0, :6] = 10 + np.arange(6)
    meta["p_state_slots"][0] = 5
    meta["d_valid"][:] = 1
    meta["d_positions"][:] = [3, 9, 30, 17]
    meta["d_state_slots"][:] = [1, 2, 3, 7]
    d, di = cfg.d_model, cfg.mamba_d_inner
    x = (rng.normal(size=(1, 8, d)).astype(np.float32),
         rng.normal(size=(4, 1, d)).astype(np.float32))
    conv = rng.normal(size=(8, cfg.mamba_d_conv - 1, di)).astype(np.float32)
    h = (rng.normal(size=(8, di, cfg.mamba_d_state)) * 0.5).astype(
        np.float32)
    return dims, meta, x, conv, h


@pytest.mark.parametrize("index,kind", [(0, BlockKind.MAMBA_MLP),
                                        (1, BlockKind.MAMBA_MOE)],
                         ids=["mamba_mlp", "mamba_moe"])
def test_serve_block_matches_jax_with_state(models, index, kind):
    """One MAMBA_MLP and one MAMBA_MOE block (dropless) over a prefill chunk
    and decode rows that carry state: the port's serve block against JAX's
    `block_apply_serve`, outputs and both state pools."""
    jcfg, tcfg = models["jcfg"], models["tcfg"]
    bkey = f"b{index}_{kind.value}"
    dims, meta, x, conv, h = _block_inputs(tcfg, seed=10 + index)
    jp = jax.tree.map(lambda a: a[0, 0], models["jparams"]["stages"][bkey])
    apply = jax.jit(jserve.block_apply_serve, static_argnums=(0, 1, 7))
    jxp, jxd, jcache, _ = apply(
        jcfg, JBlockKind(kind.value), jp, jnp.asarray(x[0]),
        jnp.asarray(x[1]), {"conv": jnp.asarray(conv), "ssm": jnp.asarray(h)},
        {k: jnp.asarray(v) for k, v in meta.items()},
        JServeDims(**BLOCK_DIMS))
    xp, xd, tconv, tssm = _serve_block(tcfg, kind, bkey, models["tparams"],
                                       meta, dims, x, conv, h)
    np.testing.assert_allclose(xp.numpy()[0, :6], np.asarray(jxp)[0, :6],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(xd.numpy(), np.asarray(jxd), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tconv.numpy(), np.asarray(jcache["conv"]),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(tssm.numpy(), np.asarray(jcache["ssm"]),
                               atol=ATOL, rtol=0)
    assert not np.array_equal(tssm.numpy()[[1, 5]], h[[1, 5]])   # advanced


def test_serve_block_keeps_to_its_slots(models):
    """The two latent JAX faults, pinned at the state: a fresh prefill row
    on a NaN-poisoned slot gives finite output equal to a zero-state run; a
    padding decode row that carries slot 0, while a live decode row holds
    slot 0, leaves slot 0's conv and scan state exactly as the live row
    wrote them (the same as with the padding rows on another slot); slots
    no live row owns come back bit-identical."""
    tcfg = models["tcfg"]
    kind, bkey = BlockKind.MAMBA_MOE, "b1_mamba_moe"
    dims, meta, x, conv, h = _block_inputs(tcfg, seed=20)
    meta["p_positions"][0, :6] = np.arange(6)          # a new request
    meta["d_valid"][:] = [1, 0, 0, 0]
    meta["d_state_slots"][:] = [0, 0, 0, 0]            # padding on slot 0
    poisoned_conv, poisoned_h = conv.copy(), h.copy()
    poisoned_conv[[4, 5, 6]] = np.nan
    poisoned_h[[4, 5, 6]] = np.nan
    clean_conv, clean_h = poisoned_conv.copy(), poisoned_h.copy()
    clean_conv[5], clean_h[5] = 0.0, 0.0
    run = _serve_block(tcfg, kind, bkey, models["tparams"], meta, dims, x,
                       poisoned_conv, poisoned_h)
    zero = _serve_block(tcfg, kind, bkey, models["tparams"], meta, dims, x,
                        clean_conv, clean_h)
    assert torch.isfinite(run[0][0, :6]).all()
    torch.testing.assert_close(run[0], zero[0], rtol=0, atol=0)
    torch.testing.assert_close(run[1][0], zero[1][0], rtol=0, atol=0)
    for pool in (2, 3):
        torch.testing.assert_close(run[pool][5], zero[pool][5], rtol=0,
                                   atol=0)
    meta_else = {k: v.copy() for k, v in meta.items()}
    meta_else["d_state_slots"][1:] = 6                 # padding elsewhere
    other = _serve_block(tcfg, kind, bkey, models["tparams"], meta_else,
                         dims, x, poisoned_conv, poisoned_h)
    before = {2: poisoned_conv, 3: poisoned_h}
    for pool in (2, 3):
        got = run[pool]
        assert torch.equal(got[0], other[pool][0])     # as the live row wrote
        assert not torch.equal(got[0], torch.from_numpy(before[pool][0]))
        for slot in (1, 2, 3, 4, 6, 7):                # owned by no live row
            assert torch.equal(got[slot].view(torch.int32),
                               torch.from_numpy(before[pool][slot]).view(
                                   torch.int32)), (pool, slot)


def test_reduced_jamba_config_matches_jax(models):
    jcfg, tcfg = models["jcfg"], models["tcfg"]
    for f in ("d_model", "d_ff", "num_layers", "mamba_d_inner",
              "mamba_d_state", "mamba_d_conv", "num_experts",
              "num_experts_per_tok", "moe_d_ff", "moe_capacity_factor",
              "num_heads", "num_kv_heads", "head_dim", "rope_theta",
              "vocab_size", "norm", "norm_eps", "layers_per_stage"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert [b.kind.value for b in tcfg.pattern] == [
        b.kind.value for b in jcfg.pattern]


def test_single_stage_folds_jamba_and_cut_keeps_one_layer_per_kind():
    full = get_config(ARCH)
    one = single_stage(full)
    assert one.plan.pp == 1 and one.num_layers == one.layers_per_stage == 72
    assert len(one.pattern) == 72 and all(b.repeat == 1 for b in one.pattern)
    stage = [b.kind for b in full.pattern]
    assert [b.kind for b in one.pattern] == stage * 8
    cut = cut_to_kinds(full, KINDS)
    assert [(b.kind, b.repeat) for b in cut.pattern] == [(k, 1)
                                                         for k in KINDS]
    assert cut.num_layers == cut.layers_per_stage == 3
    assert (cut.d_model, cut.mamba_d_inner, cut.num_experts,
            cut.moe_d_ff) == (8192, 16384, 16, 24576)
    two = cut_to_kinds(full, (BlockKind.ATTN_MOE, BlockKind.MAMBA_MLP))
    assert [b.kind for b in two.pattern] == [BlockKind.MAMBA_MLP,
                                             BlockKind.ATTN_MOE]
    with pytest.raises(ValueError, match="rwkv"):
        cut_to_kinds(full, (BlockKind.RWKV,))


def test_params_from_numpy_carries_jamba_tree(models):
    """Every Mamba, MoE and attention leaf carries across key for key,
    unchanged."""
    tree = jax.tree.map(np.asarray, models["jparams"])
    for bkey, n in (("b0_mamba_mlp", 14), ("b1_mamba_moe", 15),
                    ("b2_attn_moe", 10)):
        block = tree["stages"][bkey]
        got = models["tparams"]["stages"][bkey]
        assert set(got.keys()) == set(block) and len(block) == n, bkey
        for k, a in block.items():
            np.testing.assert_array_equal(got[k].numpy(), a)
    for k in ("A_log", "conv_w", "x_proj", "dt_proj", "dt_bias", "D"):
        assert k in tree["stages"]["b1_mamba_moe"]


def test_init_params_mamba_kinds(models):
    """The port's parameter defs equal JAX's (shape and init kind), and
    A_log is log(1..d_state) on every channel, as JAX draws it, to the last
    bit of f32 (the port rounds the float64 log; XLA's f32 log may be one
    ulp off)."""
    jcfg, tcfg = models["jcfg"], models["tcfg"]
    jdefs = jtfm.model_param_defs(jcfg)["stages"]
    tdefs = model_param_defs(tcfg)["stages"]
    assert set(jdefs) == set(tdefs)
    for bkey in jdefs:
        assert {k: (v[0], v[2]) for k, v in jdefs[bkey].items()} == \
            tdefs[bkey], bkey
    params = init_params(tcfg, 0)
    p = params["stages"]["b0_mamba_mlp"]
    np.testing.assert_allclose(
        p["A_log"].numpy(),
        np.asarray(models["jparams"]["stages"]["b0_mamba_mlp"]["A_log"]),
        rtol=2 ** -23, atol=0)
    assert p["A_log"].is_contiguous() and torch.all(p["D"] == 1)
    assert not p["dt_bias"].any() and not p["conv_b"].any()


def test_build_engine_refuses_weights_beyond_the_card(monkeypatch):
    """Full-depth jamba (72 layers, 870 GB in bf16) raises before anything
    is allocated, naming the bytes; its three-kind cut passes the check."""
    class Props:
        total_memory = 80 * 10 ** 9

    def refuse(*a, **kw):
        raise AssertionError("allocated before the check")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props)
    monkeypatch.setattr(launch_serve, "init_params", refuse)
    with pytest.raises(ValueError, match="870,127,517,696 bytes"):
        launch_serve.build_engine(ARCH, device="cuda")
    with pytest.raises(AssertionError, match="allocated before"):
        launch_serve.build_engine(ARCH, device="cuda", cut=KINDS)
    assert launch_serve.weight_bytes(cut_to_kinds(get_config(ARCH), KINDS),
                                     torch.bfloat16) == 43_994_103_808


def test_launcher_serves_reduced_jamba_cut_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--cut",
         "mamba_mlp,mamba_moe,attn_moe", "--requests", "3", "--max-new",
         "3"], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr
    assert f"[{ARCH} | cpu float32] 3/3 requests, 9 tokens" in res.stdout


# ---------------------------------------------------------------- serving

@pytest.fixture(scope="module")
def served(models):
    """PROMPT_LENS served on the JAX engine and the port's."""
    rng = np.random.default_rng(42)
    prompts = [[int(t) for t in rng.integers(0, models["jcfg"].vocab_size, n)]
               for n in PROMPT_LENS]
    with jax.set_mesh(models["mesh"]):
        jeng = JaxEngine(models["jcfg"], JServeDims(**DIMS), models["jparams"],
                         models["mesh"], JThrottleConfig(**THROTTLE))
    jticks = _record_ticks(jeng.backend)
    jreqs = [jeng.add_request(p, JSamplingParams(max_new_tokens=MAX_NEW),
                              request_id=f"r{i}")
             for i, p in enumerate(prompts)]
    jeng.drain(max_ticks=500)
    s6.launches = 0
    teng = _port_engine(models)
    tticks = _record_ticks(teng.backend)
    treqs = [teng.add_request(p, SamplingParams(max_new_tokens=MAX_NEW),
                              request_id=f"r{i}")
             for i, p in enumerate(prompts)]
    teng.drain(max_ticks=500)
    return dict(prompts=prompts, jreqs=jreqs, treqs=treqs, jticks=jticks,
                tticks=tticks, teng=teng)


def test_tokens_match_jax_engine_and_port_reference(models, served):
    for p, j, t in zip(served["prompts"], served["jreqs"], served["treqs"]):
        assert j.is_finished and t.is_finished
        assert t.output_token_ids == j.output_token_ids, t.request_id
        assert t.output_token_ids == greedy_generate(
            models["tcfg"], models["tparams"], p, MAX_NEW), t.request_id


def test_tick_composition_matches(served):
    assert served["tticks"] == served["jticks"]
    chunks = {}
    for prefill, _ in served["tticks"]:
        for rid, _n in prefill:
            chunks[rid] = chunks.get(rid, 0) + 1
    assert chunks["r3"] >= 3 and chunks["r1"] >= 2
    assert served["teng"].stats.ticks == len(served["tticks"])
    assert s6.launches == 0                      # the CPU ran the plain scan


def test_engine_gives_each_request_pages_and_a_slot(served):
    """One engine holds both: every request had KV pages (the ATTN_MOE
    layer) and a state slot (the Mamba layers), and both are free again."""
    eng = served["teng"]
    assert eng.slots.owner == {} and len(eng.slots.free) == DIMS["slots"]
    assert eng.kv.num_free_pages == DIMS["pages"]
    caches = eng.backend.caches
    assert set(caches["b0_mamba_mlp"]) == {"conv", "ssm"}
    assert set(caches["b2_attn_moe"]) == {"kv"}
    assert caches["b1_mamba_moe"]["ssm"].dtype == torch.float32
    assert caches["b1_mamba_moe"]["ssm"].abs().sum() > 0


def test_dense_forward_logits_match(models, served):
    toks = np.asarray([served["prompts"][3]], np.int32)       # 41 tokens
    dense = jax.jit(jax_reference.dense_forward, static_argnums=0)
    want = np.asarray(dense(models["jcfg"], models["jparams"],
                            jnp.asarray(toks)))
    got = dense_forward(models["tcfg"], models["tparams"],
                        torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("seed", range(4))
def test_lone_short_request_matches_dense_reference(models, seed):
    """A lone 2-token request with 8 new tokens on a fresh engine: its
    slot is 0, and 7 of the 8 decode rows of every tick are padding rows on
    slot 0 too.  The port writes back the live row only."""
    rng = np.random.default_rng(7 + seed)
    prompt = [int(t) for t in rng.integers(0, models["jcfg"].vocab_size, 2)]
    eng = _port_engine(models)
    req = eng.add_request(prompt, SamplingParams(max_new_tokens=8))
    eng.drain(max_ticks=100)
    assert req.is_finished
    assert req.output_token_ids == greedy_generate(
        models["tcfg"], models["tparams"], prompt, 8)


@pytest.mark.parametrize("seed", range(4))
def test_request_on_a_reused_slot_matches_dense_reference(models, seed):
    """A 2-token request served right after a 12-token one on the same
    engine takes over its slot; the port starts it from zero state."""
    rng = np.random.default_rng(70 + seed)
    vocab = models["jcfg"].vocab_size
    first = [int(t) for t in rng.integers(0, vocab, 12)]
    second = [int(t) for t in rng.integers(0, vocab, 2)]
    eng = _port_engine(models)
    slots = []
    build = eng.backend._build_meta

    def record(batch):
        m = build(batch)
        slots.extend(int(m["p_state_slots"][i])
                     for i in range(len(batch.prefill)))
        return m

    eng.backend._build_meta = record
    eng.add_request(first, SamplingParams(max_new_tokens=4))
    eng.drain(max_ticks=100)
    req = eng.add_request(second, SamplingParams(max_new_tokens=8))
    eng.drain(max_ticks=100)
    assert len(set(slots)) == 1                  # the slot was reused
    assert req.is_finished
    assert req.output_token_ids == greedy_generate(
        models["tcfg"], models["tparams"], second, 8)
