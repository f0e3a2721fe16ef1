"""The port's RWKV6 slice on the CPU against the JAX package: the WKV scan's
plain version, the time-mix, the block, the dense reference and the serving
engine, on the reduced rwkv6-3b (d=64, head size 16) in f32.

Inputs are made with numpy from a seed and handed to both packages; the
JAX weights are carried across with `params_from_numpy`.  Tolerances:
  * f32, the same sequential recurrence in another summation order:
    1e-5 absolute (outputs of order 1), as tests/test_kernels.py's oracles;
  * the Pallas kernel (chunked form, interpret mode): tests/test_kernels.py's
    own bound, 1e-4 (f32) and 3e-2 (bf16) times max(|oracle|, 1);
  * bf16 inputs: the port writes f32 and the JAX oracle rounds its f32
    result to bf16, so the two differ by that rounding: 2**-8 relative;
  * engines and greedy decoding: equal tokens.

Two serving cases pin the port to the dense reference where the JAX engine
misses it (ROADMAP Queue 3): a lone 2-token request on a fresh engine, where
JAX's padding decode rows scatter a stale copy of slot 0's state over the
live update (the JAX engine's tokens differed in seeds 1 and 3 here), and a
request served after another on the same engine and slot, whose state JAX
does not clear (seeds 0, 1 and 2; seed 1 also with the first fault fixed).
"""

import dataclasses
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

from repro.configs import get_config as jax_get_config
from repro.configs import make_reduced as jax_make_reduced
from repro.core import SamplingParams as JSamplingParams
from repro.core import ThrottleConfig as JThrottleConfig
from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import rwkv6_chunked_scan as jax_kernel
from repro.models import reference as jax_reference
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro.models.serve import ServeDims as JServeDims
from repro.runtime.engine import PipelineEngine as JaxEngine
from repro_torch.configs import get_config, make_reduced
from repro_torch.core import SamplingParams, ThrottleConfig
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6_scan as wkv
from repro_torch.models import serve as tserve
from repro_torch.models import ssm
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.reference import dense_forward
from repro_torch.models.serve import ServeDims
from repro_torch.models.transformer import init_params, model_param_defs
from repro_torch.runtime.engine import PipelineEngine

ATOL = 1e-5
DIMS = dict(Sp=1, C=16, Sd=8, pages=256, page=8, Bp=32, Bd=32, slots=16)
THROTTLE = dict(pipeline_depth=1, max_prefill_tokens=16,
                min_prefill_tokens=4, num_iters_T=2)
PROMPT_LENS = (7, 23, 12, 41)        # 23 and 41 exceed C=16
MAX_NEW = 5


def _cfgs():
    """(jax cfg, port cfg): reduced rwkv6-3b, f32, pp=1."""
    jcfg = jax_make_reduced(jax_get_config("rwkv6-3b"))
    jcfg = dataclasses.replace(jcfg.with_plan(pp=1, tp=1, ep_over_data=False),
                               dtype="float32")
    tcfg = make_reduced(get_config("rwkv6-3b"))
    tcfg = dataclasses.replace(tcfg.with_plan(pp=1, tp=1), dtype="float32")
    return jcfg, tcfg


@pytest.fixture(scope="module")
def models():
    """Both configs, the JAX weights (seed 0) and their port copy, and JAX's
    greedy_generate with its dense_forward jitted."""
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
    dense = jax.jit(jax_reference.dense_forward, static_argnums=0)

    def greedy(prompt, n):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_reference, "dense_forward", dense)
            return jax_reference.greedy_generate(jcfg, jparams, prompt, n)

    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                mesh=mesh, greedy=greedy)


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


# ------------------------------------------------------------ the WKV scan

# tests/test_kernels.py::test_rwkv6_scan_vs_oracle's shapes: B, T, H, D, chunk
SHAPES = [(2, 64, 2, 32, 16), (1, 128, 4, 64, 64), (1, 32, 2, 16, 32)]


def _scan_inputs(B, T, H, D, seed):
    """tests/test_kernels.py's inputs (f32 numpy)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=(B, T, H, D)).astype(f) * 0.5,
            rng.normal(size=(B, T, H, D)).astype(f) * 0.5,
            rng.normal(size=(B, T, H, D)).astype(f),
            rng.uniform(0.8, 0.999, size=(B, T, H, D)).astype(f),
            rng.normal(size=(H, D)).astype(f) * 0.3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_scan_matches_jax_oracle_and_pallas(shape, dtype):
    """At zero state and full lengths the plain version computes the Pallas
    kernel's function (every input rounded to `dtype` first, as both JAX
    functions see it)."""
    B, T, H, D, chunk = shape
    arrs = _scan_inputs(B, T, H, D, seed=sum(shape))
    jargs = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    targs = [torch.from_numpy(np.array(a.astype(jnp.float32)))
             for a in jargs]
    r, k, v = (t.to(getattr(torch, dtype)) for t in targs[:3])
    state = torch.zeros(B, H, D, D)
    ones = torch.ones(B, dtype=torch.int32)
    got = wkv.rwkv6_scan_ref(r, k, v, targs[3], targs[4], state,
                             torch.arange(B, dtype=torch.int32), ones * T,
                             ones).numpy()
    want_ref = np.asarray(jref.rwkv6_scan_ref(*jargs), np.float32)
    want_pallas = np.asarray(jax_kernel(*jargs, chunk=chunk, interpret=True),
                             np.float32)
    scale = max(float(np.abs(want_ref).max()), 1.0)
    if dtype == "float32":
        np.testing.assert_allclose(got, want_ref, atol=ATOL * scale, rtol=0)
        np.testing.assert_allclose(got, want_pallas, atol=1e-4 * scale,
                                   rtol=0)
    else:
        np.testing.assert_allclose(got, want_ref, rtol=2 ** -8,
                                   atol=ATOL * scale)
        np.testing.assert_allclose(got, want_pallas, atol=3e-2 * scale,
                                   rtol=0)
    assert torch.isfinite(state).all() and state.abs().max() > 0


def _poisoned_case(S, T, H, lens, fresh, n, dtype, seed, D=16):
    """Decays exp(-exp(U(-6, 3))); live rows on distinct slots, padding rows
    on slot 0; NaN in every slot but the non-fresh live rows'."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    r, k, v = (normal(S, T, H, D).to(dtype) for _ in range(3))
    w = torch.from_numpy(np.exp(-np.exp(
        rng.uniform(-6, 3, (S, T, H, D)))).astype(np.float32))
    u = torch.from_numpy(rng.uniform(0, 1, (H, D)).astype(np.float32))
    state = torch.full((n, H, D, D), float("nan"))
    slots = rng.permutation(n)[:S].astype(np.int32)
    for s in range(S):
        if lens[s] == 0:
            slots[s] = 0
        elif not fresh[s]:
            state[slots[s]] = normal(H, D, D) * 3
    ints = [torch.tensor(a, dtype=torch.int32) for a in (slots, lens, fresh)]
    return [r, k, v, w, u, state, *ints]


def test_plain_scan_keeps_to_its_rows_and_slots():
    """Fresh rows read none of their slot's NaN poison, padding rows (on
    slot 0, which a live row owns) and unowned slots are left bit-identical,
    and the output past each row's length is 0."""
    args = _poisoned_case(5, 20, 3, [20, 9, 0, 1, 0], [1, 0, 0, 0, 0], 8,
                          torch.float32, seed=3)
    state, slots = args[5], args[6]
    state[0] = state[slots[1]]              # a live row owns slot 0
    state[slots[1]] = float("nan")
    slots[1] = 0
    before = state.clone()
    out = wkv.rwkv6_scan_ref(*args)
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


def _simulated_kernel(r, k, v, w, u, state, slots, lens, fresh,
                      planted=False):
    """The recurrence in float64, cast to f32 (the kernel's arithmetic up to
    its f32 roundings); `planted` reads S_t in place of S_{t-1}, the
    off-by-one chip_smoke.py plants in the kernel.  Returns (out, pool)."""
    S, T, H, D = r.shape
    out = torch.zeros(S, T, H, D, dtype=torch.float64)
    pool = state.clone()
    for s in range(S):
        L, sl = int(lens[s]), int(slots[s])
        if L == 0:
            continue
        X = (torch.zeros(H, D, D, dtype=torch.float64) if fresh[s]
             else state[sl].double())
        for t in range(L):
            rr, kk, vv, ww = (a[s, t].double() for a in (r, k, v, w))
            kv = kk[..., :, None] * vv[..., None, :]
            nxt = ww[..., :, None] * X + kv
            read = nxt if planted else X
            out[s, t] = torch.einsum("hk,hkv->hv", rr,
                                     read + u.double()[..., None] * kv)
            X = nxt
        pool[sl] = X.float()
    return out.float(), pool


# chip_smoke.py's rwkv-kernel cases cut for the CPU: decode rows over a pool,
# a prefill chunk with a nonzero state and a live prefix, a ragged batch
CHECK_CASES = {
    "decode": (8, 1, 4, [1] * 6 + [0] * 2, [0] * 8, 16),
    "prefill": (1, 96, 2, [60], [0], 4),
    "ragged": (3, 40, 2, [40, 7, 0], [1, 0, 0], 6),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CHECK_CASES))
def test_tolerance_admits_exact_arithmetic_and_rejects_off_by_one(name,
                                                                  dtype):
    args = _poisoned_case(*CHECK_CASES[name], dtype, seed=len(name), D=64)
    before = args[5]
    inputs, rows = args[:5], args[6:]
    out, pool = _simulated_kernel(*args)
    assert wkv.excess(out, pool, *inputs, before, *rows)[0] <= 1.0
    out, pool = _simulated_kernel(*args, planted=True)
    assert wkv.excess(out, pool, *inputs, before, *rows)[0] > 100.0
    # a kernel that writes a slot no live row owns fails outright
    owned = {int(s) for s, n in zip(rows[0], rows[1]) if n > 0}
    spare = min(set(range(before.shape[0])) - owned)
    out, pool = _simulated_kernel(*args)
    pool[spare] = 0.0
    assert wkv.excess(out, pool, *inputs, before, *rows)[0] == float("inf")


def test_ops_cpu_takes_plain_path_without_launching():
    wkv.launches = 0
    args = _poisoned_case(3, 10, 2, [10, 4, 0], [0, 1, 0], 4, torch.float32,
                          seed=5)
    state = args[5].clone()
    out = ops.rwkv6_scan(*args[:5], state, *args[6:])
    want = wkv.rwkv6_scan_ref(*args)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert torch.equal(state.view(torch.int32), args[5].view(torch.int32))
    assert wkv.launches == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    args = _poisoned_case(2, 4, 1, [4, 4], [1, 1], 2, torch.float32, seed=6,
                          D=64)
    with pytest.raises(ValueError, match="CUDA"):
        wkv.rwkv6_chunked_scan(*args)
    assert wkv.launches == 0


def test_kernel_modules_import_without_nvcc():
    """The WKV kernel builds at first use: its modules import in a process
    with no nvcc on PATH and no CUDA_HOME, and build nothing."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    code = ("import repro_torch.kernels.rwkv6_scan, repro_torch.models.ssm\n"
            "from repro_torch.kernels import build\n"
            "assert build._libs == {} and build.build_log == {}\n"
            "try:\n    build.nvcc()\nexcept RuntimeError:\n    print('ok')\n")
    env = {"PATH": "", "PYTHONPATH": src, "CUDA_HOME": "/nonexistent"}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


# ------------------------------------------------- time-mix, block, params

def _block_params(d, ff, seed):
    """numpy RWKV block weights with a data-dependent decay that spans
    strong and weak (w0 in [-3, 1], w_lora_b nonzero)."""
    rng = np.random.default_rng(seed)
    p = {name: rng.uniform(0, 1, d) for name in (
        "mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "u", "cm_mu_k", "cm_mu_r")}
    for name, shape in (("w_r", (d, d)), ("w_k", (d, d)), ("w_v", (d, d)),
                        ("w_g", (d, d)), ("w_o", (d, d)), ("cm_r", (d, d)),
                        ("cm_k", (d, ff)), ("cm_v", (ff, d)),
                        ("w_lora_a", (d, 64))):
        p[name] = rng.normal(size=shape) * 0.15
    p["w_lora_b"] = rng.normal(size=(64, d)) * 0.5
    p["w0"] = rng.uniform(-3, 1, d)
    for name in ("ln_x_g", "ln1_g", "ln2_g"):
        p[name] = 1 + 0.1 * rng.normal(size=d)
    for name in ("ln1_b", "ln2_b"):
        p[name] = 0.1 * rng.normal(size=d)
    return {k: v.astype(np.float32) for k, v in p.items()}


B, T, D_MODEL, HD = 4, 12, 64, 16
CHUNK_LENS = np.array([12, 5, 0, 1], np.int32)


def _stateful_inputs(seed):
    rng = np.random.default_rng(seed)
    H = D_MODEL // HD
    x = rng.normal(size=(B, T, D_MODEL)).astype(np.float32)
    tm = rng.normal(size=(B, D_MODEL)).astype(np.float32)
    cm = rng.normal(size=(B, D_MODEL)).astype(np.float32)
    wkv0 = (rng.normal(size=(B, H, HD, HD)) * 0.5).astype(np.float32)
    return x, tm, cm, wkv0


def _both_states(tm, cm, wkv0):
    jstate = jssm.RWKVState(tm_x=jnp.asarray(tm), cm_x=jnp.asarray(cm),
                            wkv=jnp.asarray(wkv0))
    tstate = ssm.RWKVState(tm_x=torch.from_numpy(tm),
                           cm_x=torch.from_numpy(cm),
                           wkv=torch.from_numpy(wkv0.copy()),
                           slots=torch.arange(B, dtype=torch.int32),
                           fresh=torch.zeros(B, dtype=torch.int32))
    return jstate, tstate


def test_time_mix_matches_jax_with_state_and_ragged_lengths():
    """Nonzero carried state, ragged lengths (one row with none) and a
    data-dependent decay spanning ~0 to ~1: equal outputs on the live
    positions, equal shift and WKV states."""
    p = _block_params(D_MODEL, 128, seed=1)
    x, tm, cm, wkv0 = _stateful_inputs(seed=2)
    valid = np.arange(T)[None, :] < CHUNK_LENS[:, None]
    jstate, tstate = _both_states(tm, cm, wkv0)
    jout, jtm, jwkv = jssm.rwkv_time_mix(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
        head_dim=HD, state=jstate, valid=jnp.asarray(valid),
        chunk_lens=jnp.asarray(CHUNK_LENS))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tout, ttm, tpool = ssm.rwkv_time_mix(
        torch.from_numpy(x), tp, head_dim=HD, state=tstate,
        chunk_lens=torch.from_numpy(CHUNK_LENS))
    np.testing.assert_allclose(tout.numpy()[valid], np.asarray(jout)[valid],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(ttm.numpy(), np.asarray(jtm), atol=0, rtol=0)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jwkv), atol=ATOL,
                               rtol=0)
    np.testing.assert_array_equal(tpool.numpy()[2], wkv0[2])   # len 0
    # the decay really is data-dependent and spans strong and weak
    xw = torch.from_numpy(x) + tp["mu_w"]
    dd = torch.tanh(xw @ tp["w_lora_a"]) @ tp["w_lora_b"]
    w = torch.exp(-torch.exp(torch.clamp(tp["w0"] + dd, -20, 10)))
    assert float(w.min()) < 1e-3 and float(w.max()) > 0.9


def test_block_matches_jax_with_state():
    p = _block_params(D_MODEL, 128, seed=3)
    x, tm, cm, wkv0 = _stateful_inputs(seed=4)
    valid = np.arange(T)[None, :] < CHUNK_LENS[:, None]
    jstate, tstate = _both_states(tm, cm, wkv0)
    jx, jnew = jssm.rwkv_block(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
        head_dim=HD, norm_eps=1e-5, state=jstate, valid=jnp.asarray(valid),
        chunk_lens=jnp.asarray(CHUNK_LENS))
    tx, tnew = ssm.rwkv_block(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
        head_dim=HD, norm_eps=1e-5, state=tstate,
        valid=torch.from_numpy(valid),
        chunk_lens=torch.from_numpy(CHUNK_LENS))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tx.numpy()[~valid], x[~valid])
    for name in ("tm_x", "cm_x", "wkv"):
        np.testing.assert_allclose(getattr(tnew, name).numpy(),
                                   np.asarray(getattr(jnew, name)),
                                   atol=ATOL, rtol=0, err_msg=name)


def test_reduced_rwkv_config_matches_jax():
    jcfg, tcfg = _cfgs()
    for f in ("d_model", "d_ff", "num_layers", "rwkv_head_dim",
              "num_rwkv_heads", "norm", "norm_eps", "vocab_size"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    full = get_config("rwkv6-3b")
    assert (full.num_layers, full.d_model, full.num_rwkv_heads) == (32, 2560,
                                                                    40)


def test_params_from_numpy_carries_rwkv_tree(models):
    """Every RWKV leaf carries across key for key, unchanged."""
    tree = jax.tree.map(np.asarray, models["jparams"])
    block = tree["stages"]["b0_rwkv"]
    got = models["tparams"]["stages"]["b0_rwkv"]
    assert set(got.keys()) == set(block) and len(block) == 24
    for k, a in block.items():
        np.testing.assert_array_equal(got[k].numpy(), a)


def test_init_params_rwkv_kinds():
    """The port draws RWKV's init kinds as JAX does: mixing coefficients
    and the bonus uniform in [0, 1), decay base -1, LoRA up-projection 0."""
    _, tcfg = _cfgs()
    params = init_params(tcfg, 0)
    jdefs = jtfm.model_param_defs(_cfgs()[0])["stages"]["b0_rwkv"]
    tdefs = model_param_defs(tcfg)["stages"]["b0_rwkv"]
    assert {k: (v[0], v[2]) for k, v in jdefs.items()} == tdefs
    p = params["stages"]["b0_rwkv"]
    for name in ("mu_r", "mu_w", "u", "cm_mu_k"):
        assert 0 <= float(p[name].min()) and float(p[name].max()) < 1
        assert float(p[name].std()) > 0.2
    assert torch.all(p["w0"] == -1) and not p["w_lora_b"].any()


def test_meta_to_device_rwkv_fields():
    """The slots each row's state is written back to and the fresh flags
    are computed on the host: a live row writes its own slot, a padding row
    (on slot 0) the scratch slot past the pool; a prefill chunk at position
    0 is fresh, a later chunk is not."""
    dims = ServeDims(**{**DIMS, "Sp": 2})
    meta = tserve.zero_meta(dims)
    meta["p_chunk_lens"][:] = [5, 0]
    meta["p_positions"][0, :5] = np.arange(5)
    meta["p_state_slots"][:] = [3, 0]
    meta["d_valid"][[1, 4]] = 1
    meta["d_state_slots"][[1, 4]] = [7, 2]
    meta["d_positions"][[1, 4]] = [9, 30]
    out = tserve.host_meta(meta, dims)
    scratch = dims.slots
    assert out["p_write_slots"].tolist() == [3, scratch]
    assert out["p_fresh"].tolist() == [1, 0]
    want = [scratch] * dims.Sd
    want[1], want[4] = 7, 2
    assert out["d_write_slots"].tolist() == want
    assert not out["d_fresh"].any()
    meta["p_positions"][0, :5] = 16 + np.arange(5)     # a second chunk
    assert tserve.host_meta(meta, dims)["p_fresh"].tolist() == [
        0, 0]


# ---------------------------------------------------------------- serving

@pytest.fixture(scope="module")
def served(models):
    """PROMPT_LENS served on the JAX engine and the port's (a case where the
    JAX engine is right), plus JAX's greedy_generate."""
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
    teng = _port_engine(models)
    tticks = _record_ticks(teng.backend)
    treqs = [teng.add_request(p, SamplingParams(max_new_tokens=MAX_NEW),
                              request_id=f"r{i}")
             for i, p in enumerate(prompts)]
    teng.drain(max_ticks=500)
    greedy = [models["greedy"](p, MAX_NEW) for p in prompts]
    return dict(prompts=prompts, jreqs=jreqs, treqs=treqs, jticks=jticks,
                tticks=tticks, teng=teng, greedy=greedy)


def test_tokens_match_jax_engine_and_greedy_reference(served):
    for j, t, want in zip(served["jreqs"], served["treqs"],
                          served["greedy"]):
        assert j.is_finished and t.is_finished
        assert t.output_token_ids == j.output_token_ids == want, t.request_id


def test_tick_composition_matches(served):
    assert served["tticks"] == served["jticks"]
    chunks = {}
    for prefill, _ in served["tticks"]:
        for rid, _n in prefill:
            chunks[rid] = chunks.get(rid, 0) + 1
    assert chunks["r3"] >= 3 and chunks["r1"] >= 2
    assert served["teng"].stats.ticks == len(served["tticks"])
    assert wkv.launches == 0                     # the CPU ran the plain scan


def test_dense_forward_logits_match(models, served):
    toks = np.asarray([served["prompts"][3]], np.int32)       # 41 tokens
    want = np.asarray(jax_reference.dense_forward(
        models["jcfg"], models["jparams"], jnp.asarray(toks)))
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
    assert req.output_token_ids == models["greedy"](prompt, 8)


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
    assert req.output_token_ids == models["greedy"](second, 8)
