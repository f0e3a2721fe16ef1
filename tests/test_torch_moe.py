"""MoE of the port (NS=1): routing, capacity dispatch and the grouped-expert
FFN's plain version against the JAX package, the CPU/CUDA dispatch, and the
power of the kernel check (`moe_gemm.TOLERANCE`).

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: 1e-5 absolute for f32 (the same math in another summation
order), as tests/test_moe.py and tests/test_kernels.py use.  The
kernel-vs-plain checks on the card are in tests/test_torch_moe_gpu.py,
which imports no JAX.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import make_reduced as jax_make_reduced
from repro.kernels import ref as jref
from repro.kernels.moe_gemm import fused_moe_ffn as jax_kernel
from repro.models import moe as jmoe
from repro_torch.configs import get_config, make_reduced
from repro_torch.kernels import moe_gemm, ops
from repro_torch.models import moe

ATOL = 1e-5


def _moe_params(cfg, seed):
    """numpy router/expert (and shared-expert) weights for `cfg`."""
    rng = np.random.default_rng(seed)
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {"router": rng.normal(size=(d, E)) * 0.5,
         "w_gate": rng.normal(size=(E, d, ff)) * 0.1,
         "w_up": rng.normal(size=(E, d, ff)) * 0.1,
         "w_down": rng.normal(size=(E, ff, d)) * 0.1}
    if cfg.num_shared_experts:
        ffs = ff * cfg.num_shared_experts
        p.update(s_gate=rng.normal(size=(d, ffs)) * 0.1,
                 s_up=rng.normal(size=(d, ffs)) * 0.1,
                 s_down=rng.normal(size=(ffs, d)) * 0.1)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _both(arrays):
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def _reduced(arch):
    """The reduced config from JAX's registry (the port's holds the same
    configs: tests/test_torch_archs.py)."""
    return jax_make_reduced(jax_get_config(arch))


def test_reduced_olmoe_config_matches_jax():
    jcfg = _reduced("olmoe-1b-7b")
    tcfg = make_reduced(get_config("olmoe-1b-7b"))
    for f in ("d_model", "num_experts", "num_experts_per_tok", "moe_d_ff",
              "num_shared_experts", "moe_capacity_factor", "num_layers"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert get_config("olmoe-1b-7b").moe_capacity_factor == 1.25


def test_route_matches_jax():
    cfg = _reduced("olmoe-1b-7b")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, cfg.d_model)).astype(np.float32)
    router = _moe_params(cfg, 1)["router"]
    jw, jidx, jaux = jmoe.route(jnp.asarray(x), jnp.asarray(router),
                                cfg.num_experts_per_tok)
    tw, tidx, taux = moe.route(torch.from_numpy(x), torch.from_numpy(router),
                               cfg.num_experts_per_tok)
    assert tidx.dtype == torch.int32
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), atol=ATOL)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "kimi-k2-1t-a32b"])
def test_moe_apply_matches_jax_with_row_valid(arch):
    """At the config's capacity factor, with padding rows masked out: equal
    outputs (padding rows get zeros, or the shared expert alone)."""
    cfg = _reduced(arch)
    rng = np.random.default_rng(2)
    T = 40
    x = rng.normal(size=(T, cfg.d_model)).astype(np.float32)
    valid = rng.random(T) < 0.7
    jp, tp = _both(_moe_params(cfg, 3))
    kw = dict(top_k=cfg.num_experts_per_tok,
              capacity_factor=cfg.moe_capacity_factor)
    jout, _ = jmoe.moe_apply(jnp.asarray(x), jp, row_valid=jnp.asarray(valid),
                             **kw)
    tout, _ = moe.moe_apply(torch.from_numpy(x), tp,
                            row_valid=torch.from_numpy(valid), **kw)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL)
    if not cfg.num_shared_experts:
        assert not np.any(tout.numpy()[~valid])


def test_moe_apply_matches_dense_oracle_when_dropless():
    cfg = _reduced("kimi-k2-1t-a32b")
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(32, cfg.d_model)).astype(np.float32))
    _, tp = _both(_moe_params(cfg, 5))
    k = cfg.num_experts_per_tok
    out, _ = moe.moe_apply(x, tp, top_k=k,
                           capacity_factor=float(cfg.num_experts))
    torch.testing.assert_close(out, moe.moe_ref(x, tp, top_k=k), rtol=1e-4,
                               atol=ATOL)


@pytest.mark.parametrize("top_k,cf,same_rows", [(2, 0.5, False),
                                                (1, 0.05, True)])
def test_same_rows_drop_as_in_jax(top_k, cf, same_rows):
    """Under a tight capacity both packages keep and drop the same
    (row, expert) assignments: equal group buffers and slot positions,
    equal outputs, and equal all-zero (fully dropped) rows."""
    cfg = _reduced("olmoe-1b-7b")
    rng = np.random.default_rng(6)
    T, E = 64, cfg.num_experts
    x = rng.normal(size=(T, cfg.d_model)).astype(np.float32)
    if same_rows:                    # identical rows: one expert takes all
        x[:] = x[0]
    valid = np.ones(T, bool)
    valid[-5:] = False
    jp, tp = _both(_moe_params(cfg, 7))

    cap = moe.capacity(T, top_k, E, cf)
    assert cap == jmoe._round8(int(T * top_k / E * cf) + 1)
    _, idx, _ = moe.route(torch.from_numpy(x), tp["router"], top_k)
    flat_e = idx.reshape(-1).long()
    src = np.repeat(np.arange(T), top_k)
    flat_e = torch.where(torch.from_numpy(valid[src]), flat_e, E)
    xs = x[src]
    jbuf, jorder, jsg, jpos = jmoe._group_rows(
        jnp.asarray(xs), jnp.asarray(flat_e.numpy().astype(np.int32)), E, cap)
    tbuf, torder, tsg, tpos, tcounts = moe._group_rows(
        torch.from_numpy(xs), flat_e, E, cap)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(torder.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    dropped = tpos.numpy() >= cap
    assert dropped[np.asarray(tsg) < E].any()      # the capacity really bit
    routed = np.bincount(np.asarray(tsg)[np.asarray(tsg) < E], minlength=E)
    np.testing.assert_array_equal(tcounts.numpy(), np.minimum(routed, cap))

    kw = dict(top_k=top_k, capacity_factor=cf)
    jout, _ = jmoe.moe_apply(jnp.asarray(x), jp, row_valid=jnp.asarray(valid),
                             **kw)
    tout, _ = moe.moe_apply(torch.from_numpy(x), tp,
                            row_valid=torch.from_numpy(valid), **kw)
    jout = np.asarray(jout)
    np.testing.assert_allclose(tout.numpy(), jout, atol=ATOL)
    np.testing.assert_array_equal(np.all(tout.numpy() == 0, axis=-1),
                                  np.all(jout == 0, axis=-1))
    if same_rows:
        assert np.all(jout == 0, axis=-1).sum() > T // 2


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_moe_apply_counts_are_routed_rows_capped(cf, monkeypatch):
    """The expert FFN gets counts[e] = min(rows routed to e, capacity), int32
    on x's device, and each buffer holds exactly that many rows."""
    cfg = _reduced("olmoe-1b-7b")
    rng = np.random.default_rng(9)
    T, E, k = 64, cfg.num_experts, cfg.num_experts_per_tok
    x = torch.from_numpy(rng.normal(size=(T, cfg.d_model)).astype(np.float32))
    valid = torch.from_numpy(rng.random(T) < 0.8)
    _, tp = _both(_moe_params(cfg, 10))
    seen = []
    real = moe.expert_ffn

    def spy(xb, w_gate, w_up, w_down, counts=None):
        seen.append((xb, counts))
        return real(xb, w_gate, w_up, w_down, counts)

    monkeypatch.setattr(moe, "expert_ffn", spy)
    moe.moe_apply(x, tp, top_k=k, capacity_factor=cf, row_valid=valid)
    (xb, counts), = seen
    _, idx, _ = moe.route(x, tp["router"], k)
    routed = np.bincount(idx[valid].reshape(-1).numpy(), minlength=E)
    cap = moe.capacity(T, k, E, cf)
    assert counts.dtype == torch.int32 and counts.device == x.device
    np.testing.assert_array_equal(counts.numpy(), np.minimum(routed, cap))
    if cf < 1:
        assert (routed > cap).any()                # the capacity really bit
    held = xb.abs().sum(dim=-1) > 0                # [E, cap] rows in use
    np.testing.assert_array_equal(held.sum(dim=1).numpy(), counts.numpy())
    rows = torch.arange(cap)[None, :]
    assert not held[rows >= counts[:, None].long()].any()


def test_moe_apply_refuses_expert_parallelism():
    """Expert parallelism over a data group of one rank (`ep=`) is the
    NS=1 path: the same output and aux bit for bit (the EP exchanges are
    tested across ranks in tests/test_torch_ep.py)."""
    from repro_torch.launch.mesh import AxisGroup

    cfg = _reduced("kimi-k2-1t-a32b")
    _, tp = _both(_moe_params(cfg, 8))
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(12, cfg.d_model))).float()
    want, aux = moe.moe_apply(x, tp, top_k=2)
    got, aux1 = moe.moe_apply(x, tp, top_k=2,
                              ep=AxisGroup("data", (0,), 0))
    assert torch.equal(got, want) and torch.equal(aux1, aux)


# tests/test_kernels.py::test_fused_moe_vs_oracle's shapes and Pallas tiles,
# plus one with C = 24 (a ragged row edge for the Hopper kernel)
SHAPES = [(4, 16, 32, 64, 8, 32), (2, 32, 64, 128, 16, 64),
          (3, 8, 16, 32, 8, 16), (2, 24, 64, 128, 8, 64)]


def _ffn_case(E, C, d, ff, seed, w_scale=0.1, x_scale=0.5):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) * sc for s, sc in (
        ((E, C, d), x_scale), ((E, d, ff), w_scale), ((E, d, ff), w_scale),
        ((E, ff, d), w_scale))]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_jax_oracle_and_pallas(shape):
    E, C, d, ff, tb, fb = shape
    arrs = _ffn_case(E, C, d, ff, seed=sum(shape))
    got = moe_gemm.fused_moe_ffn_ref(*map(torch.from_numpy, arrs)).numpy()
    jargs = [jnp.asarray(a) for a in arrs]
    want_ref = np.asarray(jref.fused_moe_ffn_ref(*jargs))
    want_pallas = np.asarray(jax_kernel(*jargs, token_block=tb, ff_block=fb,
                                        interpret=True))
    np.testing.assert_allclose(got, want_ref, atol=ATOL)
    np.testing.assert_allclose(got, want_pallas, atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_plain_counts_zero_rows_past_counts(dtype):
    """The counts contract on the plain version: rows past counts[e] hold
    NaN and come out as exact zeros; the rows below are bit-equal to the
    computation without counts.  The dispatch passes counts through."""
    arrs = _ffn_case(4, 24, 64, 128, seed=5)
    counts = np.array([0, 7, 24, 13])
    live = np.arange(24)[None, :] < counts[:, None]
    arrs[0][~live] = np.nan
    args = [torch.from_numpy(a).to(dtype) for a in arrs]
    c = torch.from_numpy(counts.astype(np.int32))
    out = moe_gemm.fused_moe_ffn_ref(*args, c)
    full = moe_gemm.fused_moe_ffn_ref(*args)
    live = torch.from_numpy(live)
    assert torch.all(out[~live] == 0) and torch.isnan(full[~live]).all()
    assert torch.equal(out[live], full[live])
    assert torch.equal(ops.fused_moe_ffn(*args, c), out)
    assert moe_gemm.excess(out, *args, c)[0] == 0.0
    broken = out.clone()
    broken[0, 0, 0] = 1.0                  # a row past counts that is not 0
    assert not moe_gemm.excess(broken, *args, c)[0] <= 1.0


def test_ops_cpu_takes_plain_path_without_launching():
    moe_gemm.launches = 0
    args = [torch.from_numpy(a) for a in _ffn_case(2, 24, 64, 128, seed=1)]
    out = ops.fused_moe_ffn(*args)
    torch.testing.assert_close(out, moe_gemm.fused_moe_ffn_ref(*args),
                               rtol=0, atol=0)
    assert moe_gemm.launches == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    args = [torch.from_numpy(a) for a in _ffn_case(2, 24, 128, 128, seed=1)]
    with pytest.raises(ValueError, match="CUDA"):
        moe_gemm.fused_moe_ffn(*args)
    assert moe_gemm.launches == 0


def test_kernel_module_imports_without_nvcc():
    """The MoE kernel builds at first use: its modules import in a process
    with no nvcc on PATH and no CUDA_HOME, and build nothing."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    code = ("import repro_torch.kernels.moe_gemm, repro_torch.models.moe\n"
            "from repro_torch.kernels import build\n"
            "assert build._libs == {} and build.build_log == {}\n"
            "try:\n    build.nvcc()\nexcept RuntimeError:\n    print('ok')\n")
    env = {"PATH": "", "PYTHONPATH": src, "CUDA_HOME": "/nonexistent"}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


# The kernel's ff tile: the depth of one step of its down-projection loop
# (`Depth<T>::kStep` in csrc/moe_ffn.cu: kF32BK for f32, one 128-byte
# swizzled row, kBK, for bf16).  The planted fault stops that loop one tile
# early.
FF_TILE = {torch.float32: 32, torch.bfloat16: 64}

# chip_smoke.py's moe-kernel shapes with E cut for the CPU (jamba's, the last,
# also C and d: its ff = 24576 is what the hidden's rounding term grows
# with), and the serve path's weight scale (0.02) over unit-variance rows
CHECK_SHAPES = [(2, 88, 2048, 1024), (4, 24, 256, 256), (2, 16, 128, 128),
                (1, 16, 512, 24576)]


def _tf32(a):
    """`a` rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as cvt.rna.tf32.f32 does."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _product(eq, a, b, tf32=None):
    """einsum `eq` of f32 operands: exact products (None), split TF32
    (hi.hi + hi.lo + lo.hi, the f32 kernel's), or one TF32 product
    ("single", the fault split TF32 guards against)."""
    if tf32 is None:
        return torch.einsum(eq, a, b)
    a_hi, b_hi = _tf32(a), _tf32(b)
    if tf32 == "single":
        return torch.einsum(eq, a_hi, b_hi)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
            + torch.einsum(eq, a_hi, b_hi))


def _simulated_kernel(x, w_gate, w_up, w_down, dropped=0, tf32=None):
    """The kernel's arithmetic in plain PyTorch: f32 sums (of TF32 products
    with `tf32`), the hidden rounded to x's dtype, and optionally the last
    `dropped` ff rows of the down projection left out (the planted fault)."""
    xf = x.float()
    g = _product("ecd,edf->ecf", xf, w_gate.float(), tf32)
    u = _product("ecd,edf->ecf", xf, w_up.float(), tf32)
    h = (torch.nn.functional.silu(g) * u).to(x.dtype).float()
    keep = h.shape[-1] - dropped
    out = _product("ecf,efd->ecd", h[..., :keep], w_down.float()[:, :keep],
                   tf32)
    return out.to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", CHECK_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_tolerance_admits_kernel_arithmetic_and_rejects_dropped_ff_tile(
        shape, dtype):
    arrs = _ffn_case(*shape, seed=sum(shape), w_scale=0.02, x_scale=1.0)
    args = [torch.from_numpy(a).to(dtype) for a in arrs]
    tf32 = "split" if dtype == torch.float32 else None
    faithful = _simulated_kernel(*args, tf32=tf32)
    planted = _simulated_kernel(*args, dropped=FF_TILE[dtype], tf32=tf32)
    assert moe_gemm.excess(faithful, *args)[0] <= 1.0
    assert moe_gemm.excess(planted, *args)[0] > 1.0


# Where one TF32 product per f32 product must fail the f32 check: the small
# shapes (at olmoe's and jamba's depths its error is inside the bound, so
# only these rows tell split TF32 from single TF32; chip_smoke.py's planted
# single-TF32 copy is required to fail at its "small" row)
SINGLE_TF32_CAUGHT = {(4, 24, 256, 256), (2, 16, 128, 128)}


@pytest.mark.parametrize("shape", CHECK_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_tolerance_admits_split_tf32_and_rejects_single_tf32(shape):
    arrs = _ffn_case(*shape, seed=sum(shape), w_scale=0.02, x_scale=1.0)
    args = [torch.from_numpy(a) for a in arrs]
    split = _simulated_kernel(*args, tf32="split")
    assert moe_gemm.excess(split, *args)[0] <= 1.0
    single = moe_gemm.excess(_simulated_kernel(*args, tf32="single"),
                             *args)[0]
    if shape in SINGLE_TF32_CAUGHT:
        assert single > 1.0


@pytest.mark.parametrize("shape", CHECK_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_tolerance_admits_one_bf16_ulp(shape):
    """Kernel and plain version each round an f32 result to bf16, so they
    may land one ulp apart; the bf16 tolerance admits that everywhere."""
    arrs = _ffn_case(*shape, seed=sum(shape), w_scale=0.02, x_scale=1.0)
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    want = moe_gemm.fused_moe_ffn_ref(*args)
    nudged = (want.view(torch.int16) + 1).view(torch.bfloat16)
    excess, err = moe_gemm.excess(nudged, *args)
    assert 0.0 < excess <= 1.0 and err > 0.0


def test_excess_zero_rows_count_as_agreement():
    """Empty capacity rows (x = 0) give exact zeros in both versions; their
    bound is 0 and they must not turn the excess into NaN."""
    arrs = _ffn_case(2, 16, 128, 128, seed=3)
    arrs[0][:, 8:] = 0.0
    args = [torch.from_numpy(a) for a in arrs]
    assert moe_gemm.excess(moe_gemm.fused_moe_ffn_ref(*args), *args) == (
        0.0, 0.0)
