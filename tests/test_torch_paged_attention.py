"""Paged attention of the port: the plain PyTorch version against the JAX
oracle and the Pallas kernel (interpret mode), the KV page write, and the
CPU/CUDA dispatch.

Tolerances: 2e-5 for f32 and 2e-2 for bf16 (one bf16 rounding of outputs of
magnitude ~1), as in tests/test_kernels.py.  Rows with ctx == 0 differ by
design (the kernels write zeros, the oracles the mean of V), so only
ctx > 0 rows are compared.  The kernel-vs-plain checks on the card are in
tests/test_torch_kernel_gpu.py, which imports no JAX.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_flash_attention as jax_kernel
from repro.models.attention import write_kv_pages as jax_write_kv_pages
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.models.attention import valid_rows, write_kv_pages

SHAPES = [
    (2, 1, 4, 2, 64, 8, 4),        # decode, GQA          (test_kernels.py)
    (1, 16, 4, 4, 128, 8, 4),      # prefill chunk, MHA
    (3, 8, 8, 2, 64, 16, 8),       # prefill, deep tables
    (2, 1, 8, 8, 128, 8, 8),       # decode, MHA, D=128
    (2, 4, 40, 8, 128, 16, 4),     # qwen2.5-14b heads, 40:8 (G=5)
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _case(S, TQ, H, KH, D, page, B, seed, zero_ctx_row=False):
    rng = np.random.default_rng(seed)
    P = S * B + 2
    q = rng.normal(size=(S, TQ, H, D)).astype(np.float32)
    kv = rng.normal(size=(P, page, 2, KH, D)).astype(np.float32)
    tables = rng.permutation(P)[: S * B].reshape(S, B).astype(np.int32)
    ctx = rng.integers(TQ, B * page + 1, S).astype(np.int32)
    if zero_ctx_row:
        ctx[-1] = 0
    qpos = (np.maximum(ctx, TQ)[:, None] - TQ
            + np.arange(TQ)[None, :]).astype(np.int32)
    return q, kv, tables, ctx, qpos


def _torch_args(arrs, tdtype, device="cpu"):
    q, kv, tables, ctx, qpos = arrs
    return (torch.from_numpy(q).to(device, tdtype),
            torch.from_numpy(kv).to(device, tdtype),
            torch.from_numpy(tables).to(device),
            torch.from_numpy(ctx).to(device),
            torch.from_numpy(qpos).to(device))


def _jax_args(arrs, jdtype):
    q, kv, tables, ctx, qpos = arrs
    return (jnp.asarray(q, jdtype), jnp.asarray(kv, jdtype),
            jnp.asarray(tables), jnp.asarray(ctx), jnp.asarray(qpos))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_jax_oracle_and_pallas(shape, dtype):
    jdtype, tdtype, tol = DTYPES[dtype]
    arrs = _case(*shape, seed=sum(shape))
    out_t = pa.paged_flash_attention_ref(*_torch_args(arrs, tdtype))
    out_t = out_t.float().numpy()
    jargs = _jax_args(arrs, jdtype)
    out_ref = np.asarray(jref.paged_flash_attention_ref(*jargs), np.float32)
    TQ = shape[1]
    out_pallas = np.asarray(
        jax_kernel(*jargs, interpret=True, q_block=min(8, TQ)), np.float32)
    np.testing.assert_allclose(out_t, out_ref, atol=tol)
    np.testing.assert_allclose(out_t, out_pallas, atol=tol)


def test_plain_ctx_zero_rows_mean_of_v_like_jax_oracle():
    """ctx == 0 rows: plain version and JAX oracle agree (mean of V); the
    Pallas kernel writes zeros there.  Live rows agree with all three."""
    arrs = _case(3, 1, 4, 2, 64, 8, 4, seed=7, zero_ctx_row=True)
    out_t = pa.paged_flash_attention_ref(
        *_torch_args(arrs, torch.float32)).numpy()
    jargs = _jax_args(arrs, jnp.float32)
    out_ref = np.asarray(jref.paged_flash_attention_ref(*jargs))
    out_pallas = np.asarray(jax_kernel(*jargs, interpret=True))
    np.testing.assert_allclose(out_t, out_ref, atol=2e-5)
    np.testing.assert_allclose(out_t[:-1], out_pallas[:-1], atol=2e-5)
    assert not np.any(out_pallas[-1])


def test_write_kv_pages_drops_invalid_rows():
    """Padding rows (invalid, or page -1) write nothing.  The valid rows land
    exactly where the JAX write puts them.  JAX's scatter normalises a -1
    page to the last page before its mode="drop" bounds check, so there the
    padding rows overwrite slot 0 of the last page (ROADMAP Queue 3); the
    port leaves that page as it was, and the pages are compared below it."""
    rng = np.random.default_rng(5)
    P, page, KH, D, S, C = 6, 4, 2, 8, 2, 5
    cache = rng.normal(size=(P, page, 2, KH, D)).astype(np.float32)
    new_kv = rng.normal(size=(S, C, 2, KH, D)).astype(np.float32)
    slot = rng.permutation((P - 1) * page)[: S * C].reshape(S, C)
    pages = (slot // page).astype(np.int32)
    offs = (slot % page).astype(np.int32)
    chunk = np.array([3, 0])
    valid = np.arange(C)[None, :] < chunk[:, None]
    pages[~valid] = -1
    pages[0, 1] = -1                                   # valid but off-pool
    want = np.asarray(jax_write_kv_pages(
        jnp.asarray(cache), jnp.asarray(new_kv), jnp.asarray(pages),
        jnp.asarray(offs), jnp.asarray(valid)))
    got = torch.from_numpy(cache.copy())
    rows = torch.from_numpy(valid_rows(valid, pages, P))
    out = write_kv_pages(got, torch.from_numpy(new_kv),
                         torch.from_numpy(pages), torch.from_numpy(offs), rows)
    assert out is got                                  # in place
    np.testing.assert_array_equal(got.numpy()[:-1], want[:-1])
    np.testing.assert_array_equal(got.numpy()[-1], cache[-1])
    assert rows.tolist() == [0, 2]


def test_ops_cpu_takes_plain_path_without_launching():
    pa.launches = 0
    arrs = _case(2, 1, 4, 2, 64, 8, 4, seed=3)
    args = _torch_args(arrs, torch.float32)
    out = ops.paged_attention(*args)
    torch.testing.assert_close(out, pa.paged_flash_attention_ref(*args),
                               rtol=0, atol=0)
    assert pa.launches == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    args = _torch_args(_case(2, 1, 4, 2, 64, 8, 4, seed=3), torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_flash_attention(*args)
    assert pa.launches == 0


def test_kernel_module_imports_without_nvcc():
    """The build happens at first use: the kernel modules import in a
    process with no nvcc on PATH and no CUDA_HOME, and build nothing."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    code = ("import repro_torch.kernels.ops, repro_torch.models.serve\n"
            "from repro_torch.kernels import build\n"
            "assert build._libs == {} and build.build_log == {}\n"
            "try:\n    build.nvcc()\nexcept RuntimeError:\n    print('ok')\n")
    env = {"PATH": "", "PYTHONPATH": src, "CUDA_HOME": "/nonexistent"}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


# chip_smoke.py's kernel shapes, decode cut to 8 sequences for the CPU
CHIP_SHAPES = [
    (8, 1, 16, 16, 64, 16, 128),   # qwen1.5-0.5b decode
    (1, 512, 16, 16, 64, 16, 128),  # qwen1.5-0.5b prefill chunk
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES + CHIP_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_tolerance_rejects_off_by_one_causal_mask(shape, dtype):
    """The kernel-vs-plain check (`pa.excess` within `pa.TOLERANCE`) has the
    power to catch a mask of kpos < qpos: the plain version at q positions
    one lower is exactly that fault, and it must exceed the tolerance."""
    args = _torch_args(_case(*shape, seed=sum(shape)), dtype)
    q, kv, tables, ctx, qpos = args
    want = pa.paged_flash_attention_ref(*args)
    faulty = pa.paged_flash_attention_ref(q, kv, tables, ctx, qpos - 1)
    assert pa.excess(want, *args) == (0.0, 0.0)
    assert pa.excess(faulty, *args)[0] > 1.0


@pytest.mark.parametrize("shape", SHAPES + CHIP_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_tolerance_admits_one_bf16_ulp(shape):
    """Kernel and plain version each round an f32 result to bf16, so they
    may land one ulp apart; the bf16 tolerance admits that everywhere."""
    args = _torch_args(_case(*shape, seed=sum(shape)), torch.bfloat16)
    want = pa.paged_flash_attention_ref(*args)
    nudged = (want.view(torch.int16) + 1).view(torch.bfloat16)
    excess, err = pa.excess(nudged, *args)
    assert 0.0 < excess <= 1.0 and err > 0.0
