"""Training through the port's kernels: the fused-MoE kernel under autograd
(`moe_gemm.FusedMoEFFN`, the Hopper forward and `fused_moe_ffn_backward`)
and the kernels without a backward.  This file imports no JAX.

On the CPU: the backward's formula itself, fed the plain forward's inputs,
against autograd through `fused_moe_ffn_ref` within
`moe_gemm.GRAD_TOLERANCE` (f32 and bf16, ragged `counts` with finite
garbage past them), a backward with a planted fault (the sigmoid in place
of silu's derivative) failing the same check, and in f32 one fed operands
rounded to TF32's precision failing it too; and `moe_apply`'s dispatch
carrying the gradients of the dense oracle `moe_ref` where nothing drops.

On the card (``gpu`` marker; whether a card is present is decided in a
fixture at run time, so they skip without one):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_train_gpu.py

the Function's gradients against autograd through the plain version, the
planted backward and (f32) a TF32 backward failing; the paged-attention, WKV6 and Mamba wrappers
raising on an input that requires grad; and an MoE train step on the card
launching the kernel layers x M x 2 times (each forward again in the
backward's recomputation) and giving the CPU step's loss.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import BlockSpec, get_config, make_reduced
from repro_torch.distributed.optimizer import adam_init
from repro_torch.distributed.pipeline import build_train_step
from repro_torch.kernels import moe_gemm, ops
from repro_torch.models import moe as moe_lib
from repro_torch.models.transformer import init_params

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _case(E, C, d, ff, counts, seed, device="cpu", dtype=torch.float32):
    """Unit-variance rows, the serve path's weight scale (0.02), finite
    garbage past each expert's count, a unit-variance output gradient."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(E, C, d, generator=g)
    ws = [torch.randn(*s, generator=g) * 0.02
          for s in ((E, d, ff), (E, d, ff), (E, ff, d))]
    dout = torch.randn(E, C, d, generator=g)
    counts = torch.tensor(counts, dtype=torch.int32)
    return ([t.to(device, dtype) for t in [x] + ws] + [counts.to(device)],
            dout.to(device, dtype))


CPU_CASES = [(4, 16, 32, 64, [16, 5, 0, 11]), (2, 24, 64, 32, [24, 24])]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CPU_CASES, ids=lambda c: "x".join(
    map(str, c[:4])))
def test_backward_formula_matches_autograd_of_plain(case, dtype):
    *shape, counts = case
    args, dout = _case(*shape, counts, seed=sum(shape),
                       dtype=DTYPES[dtype])
    grads = moe_gemm.fused_moe_ffn_backward(*args, dout)
    for grad, t in zip(grads, args):
        assert grad.dtype == t.dtype and grad.shape == t.shape
    excess, err = moe_gemm.grad_excess(grads, *args, dout)
    assert excess <= 1.0, f"max abs err {err}"
    live = torch.arange(shape[1])[None, :] < args[4][:, None]
    assert torch.all(grads[0][~live] == 0)       # rows past counts: zero dx
    planted = moe_gemm.fused_moe_ffn_backward(*args, dout,
                                              dsilu=torch.sigmoid)
    assert moe_gemm.grad_excess(planted, *args, dout)[0] > 1.0
    if dtype == "float32":
        # TF32's precision: every operand rounded to 10 mantissa bits
        rounded = [_tf32(t) for t in args[:4]]
        planted = moe_gemm.fused_moe_ffn_backward(*rounded, args[4],
                                                  _tf32(dout))
        assert moe_gemm.grad_excess(planted, *args, dout)[0] > 1.0


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 `t` rounded to TF32 (10 mantissa bits, to nearest)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def test_moe_apply_carries_the_gradients_of_the_dense_oracle():
    """Dropless capacity: `moe_apply`'s sort, capacity buffers and combine
    pass the gradients of `moe_ref` (the dense per-expert sum) to x, the
    router and every expert; the aux loss has a router gradient."""
    torch.manual_seed(0)
    T, d, E, ff, k = 24, 32, 4, 48, 2
    x = torch.randn(T, d, requires_grad=True)
    params = {"router": torch.randn(d, E) * 0.2,
              "w_gate": torch.randn(E, d, ff) * 0.1,
              "w_up": torch.randn(E, d, ff) * 0.1,
              "w_down": torch.randn(E, ff, d) * 0.1}
    for t in params.values():
        t.requires_grad_(True)
    leaves = [x] + list(params.values())
    y, aux = moe_lib.moe_apply(x, params, top_k=k, capacity_factor=float(E))
    got = torch.autograd.grad((y * y).sum(), leaves, retain_graph=True)
    want = torch.autograd.grad((moe_lib.moe_ref(x, params, top_k=k) ** 2)
                               .sum(), leaves)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-6)
    assert float(torch.autograd.grad(aux, params["router"])[0].abs().max()) > 0


@pytest.fixture
def cuda_device():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


GPU_CASES = [(4, 16, 128, 256, [16, 5, 0, 11]),
             (64, 648, 2048, 1024, list(range(648, 648 - 64 * 9, -9)))]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", GPU_CASES, ids=lambda c: "x".join(
    map(str, c[:4])))
def test_function_grads_match_plain_on_card(cuda_device, case, dtype):
    """Through `ops.fused_moe_ffn` with inputs that require grad: one
    kernel launch, gradients within GRAD_TOLERANCE of autograd through the
    plain version (olmoe's training shapes: E=64, C=648 at 4,096 rows,
    top-8, capacity factor 1.25, ragged); the planted backward fails, and
    in f32 so does the backward fed operands rounded to TF32 and, at
    olmoe's shapes, the backward run on TF32 products."""
    *shape, counts = case
    args, dout = _case(*shape, counts, seed=sum(shape), device=cuda_device,
                       dtype=DTYPES[dtype])
    leaves = [t.detach().requires_grad_(True) for t in args[:4]]
    before = moe_gemm.launches
    out = ops.fused_moe_ffn(*leaves, args[4])
    assert moe_gemm.launches == before + 1
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, leaves, dout)
    excess, err = moe_gemm.grad_excess(grads, *args, dout)
    assert excess <= 1.0, f"max abs err {err}"
    planted = moe_gemm.fused_moe_ffn_backward(*args, dout,
                                              dsilu=torch.sigmoid)
    assert moe_gemm.grad_excess(planted, *args, dout)[0] > 1.0
    if dtype == "float32":
        rounded = [_tf32(t) for t in args[:4]]
        planted = moe_gemm.fused_moe_ffn_backward(*rounded, args[4],
                                                  _tf32(dout))
        assert moe_gemm.grad_excess(planted, *args, dout)[0] > 1.0
    if dtype == "float32" and case is GPU_CASES[-1]:
        # TF32 products (at the small shape cuBLAS keeps its f32 kernels)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            planted = moe_gemm.fused_moe_ffn_backward(*args, dout)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        assert moe_gemm.grad_excess(planted, *args, dout)[0] > 1.0


@pytest.mark.gpu
def test_kernels_without_backward_raise_on_card(cuda_device):
    dev = cuda_device
    f = dict(device=dev, dtype=torch.float32)
    i32 = dict(device=dev, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.paged_attention(torch.zeros(1, 1, 2, 64, **f, requires_grad=True),
                            torch.zeros(4, 8, 2, 2, 64, **f),
                            torch.zeros(1, 1, **i32), torch.ones(1, **i32),
                            torch.zeros(1, 1, **i32))
    r = torch.zeros(1, 1, 2, 64, **f, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.rwkv6_scan(r, r, r, r, torch.zeros(2, 64, **f),
                       torch.zeros(2, 2, 64, 64, **f), torch.zeros(1, **i32),
                       torch.ones(1, **i32), torch.ones(1, **i32))
    dt = torch.zeros(1, 1, 128, **f, requires_grad=True)
    b = torch.zeros(1, 1, 16, **f)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.mamba_scan(dt, dt, b, b, torch.zeros(128, 16, **f),
                       torch.zeros(2, 128, 16, **f), torch.zeros(1, **i32),
                       torch.ones(1, **i32), torch.ones(1, **i32))


@pytest.mark.gpu
def test_moe_train_step_runs_the_kernel_on_card(cuda_device):
    """A two-layer olmoe at widths the kernel takes (d = ff = 128), f32:
    the step on the card launches the MoE kernel layers x M x 2 times and
    gives the CPU step's loss, aux and gnorm."""
    cfg = make_reduced(get_config("olmoe-1b-7b"), d_model=128, d_ff=128)
    cfg = dataclasses.replace(
        cfg, moe_d_ff=128, num_layers=2, dtype="float32",
        pattern=(BlockSpec(cfg.pattern[0].kind, 2),),
        plan=dataclasses.replace(cfg.plan, pp=1, tp=1))
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 1, 64)).astype(np.int32)
             for k in ("tokens", "labels")}
    metrics = {}
    for dev in ("cpu", cuda_device):
        params = init_params(cfg, 0, dtype=torch.float32).to(dev).trainable()
        step = build_train_step(cfg, device=dev)
        before = moe_gemm.launches
        _, _, m = step(params, adam_init(params), batch)
        metrics[str(dev)] = {k: float(v) for k, v in m.items()}
        launched = moe_gemm.launches - before
    assert launched == 2 * 2 * 2
    for k in ("loss", "aux", "gnorm"):
        want = metrics["cpu"][k]
        assert abs(metrics["cuda"][k] - want) <= 1e-4 * abs(want), k
