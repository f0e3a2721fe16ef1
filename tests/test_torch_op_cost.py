"""The op count on the meta device (`roofline.op_cost`), the kernels' meta
branch, the counting collectives and the dry run (`launch.dryrun`), on the
CPU.

* The counter against the JAX package's ``hlo_cost.analyse_hlo_text``:
  seven trips of an 8x8 matmul (the program of tests/test_hlo_cost.py) are
  7·2·8³ flops, exactly; on the reduced qwen1.5-0.5b serve tick at one
  device, the weight GEMMs (the port's ``mm``, JAX's dots without batch
  dimensions) agree exactly, and so does the total (the attention kernel's
  booked cost against JAX's flash einsums over every table page): the
  tolerance is 0, and a failure names the flops by op.
* Each kernel's dispatch (`kernels.ops`): a CPU tensor reaches the plain
  version, a meta tensor books the kernel's `cost` and returns an empty
  result of the kernel's shape, and neither counts a launch; under
  autograd the fused MoE books its forward and runs its backward's
  products.  (A CUDA tensor reaching the kernel or raising is held on the
  card: tests/test_torch_kernel_gpu.py.)
* The counting axes: every collective books its payload bytes under its
  HLO name and returns a meta result, with no process group.
* The dry run finishes on meta for every assigned arch's ``decode_32k``
  at the single-pod layout and for jamba's ``long_500k``, whose geometry
  shards the decode KV over the data axis.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.configs import make_reduced as jax_make_reduced
from repro.distributed.pipeline import build_serve_tick as jax_serve_tick
from repro.launch.shapes import serve_input_specs as jax_input_specs
from repro.models import transformer as jax_tfm
from repro.models.serve import ServeDims as JaxServeDims
from repro.roofline.hlo_cost import analyse_hlo_text, parse_hlo
from repro_torch.configs import ASSIGNED_ARCHS, get_config, make_reduced
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.pipeline import build_serve_tick
from repro_torch.kernels import mamba_scan, moe_gemm, ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import rwkv6_scan
from repro_torch.launch import dryrun, shapes
from repro_torch.launch.mesh import counting_groups, rank_layout
from repro_torch.models import serve as serve_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.serve import ServeDims
from repro_torch.roofline.op_cost import COLLECTIVES, OpCounter

META = torch.device("meta")
DIMS = dict(Sp=1, C=16, Sd=2, pages=16, page=8, Bp=8, Bd=8, slots=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def test_seven_matmul_trips_count_as_the_hlo_parser_counts():
    x, w = _meta(8, 8), _meta(8, 8)
    with OpCounter() as c:
        y = x
        for _ in range(7):
            y = y @ w
    assert c.flops == 7 * 2 * 8 ** 3

    @jax.jit
    def f(x, w):
        def body(c, _):
            return c @ w, None
        y, _ = jax.lax.scan(body, x, None, length=7)
        return y

    a = jnp.ones((8, 8), jnp.float32)
    res = analyse_hlo_text(f.lower(a, a).compile().as_text())
    assert res["flops"] == pytest.approx(c.flops, rel=0.01)


def _jax_tick_hlo():
    jc = dataclasses.replace(jax_make_reduced(jax_get_config(
        "qwen1.5-0.5b")).with_plan(pp=1, tp=1), dtype="float32")
    mesh = jax.make_mesh((1, 1, 1), ("data", "stage", "tensor"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)
    with jax.set_mesh(mesh):
        dims = JaxServeDims(**DIMS)
        tick, specs = jax_serve_tick(jc, mesh, dims)
        params = jax.tree.map(
            lambda a, s: jax.ShapeDtypeStruct(
                a.shape, jnp.float32, sharding=NamedSharding(mesh, s)),
            jax_tfm.abstract_params(jc), jax_tfm.param_pspecs(jc),
            is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
        caches, carry, meta, fresh, _ = jax_input_specs(jc, dims, mesh,
                                                        specs)
        return jax.jit(tick).lower(params, caches, carry, meta,
                                   fresh).compile().as_text()


def _jax_dot_flops(text):
    """(weight-GEMM flops, batched-dot flops) of the HLO's dots, each once
    (the reduced tick's loops are unrolled: no trip counts to fold)."""
    from repro.roofline.hlo_cost import _dot_flops
    weights = batched = 0.0
    for comp in parse_hlo(text).values():
        for op in comp.ops:
            if op.kind == "dot":
                if "lhs_batch_dims" in op.attrs:
                    batched += _dot_flops(op, comp)
                else:
                    weights += _dot_flops(op, comp)
    return weights, batched


def test_reduced_qwen_tick_flops_match_the_jax_hlo():
    text = _jax_tick_hlo()
    weights, batched = _jax_dot_flops(text)
    total = analyse_hlo_text(text)["flops"]
    assert weights + batched == total
    cfg = dataclasses.replace(make_reduced(get_config(
        "qwen1.5-0.5b")).with_plan(pp=1, tp=1), dtype="float32")
    dims = ServeDims(**DIMS)
    meta = {k: _meta(*s, dtype=torch.int32)
            for k, s in shapes.meta_field_shapes(dims).items()}
    meta["p_tok"] = _meta(dims.Sp, dims.C, dtype=torch.int32)
    meta["d_tok"] = _meta(dims.Sd, dtype=torch.int32)
    tick = build_serve_tick(cfg, dims)
    with torch.inference_mode(), OpCounter() as c:
        tick(tfm.abstract_params(cfg, torch.float32),
             serve_lib.init_caches(cfg, dims, torch.float32, META), meta)
    by_op = {k: v[1] for k, v in c.by_op.items() if v[1]}
    assert by_op.get("mm") == weights, (by_op, weights, batched)
    assert c.flops == total, (by_op, weights, batched)


def _kernel_cases():
    """(name, ops function, args, kernel module, output shape) at small
    shapes, on the CPU."""
    g = torch.Generator().manual_seed(0)

    def rn(*s):
        return torch.randn(s, generator=g)

    i32 = torch.int32
    S, TQ, H, KH, D, page, B = 2, 3, 4, 2, 16, 4, 3
    pa_args = (rn(S, TQ, H, D), rn(S * B + 1, page, 2, KH, D),
               torch.arange(S * B, dtype=i32).view(S, B),
               torch.tensor([9, 5], dtype=i32),
               torch.tensor([[6, 7, 8], [2, 3, 4]], dtype=i32))
    E, C, d, ff = 3, 4, 8, 16
    moe_args = (rn(E, C, d), rn(E, d, ff), rn(E, d, ff), rn(E, ff, d),
                torch.tensor([4, 1, 0], dtype=i32))
    T, Hr, Dr, slots = 3, 2, 8, 4
    lens, slots_t = torch.tensor([3, 1], dtype=i32), torch.tensor(
        [0, 2], dtype=i32)
    fresh = torch.tensor([1, 0], dtype=i32)
    wkv_args = (rn(2, T, Hr, Dr), rn(2, T, Hr, Dr), rn(2, T, Hr, Dr),
                torch.rand(2, T, Hr, Dr, generator=g), rn(Hr, Dr),
                rn(slots, Hr, Dr, Dr), slots_t, lens, fresh)
    di, ds = 6, 4
    s6_args = (torch.rand(2, T, di, generator=g), rn(2, T, di), rn(2, T, ds),
               rn(2, T, ds), -torch.rand(di, ds, generator=g),
               rn(slots, di, ds), slots_t, lens, fresh)
    return [("paged_attention", ops.paged_attention, pa_args, pa,
             (S, TQ, H, D)),
            ("moe_ffn", ops.fused_moe_ffn, moe_args, moe_gemm, (E, C, d)),
            ("rwkv6_scan", ops.rwkv6_scan, wkv_args, rwkv6_scan,
             (2, T, Hr, Dr)),
            ("mamba_scan", ops.mamba_scan, s6_args, mamba_scan, (2, T, di))]


@pytest.mark.parametrize("case", range(4),
                         ids=["paged_attention", "moe_ffn", "rwkv6_scan",
                              "mamba_scan"])
def test_kernel_dispatch_cpu_plain_meta_booked(case):
    name, fn, args, mod, shape = _kernel_cases()[case]
    refs = {"paged_attention": pa.paged_flash_attention_ref,
            "moe_ffn": moe_gemm.fused_moe_ffn_ref,
            "rwkv6_scan": rwkv6_scan.rwkv6_scan_ref,
            "mamba_scan": mamba_scan.mamba_scan_ref}
    before = mod.launches
    cpu = [a.clone() for a in args]
    want = [a.clone() for a in args]
    got = fn(*cpu)
    torch.testing.assert_close(got, refs[name](*want), rtol=0, atol=0)
    meta = [a.to(META) for a in args]
    with OpCounter() as c:
        out = fn(*meta)
    assert out.is_meta and tuple(out.shape) == shape
    flops, nbytes = mod.cost(*meta)
    assert c.by_op[f"kernel:{name}"] == [1, flops, nbytes]
    assert flops > 0 and nbytes > 0
    assert mod.launches == before


def test_paged_attention_meta_books_the_lse_output():
    args = [a.to(META) for a in _kernel_cases()[0][2]]
    with OpCounter() as c:
        out, lse = ops.paged_attention(*args, with_lse=True)
    assert tuple(lse.shape) == tuple(out.shape[:-1])
    assert lse.dtype == torch.float32
    assert c.by_op["kernel:paged_attention"][1:] == list(
        pa.cost(*args, with_lse=True))


def test_moe_under_autograd_on_meta_books_forward_runs_backward():
    args = [a.to(META) for a in _kernel_cases()[1][2]]
    x, wg, wu, wd = (a.requires_grad_(True) for a in args[:4])
    with OpCounter() as c:
        ops.fused_moe_ffn(x, wg, wu, wd, args[4]).sum().backward()
    assert c.by_op["kernel:moe_ffn"][0] == 1
    assert c.by_op["bmm"][0] == 8            # the backward's products
    assert wg.grad is not None and wg.grad.is_meta


def test_counting_axes_book_collectives_and_call_no_process_group():
    assert not dist.is_initialized()
    ranks = counting_groups(rank_layout(2, 2, 2), 5)
    assert ranks.coords == {"data": 1, "stage": 0, "tensor": 1}
    t = _meta(4, 6)
    with OpCounter() as c:
        assert coll.all_reduce(t, ranks["tensor"]) is t
        got = coll.all_gather(t, ranks["data"])
        assert len(got) == 2 and all(g.is_meta for g in got)
        coll.broadcast(t, ranks["stage"], 1)
        coll.exchange(send=(t, ranks["stage"].peer(1)))
        out = coll.all_to_all(t, ranks["data"])
        assert out.is_meta and out.shape == t.shape
    n = 4 * 6 * 4
    assert c.collectives == {"all-reduce": 2 * n, "all-gather": n,
                             "reduce-scatter": 0, "all-to-all": n,
                             "collective-permute": n}


def _check_cell(d):
    assert set(d["collective_breakdown"]) == set(COLLECTIVES)
    assert d["hlo_flops"] > 0 and d["hlo_bytes"] > 0
    assert d["per_device_memory_bytes"] > 0
    assert isinstance(d["fits_hbm"], bool)
    for k in ("t_compute", "t_memory", "t_collective", "bottleneck"):
        assert k in d


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_dryrun_decode_cell_on_meta(arch):
    d = dryrun.analyse_cell(arch, "decode_32k", verbose=False)
    _check_cell(d)
    assert d["mesh"] == "16x16" and d["chips"] == 256
    assert len(d["stages"]) == get_config(arch).plan.pp


def test_dryrun_jamba_long_500k_shards_the_decode_kv():
    arch = "jamba-1.5-large-398b"
    cfg = get_config(arch)
    info = dryrun.lower_cell(arch, "long_500k")
    dims = info["dims"]
    assert dims.seq_shard and dims.Sp == dims.C == 0
    _check_cell(dryrun.analyse_cell(arch, "long_500k", verbose=False))
    # the same rank program without the shard: the attention partials'
    # merge over `data` is all the all-reduce bytes differ by, an
    # all-reduce of the max [Sd, 1, H] and one of the sum [Sd, 1, H, D + 1]
    # f32 for each attention layer of the stage
    layout, _ = dryrun.cell_layout(cfg)
    rank = layout.rank_of({"stage": 0})
    sharded = dryrun.count_serve(cfg, dims, layout, rank)
    whole = dryrun.count_serve(
        cfg, dataclasses.replace(dims, seq_shard=False), layout, rank)
    H = cfg.num_heads // cfg.plan.tp
    layers = sum(bs.repeat for bs in cfg.pattern
                 if bs.kind.value.startswith("attn"))
    merge = layers * 4 * dims.Sd * H * (cfg.head_dim + 2)
    assert (sharded["collectives"]["all-reduce"]
            - whole["collectives"]["all-reduce"]) == merge
    assert sharded["flops"] == whole["flops"]
