"""Cell geometry and the roofline cell against the JAX package, on the CPU
with no devices: `launch.shapes`, `roofline.analysis` and the dry run's
per-rank arguments.

* `serve_cell_dims` and `train_cell_dims` equal JAX's field for field, for
  every arch of the registry, each of its `applicable_shapes`, at ``data``
  in {1, 2, 16, 32}.
* `param_count` and `model_flops` equal JAX's; a `RooflineCell`'s terms
  equal JAX's once the constants' ratio is taken out (the port's are the
  H100's data-sheet rates, JAX's the TPU's), and so do `render_table`'s
  rows when the two cells are given counts that make their times equal.
* The dry run's per-rank parameter bytes (`dryrun.rank_params`, the
  rank's `shard_params` of `abstract_params` on the meta device) equal
  JAX's per-device bytes, computed from `param_pspecs` and its abstract
  params by arithmetic, for every arch at its production layout, on every
  stage.  No arch differs.
* One rank's abstract inputs are JAX's per-device shards
  (``NamedSharding.shard_shape`` over an ``AbstractMesh`` of the
  production layout): the training batch exactly; the caches but for the
  port's scratch page or slot at the end of each pool and, for whisper,
  the encoder snapshot, which the port keeps per encoder group
  (``b0_enc_layer/h``, JAX ``enc_h/h``); the tick's metadata fields per
  stage entry (the port's rank holds every stage's entry).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro.configs import applicable_shapes as jax_applicable_shapes
from repro.configs import get_config as jax_get_config
from repro.distributed.pipeline import build_serve_tick as jax_serve_tick
from repro.launch import shapes as jax_shapes
from repro.models import transformer as jax_tfm
from repro.roofline import analysis as jax_analysis
from repro_torch.configs import (
    ASSIGNED_ARCHS,
    ASSIGNED_SHAPES,
    applicable_shapes,
    get_config,
    list_archs,
)
from repro_torch.launch import dryrun, shapes
from repro_torch.launch.mesh import counting_groups
from repro_torch.roofline import analysis

DATA = (1, 2, 16, 32)


def _fields(x) -> dict:
    return dataclasses.asdict(x)


@pytest.mark.parametrize("arch", list_archs())
def test_cell_dims_equal_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert [s.name for s in applicable_shapes(cfg)] == \
        [s.name for s in jax_applicable_shapes(jcfg)]
    for shape in applicable_shapes(cfg):
        for data in DATA:
            if shape.kind == "train":
                got = shapes.train_cell_dims(cfg, shape, data=data)
                want = jax_shapes.train_cell_dims(jcfg, shape, data=data)
            else:
                got = shapes.serve_cell_dims(cfg, shape, data=data)
                want = jax_shapes.serve_cell_dims(jcfg, shape, data=data)
            assert _fields(got) == _fields(want), (shape.name, data)


def test_seq_shard_only_where_jax_shards():
    sharded = [(a, s.name) for a in list_archs()
               for s in applicable_shapes(get_config(a))
               if s.kind == "decode"
               and shapes.serve_cell_dims(get_config(a), s).seq_shard]
    assert sharded == [("jamba-1.5-large-398b", "long_500k")]


@pytest.mark.parametrize("arch", list_archs())
def test_param_count_and_model_flops_equal_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for active in (False, True):
        assert analysis.param_count(cfg, active) == \
            jax_analysis.param_count(jcfg, active)
    for shape in applicable_shapes(cfg):
        for chips in (256, 512):
            assert analysis.model_flops(cfg, shape, chips, shape.kind) == \
                jax_analysis.model_flops(jcfg, shape, chips, shape.kind)


def _cells(flops, nbytes, coll, ratio=(1.0, 1.0, 1.0)):
    kw = dict(arch="x", shape="decode_32k", mesh="16x16", chips=256,
              collective_breakdown={}, model_flops_per_chip=0.5 * flops,
              per_device_memory_bytes=1e9)
    port = analysis.RooflineCell(hlo_flops=flops, hlo_bytes=nbytes,
                                 collective_bytes=coll, **kw)
    jax_cell = jax_analysis.RooflineCell(
        hlo_flops=flops * ratio[0], hlo_bytes=nbytes * ratio[1],
        collective_bytes=coll * ratio[2],
        **dict(kw, model_flops_per_chip=0.5 * flops * ratio[0]))
    return port, jax_cell


@pytest.mark.parametrize("counts", [(1e12, 1e9, 1e8), (1e10, 1e11, 1e8),
                                    (1e9, 1e8, 1e11)])
def test_roofline_cell_terms_equal_jax_after_the_constants(counts):
    port, jcell = _cells(*counts)
    assert port.t_compute * analysis.PEAK_FLOPS == pytest.approx(
        jcell.t_compute * jax_analysis.PEAK_FLOPS)
    assert port.t_memory * analysis.HBM_BW == pytest.approx(
        jcell.t_memory * jax_analysis.HBM_BW)
    assert port.t_collective * analysis.NVLINK_BW == pytest.approx(
        jcell.t_collective * jax_analysis.ICI_BW)
    assert port.useful_ratio == jcell.useful_ratio
    # counts scaled by the constants' ratio give JAX's times, bottleneck,
    # roofline fraction and table row
    ratio = (jax_analysis.PEAK_FLOPS / analysis.PEAK_FLOPS,
             jax_analysis.HBM_BW / analysis.HBM_BW,
             jax_analysis.ICI_BW / analysis.NVLINK_BW)
    port, jcell = _cells(*counts, ratio=ratio)
    for k in ("t_compute", "t_memory", "t_collective", "roofline_fraction"):
        assert getattr(port, k) == pytest.approx(getattr(jcell, k))
    assert port.bottleneck == jcell.bottleneck
    d, jd = port.to_dict(), jcell.to_dict()
    assert set(jd) <= set(d) and d["fits_hbm"]
    assert analysis.render_table([port]) == jax_analysis.render_table([jcell])


def _jax_per_device_bytes(jcfg) -> float:
    """JAX's per-device parameter bytes at the production mesh: each
    leaf's bytes over the sizes of the axes its spec names."""
    sizes = {"data": 16, "stage": jcfg.plan.pp, "tensor": jcfg.plan.tp}
    specs = {jax.tree_util.keystr(k): s for k, s in
             jax.tree_util.tree_flatten_with_path(
                 jax_tfm.param_pspecs(jcfg),
                 is_leaf=lambda x: isinstance(x, P))[0]}
    total = 0.0
    for k, a in jax.tree_util.tree_flatten_with_path(
            jax_tfm.abstract_params(jcfg))[0]:
        split = 1
        for entry in specs[jax.tree_util.keystr(k)]:
            for name in entry if isinstance(entry, tuple) else (entry,):
                split *= sizes[name] if name else 1
        total += np.prod(a.shape) * a.dtype.itemsize / split
    return total


@pytest.mark.parametrize("arch", list_archs())
def test_rank_param_bytes_equal_jax_per_device_bytes(arch):
    cfg = get_config(arch)
    layout, _ = dryrun.cell_layout(cfg)
    want = _jax_per_device_bytes(jax_get_config(arch))
    for s in range(cfg.plan.pp):
        params = dryrun.rank_params(cfg, layout, layout.rank_of({"stage": s}))
        assert shapes.nbytes(params) == want, s


def _mesh(cfg):
    return AbstractMesh((16, cfg.plan.pp, cfg.plan.tp),
                        ("data", "stage", "tensor"))


def _shard(x):
    return tuple(x.sharding.shard_shape(x.shape))


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_rank_inputs_are_jax_device_shards(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    mesh = _mesh(jcfg)
    layout, _ = dryrun.cell_layout(cfg)
    train = ASSIGNED_SHAPES["train_4k"]
    got = shapes.train_batch_specs(
        cfg, shapes.train_cell_dims(cfg, train), data=16)
    want = jax_shapes.train_batch_specs(
        jcfg, jax_shapes.train_cell_dims(jcfg, train), mesh)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: _shard(v) for k, v in want.items()}
    ranks = counting_groups(layout, layout.rank_of({"stage": 1}))
    for shape in applicable_shapes(cfg):
        if shape.kind == "train":
            continue
        dims = shapes.serve_cell_dims(cfg, shape)
        jdims = jax_shapes.serve_cell_dims(jcfg, shape)
        _, specs = jax_serve_tick(jcfg, mesh, jdims)
        caches, _, meta, _, _ = jax_shapes.serve_input_specs(
            jcfg, jdims, mesh, specs)
        x = shapes.serve_input_specs(cfg, dims, ranks,
                                     getattr(torch, cfg.dtype))
        for gk, grp in caches.items():
            for name, leaf in grp.items():
                want = list(_shard(leaf))
                if gk == "enc_h":           # the port's per-group snapshot
                    gk = next(k for k in x["caches"]
                              if k.endswith("enc_layer"))
                    want[1] += 1            # its scratch slot
                else:                       # the scratch page or slot
                    want[2] += 1
                assert tuple(x["caches"][gk][name].shape) == tuple(want), \
                    (shape.name, gk, name)
        for k, v in meta.items():
            assert tuple(x["meta"][k].shape)[1:] == _shard(v)[1:], k
            assert x["meta"][k].shape[0] == cfg.plan.pp
