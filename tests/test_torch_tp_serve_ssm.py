"""Tensor parallelism of the RWKV, Mamba and encoder-decoder blocks across
ranks on the CPU (gloo), served against the JAX package: the reduced
rwkv6-3b (RWKV) at tp=2, jamba-1.5-large-398b (MAMBA_MLP, MAMBA_MOE and
ATTN_MOE) at tp=2 and whisper-small (ENC_LAYER and DEC_LAYER, Te = 16
encoder frames) at tp=4, as tests/test_torch_tp_serve.py runs its cases
(the helpers are that module's): the ranks' greedy tokens equal the
one-process engine's and JAX's dense reference's, tick for tick.

The layouts: each of the six archs with a kind other than ATTN_MLP shards
over its published pipeline layout, JAX's production mesh with its
``model`` axis factored into (stage, tensor) (`derive_pipeline_mesh`),
jamba and kimi-k2 with their experts split over the 16 data replicas
(expert parallelism over `data`), and at one.

The shapes: at the published widths and tp of those archs, each rank's
cache arrays are the rank's block of JAX's
``cache_defs`` specs (``repro.models.serve.block_cache_defs``: KV heads,
WKV heads and Mamba's channels split over ``tensor``; the MLA latent pool,
the RWKV shift states and whisper's encoder snapshot whole), each with the
port's scratch page or slot.
"""

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import serve as jax_serve
from repro.models.serve import ServeDims as JServeDims
from repro_torch.configs import BlockKind, get_config
from repro_torch.launch.mesh import (
    Layout,
    derive_pipeline_mesh,
    make_production_mesh,
)
from repro_torch.models import serve as serve_lib
from repro_torch.models.serve import ServeDims
from repro_torch.models.transformer import (
    check_shardable,
    expert_parts,
    shard_config,
)

from test_torch_tp_serve import check_twin, serve_twin

TP_ARCHS = ("olmoe-1b-7b", "kimi-k2-1t-a32b", "minicpm3-4b", "rwkv6-3b",
            "jamba-1.5-large-398b", "whisper-small")
FULL = dict(Sp=1, C=512, Sd=32, pages=2048, page=16, Bp=128, Bd=128,
            slots=64, Te=1500)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch,tp,te", [
    ("rwkv6-3b", 2, 0),
    ("jamba-1.5-large-398b", 2, 0),
    ("whisper-small", 4, 16),
])
def test_served_across_tensor_ranks_gives_jax_greedy_tokens(
        arch, tp, te, tmp_path):
    check_twin(serve_twin(arch, 1, tp, tmp_path, seed=7, te=te))


def _rank_block(shape, spec, tp):
    """The rank's block of a JAX cache array: each dim split over
    ``tensor`` divided by tp (``data`` is 1 here)."""
    return tuple(n // tp if e == "tensor" else n
                 for n, e in zip(shape, tuple(spec) + (None,) * len(shape)))


@pytest.mark.parametrize("arch", TP_ARCHS)
def test_rank_caches_are_the_rank_block_of_jax_cache_specs(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    tp = cfg.plan.tp
    te = FULL["Te"] if cfg.is_encoder_decoder else 0
    local = shard_config(cfg, tp)
    dims = ServeDims(**{**FULL, "Te": te})
    jdims = JServeDims(**{**FULL, "Te": te})
    for bs in cfg.pattern:
        mine = serve_lib.block_cache_defs(local, bs.kind, dims, bs.repeat)
        if bs.kind == BlockKind.ENC_LAYER:
            shape, spec = jax_serve.cache_defs(jcfg, jdims)["enc_h"]["h"]
            assert "tensor" not in tuple(spec)
            want = {"h": _rank_block(shape[1:], tuple(spec)[1:], tp)}
        else:
            jax_kind = type(jcfg.pattern[0].kind)(bs.kind.value)
            want = {k: _rank_block(s, sp, tp) for k, (s, sp) in
                    jax_serve.block_cache_defs(jcfg, jax_kind, jdims,
                                               bs.repeat).items()}
        # the port's pools hold one scratch page or slot past JAX's
        grown = {}
        for k, shape in want.items():
            at = 0 if k == "h" else 1
            grown[k] = shape[:at] + (shape[at] + 1,) + shape[at + 1:]
        assert mine == grown, (bs.kind, mine, grown)
    heads = {BlockKind.RWKV: ("wkv", 2), BlockKind.MAMBA_MLP: ("ssm", 2)}
    for bs in cfg.pattern:
        if bs.kind in heads:
            name, dim = heads[bs.kind]
            whole = serve_lib.block_cache_defs(cfg, bs.kind, dims, 1)[name]
            part = serve_lib.block_cache_defs(local, bs.kind, dims, 1)[name]
            assert part[dim] * tp == whole[dim]


@pytest.mark.parametrize("arch", TP_ARCHS)
def test_published_layouts_shard(arch):
    cfg = get_config(arch)
    pp, tp = cfg.plan.pp, cfg.plan.tp
    prod = derive_pipeline_mesh(make_production_mesh(), pp, tp)
    assert (prod.size("data"), prod.size("stage"), prod.size("tensor")) == \
        (16, pp, tp)
    check_shardable(cfg, prod)
    if cfg.plan.ep_over_data:
        # expert parallelism: the experts split over the 16 data replicas
        local = shard_config(cfg, tp, expert_parts(cfg, 16))
        assert local.local_experts * 16 == cfg.num_experts
        one = derive_pipeline_mesh(Layout((1, pp * tp), ("data", "model")),
                                   pp, tp)
        check_shardable(cfg, one)
