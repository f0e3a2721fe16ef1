"""Tensor parallelism of the MoE and MLA blocks across ranks on the CPU
(gloo), served against the JAX package: the reduced olmoe-1b-7b
(ATTN_MOE) at tp=4, kimi-k2-1t-a32b (ATTN_MOE with its shared expert) at
tp=2, and minicpm3-4b (MLA_MLP) at tp=2 and at pp=2 x tp=2.

Each case runs f32 with JAX's ``init_params`` weights (carried across by
`params_from_numpy`; every rank cuts its shard from the saved tree), dropless
(capacity factor = the expert count, as tests/test_torch_archs.py builds
the MoE archs), one stage's uniform pattern two layers deep at pp=1.  The
ranks serve through `torch_rank_jobs.serve_rank` (`launch.ranks.spawn`: one
process a rank, a ``FileStore`` under ``tmp_path``, one intra-op thread a
rank, a 60-s group timeout and a launch timeout).  Their greedy tokens
must equal the port's one-process engine's on the same weights and JAX's
dense reference's (read off one teacher-forced jitted forward), and the
batch of every tick the one-process engine's.  Every rank's traffic holds
the TP all-reduces.  Where the routing is computed whole on every rank, a
rank that routed differently from the others would fail the token check.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import BlockSpec as JBlockSpec
from repro.configs import get_config as jax_get_config
from repro.configs import make_reduced as jax_make_reduced
from repro.models import reference as jax_reference
from repro.models import transformer as jax_tfm
from repro_torch.configs import BlockSpec, get_config, make_reduced
from repro_torch.core import SamplingParams, ThrottleConfig
from repro_torch.launch import ranks as rk
from repro_torch.launch.mesh import rank_layout
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.serve import ServeDims
from repro_torch.runtime.engine import PipelineEngine
from torch_rank_jobs import serve_rank

DIMS = dict(Sp=1, C=16, Sd=8, pages=256, page=8, Bp=32, Bd=32, slots=16)
THROTTLE = dict(max_prefill_tokens=16, min_prefill_tokens=4, num_iters_T=2)
PROMPT_LENS = (9, 21, 5)            # 21 exceeds C=16
MAX_NEW = 5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(arch: str, pp: int, tp: int):
    """(JAX config, the port's config at `tp`): reduced, f32, dropless, at
    pp stages; at pp=1 a uniform pattern two layers deep.  JAX's runs its
    dense forward at one device (no expert parallelism)."""
    j, t = jax_make_reduced(jax_get_config(arch)), make_reduced(
        get_config(arch))
    if pp == 1 and len(t.pattern) == 1:
        j = dataclasses.replace(
            j, pattern=(JBlockSpec(j.pattern[0].kind, 2),), num_layers=2)
        t = dataclasses.replace(
            t, pattern=(BlockSpec(t.pattern[0].kind, 2),), num_layers=2)
    cf = float(max(j.num_experts, 1))
    j = dataclasses.replace(j.with_plan(pp=pp, tp=1, ep_over_data=False),
                            dtype="float32", moe_capacity_factor=cf)
    t = dataclasses.replace(t.with_plan(pp=pp, tp=tp), dtype="float32",
                            moe_capacity_factor=cf)
    return j, t


def jax_params(cfg, path):
    """JAX's ``init_params`` tree, saved as npz (``/``-joined paths) for
    the ranks, and as a numpy tree."""
    params = jax_tfm.init_params(cfg, jax.random.key(0), dtype=jnp.float32)
    flat = {"/".join(str(k.key) for k in p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(path, **flat)
    tree = {}
    for key, a in flat.items():
        node = tree
        *heads, leaf = key.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = a
    return params, tree


def jax_greedy(jcfg, jparams, prompts, outs, encs=None):
    """JAX's dense reference's greedy tokens along `outs`: one jitted
    `dense_forward` over every prompt and its output (padded at the end;
    causal), an encoder-decoder's encoder input prepended and the logits
    read on the decoder half, at the positions that predict each output
    token."""
    rows = [list(p) + list(o) for p, o in zip(prompts, outs)]
    ids = np.zeros((len(rows), max(map(len, rows))), np.int32)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
    fwd = jax.jit(jax_reference.dense_forward, static_argnums=0)
    args = (jnp.asarray(ids),)
    if encs is not None:
        args += (jnp.asarray(np.stack(encs)),)
    logits = np.asarray(fwd(jcfg, jparams, *args))
    te = 0 if encs is None else encs[0].shape[0]
    return [[int(np.argmax(logits[i, te + len(p) - 1 + k]))
             for k in range(len(o))]
            for i, (p, o) in enumerate(zip(prompts, outs))]


def record(eng):
    """The entering batch of every tick, as `serve_rank` records it."""
    ticks = []
    inner = eng.backend.execute

    def execute(ring, exiting_id, now):
        b = (eng.scheduler.get_batch(ring[0][0])
             if ring[0][0] is not None else None)
        ticks.append(None if b is None else [
            [[q.request.request_id, q.start_pos, q.num_tokens]
             for q in b.prefill],
            [q.request.request_id for q in b.decode]])
        return inner(ring, exiting_id, now)

    eng.backend.execute = execute
    return ticks


def serve_twin(arch: str, pp: int, tp: int, tmp_path, seed: int = 5,
               te: int = 0):
    """The case's JAX greedy tokens, the one-process engine's tokens and
    ticks, and the ranks' results."""
    jcfg, cfg = cfgs(arch, pp, tp)
    dims = ServeDims(**DIMS, Te=te)
    jparams, tree = jax_params(jcfg, tmp_path / "w.npz")
    rng = np.random.default_rng(seed)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in PROMPT_LENS]
    encs = None
    if te:
        encs = [(rng.normal(size=(te, cfg.d_model)) * 0.05)
                .astype(np.float32) for _ in prompts]
    one = cfg.with_plan(tp=1)
    throttle = ThrottleConfig(pipeline_depth=pp, **THROTTLE)
    eng = PipelineEngine(one, dims, params_from_numpy(one, tree), throttle,
                         device="cpu")
    ticks = record(eng)
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=MAX_NEW),
                            request_id=f"r{i}",
                            **({} if encs is None else
                               {"enc_embeds": encs[i]}))
            for i, p in enumerate(prompts)]
    eng.drain(max_ticks=400)
    single = [r.output_token_ids for r in reqs]
    job = dict(cfg=cfg, dims=dims, throttle=throttle, prompts=prompts,
               encs=encs, max_new=MAX_NEW, device="cpu", dtype="float32",
               npz=str(tmp_path / "w.npz"))
    out = rk.spawn(serve_rank, rank_layout(1, pp, tp), (job,),
                   store_dir=str(tmp_path / "store"), threads=1,
                   timeout_s=180, group_timeout_s=60)
    return dict(want=jax_greedy(jcfg, jparams, prompts, single, encs),
                single=single, ticks=ticks, stats=eng.stats, out=out)


def check_twin(r):
    head = r["out"][0]
    assert head["tokens"] == r["single"] == r["want"]
    assert all(head["finished"])
    assert head["ticks"] == r["ticks"]
    assert head["stats"]["ticks"] == r["stats"].ticks
    for o in r["out"]:
        assert o["rank_stats"]["ticks"] == r["stats"].ticks
        assert o["rank_stats"]["traffic"]["bytes"]["tp"] > 0


@pytest.mark.parametrize("arch,pp,tp", [
    ("olmoe-1b-7b", 1, 4),
    ("kimi-k2-1t-a32b", 1, 2),
    ("minicpm3-4b", 1, 2),
    ("minicpm3-4b", 2, 2),
])
def test_served_across_tensor_ranks_gives_jax_greedy_tokens(
        arch, pp, tp, tmp_path):
    check_twin(serve_twin(arch, pp, tp, tmp_path))
