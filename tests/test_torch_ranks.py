"""The port across ranks on the CPU (gloo), against the JAX package: the
serve tick and the GPipe train step over a ``(data, stage, tensor)``
layout of processes, the collectives, and the rank layout itself.

Every launch goes through `repro_torch.launch.ranks.spawn`: one process a
rank, a ``FileStore`` under the test's ``tmp_path`` (no TCP port, so
``-n 6`` workers cannot collide), one intra-op thread a rank, a 60-s
timeout on every collective and a timeout on the launch as a whole, so a
deadlock fails a test instead of hanging the suite.

* Serve twin of ``test_multidevice.py::test_serve_tick_multistage_engine_
  equivalence``: the reduced qwen1.5-0.5b at pp=2 x tp=2 on 4 ranks, with
  JAX's ``init_params`` weights, that test's ``ServeDims``, throttle and
  prompts: JAX's greedy tokens (``greedy_generate``'s, its dense forward
  jitted once), and the port's single-process
  pp=2 engine's batch composition tick for tick; and rwkv6-3b at pp=2 x
  tp=1.
* Loss twin of ``::test_pipeline_loss_matches_dense_reference``: the
  reduced internlm2-1.8b at (2, 2, 2), lr 0, ``aux_coef`` 0, M=4, mb=2,
  T=16: within 2e-4 (JAX's bound) of JAX's dense cross-entropy.
* Train twin at (2, 2, 2) for each gradient mode: the loss finite and
  falling over 4 steps, every replicated leaf the same on all of its
  replicas; without compression each rank's leaves after 2 steps within
  1e-5 of the slice of the port's single-process step's (held to JAX's by
  test_torch_train.py; a few elements, whose gradient sits at rounding
  level where Adam's first steps are ~lr sign(g), come within 1e-5 and
  not closer).
* Collectives at 4 ranks against JAX's ``compressed_psum`` under
  ``shard_map`` on a 4-device host mesh (one subprocess, as
  test_multidevice's ``run_py``), on the same numpy inputs: ``int8`` bit
  for bit; f32 within 1e-6 of the largest sum; ``ring8`` over one axis of
  4 bit for bit but for each rank's own reduced chunk, which the port
  quantises and JAX leaves unquantised (there within half a final
  quantisation step, ``scale0 * 4 / 2``), and over two axes within one
  final quantisation step of each axis (``n * absmax / 127`` of what the
  axis sums) of JAX's and of the f32 sum; the port's result is the same on
  every rank, JAX's is not.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jax_get_config
from repro.configs import make_reduced as jax_make_reduced
from repro.models import transformer as jax_tfm
from repro.models.reference import dense_forward as jax_dense_forward
from repro_torch.configs import get_config, make_reduced
from repro_torch.core import SamplingParams, ThrottleConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.elastic import replan_to, shard_views
from repro_torch.distributed.optimizer import AdamConfig, adam_init
from repro_torch.distributed.pipeline import build_train_step
from repro_torch.launch import ranks as rk
from repro_torch.launch.mesh import (
    Layout,
    choose_backend,
    derive_pipeline_mesh,
    make_production_mesh,
    rank_device,
    rank_layout,
    use_ranks,
)
from repro_torch.launch.serve import rank_weight_bytes
from repro_torch.launch.train import train_rank
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.reference import greedy_generate
from repro_torch.models.serve import ServeDims
from repro_torch.models.transformer import (
    init_params,
    param_pspecs,
    shard_params,
    spec_axes,
    tree_items,
)
from repro_torch.runtime.engine import PipelineEngine
from torch_rank_jobs import serve_rank

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = ServeDims(Sp=1, C=16, Sd=8, pages=256, page=8, Bp=32, Bd=32, slots=16)
THROTTLE = dict(pipeline_depth=2, max_prefill_tokens=16,
                min_prefill_tokens=4, num_iters_T=2)
M, MB, T = 4, 2, 16
LOSS_TOL = 2e-4
PARAM_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spawn(fn, layout, job, tmp_path, name):
    return rk.spawn(fn, layout, (job,), store_dir=str(tmp_path / name),
                    threads=1, timeout_s=180, group_timeout_s=60)


def _jax_cfg(arch: str, pp: int, tp: int):
    cfg = jax_make_reduced(jax_get_config(arch)).with_plan(pp=pp, tp=tp)
    return dataclasses.replace(cfg, dtype="float32")


def _port_cfg(arch: str, pp: int, tp: int):
    cfg = make_reduced(get_config(arch)).with_plan(pp=pp, tp=tp)
    return dataclasses.replace(cfg, dtype="float32")


def _jax_params(cfg, path):
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


def _jax_greedy(cfg, params, prompt, max_new: int, width: int = 32):
    """JAX's ``greedy_generate``: the argmax of the dense forward's last
    position, each step; the forward jitted once at a padded `width`
    (causal attention keeps the padding out of the positions read)."""
    fwd = jax.jit(lambda t: jax_dense_forward(cfg, params, t))
    toks = list(prompt)
    for _ in range(max_new):
        ids = np.zeros((1, width), np.int32)
        ids[0, :len(toks)] = toks
        toks.append(int(jnp.argmax(fwd(jnp.asarray(ids))[0, len(toks) - 1])))
    return toks[len(prompt):]


def _record(eng):
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


# ----------------------------------------------------------------------------
# The layout
# ----------------------------------------------------------------------------

def test_layout_is_row_major_with_jax_mesh_names():
    lay = rank_layout(2, 2, 2)
    assert lay.world == 8 and lay.names == ("data", "stage", "tensor")
    for r in range(8):
        c = lay.coords(r)
        assert (c["data"], c["stage"], c["tensor"]) == tuple(
            int(i) for i in np.unravel_index(r, (2, 2, 2)))
        assert lay.rank_of(c) == r
    assert lay.line("stage", 5) == [5, 7]
    assert lay.line("tensor", 5) == [4, 5]
    assert lay.line("data", 5) == [1, 5]
    assert sorted(map(tuple, lay.lines("stage"))) == [(0, 2), (1, 3),
                                                      (4, 6), (5, 7)]
    prod = make_production_mesh()
    assert (prod.shape, prod.names) == ((16, 16), ("data", "model"))
    pod = make_production_mesh(multi_pod=True)
    assert (pod.shape, pod.names) == ((2, 16, 16), ("pod", "data", "model"))
    d = derive_pipeline_mesh(pod, 4, 4)
    assert d.shape == (2, 16, 4, 4)
    assert d.names == ("pod", "data", "stage", "tensor")
    with pytest.raises(ValueError, match="pp\\*tp"):
        derive_pipeline_mesh(prod, 4, 2)
    assert Layout((16,), ("model",)).world == 16


def test_backend_rule_and_devices():
    assert choose_backend(4, "cuda", 1) == "gloo"       # ranks share a card
    assert choose_backend(4, "cuda", 4) == "nccl"
    assert choose_backend(2, "cpu") == "gloo"
    assert choose_backend(4, "cuda", 8, "gloo") == "gloo"
    with pytest.raises(ValueError, match="card per rank"):
        choose_backend(4, "cuda", 1, "nccl")
    assert [rank_device(r, "cuda", 1) for r in range(3)] == ["cuda:0"] * 3
    assert rank_device(5, "cuda", 4) == "cuda:1"
    assert rank_device(5, "cpu") == "cpu"


def test_launchers_choose_processes_or_the_one_device_ring():
    assert use_ranks(1, 2, 2, "cpu") and use_ranks(2, 1, 1, "cuda", 1)
    assert use_ranks(1, 4, 1, "cuda", 4)          # a card a stage
    assert not use_ranks(1, 4, 1, "cuda", 1)      # the ring on one card
    assert not use_ranks(1, 2, 1, "cpu")
    assert not use_ranks(1, 1, 1, "cuda", 8)


# ----------------------------------------------------------------------------
# Specs and shards
# ----------------------------------------------------------------------------

def _norm_spec(spec):
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "olmoe-1b-7b",
                                  "minicpm3-4b", "rwkv6-3b",
                                  "jamba-1.5-large-398b", "whisper-small",
                                  "kimi-k2-1t-a32b"])
def test_param_pspecs_match_jax(arch):
    jspecs = dict(jax.tree_util.tree_flatten_with_path(
        jax_tfm.param_pspecs(_jax_cfg(arch, 2, 2)),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0])
    jspecs = {"/".join(str(k.key) for k in p): _norm_spec(s)
              for p, s in jspecs.items()}
    ours = {k: _norm_spec(s)
            for k, s in tree_items(param_pspecs(_port_cfg(arch, 2, 2)))}
    assert ours == jspecs


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "jamba-1.5-large-398b"])
def test_rank_draws_equal_the_slice_of_the_whole_tree(monkeypatch, arch):
    """`init_params(layout=, rank=)` keeps each rank's block of every leaf
    exactly as the whole tree draws it, whole leaves and leaves drawn in
    parts alike (the part size patched down so that the reduced model's
    leaves take that path too).  jamba's fused Mamba ``in_proj`` [d, 2 di]
    gives each rank its block of both halves (x, then z), a copy where
    every other leaf's block is a view; jamba's experts (expert
    parallelism over `data`) each data rank's block of them."""
    from repro_torch.models import transformer as tfm

    cfg = _port_cfg(arch, 2, 2)
    lay = rank_layout(2, 2, 2)
    for limit in (tfm._F32_DRAW_BYTES, 4096):
        monkeypatch.setattr(tfm, "_F32_DRAW_BYTES", limit)
        full = init_params(cfg, 3, dtype=torch.float32)
        for r in range(lay.world):
            mine = dict(tree_items(init_params(cfg, 3, dtype=torch.float32,
                                               layout=lay, rank=r)))
            want = dict(tree_items(shard_params(cfg, full, lay, r)))
            assert mine.keys() == want.keys()
            for k in want:
                assert torch.equal(mine[k], want[k]), (limit, r, k)
    rank = lay.world - 1
    assert rank_weight_bytes(cfg, lay, rank, torch.float32) == sum(
        t.numel() * 4 for t in want.values())             # the memory check
    views = dict(tree_items(shard_views(full, cfg, lay, rank)))
    whole = dict(tree_items(full))
    for k, t in tree_items(shard_params(cfg, full, lay, rank)):
        assert torch.equal(views[k], t)
        same = views[k].untyped_storage().data_ptr() == \
            whole[k].untyped_storage().data_ptr()
        assert same == (tfm.leaf_parts(k) == 1), k      # a view: no copy
    assert replan_to(cfg.with_plan(tp=1), lay).plan == cfg.plan
    shard = dict(tree_items(init_params(cfg, 3, dtype=torch.float32,
                                        layout=lay, rank=rank)))
    c = lay.coords(rank)
    if arch == "jamba-1.5-large-398b":
        di = cfg.mamba_d_inner
        w = di // 2
        got = shard["stages/b0_mamba_mlp/in_proj"]
        src = whole["stages/b0_mamba_mlp/in_proj"][c["stage"]:c["stage"] + 1]
        lo = c["tensor"] * w
        assert got.shape == (1, 1, cfg.d_model, di)
        assert torch.equal(got[..., :w], src[..., lo:lo + w])
        assert torch.equal(got[..., w:], src[..., di + lo:di + lo + w])
        assert shard["stages/b0_mamba_mlp/out_proj"].shape == (
            1, 1, w, cfg.d_model)
        return
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    assert shard["stages/b0_attn_mlp/wq"].shape == (1, 1, cfg.d_model,
                                                     H * hd // 2)
    assert shard["stages/b0_attn_mlp/wk"].shape == (1, 1, cfg.d_model,
                                                     KH * hd // 2)
    assert shard["stages/b0_attn_mlp/w_down"].shape == (1, 1, cfg.d_ff // 2,
                                                         cfg.d_model)
    assert shard["embed/tok"].shape == (cfg.padded_vocab, cfg.d_model // 2)
    assert shard["lm_head/w"].shape == (cfg.d_model, cfg.padded_vocab // 4)


def test_tensor_parallelism_refuses_what_it_does_not_split():
    """Every block kind shards at tp > 1 (olmoe's ATTN_MOE at tp=2);
    jamba (``ep_over_data``) at (2, 2, 2) draws its block of the experts
    over `data` at its tensor columns, the slice of the whole tree's; an
    expert count that does not divide dp, and a width that does not
    divide tp, raise `ValueError`."""
    cfg = _port_cfg("olmoe-1b-7b", 2, 2)
    shard = dict(tree_items(init_params(cfg, 0, dtype=torch.float32,
                                        layout=rank_layout(1, 2, 2),
                                        rank=1)))
    assert shard["stages/b0_attn_moe/w_gate"].shape == (
        1, 1, cfg.num_experts, cfg.d_model, cfg.moe_d_ff // 2)
    jamba = _port_cfg("jamba-1.5-large-398b", 2, 2)
    lay = rank_layout(2, 2, 2)
    whole = dict(tree_items(init_params(jamba, 0, dtype=torch.float32)))
    E, ff = jamba.num_experts, jamba.moe_d_ff
    for rank in range(lay.world):
        c = lay.coords(rank)
        mine = dict(tree_items(init_params(jamba, 0, dtype=torch.float32,
                                           layout=lay, rank=rank)))
        for key in ("stages/b8_attn_moe/w_up", "stages/b1_mamba_moe/w_down"):
            e = slice(c["data"] * E // 2, (c["data"] + 1) * E // 2)
            f = slice(c["tensor"] * ff // 2, (c["tensor"] + 1) * ff // 2)
            s = c["stage"]
            want = (whole[key][s:s + 1, :, e, :, f] if key.endswith("w_up")
                    else whole[key][s:s + 1, :, e, f, :])
            assert torch.equal(mine[key], want), (key, rank)
    with pytest.raises(ValueError, match="does not split"):
        init_params(jamba, 0, layout=rank_layout(3, 2, 2), rank=0)
    qwen = _port_cfg("qwen1.5-0.5b", 2, 3)
    with pytest.raises(ValueError, match="does not split"):
        init_params(qwen, 0, layout=rank_layout(1, 2, 3), rank=0)


# ----------------------------------------------------------------------------
# Serve
# ----------------------------------------------------------------------------

def test_serve_at_pp2_tp2_gives_jax_greedy_tokens(tmp_path):
    """The twin of test_multidevice's multistage engine test on 4 ranks."""
    jcfg, cfg = _jax_cfg("qwen1.5-0.5b", 2, 2), _port_cfg("qwen1.5-0.5b",
                                                          2, 2)
    jparams, tree = _jax_params(jcfg, tmp_path / "w.npz")
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in (9, 21)]
    want = [_jax_greedy(jcfg, jparams, p, 5) for p in prompts]
    one = cfg.with_plan(pp=2, tp=1)
    eng = PipelineEngine(one, DIMS, params_from_numpy(one, tree),
                         ThrottleConfig(**THROTTLE), device="cpu")
    ticks = _record(eng)
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=5),
                            request_id=f"r{i}") for i, p in enumerate(prompts)]
    eng.drain(max_ticks=400)
    job = dict(cfg=cfg, dims=DIMS, throttle=ThrottleConfig(**THROTTLE),
               prompts=prompts, max_new=5, device="cpu", dtype="float32",
               npz=str(tmp_path / "w.npz"))
    out = _spawn(serve_rank, rank_layout(1, 2, 2), job, tmp_path, "serve")
    assert out[0]["tokens"] == want
    assert [r.output_token_ids for r in reqs] == want
    assert out[0]["ticks"] == ticks
    assert out[0]["stats"]["ticks"] == eng.stats.ticks
    # every rank ran every tick; TP all-reduces on each, the hop between
    # the stages, the head's broadcast and gathers
    for o in out:
        assert o["rank_stats"]["ticks"] == eng.stats.ticks
        tr = o["rank_stats"]["traffic"]["bytes"]
        assert tr["tp"] > 0 and tr["hop"] > 0 and tr["head"] > 0


def test_rwkv_across_stages_matches_one_process(tmp_path):
    """rwkv6-3b at pp=2 x tp=1 on 2 ranks: the single-process pp=2
    engine's tokens and ticks on the same weights (JAX's), and the dense
    reference's tokens (the port's `greedy_generate`, held to JAX's by
    test_torch_rwkv.py)."""
    jcfg, cfg = _jax_cfg("rwkv6-3b", 2, 1), _port_cfg("rwkv6-3b", 2, 1)
    _, tree = _jax_params(jcfg, tmp_path / "w.npz")
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in (11, 19, 4)]
    eng = PipelineEngine(cfg, DIMS, params_from_numpy(cfg, tree),
                         ThrottleConfig(**THROTTLE), device="cpu")
    ticks = _record(eng)
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=4),
                            request_id=f"r{i}") for i, p in enumerate(prompts)]
    eng.drain(max_ticks=400)
    job = dict(cfg=cfg, dims=DIMS, throttle=ThrottleConfig(**THROTTLE),
               prompts=prompts, max_new=4, device="cpu", dtype="float32",
               npz=str(tmp_path / "w.npz"))
    out = _spawn(serve_rank, rank_layout(1, 2, 1), job, tmp_path, "serve")
    assert out[0]["tokens"] == [r.output_token_ids for r in reqs]
    assert out[0]["ticks"] == ticks
    full = params_from_numpy(cfg, tree)
    assert out[0]["tokens"] == [greedy_generate(cfg, full, p, 4)
                                for p in prompts]


@pytest.mark.parametrize("module,args,out", [
    ("serve", ["--reduced", "--pp", "2", "--tp", "2", "--requests", "3",
               "--max-new", "4"], ("3/3 requests", "ranks=4")),
    ("serve", ["--reduced", "--arch", "jamba-1.5-large-398b", "--tp", "2",
               "--requests", "3", "--max-new", "4"],
     ("3/3 requests", "ranks=2")),
    ("train", ["--arch", "rwkv6-3b", "--tp", "2", "--steps", "2", "--seq",
               "16"], ("step    1 loss=", "ranks=2")),
])
def test_serve_launcher_runs_ranks_on_cpu(tmp_path, module, args, out):
    """The serve launcher over pp=2 x tp=2 ranks (qwen) and tp=2 (jamba's
    three block kinds), and the train launcher at tp=2 (rwkv6-3b)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", f"repro_torch.launch.{module}", "--device",
         "cpu", *args, "--store", str(tmp_path / "store")],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert all(o in res.stdout for o in out), res.stdout[-2000:]


# ----------------------------------------------------------------------------
# Train
# ----------------------------------------------------------------------------

def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (M, MB, T))
            .astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (M, MB, T))
            .astype(np.int32)}


def test_lr0_loss_matches_jax_dense_cross_entropy(tmp_path):
    """The twin of test_multidevice's pipeline-loss test at (2, 2, 2)."""
    jcfg, cfg = _jax_cfg("internlm2-1.8b", 2, 2), _port_cfg(
        "internlm2-1.8b", 2, 2)
    jparams, tree = _jax_params(jcfg, tmp_path / "w.npz")
    batch = _batch(cfg)
    logits = np.asarray(jax_dense_forward(
        jcfg, jparams, jnp.asarray(batch["tokens"].reshape(M * MB, T))),
        np.float32)
    lse = np.asarray(jax.nn.logsumexp(jnp.asarray(logits), axis=-1))
    gold = np.take_along_axis(
        logits, batch["labels"].reshape(M * MB, T)[..., None], axis=-1)[..., 0]
    want = float(np.mean(lse - gold))
    job = dict(cfg=cfg, steps=1, batches=[batch], lr=0.0, aux_coef=0.0,
               device="cpu", dtype="float32", npz=str(tmp_path / "w.npz"),
               keep=1)
    out = _spawn(train_rank, rank_layout(2, 2, 2), job, tmp_path, "train")
    losses = {o["loss"][0] for o in out}
    assert len(losses) == 1                 # every rank reports the loss
    assert abs(out[0]["loss"][0] - want) < LOSS_TOL, (out[0]["loss"], want)
    lay = rank_layout(2, 2, 2)
    full = params_from_numpy(cfg, tree)
    for o in out:                           # lr 0: the step moved nothing
        want_p = dict(tree_items(shard_params(cfg, full, lay, o["rank"])))
        for k, v in o["params"].items():
            np.testing.assert_array_equal(v, want_p[k].numpy())


def _replicas_agree(out, cfg, lay):
    specs = dict(tree_items(param_pspecs(cfg)))
    for k in out[0]["params"]:
        split = spec_axes(specs[k])
        groups = {}
        for o in out:
            c = lay.coords(o["rank"])
            groups.setdefault(tuple(c[a] for a in lay.names if a in split),
                              []).append(o["params"][k])
        for vals in groups.values():
            for v in vals[1:]:
                np.testing.assert_array_equal(v, vals[0], err_msg=k)


@pytest.mark.parametrize("mode", [None, "int8", "ring8"])
def test_train_at_2x2x2(tmp_path, mode):
    cfg = _port_cfg("internlm2-1.8b", 2, 2)
    lay = rank_layout(2, 2, 2)
    batch = _batch(cfg)
    job = dict(cfg=cfg, steps=4, batches=[batch] * 4, lr=1e-3,
               device="cpu", dtype="float32", grad_compression=mode, keep=2)
    out = _spawn(train_rank, lay, job, tmp_path, "train")
    losses = out[0]["loss"]
    assert all(o["loss"] == losses for o in out)
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    _replicas_agree(out, cfg, lay)
    if mode is not None:
        return
    one = cfg.with_plan(pp=2, tp=1)
    p = init_params(one, 0, dtype=torch.float32).trainable()
    opt = adam_init(p)
    step = build_train_step(one, adam=AdamConfig(lr=1e-3), device="cpu")
    for _ in range(2):
        p, opt, m = step(p, opt, batch)
    assert abs(float(m["loss"]) - losses[1]) < 1e-5
    for o in out:
        want = dict(tree_items(shard_params(cfg, p, lay, o["rank"])))
        for k, v in o["params"].items():
            np.testing.assert_allclose(v, want[k].detach().numpy(), rtol=0,
                                       atol=PARAM_TOL, err_msg=k)


# ----------------------------------------------------------------------------
# Collectives against JAX
# ----------------------------------------------------------------------------

N_ELEMS = 4099                       # >= 4096, and not a multiple of 4
MODES = (None, "int8", "ring8")

JAX_PSUM = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.distributed.collectives import compressed_psum

path = sys.argv[1]
xs = np.load(path + "/x.npy")
out = {}
for shape, names in (((4,), ("data",)), ((2, 2), ("data", "stage"))):
    mesh = jax.make_mesh(shape, names,
                         axis_types=(jax.sharding.AxisType.Auto,) * len(names))
    for mode in (None, "int8", "ring8"):
        fn = jax.shard_map(
            lambda x, mode=mode: compressed_psum(x[0], names, mode=mode)[None],
            mesh=mesh, in_specs=P(names), out_specs=P(names),
            axis_names=frozenset(names), check_vma=False)
        out[f"{len(shape)}-{mode}"] = np.asarray(jax.jit(fn)(jnp.asarray(xs)))
np.savez(path + "/jax.npz", **out)
print("JAX_PSUM_DONE")
"""


def _psum_rank(ranks, xs):
    x = torch.from_numpy(xs[ranks.rank])
    out = {}
    for n_axes, names in ((1, ("data",)), (2, ("data", "stage"))):
        axes = [ranks[a] for a in names]
        for mode in MODES:
            out[f"{n_axes}-{mode}"] = coll.compressed_psum(
                x, mode, axes).numpy()
    return out


def test_compressed_psum_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    xs = (rng.standard_normal((4, N_ELEMS))
          * np.array([[0.5], [1.0], [2.0], [0.25]])).astype(np.float32)
    np.save(tmp_path / "x.npy", xs)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_PSUM),
                          str(tmp_path)], capture_output=True, text=True,
                         timeout=300, env=env)
    assert res.returncode == 0 and "JAX_PSUM_DONE" in res.stdout, \
        res.stderr[-3000:]
    jx = dict(np.load(tmp_path / "jax.npz"))
    # the 1-axis case on a layout of one axis of 4 ranks ("data"), the
    # 2-axis case on (data 2, stage 2): one layout (2, 2, 1) serves both
    # only for two axes, so the 1-axis ranks use a (4, 1, 1) layout
    ports = {}
    for lay, key in ((rank_layout(4, 1, 1), 1), (rank_layout(2, 2, 1), 2)):
        out = _spawn(_psum_rank, lay, xs, tmp_path, f"psum{key}")
        for mode in MODES:
            ports[f"{key}-{mode}"] = np.stack(
                [o[f"{key}-{mode}"] for o in out])
    total = xs.sum(axis=0)
    scale = np.abs(total).max()
    for key in ("1", "2"):
        np.testing.assert_array_equal(ports[f"{key}-int8"], jx[f"{key}-int8"])
        np.testing.assert_allclose(ports[f"{key}-None"], jx[f"{key}-None"],
                                   rtol=0, atol=1e-6 * scale)
        ring = ports[f"{key}-ring8"]
        assert all(np.array_equal(r, ring[0]) for r in ring)  # replicas
    # one axis of 4: each rank's chunks as JAX's, but for its own, which
    # JAX leaves unquantised
    chunk = -(-N_ELEMS // 4)
    scale0 = np.float32(max(np.abs(xs).max() / 127.0, 1e-30))
    for r in range(4):
        own = (r + 1) % 4
        mine = np.zeros(N_ELEMS, bool)
        mine[own * chunk:(own + 1) * chunk] = True
        got, want = ports["1-ring8"][r], jx["1-ring8"][r]
        np.testing.assert_array_equal(got[~mine], want[~mine])
        assert np.abs(got[mine] - want[mine]).max() <= scale0 * 4 / 2 * 1.0001
    # two axes (data, then stage, 2 ranks each): within one final
    # quantisation step of each axis, ``n * absmax / 127`` of what that
    # axis sums, of JAX's and of the f32 sum
    data_sums = xs.reshape(2, 2, N_ELEMS).sum(axis=0)
    bound = 2 * np.abs(xs).max() / 127 + 2 * np.abs(data_sums).max() / 127
    assert np.abs(ports["2-ring8"] - jx["2-ring8"]).max() <= bound
    assert np.abs(ports["2-ring8"] - total).max() <= bound
