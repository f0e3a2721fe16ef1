"""Training checkpoints across ranks on the CPU (gloo), against the
one-process save and the JAX package's restore.

* Saved at dp=2 x pp=2 x tp=2 (`train_rank` with ``ckpt``, an lr-0 step
  on JAX's ``init_params`` weights: the reduced qwen1.5-0.5b, and the
  reduced kimi-k2-1t-a32b with its experts split over `data`), every file,
  the manifest included, is byte-equal to `save_checkpoint` of the same
  weights in one process; JAX's ``restore_checkpoint`` reads it into JAX's
  ``init_params`` exactly (f32), and each rank's leaves after the step
  equal its block of the file.
* `restore_checkpoint(layout=, rank=)` gives every rank exactly its
  `shard_slices` block at tp=1, tp=2 and dp=2 (kimi's experts by data
  rank), and `elastic.rank_restore` re-tiles a pp=2 checkpoint for a
  pp=1 layout.
* The train launcher saves at ``--dp 2 --pp 2 --tp 2`` and resumes at
  ``--tp 1`` and in one process; its lr-0 step after resume gives the
  one-process loss of the saved parameters on the same batch.
* Without its manifest a checkpoint does not restore, and a write that
  fails on one rank raises on every rank and leaves no manifest.
"""

import filecmp
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
from repro.runtime import checkpoint as jax_ckpt
from repro_torch.data.tokens import batches
from repro_torch.distributed.elastic import rank_restore, replan
from repro_torch.distributed.optimizer import AdamConfig, adam_init
from repro_torch.distributed.pipeline import build_train_step
from repro_torch.launch.mesh import rank_layout
from repro_torch.launch.serve import serve_config
from repro_torch.launch.train import train_rank
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import (
    abstract_params,
    block_slices,
    leaf_parts,
    param_pspecs,
    shard_params,
    tree_items,
)
from repro_torch.runtime import checkpoint as ckpt
from test_torch_ranks import LOSS_TOL, _port_cfg, _spawn
from torch_rank_jobs import failed_save_rank
from test_torch_tp_serve import cfgs, jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen1.5-0.5b", "kimi-k2-1t-a32b")


def join_blocks(blocks, spec, shape, layout, parts=1):
    """The whole leaf of `shape` from every rank's block (`blocks` in rank
    order over `layout`): `shard_block`'s inverse.  Of a block replicated
    on several ranks, the last rank's is kept."""
    whole = torch.empty(shape, dtype=blocks[0].dtype)
    for rank, blk in enumerate(blocks):
        for w, b in block_slices(spec, shape, layout, rank, parts):
            whole[w] = blk[b]
    return whole


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def saved(request, tmp_path_factory):
    """JAX's weights saved across (2, 2, 2) ranks after an lr-0 step, and
    in one process."""
    arch = request.param
    jcfg, cfg = cfgs(arch, 2, 2)
    d = tmp_path_factory.mktemp(arch)
    jp, tree = jax_params(jcfg, d / "w.npz")
    job = dict(cfg=cfg, steps=1, seq=16, M=2, mbg=2, lr=0.0, aux_coef=0.0,
               device="cpu", dtype="float32", npz=str(d / "w.npz"),
               ckpt=str(d / "ranks"), keep=1)
    out = _spawn(train_rank, rank_layout(2, 2, 2), job, d, "store")
    one = cfg.with_plan(tp=1)
    ckpt.save_checkpoint(str(d / "one"), params_from_numpy(one, tree),
                         extra={"step": 0})
    return dict(arch=arch, cfg=cfg, jcfg=jcfg, jparams=jp, tree=tree,
                dir=d, out=out)


def test_save_at_ranks_is_the_one_process_save_byte_for_byte(saved):
    d = saved["dir"]
    names = sorted(os.listdir(d / "one"))
    assert sorted(os.listdir(d / "ranks")) == names
    assert "manifest.json" in names and len(names) > 10
    for name in names:
        assert filecmp.cmp(d / "ranks" / name, d / "one" / name,
                           shallow=False), name
    assert all(o["resumed"] is False and o["ckpt_s"] > 0
               for o in saved["out"])
    # each block written once: the ranks' bytes add up to the tree's
    total = sum(np.load(d / "one" / n).nbytes for n in names
                if n.endswith(".npy"))
    assert sum(o["ckpt_bytes"] for o in saved["out"]) == total


def test_jax_restores_the_rank_checkpoint_exactly(saved):
    got = jax_ckpt.restore_checkpoint(str(saved["dir"] / "ranks"),
                                      saved["jparams"])
    for (p, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(got)[0],
            jax.tree_util.tree_flatten_with_path(saved["jparams"])[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(p))


def test_each_rank_restores_its_own_leaves(saved):
    """The leaves each rank held after its step (``keep``) are its block
    of the file, and join into the whole tree (`join_blocks`)."""
    cfg, lay = saved["cfg"], rank_layout(2, 2, 2)
    specs = dict(tree_items(param_pspecs(cfg)))
    whole = dict(tree_items(params_from_numpy(cfg.with_plan(tp=1),
                                              saved["tree"])))
    for k, want in whole.items():
        got = join_blocks([torch.from_numpy(o["params"][k])
                           for o in saved["out"]], specs[k],
                          tuple(want.shape), lay, leaf_parts(k))
        assert torch.equal(got, want), k
    for r, o in enumerate(saved["out"]):
        got = ckpt.restore_checkpoint(str(saved["dir"] / "ranks"),
                                      abstract_params(cfg), layout=lay,
                                      rank=r, specs=param_pspecs(cfg))
        for k, t in tree_items(got):
            np.testing.assert_array_equal(t.numpy(), o["params"][k],
                                          err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("shape", [(1, 2, 1), (1, 2, 2), (2, 2, 1)],
                         ids=["tp1", "tp2", "dp2"])
def test_restore_at_a_layout_reads_each_rank_its_block(saved, shape):
    cfg = saved["cfg"].with_plan(tp=shape[2])
    lay = rank_layout(*shape)
    whole = params_from_numpy(cfg.with_plan(tp=1), saved["tree"])
    for r in range(lay.world):
        got = ckpt.restore_checkpoint(str(saved["dir"] / "ranks"),
                                      abstract_params(cfg), layout=lay,
                                      rank=r, specs=param_pspecs(cfg))
        want = dict(tree_items(shard_params(cfg, whole, lay, r)))
        for k, t in tree_items(got):
            assert torch.equal(t, want[k]), (r, k)


def test_rank_restore_retiles_to_another_stage_count(tmp_path):
    """A pp=2 checkpoint of a uniform pattern (qwen's) read at a pp=1 x
    tp=2 layout: each rank gets its block of `repartition_params`'s
    view."""
    from repro_torch.distributed.elastic import repartition_params
    from repro_torch.models.transformer import init_params

    cfg2, _ = serve_config("qwen1.5-0.5b", reduced=True, pp=2)
    whole = init_params(cfg2, 3)
    ckpt.save_checkpoint(str(tmp_path), whole)
    cfg = replan(cfg2, 1, 2)
    lay = rank_layout(1, 1, 2)
    whole = repartition_params(whole, cfg2, cfg.with_plan(tp=1))
    for r in range(lay.world):
        got = rank_restore(str(tmp_path), cfg, lay, r)
        want = dict(tree_items(shard_params(cfg, whole, lay, r)))
        for k, t in tree_items(got):
            assert torch.equal(t, want[k]), (r, k)


def test_restore_without_manifest_raises(saved, tmp_path):
    d = tmp_path / "partial"
    d.mkdir()
    for name in os.listdir(saved["dir"] / "ranks"):
        if name != "manifest.json":
            (d / name).write_bytes((saved["dir"] / "ranks" / name)
                                   .read_bytes())
    cfg = saved["cfg"]
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(d), abstract_params(cfg),
                                layout=rank_layout(2, 2, 2), rank=0,
                                specs=param_pspecs(cfg))
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(d), abstract_params(cfg))


def test_a_write_failed_on_one_rank_raises_everywhere_and_no_manifest(
        tmp_path):
    """Rank 1's block writes fail (a full disk) at tp=2: both saves, at
    once and in the background, raise on both ranks (rank 0 naming the
    other rank's failure) and write no manifest over the partial files."""
    cfg = _port_cfg("qwen1.5-0.5b", 1, 2)
    out = _spawn(failed_save_rank, rank_layout(1, 1, 2),
                 dict(cfg=cfg, dir=str(tmp_path)), tmp_path, "store")
    assert out[0] == {"sync": "RuntimeError", "async": "RuntimeError"}
    assert out[1] == {"sync": "OSError", "async": "OSError"}
    for name in ("sync", "async"):
        files = os.listdir(tmp_path / name)
        assert any(f.endswith(".npy") for f in files)
        assert "manifest.json" not in files, name


def _train(args, tmp_path, name):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--seq", "16", *args, "--store", str(tmp_path / name)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def test_launcher_saves_at_ranks_and_resumes_at_another_tp(tmp_path):
    """``--dp 2 --pp 2 --tp 2 --ckpt D`` trains two steps and saves; an
    lr-0 step resumed at ``--tp 1`` gives the one-process loss of the saved
    parameters on its batch (the first of dp=2 sequences a micro-batch);
    one process at ``--pp 2`` resumes from the same files."""
    d = str(tmp_path / "ck")
    out = _train(["--dp", "2", "--pp", "2", "--tp", "2", "--steps", "2",
                  "--ckpt", d, "--ckpt-every", "2"], tmp_path, "s1")
    assert f"checkpointed to {d}" in out
    first = float(re.search(r"step    0 loss=(\S+)", out).group(1))
    out = _train(["--dp", "2", "--pp", "2", "--tp", "1", "--steps", "1",
                  "--lr", "0", "--ckpt", d, "--resume"], tmp_path, "s2")
    assert f"resumed from {d}" in out
    resumed = float(re.search(r"step    0 loss=(\S+)", out).group(1))
    cfg, _ = serve_config("qwen1.5-0.5b", reduced=True, pp=2)
    params = ckpt.restore_checkpoint(d, abstract_params(cfg)).trainable()
    step = build_train_step(cfg, adam=AdamConfig(lr=0.0), device="cpu")
    _, _, m = step(params, adam_init(params),
                   next(batches(cfg.vocab_size, 2, 2, 16, seed=0)))
    assert abs(resumed - float(m["loss"])) < max(LOSS_TOL, 1e-4)
    assert abs(resumed - first) > 1e-3       # trained, then restored
    out = _train(["--pp", "2", "--steps", "1", "--lr", "0", "--ckpt", d,
                  "--resume"], tmp_path, "s3")
    assert f"resumed from {d}" in out
