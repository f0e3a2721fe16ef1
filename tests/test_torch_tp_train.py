"""The GPipe train step with tensor parallelism of the MoE and MLA blocks
across ranks on the CPU (gloo), against the JAX package and the port's
one-process step: the reduced olmoe-1b-7b (ATTN_MOE) at tp=4,
kimi-k2-1t-a32b (ATTN_MOE with its shared expert) at tp=2 and
minicpm3-4b (MLA_MLP) at tp=2 and at dp=2 x tp=2 (each data rank one of
a micro-batch's two sequences), configured as tests/test_torch_tp_serve.py
configures them (f32, dropless, two layers at pp=1), with JAX's
``init_params`` weights.

One launch a case (`launch.ranks.run_each` of `launch.train.train_rank`):

* at lr 0 and ``aux_coef`` 0, the loss within 2e-4 (JAX's bound) of JAX's
  dense cross-entropy, the same on every rank, and no leaf moved;
* after 2 steps at lr 1e-3 (``aux_coef`` 0.01: the MoE load-balancing loss
  is in the gradient), each rank's leaves within 1e-5 of its block of the
  port's one-process step's leaves (held to JAX's by test_torch_train.py),
  and every replicated leaf equal on all of its replicas (but for the
  few elements whose gradient sits at Adam's eps, `ILL_V`).  A
  ``copy_to_tensor`` on a tensor that also feeds replicated work sums that
  work's gradient tp times, and a replicated leaf whose columns act on the
  rank's channels keeps only part of its gradient without one: either
  moves a leaf past the bound or apart from its replicas.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.reference import dense_forward as jax_dense_forward
from repro_torch.distributed.optimizer import AdamConfig, adam_init
from repro_torch.distributed.pipeline import build_train_step
from repro_torch.launch import ranks as rk
from repro_torch.launch.mesh import rank_layout
from repro_torch.launch.train import train_rank
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import (
    param_pspecs,
    shard_params,
    spec_axes,
    tree_items,
    tree_map,
)

from test_torch_tp_serve import cfgs, jax_params

M, MB, T = 2, 2, 16
LOSS_TOL = 2e-4
PARAM_TOL = 1e-5
# An element whose one-process gradient on some step is not zero but stays
# below ILL_V * Adam's eps (the root of the bias-corrected second moment)
# moves by lr * g / (|g| + eps) on it, a ratio of numbers at rounding level:
# the ranks' sums, rounded in another order, move it by up to ~lr * (its
# relative rounding).  Such an element may miss PARAM_TOL (at most
# ILL_SHARE of a leaf does), and is then held to the 2 steps' Adam bound,
# 2 lr each; every other element to PARAM_TOL.
ILL_V = 10
ILL_SHARE = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (M, MB, T)).astype(np.int32)
            for k in ("tokens", "labels")}


def jax_dense_loss(jcfg, jparams, b, ew: int) -> float:
    logits = np.asarray(jax.jit(jax_dense_forward, static_argnums=(0, 4))(
        jcfg, jparams, jnp.asarray(b["tokens"].reshape(M * MB, T)), None,
        ew), np.float32)
    lse = np.asarray(jax.nn.logsumexp(jnp.asarray(logits), axis=-1))
    gold = np.take_along_axis(
        logits, b["labels"].reshape(M * MB, T)[..., None], axis=-1)[..., 0]
    return float(np.mean(lse - gold))


def replicas_agree(out, cfg, lay):
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


def train_twin(arch: str, tp: int, tmp_path, pp: int = 1, dp: int = 1,
               aux_coef: float = 0.01):
    jcfg, cfg = cfgs(arch, pp, tp)
    ew = T // 2 if cfg.is_encoder_decoder else 0
    jparams, tree = jax_params(jcfg, tmp_path / "w.npz")
    b = batch(cfg)
    want = jax_dense_loss(jcfg, jparams, b, ew)
    lay = rank_layout(dp, pp, tp)
    npz = str(tmp_path / "w.npz")
    jobs = [(train_rank, dict(cfg=cfg, steps=1, batches=[b], lr=0.0,
                              aux_coef=0.0, enc_width=ew, device="cpu",
                              dtype="float32", npz=npz, keep=1)),
            (train_rank, dict(cfg=cfg, steps=2, batches=[b] * 2, lr=1e-3,
                              aux_coef=aux_coef, enc_width=ew, device="cpu",
                              dtype="float32", npz=npz, keep=2))]
    runs = rk.spawn(rk.run_each, lay, (jobs,),
                    store_dir=str(tmp_path / "store"), threads=1,
                    timeout_s=240, group_timeout_s=60)
    lr0, two = [r[0] for r in runs], [r[1] for r in runs]
    assert len({o["loss"][0] for o in lr0}) == 1     # every rank's loss
    assert abs(lr0[0]["loss"][0] - want) < LOSS_TOL, (lr0[0]["loss"], want)
    one = cfg.with_plan(tp=1)
    full = params_from_numpy(one, tree)
    for o in lr0:                                    # lr 0 moved nothing
        mine = dict(tree_items(shard_params(cfg, full, lay, o["rank"])))
        for k, v in o["params"].items():
            np.testing.assert_array_equal(v, mine[k].numpy(), err_msg=k)
    replicas_agree(two, cfg, lay)
    p = full.trainable()
    opt = adam_init(p)
    step = build_train_step(one, adam=AdamConfig(lr=1e-3), enc_width=ew,
                            aux_coef=aux_coef, device="cpu")
    adam = AdamConfig(lr=1e-3)
    rms = []                    # each step's sqrt(bias-corrected v)
    for i in range(2):
        p, opt, m = step(p, opt, b)
        c = 1.0 - adam.b2 ** (i + 1)
        rms.append(tree_map(lambda t: torch.sqrt(t / c), opt.v))
    assert all(o["loss"] == two[0]["loss"] for o in two)
    assert abs(float(m["loss"]) - two[0]["loss"][1]) < 1e-5
    for o in two:
        mine = dict(tree_items(shard_params(cfg, p, lay, o["rank"])))
        steps = [dict(tree_items(shard_params(cfg, r, lay, o["rank"])))
                 for r in rms]
        for k, v in o["params"].items():
            want = mine[k].detach().numpy()
            # where a step's gradient sits at eps's level, Adam's step is
            # a ratio of rounding-level numbers: such an element may miss
            # PARAM_TOL, and is then held to Adam's own bound
            ill = np.zeros(v.shape, bool)
            for r in steps:
                r = r[k].numpy()
                ill |= (r > 0) & (r < ILL_V * adam.eps)
            off = np.abs(v - want) > PARAM_TOL
            assert not np.any(off & ~ill), (k, np.abs(v - want).max())
            assert off.mean() <= ILL_SHARE, (k, int(off.sum()))
            assert np.all(np.abs(v - want) <= 4 * adam.lr), k


@pytest.mark.parametrize("arch,tp,dp", [
    ("olmoe-1b-7b", 4, 1),
    ("kimi-k2-1t-a32b", 2, 1),
    ("minicpm3-4b", 2, 1),
    ("minicpm3-4b", 2, 2),
])
def test_trained_across_tensor_ranks_matches_jax_and_one_process(
        arch, tp, dp, tmp_path):
    train_twin(arch, tp, tmp_path, dp=dp)
