"""Expert-parallel training across ranks on the CPU (gloo): the reduced
kimi-k2-1t-a32b (ATTN_MOE with its shared expert; its plan sets
``ep_over_data``) with its experts split over `data`, against the JAX
package and the port's one-process step, configured as
tests/test_torch_tp_serve.py configures it (f32, dropless), with JAX's
``init_params`` weights.  At dp=2 x pp=2 x tp=2, the layout of
``tests/test_multidevice.py::test_ep_moe_train_and_grad_compression`` (8
ranks), and at dp=2 alone.

`test_torch_tp_train.train_twin` runs both launches (`launch.ranks.run_each`
of `launch.train.train_rank`): at lr 0 and ``aux_coef`` 0 the loss within
2e-4 (JAX's bound) of JAX's dense cross-entropy on every rank, and no leaf
moved; after 2 Adam steps at lr 1e-3 (``aux_coef`` 0: the load-balancing
loss is each data replica's over its own rows, as in JAX's step, and so
not the one-process step's) each rank's leaves within 1e-5 of its
block of the one-process step's (its experts, at its ff columns), which
fails if an expert leaf's gradient were summed over `data` (the other
replica's experts are other experts).  Besides: the expert leaves' specs
name `data`, so their gradients are synced over no data axis and their
squares enter the global norm once per expert; the ranks' gradient norm is
the one-process step's within 1e-5 relative.
"""

import pytest
import torch

from repro_torch.distributed.optimizer import AdamConfig, adam_init
from repro_torch.distributed.pipeline import build_train_step, grad_sync_axes
from repro_torch.launch import ranks as rk
from repro_torch.launch.mesh import rank_layout
from repro_torch.launch.train import train_rank
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import param_pspecs, spec_axes, tree_items

from test_torch_tp_serve import cfgs, jax_params
from test_torch_tp_train import batch, train_twin

ARCH = "kimi-k2-1t-a32b"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dp,pp,tp", [(2, 2, 2), (2, 1, 1)])
def test_expert_parallel_training_matches_jax_and_one_process(
        dp, pp, tp, tmp_path):
    _, cfg = cfgs(ARCH, pp, tp)
    assert cfg.plan.ep_over_data
    train_twin(ARCH, tp, tmp_path, pp=pp, dp=dp, aux_coef=0.0)


def test_expert_gradients_are_not_summed_over_data(tmp_path):
    """The expert leaves split over `data` (so `grad_sync_axes` leaves it
    out and the norm sums their squares over it once), the others not;
    and the global gradient norm at dp=2 is the one-process step's."""
    _, cfg = cfgs(ARCH, 1, 1)
    for path, spec in tree_items(param_pspecs(cfg)):
        expert = path.rsplit("/", 1)[-1] in ("w_gate", "w_up", "w_down") \
            and "attn_moe" in path
        assert ("data" in spec_axes(spec)) == expert, path
        assert ("data" in grad_sync_axes(spec)) == (not expert), path
    _, tree = jax_params(cfgs(ARCH, 1, 1)[0], tmp_path / "w.npz")
    b = batch(cfg)
    out = rk.spawn(train_rank, rank_layout(2, 1, 1), (dict(
        cfg=cfg, steps=1, batches=[b], lr=1e-3, aux_coef=0.0, device="cpu",
        dtype="float32", npz=str(tmp_path / "w.npz")),),
        store_dir=str(tmp_path / "store"), threads=1, timeout_s=180,
        group_timeout_s=60)
    p = params_from_numpy(cfg, tree).trainable()
    step = build_train_step(cfg, adam=AdamConfig(lr=1e-3), aux_coef=0.0,
                            device="cpu")
    _, _, m = step(p, adam_init(p), b)
    for o in out:
        assert abs(o["gnorm"][0] - float(m["gnorm"])) <= \
            1e-5 * float(m["gnorm"])
        # the ep exchanges ran: forward and backward, each MoE layer
        assert o["traffic"]["bytes"]["ep"] > 0
