"""The port's train step (`repro_torch.distributed.pipeline.build_train_step`)
on the CPU against the JAX package's.

Reduced configs in f32, the JAX parameters carried across with
`params_from_numpy`, the same seeded numpy batch (some labels masked): one
step of JAX's jitted `build_train_step` on a (1, 1, 1) mesh against the
port's, for qwen1.5-0.5b, olmoe-1b-7b (MoE aux loss), minicpm3-4b (MLA),
qwen2-vl-7b (M-RoPE, with frontend ``embeds``), whisper-small
(``enc_width = T // 2``), rwkv6-3b (RWKV) and jamba-1.5-large-398b
(MAMBA_MLP, MAMBA_MOE and ATTN_MOE); at T = 16 the JAX package runs its
per-token scans, the port its chunked train forms (`models/ssm.py`).
Compared: loss, aux, gnorm and total to 1e-5 relative, and the returned
Adam moments ``m`` and ``v`` (which carry the clipped gradients)
elementwise within 1e-5 of each leaf's largest magnitude; the two
packages differ there by f32 rounding only (<= 1e-6 of it).  Updated
parameters are not compared elementwise: Adam's first step is
~lr sign(g), and where |g| sits at rounding level the sign is noise.

Beside it: the bf16 step against JAX's bf16 step (qwen1.5-0.5b and
olmoe-1b-7b; to a bf16 bound); the port at pp=2 against JAX at pp=1 on the
same logical layers (olmoe-1b-7b, rwkv6-3b); ``grad_compression="int8"``
against JAX's (which quantises every large gradient once on that mesh); a
padded layer; the loss falling over 30 steps on `SyntheticLM`.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from repro.configs import get_config as jax_get_config
from repro.configs import make_reduced as jax_make_reduced
from repro.configs.base import BlockSpec as JaxBlockSpec
from repro.distributed.optimizer import adam_init as jax_adam_init
from repro.distributed.pipeline import build_train_step as jax_build_train_step
from repro.models import transformer as jax_tfm
from repro.models.reference import dense_forward as jax_dense_forward
from repro.models.transformer import cross_entropy as jax_cross_entropy
from repro_torch.configs import BlockSpec, get_config, make_reduced, stage_config
from repro_torch.data.tokens import batches
from repro_torch.distributed.elastic import repartition_params
from repro_torch.distributed.optimizer import AdamConfig, adam_init
from repro_torch.distributed.pipeline import build_train_step
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.reference import dense_forward
from repro_torch.models.transformer import cross_entropy, init_params, tree_items

ARCHS = ("qwen1.5-0.5b", "olmoe-1b-7b", "minicpm3-4b", "qwen2-vl-7b",
         "whisper-small", "rwkv6-3b", "jamba-1.5-large-398b")
M, MBG, T = 2, 2, 16
REL = 1e-5          # loss, aux, gnorm, total
MOMENT_TOL = 1e-5   # m, v: of each leaf's largest magnitude


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: tiny tensors, several test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch: str, layers: int = 0):
    """(JAX, port) reduced f32 configs at pp=1; with `layers`, one uniform
    stage of that many layers."""
    jc = jax_make_reduced(jax_get_config(arch)).with_plan(
        pp=1, tp=1, ep_over_data=False)
    tc = make_reduced(get_config(arch)).with_plan(pp=1, tp=1,
                                                  ep_over_data=False)
    if layers:
        kind = jc.pattern[0].kind
        jc = dataclasses.replace(jc, pattern=(JaxBlockSpec(kind, layers),),
                                 num_layers=layers)
        tc = dataclasses.replace(
            tc, pattern=(BlockSpec(tc.pattern[0].kind, layers),),
            num_layers=layers)
    return (dataclasses.replace(jc, dtype="float32"),
            dataclasses.replace(tc, dtype="float32"))


def _batch(cfg, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    b = {k: rng.integers(0, cfg.vocab_size, (M, MBG, T)).astype(np.int32)
         for k in ("tokens", "labels")}
    b["labels"][1, 0, :3] = -100
    if cfg.family in ("vlm", "audio"):
        Tv = 4 if cfg.family == "vlm" else T // 2
        b["embeds"] = (rng.normal(size=(M, MBG, Tv, cfg.d_model))
                       * 0.02).astype(np.float32)
    return b


def _flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_step(jc, batch, *, grad_compression=None, lr=3e-4):
    """One jitted JAX step on a (1, 1, 1) mesh from init_params(key 0) in
    `jc`'s dtype: (the initial params as numpy, metrics, m, v)."""
    from repro.distributed.optimizer import AdamConfig as JaxAdamConfig

    mesh = jax.make_mesh((1, 1, 1), ("data", "stage", "tensor"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)
    ew = T // 2 if jc.is_encoder_decoder else 0
    with jax.set_mesh(mesh):
        step = jax.jit(jax_build_train_step(
            jc, mesh, adam=JaxAdamConfig(lr=lr), enc_width=ew,
            grad_compression=grad_compression))
        params = jax_tfm.init_params(jc, jax.random.key(0),
                                     dtype=getattr(jnp, jc.dtype))
        host = jax.tree.map(np.asarray, params)
        params = jax.tree.map(
            lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
            params, jax_tfm.param_pspecs(jc),
            is_leaf=lambda x: isinstance(x, P))
        _, opt, m = step(params, jax_adam_init(params),
                         {k: jnp.asarray(v) for k, v in batch.items()})
        return (host, {k: float(v) for k, v in m.items()}, _flat(opt.m),
                _flat(opt.v))


def _port_step(tc, params, batch, *, grad_compression=None, lr=3e-4):
    ew = T // 2 if tc.is_encoder_decoder else 0
    step = build_train_step(tc, adam=AdamConfig(lr=lr), enc_width=ew,
                            grad_compression=grad_compression, device="cpu")
    params = params.trainable()
    _, opt, m = step(params, adam_init(params), batch)
    assert int(opt.step) == 1
    return ({k: float(v) for k, v in m.items()},
            dict(tree_items(opt.m)), dict(tree_items(opt.v)))


def _check(got, want, stages: int = 0, rel=REL, moment_tol=(MOMENT_TOL,) * 2):
    """Metrics to `rel`, moments m and v to `moment_tol`; `stages` > 0
    folds the port's stacked [S, R, ...] moments to JAX's [1, S * R, ...]."""
    gm, g_m, g_v = got
    wm, w_m, w_v = want
    for k in ("loss", "aux", "gnorm", "total"):
        assert abs(gm[k] - wm[k]) <= rel * max(abs(wm[k]), 1e-6), \
            (k, gm[k], wm[k])
    for got_tree, want_tree, mtol in zip((g_m, g_v), (w_m, w_v), moment_tol):
        assert set(got_tree) == set(want_tree)
        for path, t in got_tree.items():
            a = t.numpy()
            w = want_tree[path]
            if stages and path.startswith("stages/"):
                a = a.reshape(w.shape)
            assert a.shape == w.shape, path
            tol = mtol * max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(a - w).max()) <= tol, path


@pytest.fixture(scope="module", params=ARCHS)
def twin(request):
    arch = request.param
    jc, tc = _cfgs(arch)
    batch = _batch(jc)
    host, *want = _jax_step(jc, batch)
    return dict(arch=arch, jc=jc, tc=tc, batch=batch, host=host,
                want=tuple(want))


def test_train_step_matches_jax(twin):
    """loss, aux, gnorm, total and the Adam moments after one step equal
    the JAX step's; the MoE arch has a nonzero aux."""
    got = _port_step(twin["tc"], params_from_numpy(twin["tc"], twin["host"]),
                     twin["batch"])
    _check(got, twin["want"])
    assert (got[0]["aux"] > 0) == twin["tc"].is_moe
    assert np.isfinite(got[0]["loss"]) and got[0]["gnorm"] > 0


def test_lr0_loss_is_the_dense_cross_entropy(twin):
    """At lr=0 and aux_coef=0 the step's loss is the dense reference's
    cross-entropy over every position (labels < 0 masked; whisper's
    encoder half included), JAX's and the port's alike, and the
    parameters stay as they were; `cross_entropy` matches JAX's.  The
    batch has no frontend rows, which replace token embeddings in the
    step only."""
    tc = twin["tc"]
    batch = {k: v for k, v in twin["batch"].items() if k != "embeds"}
    ew = T // 2 if tc.is_encoder_decoder else 0
    params = params_from_numpy(tc, twin["host"])
    toks = torch.as_tensor(batch["tokens"]).reshape(M * MBG, T).long()
    labs = torch.as_tensor(batch["labels"]).reshape(M * MBG, T).long()
    logits = dense_forward(tc, params, toks, enc_width=ew)
    mask = (labs >= 0).float()
    want = float(cross_entropy(logits, torch.clamp(labs, min=0), mask))
    jax_logits = jax_dense_forward(twin["jc"], twin["host"],
                                   jnp.asarray(toks.numpy()), enc_width=ew)
    jax_ce = float(jax_cross_entropy(jax_logits, jnp.asarray(
        np.maximum(labs.numpy(), 0)), jnp.asarray(mask.numpy())))
    assert abs(want - jax_ce) <= REL * want
    step = build_train_step(tc, adam=AdamConfig(lr=0.0), aux_coef=0.0,
                            enc_width=ew, device="cpu")
    p = params.trainable()
    before = {k: t.detach().clone() for k, t in tree_items(p)}
    _, _, m = step(p, adam_init(p), batch)
    assert abs(float(m["loss"]) - want) <= REL * want
    for k, t in tree_items(p):
        assert torch.equal(t.detach(), before[k]), k


def _two_layers(arch: str, seed: int) -> dict:
    """`arch` with two layers of its first kind in one stage: JAX's step
    at pp=1."""
    jc, tc = _cfgs(arch, layers=2)
    batch = _batch(jc, seed=seed)
    host, *want = _jax_step(jc, batch)
    return dict(jc=jc, tc=tc, batch=batch, host=host, want=tuple(want))


@pytest.fixture(scope="module")
def olmoe_two_layers():
    """olmoe with two ATTN_MOE layers in one stage: JAX's step at pp=1."""
    return _two_layers("olmoe-1b-7b", seed=1)


# bf16 against JAX's bf16 step.  Each side's gradients carry the bf16
# roundings (2**-8 each) of the activations and of their gradients on the
# way through the layers and the head, ~8 in sequence at these depths, in
# different places on the two sides: ~sqrt(2 * 8) * 2**-8 = 2**-6 of a
# leaf apart, bounded at twice that; v, quadratic in the gradient, at twice
# m's.  The loss, aux and gnorm, f32 reductions of them, within one bf16
# rounding.  (JAX's own bf16 step is as far from its f32 step on the same
# weights: m 1e-2, v 2e-2 of a leaf.)
BF16_REL = 2 ** -8
BF16_MOMENT_TOL = (2 ** -5, 2 ** -4)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "olmoe-1b-7b"])
def test_bf16_train_step_matches_jax(arch):
    """The bf16 step (bf16 weights and gradients, f32 moments, no master
    weights) against JAX's bf16 step from the same bf16 weights: loss, aux
    and gnorm to BF16_REL, m and v to BF16_MOMENT_TOL of each leaf's
    largest magnitude; the weights updated in place are JAX's update of
    those moments, cast to bf16.  (The updated weights themselves are not
    compared with JAX's: Adam's first step is ~lr sign(g), and the sign of
    a gradient at bf16 noise level differs.)"""
    import ml_dtypes

    jc, tc = (dataclasses.replace(c, dtype="bfloat16") for c in _cfgs(arch))
    batch = _batch(jc, seed=5)
    host, *want = _jax_step(jc, batch)
    params = params_from_numpy(tc, host).trainable()
    before = {k: t.detach().float().numpy() for k, t in tree_items(params)}
    lr = 3e-4
    step = build_train_step(tc, adam=AdamConfig(lr=lr), device="cpu")
    _, opt, m = step(params, adam_init(params), batch)
    got = ({k: float(v) for k, v in m.items()}, dict(tree_items(opt.m)),
           dict(tree_items(opt.v)))
    _check(got, tuple(want), rel=BF16_REL, moment_tol=BF16_MOMENT_TOL)
    # the update in place: JAX's arithmetic on the port's moments (f32,
    # step 1), cast to bf16, bit for bit
    cfg = AdamConfig()
    b1c, b2c = np.float32(1) - np.float32(cfg.b1), \
        np.float32(1) - np.float32(cfg.b2)
    for k, t in tree_items(params):
        assert t.dtype == torch.bfloat16, k
        mk, vk = got[1][k].numpy(), got[2][k].numpy()
        u = (mk / b1c) / (np.sqrt(vk / b2c) + np.float32(cfg.eps))
        want_p = (before[k] - np.float32(lr) * u).astype(ml_dtypes.bfloat16)
        assert np.array_equal(t.detach().float().numpy(),
                              want_p.astype(np.float32)), k


def test_pp2_matches_jax_pp1(olmoe_two_layers):
    """The port at pp=2 (one layer a stage, the GPipe ticks of two
    micro-batches; the aux summed over both stages) on the same logical
    layers as JAX's pp=1 step."""
    _check_pp2(olmoe_two_layers)


def test_rwkv_pp2_matches_jax_pp1():
    """The same for two RWKV layers: the train forms in two stages."""
    _check_pp2(_two_layers("rwkv6-3b", seed=4))


def _check_pp2(run: dict) -> None:
    tc2 = stage_config(run["tc"], 2)
    assert tc2.plan.pp == 2 and tc2.layers_per_stage == 1
    params = repartition_params(params_from_numpy(run["tc"], run["host"]),
                                run["tc"], tc2)
    got = _port_step(tc2, params, run["batch"])
    _check(got, run["want"], stages=2)
    one = _port_step(run["tc"], params_from_numpy(run["tc"], run["host"]),
                     run["batch"])
    _check(one, run["want"])


def test_int8_grad_compression_matches_jax():
    """On JAX's (1, 1, 1) mesh "int8" quantises every gradient of 4,096
    elements or more once; the port's does the same, and the moments move
    off the uncompressed run's."""
    jc, tc = _cfgs("qwen1.5-0.5b")
    batch = _batch(jc, seed=2)
    host, *want = _jax_step(jc, batch, grad_compression="int8")
    params = params_from_numpy(tc, host)
    got = _port_step(tc, params, batch, grad_compression="int8")
    _check(got, tuple(want))
    plain = _port_step(tc, params, batch)
    emb = "embed/tok"
    assert not torch.equal(got[1][emb], plain[1][emb])


def test_padded_layer_is_identity_with_zero_gradient():
    """pp=2 x 2 stacked layers with num_layers=3: the last stage's second
    layer is padding; the step equals pp=1 over the three real layers,
    and the padded layer's moments stay zero."""
    _, tc3 = _cfgs("olmoe-1b-7b", layers=3)
    tc4 = dataclasses.replace(tc3, pattern=(BlockSpec(
        tc3.pattern[0].kind, 2),), plan=dataclasses.replace(tc3.plan, pp=2))
    assert tc4.padded_layers == 4 and tc4.num_layers == 3
    p4 = init_params(tc4, 0, dtype=torch.float32)
    p3 = {k: dict(v.items()) for k, v in p4.items() if k != "stages"}
    p3["stages"] = {g: {n: t.reshape((1, 4) + t.shape[2:])[:, :3]
                        for n, t in leaves.items()}
                    for g, leaves in p4["stages"].items()}
    from repro_torch.models.transformer import TransformerParams
    batch = _batch(tc3, seed=3)
    m3, mo3, _ = _port_step(tc3, TransformerParams(p3), batch)
    m4, mo4, _ = _port_step(tc4, p4, batch)
    for k in ("loss", "aux", "gnorm"):
        assert abs(m3[k] - m4[k]) <= REL * abs(m3[k]), k
    for path, t in mo4.items():
        if path.startswith("stages/"):
            assert float(t[1, 1].abs().max()) == 0.0, path
            flat = t.reshape((4,) + t.shape[2:])[:3]
            assert torch.allclose(flat, mo3[path][0], rtol=0,
                                  atol=MOMENT_TOL * float(flat.abs().max()))


def test_loss_falls_over_30_steps_on_synthetic_lm():
    _, tc = _cfgs("qwen1.5-0.5b")
    step = build_train_step(tc, adam=AdamConfig(lr=1e-3), device="cpu")
    params = init_params(tc, 0, dtype=torch.float32).trainable()
    opt = adam_init(params)
    data = batches(tc.vocab_size, 2, 1, 64, seed=0)
    losses = []
    for _ in range(30):
        params, opt, m = step(params, opt, next(data))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.2, losses


def test_step_refuses_frozen_params():
    _, tc = _cfgs("qwen1.5-0.5b")
    params = init_params(tc, 0, dtype=torch.float32)
    step = build_train_step(tc, device="cpu")
    with pytest.raises(ValueError, match="trainable"):
        step(params, adam_init(params), _batch(tc))
