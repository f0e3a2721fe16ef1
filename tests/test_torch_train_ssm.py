"""The RWKV and Mamba train forms of the port (`models/ssm.py`:
`wkv6_train`, `selective_scan_train`, and the mixers with ``train=True``)
on the CPU against the JAX package's train path.

Inputs are made with numpy from a seed and handed to both packages, in
f32.  (a) `rwkv_time_mix` and (b) `mamba_mixer`, forward and gradients
(of the input and every weight, for a seeded output gradient) against
`jax.grad` through the JAX functions, on both of JAX's paths: the
per-token `lax.scan` (T = 16) and the chunked form (`_wkv_chunked` at
T = 128; the blocked associative scan, chunk 256, at T = 512), at
init-like decays.  (c) At strong decays the port's WKV form is finite
and matches autograd of the sequential recurrence where JAX's
`_wkv_chunked` gradient is not finite (ROADMAP Queue 3).  And the check
of `models/ssm_check.py` that the card runs: the forms pass it at init,
strong and no decay, in f32 and with bf16 inputs, and its planted copies
fail it.

Tolerances: outputs within 1e-5 x max(|JAX|, 1); each gradient within
1e-5 of its tensor's largest magnitude (the two packages differ by f32
rounding, ~1e-7 of it); `ssm_check` states its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.models import ssm
from repro_torch.models import ssm_check as sc

OUT_TOL = 1e-5
GRAD_TOL = 1e-5
D_MODEL, HD, FF = 64, 16, 128
DI, DS, DC = 128, 16, 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: tiny tensors, several test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rwkv_params(seed):
    """numpy time-mix weights with init-like decays (w0 about -1, a small
    LoRA: -log w about e^-1, ~24 over a 64-token chunk)."""
    rng = np.random.default_rng(seed)
    d = D_MODEL
    p = {name: rng.uniform(0, 1, d) for name in (
        "mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "u")}
    for name, shape in (("w_r", (d, d)), ("w_k", (d, d)), ("w_v", (d, d)),
                        ("w_g", (d, d)), ("w_o", (d, d)),
                        ("w_lora_a", (d, 32))):
        p[name] = rng.normal(size=shape) * 0.15
    p["w_lora_b"] = rng.normal(size=(32, d)) * 0.1
    p["w0"] = rng.uniform(-1.5, -0.5, d)
    p["ln_x_g"] = 1 + 0.1 * rng.normal(size=d)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _mamba_params(seed):
    """numpy Mamba weights with a spread of step sizes (dt_bias in
    [-4, 1])."""
    rng = np.random.default_rng(seed)
    dtr = max(8, D_MODEL // 16)
    p = {"in_proj": rng.normal(size=(D_MODEL, 2 * DI)) * 0.15,
         "conv_w": rng.normal(size=(DC, DI)) * 0.4,
         "conv_b": rng.normal(size=DI) * 0.1,
         "x_proj": rng.normal(size=(DI, dtr + 2 * DS)) * 0.15,
         "dt_proj": rng.normal(size=(dtr, DI)) * 0.3,
         "dt_bias": rng.uniform(-4, 1, DI),
         "A_log": np.log(np.arange(1, DS + 1))[None, :]
         + 0.2 * rng.normal(size=(DI, DS)),
         "D": 1 + 0.1 * rng.normal(size=DI),
         "out_proj": rng.normal(size=(DI, D_MODEL)) * 0.1}
    return {k: np.asarray(v, np.float32) for k, v in p.items()}


def _twin(jax_fn, port_fn, x, p, seed):
    """Forward and gradients (of x and every weight) of both functions for
    one seeded output gradient: ((out, grads), (jax out, jax grads))."""
    g = np.random.default_rng(seed).normal(size=x.shape).astype(np.float32)

    def loss(xj, pj):
        return jnp.sum(jax_fn(xj, pj) * g)

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jout = np.asarray(jax_fn(jnp.asarray(x), jp))
    jgx, jgp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jp)
    xt = torch.tensor(x, requires_grad=True)
    pt = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    out = port_fn(xt, pt)
    (out * torch.from_numpy(g)).sum().backward()
    grads = {"x": (xt.grad, np.asarray(jgx))}
    grads.update({k: (pt[k].grad, np.asarray(jgp[k])) for k in p})
    return out.detach().numpy(), jout, grads


def _assert_twin(out, jout, grads):
    np.testing.assert_allclose(out, jout, rtol=0,
                               atol=OUT_TOL * max(np.abs(jout).max(), 1.0))
    for name, (got, want) in grads.items():
        assert got is not None, name
        tol = GRAD_TOL * max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= tol, (name, err, tol)


@pytest.mark.parametrize("T", [16, 128])
def test_wkv_train_form_matches_jax_time_mix(T):
    """`rwkv_time_mix(train=True)` against JAX's: T = 16 is JAX's
    per-token scan, T = 128 its `_wkv_chunked` (two 64-token chunks); the
    port cuts both into chunks of 64 and sub-chunks of 8."""
    p = _rwkv_params(seed=T)
    x = np.random.default_rng(T + 1).normal(
        size=(2, T, D_MODEL)).astype(np.float32)
    out, jout, grads = _twin(
        lambda xj, pj: jssm.rwkv_time_mix(xj, pj, head_dim=HD)[0],
        lambda xt, pt: ssm.rwkv_time_mix(xt, pt, head_dim=HD, train=True)[0],
        x, p, seed=T + 2)
    _assert_twin(out, jout, grads)
    assert float(np.abs(grads["w0"][1]).max()) > 0     # the decay trains


@pytest.mark.parametrize("T", [16, 512])
def test_mamba_train_form_matches_jax_mixer(T):
    """`mamba_mixer(train=True)` against JAX's: T = 16 is JAX's per-token
    scan, T = 512 its blocked associative scan (two chunks of 256); the
    port's chunks are 64 tokens."""
    p = _mamba_params(seed=T)
    x = np.random.default_rng(T + 1).normal(
        size=(2, T, D_MODEL)).astype(np.float32)
    out, jout, grads = _twin(
        lambda xj, pj: jssm.mamba_mixer(xj, pj, d_state=DS, d_conv=DC)[0],
        lambda xt, pt: ssm.mamba_mixer(xt, pt, d_state=DS, d_conv=DC,
                                       train=True)[0],
        x, p, seed=T + 2)
    _assert_twin(out, jout, grads)
    assert float(np.abs(grads["A_log"][1]).max()) > 0


def test_wkv_strong_decay_is_finite_where_jax_chunked_gradient_is_not():
    """Decays over the serve clamp's whole range (-log w up to 22,026):
    the port's form matches autograd of the sequential recurrence, while
    the gradient of JAX's `_wkv_chunked`, which multiplies k by exp(-log
    P), is not finite."""
    B, T, H, D = 1, 128, 2, 16
    inputs = sc.wkv_case(B, T, H, D, "strong", seed=7)
    res = sc.check(ssm.wkv6_train, sc.sequential_wkv6, inputs)
    assert res["out"] <= 1.0 and res["grad"] <= 1.0, res
    r, k, v, logw, u = (jnp.asarray(t.numpy()) for t in inputs)
    g = jnp.asarray(np.random.default_rng(8).normal(size=(B, T, H, D)),
                    jnp.float32)

    def loss(r, k, v, logw, u):
        o, _ = jssm._wkv_chunked(r, k, v, jnp.exp(logw), u,
                                 jnp.zeros((B, H, D, D)), 64)
        return jnp.sum(o * g)

    jgrads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(r, k, v, logw, u)
    assert not all(np.isfinite(np.asarray(t)).all() for t in jgrads)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decay", list(sc.WKV_DECAYS))
def test_train_forms_pass_the_card_check(decay, dtype):
    """`ssm_check.check` at a size the card's check uses in miniature
    (T = 200: four chunks, a partial last one): both forms within the
    bound at init, strong and no decay, f32 and bf16 inputs."""
    dt = getattr(torch, dtype)
    res = sc.check(ssm.wkv6_train, sc.sequential_wkv6,
                   sc.wkv_case(2, 200, 2, 16, decay, seed=3, dtype=dt))
    assert res["out"] <= 1.0 and res["grad"] <= 1.0, res
    res = sc.check(ssm.selective_scan_train, sc.sequential_selective_scan,
                   sc.mamba_case(2, 200, 32, 16, decay, seed=4, dtype=dt))
    assert res["out"] <= 1.0 and res["grad"] <= 1.0, res


@pytest.mark.parametrize("name", list(sc.PLANTS))
def test_planted_forms_fail_the_card_check(name):
    """Each planted copy fails the check at strong decays (the division
    overflows only there; the other two fail at every decay)."""
    if name.startswith("wkv"):
        inputs = sc.wkv_case(2, 200, 2, 16, "strong", seed=5)
        res = sc.check(sc.planted(name), sc.sequential_wkv6, inputs)
    else:
        inputs = sc.mamba_case(2, 200, 32, 16, "strong", seed=6)
        res = sc.check(sc.planted(name), sc.sequential_selective_scan,
                       inputs)
    assert res["grad"] > 1.0, res


def test_train_forms_refuse_state():
    x = torch.zeros(1, 4, D_MODEL)
    p = {k: torch.from_numpy(v) for k, v in _rwkv_params(0).items()}
    with pytest.raises(ValueError, match="zero state"):
        ssm.rwkv_time_mix(x, p, head_dim=HD, train=True,
                          chunk_lens=torch.ones(1, dtype=torch.int32))
