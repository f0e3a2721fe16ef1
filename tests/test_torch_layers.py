"""repro_torch layers against their JAX twins (repro.models.*), on the CPU.

The same numpy inputs, drawn from a fixed seed, go through both; f32
throughout, atol = rtol = 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import make_reduced as jax_make_reduced
from repro.models import layers as jl
from repro.models import transformer as jtfm
from repro_torch.configs import get_config, make_reduced
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttfm
from repro_torch.models.convert import params_from_numpy

TOL = dict(atol=1e-5, rtol=1e-5)


def _close(t: torch.Tensor, j) -> None:
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 128)])
def test_rmsnorm(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape[-1:]).astype(np.float32)
    _close(tl.rmsnorm(torch.from_numpy(x), torch.from_numpy(g), 1e-5),
           jl.rmsnorm(jnp.asarray(x), jnp.asarray(g), 1e-5))


@pytest.mark.parametrize("T,H,D,theta", [(7, 4, 16, 1e4), (5, 2, 64, 1e6)])
def test_apply_rope(T, H, D, theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, T, H, D)).astype(np.float32)
    pos = rng.integers(0, 3000, size=(2, T)).astype(np.int32)
    _close(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


def test_mlp_apply_swiglu():
    rng = np.random.default_rng(2)
    d, ff = 32, 48
    x = rng.normal(size=(6, d)).astype(np.float32)
    p = {k: (rng.normal(size=s) * 0.1).astype(np.float32) for k, s in
         (("w_gate", (d, ff)), ("w_up", (d, ff)), ("w_down", (ff, d)))}
    _close(tl.mlp_apply(torch.from_numpy(x),
                        {k: torch.from_numpy(v) for k, v in p.items()}, "silu"),
           jl.mlp_apply(jnp.asarray(x),
                        {k: jnp.asarray(v) for k, v in p.items()}, "silu"))


def _both_params(arch):
    jcfg = jax_make_reduced(jax_get_config(arch)).with_plan(pp=1, tp=1)
    tcfg = make_reduced(get_config(arch)).with_plan(pp=1, tp=1)
    jparams = jtfm.init_params(jcfg, jax.random.key(3), dtype=jnp.float32)
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                dtype=torch.float32)
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen2.5-14b"])
def test_embed_and_head_apply(arch):
    jcfg, tcfg, jparams, tparams = _both_params(arch)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 9)).astype(np.int32)
    h_j = jtfm.embed_apply(jcfg, jparams, jnp.asarray(toks))
    h_t = ttfm.embed_apply(tcfg, tparams, torch.from_numpy(toks).long())
    _close(h_t, h_j)
    hid = rng.normal(size=(2, 9, jcfg.d_model)).astype(np.float32)
    _close(ttfm.head_apply(tcfg, tparams, torch.from_numpy(hid)),
           jtfm.head_apply(jcfg, jparams, jnp.asarray(hid)))
