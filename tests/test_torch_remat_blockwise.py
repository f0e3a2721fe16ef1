"""The ``dots`` remat policy and the blockwise attention over full
sequences, on the CPU, against the port's own ``full`` / dense forms and
the JAX package.

* ``remat="dots"`` (`transformer.stage_forward_train`, through
  `build_train_step(remat=)`): one train step of the reduced qwen1.5-0.5b
  and olmoe-1b-7b gives the ``"full"`` step's loss, aux, gnorm and Adam
  moments, and JAX's step with ``REPRO_REMAT_POLICY=dots`` (set for the
  JAX side only, through ``monkeypatch``), within tests/test_torch_train.py's
  tolerance (1e-5 relative for the metrics, 1e-5 of a leaf's largest
  magnitude for the moments).  The policy does what it says: the backward
  recomputes no weight GEMM (``mm``) under ``"dots"``, and every one under
  ``"full"``; an unknown policy raises.
* `attention.causal_attention` and `attention.cross_attention` (an online
  softmax over KV blocks of 512) equal the dense softmax (an oracle
  written here) and JAX's ``causal_attention`` / ``cross_attention``,
  ragged last blocks included (JAX, which asserts that the block divides
  the sequence, runs those at one block of the whole sequence), f32,
  within 2e-5 of the output's largest magnitude; GQA and MLA's wider
  value head included; their gradients equal the dense form's within 2e-5
  of each gradient's largest magnitude.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.models import attention as jattn
from repro_torch.distributed.optimizer import AdamConfig, adam_init
from repro_torch.distributed.pipeline import build_train_step
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import tree_items
from repro_torch.roofline.op_cost import OpCounter
from test_torch_train import _batch, _cfgs, _check, _jax_step

ATTN_TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------------
# remat="dots"
# ----------------------------------------------------------------------------

def _port_step(tc, host, batch, remat):
    step = build_train_step(tc, adam=AdamConfig(lr=3e-4), device="cpu",
                            remat=remat)
    params = params_from_numpy(tc, host, dtype=torch.float32).trainable()
    _, opt, m = step(params, adam_init(params), batch)
    return ({k: float(v) for k, v in m.items()},
            dict(tree_items(opt.m)), dict(tree_items(opt.v)))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "olmoe-1b-7b"])
def test_dots_step_matches_full_and_jax_dots(arch, monkeypatch):
    jc, tc = _cfgs(arch)
    batch = _batch(jc)
    monkeypatch.setenv("REPRO_REMAT_POLICY", "dots")
    host, *want = _jax_step(jc, batch)
    monkeypatch.delenv("REPRO_REMAT_POLICY")
    dots = _port_step(tc, host, batch, "dots")
    full = _port_step(tc, host, batch, "full")
    _check(dots, tuple(want))
    metrics, m, v = full
    _check(dots, (metrics, {k: t.numpy() for k, t in m.items()},
                  {k: t.numpy() for k, t in v.items()}))


def _mm_calls(tc, x, remat):
    """(mm calls in forward, in backward) of one stage's layers."""
    stage = {g: {k: v[0].detach().requires_grad_(True)
                 for k, v in leaves.items()}
             for g, leaves in tfm.init_params(tc, 0, dtype=torch.float32)
             ["stages"].items()}
    with OpCounter() as fwd:
        y, _ = tfm.stage_forward_train(tc, stage, x, remat=remat)
    with OpCounter() as bwd:
        y.sum().backward()
    return fwd.by_op["mm"][0], bwd.by_op["mm"][0]


def test_dots_recomputes_no_weight_gemm():
    _, tc = _cfgs("qwen1.5-0.5b")
    x = torch.randn(2, 8, tc.d_model, requires_grad=True)
    f_full, b_full = _mm_calls(tc, x, "full")
    f_dots, b_dots = _mm_calls(tc, x, "dots")
    assert tc.layers_per_stage == 1 and f_full == f_dots == 7
    # dots: only the two gradient products of each weight GEMM; full also
    # recomputes each but the layer's last (the down projection, whose
    # output no backward reads: the checkpoint's recompute stops early)
    assert b_dots == 2 * f_dots
    assert b_full - b_dots == f_full - 1
    with pytest.raises(ValueError, match="remat"):
        tfm.stage_forward_train(tc, {}, x, remat="none")


# ----------------------------------------------------------------------------
# Blockwise attention
# ----------------------------------------------------------------------------

def _dense(q, k, v, causal):
    """Softmax attention, whole: q [B, Tq, H, D], k/v [B, Tk, KH, .]."""
    B, Tq, H, D = q.shape
    KH = k.shape[2]
    qg = q.double().reshape(B, Tq, KH, H // KH, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.double()) * D ** -0.5
    if causal:
        mask = torch.ones(Tq, k.shape[1], dtype=torch.bool).tril()
        s = s.masked_fill(~mask, -1e30)
    o = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, -1), v.double())
    return o.reshape(B, Tq, H, v.shape[-1]).float()


# B, Tq, Tk, H, KH, D, Dv, causal
CASES = {"causal_two_blocks": (2, 1024, 1024, 4, 2, 16, 16, True),
         "causal_ragged": (1, 1100, 1100, 4, 4, 16, 16, True),
         "causal_mla_dv": (1, 600, 600, 2, 2, 24, 16, True),
         "encoder_1500": (1, 1500, 1500, 6, 6, 8, 8, False),
         "cross_decode": (3, 5, 1500, 4, 2, 16, 16, False)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_blockwise_matches_dense_and_jax(case):
    B, Tq, Tk, H, KH, D, Dv, causal = CASES[case]
    rng = np.random.default_rng(len(case))
    q = rng.normal(size=(B, Tq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Tk, KH, D)).astype(np.float32)
    v = rng.normal(size=(B, Tk, KH, Dv)).astype(np.float32)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    if Tq == Tk:
        got = attn.causal_attention(qt, kt, vt, causal=causal)
    else:
        got = attn.cross_attention(qt, kt, vt)
    want = _dense(qt, kt, vt, causal)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=ATTN_TOL * scale)
    # JAX at a block that divides the sequence (the whole of it when 512
    # does not), which the blocks do not change but for rounding
    bk = 512 if Tk % 512 == 0 else Tk
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    if Tq == Tk:
        jout = jattn.causal_attention(jq, jk, jv, block_k=bk, causal=causal)
    else:
        jout = jattn.cross_attention(jq, jk, jv, block_k=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(jout), rtol=0,
                               atol=ATTN_TOL * scale)


@pytest.mark.parametrize("case", ["causal_ragged", "causal_mla_dv",
                                  "cross_decode"])
def test_blockwise_gradients_match_dense(case):
    """The gradients of q, k and v through the blockwise form (the running
    max taken without gradient, causal blocks skipped for the rows before
    them) equal the dense softmax's, f32, within 2e-5 of each gradient's
    largest magnitude."""
    B, Tq, Tk, H, KH, D, Dv, causal = CASES[case]
    g = torch.Generator().manual_seed(len(case))
    leaves = [torch.randn(s, generator=g, dtype=torch.float64).float()
              .requires_grad_(True) for s in ((B, Tq, H, D), (B, Tk, KH, D),
                                              (B, Tk, KH, Dv))]
    dout = torch.randn(B, Tq, H, Dv, generator=g)
    if Tq == Tk:
        got = attn.causal_attention(*leaves, causal=causal)
    else:
        got = attn.cross_attention(*leaves)
    got_g = torch.autograd.grad(got, leaves, dout)
    want_g = torch.autograd.grad(_dense(*leaves, causal), leaves, dout)
    for a, w in zip(got_g, want_g):
        torch.testing.assert_close(a, w, rtol=0,
                                   atol=ATTN_TOL * float(w.abs().max()))


def test_blockwise_holds_a_few_blocks_of_scores():
    """At T = 4096 the forward's temporaries peak at a few [B, T, H, 512]
    f32 blocks of scores (the scores, their exponentials and the mask of
    one block), not at the [B, H, T, T] whole of them (8 blocks, which the
    dense form held twice over: scores and softmax)."""
    T = 4096
    q = torch.randn(1, T, 1, 8)
    kv = torch.randn(1, T, 1, 8)
    with OpCounter() as c:
        attn.causal_attention(q, kv, kv)
    block = T * 512 * 4
    assert c.peak <= 4 * block <= (T * T * 4) // 2
