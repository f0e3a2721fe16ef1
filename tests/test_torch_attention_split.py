"""The split arithmetic of the port's paged attention: the plain versions of
one split's flash partials (`paged_flash_attention_partials_ref`) and of
their merge (`merge_partials_ref`, `finalize_partials_ref`), held against
the JAX package's `flash_attention_blocks` + `merge_flash_partials` (under
`jax.vmap` with an axis name) + `finalize_flash` on the same numpy inputs.

The kernel splits a row's table pages across blocks and merges their
partials the same way; its splits are checked against the plain version on
the card (tests/test_torch_kernel_gpu.py).  Here: one split, two, uneven
ones, splits that hold no key of some rows (past ctx, past the causal
horizon, or empty), a ctx == 0 row, and G = 1, 5 and 8.

Tolerance: 2e-5, JAX's f32 partials against the port's plain partials
(computed in f64), relative for the unnormalised o and l, which grow with
the number of keys.  A (split, row) pair that attends no key is exact:
o = 0, m = -1e30, l = 0 in the port.  JAX's online softmax gives such a
row m = -1e30 but counts its masked keys into l and o (p = exp(0) while m
is -1e30), which the merge then scales by 0, so those pairs are compared
by their m alone.  Rows with ctx == 0 differ
by design (the port writes zeros, JAX the mean of V) and are compared with
zeros.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import (finalize_flash, flash_attention_blocks,
                                    merge_flash_partials)
from repro_torch.kernels import paged_attention as pa

TOL = 2e-5

# S, TQ, H, KH, D, page, B
SHAPES = {
    "G1": (3, 4, 4, 4, 16, 8, 8),
    "G5": (3, 3, 10, 2, 16, 4, 12),
    "G8": (2, 5, 8, 1, 32, 8, 6),
}

# table-page boundaries of the splits, as fractions of B: [0, ..., 1]
SPLITS = {
    "one": (0.0, 1.0),
    "two": (0.0, 0.5, 1.0),
    "uneven": (0.0, 0.125, 0.75, 1.0),
    "with_empty": (0.0, 0.25, 0.25, 0.5, 1.0),
}


def _case(S, TQ, H, KH, D, page, B, seed):
    """Contexts of one page, about half the table, and the whole table;
    the last sequence has ctx == 0.  q positions are the last TQ positions
    of each context, so short contexts leave the later splits empty and the
    causal horizon cuts rows inside a split."""
    rng = np.random.default_rng(seed)
    P = S * B + 1
    q = rng.normal(size=(S, TQ, H, D)).astype(np.float32)
    kv = rng.normal(size=(P, page, 2, KH, D)).astype(np.float32)
    tables = rng.permutation(P)[: S * B].reshape(S, B).astype(np.int32)
    ctx = np.array([B * page, max(TQ, B * page // 2 + 3), page, TQ][:S],
                   np.int32)
    ctx[-1] = 0
    qpos = (np.maximum(ctx, TQ)[:, None] - TQ
            + np.arange(TQ)[None, :]).astype(np.int32)
    return q, kv, tables, ctx, qpos


def _bounds(fracs, B):
    return [int(round(f * B)) for f in fracs]


def _jax_splits(arrs, bounds):
    """JAX's partials of each split (vmapped over the splits, one page per
    flash block, pages past a split's end masked) and their merge."""
    q, kv, tables, ctx, qpos = (jnp.asarray(a) for a in arrs)
    page = kv.shape[1]
    B = tables.shape[1]
    lo = jnp.asarray(bounds[:-1], jnp.int32)
    hi = jnp.asarray(bounds[1:], jnp.int32)
    n_blocks = max(1, max(b - a for a, b in zip(bounds[:-1], bounds[1:])))

    def split(lo_i, hi_i):
        def kv_blk(i):
            b = lo_i + i
            pages = jnp.take(tables, jnp.minimum(b, B - 1), axis=1)   # [S]
            blk = kv[pages]                          # [S, page, 2, KH, D]
            kpos = b * page + jnp.arange(page)
            mask = ((kpos[None, None, :] < ctx[:, None, None])
                    & (kpos[None, None, :] <= qpos[:, :, None])
                    & (b < hi_i))
            return blk[:, :, 0], blk[:, :, 1], mask
        return flash_attention_blocks(q, kv_blk, n_blocks)

    o, m, l = jax.vmap(split)(lo, hi)
    merged = jax.vmap(lambda o_, m_, l_: merge_flash_partials(o_, m_, l_, "sp"),
                      axis_name="sp")(o, m, l)
    out = finalize_flash(merged[0][0], merged[2][0], jnp.float32)
    return (np.asarray(o), np.asarray(m), np.asarray(l)), np.asarray(out)


def _attends(arrs, lo, hi):
    """[S, TQ] bool: the row attends some key of table pages [lo, hi)."""
    _, kv, _, ctx, qpos = arrs
    page = kv.shape[1]
    kend = np.minimum(ctx[:, None], qpos + 1)
    return (kend > lo * page) & (hi > lo)


@pytest.mark.parametrize("split", list(SPLITS))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_partials_and_merge_match_jax(shape, split):
    S, TQ, H, KH, D, page, B = SHAPES[shape]
    arrs = _case(*SHAPES[shape], seed=B + H)
    bounds = _bounds(SPLITS[split], B)
    targs = [torch.from_numpy(a) for a in arrs]
    parts = [pa.paged_flash_attention_partials_ref(*targs, lo, hi)
             for lo, hi in zip(bounds[:-1], bounds[1:])]
    (jo, jm, jl), jout = _jax_splits(arrs, bounds)
    for i, ((o, m, l), lo, hi) in enumerate(zip(parts, bounds[:-1],
                                                 bounds[1:])):
        hit = _attends(arrs, lo, hi)                     # [S, TQ]
        o, m, l = o.numpy(), m.numpy(), l.numpy()
        np.testing.assert_allclose(m[hit], jm[i][hit], atol=TOL)
        np.testing.assert_allclose(l[hit], jl[i][hit], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(o[hit], jo[i][hit], rtol=TOL, atol=TOL)
        miss = ~hit
        assert np.all(o[miss] == 0) and np.all(l[miss] == 0)
        assert np.all(m[miss] == pa.NEG_INF) and np.all(jm[i][miss] == pa.NEG_INF)
    o, m, l = pa.merge_partials_ref(parts)
    out = pa.finalize_partials_ref(o, l, torch.float32).numpy()
    live = arrs[3] > 0
    np.testing.assert_allclose(out[live], jout[live], atol=TOL)
    plain = pa.paged_flash_attention_ref(*targs).numpy()
    np.testing.assert_allclose(out[live], plain[live], atol=TOL)
    assert np.all(out[~live] == 0)


@pytest.mark.parametrize("seed", range(6))
def test_any_split_of_the_pages_merges_to_the_plain_version(seed):
    """Random boundaries, empty splits allowed, at G = 1, 5 and 8 in turn:
    the merge of the partials is the plain version on every ctx > 0 row,
    and zeros on the ctx == 0 row."""
    shape = list(SHAPES.values())[seed % len(SHAPES)]
    B = shape[-1]
    rng = np.random.default_rng(100 + seed)
    cuts = np.sort(rng.integers(0, B + 1, size=int(rng.integers(1, 5))))
    bounds = [0, *map(int, cuts), B]
    arrs = _case(*shape, seed=seed)
    targs = [torch.from_numpy(a) for a in arrs]
    parts = [pa.paged_flash_attention_partials_ref(*targs, lo, hi)
             for lo, hi in zip(bounds[:-1], bounds[1:])]
    o, m, l = pa.merge_partials_ref(parts)
    out = pa.finalize_partials_ref(o, l, torch.float32).numpy()
    live = arrs[3] > 0
    plain = pa.paged_flash_attention_ref(*targs).numpy()
    np.testing.assert_allclose(out[live], plain[live], atol=TOL)
    assert np.all(out[~live] == 0)


def test_split_past_the_context_contributes_nothing():
    """A split that lies wholly past a row's context (or its causal
    horizon) gives that row exact zeros and m = -1e30, and merging it in
    changes nothing."""
    arrs = _case(*SHAPES["G5"], seed=3)
    B = SHAPES["G5"][-1]
    targs = [torch.from_numpy(a) for a in arrs]
    head = pa.paged_flash_attention_partials_ref(*targs, 0, 1)
    tail = pa.paged_flash_attention_partials_ref(*targs, 1, B)
    short = arrs[3] <= SHAPES["G5"][5]               # ctx within page 0
    assert np.all(tail[0].numpy()[short] == 0)
    assert np.all(tail[1].numpy()[short] == pa.NEG_INF)
    assert np.all(tail[2].numpy()[short] == 0)
    o1, _, l1 = pa.merge_partials_ref([head])
    o2, _, l2 = pa.merge_partials_ref([head, tail])
    torch.testing.assert_close(o2[torch.from_numpy(short)],
                               o1[torch.from_numpy(short)], rtol=0, atol=0)
    torch.testing.assert_close(l2[torch.from_numpy(short)],
                               l1[torch.from_numpy(short)], rtol=0, atol=0)
