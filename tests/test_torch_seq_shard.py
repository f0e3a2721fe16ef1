"""Decode-only geometry and sequence-sharded decode on the CPU.

* A decode-only tick (``Sp = C = 0``, what `launch.shapes.serve_cell_dims`
  gives a decode cell) on the reduced qwen1.5-0.5b: prefill at a tick with
  a prefill phase, then greedy decode at ``Sp = C = 0`` over the same
  pools, giving JAX's greedy tokens (its dense reference, teacher-forced
  along them).
* The plain sharded attention: per shard, `ops.paged_attention` on the
  local context and positions (`attention.shard_keys`) with its
  log-sum-exp, merged (`merge_partials_ref`), against JAX's
  ``paged_attention(merge_axis="data", shard_info=(r, n))`` under
  ``jax.vmap(..., axis_name="data")`` on one CPU device, and against the
  unsharded plain attention over the interleaved pool, at f32 2e-5 (of
  the output's largest magnitude; rows with ctx == 0 excluded: the plain
  version gives them the mean of V).  Shards where some rows attend no
  key (short contexts, early q positions) are included.
* The rank tick at dp=2 with ``seq_shard`` (gloo; a ``FileStore`` under
  ``tmp_path``, one intra-op thread a rank, a 60-s group timeout and a
  launch timeout, as in tests/test_torch_ranks.py) on the reduced jamba
  (its experts split over the two replicas), the KV pools and Mamba states
  filled with seeded random values: every decode tick's logits equal the
  unsharded one-process tick's within 2e-5 of their largest magnitude.
  A prefill phase at ``seq_shard`` raises (JAX shards only decode cells).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.distributed.pipeline import (
    build_rank_serve_tick,
    build_serve_tick,
)
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch import ranks as rk
from repro_torch.launch.mesh import rank_layout
from repro_torch.models import attention as attn
from repro_torch.models import serve as serve_lib
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.serve import ServeDims
from repro_torch.models.transformer import init_params
from test_torch_tp_serve import cfgs, jax_greedy, jax_params

TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------------
# Decode-only geometry
# ----------------------------------------------------------------------------

FULL = ServeDims(Sp=1, C=16, Sd=2, pages=16, page=8, Bp=4, Bd=4, slots=2)


def _device_meta(m, dims, p_tok, d_tok):
    out = {k: torch.from_numpy(np.ascontiguousarray(v))
           for k, v in serve_lib.host_meta(m, dims).items()}
    out["p_tok"] = torch.from_numpy(p_tok)
    out["d_tok"] = torch.from_numpy(d_tok)
    return out


def test_decode_only_tick_gives_jax_greedy_tokens(tmp_path):
    jcfg, cfg = cfgs("qwen1.5-0.5b", 1, 1)
    jparams, tree = jax_params(jcfg, tmp_path / "w.npz")
    params = params_from_numpy(cfg, tree, dtype=torch.float32)
    prompt = [int(t) for t in np.random.default_rng(3).integers(
        0, cfg.vocab_size, 11)]
    L, steps = len(prompt), 6
    table = np.arange(FULL.Bd, dtype=np.int32)
    caches = serve_lib.init_caches(cfg, FULL, torch.float32)
    p_tok = np.zeros((FULL.Sp, FULL.C), np.int32)
    p_tok[0, :L] = prompt
    m = serve_lib.zero_meta(FULL)
    m["p_positions"][0, :L] = np.arange(L)
    m["p_chunk_lens"][0] = m["p_context_lens"][0] = L
    m["p_block_tables"][0] = table
    m["p_slot_pages"][0, :L] = np.arange(L) // FULL.page
    m["p_slot_offsets"][0, :L] = np.arange(L) % FULL.page
    m["p_sample"][0] = 1
    tick = build_serve_tick(cfg, FULL)
    with torch.inference_mode():
        caches, logits = tick(params, caches, _device_meta(
            m, FULL, p_tok, np.zeros(FULL.Sd, np.int32)))
    outs = [int(torch.argmax(logits[0]))]
    dec = dataclasses.replace(FULL, Sp=0, C=0)
    dtick = build_serve_tick(cfg, dec, carry_dims=FULL)
    for pos in range(L, L + steps - 1):
        m = serve_lib.zero_meta(dec)
        assert m["p_positions"].shape == (0, 0)
        m["d_positions"][0] = pos
        m["d_context_lens"][0] = pos + 1
        m["d_block_tables"][0] = table
        m["d_slot_pages"][0] = pos // dec.page
        m["d_slot_offsets"][0] = pos % dec.page
        m["d_valid"][0] = 1
        d_tok = np.array([outs[-1], 0], np.int32)
        with torch.inference_mode():
            caches, logits = dtick(params, caches, _device_meta(
                m, dec, np.zeros((FULL.Sp, FULL.C), np.int32), d_tok))
        assert logits.shape == (dec.Sd, cfg.vocab_size)
        outs.append(int(torch.argmax(logits[0])))
    assert outs == jax_greedy(jcfg, jparams, [prompt], [outs])[0]


# ----------------------------------------------------------------------------
# The plain sharded attention against JAX's merge_axis path
# ----------------------------------------------------------------------------

# S, TQ, H, KH, D, page, local table pages, shards
CASES = {"decode_gqa": (3, 1, 8, 2, 16, 8, 6, 2),
         "rows_mha": (2, 3, 4, 4, 16, 4, 8, 2),
         "four_shards": (3, 1, 4, 1, 32, 8, 4, 4)}


def _shard_case(S, TQ, H, KH, D, page, B, n, seed):
    """Per-shard pools and tables (local page b of shard r is global page
    b n + r), global contexts from one page to the whole interleaved table
    (one row with ctx == 0), q positions the last TQ of each context."""
    rng = np.random.default_rng(seed)
    P = S * B + 1
    q = rng.normal(size=(S, TQ, H, D)).astype(np.float32)
    pools = rng.normal(size=(n, P, page, 2, KH, D)).astype(np.float32)
    tables = np.stack([rng.permutation(P)[:S * B].reshape(S, B)
                       for _ in range(n)]).astype(np.int32)
    full = n * B * page
    ctx = np.array([full, full // 2 + 3, page - 2][:S], np.int32)
    ctx[-1] = 0 if S > 2 else ctx[-1]
    qpos = (np.maximum(ctx, TQ)[:, None] - TQ
            + np.arange(TQ)[None, :]).astype(np.int32)
    return q, pools, tables, ctx, qpos


def _port_sharded(q, pools, tables, ctx, qpos):
    n, page = pools.shape[0], pools.shape[2]
    qt, ct, qp = (torch.from_numpy(a) for a in (q, ctx, qpos))
    parts = []
    for r in range(n):
        lc = attn.shard_keys(ct, page, r, n).int()
        lq = (attn.shard_keys(qp + 1, page, r, n) - 1).int()
        o, lse = ops.paged_attention(qt, torch.from_numpy(pools[r]),
                                     torch.from_numpy(tables[r]), lc, lq,
                                     with_lse=True)
        parts.append((o.float(), lse, torch.ones_like(lse)))
    o, _, l = pa.merge_partials_ref(parts)
    return pa.finalize_partials_ref(o, l, torch.float32).numpy()


def _jax_sharded(q, pools, tables, ctx, qpos):
    n, B = pools.shape[0], tables.shape[-1]

    def one(pool, table, r):
        return jattn.paged_attention(
            jnp.asarray(q), pool, table, jnp.asarray(ctx), jnp.asarray(qpos),
            pages_per_block=B, merge_axis="data", shard_info=(r, n))

    out = jax.vmap(one, axis_name="data")(
        jnp.asarray(pools), jnp.asarray(tables), jnp.arange(n))
    return np.asarray(out)


def _unsharded(q, pools, tables, ctx, qpos):
    """The plain attention over the interleaved pool as one: global page
    g of a row is shard g % n's local page g // n."""
    n, P = pools.shape[:2]
    S, B = tables.shape[1:]
    pool = pools.reshape((n * P,) + pools.shape[2:])
    g = np.arange(n * B)
    table = np.stack([tables[g % n, s, g // n] + (g % n) * P
                      for s in range(S)]).astype(np.int32)
    return ops.paged_attention(*(torch.from_numpy(a) for a in (
        q, pool, table, ctx, qpos))).numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_attention_matches_jax_merge_axis(case):
    args = _shard_case(*CASES[case], seed=len(case))
    got = _port_sharded(*args)
    want = _jax_sharded(*args)
    whole = _unsharded(*args)
    live = args[3] > 0
    scale = float(np.abs(whole[live]).max())
    for r in range(want.shape[0]):          # every shard holds the merge
        np.testing.assert_allclose(got[live], want[r][live], rtol=0,
                                   atol=TOL * scale)
    np.testing.assert_allclose(got[live], whole[live], rtol=0,
                               atol=TOL * scale)


def test_shard_keys_counts_each_shards_prefix():
    page, n = 4, 3
    end = torch.arange(0, 60, dtype=torch.int32)
    for r in range(n):
        want = [sum(1 for k in range(int(e)) if (k // page) % n == r)
                for e in end]
        assert attn.shard_keys(end, page, r, n).tolist() == want


def test_plain_lse_is_the_masked_logsumexp():
    q, pools, tables, ctx, qpos = _shard_case(*CASES["rows_mha"], seed=9)
    args = [torch.from_numpy(a) for a in (q, pools[0], tables[0], ctx, qpos)]
    _, lse = pa.paged_flash_attention_ref(*args, with_lse=True)
    S, TQ, H, D = q.shape
    kv = torch.from_numpy(pools[0])[args[2]].reshape(S, -1, 2, H, D)
    s = torch.einsum("sqhd,skhd->sqhk", args[0], kv[:, :, 0]) * D ** -0.5
    kpos = torch.arange(kv.shape[1])
    mask = (kpos < args[3][:, None, None]) & (kpos <= args[4][:, :, None])
    want = torch.logsumexp(s.masked_fill(~mask[:, :, None], -1e30), -1)
    live = mask.any(-1)
    torch.testing.assert_close(lse[live], want[live], rtol=0, atol=1e-5)
    assert bool((lse[~live] == pa.NEG_INF).all())


# ----------------------------------------------------------------------------
# The rank tick at dp=2 with seq_shard against the unsharded tick
# ----------------------------------------------------------------------------

DP, PAGE, B_LOC, L0, TICKS = 2, 8, 4, 37, 4


def _jamba():
    _, cfg = cfgs("jamba-1.5-large-398b", 1, 1)
    return cfg


def _decode_meta(dims, pos, table, page_id):
    m = serve_lib.zero_meta(dims)
    m["d_positions"][0] = pos
    m["d_context_lens"][0] = pos + 1
    m["d_block_tables"][0] = table
    m["d_slot_pages"][0] = page_id
    m["d_slot_offsets"][0] = pos % dims.page
    m["d_valid"][0] = 1
    return m


def _filled_caches(cfg, dims, seed):
    """Every pool filled with seeded normal values (the Mamba states
    small), the scratch page and slot too."""
    gen = torch.Generator().manual_seed(seed)
    caches = serve_lib.init_caches(cfg, dims, torch.float32)
    for grp in caches.values():
        for name, t in grp.items():
            scale = 0.1 if name in ("conv", "ssm") else 1.0
            t.copy_(torch.randn(t.shape, generator=gen) * scale)
    return caches


def _local_pool(whole, r):
    """Shard r's pool of a KV leaf [S, R, pages + 1, ...]: local page b
    is global page b * DP + r; then its own scratch page."""
    pages = whole.shape[2] - 1
    idx = torch.arange(r, pages, DP)
    return torch.cat([whole[:, :, idx], whole[:, :, -1:]], 2).contiguous()


def _seq_rank(ranks, job):
    """This replica's shard: its params, its interleaved KV pages and the
    whole Mamba state; the decode ticks' logits as the head computes
    them."""
    from repro_torch.models import transformer as tfm

    cfg, dims = job["cfg"], job["dims"]
    r = ranks.index("data")
    params = init_params(cfg, 0, dtype=torch.float32, layout=ranks.layout,
                         rank=ranks.rank)
    local = tfm.shard_config(cfg, 1, tfm.expert_parts(cfg, DP))
    caches = serve_lib.init_caches(local, dims, torch.float32)
    for gk, grp in job["caches"].items():
        for name, t in grp.items():
            caches[gk][name].copy_(_local_pool(t, r) if name == "kv" else t)
    seen = []
    head = tfm.head_apply
    tfm.head_apply = lambda *a: seen.append(head(*a).float()) or seen[-1]
    tick = build_rank_serve_tick(cfg, dims, ranks)
    table = np.arange(B_LOC, dtype=np.int32)
    for t, tok in enumerate(job["tokens"]):
        pos = L0 + t
        g = pos // PAGE
        m = _decode_meta(dims, pos, table, g // DP if g % DP == r else -1)
        meta = _device_meta(m, dims, np.zeros((0, 0), np.int32),
                            np.array([tok], np.int32))
        with torch.inference_mode():
            caches, _ = tick(params, caches, meta, None)
    return [s.numpy() for s in seen]


def test_seq_shard_rank_tick_gives_the_unsharded_logits(tmp_path):
    cfg = _jamba()
    local_dims = ServeDims(Sp=0, C=0, Sd=1, pages=B_LOC, page=PAGE, Bp=8,
                           Bd=B_LOC, slots=1, seq_shard=True)
    whole_dims = dataclasses.replace(local_dims, pages=DP * B_LOC,
                                     Bd=DP * B_LOC, seq_shard=False)
    caches = _filled_caches(cfg, whole_dims, seed=4)
    tokens = [int(t) for t in np.random.default_rng(8).integers(
        0, cfg.vocab_size, TICKS)]
    job = dict(cfg=cfg, dims=local_dims, tokens=tokens,
               caches={gk: {k: v.clone() for k, v in grp.items()}
                       for gk, grp in caches.items()})
    out = rk.spawn(_seq_rank, rank_layout(DP, 1, 1), (job,),
                   store_dir=str(tmp_path / "store"), threads=1,
                   timeout_s=180, group_timeout_s=60)
    params = init_params(cfg, 0, dtype=torch.float32)
    tick = build_serve_tick(cfg, whole_dims)
    table = np.arange(DP * B_LOC, dtype=np.int32)
    for t, tok in enumerate(tokens):
        pos = L0 + t
        m = _decode_meta(whole_dims, pos, table, pos // PAGE)
        meta = _device_meta(m, whole_dims, np.zeros((0, 0), np.int32),
                            np.array([tok], np.int32))
        with torch.inference_mode():
            caches, logits = tick(params, caches, meta)
        want = logits.numpy()
        scale = float(np.abs(want).max())
        for rank_logits in out:
            np.testing.assert_allclose(rank_logits[t], want, rtol=0,
                                       atol=TOL * scale)


def test_prefill_rows_refuse_a_sequence_shard():
    """JAX shards only decode cells (``Sp = 0``): a prefill phase at
    ``seq_shard`` raises rather than attend a shard unmerged."""
    from repro_torch.launch.mesh import AxisGroup

    cfg = _jamba()
    with pytest.raises(ValueError, match="decode rows only"):
        serve_lib._paged_self_attention(cfg, {}, torch.zeros(1, 4, 8), None,
                                        {}, True, seq=AxisGroup("data",
                                                                (0, 1), 0))
