"""State-space / linear-recurrence mixers (``repro.models.ssm``): Mamba
(jamba) and RWKV6 (Finch).

Each entry point operates on [B, T, d] with an optional recurrent state:
the dense reference runs each row from a zero state over its whole length;
serve passes the rows' state and live lengths.  The recurrences go through
`ops.mamba_scan` and `ops.rwkv6_scan`: the Hopper kernel for CUDA tensors,
its plain version on the CPU.  Unlike the JAX package, which returns a new
scan state per row, the port keeps that state (Mamba's `ssm`, RWKV's `wkv`)
in the layer's slot pool and the scan advances it in place (`MambaState`,
`RWKVState`).

With ``train=True`` the mixers run whole sequences from a zero state
through the train forms instead, `wkv6_train` and `selective_scan_train`:
chunked plain PyTorch that autograd differentiates on either device, the
counterparts of the jnp forms the JAX package trains through
(``repro/models/ssm.py``'s blocked associative scan and `_wkv_chunked`).
They keep no state and never call the kernels, which have no backward.

At a tensor rank (``tp``, a `launch.mesh.AxisGroup`) the mixers compute
the rank's channels: Mamba's d_inner / tp channels (its block of both
halves of ``in_proj``, `transformer.PAIRED_LEAVES`), RWKV's H / tp heads
and d_ff / tp channel-mix columns, at the whole d_model.  The mixers'
outputs are then the rank's partial sums, which the caller reduces over
the group, so that a serve tick reduces both phases in one all-reduce.
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import collectives as coll
from repro_torch.kernels import ops
from repro_torch.models.layers import layernorm

GROUP_NORM_EPS = 64e-5


def _train_args(train: bool, state, chunk_lens) -> None:
    if train and (state is not None or chunk_lens is not None):
        raise ValueError("the train form runs whole rows from a zero state: "
                         "it takes no state and no chunk_lens")


# ----------------------------------------------------------------------------
# Mamba (S6, selective SSM)  [arXiv:2312.00752]
# ----------------------------------------------------------------------------

class MambaState(NamedTuple):
    """Recurrent state of B rows of one Mamba layer."""

    conv: torch.Tensor    # [B, d_conv - 1, d_inner]  last conv inputs
    ssm: torch.Tensor     # [slots, d_inner, d_state] f32 pool, in place
    slots: torch.Tensor   # [B] int32: each row's slot in `ssm`
    fresh: torch.Tensor   # [B] int32: 1 = the row's scan state starts at 0


def mamba_init_state(batch: int, d_inner: int, d_state: int, d_conv: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device: torch.device | str = "cpu") -> MambaState:
    """Zero state for `batch` rows, one pool slot each."""
    return MambaState(
        conv=torch.zeros(batch, d_conv - 1, d_inner, dtype=dtype,
                         device=device),
        ssm=torch.zeros(batch, d_inner, d_state, dtype=torch.float32,
                        device=device),
        slots=torch.arange(batch, dtype=torch.int32, device=device),
        fresh=torch.ones(batch, dtype=torch.int32, device=device))


def mamba_mixer(
    x: torch.Tensor,                    # [B, T, d]
    p: Mapping[str, torch.Tensor],
    *,
    d_state: int,
    d_conv: int,
    state: Optional[MambaState] = None,
    chunk_lens: Optional[torch.Tensor] = None,
    train: bool = False,
    tp=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out, new conv state).  Rows run their first `chunk_lens`
    tokens (all T when None) through the scan; the state's `ssm` pool is
    advanced in place at the rows' slots.  The outputs past a row's live
    tokens are not defined (the JAX masks zero them).  The new conv state
    is the last ``d_conv - 1`` live rows of ``[old state | chunk]`` (the old
    state itself for a row with no live token).  `train`: whole rows from
    a zero state through `selective_scan_train` (no state, no lengths).
    At tensor rank `tp` the channels are the rank's: x (the normed input,
    which feeds nothing else) enters them, ``x_proj``'s row-parallel
    partial sums are reduced and enter them again (dt, B and C act on the
    rank's channels), and out is the rank's partial sum."""
    B, T, _ = x.shape
    xz = coll.copy_to_tensor(x, tp) @ p["in_proj"]      # [B, T, 2*di]
    di = xz.shape[-1] // 2
    xi, z = xz[..., :di], xz[..., di:]
    _train_args(train, state, chunk_lens)
    if state is None:
        state = mamba_init_state(B, di, d_state, d_conv, x.dtype, x.device)

    # causal depthwise conv over time, four shifted multiply-adds in f32 as
    # the JAX function sums them (no conv1d: cuDNN would run f32 in TF32)
    conv_in = torch.cat([state.conv.to(xi.dtype), xi], dim=1)
    w = p["conv_w"].float()
    yc = torch.zeros((B, T, di), dtype=torch.float32, device=x.device)
    for j in range(d_conv):
        yc = yc + conv_in[:, j:j + T].float() * w[j]
    xi = F.silu(yc + p["conv_b"].float()).to(x.dtype)
    if chunk_lens is None:
        new_conv = conv_in[:, T:]
    else:
        idx = chunk_lens.long()[:, None] + torch.arange(
            d_conv - 1, device=x.device)[None, :]        # [B, dc-1]
        new_conv = torch.gather(conv_in, 1,
                                idx[..., None].expand(-1, -1, di))

    # input-dependent SSM parameters
    dtr = p["dt_proj"].shape[0]
    dbc = coll.copy_to_tensor(coll.reduce_from_tensor(
        xi @ p["x_proj"], tp), tp)                      # [B, T, dtr + 2*ds]
    Bm = dbc[..., dtr:dtr + d_state].float().contiguous()
    Cm = dbc[..., dtr + d_state:].float().contiguous()
    dt = F.softplus((dbc[..., :dtr] @ p["dt_proj"]).float()
                    + p["dt_bias"].float())              # [B, T, di]
    A = -torch.exp(p["A_log"].float())                  # [di, ds]

    if train:
        y = selective_scan_train(dt, xi, Bm, Cm, A)
    else:
        lens = chunk_lens if chunk_lens is not None else torch.full(
            (B,), T, dtype=torch.int32, device=x.device)
        y = ops.mamba_scan(dt.contiguous(), xi.contiguous(), Bm, Cm,
                           A.contiguous(), state.ssm, state.slots,
                           lens.to(torch.int32), state.fresh)     # f32
    y = y + xi.float() * p["D"].float()
    y = (y * F.silu(z.float())).to(x.dtype)
    return y @ p["out_proj"], new_conv.to(x.dtype)


# ----------------------------------------------------------------------------
# RWKV6 (Finch) — data-dependent decay linear attention  [arXiv:2404.05892]
# ----------------------------------------------------------------------------


class RWKVState(NamedTuple):
    """Recurrent state of B rows of one RWKV layer."""

    tm_x: torch.Tensor    # [B, d]  last input of the time-mix block
    cm_x: torch.Tensor    # [B, d]  last input of the channel-mix block
    wkv: torch.Tensor     # [slots, H, dk, dv] f32 pool, advanced in place
    slots: torch.Tensor   # [B] int32: each row's slot in `wkv`
    fresh: torch.Tensor   # [B] int32: 1 = the row's WKV state starts at 0


def rwkv_init_state(batch: int, d: int, heads: int, head_dim: int,
                    dtype: torch.dtype = torch.bfloat16,
                    device: torch.device | str = "cpu") -> RWKVState:
    """Zero state for `batch` rows, one pool slot each."""
    return RWKVState(
        tm_x=torch.zeros(batch, d, dtype=dtype, device=device),
        cm_x=torch.zeros(batch, d, dtype=dtype, device=device),
        wkv=torch.zeros(batch, heads, head_dim, head_dim,
                        dtype=torch.float32, device=device),
        slots=torch.arange(batch, dtype=torch.int32, device=device),
        fresh=torch.ones(batch, dtype=torch.int32, device=device))


def _token_shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """sx_t = x_{t-1} - x_t with x_{-1} = last (carried across chunks)."""
    prev = torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)
    return prev - x


def _last_valid_row(x: torch.Tensor, last: torch.Tensor,
                    chunk_lens: Optional[torch.Tensor]) -> torch.Tensor:
    """New shift-state: x[chunk_len-1] per sequence (old state if len==0)."""
    if chunk_lens is None:
        return x[:, -1, :]
    idx = torch.clamp(chunk_lens - 1, min=0).long()
    picked = x[torch.arange(x.shape[0], device=x.device), idx]
    return torch.where((chunk_lens > 0)[:, None], picked, last)


def rwkv_time_mix(
    x: torch.Tensor,                    # [B, T, d]
    p: Mapping[str, torch.Tensor],
    *,
    head_dim: int,
    state: Optional[RWKVState] = None,
    chunk_lens: Optional[torch.Tensor] = None,
    train: bool = False,
    tp=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (out, new_tm_x, wkv pool).  Rows run their first
    `chunk_lens` tokens (all T when None) through the recurrence; the
    pool is advanced in place at the rows' slots.  `train`: whole rows
    from a zero state through `wkv6_train` (no state, no lengths; no pool
    comes back).  At tensor rank `tp` the heads are the rank's (H from
    ``w_r``'s columns): the four mixed inputs and the decay LoRA's hidden
    enter them, the replicated ``w0``, ``u``, ``ln_x_g`` and the LoRA's
    output columns are sliced to them (`collectives.slice_for_tensor`),
    and out is the rank's partial sum."""
    B, T, d = x.shape
    H = p["w_r"].shape[-1] // head_dim
    dl = H * head_dim
    _train_args(train, state, chunk_lens)
    if state is None and not train:
        state = rwkv_init_state(B, d, H, head_dim, x.dtype, x.device)
    last = (torch.zeros(B, d, dtype=x.dtype, device=x.device)
            if state is None else state.tm_x)
    sx = _token_shift(x, last)

    def mixed(mu):                   # an input of the rank's columns only
        return coll.copy_to_tensor(x + sx * p[mu], tp)

    def rank_cols(name):             # a replicated leaf's rank columns
        return coll.slice_for_tensor(p[name], tp)

    xw = x + sx * p["mu_w"]
    r = (mixed("mu_r") @ p["w_r"]).reshape(B, T, H, head_dim)
    k = (mixed("mu_k") @ p["w_k"]).reshape(B, T, H, head_dim)
    v = (mixed("mu_v") @ p["w_v"]).reshape(B, T, H, head_dim)
    g = F.silu(mixed("mu_g") @ p["w_g"])
    # data-dependent decay (the Finch contribution): w = exp(-exp(w0 + lora))
    dd = coll.copy_to_tensor(torch.tanh(xw @ p["w_lora_a"]), tp) \
        @ rank_cols("w_lora_b")                               # [B, T, dl]
    logw = -torch.exp(torch.clamp(rank_cols("w0").float() + dd.float(),
                                  -20.0, 10.0))
    logw = logw.reshape(B, T, H, head_dim)
    # the bonus for the current token
    u = rank_cols("u").reshape(H, head_dim).float()

    if train:
        o = wkv6_train(r, k, v, logw, u)
    else:
        lens = chunk_lens if chunk_lens is not None else torch.full(
            (B,), T, dtype=torch.int32, device=x.device)
        o = ops.rwkv6_scan(r, k, v, torch.exp(logw), u, state.wkv,
                           state.slots, lens.to(torch.int32),
                           state.fresh)                         # f32
    # per-head group norm, in f32
    mu = torch.mean(o, dim=-1, keepdim=True)
    var = torch.mean(torch.square(o - mu), dim=-1, keepdim=True)
    o = (o - mu) * torch.rsqrt(var + GROUP_NORM_EPS)
    o = (o.reshape(B, T, dl) * rank_cols("ln_x_g").float()).to(x.dtype)
    out = (o * g.to(x.dtype)) @ p["w_o"]
    return (out, _last_valid_row(x, last, chunk_lens),
            None if train else state.wkv)


def rwkv_channel_mix_parts(
    x: torch.Tensor,                    # [B, T, d]
    p: Mapping[str, torch.Tensor],
    *,
    state: Optional[RWKVState] = None,
    chunk_lens: Optional[torch.Tensor] = None,
    tp=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The channel mix before its product: (receptance sigmoid(xr @ cm_r),
    value k @ cm_v, new_cm_x); out = receptance * value.  At tensor rank
    `tp` the receptance is replicated and the value the rank's partial sum
    over its d_ff columns (only xk enters them), which must be reduced
    before the product."""
    B, T, d = x.shape
    last = (torch.zeros(B, d, dtype=x.dtype, device=x.device)
            if state is None else state.cm_x)
    sx = _token_shift(x, last)
    xk = coll.copy_to_tensor(x + sx * p["cm_mu_k"], tp)
    xr = x + sx * p["cm_mu_r"]
    k = torch.square(torch.relu(xk @ p["cm_k"]))
    return (torch.sigmoid(xr @ p["cm_r"]), k @ p["cm_v"],
            _last_valid_row(x, last, chunk_lens))


def rwkv_channel_mix(
    x: torch.Tensor,                    # [B, T, d]
    p: Mapping[str, torch.Tensor],
    *,
    state: Optional[RWKVState] = None,
    chunk_lens: Optional[torch.Tensor] = None,
    tp=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, new_cm_x): `rwkv_channel_mix_parts`, the value reduced over
    `tp` before the product."""
    r, kv, cm_x = rwkv_channel_mix_parts(x, p, state=state,
                                         chunk_lens=chunk_lens, tp=tp)
    return r * coll.reduce_from_tensor(kv, tp), cm_x


def rwkv_block(
    x: torch.Tensor,
    p: Mapping[str, torch.Tensor],
    *,
    head_dim: int,
    norm_eps: float,
    state: Optional[RWKVState] = None,
    valid: Optional[torch.Tensor] = None,
    chunk_lens: Optional[torch.Tensor] = None,
    train: bool = False,
    tp=None,
) -> Tuple[torch.Tensor, Optional[RWKVState]]:
    """Layernorm, time-mix, layernorm, channel-mix, each with its residual.
    `valid` [B, T] (the positions before `chunk_lens`) zeroes the padding
    positions' mixer outputs, as the JAX masks do.  `train`: the time-mix's
    train form (`rwkv_time_mix`), and no state comes back.  At tensor rank
    `tp` each mixer's partial sums are reduced before its residual."""
    if state is None and not train:
        B, _, d = x.shape
        state = rwkv_init_state(B, d, p["w_r"].shape[-1] // head_dim,
                                head_dim, x.dtype, x.device)
    h = layernorm(x, p["ln1_g"], p["ln1_b"], norm_eps)
    att, tm_x, wkv = rwkv_time_mix(h, p, head_dim=head_dim, state=state,
                                   chunk_lens=chunk_lens, train=train, tp=tp)
    att = coll.reduce_from_tensor(att, tp)
    if valid is not None:
        att = att.masked_fill(~valid[..., None], 0)
    x = x + att
    h = layernorm(x, p["ln2_g"], p["ln2_b"], norm_eps)
    ffn, cm_x = rwkv_channel_mix(h, p, state=state, chunk_lens=chunk_lens,
                                 tp=tp)
    if valid is not None:
        ffn = ffn.masked_fill(~valid[..., None], 0)
    x = x + ffn
    if train:
        return x, None
    return x, state._replace(tm_x=tm_x, cm_x=cm_x, wkv=wkv)


# ----------------------------------------------------------------------------
# Train forms: whole sequences from a zero state, differentiable
# ----------------------------------------------------------------------------

# WKV6: tokens a state hand-off (the JAX package's chunk) and a sub-chunk.
# At rwkv6-3b's T = 4,096 (H = 40, D = 64, one row) the largest f32
# intermediates, the [8, 8, D] blocks and the keys decayed to each later
# sub-chunk's start, are 335 MB each; the hand-off loop runs 64 times.
WKV_CHUNK = 64
WKV_SUB = 8
# Mamba: tokens a state hand-off.  A chunk's [L, di, ds] f32 tensors are
# 67 MB each at jamba's di = 16,384, ds = 16 and one row.
MAMBA_CHUNK = 64


def _prefix(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the positions before each one along dim -2."""
    return torch.cat([torch.zeros_like(x[..., :1, :]),
                      torch.cumsum(x[..., :-1, :], dim=-2)], dim=-2)


def _suffix(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the positions after each one along dim -2."""
    return _prefix(x.flip(-2)).flip(-2)


def _between(x: torch.Tensor) -> torch.Tensor:
    """x [..., m, D] -> [..., m, m, D]: entry (t, j) is the sum of x_s over
    j < s < t (0 where no s lies between)."""
    m = x.shape[-2]
    i = torch.arange(m, device=x.device)
    after = (i[None, :] > i[:, None]).to(x.dtype)[..., None]     # s > j
    y = torch.cumsum(x[..., None, :, :] * after, dim=-2)   # (j, u): j < s <= u
    y = torch.cat([torch.zeros_like(y[..., :1, :]), y[..., :-1, :]], dim=-2)
    return y.transpose(-3, -2)


def wkv6_train(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The WKV6 recurrence over whole sequences from a zero state, in a
    form autograd differentiates: r, k, v [B, T, H, D] (any float dtype),
    the decay as logw = log w [B, T, H, D] (<= 0), u [H, D]; returns
    o [B, T, H, D] f32, where

        o_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
        S_t = diag(w_t) S_{t-1} + k_t v_t^T,      S_{-1} = 0,

    that is o_t = sum_{j<t} (r_t . k_j prod_{j<s<t} w_s) v_j
    + (r_t . u k_t) v_t.  Chunks of WKV_CHUNK tokens, each cut into
    sub-chunks of WKV_SUB: a pair (t, j) in one sub-chunk takes its product
    directly, on an [l, l, D] block; a pair in two sub-chunks of one chunk
    splits it at the first token of t's sub-chunk; a pair in two chunks
    goes through the state entering t's chunk, handed on from chunk to
    chunk in a loop (the JAX package's `lax.scan`).  Every product of w
    is exp of a sum of log w over an interval, and every such sum adds
    terms of one sign: each exponent is <= 0, nothing is divided, and no
    difference of two long sums cancels.  (The JAX package's
    `_wkv_chunked` divides by the cumulative decay, which overflows f32
    once -log w summed over a chunk passes 88.)"""
    B, T, H, D = r.shape
    L, l = WKV_CHUNK, WKV_SUB
    n, NC = L // l, -(-T // L)

    def chunked(x):          # [B, T, H, D] -> [B, H, NC, n, l, D] f32
        x = F.pad(x.float(), (0, 0, 0, 0, 0, NC * L - T))
        return x.transpose(1, 2).reshape(B, H, NC, n, l, D)

    r, k, v, lw = (chunked(x) for x in (r, k, v, logw))
    uf = u.float().reshape(1, H, 1, 1, 1, D)
    # j < t in one sub-chunk, and the bonus at j = t
    tri = torch.ones(l, l, dtype=torch.bool, device=r.device).tril(-1)
    dec = _between(lw).masked_fill(~tri[..., None], -math.inf).exp()
    o = (torch.einsum("...td,...tjd,...jd->...tj", r, dec, k) @ v
         + (r * uf * k).sum(-1, keepdim=True) * v)
    # t in sub-chunk p, j in sub-chunk q < p: the product over s in p
    # before t, times the product over s after j to p's start (the rest of
    # q, then the sub-chunks between q and p)
    early = torch.ones(n, n, dtype=torch.bool, device=r.device).tril(-1)
    kdec = (_between(lw.sum(-2))[..., :, :, None, :]
            + _suffix(lw)[..., None, :, :, :]).masked_fill(
                ~early[:, :, None, None], -math.inf).exp()   # [p, q, j, D]
    ks = (k[..., None, :, :, :] * kdec).flatten(-3, -2)      # [p, L, D]
    rs = r * _prefix(lw).exp()
    o = o + (rs @ ks.transpose(-1, -2)) @ v.flatten(-3, -2)[..., None, :, :]
    # t and j in two chunks: the state entering t's chunk
    r, k, v, lw, o = (x.flatten(-3, -2) for x in (r, k, v, lw, o))
    add = (k * _suffix(lw).exp()).transpose(-1, -2) @ v     # [B, H, NC, D, D]
    decay = lw.sum(-2).exp()[..., None]                     # [B, H, NC, D, 1]
    S = [torch.zeros_like(add[:, :, 0])]
    for c in range(NC - 1):
        S.append(torch.addcmul(add[:, :, c], decay[:, :, c], S[-1]))
    o = o + (r * _prefix(lw).exp()) @ torch.stack(S, dim=2)
    return o.reshape(B, H, NC * L, D)[:, :, :T].transpose(1, 2)


def selective_scan_train(dt: torch.Tensor, x: torch.Tensor, Bm: torch.Tensor,
                         C: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """The selective scan over whole sequences from a zero state, in a form
    autograd differentiates: dt, x [B, T, di], Bm, C [B, T, ds] and
    A [di, ds] (< 0); returns y [B, T, di] f32, where

        h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t,   y_t = C_t . h_t.

    Chunks of MAMBA_CHUNK tokens with one state hand-off each, as the JAX
    package's blocked associative scan: inside a chunk a Hillis-Steele scan
    whose factors are products of exp(dt A) <= 1 (nothing is divided).
    The [L, di, ds] tensors exist a chunk at a time: each chunk runs under
    `torch.utils.checkpoint`, so backward keeps only the states handed
    between chunks and recomputes the rest."""
    Bsz, T, _ = dt.shape
    h = torch.zeros((Bsz,) + tuple(A.shape), dtype=torch.float32,
                    device=dt.device)
    ys = []
    for t0 in range(0, T, MAMBA_CHUNK):
        c = slice(t0, t0 + MAMBA_CHUNK)
        y, h = checkpoint(_scan_chunk, dt[:, c], x[:, c], Bm[:, c], C[:, c],
                          A, h, use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, dim=1)


def _scan_chunk(dt, x, Bm, C, A, h):
    """One chunk of `selective_scan_train` from the state h [B, di, ds]:
    (y [B, L, di], the state after its last token)."""
    dt = dt.float()
    a = torch.exp(dt[..., None] * A.float())                 # [B, L, di, ds]
    b = (dt * x.float())[..., None] * Bm.float()[:, :, None, :]
    off = 1
    while off < a.shape[1]:     # then a_t = prod_{s<=t} dA_s, b_t = h_t | 0
        b = torch.cat([b[:, :off], torch.addcmul(b[:, off:], a[:, off:],
                                                 b[:, :-off])], dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    hs = torch.addcmul(b, a, h[:, None])
    return torch.einsum("blds,bls->bld", hs, C.float()), hs[:, -1]
