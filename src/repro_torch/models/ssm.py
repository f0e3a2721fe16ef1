"""State-space / linear-recurrence mixers (``repro.models.ssm``): Mamba
(jamba) and RWKV6 (Finch).

Each entry point operates on [B, T, d] with an optional recurrent state:
train (the dense reference) runs each row from a zero state over its whole
length; serve passes the rows' state and live lengths.  The recurrences go
through `ops.mamba_scan` and `ops.rwkv6_scan`: the Hopper kernel for CUDA
tensors, its plain version on the CPU.  Unlike the JAX package, which
returns a new scan state per row, the port keeps that state (Mamba's `ssm`,
RWKV's `wkv`) in the layer's slot pool and the scan advances it in place
(`MambaState`, `RWKVState`).
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import layernorm

GROUP_NORM_EPS = 64e-5


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out, new conv state).  Rows run their first `chunk_lens`
    tokens (all T when None) through the scan; the state's `ssm` pool is
    advanced in place at the rows' slots.  The outputs past a row's live
    tokens are not defined (the JAX masks zero them).  The new conv state
    is the last ``d_conv - 1`` live rows of ``[old state | chunk]`` (the old
    state itself for a row with no live token)."""
    B, T, _ = x.shape
    xz = x @ p["in_proj"]                               # [B, T, 2*di]
    di = xz.shape[-1] // 2
    xi, z = xz[..., :di], xz[..., di:]
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
    dbc = xi @ p["x_proj"]                              # [B, T, dtr + 2*ds]
    Bm = dbc[..., dtr:dtr + d_state].float().contiguous()
    Cm = dbc[..., dtr + d_state:].float().contiguous()
    dt = F.softplus((dbc[..., :dtr] @ p["dt_proj"]).float()
                    + p["dt_bias"].float())              # [B, T, di]
    A = -torch.exp(p["A_log"].float())                  # [di, ds]

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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (out, new_tm_x, wkv pool).  Rows run their first
    `chunk_lens` tokens (all T when None) through the recurrence; the
    pool is advanced in place at the rows' slots."""
    B, T, d = x.shape
    H = d // head_dim
    if state is None:
        state = rwkv_init_state(B, d, H, head_dim, x.dtype, x.device)
    last = state.tm_x
    sx = _token_shift(x, last)
    xr = x + sx * p["mu_r"]
    xk = x + sx * p["mu_k"]
    xv = x + sx * p["mu_v"]
    xg = x + sx * p["mu_g"]
    xw = x + sx * p["mu_w"]

    r = (xr @ p["w_r"]).reshape(B, T, H, head_dim)
    k = (xk @ p["w_k"]).reshape(B, T, H, head_dim)
    v = (xv @ p["w_v"]).reshape(B, T, H, head_dim)
    g = F.silu(xg @ p["w_g"])
    # data-dependent decay (the Finch contribution): w = exp(-exp(w0 + lora))
    dd = torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]       # [B, T, d]
    logw = -torch.exp(torch.clamp(p["w0"].float() + dd.float(), -20.0, 10.0))
    w = torch.exp(logw).reshape(B, T, H, head_dim)            # in (0, 1)
    u = p["u"].reshape(H, head_dim).float()    # bonus for the current token

    lens = chunk_lens if chunk_lens is not None else torch.full(
        (B,), T, dtype=torch.int32, device=x.device)
    o = ops.rwkv6_scan(r, k, v, w, u, state.wkv, state.slots,
                       lens.to(torch.int32), state.fresh)     # f32
    # per-head group norm, in f32
    mu = torch.mean(o, dim=-1, keepdim=True)
    var = torch.mean(torch.square(o - mu), dim=-1, keepdim=True)
    o = (o - mu) * torch.rsqrt(var + GROUP_NORM_EPS)
    o = (o.reshape(B, T, d) * p["ln_x_g"].float()).to(x.dtype)
    out = (o * g.to(x.dtype)) @ p["w_o"]
    return out, _last_valid_row(x, last, chunk_lens), state.wkv


def rwkv_channel_mix(
    x: torch.Tensor,                    # [B, T, d]
    p: Mapping[str, torch.Tensor],
    *,
    state: Optional[RWKVState] = None,
    chunk_lens: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    B, T, d = x.shape
    last = (torch.zeros(B, d, dtype=x.dtype, device=x.device)
            if state is None else state.cm_x)
    sx = _token_shift(x, last)
    xk = x + sx * p["cm_mu_k"]
    xr = x + sx * p["cm_mu_r"]
    k = torch.square(torch.relu(xk @ p["cm_k"]))
    out = torch.sigmoid(xr @ p["cm_r"]) * (k @ p["cm_v"])
    return out, _last_valid_row(x, last, chunk_lens)


def rwkv_block(
    x: torch.Tensor,
    p: Mapping[str, torch.Tensor],
    *,
    head_dim: int,
    norm_eps: float,
    state: Optional[RWKVState] = None,
    valid: Optional[torch.Tensor] = None,
    chunk_lens: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, RWKVState]:
    """Layernorm, time-mix, layernorm, channel-mix, each with its residual.
    `valid` [B, T] (the positions before `chunk_lens`) zeroes the padding
    positions' mixer outputs, as the JAX masks do."""
    if state is None:
        B, _, d = x.shape
        state = rwkv_init_state(B, d, d // head_dim, head_dim, x.dtype,
                                x.device)
    h = layernorm(x, p["ln1_g"], p["ln1_b"], norm_eps)
    att, tm_x, wkv = rwkv_time_mix(h, p, head_dim=head_dim, state=state,
                                   chunk_lens=chunk_lens)
    if valid is not None:
        att = att.masked_fill(~valid[..., None], 0)
    x = x + att
    h = layernorm(x, p["ln2_g"], p["ln2_b"], norm_eps)
    ffn, cm_x = rwkv_channel_mix(h, p, state=state, chunk_lens=chunk_lens)
    if valid is not None:
        ffn = ffn.masked_fill(~valid[..., None], 0)
    x = x + ffn
    return x, state._replace(tm_x=tm_x, cm_x=cm_x, wkv=wkv)
