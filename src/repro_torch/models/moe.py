"""Mixture-of-Experts (``repro.models.moe``): every expert on this rank
(NS=1), or expert parallelism over a data group of NS ranks, each holding
``E_loc = E / NS`` experts.

Dispatch is sort-based with static capacity buffers, as in the JAX package:
the T*top_k (row, expert) assignments are stably sorted by expert, each
takes the next position of its expert's ``[capacity, d]`` buffer, and the
ones past capacity drop.  The same rows drop as in JAX because the sort is
stable and the group starts come from a left `searchsorted`.

**Expert parallelism** (`moe_apply(ep=)`, JAX's ``ep_axis`` branch): the
assignments are bucketed by destination rank (``expert // E_loc``) into
``[NS, cap_send]`` send buffers, exchanged (`collectives.exchange_rows`,
JAX's tiled ``all_to_all``), grouped by local expert into ``[E_loc,
cap_e]`` buffers for the expert kernel, and the results exchanged back;
``cap_send`` and ``cap_e`` are JAX's formulas, and the received rows are
grouped in rank order by the same stable sort, so the same rows drop.
JAX packs each row's local expert id and a valid flag into two extra
columns of x's dtype (exact in bf16 only up to 256 local experts); here
the ids travel in an int32 buffer of their own, the empty slots holding
the sentinel ``E_loc``.  Every rank of the group joins both exchanges
whatever its rows: padding rows and an idle replica's send no valid row.

JAX's ``.at[...].set(mode="drop")`` silently drops out-of-range writes (the
sentinel expert ``E`` of padding rows, positions past capacity); torch
indexing would raise or wrap, so dropped assignments are sent to one extra
dump row of the buffer, which is cut off.  The rows each buffer holds go to
the expert kernel as a device tensor, so that it skips the empty ones.
Nothing here reads a device value on the host (no ``.item()``, ``nonzero``
or boolean-mask indexing): the capacities are host functions of the padded
row count.  The combine is a sum
over each row's top_k slots, which is deterministic where a CUDA
``index_add_`` is not.

At a tensor rank (``tp``) every expert's and the shared expert's ff columns
are the rank's: the routing is computed whole on every rank (the same rows
in the same slots, bit for bit), the rank's expert outputs are partial sums
over its columns, and the routed and shared partials are summed over the
group in f32 in one all-reduce before the cast.  With both, a rank's data
group is the ranks of its stage and tensor index: each exchanges its
columns' partial sums with the peers that hold the same columns.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as coll
from repro_torch.kernels import ops
from repro_torch.models.layers import swiglu


def _round8(x: int) -> int:
    return max(8, (x + 7) // 8 * 8)


def capacity(rows: int, top_k: int, num_experts: int,
             capacity_factor: float) -> int:
    """Rows of each expert's buffer for `rows` (padded) token rows, as the
    JAX package computes it at NS=1."""
    return _round8(int(rows * top_k / num_experts * capacity_factor) + 1)


def route(x: torch.Tensor, router_w: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Softmax-then-top-k routing with weight renormalization.

    Returns (weights [T,K] f32, expert_ids [T,K] int32, aux_loss scalar)."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, top_k, dim=-1)
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    # GShard load-balancing auxiliary loss: E * mean_e(frac_tokens_e * mean_prob_e)
    E = router_w.shape[-1]
    me = probs.mean(dim=0)
    fe = F.one_hot(idx[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(fe * me)
    return w, idx.to(torch.int32), aux


def _dispatch(group_ids: torch.Tensor, num_groups: int, capacity: int):
    """Where `_group_rows` puts each row: (order, slot_group, slot_pos,
    slot, counts).  `slot` is each sorted row's index in the flattened
    ``[num_groups * capacity]`` buffers, ``num_groups * capacity`` (the
    dump row) for a dropped or invalid one; counts [num_groups] int32."""
    n = group_ids.shape[0]
    dev = group_ids.device
    order = torch.argsort(group_ids, stable=True)
    sg = group_ids[order]
    # left edges of the groups, and of the invalid rows after them
    starts = torch.searchsorted(
        sg, torch.arange(num_groups + 1, device=dev, dtype=sg.dtype))
    counts = torch.clamp(starts[1:] - starts[:-1], max=capacity)
    pos = (torch.arange(n, device=dev)
           - starts[torch.clamp(sg, max=num_groups - 1)])
    pos = torch.where(sg < num_groups, pos, capacity)    # invalid -> dropped
    slot = torch.where(pos < capacity, sg * capacity + pos,
                       num_groups * capacity)
    return order, sg, pos, slot, counts.to(torch.int32)


def _scatter_rows(values: torch.Tensor, slot: torch.Tensor,
                  num_groups: int, capacity: int, fill=0) -> torch.Tensor:
    """`values` (already in `_dispatch` order) into ``[num_groups,
    capacity, ...]`` buffers at `slot`, `fill` elsewhere."""
    dump = num_groups * capacity
    buf = values.new_full((dump + 1,) + values.shape[1:], fill)
    buf[slot] = values                 # dropped rows all land on the dump row
    return buf[:dump].view((num_groups, capacity) + values.shape[1:])


def _group_rows(values: torch.Tensor, group_ids: torch.Tensor,
                num_groups: int, capacity: int):
    """Sort rows by group and scatter into [num_groups, capacity, ...]
    buffers.

    Returns (buffers, order, slot_group, slot_pos, counts); rows beyond
    capacity drop, and counts [num_groups] int32 is the rows each buffer
    holds, min(rows routed to the group, capacity).  `group_ids` >=
    num_groups mark invalid rows (never stored)."""
    order, sg, pos, slot, counts = _dispatch(group_ids, num_groups,
                                             capacity)
    buf = _scatter_rows(values[order], slot, num_groups, capacity)
    return buf, order, sg, pos, counts


def _ungroup_rows(buffers: torch.Tensor, order: torch.Tensor,
                  slot_group: torch.Tensor, slot_pos: torch.Tensor
                  ) -> torch.Tensor:
    """Inverse of `_group_rows`: read each row's result back (dropped -> 0)."""
    num_groups, cap = buffers.shape[:2]
    ok = slot_pos < cap
    vals = buffers[torch.clamp(slot_group, max=num_groups - 1),
                   torch.clamp(slot_pos, min=0, max=cap - 1)]
    vals = torch.where(ok.view((-1,) + (1,) * (vals.dim() - 1)), vals,
                       torch.zeros((), dtype=vals.dtype, device=vals.device))
    out = torch.empty_like(vals)
    out[order] = vals                  # order is a permutation
    return out


def expert_ffn(xb: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor,
               counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped SwiGLU over padded per-expert buffers, every shape through
    `ops.fused_moe_ffn`: the Hopper kernel for CUDA tensors (which raises on
    a shape it does not take), the plain version on the CPU.

    xb [E, C, d]; weights [E, d, ff] / [E, ff, d]; counts [E] int32, the
    rows each buffer holds (the kernel skips the rest)."""
    return ops.fused_moe_ffn(xb, w_gate, w_up, w_down, counts)


def moe_apply(
    x: torch.Tensor,                     # [T, d] flattened tokens
    params: Dict[str, torch.Tensor],
    *,
    top_k: int,
    ep=None,
    capacity_factor: float = 1.25,
    row_valid: Optional[torch.Tensor] = None,   # [T] bool: padding rows opt out
    tp=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [T, d], aux_loss).  `params` holds:
    router [d, E]; w_gate/w_up [E_loc, d, ff]; w_down [E_loc, ff, d];
    optional shared-expert s_gate/s_up [d, ffs], s_down [ffs, d].
    ``E_loc == E / ep.size``: with `ep` (a `launch.mesh.AxisGroup`, the
    rank's data group; this rank holds experts ``[ep.index * E_loc,
    (ep.index + 1) * E_loc)``) the rows travel to their experts' ranks and
    back (the module docstring); every rank of the group must call this
    with the same T.  Rows with row_valid=False (static-tick bucket
    padding) are routed nowhere and consume no expert capacity.  At tensor
    rank `tp` (a `launch.mesh.AxisGroup`; ff and ffs the rank's columns)
    the router is replicated, x enters the expert path and the routing
    weights enter the combine through `copy_to_tensor` (both scale the
    rank's partial sums), and the output is reduced over the group."""
    T, d = x.shape
    E_loc = params["w_gate"].shape[0]
    NS = 1 if ep is None else ep.size
    E = E_loc * NS

    w, idx, aux = route(x, params["router"], top_k)
    N = T * top_k
    flat_e = idx.reshape(N).long()
    src = torch.arange(T, device=x.device).repeat_interleave(top_k)
    if row_valid is not None:
        flat_e = torch.where(row_valid[src], flat_e, E)  # invalid sentinel
    xe = coll.copy_to_tensor(x, tp)          # the router reads x as it is
    xs = xe[src]                                          # [N, d]

    if NS > 1:
        # bucket by destination rank, exchange, compute, exchange back
        cap_send = _round8(int(N / NS * capacity_factor) + 1)
        order, sg, pos, slot, _ = _dispatch(flat_e // E_loc, NS, cap_send)
        xbuf = _scatter_rows(xs[order], slot, NS, cap_send)
        lbuf = _scatter_rows((flat_e % E_loc).to(torch.int32)[order], slot,
                             NS, cap_send, fill=E_loc)
        rx = coll.exchange_rows(xbuf, ep).reshape(NS * cap_send, d)
        re = coll.all_to_all(lbuf, ep).reshape(NS * cap_send).long()
        cap_e = _round8(int(NS * cap_send / E_loc * capacity_factor) + 1)
        ebuf, order2, sg2, pos2, counts = _group_rows(rx, re, E_loc, cap_e)
        y = expert_ffn(ebuf, params["w_gate"], params["w_up"],
                       params["w_down"], counts)
        ry = _ungroup_rows(y, order2, sg2, pos2).view(NS, cap_send, d)
        ys = _ungroup_rows(coll.exchange_rows(ry, ep), order, sg, pos)
    else:
        cap = capacity(T, top_k, E, capacity_factor)
        ebuf, order, sg, pos, counts = _group_rows(xs, flat_e, E, cap)
        y = expert_ffn(ebuf, params["w_gate"], params["w_up"],
                       params["w_down"], counts)
        ys = _ungroup_rows(y, order, sg, pos)             # [N, d]

    w = coll.copy_to_tensor(w, tp)
    out = (ys.float().view(T, top_k, d) * w[..., None]).sum(dim=1)
    if "s_gate" in params:
        shared = swiglu(xe, params["s_gate"], params["s_up"],
                        params["s_down"])
        out = out + shared.float()
    return coll.reduce_from_tensor(out, tp).to(x.dtype), aux


def moe_ref(x: torch.Tensor, params: Dict[str, torch.Tensor], *,
            top_k: int) -> torch.Tensor:
    """Dense per-expert oracle (no capacity drops) for correctness tests."""
    w, idx, _ = route(x, params["router"], top_k)
    E = params["router"].shape[-1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(E):
        ye = swiglu(x, params["w_gate"][e], params["w_up"][e],
                    params["w_down"][e])
        gate = torch.where(idx == e, w, torch.zeros_like(w)).sum(dim=-1)
        out = out + gate[:, None] * ye.float()
    if "s_gate" in params:
        out = out + swiglu(x, params["s_gate"], params["s_up"],
                           params["s_down"]).float()
    return out.to(x.dtype)
