"""One rank's program counted on ``meta`` tensors
(``repro.roofline.hlo_cost``).

The JAX module parses the optimised HLO of a compiled program and folds
its costs bottom-up, scaling each loop body by its trip count.  PyTorch
compiles no program: the port runs one rank's program itself, eagerly, on
``meta`` tensors (shapes and dtypes, no storage), under `OpCounter`, a
``TorchDispatchMode`` that sees every aten op below autograd (the
backward's and a recompute's ops too):

* **flops** — 2·M·N·K of every ``mm`` / ``addmm`` / ``bmm`` / ``baddbmm``
  (``einsum``, ``matmul`` and ``linear`` lower to them); elementwise work
  is not counted, as ``hlo_cost`` counts only dots.
* **bytes** — operands plus result of every op that is not a view (a view,
  ``_unsafe_view`` among them, moves nothing, nor does an op that only
  allocates, ``empty``).  A gather
  (``index``, ``index_select``, ``gather``, ``embedding``) counts 2× its
  result plus its indices, an index write (``index_put``, ``index_copy``,
  ``scatter``) 2× its updates plus its indices: the pages touched, not the
  pool, as ``hlo_cost`` counts them.  ``copy_`` counts its source and its
  destination once each.
* **kernels** — a kernel's wrapper given meta tensors books its own cost
  (`book`), computed from shapes at the full static geometry, and returns
  an empty result: the ops inside a kernel are never seen.
* **collectives** — on the dry run's counting axes each collective books
  its payload bytes under its HLO name (`COLLECTIVES`, `book_collective`).
* **peak live bytes** — a storage an op allocates is live from that op
  until its last tensor dies (a finaliser on the storage); the largest sum
  seen.  Storages made before the count (the program's arguments) are not
  in it.

A Python loop runs as many times as it runs, so every trip is counted,
which ``hlo_cost``'s trip counts stand in for.
"""

from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Dict, Iterable, List, Optional

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _get_current_dispatch_mode_stack,
)
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten

# the HLO names of the collectives (``hlo_cost._COLL_OPS``)
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_DOTS = {"mm", "addmm", "bmm", "baddbmm"}
_GATHERS = {"index", "index_select", "gather", "embedding"}
_SCATTERS = {"index_put", "index_put_", "_index_put_impl_", "index_copy",
             "index_copy_", "scatter", "scatter_", "index_add",
             "index_add_"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(xs) -> List[torch.Tensor]:
    return [x for x in tree_flatten(xs)[0] if isinstance(x, torch.Tensor)]


def _dot_flops(name: str, args) -> float:
    a, b = (args[0], args[1]) if name in ("mm", "bmm") else (args[1],
                                                            args[2])
    batch = a.shape[0] if a.dim() == 3 else 1
    m, k = a.shape[-2], a.shape[-1]
    return 2.0 * batch * m * k * b.shape[-1]


class OpCounter(TorchDispatchMode):
    """Counts flops, bytes, collective bytes and peak live bytes of the ops
    run under it (see the module docstring); ``by_op`` splits the flops
    and bytes by op name (a kernel's as ``kernel:<name>``)."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
        self.by_op: Dict[str, List[float]] = defaultdict(
            lambda: [0, 0.0, 0.0])           # calls, flops, bytes
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}

    @property
    def collective_bytes(self) -> float:
        return sum(self.collectives.values())

    def _add(self, name: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes
        row = self.by_op[name]
        row[0] += 1
        row[1] += flops
        row[2] += nbytes

    def _freed(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def _track(self, outs: Iterable[torch.Tensor],
               ins: Iterable[torch.Tensor]) -> None:
        """Count each output whose storage no input shares as allocated
        here, live until the storage dies."""
        held = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in held or key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = n
            weakref.finalize(st, self._freed, key)
            self.live += n
            self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # an op with a decomposition (``matmul``, ``einsum`` and ``linear``
        # reach the mode whole under inference mode) runs as its parts
        if torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), torch._C.DispatchKey.CompositeImplicitAutograd):
            with self:                   # the parts come back here
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        outs = _tensors(out)
        view = func.is_view or name == "_unsafe_view"
        if view or not outs or name.startswith(("empty", "new_empty")):
            if outs and not view:
                self._track(outs, _tensors((args, kwargs)))
            return out
        ins = _tensors((args, kwargs))
        flops = _dot_flops(name, args) if name in _DOTS else 0.0
        if name in _GATHERS:
            nbytes = 2 * sum(map(_nbytes, outs)) + sum(
                _nbytes(t) for t in ins[1:])
        elif name in _SCATTERS:
            upd = ins[-1]
            nbytes = 2 * _nbytes(upd) + sum(_nbytes(t) for t in ins[1:-1])
        elif name == "copy_":
            nbytes = sum(map(_nbytes, ins[:2]))
        else:
            nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self._add(name, flops, nbytes)
        self._track(outs, ins)
        return out

    def summary(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "collective_bytes": self.collective_bytes,
                "collectives": dict(self.collectives),
                "peak_live_bytes": self.peak}


def _active() -> Optional[OpCounter]:
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, OpCounter):
            return mode
    return None


def book(name: str, flops: float, nbytes: float) -> None:
    """A kernel's own work, computed from its shapes, into the active
    counter (none: nothing)."""
    counter = _active()
    if counter is not None:
        counter._add(f"kernel:{name}", float(flops), float(nbytes))


def book_collective(name: str, nbytes: float) -> None:
    """A collective's payload bytes under its HLO name `name`
    (`COLLECTIVES`) into the active counter (none: nothing)."""
    if name not in COLLECTIVES:
        raise ValueError(f"unknown collective {name!r}")
    counter = _active()
    if counter is not None:
        counter.collectives[name] += float(nbytes)
