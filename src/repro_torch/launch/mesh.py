"""The rank layout (``repro.launch.mesh``): which process holds which
``(data, stage, tensor)`` coordinates, and one process group per line of
each axis.

The JAX package names the devices of one mesh; here each device of that
mesh is a process (a rank), and the mesh is a `Layout`: axis names and
sizes, ranks laid out in row-major order (the last axis fastest), as
``jax.make_mesh`` lays out its devices.  `make_production_mesh` and
`derive_pipeline_mesh` keep the JAX names: the ``(16, 16)`` and
``(2, 16, 16)`` production layouts, and the ``model`` axis factored into
``stage x tensor``.  They build layouts, not groups, so importing this
module touches no device and no process group.

`RankGroups` (`init_groups`, after ``torch.distributed`` is initialised)
holds, for one rank, an `AxisGroup` per axis: the ranks of the line of that
axis through this rank (the stage ring of its data replica and tensor
index, the tensor group of its stage, its data group) and the process group
over them (None for an axis of size 1).  Every rank creates every line's
group, in one order, as ``new_group`` requires.

**Backend.**  `choose_backend`: ``nccl`` when every rank has a card of its
own (rank r on card ``r % device_count``, ``world <= device_count``),
``gloo`` when ranks share a card, and on the CPU.  The launchers decide
once, from ``--backend`` or that rule; nothing falls back at run time.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
from typing import Dict, Iterator, List, Optional, Tuple

AXES = ("data", "stage", "tensor")


@dataclasses.dataclass(frozen=True)
class Layout:
    """Named axes over ``prod(shape)`` ranks, row-major (the last axis
    fastest)."""

    shape: Tuple[int, ...]
    names: Tuple[str, ...]

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.names) or any(n < 1 for n in
                                                     self.shape):
            raise ValueError(f"layout {self.shape} over {self.names}")

    @property
    def world(self) -> int:
        return math.prod(self.shape)

    def size(self, axis: str) -> int:
        return self.shape[self.names.index(axis)] if axis in self.names \
            else 1

    def coords(self, rank: int) -> Dict[str, int]:
        if not 0 <= rank < self.world:
            raise ValueError(f"rank {rank} outside a world of {self.world}")
        out = {}
        for name, n in reversed(list(zip(self.names, self.shape))):
            out[name] = rank % n
            rank //= n
        return {name: out[name] for name in self.names}

    def rank_of(self, coords: Dict[str, int]) -> int:
        rank = 0
        for name, n in zip(self.names, self.shape):
            rank = rank * n + coords.get(name, 0)
        return rank

    def line(self, axis: str, rank: int) -> List[int]:
        """The ranks along `axis` through `rank`, in axis order."""
        c = self.coords(rank)
        return [self.rank_of({**c, axis: i}) for i in range(self.size(axis))]

    def lines(self, axis: str) -> Iterator[List[int]]:
        """Every line of `axis`, each once, in rank order of its first."""
        seen = set()
        for r in range(self.world):
            line = self.line(axis, r)
            if line[0] not in seen:
                seen.add(line[0])
                yield line


def make_production_mesh(*, multi_pod: bool = False) -> Layout:
    """The production layout: ``(16, 16)`` over (data, model), or
    ``(2, 16, 16)`` over (pod, data, model)."""
    if multi_pod:
        return Layout((2, 16, 16), ("pod", "data", "model"))
    return Layout((16, 16), ("data", "model"))


def derive_pipeline_mesh(layout: Layout, pp: int, tp: int) -> Layout:
    """Factor the last (``model``) axis into (``stage``, ``tensor``): the
    same ranks in the same order under new names."""
    if layout.shape[-1] != pp * tp:
        raise ValueError(f"model axis {layout.shape[-1]} != pp*tp = "
                         f"{pp}*{tp}")
    return Layout(layout.shape[:-1] + (pp, tp),
                  layout.names[:-1] + ("stage", "tensor"))


def rank_layout(dp: int = 1, pp: int = 1, tp: int = 1) -> Layout:
    """The ``(data, stage, tensor)`` layout of dp * pp * tp ranks."""
    return Layout((dp, pp, tp), AXES)


def choose_backend(world: int, device_type: str, device_count: int = 0,
                   backend: Optional[str] = None) -> str:
    """``backend`` when given (``nccl`` needs a card per rank), else
    ``nccl`` when each of `world` ranks has a card of its own and ``gloo``
    otherwise (ranks sharing a card, or the CPU)."""
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    own_cards = device_type == "cuda" and world <= device_count
    if backend == "nccl" and not own_cards:
        raise ValueError(f"nccl needs a card per rank: {world} ranks, "
                         f"{device_count} cards ({device_type})")
    return backend or ("nccl" if own_cards else "gloo")


def use_ranks(dp: int, pp: int, tp: int, device_type: str,
              device_count: int = 0) -> bool:
    """Whether a launcher runs dp x pp x tp processes, one a rank: always
    at tp > 1 or dp > 1; at pp > 1 alone when every rank has a card of its
    own (else the pp stages run as a ring of micro-batches in one
    process, on its one device)."""
    if tp > 1 or dp > 1:
        return True
    return pp > 1 and device_type == "cuda" and pp <= device_count


def rank_device(rank: int, device_type: str, device_count: int = 0) -> str:
    """Rank r's device: card ``r % device_count``, or the CPU."""
    if device_type != "cuda":
        return "cpu"
    return f"cuda:{rank % max(device_count, 1)}"


@dataclasses.dataclass
class AxisGroup:
    """One rank's line of one axis: its global ranks in axis order, this
    rank's index on it, and the process group over it (None at size 1)."""

    axis: str
    ranks: Tuple[int, ...]
    index: int
    group: object = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    def peer(self, offset: int) -> int:
        """The global rank `offset` steps along the line (cyclic)."""
        return self.ranks[(self.index + offset) % self.size]


@dataclasses.dataclass
class RankGroups:
    """A rank's place in the layout and its groups, one per axis, and the
    seconds a collective waits for its peers before it raises
    (``timeout_s``; None: the backend's default)."""

    layout: Layout
    rank: int
    axes: Dict[str, AxisGroup]
    backend: str = "gloo"
    timeout_s: Optional[float] = None

    @property
    def coords(self) -> Dict[str, int]:
        return self.layout.coords(self.rank)

    def __getitem__(self, axis: str) -> AxisGroup:
        return self.axes[axis]

    def size(self, axis: str) -> int:
        return self.layout.size(axis)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def world_axis(self) -> AxisGroup:
        """Every rank, on the default process group."""
        return AxisGroup("world", tuple(range(self.layout.world)),
                         self.rank)


def counting_groups(layout: Layout, rank: int) -> RankGroups:
    """`rank`'s groups for the dry run (`launch.dryrun`): every axis of the
    layout's size, with no process group.  The program runs on ``meta``
    tensors there, and each collective books its bytes instead of moving
    them (`distributed.collectives`); nothing joins a process group."""
    axes = {name: AxisGroup(name, tuple(layout.line(name, rank)),
                            layout.coords(rank)[name])
            for name in layout.names}
    return RankGroups(layout, rank, axes, backend="count")


def init_groups(layout: Layout, rank: int, backend: str = "gloo",
                timeout_s: Optional[float] = None) -> RankGroups:
    """Create every line's group of every axis (collectively: all ranks
    call this, in one order) and return `rank`'s.  The default process
    group must be initialised over ``layout.world`` ranks."""
    import torch.distributed as dist

    if dist.get_world_size() != layout.world:
        raise ValueError(f"process group of {dist.get_world_size()} ranks, "
                         f"layout of {layout.world}")
    kw = {} if timeout_s is None else {
        "timeout": datetime.timedelta(seconds=timeout_s)}
    axes = {}
    for name in layout.names:
        for line in layout.lines(name):
            group = (dist.new_group(line, backend=backend, **kw)
                     if len(line) > 1 else None)
            if rank in line:
                axes[name] = AxisGroup(name, tuple(line), line.index(rank),
                                       group)
    return RankGroups(layout, rank, axes, backend, timeout_s)
