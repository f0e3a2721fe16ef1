"""Checkpoints (``repro.runtime.checkpoint``), in the JAX package's on-disk
layout, so that a checkpoint written by either package restores in the
other.

Layout: one ``.npy`` per leaf, named by its ``/``-joined tree path with
``/`` replaced by ``__``, and ``manifest.json`` (every leaf's file, shape
and dtype, and the caller's `extra`), written through a ``.tmp`` file and
``os.replace``.  bf16 leaves are stored as their ``uint16`` bits (numpy has
no bfloat16); reading needs no ``ml_dtypes``.  Paths are the JAX tree's:
nested mappings (dicts, `TransformerParams`) by key, NamedTuples (an
`AdamState`) by field name.

`AsyncCheckpointer` takes its snapshot synchronously on `submit` (a copy
on the host: a CPU leaf is cloned, since the next in-place Adam step would
overwrite the storage the writer thread reads; a CUDA leaf is copied to the
host, which waits for the card) and writes it in a background thread, so
the train loop is not held up by the disk.

**Across ranks** (the counterpart of the JAX restore's ``shardings=``):
`restore_checkpoint(layout=, rank=)` reads only the rank's block of each
logical leaf (`transformer.block_slices` of its `param_pspecs` split,
through ``np.load(mmap_mode="r")``), so no rank holds the whole model.
`save_checkpoint_ranks` writes, from every rank's shard, the same files as
`save_checkpoint` of the whole tree, byte for byte: rank 0 writes each
``.npy`` header (``open_memmap``), then the one rank that owns each block
(index 0 on every axis the leaf is replicated over: experts split over
``data`` are written by their data rank) writes it in place, and only
once every rank has said that its writes succeeded (an all-reduce of a
failure flag) rank 0 writes the manifest; a failure on any rank raises on
every rank.  So neither a crash nor a failed write leaves a manifest that
points at partial files.  `AsyncCheckpointer(ranks=)`
takes its host snapshot synchronously on every rank and writes its blocks
in the background; the manifest follows at the next `submit` or `wait`.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.transformer import (
    TransformerParams,
    block_slices,
    is_node,
    leaf_parts,
    param_pspecs,
    spec_axes,
)

_BF16 = "bfloat16"


def _flatten_with_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """{path: leaf}: mappings by key (sorted), NamedTuples by field."""
    if is_node(tree):
        items = ((str(k), tree[k]) for k in sorted(tree.keys()))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        return {prefix: tree}
    flat: Dict[str, Any] = {}
    for k, v in items:
        flat.update(_flatten_with_paths(v, f"{prefix}/{k}" if prefix else k))
    return flat


def _unflatten(target, flat: Dict[str, Any], prefix: str = ""):
    """`target`'s structure with the leaves of `flat` (a `TransformerParams`
    target gives a `TransformerParams`)."""
    def at(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if is_node(target):
        tree = {k: _unflatten(target[k], flat, at(k)) for k in target.keys()}
        return TransformerParams(tree) if isinstance(
            target, TransformerParams) else tree
    if isinstance(target, tuple) and hasattr(target, "_fields"):
        return type(target)(*(_unflatten(v, flat, at(k))
                              for k, v in zip(target._fields, target)))
    return flat[prefix]


def _to_numpy(t) -> np.ndarray:
    """A host snapshot leaf as numpy; bf16 as its uint16 bits."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(t)


def leaf_digest(t: torch.Tensor) -> str:
    """The SHA-1 of a leaf's bytes as a checkpoint stores them."""
    import hashlib

    return hashlib.sha1(np.ascontiguousarray(
        _to_numpy(t.detach().cpu())).tobytes()).hexdigest()


def _dtype_name(t) -> str:
    if isinstance(t, torch.Tensor):
        return str(t.dtype).split(".")[-1]
    return str(np.asarray(t).dtype)


def save_checkpoint(directory: str, tree, *,
                    extra: Optional[dict] = None) -> None:
    """Write `tree` (leaves: host or device tensors, numpy arrays)."""
    os.makedirs(directory, exist_ok=True)
    manifest = {"leaves": {}, "extra": extra or {}}
    for key, leaf in _flatten_with_paths(tree).items():
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu()
        arr = _to_numpy(leaf)
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(directory, fname), arr)
        manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                   "dtype": _dtype_name(leaf)}
    tmp = os.path.join(directory, "manifest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, os.path.join(directory, "manifest.json"))


def load_manifest(directory: str) -> dict:
    with open(os.path.join(directory, "manifest.json")) as f:
        return json.load(f)


def _as_torch(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _load_leaf(directory: str, info: dict) -> torch.Tensor:
    return _as_torch(np.load(os.path.join(directory, info["file"])),
                     info["dtype"])


def _read_block(directory: str, info: dict, key: str,
                shape: Tuple[int, ...], spec, layout, rank: int,
                retile: bool) -> torch.Tensor:
    """Rank `rank`'s block of the leaf stored at `info` (whole `shape`),
    read through a memory map.  With `retile`, a stage leaf stored as
    ``[S, R, ...]`` is first seen as ``shape``'s ``[S', R', ...]`` (the
    same layers, `elastic.repartition_params`'s view)."""
    arr = np.load(os.path.join(directory, info["file"]), mmap_mode="r")
    if tuple(arr.shape) != tuple(shape):
        if not (retile and arr.ndim == len(shape) >= 2
                and arr.shape[2:] == tuple(shape[2:])
                and arr.shape[0] * arr.shape[1] == shape[0] * shape[1]):
            raise ValueError(f"checkpoint leaf {key!r} has shape "
                             f"{tuple(arr.shape)}, the target {tuple(shape)}")
        arr = arr.reshape(shape)
    pieces = block_slices(spec, tuple(shape), layout, rank, leaf_parts(key))
    if len(pieces) == 1:
        block = np.array(arr[pieces[0][0]])
    else:
        j = next(d for d, b in enumerate(pieces[0][1]) if b != slice(None))
        block = np.concatenate([arr[w] for w, _ in pieces], axis=j)
    return _as_torch(block, info["dtype"])


def restore_checkpoint(directory: str, target_tree, *,
                       device: torch.device | str = "cpu", layout=None,
                       rank: int = 0, specs=None, retile: bool = False):
    """Restore into the structure of `target_tree` (its values, which may be
    meta tensors, are ignored; each leaf keeps the dtype it was saved in)
    on `device`.  Raises on a leaf the checkpoint lacks and on a shape that
    differs from the target's.

    With a `layout` (`launch.mesh.Layout`), `target_tree` is the whole
    tree (`abstract_params`) and each leaf comes back as rank `rank`'s
    block of it, split by `specs` (the tree's `param_pspecs`), read off a
    memory map of the file; `retile` lets a stage leaf saved at another
    stage count be read (`elastic.rank_restore`)."""
    manifest = load_manifest(directory)
    flat_specs = _flatten_with_paths(specs) if layout is not None else {}
    out = {}
    for key, want in _flatten_with_paths(target_tree).items():
        info = manifest["leaves"].get(key)
        if info is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        shape = getattr(want, "shape", None)
        if layout is not None:
            leaf = _read_block(directory, info, key, tuple(shape),
                               flat_specs[key], layout, rank, retile)
            out[key] = leaf.to(device)
            continue
        leaf = _load_leaf(directory, info)
        if shape is not None and tuple(shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {key!r} has shape "
                             f"{tuple(leaf.shape)}, the target "
                             f"{tuple(shape)}")
        out[key] = leaf.to(device)
    return _unflatten(target_tree, out)


# ----------------------------------------------------------------------------
# Saving across ranks
# ----------------------------------------------------------------------------

def writes_block(spec, layout, rank: int) -> bool:
    """Whether `rank` writes its block of a leaf split by `spec`: it is at
    index 0 of every axis the leaf is replicated over."""
    named = set(spec_axes(spec))
    coords = layout.coords(rank)
    return all(coords[a] == 0 for a in layout.names if a not in named)


def _file_dtype(leaf: torch.Tensor) -> np.dtype:
    return np.dtype(np.uint16) if leaf.dtype == torch.bfloat16 else \
        torch.empty(0, dtype=leaf.dtype).numpy().dtype


def _rank_plan(tree, cfg, ranks) -> List[tuple]:
    """(path, whole shape, file, dtype name, file dtype, spec) of every
    leaf of `cfg`'s whole tree, in `save_checkpoint`'s order, beside the
    rank's shard `tree`."""
    from repro_torch.models.transformer import abstract_params

    whole = _flatten_with_paths(abstract_params(cfg))
    mine = _flatten_with_paths(tree)
    specs = _flatten_with_paths(param_pspecs(cfg))
    return [(key, tuple(w.shape), key.replace("/", "__") + ".npy",
             _dtype_name(mine[key]), _file_dtype(mine[key]), specs[key])
            for key, w in whole.items()]


def _write_headers(directory: str, plan: List[tuple]) -> None:
    """Rank 0: a stale manifest goes first, then every leaf's ``.npy``
    header and room for its data."""
    os.makedirs(directory, exist_ok=True)
    stale = os.path.join(directory, "manifest.json")
    if os.path.exists(stale):
        os.remove(stale)
    for _, shape, fname, _, fdtype, _ in plan:
        mm = np.lib.format.open_memmap(os.path.join(directory, fname),
                                       mode="w+", dtype=fdtype, shape=shape)
        del mm


def _write_blocks(directory: str, plan: List[tuple], host: Dict[str, Any],
                  layout, rank: int) -> None:
    """This rank's blocks (`host`: its shard's leaves on the host) into the
    files, in place."""
    for key, shape, fname, _, _, spec in plan:
        if not writes_block(spec, layout, rank):
            continue
        block = _to_numpy(host[key])
        mm = np.load(os.path.join(directory, fname), mmap_mode="r+")
        for w, b in block_slices(spec, shape, layout, rank,
                                 leaf_parts(key)):
            mm[w] = block[b]
        mm.flush()
        del mm


def _write_manifest(directory: str, plan: List[tuple],
                    extra: Optional[dict]) -> None:
    manifest = {"leaves": {key: {"file": fname, "shape": list(shape),
                                 "dtype": dname}
                           for key, shape, fname, dname, _, _ in plan},
                "extra": extra or {}}
    tmp = os.path.join(directory, "manifest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, os.path.join(directory, "manifest.json"))


def _all_or_none(fn: Callable[[], Any]) -> None:
    """Run `fn` on this rank, then agree with every rank of the world
    (collective) on whether all of them succeeded: if any failed, each
    rank raises, its own error or one that says another rank failed.  So
    no rank goes on to write a manifest over another's partial files."""
    import torch.distributed as dist

    err = None
    try:
        fn()
    except Exception as e:  # noqa: BLE001
        err = e
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    failed = torch.tensor([int(err is not None)], dtype=torch.int32,
                          device=dev)
    dist.all_reduce(failed, op=dist.ReduceOp.MAX)
    if err is not None:
        raise err
    if failed.item():
        raise RuntimeError("checkpoint: another rank's writes failed; no "
                           "manifest was written")


def save_checkpoint_ranks(directory: str, tree, cfg, ranks, *,
                          extra: Optional[dict] = None) -> None:
    """Every rank's part (collective: all ranks call it) of saving the
    whole tree of `cfg` whose shard this rank holds as `tree`: the files
    `save_checkpoint` writes of the whole tree, byte for byte.  A failure
    on any rank raises on every rank, before the manifest."""
    plan = _rank_plan(tree, cfg, ranks)
    host = {k: _snapshot(v) for k, v in _flatten_with_paths(tree).items()}
    head = ranks.rank == 0
    _all_or_none(lambda: head and _write_headers(directory, plan))
    _all_or_none(lambda: _write_blocks(directory, plan, host, ranks.layout,
                                       ranks.rank))
    _all_or_none(lambda: head and _write_manifest(directory, plan, extra))


def _snapshot(leaf):
    """A host copy of one leaf that no later in-place update reaches."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        return leaf.cpu() if leaf.is_cuda else leaf.clone()
    return np.array(leaf, copy=True)


class AsyncCheckpointer:
    """Non-blocking checkpoint writer (one background thread; the snapshot
    is taken synchronously on `submit`).  With `ranks` and `cfg`, every
    rank submits its shard (collectively): rank 0 writes the headers
    before `submit` returns, each rank's thread writes its blocks, and the
    manifest is written once every rank's writes are done, at the next
    `submit` or at `wait` (both collective then).  A write that failed on
    any rank raises there on every rank, and no manifest is written."""

    def __init__(self, ranks=None, cfg=None) -> None:
        self.ranks, self.cfg = ranks, cfg
        self._manifest: Optional[tuple] = None
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                item()
            except BaseException as e:  # noqa: BLE001
                self._err = e
            finally:
                self._q.task_done()

    def submit(self, directory: str, tree, *,
               extra: Optional[dict] = None) -> None:
        if self.ranks is None and self._err:
            raise self._err
        host = {k: _snapshot(v) for k, v in _flatten_with_paths(tree).items()}
        if self.ranks is None:
            self._q.put(lambda: save_checkpoint(directory, host, extra=extra))
            return
        self._finish()
        plan = _rank_plan(host, self.cfg, self.ranks)
        head = self.ranks.rank == 0
        _all_or_none(lambda: head and _write_headers(directory, plan))
        lay, rank = self.ranks.layout, self.ranks.rank
        self._q.put(lambda: _write_blocks(directory, plan, host, lay, rank))
        self._manifest = (directory, plan, extra)

    def _finish(self) -> None:
        """At ranks: once every rank's blocks are written, and only if all
        of them were, rank 0 writes the pending manifest."""
        self._q.join()
        pending, self._manifest = self._manifest, None
        err, self._err = self._err, None

        def written() -> None:
            if err is not None:
                raise err

        _all_or_none(written)
        if pending is not None:
            head = self.ranks.rank == 0
            _all_or_none(lambda: head and _write_manifest(*pending))

    def wait(self) -> None:
        if self.ranks is not None:
            self._finish()
        self._q.join()
        if self._err:
            raise self._err

    def close(self) -> None:
        self._q.put(None)
        self._t.join()
