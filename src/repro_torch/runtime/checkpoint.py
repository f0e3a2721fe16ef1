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
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models.transformer import TransformerParams, is_node

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


def _load_leaf(directory: str, info: dict) -> torch.Tensor:
    arr = np.load(os.path.join(directory, info["file"]))
    if info["dtype"] == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore_checkpoint(directory: str, target_tree, *,
                       device: torch.device | str = "cpu"):
    """Restore into the structure of `target_tree` (its values, which may be
    meta tensors, are ignored; each leaf keeps the dtype it was saved in)
    on `device`.  Raises on a leaf the checkpoint lacks and on a shape that
    differs from the target's."""
    manifest = load_manifest(directory)
    out = {}
    for key, want in _flatten_with_paths(target_tree).items():
        info = manifest["leaves"].get(key)
        if info is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        leaf = _load_leaf(directory, info)
        shape = getattr(want, "shape", None)
        if shape is not None and tuple(shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {key!r} has shape "
                             f"{tuple(leaf.shape)}, the target "
                             f"{tuple(shape)}")
        out[key] = leaf.to(device)
    return _unflatten(target_tree, out)


def _snapshot(leaf):
    """A host copy of one leaf that no later in-place update reaches."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        return leaf.cpu() if leaf.is_cuda else leaf.clone()
    return np.array(leaf, copy=True)


class AsyncCheckpointer:
    """Non-blocking checkpoint writer (one background thread; the snapshot
    is taken synchronously on `submit`)."""

    def __init__(self) -> None:
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            directory, host_tree, extra = item
            try:
                save_checkpoint(directory, host_tree, extra=extra)
            except BaseException as e:  # noqa: BLE001
                self._err = e
            finally:
                self._q.task_done()

    def submit(self, directory: str, tree, *,
               extra: Optional[dict] = None) -> None:
        if self._err:
            raise self._err
        host = {k: _snapshot(v) for k, v in _flatten_with_paths(tree).items()}
        self._q.put((directory, host, extra))

    def wait(self) -> None:
        self._q.join()
        if self._err:
            raise self._err

    def close(self) -> None:
        self._q.put(None)
        self._t.join()
