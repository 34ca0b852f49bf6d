"""Checkpointing: manifest + per-leaf .npy files + step management — the
port of the JAX package's ``checkpoint/store.py``, with the same layout:

    <dir>/step_00000100/MANIFEST.json     tree structure + leaf metadata
    <dir>/step_00000100/<leaf>.npy        one array per tree leaf
    <dir>/step_00000100/data_state.npz    data-pipeline position
    <dir>/LATEST                          atomic pointer to the newest step

Leaf names are the JAX ``keystr`` names of the same dict/list tree
(``repro_torch.tree``), bf16 leaves are stored as a uint16 view, and the
manifest's dtype names are numpy's, so a checkpoint written by either
package restores in the other.  Writes go to a temp dir and are renamed
into place, so a crash mid-save never corrupts the LATEST checkpoint.
``keep`` bounds disk use.

A leaf too large to hold whole where it is saved (a parameter sharded
over ranks) goes in as a :class:`Streamed` leaf, written slice by slice
into its file; ``restore(..., select=)`` reads each leaf's block alone.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.tree import leaves_with_path

_LEAF_RE = re.compile(r"[^\w.-]+")

_NP_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
             torch.float16: "float16", torch.int32: "int32",
             torch.int64: "int64", torch.bool: "bool"}


def _leaf_name(path: str) -> str:
    return _LEAF_RE.sub("_", path).strip("_")


def _to_numpy(leaf):
    """(array to write, manifest dtype name) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:       # numpy has no bfloat16
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), _NP_NAMES[t.dtype]
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


@dataclass(frozen=True)
class Streamed:
    """A leaf saved in slices: the whole leaf's ``shape`` and ``dtype``,
    and ``parts()``, an iterator of ``(index, tensor)`` pairs that tile
    it (``index`` a tuple of slices into the whole leaf)."""
    shape: tuple
    dtype: torch.dtype
    parts: Callable[[], Iterator[tuple]]


def _write_streamed(file: str, leaf: Streamed) -> tuple:
    """Write ``leaf`` into an .npy file slice by slice; returns (shape,
    manifest dtype name)."""
    bf16 = leaf.dtype == torch.bfloat16
    np_dtype = np.uint16 if bf16 else np.dtype(_NP_NAMES[leaf.dtype])
    out = np.lib.format.open_memmap(file, mode="w+", dtype=np_dtype,
                                    shape=tuple(leaf.shape))
    for index, part in leaf.parts():
        out[index] = _to_numpy(part.to(leaf.dtype))[0]
    out.flush()
    del out
    return tuple(leaf.shape), "bfloat16" if bf16 else _NP_NAMES[leaf.dtype]


def save(directory: str, step: int, tree, data_state: Optional[dict] = None,
         keep: int = 3) -> str:
    """Save a tree checkpoint; returns the checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:08d}"
    final = os.path.join(directory, name)
    flat = leaves_with_path(tree)
    tmp = tempfile.mkdtemp(dir=directory, prefix=f".{name}.tmp")
    try:
        manifest = {"step": step, "treedef": None, "leaves": []}
        names = []
        for path, leaf in flat:
            nm = _leaf_name(path)
            if nm in names:
                raise ValueError(f"leaf name collision: {nm}")
            names.append(nm)
            file = os.path.join(tmp, nm + ".npy")
            if isinstance(leaf, Streamed):
                shape, dtype_name = _write_streamed(file, leaf)
            else:
                arr, dtype_name = _to_numpy(leaf)
                np.save(file, arr)
                shape = arr.shape
            manifest["leaves"].append(
                {"name": nm, "shape": list(shape), "dtype": dtype_name})
        manifest["treedef"] = names
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if data_state is not None:
            np.savez(os.path.join(tmp, "data_state.npz"), **data_state)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _write_latest(directory, name)
    _gc(directory, keep)
    return final


def _write_latest(directory: str, name: str):
    tmp = os.path.join(directory, ".LATEST.tmp")
    with open(tmp, "w") as f:
        f.write(name)
    os.rename(tmp, os.path.join(directory, "LATEST"))


def _gc(directory: str, keep: int):
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    try:
        with open(os.path.join(directory, "LATEST")) as f:
            return int(f.read().strip().split("_")[1])
    except (FileNotFoundError, IndexError, ValueError):
        return None


def restore(directory: str, tree_like, step: Optional[int] = None,
            select: Optional[Callable] = None):
    """Restore into ``tree_like``'s tensors, in place: each stored leaf is
    copied into the tensor of the same path, converted to its dtype on its
    device, so a restore holds no second copy of the state where it
    lands.  ``select(path, whole)`` (optional) returns the block of a
    whole leaf (a view of its mapped file) to restore: only that block is
    read.  A leaf (or block) whose shape is not its tensor's raises.
    Returns (tree, data_state | None): ``tree_like`` itself, filled."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    flat = leaves_with_path(tree_like)
    names = [_leaf_name(p) for p, _ in flat]
    if names != manifest["treedef"]:
        raise ValueError(
            "checkpoint tree mismatch:\n"
            f"  want {names[:5]}...\n  have {manifest['treedef'][:5]}...")
    stored_dtype = {leaf["name"]: leaf["dtype"]
                    for leaf in manifest["leaves"]}
    for (p, like), nm in zip(flat, names):
        arr = np.load(os.path.join(path, nm + ".npy"),
                      mmap_mode=None if select is None else "c")
        if stored_dtype.get(nm) == "bfloat16":   # stored as a uint16 view
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if select is not None:
            t = select(p, t)
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf {p}: "
                             f"{'block' if select else 'leaf'} "
                             f"{tuple(t.shape)}, want {tuple(like.shape)}")
        like.copy_(t)
        del t, arr
    tree = tree_like
    ds_path = os.path.join(path, "data_state.npz")
    data_state = dict(np.load(ds_path, allow_pickle=False)) \
        if os.path.exists(ds_path) else None
    return tree, data_state
