"""Weights made on the device from ``--seed``, in a few large calls.

The layout is the benchmark's own list of leaves (``layout``), written
by the configuration's family file from its widths; it is the port's
parameter tree (layers stacked on dim 0), so the program takes it as it
is (``tree``) and the reference reads the same leaves by path.  Every
matrix is a view into one buffer drawn by one ``randn`` call in the
dtype it is used in; a leaf of special init takes one ``rand`` call.
The same seed gives the same bits, so the reference draws the weights
again instead of keeping a copy beside the program's.
"""
from __future__ import annotations

import math

import torch

from harness.spec import family

#: leaves start at multiples of this many elements (aligned views)
_ALIGN = 128


def layout(config: dict) -> list:
    """``[(path, shape, init, arg)]`` of the configuration's leaves, from
    its family file (``families/<family>.py``).  ``init``: ``normal``
    (``arg`` the scale), ``ones``, ``zeros``, or ``rand`` (``arg`` maps a
    uniform draw on [0, 1) to the leaf)."""
    return family(config).leaves(config)


def make(config: dict, seed: int, device, dtype: torch.dtype) -> dict:
    """``{path: tensor}``: matrices in ``dtype`` (drawn in it), norm
    scales and ``rand`` leaves in float32 (the port reads them in f32).  One ``randn`` for all matrices, one ``rand`` a
    special leaf, in the order of :func:`layout`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2**63 - 1))
    leaves = layout(config)
    normal = [(p, sh, sc) for p, sh, kind, sc in leaves if kind == "normal"]
    sizes = [-(-math.prod(sh) // _ALIGN) * _ALIGN for _, sh, _ in normal]
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    out = {}
    at = 0
    for (path, shape, scale), n in zip(normal, sizes):
        out[path] = flat[at:at + math.prod(shape)].view(shape).mul_(scale)
        at += n
    f32 = torch.float32
    for path, shape, kind, arg in leaves:
        if kind == "ones":
            out[path] = torch.ones(shape, dtype=f32, device=device)
        elif kind == "zeros":
            out[path] = torch.zeros(shape, dtype=dtype, device=device)
        elif kind == "rand":
            out[path] = arg(torch.rand(shape, generator=gen, device=device,
                                       dtype=f32))
    return {p: out[p] for p, *_ in leaves}


def tree(flat: dict) -> dict:
    """The nested tree of ``{path: tensor}`` (a numeric part is a list
    index), as the port's models take their parameters."""
    root: dict = {}
    for path, t in flat.items():
        parts = path.split(".")
        node = root
        for i, part in enumerate(parts[:-1]):
            nxt = parts[i + 1]
            key = int(part) if part.isdigit() else part
            if isinstance(node, list):
                while len(node) <= key:
                    node.append({})
                node = node[key]
            else:
                node = node.setdefault(key, [] if nxt.isdigit() else {})
        node[parts[-1]] = t
    return root


def nbytes(flat: dict) -> int:
    return sum(t.numel() * t.element_size() for t in flat.values())
