"""A served model's weights, made by the benchmark from ``--seed``.

The benchmark makes the weights and hands the same to the program and,
after the program's state is freed, makes them again for the plain
reference: the reference never reads what the program holds.  The layout
is the program's parameter tree (nested dicts and tuples of tensors), given
as a template of shapes and dtypes (:func:`template`), so the same maker
serves every configuration.

Each leaf is drawn on the device, in the dtype it is served in, in one
call: a matrix (two or more dims in one layer) from ``normal(0, std)``, a
norm scale or a vector zero (the program's norms multiply by ``1 +
scale``).  One ``torch.Generator`` on the device, seeded with the run's
seed, draws the leaves in the tree's order, so the same seed gives the
same weights bit for bit on the same device.  Nothing here imports the
program.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Leaf:
    """A template leaf: its shape, served dtype and dims in one layer."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    dims: int


def template(abstract, compute_dtype: torch.dtype, stacked_keys=("blocks",)):
    """The served layout of an abstract (``meta``) parameter tree: float32
    leaves of two or more dims are served in ``compute_dtype``, the rest in
    their own dtype (the program's cast rule).  A leaf under one of
    ``stacked_keys`` carries a leading stacking dim, not counted among its
    layer dims."""
    def walk(node, stacked):
        if isinstance(node, dict):
            return {k: walk(v, stacked or k in stacked_keys) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(walk(v, stacked) for v in node)
        dtype = compute_dtype if node.dtype == torch.float32 and node.dim() >= 2 else node.dtype
        return Leaf(tuple(node.shape), dtype, node.dim() - int(stacked))

    return walk(abstract, False)


def leaves(tree, path=()) -> Iterator[Tuple[tuple, object]]:
    """``(path, leaf)`` of a tree in its order."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from leaves(value, path + (key,))
    elif isinstance(tree, (tuple, list)):
        for i, value in enumerate(tree):
            yield from leaves(value, path + (i,))
    else:
        yield path, tree


def make(layout, seed: int, device, std: float):
    """The weights of ``layout`` (a :func:`template`) from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 64))

    def draw(path, leaf: Leaf):
        out = torch.empty(leaf.shape, dtype=leaf.dtype, device=device)
        if path[-1] == "scale" or leaf.dims < 2:
            return out.zero_()
        return out.normal_(0.0, std, generator=gen)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(walk(v, path + (i,)) for i, v in enumerate(node))
        return draw(path, node)

    return walk(layout, ())


def round_through(weights, dtype: torch.dtype) -> None:
    """Round every matrix of ``weights`` in place through ``dtype`` (an 8-bit
    float): each slice along the leading dim scaled by its largest
    magnitude onto the format's range, rounded, scaled back (a float32
    copy of at most 2**28 elements at a time)."""
    top = torch.finfo(dtype).max
    for _, leaf in leaves(weights):
        if leaf.dim() < 2 or not leaf.is_floating_point():
            continue
        rows = max(1, (1 << 28) // max(1, leaf[0].numel()))
        for part in leaf.split(rows, 0):
            f = part.float()
            scale = f.abs().amax(dim=tuple(range(1, f.dim())), keepdim=True).clamp_min(1e-30) / top
            part.copy_((f / scale).to(dtype).float() * scale)
