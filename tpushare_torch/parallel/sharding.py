"""Spec trees and per-rank slices of parameter trees. Counterpart of
``tpushare/parallel/sharding.py``.

A spec is a ``P``: a tuple with one entry per dimension of the leaf it
places, each None (replicated), a canonical axis name, or a tuple of
axis names (the dimension splits over their product, the first name
outermost), as ``jax.sharding.PartitionSpec`` reads. A spec tree mirrors
a parameter tree: dicts down to ``P`` leaves. A spec shorter than its
leaf replicates the trailing dimensions.

``shard_tree`` cuts a whole tree into one rank's slices: each sharded
dimension keeps the contiguous block at the rank's coordinate, and every
slice is a contiguous tensor of its own (the kernels refuse views).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch


class P(tuple):
    """A partition spec: ``P(None, "tp")``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def replicated(spec: P) -> bool:
    """True when ``spec`` splits no dimension."""
    return all(not _axes(e) for e in spec)


def _split(entry, sizes: Mapping[str, int],
           coords: Optional[Mapping[str, int]]) -> Tuple[int, int]:
    """(parts, index) of one dimension's entry."""
    parts, idx = 1, 0
    for ax in _axes(entry):
        n = int(sizes.get(ax, 1))
        parts *= n
        idx = idx * n + (int(coords.get(ax, 0)) if coords else 0)
    return parts, idx


def local_shape(shape: Sequence[int], spec: P,
                sizes: Mapping[str, int]) -> Tuple[int, ...]:
    """The per-rank shape of a leaf of ``shape`` placed by ``spec`` on a
    mesh of axis ``sizes``. A dimension its axes do not divide
    raises."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec!r} has more entries than the leaf "
                         f"has dimensions {tuple(shape)}")
    out = list(shape)
    for d, entry in enumerate(spec):
        parts, _ = _split(entry, sizes, None)
        if out[d] % parts:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                             f"split over {_axes(entry)} ({parts} parts)")
        out[d] //= parts
    return tuple(out)


def shard_leaf(leaf: torch.Tensor, spec: P, sizes: Mapping[str, int],
               coords: Mapping[str, int],
               device=None) -> torch.Tensor:
    """This rank's contiguous slice of ``leaf`` (on ``device``). A
    checkpoint's lazy leaf (``checkpoint.LazyLeaf``) reads only that
    slice."""
    if hasattr(leaf, "read_slice"):
        return leaf.read_slice(spec, sizes, coords, device).contiguous()
    local = local_shape(leaf.shape, spec, sizes)
    out = leaf
    for d, entry in enumerate(spec):
        parts, idx = _split(entry, sizes, coords)
        if parts > 1:
            out = out.narrow(d, idx * local[d], local[d])
    return out.to(device=device if device is not None else leaf.device
                  ).contiguous()


def _walk(tree, specs, fn, path=""):
    if isinstance(tree, Mapping):
        if not isinstance(specs, Mapping):
            raise ValueError(f"spec tree has a leaf where the params "
                             f"have a subtree at {path or '/'}")
        missing = set(tree) - set(specs)
        if missing:
            raise ValueError(f"spec tree lacks {sorted(missing)} under "
                             f"{path or '/'}")
        return {k: _walk(v, specs[k], fn, f"{path}/{k}")
                for k, v in tree.items()}
    if specs is None:
        specs = P()
    if not isinstance(specs, tuple):
        raise ValueError(f"no spec leaf at {path}: {specs!r}")
    return fn(tree, specs, path)


def shard_tree(tree, specs, mesh, device=None) -> Dict[str, Any]:
    """This rank's slices of every leaf of ``tree`` placed per the spec
    tree ``specs`` on ``mesh``: a ``ServingMesh`` (its ``device`` when
    ``device`` is None) or a training ``DeviceMesh`` (each leaf's own
    device when ``device`` is None). Replicated leaves are placed
    whole."""
    from tpushare_torch.parallel.mesh import mesh_layout
    sizes, coords = mesh_layout(mesh)
    dev = getattr(mesh, "device", None) if device is None else device
    return _walk(tree, specs,
                 lambda leaf, spec, _p: shard_leaf(leaf, spec, sizes,
                                                   coords, dev))


def spec_axes(spec: P) -> Tuple[str, ...]:
    """Every axis ``spec`` splits a dimension over."""
    return tuple(ax for e in spec for ax in _axes(e))


def walk_specs(tree, specs, fn):
    """``fn(leaf, spec)`` over the leaves of ``tree`` and their specs
    (a missing spec subtree: replicated), as a tree of the results."""
    return _walk(tree, specs, lambda leaf, spec, _p: fn(leaf, spec))


def replicated_specs(tree):
    """A spec tree placing every leaf of ``tree`` whole: for a tree whose
    leaves are already one rank's slices."""
    if isinstance(tree, Mapping):
        return {k: replicated_specs(v) for k, v in tree.items()}
    return P()
