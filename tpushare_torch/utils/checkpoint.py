"""Workload checkpoint/resume in the safetensors format, written and read
by the port's own code. Counterpart of ``tpushare/utils/checkpoint.py``
(orbax there).

The plugin itself keeps no checkpoint: its durable truth lives in the
cluster (pod annotations, node status). Checkpoints belong to the
workloads it schedules: a tenant pod that is rescheduled or preempted
resumes its params and optimizer state from here.

File layout (the safetensors format): an 8-byte little-endian header
length N, N bytes of JSON header, then the raw little-endian bytes of
every tensor, one after another. The header maps each leaf's key path
(its dict keys joined by ``/``) to ``{"dtype", "shape",
"data_offsets": [begin, end]}`` (offsets into the bytes after the
header), and its ``__metadata__`` holds the tree's nesting as a JSON
string under ``"tree"`` (empty dicts included, so ``{}`` optimizer
states round-trip). The header is padded with spaces to a multiple of
8 bytes. Nothing here imports the ``safetensors`` package; a file
written here is one ``safetensors.torch.load_file`` reads.

``save`` streams the leaves into ``<path>.tmp.<pid>``, fsyncs it and
renames it into place (``utils/atomicio.py``'s pattern; its directory
fsync), so a reader never sees a torn checkpoint. ``restore`` reads a
leaf at a time.

Cross-mesh restore (the reference's ``restore(shardings=)``) reads one
rank's slice of each leaf of a tree saved whole:

- ``MeshShard`` (tp / ep serving placement, ``parallel/sharding.py``
  spec trees; ``mesh_shardings`` builds the tree for a mesh's rank): the
  contiguous block at the rank's coordinates, read by offset through a
  memory map, so only the slice's bytes are read and no rank holds the
  whole leaf;
- ``FlatShard`` (fsdp flat storage): a checkpoint of fsdp state holds
  the global flat leaves (``training.fsdp_stream_shard_params``' bytes,
  or the plain ``fsdp_shard_params`` layout), read at any fsdp size (the
  leaf is cut to its unpadded elements, padded for the new size and
  sliced).

``lazy_tree`` returns a tree of ``LazyLeaf`` handles instead of tensors:
``sharding.shard_leaf`` reads each one's slice for the rank placing it
(the reshard checkpoint of ``models/reshard.py`` ``ParamStore``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from tpushare_torch import DeviceLike, resolve_device
from tpushare_torch.utils import atomicio


@dataclasses.dataclass(frozen=True)
class FlatShard:
    """How ``restore(shardings=)`` reads one global flat fsdp leaf: as
    slice ``index`` of ``n_shards``. ``numel``: the unpadded elements
    (per row with ``rows``). ``rows``: a streaming layer stack [L, F*c]
    (L rows, each cut and sliced) -> [L, c]; else [F*c] -> [c], or with
    ``stacked`` (the plain layout [F, c]) -> [1, c]."""
    numel: int
    n_shards: int
    index: int
    rows: Optional[int] = None
    stacked: bool = False

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the stored global leaf ``t``."""
        lead = self.rows or 1
        if t.numel() < lead * self.numel:
            raise ValueError(f"flat leaf of {t.numel()} elements holds no "
                             f"{lead} x {self.numel}")
        data = t.reshape(lead, -1)[:, :self.numel]
        c = -(-self.numel // self.n_shards)
        data = torch.nn.functional.pad(
            data, (0, self.n_shards * c - self.numel))
        part = data[:, self.index * c:(self.index + 1) * c].contiguous()
        if self.rows:
            return part
        return part.reshape(1, c) if self.stacked else part.reshape(c)

    def shape(self) -> List[int]:
        c = -(-self.numel // self.n_shards)
        return [self.rows, c] if self.rows else (
            [1, c] if self.stacked else [c])


@dataclasses.dataclass(frozen=True)
class MeshShard:
    """How ``restore(shardings=)`` reads one leaf placed by ``spec`` (a
    ``sharding.P``) on a serving mesh of axis ``sizes``: the contiguous
    block at the rank's ``coords`` (both as (axis, value) pairs)."""
    spec: Tuple[Any, ...]
    sizes: Tuple[Tuple[str, int], ...]
    coords: Tuple[Tuple[str, int], ...]

    def shape(self, full: List[int]) -> List[int]:
        from tpushare_torch.parallel.sharding import local_shape
        return list(local_shape(full, self.spec, dict(self.sizes)))


def mesh_shardings(specs: Any, mesh) -> Any:
    """The ``restore(shardings=)`` tree of ``mesh``'s rank for a spec
    tree (``transformer.param_specs`` and its kin)."""
    sizes = tuple(sorted(mesh.sizes.items()))
    coords = tuple(sorted(mesh.coords(mesh.rank or 0).items()))
    if isinstance(specs, Mapping):
        return {k: mesh_shardings(v, mesh) for k, v in specs.items()}
    return MeshShard(tuple(specs or ()), sizes, coords)


def _shard_at(shardings: Any, parts: List[str]):
    """The FlatShard, MeshShard or None that ``shardings`` gives the
    leaf at key path ``parts``: a None subtree reads its leaves whole;
    anything else is no placement of the port (``NotImplementedError``,
    naming the two it has)."""
    node = shardings
    for p in parts:
        if node is None or isinstance(node, (FlatShard, MeshShard)):
            break
        if not isinstance(node, dict):
            break
        node = node.get(p)
    if node is None or isinstance(node, (FlatShard, MeshShard)):
        return node
    raise NotImplementedError(
        f"restore(shardings=) with {type(node).__name__} at "
        f"{_SEP.join(parts)}: the port's placements are FlatShard (fsdp "
        f"flat storage, ROADMAP A10a) and MeshShard (tp / ep serving "
        f"slices), or None")


# safetensors dtype names <-> torch dtypes.
_DTYPES = {torch.bfloat16: "BF16", torch.float16: "F16",
           torch.float32: "F32", torch.float64: "F64", torch.int8: "I8",
           torch.uint8: "U8", torch.int16: "I16", torch.int32: "I32",
           torch.int64: "I64", torch.bool: "BOOL"}
_FROM_NAME = {v: k for k, v in _DTYPES.items()}
_SEP = "/"
_CHUNK = 256 << 20            # bytes copied to the host per write


def key_paths(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(key path, leaf) in sorted-key order; a leaf is anything that is
    not a dict."""
    for key in sorted(tree):
        if _SEP in key:
            raise ValueError(f"checkpoint keys may not contain {_SEP!r}: "
                             f"{key!r}")
        val = tree[key]
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from key_paths(val, path + _SEP)
        else:
            yield path, val


def _skeleton(tree: Any) -> Any:
    """The nesting with every leaf replaced by None."""
    return {k: _skeleton(v) if isinstance(v, dict) else None
            for k, v in tree.items()}


def _as_tensor(leaf: Any) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    return torch.as_tensor(np.asarray(leaf))


def _header(entries: List[Tuple[str, torch.Tensor]], skeleton) -> bytes:
    header: Dict[str, Any] = {"__metadata__": {"tree": json.dumps(skeleton)}}
    off = 0
    for key, t in entries:
        if t.dtype not in _DTYPES:
            raise ValueError(f"{key}: no safetensors dtype for {t.dtype}")
        n = t.numel() * t.element_size()
        header[key] = {"dtype": _DTYPES[t.dtype], "shape": list(t.shape),
                       "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    return raw + b" " * (-len(raw) % 8)


def _write_leaf(f, t: torch.Tensor) -> None:
    """Write a tensor's bytes (little-endian, row-major), copying at most
    ``_CHUNK`` bytes to the host at a time."""
    flat = t.contiguous().reshape(-1)
    if flat.dtype == torch.bool:
        flat = flat.to(torch.uint8)
    per = max(1, _CHUNK // max(1, flat.element_size()))
    for i in range(0, flat.numel(), per):
        part = flat[i:i + per].cpu().view(torch.uint8)
        f.write(memoryview(part.numpy()))


def save(path: str, tree: Any, *, overwrite: bool = True) -> int:
    """Write a nested dict of tensors (params, optimizer state, 0-d
    leaves such as ``step``) to the file ``path``. An existing ``path``
    is replaced when ``overwrite``, else ``ValueError`` (the reference's
    orbax refusal). Returns the file's size in bytes."""
    path = os.path.abspath(path)
    if os.path.exists(path) and not overwrite:
        raise ValueError(f"Destination {path} already exists.")
    entries = [(k, _as_tensor(v)) for k, v in key_paths(tree)]
    header = _header(entries, _skeleton(tree))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(struct.pack("<Q", len(header)))
            f.write(header)
            for _, t in entries:
                _write_leaf(f, t)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    atomicio.fsync_dir(os.path.dirname(path))
    return os.path.getsize(path)


def _read_header(path: str) -> Tuple[Dict[str, Any], int]:
    """(header dict, offset of the first tensor byte) of a checkpoint."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    return header, 8 + n


def _read_leaf(f, base: int, info: Dict[str, Any], device: torch.device,
               dtype: Optional[torch.dtype]) -> torch.Tensor:
    begin, end = info["data_offsets"]
    stored = _FROM_NAME[info["dtype"]]
    f.seek(base + begin)
    raw = torch.empty(end - begin, dtype=torch.uint8)
    if end > begin:
        f.readinto(memoryview(raw.numpy()))
    if stored == torch.bool:
        t = raw.to(torch.bool)
    else:
        t = raw.view(stored)
    t = t.reshape(info["shape"])
    return t.to(device=device, dtype=dtype or stored)


_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _read_block(path: str, base: int, info: Dict[str, Any],
                spec: Any, sizes: Mapping[str, int],
                coords: Mapping[str, int], device: torch.device,
                dtype: Optional[torch.dtype]) -> torch.Tensor:
    """The contiguous block of one stored leaf that ``spec`` places at
    ``coords``, read by offset: a memory map of the leaf's bytes, of
    which only the block's pages are touched."""
    from tpushare_torch.parallel.sharding import _split, local_shape
    shape = list(info["shape"])
    stored = _FROM_NAME[info["dtype"]]
    local = local_shape(shape, spec, sizes)
    if not shape or 0 in shape or list(local) == shape:
        with open(path, "rb") as f:
            return _read_leaf(f, base, info, device, dtype)
    begin, _ = info["data_offsets"]
    size = torch.empty(0, dtype=stored).element_size()
    mm = np.memmap(path, dtype=_UINT[size], mode="r",
                   offset=base + begin, shape=tuple(shape))
    index = []
    for d in range(len(shape)):
        if d < len(spec):
            parts, idx = _split(spec[d], sizes, coords)
        else:
            parts, idx = 1, 0
        index.append(slice(idx * local[d], (idx + 1) * local[d])
                     if parts > 1 else slice(None))
    block = torch.from_numpy(np.ascontiguousarray(mm[tuple(index)]))
    del mm
    t = block.to(torch.bool) if stored == torch.bool else block.view(stored)
    return t.to(device=device, dtype=dtype or stored)


class LazyLeaf:
    """One stored leaf, unread: ``shape`` and ``dtype`` come from the
    header, ``read_slice`` reads the block a spec places at a rank's
    coordinates (``sharding.shard_leaf`` calls it), ``load`` the whole
    leaf."""

    __slots__ = ("path", "base", "info")

    def __init__(self, path: str, base: int, info: Dict[str, Any]):
        self.path, self.base, self.info = path, base, info

    @property
    def shape(self) -> torch.Size:
        return torch.Size(self.info["shape"])

    @property
    def dtype(self) -> torch.dtype:
        return _FROM_NAME[self.info["dtype"]]

    @property
    def device(self) -> torch.device:
        return torch.device("cpu")

    def read_slice(self, spec, sizes, coords, device) -> torch.Tensor:
        return _read_block(self.path, self.base, self.info, spec, sizes,
                           coords, torch.device(device or "cpu"), None)

    def load(self, device=None) -> torch.Tensor:
        with open(self.path, "rb") as f:
            return _read_leaf(f, self.base, self.info,
                              torch.device(device or "cpu"), None)


def lazy_tree(path: str) -> Any:
    """The tree of a checkpoint with every leaf a ``LazyLeaf``."""
    path = os.path.abspath(path)
    header, base = _read_header(path)
    skeleton = json.loads(header["__metadata__"]["tree"])

    def build(node, prefix):
        return {k: build(v, f"{prefix}{k}{_SEP}") if isinstance(v, dict)
                else LazyLeaf(path, base, header[prefix + k])
                for k, v in node.items()}
    return build(skeleton, "")


def restore(path: str, *, like: Optional[Any] = None,
            shardings: Optional[Any] = None,
            device: DeviceLike = None) -> Any:
    """Read a tree back.

    ``like``: a nested dict of tensors (or anything with ``shape`` and
    ``dtype``) fixing structure and dtypes; a key it names that the file
    lacks, or holds at another shape, raises ``ValueError``. Leaves go to
    ``device``, else to ``like``'s leaf's device, else to the card (the
    port's default device). ``shardings`` (the reference's cross-mesh
    restore): a tree over the same keys whose leaves are ``MeshShard``
    (read that rank's tp / ep block of a leaf saved whole, by offset),
    ``FlatShard`` (that rank's slice of a global flat fsdp leaf) or None
    (read the leaf whole); a None subtree reads whole, and ``like``
    holds the slices' shapes. Any other leaf raises
    ``NotImplementedError``."""
    path = os.path.abspath(path)
    header, base = _read_header(path)

    def read(f, key, dev, dtype):
        spec = _shard_at(shardings, key.split(_SEP))
        if spec is None:
            return _read_leaf(f, base, header[key], dev, dtype)
        if isinstance(spec, MeshShard):
            return _read_block(path, base, header[key], spec.spec,
                               dict(spec.sizes), dict(spec.coords), dev,
                               dtype)
        return spec.take(_read_leaf(f, base, header[key], torch.device(
            "cpu"), None)).to(device=dev, dtype=dtype or
                              _FROM_NAME[header[key]["dtype"]])

    if like is None:
        dev = resolve_device(device)
        skeleton = json.loads(header["__metadata__"]["tree"])

        def build(node, prefix):
            return {k: build(v, f"{prefix}{k}{_SEP}") if isinstance(v, dict)
                    else read(f, prefix + k, dev, None)
                    for k, v in node.items()}
        with open(path, "rb") as f:
            return build(skeleton, "")

    wanted = list(key_paths(like))
    problems = []
    for key, ref in wanted:
        info = header.get(key)
        spec = _shard_at(shardings, key.split(_SEP))
        if info is None:
            problems.append(f"{key}: missing")
            continue
        if spec is None:
            have = list(info["shape"])
        elif isinstance(spec, MeshShard):
            have = spec.shape(list(info["shape"]))
        else:
            have = spec.shape()
        if have != list(ref.shape):
            where = "in the file" if spec is None else "sliced"
            problems.append(f"{key}: shape {have} {where}, "
                            f"{list(ref.shape)} wanted")
    if problems:
        raise ValueError(f"checkpoint {path} does not match like: "
                         + "; ".join(problems))
    out: Dict[str, Any] = _skeleton(like)
    with open(path, "rb") as f:
        for key, ref in wanted:
            dev = (torch.device(device) if device is not None
                   else getattr(ref, "device", None) or resolve_device())
            dtype = ref.dtype if isinstance(ref.dtype, torch.dtype) else None
            node = out
            parts = key.split(_SEP)
            for p in parts[:-1]:
                node = node[p]
            node[parts[-1]] = read(f, key, dev, dtype)
    return out
