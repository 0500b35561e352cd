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
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from tpushare_torch import DeviceLike, resolve_device
from tpushare_torch.utils import atomicio

TODO_RESHARD = ("ROADMAP A10 (multi-GPU placement) and A12 (fsdp "
                "flat-storage checkpoints)")

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


def restore(path: str, *, like: Optional[Any] = None,
            shardings: Optional[Any] = None,
            device: DeviceLike = None) -> Any:
    """Read a tree back.

    ``like``: a nested dict of tensors (or anything with ``shape`` and
    ``dtype``) fixing structure and dtypes; a key it names that the file
    lacks, or holds at another shape, raises ``ValueError``. Leaves go to
    ``device``, else to ``like``'s leaf's device, else to the card (the
    port's default device). ``shardings`` (the reference's cross-mesh
    restore) raises ``NotImplementedError``."""
    if shardings is not None:
        raise NotImplementedError(f"restore(shardings=): {TODO_RESHARD}")
    path = os.path.abspath(path)
    header, base = _read_header(path)
    if like is None:
        dev = resolve_device(device)
        skeleton = json.loads(header["__metadata__"]["tree"])

        def build(node, prefix):
            return {k: build(v, f"{prefix}{k}{_SEP}") if isinstance(v, dict)
                    else _read_leaf(f, base, header[prefix + k], dev, None)
                    for k, v in node.items()}
        with open(path, "rb") as f:
            return build(skeleton, "")

    wanted = list(key_paths(like))
    problems = []
    for key, ref in wanted:
        info = header.get(key)
        if info is None:
            problems.append(f"{key}: missing")
        elif list(info["shape"]) != list(ref.shape):
            problems.append(f"{key}: shape {info['shape']} in the file, "
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
            node[parts[-1]] = _read_leaf(f, base, header[key], dev, dtype)
    return out
