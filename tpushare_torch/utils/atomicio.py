"""The port's copy of ``tpushare/utils/atomicio.py`` (stdlib only; a test holds it
equal to the original).

Atomic persistent writes: write-tmp -> fsync -> rename.

Every file a tpushare process re-reads across a process boundary — the
durable journal's checkpoint meta, the analysis baseline ratchet, the
ParamStore checkpoint metadata — must never be observable half-written:
a SIGKILL between ``open(path, "w")`` and the final ``flush`` leaves a
torn file that poisons the NEXT process's read (the exact class of
failure the crash-only serving work exists to remove). This module is
the ONE home of the safe pattern:

1. write the full payload to ``<path>.tmp.<pid>`` in the same
   directory (same filesystem, so the rename is atomic);
2. ``flush`` + ``os.fsync`` the tmp file (the data is durable before
   it becomes visible);
3. ``os.replace`` onto the destination (atomic on POSIX — readers see
   the old complete file or the new complete file, never a mix);
4. best-effort fsync of the containing directory (the rename itself
   is durable across power loss, not just process death).

Append-only logs are deliberately OUT of scope: the durable journal's
segments are crash-consistent by construction (length-prefix + CRC
framing; a torn tail record is discarded on replay), so they append
with ``"ab"`` and fsync in place. The analysis rule RL403 polices
exactly this split: ``open(..., "w")`` in a persistence module is a
finding; ``"ab"`` appends and reads are not.

stdlib-only: the analysis baseline writer (a jax-free process) and the
plugin-side consumers import this without dragging in a runtime.
"""

from __future__ import annotations

import json
import os
from typing import Any


def fsync_dir(path: str) -> None:
    """Best-effort fsync of a directory (makes a rename durable).
    Platforms/filesystems that refuse directory fds are tolerated —
    the rename is still atomic, just not power-loss-durable."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_bytes(path: str, data: bytes) -> None:
    """Atomically replace ``path`` with ``data`` (tmp -> fsync ->
    rename -> dir fsync). The tmp file is removed on failure, so a
    crashed writer never litters the directory with partials that a
    naive glob would pick up."""
    path = os.fspath(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    fsync_dir(os.path.dirname(path) or ".")


def write_text(path: str, text: str, encoding: str = "utf-8") -> None:
    write_bytes(path, text.encode(encoding))


def write_json(path: str, obj: Any, *, indent: int = 1,
               sort_keys: bool = False) -> None:
    """Atomic JSON write with a trailing newline (the checked-in-file
    convention the baseline ratchet already follows)."""
    write_text(path, json.dumps(obj, indent=indent,
                                sort_keys=sort_keys) + "\n")
