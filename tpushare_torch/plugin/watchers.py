"""Filesystem and signal watchers for the daemon's event loop: the port's
copy of ``tpushare/plugin/watchers.py``. ``FSWatcher`` is Linux
inotify(7) through ctypes (the daemon needs CREATE events on one
directory: the kubelet's recreated ``kubelet.sock``, the reference's
gpumanager.go:84-87); ``OSWatcher`` queues signals.
"""

from __future__ import annotations

import collections
import ctypes
import ctypes.util
import logging
import os
import queue
import select
import signal
import struct
import threading
import time
from dataclasses import dataclass
from typing import Optional

log = logging.getLogger("tpushare.watchers")

IN_CREATE = 0x00000100
IN_DELETE = 0x00000200
IN_MOVED_TO = 0x00000080
IN_NONBLOCK = 0o4000

_EVENT_HDR = struct.Struct("iIII")  # wd, mask, cookie, len


@dataclass(frozen=True)
class FSEvent:
    name: str   # full path of the file the event is about
    mask: int

    @property
    def is_create(self) -> bool:
        return bool(self.mask & (IN_CREATE | IN_MOVED_TO))


class FSWatcher:
    """inotify watcher on one or more directories; events arrive on
    ``self.events`` (a queue.Queue of FSEvent)."""

    def __init__(self, *paths: str):
        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6",
                           use_errno=True)
        self._libc = libc
        self._fd = libc.inotify_init1(IN_NONBLOCK)
        if self._fd < 0:
            raise OSError(ctypes.get_errno(), "inotify_init1 failed")
        self._wd_to_path = {}
        for p in paths:
            wd = libc.inotify_add_watch(
                self._fd, p.encode(), IN_CREATE | IN_DELETE | IN_MOVED_TO)
            if wd < 0:
                os.close(self._fd)
                raise OSError(ctypes.get_errno(), f"inotify_add_watch({p}) failed")
            self._wd_to_path[wd] = p
        self.events: "queue.Queue[FSEvent]" = queue.Queue()
        self.broken = False
        self._stop_r, self._stop_w = os.pipe()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tpushare-fswatch")
        self._thread.start()

    def _loop(self) -> None:
        while True:
            ready, _, _ = select.select([self._fd, self._stop_r], [], [])
            if self._stop_r in ready:
                return
            try:
                data = os.read(self._fd, 4096)
            except BlockingIOError:
                continue
            except OSError as e:
                # Never die silently: this thread feeds the load-bearing
                # kubelet.sock re-register path (gpumanager.go:84-87).
                log.error("inotify read failed (%s); fs watch degraded", e)
                self.broken = True
                return
            off = 0
            while off + _EVENT_HDR.size <= len(data):
                wd, mask, _cookie, nlen = _EVENT_HDR.unpack_from(data, off)
                off += _EVENT_HDR.size
                name = data[off:off + nlen].split(b"\0")[0].decode()
                off += nlen
                base = self._wd_to_path.get(wd, "")
                self.events.put(FSEvent(name=os.path.join(base, name), mask=mask))

    def close(self) -> None:
        os.write(self._stop_w, b"x")
        self._thread.join(timeout=2)
        for fd in (self._fd, self._stop_r, self._stop_w):
            try:
                os.close(fd)
            except OSError:
                pass


class OSWatcher:
    """Buffered signal channel (reference: newOSWatcher, watchers.go:27-32).
    Must be constructed on the main thread. Uses a deque (atomic
    append/popleft) instead of queue.Queue — a Queue's mutex can
    deadlock when the handler interrupts a get() holding the same lock
    on the main thread."""

    def __init__(self, *sigs: int):
        self.signals: "collections.deque[int]" = collections.deque()
        for s in sigs:
            signal.signal(s, self._handler)

    def _handler(self, signum: int, _frame) -> None:
        self.signals.append(signum)  # async-signal-safe: atomic, lock-free

    def get(self, timeout: Optional[float] = None) -> Optional[int]:
        deadline = time.monotonic() + (timeout or 0)
        while True:
            try:
                return self.signals.popleft()
            except IndexError:
                if timeout is None or time.monotonic() >= deadline:
                    return None
                time.sleep(min(0.05, max(0.0, deadline - time.monotonic())))
