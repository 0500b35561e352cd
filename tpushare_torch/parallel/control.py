"""The control plane of sharded serving: rank 0 takes the requests, the
other ranks replay its calls.

A sharded slot server is one process per rank, each holding its slices
of the weights and KV, and each running the same server code on the same
calls: every host decision (admission, eviction, prefix chains, block
ids) then comes out equal on every rank, and the collectives inside the
forward meet. Requests reach rank 0 only, so rank 0 wraps its server in
a ``ShardedServer``: each public call that changes the server's state
(``CALLS``, and ``finalize`` of the ``PendingStep`` a ``step_async``
returned) is broadcast to the followers on the mesh's gloo control group
before rank 0 runs it — the method name and its host arguments (tensors
travel as CPU copies). Every other attribute reads rank 0's server,
which is what the engine above reads; the engine itself is unchanged.
The other ranks run ``follow(server, mesh)``, which replays the calls
in order until ``ShardedServer.stop()`` sends its stop message.

The channel (``StoreChannel``) is the mesh generation's store: message
n is the key ``m<n>`` under the generation's prefix, which rank 0 sets
and each follower waits for (the store answers the wait when the key is
set). No collective carries it, so a follower never waits on a dead
peer's group to hear from rank 0. Rank 0 ends a generation with a
``regen`` message (``retire``); a follower that hears nothing for longer
than rank 0's heartbeat also checks whether rank 0 posted the next
generation's plan (``ServingMesh.next_plan_ready``) and leaves with
``GenerationEnded``.

Faults. A call that raises on rank 0 is followed by a ``raised``
message naming the exception type; a follower checks that its replay
raised the same type (a host decision such as ``PoolExhausted`` raises
on every rank alike) and stops with ``ControlDesync`` where the ranks
part. Both sides fold every call's result into a digest (``digest``),
so a run can show every rank's stream equal to rank 0's. Every wait
has a time limit: the data groups time out after the mesh's
``bind(timeout_s=)``, a follower that hears nothing for as long raises
``TimeoutError``, and while rank 0 is idle a heartbeat thread sends a
ping every ``heartbeat_s``.
"""

from __future__ import annotations

import datetime
import hashlib
import pickle
import threading
import time
from typing import Any, Dict, Optional

import torch

from tpushare_torch.models.serving import PendingStep

# The server calls that change its state: each is replayed on every
# follower, in rank 0's order.
CALLS = frozenset({"admit", "admit_start", "admit_step", "step",
                   "step_async", "evict", "prefetch_prefix"})


class ControlDesync(RuntimeError):
    """A follower's replay parted from rank 0's call."""


class GenerationEnded(Exception):
    """Rank 0 ended the mesh's generation (a reshard or a grow-back):
    the follower leaves its replay loop to meet the next one. ``calls``:
    the calls it replayed in that generation."""

    calls = 0


class StoreChannel:
    """Rank 0's messages to the followers of one mesh generation, in
    order, as keys of the generation's store prefix. ``ended()`` tells a
    waiting follower that rank 0 moved on. Rank 0 deletes a message
    ``WINDOW`` messages after sending it (a follower is never that far
    behind: every tick's forward meets it in a collective)."""

    WINDOW = 4096
    # Longer than rank 0's idle heartbeat (ShardedServer, 5 s): a wait
    # this long without a message means rank 0 moved on or stalled.
    WAIT_S = 10.0

    def __init__(self, store, timeout_s: float, ended):
        self.store, self.timeout_s, self._ended = store, timeout_s, ended
        self.sent = self.read = 0

    def send(self, msg) -> None:
        self.sent += 1
        self.store.set(f"m{self.sent}", pickle.dumps(msg))
        if self.sent > self.WINDOW:
            self.store.delete_key(f"m{self.sent - self.WINDOW}")

    def recv(self):
        """The next message. Blocks in the store's wait, which returns
        as soon as rank 0 sets the key; after each ``WAIT_S`` of silence
        asks ``ended()``. A store that is gone (rank 0's process died)
        raises from the wait or from ``ended()``."""
        self.read += 1
        key = f"m{self.read}"
        deadline = time.monotonic() + self.timeout_s
        while True:
            left = deadline - time.monotonic()
            try:
                self.store.wait([key], datetime.timedelta(
                    seconds=max(0.001, min(self.WAIT_S, left))))
                break
            except torch.distributed.DistStoreError:
                if self._ended():
                    raise GenerationEnded() from None
                if left <= self.WAIT_S:
                    raise TimeoutError(f"rank 0 sent nothing for "
                                       f"{self.timeout_s} s") from None
        return pickle.loads(self.store.get(key))


def _host(obj):
    """Tensors -> CPU copies, through lists, tuples and dicts."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    return obj


def fold(h, out) -> None:
    """Fold one call's result into the running digest ``h`` (a
    ``PendingStep``'s result is folded at its finalize)."""
    if not isinstance(out, (PendingStep, _Pending)):
        h.update(repr(out).encode())


def _bcast(mesh, msg=None):
    """Rank 0 sends ``msg``; a follower receives the next message."""
    if mesh.rank == 0:
        mesh.control.send(msg)
        return msg
    return mesh.control.recv()


class _Pending:
    """Rank 0's view of a broadcast ``step_async``: ``finalize`` is
    broadcast before it runs (the followers finalize theirs in the
    same place of the call order)."""

    __slots__ = ("_owner", "_inner", "_seq", "slots")

    def __init__(self, owner: "ShardedServer", inner: PendingStep,
                 seq: int):
        self._owner, self._inner, self._seq = owner, inner, seq
        self.slots = inner.slots

    def finalize(self, invalid=frozenset()) -> Dict[int, Any]:
        return self._owner._run(("finalize", self._seq,
                                 frozenset(invalid)),
                                lambda: self._inner.finalize(invalid))


class ShardedServer:
    """Rank 0's server, its state-changing calls broadcast to the
    followers first. Reads go straight to the wrapped server."""

    def __init__(self, srv, mesh, *, heartbeat_s: float = 5.0):
        self._srv, self._mesh = srv, mesh
        self._lock = threading.Lock()
        self._seq = 0
        self._last = time.monotonic()
        self._stopped = threading.Event()
        self.broadcasts = 0
        self.digest = hashlib.sha256()
        self._hb = threading.Thread(target=self._heartbeat,
                                    args=(heartbeat_s,),
                                    name="mesh-heartbeat", daemon=True)
        self._hb.start()

    def __getattr__(self, name):
        attr = getattr(self._srv, name)
        if name in CALLS:
            def call(*a, **kw):
                seq = self._seq + 1
                out = self._run(("call", seq, name, _host(a), _host(kw)),
                                lambda: attr(*a, **kw))
                if isinstance(out, PendingStep):
                    return _Pending(self, out, seq)
                return out
            return call
        return attr

    def _send(self, msg) -> None:
        _bcast(self._mesh, msg)
        self._last = time.monotonic()
        self.broadcasts += 1

    def _run(self, msg, fn):
        if self._stopped.is_set():
            raise RuntimeError("the sharded server was stopped")
        with self._lock:
            if msg[0] == "call":
                self._seq = msg[1]
            self._send(msg)
            try:
                out = fn()
            except Exception as e:
                self._send(("raised", type(e).__name__, str(e)[:500]))
                raise
            fold(self.digest, out)
            return out

    def _heartbeat(self, every: float) -> None:
        while not self._stopped.wait(every / 2):
            if time.monotonic() - self._last < every:
                continue
            if self._lock.acquire(blocking=False):
                try:
                    if not self._stopped.is_set():
                        self._send(("ping",))
                finally:
                    self._lock.release()

    def stop(self) -> None:
        """Send the followers their stop message (once) and end the
        heartbeat."""
        self._end(("stop",))

    def retire(self, generation: int) -> None:
        """End this mesh generation: the followers leave their replay
        loop for ``generation`` (sent once; a follower that is gone
        misses nothing it needs, the plan is on the store)."""
        self._end(("regen", int(generation)))

    def _end(self, msg) -> None:
        with self._lock:
            if self._stopped.is_set():
                return
            self._stopped.set()
            try:
                self._send(msg)
            except Exception:           # noqa: BLE001 — the store's
                if msg[0] == "stop":    # owner is this process
                    raise
        self._hb.join(timeout=30)

    @property
    def wrapped(self):
        return self._srv


def follow(srv, mesh, *, log=None, digest=None) -> int:
    """Replay rank 0's calls on this rank's ``srv`` until the stop
    message; returns the calls replayed, each result folded into
    ``digest`` (a hashlib object) where given. Raises ``ControlDesync``
    where a replay's outcome parts from rank 0's, ``GenerationEnded``
    where rank 0 ended the mesh generation, and ``TimeoutError`` where
    rank 0 falls silent."""
    h = digest if digest is not None else hashlib.sha256()
    if mesh.rank == 0:
        raise ValueError("rank 0 serves; follow() runs on the others")
    pending: Dict[int, PendingStep] = {}
    failed: Optional[BaseException] = None
    where = ""
    n = 0
    while True:
        msg = _bcast(mesh)
        kind = msg[0]
        if kind == "raised":
            if failed is None or type(failed).__name__ != msg[1]:
                raise ControlDesync(
                    f"rank 0 raised {msg[1]}: {msg[2]} in {where} where "
                    f"rank {mesh.rank} "
                    + (f"raised {failed!r}" if failed is not None
                       else "did not"))
            failed = None
            continue
        if failed is not None:
            raise ControlDesync(f"rank {mesh.rank} raised {failed!r} in "
                                f"{where} where rank 0 did not") \
                from failed
        if kind == "ping":
            continue
        if kind == "stop":
            return n
        if kind == "regen":
            ended = GenerationEnded(msg[1])
            ended.calls = n
            raise ended
        try:
            if kind == "call":
                _, seq, name, a, kw = msg
                where = name
                if name not in CALLS:
                    raise ControlDesync(f"unknown call {name!r}")
                out = getattr(srv, name)(*a, **kw)
                if isinstance(out, PendingStep):
                    pending[seq] = out
                fold(h, out)
            elif kind == "finalize":
                _, seq, invalid = msg
                where = "finalize"
                fold(h, pending.pop(seq).finalize(invalid))
            else:
                raise ControlDesync(f"unknown message {kind!r}")
        except ControlDesync:
            raise
        except Exception as e:      # matched against rank 0's next word
            failed = e
            if log is not None:
                log(f"rank {mesh.rank}: {where} raised {e!r}")
        n += 1
