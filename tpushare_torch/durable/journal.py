"""The port's copy of ``tpushare/durable/journal.py`` (stdlib only; a test holds it
equal to the original).

Write-ahead request journal: the durable half of crash-only serving.

Everything the engine needs to survive a SIGKILL already exists in
host memory by construction (host mirrors, per-request generated
tokens, the fold-watermark); this module persists exactly that state
as an append-only record log so a restarted process can rebuild it.

Record framing (one record)::

    <u32 payload length LE> <u32 crc32(payload) LE> <payload bytes>

The payload is compact JSON. A record is VALID iff its full frame is
present and the CRC matches; replay stops at the first invalid frame
in a segment — a torn tail (the process died mid-write) is discarded,
never poisons replay, and everything before it is intact. That is the
whole crash-consistency story: no in-place mutation, no index to
corrupt, recovery = scan.

Record kinds (the engine writes, ``scan`` reads)::

    ACCEPT {id, key, ph, prompt, tier, tenant, mt, eos, adapter}
    TOKENS {id, s, t}          # tokens t start at stream offset s
    DONE   {id, n}             # n = total tokens at completion
    CANCEL {id}
    FAILED {id, err, status}

``ACCEPT`` carries the prompt itself (replay must re-admit it) plus
its hash ``ph`` (the dedupe window's key-reuse check: the same
``Idempotency-Key`` with a DIFFERENT prompt is a client bug and must
409, never silently re-attach). ``TOKENS`` is batched per engine tick
off the one existing device fetch — journaling adds host file I/O to
the tick, never a device sync.

Segments rotate at ``segment_bytes`` (``journal-<seq>.wal``); on
quiescence (no open requests) ``checkpoint()`` truncates: old
segments are deleted and a ``checkpoint.json`` meta (written via
utils/atomicio — tmp -> fsync -> rename) records the rotation point,
so an idle daemon's journal converges to near-zero bytes instead of
growing forever.

fsync policy (``--journal-fsync``):

    tick   fsync every tick flush — a completed response implies its
           tokens are on disk (strongest; one fsync per work tick)
    batch  fsync on segment rotation, checkpoint, and close — bounded
           loss window of one segment on power failure, still zero
           loss on process death (the OS holds the writes)
    off    never fsync — zero loss on process death only (kill -9
           keeps page cache; power loss may lose the tail)

Chaos: the constructor takes ``fault_write`` / ``fault_fsync`` fault
points (tpushare_torch.chaos ``journal.write`` / ``journal.fsync``). A
``raise`` fired there is counted (``write_errors`` / ``fsync_errors``)
and swallowed — journaling degrades, serving never stops; a lost
record means the corresponding request re-executes after a crash,
which is token-exact under greedy and deduped by its idempotency key.
"""

from __future__ import annotations

import dataclasses
import json
import hashlib
import os
import struct
import threading
import time
import zlib
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

FSYNC_POLICIES = ("tick", "batch", "off")

_FRAME = struct.Struct("<II")          # payload length, crc32(payload)
_SEGMENT_FMT = "journal-{:08d}.wal"
_CHECKPOINT_META = "checkpoint.json"

#: terminal record kinds — a request with one of these is closed
TERMINAL_KINDS = ("DONE", "CANCEL", "FAILED")


def prompt_hash(prompt) -> str:
    """Stable hash of a token-id prompt for the idempotency-key reuse
    check (ACCEPT.ph). sha256 over the canonical JSON spelling."""
    data = json.dumps([int(t) for t in prompt],
                      separators=(",", ":")).encode()
    return hashlib.sha256(data).hexdigest()[:32]


def _noop(value=None):
    return None


class Journal:
    """One process's append-only request journal. Thread-safe: the
    engine thread owns the tick batching, but terminal records can
    arrive from handler/supervisor threads (shutdown drains), so every
    append holds the lock."""

    def __init__(self, path: str, *, fsync: str = "tick",
                 segment_bytes: int = 4 << 20,
                 fault_write: Optional[Callable] = None,
                 fault_fsync: Optional[Callable] = None):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(f"unknown fsync policy {fsync!r}; "
                             f"known: {FSYNC_POLICIES}")
        self.path = os.fspath(path)
        self.fsync_policy = fsync
        self.segment_bytes = max(4096, int(segment_bytes))
        self._fault_write = fault_write or _noop
        self._fault_fsync = fault_fsync or _noop
        self._lock = threading.Lock()
        os.makedirs(self.path, exist_ok=True)
        seqs = [s for s, _ in _segments(self.path)]
        self._seq = (max(seqs) + 1) if seqs else 1  # tpushare: lock[_lock]
        self._f = None                              # tpushare: lock[_lock]
        self._open_segment()
        # Observability (the /stats journal block).
        self.records = 0
        self.bytes_written = 0
        self.fsync_ms = 0.0
        self.fsyncs = 0
        self.write_errors = 0
        self.fsync_errors = 0
        self.checkpoints = 0
        self._dirty = False                         # tpushare: lock[_lock]
        # Async flush plumbing (tick_flush_async): one lazy daemon
        # worker, at most one flush in flight. _flush_done doubles as
        # the join barrier — set = idle, cleared = a flush is queued
        # or running.
        self._flush_req = threading.Event()
        self._flush_done = threading.Event()
        self._flush_done.set()
        self._flusher: Optional[threading.Thread] = None
        self._flusher_stop = False

    # -- segment plumbing ---------------------------------------------
    def _segment_path(self, seq: int) -> str:
        return os.path.join(self.path, _SEGMENT_FMT.format(seq))

    def _open_segment(self) -> None:
        # "ab", not "w": append-only is the crash-consistency model
        # (RL403 polices the "w" spelling in persistence modules).
        # Reached both from __init__ (single-threaded, pre-publication
        # — no lock needed) and from _rotate_locked (lock held); the
        # entry-lock intersection can only prove the weaker caller.
        self._f = open(self._segment_path(self._seq), "ab")  # tpushare: ignore[TO901]

    def _rotate_locked(self) -> None:
        self._flush_locked(force_fsync=self.fsync_policy != "off")
        self._f.close()
        self._seq += 1
        self._open_segment()

    # -- writes --------------------------------------------------------
    def append(self, rec: Dict[str, Any]) -> None:
        """Append one record (buffered; becomes durable at the next
        flush per the fsync policy). Write faults are counted and
        swallowed — a degraded journal must never take serving down
        with it."""
        payload = json.dumps(rec, separators=(",", ":")).encode()
        frame = _FRAME.pack(len(payload), zlib.crc32(payload)) + payload
        with self._lock:
            try:
                self._fault_write()
                self._f.write(frame)
            except Exception:
                self.write_errors += 1
                return
            self._dirty = True
            self.records += 1
            self.bytes_written += len(frame)
            if self._f.tell() >= self.segment_bytes:
                try:
                    self._rotate_locked()
                except Exception:
                    self.write_errors += 1

    def _flush_locked(self, force_fsync: bool) -> None:
        if not self._dirty and not force_fsync:
            return
        self._f.flush()
        self._dirty = False
        if not force_fsync:
            return
        t0 = time.monotonic()
        try:
            self._fault_fsync()
            os.fsync(self._f.fileno())
        except Exception:
            self.fsync_errors += 1
            return
        finally:
            self.fsync_ms += (time.monotonic() - t0) * 1e3
        self.fsyncs += 1

    def tick_flush(self) -> None:
        """The engine's per-tick flush: buffered frames reach the OS;
        ``tick`` policy also fsyncs (the strongest contract: a token a
        client saw is a token on disk)."""
        with self._lock:
            try:
                self._flush_locked(
                    force_fsync=self.fsync_policy == "tick")
            except Exception:
                self.write_errors += 1

    def tick_flush_async(self) -> None:
        """``tick_flush`` handed to the journal's single flusher
        thread, so the fsync latency rides the engine's in-flight
        device dispatch instead of its host gap. Ordering is
        preserved by construction: at most ONE flush is in flight
        (a second call joins the previous one first), so flushes
        never reorder and the crash-loss window stays the same class
        as the serial tick — at most the one tick whose flush had
        not completed, which journal replay already tolerates as a
        torn tail."""
        if self._flusher is None:
            self._flusher = threading.Thread(
                target=self._flush_worker, name="journal-flusher",
                daemon=True)
            self._flusher.start()
        self._flush_done.wait()         # at most one in flight
        self._flush_done.clear()
        self._flush_req.set()

    def _flush_worker(self) -> None:
        while True:
            self._flush_req.wait()
            self._flush_req.clear()
            if self._flusher_stop:
                self._flush_done.set()
                return
            try:
                self.tick_flush()
            finally:
                self._flush_done.set()

    def join_flushes(self) -> None:
        """Barrier: wait for any in-flight async flush. Checkpoint
        truncation and close call this first so a worker-thread flush
        can never race the segment swap. No-op when async flushing
        was never used."""
        self._flush_done.wait()

    def checkpoint(self, open_requests: int) -> bool:
        """Checkpoint-truncate on quiescence: with no open requests,
        every record in the log is history — delete old segments,
        start a fresh one, and record the rotation point atomically
        (utils/atomicio: a crash mid-checkpoint leaves either the old
        meta or the new one, and replay works under both because the
        segments themselves are the truth)."""
        if open_requests:
            return False
        from tpushare_torch.utils import atomicio
        self.join_flushes()
        with self._lock:
            try:
                self._flush_locked(
                    force_fsync=self.fsync_policy != "off")
                self._f.close()
                old = [p for s, p in _segments(self.path)
                       if s <= self._seq]
                self._seq += 1
                self._open_segment()
                atomicio.write_json(
                    os.path.join(self.path, _CHECKPOINT_META),
                    {"truncated_below": self._seq,
                     "checkpoints": self.checkpoints + 1})
                for p in old:
                    os.remove(p)
            except Exception:
                self.write_errors += 1
                if self._f is None or self._f.closed:
                    self._open_segment()
                return False
            self.checkpoints += 1
            return True

    def close(self) -> None:
        self.join_flushes()
        if self._flusher is not None:
            self._flusher_stop = True
            self._flush_done.clear()
            self._flush_req.set()
            self._flush_done.wait()
        with self._lock:
            try:
                self._flush_locked(
                    force_fsync=self.fsync_policy != "off")
                self._f.close()
            except Exception:
                self.write_errors += 1

    # -- observability -------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            n_segments = len(list(_segments(self.path)))
            return {
                "path": self.path,
                "fsync": self.fsync_policy,
                "records": self.records,
                "journal_bytes": self.bytes_written,
                "journal_fsync_ms": round(self.fsync_ms, 2),
                "fsyncs": self.fsyncs,
                "segments": n_segments,
                "checkpoints": self.checkpoints,
                "write_errors": self.write_errors,
                "fsync_errors": self.fsync_errors,
            }


def _segments(path: str) -> List[Tuple[int, str]]:
    """(seq, full path) for every segment file, ascending."""
    out: List[Tuple[int, str]] = []
    try:
        names = os.listdir(path)
    except OSError:
        return out
    for name in names:
        if name.startswith("journal-") and name.endswith(".wal"):
            try:
                seq = int(name[len("journal-"):-len(".wal")])
            except ValueError:
                continue
            out.append((seq, os.path.join(path, name)))
    return sorted(out)


def read_records(path: str) -> Iterator[Dict[str, Any]]:
    """Yield valid records across every segment in order. Replay
    stops at the first torn/corrupt frame PER SEGMENT (the tail the
    dying process never finished) and continues with the next segment
    — a mid-log segment can only have a torn tail if the process died
    while it was current, in which case no later segment exists."""
    for _, seg in _segments(path):
        try:
            with open(seg, "rb") as f:
                data = f.read()
        except OSError:
            continue
        off = 0
        while off + _FRAME.size <= len(data):
            length, crc = _FRAME.unpack_from(data, off)
            start = off + _FRAME.size
            end = start + length
            if end > len(data):
                break                   # torn tail: discard
            payload = data[start:end]
            if zlib.crc32(payload) != crc:
                break                   # corrupt: stop at the tear
            try:
                rec = json.loads(payload)
            except ValueError:
                break
            yield rec
            off = end


@dataclasses.dataclass
class RecoveredRequest:
    """One request's journal-reconstructed state."""
    request_id: str
    idempotency_key: Optional[str]
    prompt_hash: str
    prompt: List[int]
    tier: str
    tenant: str
    max_tokens: int
    eos: Optional[int]
    adapter: int
    tokens: List[int]
    status: str                         # open | done | cancelled | failed
    error: Optional[str] = None
    error_status: int = 503

    @property
    def open(self) -> bool:
        return self.status == "open"


def scan(path: str) -> Dict[str, RecoveredRequest]:
    """Rebuild per-request state from the journal: request_id ->
    RecoveredRequest. TOKENS batches are stitched by their stream
    offsets; an out-of-order or gapped batch truncates the stream at
    the gap (never observed in practice — ticks append in order — but
    a half-recovered stream must stay a PREFIX of the true one, or
    replay would continue from fabricated state)."""
    out: Dict[str, RecoveredRequest] = {}
    for rec in read_records(path):
        kind = rec.get("k")
        rid = rec.get("id")
        if not isinstance(rid, str):
            continue
        if kind == "ACCEPT":
            out[rid] = RecoveredRequest(
                request_id=rid,
                idempotency_key=rec.get("key"),
                prompt_hash=str(rec.get("ph", "")),
                prompt=[int(t) for t in rec.get("prompt", [])],
                tier=str(rec.get("tier", "standard")),
                tenant=str(rec.get("tenant", "default")),
                max_tokens=int(rec.get("mt", 1)),
                eos=rec.get("eos"),
                adapter=int(rec.get("adapter", -1)),
                tokens=[], status="open")
            continue
        req = out.get(rid)
        if req is None:
            continue                    # terminal/tokens for a request
        if kind == "TOKENS":            # whose ACCEPT was checkpointed
            s = int(rec.get("s", 0))
            if s > len(req.tokens):
                continue                # gap: keep the intact prefix
            toks = [int(t) for t in rec.get("t", [])]
            req.tokens = req.tokens[:s] + toks
            continue
        if kind == "DONE":
            req.status = "done"
        elif kind == "CANCEL":
            req.status = "cancelled"
        elif kind == "FAILED":
            req.status = "failed"
            req.error = str(rec.get("err", "failed"))
            req.error_status = int(rec.get("status", 503))
    return out
