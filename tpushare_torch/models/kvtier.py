"""Host-RAM KV offload tier and the measured transfer-vs-recompute
policy. Counterpart of ``tpushare/models/kvtier.py``.

* :class:`HostKvTier` — a byte-budgeted LRU of paged KV blocks DEMOTED
  to host memory instead of destroyed, keyed by the prefix cache's
  chain digests. Cold blocks land here when an admission reclaims them
  (``paged.demote_for_alloc``), migrated blocks from sibling replicas
  land here (``/kv/migrate``), and a later prefix hit PROMOTES the chain
  back into the device pool — a host-to-device copy instead of a
  prefill. The tier is inclusive: a promoted entry stays resident.
* :class:`CrossoverEstimator` — the measured demote/migrate/promote
  policy: per channel (device-to-host, host-to-device, replica-to-replica
  network) it compares bytes-to-move at the measured rate with
  tokens-to-prefill at the measured prefill rate. Unmeasured channels
  default to ``transfer`` and are counted.
* :class:`HostBlockArena` — where the payloads live. ONE host buffer,
  page-locked when the pool is on a CUDA card (so copies from and to it
  run asynchronously on the card's copy engines), carved into equal
  slots, one block each (every pool leaf of the block back to back).
  It is allocated once, when the tier is attached to a pool, never per
  block. Every asynchronous copy into or out of a slot leaves a CUDA
  event on it (its fence): a later reader or writer of that slot, on
  any stream or on the host, waits for the fence first.

Payloads are host tensors (``{pool field: tensor}``, each shaped like
``pool[:, blk]``), not numpy arrays. Threading: every public tier method
takes the one tier lock. Arena memory is written only by the engine
thread (demotions, migrated landings); other threads read it through
:meth:`HostKvTier.copy_out`, under the tier lock, so an entry cannot be
evicted and its slot rewritten mid-read.

Chaos: ``fault_demote`` / ``fault_promote`` are the slots the engine
wires to the ``kv.demote`` / ``kv.promote`` chaos points. A raising
demote drops the block (recompute later, never corruption); a raising
promote breaks the chain at that block and the admission recomputes
from there, token-exact.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from tpushare_torch.utils.profiling import PhaseTimer

#: Estimator channel names. ``d2h`` gates demotion (is the block worth
#: saving?), ``h2d`` gates promotion (is the saved block worth restoring
#: vs recomputing?), ``net`` gates migration (is pulling a sibling's
#: chain worth it vs prefilling locally?).
CHANNELS = ("d2h", "h2d", "net")

#: Leaf offsets inside an arena slot are aligned to this many bytes, so
#: every leaf view reinterprets its bytes in place.
_ALIGN = 16


class CrossoverEstimator:
    """Transfer-vs-recompute crossover from measured rates.

    ``observe_transfer(channel, nbytes, seconds)`` and
    ``observe_prefill(tokens, seconds)`` feed it from real work. A copy
    on the card is fed by ``observe_events``: its two CUDA events are
    read once the second has completed (a host clock around a copy
    that was only enqueued would time the launch, not the transfer).
    ``decide`` compares ``bytes_to_move / rate(channel)`` with
    ``tokens_to_recompute / prefill_rate()``. The spans accumulate in a
    :class:`PhaseTimer` (one phase per channel plus ``prefill``)."""

    def __init__(self) -> None:
        self.timer = PhaseTimer()
        self._bytes: Dict[str, float] = {}
        self._tokens: float = 0.0
        self.decisions: Dict[str, int] = {
            "transfer": 0, "recompute": 0, "unmeasured": 0}
        self._lock = threading.Lock()
        # (channel, nbytes, start event, end event) not yet completed.
        self._pending: List[tuple] = []

    def _charge(self, phase: str, seconds: float) -> None:
        t = self.timer
        t.seconds[phase] = t.seconds.get(phase, 0.0) + seconds
        t.counts[phase] = t.counts.get(phase, 0) + 1

    def observe_transfer(self, channel: str, nbytes: int,
                         seconds: float) -> None:
        if channel not in CHANNELS or nbytes <= 0 or seconds <= 0:
            return
        with self._lock:
            self._charge(channel, seconds)
            self._bytes[channel] = self._bytes.get(channel, 0.0) \
                + float(nbytes)

    def observe_events(self, channel: str, nbytes: int, start,
                       end) -> None:
        """A transfer enqueued on the card between two recorded CUDA
        events: charged by the events' device time once ``end`` has
        completed (read without waiting, at the next rate query)."""
        if channel not in CHANNELS or nbytes <= 0:
            return
        with self._lock:
            self._pending.append((channel, int(nbytes), start, end))

    def _harvest(self) -> None:
        """Charge every pending event pair whose end has completed."""
        with self._lock:
            if not self._pending:
                return
            keep = []
            for ch, nb, start, end in self._pending:
                if not end.query():
                    keep.append((ch, nb, start, end))
                    continue
                sec = start.elapsed_time(end) / 1e3
                if sec > 0:
                    self._charge(ch, sec)
                    self._bytes[ch] = self._bytes.get(ch, 0.0) + float(nb)
            self._pending = keep

    def observe_prefill(self, tokens: int, seconds: float) -> None:
        if tokens <= 0 or seconds <= 0:
            return
        with self._lock:
            self._charge("prefill", seconds)
            self._tokens += float(tokens)

    def rate(self, channel: str) -> Optional[float]:
        """Measured bytes/s for ``channel``, or None before the first
        observation (the policy must not invent a rate)."""
        self._harvest()
        with self._lock:
            sec = self.timer.seconds.get(channel, 0.0)
            nb = self._bytes.get(channel, 0.0)
        if sec <= 0 or nb <= 0:
            return None
        return nb / sec

    def prefill_rate(self) -> Optional[float]:
        """Measured prefill tokens/s, or None before the first chunk."""
        with self._lock:
            sec = self.timer.seconds.get("prefill", 0.0)
            tok = self._tokens
        if sec <= 0 or tok <= 0:
            return None
        return tok / sec

    def decide(self, channel: str, bytes_to_move: int,
               tokens_to_recompute: int) -> str:
        """``"transfer"`` or ``"recompute"`` for one chain. Both rates
        measured: compare the projected costs (ties go to transfer).
        Either missing: transfer, counted as ``unmeasured`` — the
        transfer it permits is the observation that ends blindness."""
        r = self.rate(channel)
        p = self.prefill_rate()
        if r is None or p is None:
            with self._lock:
                self.decisions["unmeasured"] += 1
                self.decisions["transfer"] += 1
            return "transfer"
        move_s = bytes_to_move / r
        redo_s = tokens_to_recompute / p
        out = "transfer" if move_s <= redo_s else "recompute"
        with self._lock:
            self.decisions[out] += 1
        return out

    def snapshot(self) -> dict:
        """The ``/stats`` citation: every input the policy used.
        Unmeasured channels report null rates (null-not-0)."""
        self._harvest()
        with self._lock:
            chans = {}
            for ch in CHANNELS:
                sec = self.timer.seconds.get(ch, 0.0)
                nb = self._bytes.get(ch, 0.0)
                chans[ch] = {
                    "bytes_per_s": (round(nb / sec, 1)
                                    if sec > 0 and nb > 0 else None),
                    "bytes_total": int(nb),
                    "seconds": round(sec, 6),
                    "transfers": self.timer.counts.get(ch, 0),
                }
            psec = self.timer.seconds.get("prefill", 0.0)
            prefill = {
                "tokens_per_s": (round(self._tokens / psec, 1)
                                 if psec > 0 and self._tokens > 0
                                 else None),
                "tokens_total": int(self._tokens),
                "seconds": round(psec, 6),
            }
            return {"channels": chans, "prefill": prefill,
                    "decisions": dict(self.decisions)}


class Payload(dict):
    """One block's leaves ``{pool field: tensor}``. ``row`` is the
    block's raw bytes (an arena slot on the host, or a staged copy on
    the card), ``slot`` the arena slot it occupies (None when staged),
    ``event`` the CUDA event a reader of a staged copy waits on."""

    __slots__ = ("row", "slot", "event")

    def __init__(self, leaves, row=None, slot=None, event=None):
        super().__init__(leaves)
        self.row = row
        self.slot = slot
        self.event = event


class HostBlockArena:
    """Host memory for one pool's demoted blocks: a ``[n_slots,
    slot_bytes]`` byte buffer, page-locked for a CUDA pool. ``layout``
    is ``[(field, block shape, dtype), ...]`` — one pool leaf each,
    shaped like ``pool[:, blk]``."""

    def __init__(self, layout: Sequence[Tuple[str, tuple, torch.dtype]],
                 n_slots: int, device: torch.device):
        self.layout = [(f, tuple(s), d) for f, s, d in layout]
        self.offsets: Dict[str, Tuple[int, int]] = {}
        off = 0
        for field, shape, dtype in self.layout:
            nb = dtype.itemsize
            for n in shape:
                nb *= n
            self.offsets[field] = (off, nb)
            off += -(-nb // _ALIGN) * _ALIGN
        self.slot_bytes = off
        self.block_bytes = sum(nb for _, nb in self.offsets.values())
        self.device = device
        self.cuda = device.type == "cuda"
        self.buf = torch.empty((n_slots, self.slot_bytes),
                               dtype=torch.uint8, pin_memory=self.cuda)
        self._free = list(range(n_slots - 1, -1, -1))
        self._fence: Dict[int, object] = {}
        self._lock = threading.Lock()

    @property
    def n_slots(self) -> int:
        return self.buf.shape[0]

    @property
    def free_slots(self) -> int:
        with self._lock:
            return len(self._free)

    def leaves(self, rows: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Leaf views of raw block bytes: ``rows`` [slot_bytes] gives
        block-shaped leaves, [n, slot_bytes] gives [n, *block shape]."""
        lead = tuple(rows.shape[:-1])
        out = {}
        for field, shape, dtype in self.layout:
            off, nb = self.offsets[field]
            out[field] = rows[..., off:off + nb].view(dtype).view(
                *lead, *shape)
        return out

    def payload(self, slot: int) -> Payload:
        row = self.buf[slot]
        return Payload(self.leaves(row), row=row, slot=slot)

    def acquire(self) -> Optional[int]:
        with self._lock:
            return self._free.pop() if self._free else None

    def release(self, slot: int) -> None:
        with self._lock:
            self._free.append(slot)

    def fence(self, slots, event) -> None:
        """``event`` follows the latest asynchronous copy touching
        ``slots``."""
        if event is None:
            return
        with self._lock:
            for s in slots:
                self._fence[s] = event

    def wait_on_stream(self, slots, stream) -> None:
        """Order ``stream`` after every pending copy on ``slots``."""
        with self._lock:
            evs = {id(e): e for e in (self._fence.get(s) for s in slots)
                   if e is not None}
        for e in evs.values():
            stream.wait_event(e)

    def wait_on_host(self, slot: int) -> None:
        """Block the calling thread until ``slot``'s copies are done."""
        with self._lock:
            ev = self._fence.pop(slot, None)
        if ev is not None:
            ev.synchronize()


class _Entry:
    __slots__ = ("data", "nbytes", "tenant", "tokens")

    def __init__(self, data: Dict[str, torch.Tensor], nbytes: int,
                 tenant: Optional[str], tokens: int):
        self.data = data
        self.nbytes = nbytes
        self.tenant = tenant
        self.tokens = tokens


class HostKvTier:
    """Byte-budgeted host-RAM LRU of demoted/migrated KV blocks, keyed
    by the prefix cache's chain digests (bytes).

    ``staged`` holds chains the overlapped tick's prefetch has already
    uploaded to the card (on a side stream, ahead of their admission); a
    later ``take_promote`` consumes the device copy (prefetch hit)
    instead of uploading again. Stale stages are dropped at the next
    prefetch. ``arena`` is attached with the pool
    (``paged.attach_host_tier``); an entry whose payload occupies an
    arena slot returns it when the entry leaves the tier."""

    def __init__(self, budget_bytes: int, *,
                 estimator: Optional[CrossoverEstimator] = None,
                 quota=None):
        if budget_bytes <= 0:
            raise ValueError("host tier budget must be positive")
        self.budget_bytes = int(budget_bytes)
        self.estimator = estimator or CrossoverEstimator()
        self.quota = quota
        self.arena: Optional[HostBlockArena] = None
        self._entries: "OrderedDict[bytes, _Entry]" = OrderedDict()
        self.staged: Dict[bytes, dict] = {}
        self._lock = threading.Lock()
        # Chaos slots (the engine wires kv.demote / kv.promote here).
        self.fault_demote: Optional[Callable] = None
        self.fault_promote: Optional[Callable] = None
        self.bytes_resident = 0
        self.demotions = 0
        self.promotions = 0
        self.migrations_in = 0
        self.prefetch_hits = 0
        self.prefetch_misses = 0
        self.evictions = 0
        self.demote_failures = 0
        self.promote_failures = 0
        self.put_refused = 0
        # Blocks the LAST admit_prefix landed from this tier: promoted
        # landings are fresh device allocations the tenant pays for.
        self.last_promoted_n = 0

    # -- write side ---------------------------------------------------

    def put(self, key: bytes, data: Dict[str, torch.Tensor], *,
            tenant: Optional[str] = None, tokens: int = 0,
            kind: str = "demote") -> bool:
        """Land one block. Returns False when refused (a single block
        larger than the whole budget). Over-budget resolution is
        spill-isolated: a tenant past its own host quota evicts ITS OWN
        oldest entries first; only the global budget evicts globally
        oldest-first."""
        nbytes = int(sum(a.nbytes for a in data.values()))
        if nbytes > self.budget_bytes:
            with self._lock:
                self.put_refused += 1
            return False
        evicted: List[_Entry] = []
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self.bytes_resident -= old.nbytes
                self._host_refund(old)
                self._release(old)
            self._entries[key] = _Entry(data, nbytes, tenant, tokens)
            self.bytes_resident += nbytes
            if self.quota is not None and tenant is not None:
                self.quota.host_charge(tenant, nbytes)
                while self.quota.host_over(tenant):
                    victim = None
                    for k, e in self._entries.items():
                        if e.tenant == tenant and k != key:
                            victim = k
                            break
                    if victim is None:
                        break       # only the new entry itself left
                    evicted.append(self._evict_locked(victim))
            while self.bytes_resident > self.budget_bytes:
                k = next(iter(self._entries))
                if k == key and len(self._entries) == 1:
                    break
                evicted.append(self._evict_locked(k))
            if kind == "migrate":
                self.migrations_in += 1
            else:
                self.demotions += 1
        del evicted
        return True

    def _evict_locked(self, key: bytes) -> _Entry:
        e = self._entries.pop(key)
        self.bytes_resident -= e.nbytes
        self.evictions += 1
        self._host_refund(e)
        self._release(e)
        return e

    def _host_refund(self, e: _Entry) -> None:
        if self.quota is not None and e.tenant is not None:
            self.quota.host_refund(e.tenant, e.nbytes)

    def _release(self, e: _Entry) -> None:
        slot = getattr(e.data, "slot", None)
        if slot is not None and self.arena is not None:
            self.arena.release(slot)

    def pop(self, key: bytes) -> Optional[Dict[str, torch.Tensor]]:
        """Remove an entry. An arena-backed payload's slot returns to
        the arena, so its tensors stay valid only until the next put."""
        with self._lock:
            e = self._entries.pop(key, None)
            if e is None:
                return None
            self.bytes_resident -= e.nbytes
            self._host_refund(e)
            self._release(e)
            return e.data

    # -- read side ----------------------------------------------------

    def has(self, key: bytes) -> bool:
        with self._lock:
            return key in self._entries

    def get(self, key: bytes) -> Optional[Dict[str, torch.Tensor]]:
        """Peek without consuming; bumps recency. The engine thread's
        read (its own stream orders it after the slot's copies); other
        threads read through ``copy_out``."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return None
            self._entries.move_to_end(key)
            return e.data

    def copy_out(self, key: bytes) -> Optional[Dict[str, torch.Tensor]]:
        """A private host copy of one entry (the ``/kv/blocks`` serving
        side, on a handler thread): taken under the tier lock after the
        slot's pending copies, so no eviction can hand the slot to a
        new block mid-read. Bumps recency."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return None
            self._entries.move_to_end(key)
            slot = getattr(e.data, "slot", None)
            if slot is not None and self.arena is not None:
                self.arena.wait_on_host(slot)
            return {pf: t.clone() for pf, t in e.data.items()}

    def entry_tokens(self, key: bytes) -> int:
        with self._lock:
            e = self._entries.get(key)
            return e.tokens if e is not None else 0

    def keys_hex(self) -> List[str]:
        """Resident chain digests for the ``/prefixes`` gossip."""
        with self._lock:
            return [k.hex() for k in self._entries]

    # -- promotion ----------------------------------------------------

    def begin_promote(self, key: bytes, tokens: int = 0) -> bool:
        """Gate one block's promotion. False = not resident, chaos
        fault, or the measured policy says recompute — the caller then
        breaks the chain there and prefills the rest."""
        with self._lock:
            staged = key in self.staged
            resident = key in self._entries
            e = self._entries.get(key)
        if not staged and not resident:
            return False
        if self.fault_promote is not None:
            try:
                self.fault_promote()
            except Exception:
                with self._lock:
                    self.promote_failures += 1
                return False
        if staged:
            return True             # upload already paid for
        if tokens > 0 and e is not None:
            if self.estimator.decide("h2d", e.nbytes, tokens) \
                    == "recompute":
                return False
        return True

    def take_promote(self, key: bytes):
        """The promotion payload: the staged device copy when the
        prefetch landed one (hit), else the host entry (miss — the
        admission pays the upload). Host entries stay resident."""
        with self._lock:
            dev = self.staged.pop(key, None)
            if dev is not None:
                self.prefetch_hits += 1
                self.promotions += 1
                return dev, True
            e = self._entries.get(key)
            if e is None:
                return None, False
            self._entries.move_to_end(key)
            self.prefetch_misses += 1
            self.promotions += 1
            return e.data, False

    def stage(self, key: bytes, device_data: dict) -> None:
        with self._lock:
            self.staged[key] = device_data

    def clear_staged(self, keep=()) -> None:
        """Drop stale prefetch stages (saved uploads, not state)."""
        keep = set(keep)
        with self._lock:
            for k in [k for k in self.staged if k not in keep]:
                del self.staged[k]

    # -- observability ------------------------------------------------

    def snapshot(self) -> dict:
        crossover = self.estimator.snapshot()
        with self._lock:
            n = len(self._entries)
            return {
                "blocks_resident": n,
                "bytes_resident": self.bytes_resident,
                "budget_bytes": self.budget_bytes,
                "staged": len(self.staged),
                "demotions": self.demotions,
                "promotions": self.promotions,
                "migrations_in": self.migrations_in,
                "evictions": self.evictions,
                "demote_failures": self.demote_failures,
                "promote_failures": self.promote_failures,
                "put_refused": self.put_refused,
                "prefetch_hit_rate": (
                    round(self.prefetch_hits
                          / (self.prefetch_hits
                             + self.prefetch_misses), 4)
                    if (self.prefetch_hits
                        + self.prefetch_misses) else None),
                "crossover": crossover,
            }


def timed(fn):
    """(result, seconds) of ``fn()`` — the estimator feed helper for
    work that is complete when ``fn`` returns."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


class CopySpan:
    """Times one batch of copies for the estimator: CUDA events around
    the batch on a card (read when done, by ``observe_events``), the
    host clock on the CPU, where every copy is complete on return."""

    def __init__(self, device: torch.device, stream=None):
        self.cuda = device.type == "cuda"
        self.stream = stream
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record(stream)
        else:
            self.t0 = time.perf_counter()

    def close(self, estimator: CrossoverEstimator, channel: str,
              nbytes: int):
        """Record the end and feed ``estimator``; returns the end event
        (the copies' fence) on a card, else None."""
        if self.cuda:
            self.end.record(self.stream)
            estimator.observe_events(channel, nbytes, self.start, self.end)
            return self.end
        estimator.observe_transfer(channel, nbytes,
                                   time.perf_counter() - self.t0)
        return None
