"""CC204 negatives: every shape here is deadlock-free — nothing may
be flagged.

- a consistent acquisition order (_lock before _pool_lock everywhere)
  produces edges but no cycle;
- SEQUENTIAL acquisitions (one with-block closed before the next
  opens) produce no edge at all;
- re-entering an RLock (or a Condition, whose default inner lock is
  an RLock) is legal by construction.
"""
import threading


class EngineLike:
    def __init__(self):
        self._lock = threading.Lock()
        self._pool_lock = threading.Lock()
        self._rlock = threading.RLock()
        self._cond = threading.Condition()

    def tick(self):
        with self._lock:
            self._grow()              # _lock -> _pool_lock

    def _grow(self):
        with self._pool_lock:
            self.blocks += 1

    def stats(self):
        with self._lock:              # same order as tick: no cycle
            with self._pool_lock:
                return dict(self.counters)

    def snapshot(self):
        with self._cond:
            version = self.version
        with self._lock:              # sequential, not nested: no edge
            devices = list(self.devices)
        return version, devices

    def reenter_rlock(self):
        with self._rlock:
            self._helper()

    def _helper(self):
        with self._rlock:             # RLock: reentrant, legal
            self.n += 1

    def notify(self):
        with self._cond:
            self._wake()

    def _wake(self):
        with self._cond:              # Condition wraps an RLock: legal
            self._cond.notify_all()
