"""CC204 true positives: lock-order inversion + non-reentrant
re-entry, both only visible ACROSS functions.

``tick`` takes _pool_lock while holding _lock (through a helper call,
so the edge itself is inter-procedural); ``stats`` nests them the
other way around — two threads running the two paths concurrently
deadlock. ``reenter`` re-acquires a plain (non-reentrant)
threading.Lock through a helper: guaranteed self-deadlock. Expected:
exactly two findings (one per cycle, each reported once at its
earliest edge site)."""
import threading


class EngineLike:
    def __init__(self):
        self._lock = threading.Lock()
        self._pool_lock = threading.Lock()

    def tick(self):
        with self._lock:
            self._grow()              # edge: _lock -> _pool_lock

    def _grow(self):
        with self._pool_lock:
            self.blocks += 1

    def stats(self):
        with self._pool_lock:
            with self._lock:          # edge: _pool_lock -> _lock (cycle!)
                return dict(self.counters)

    def reenter(self):
        with self._lock:
            self._helper()            # edge: _lock -> _lock (self-deadlock)

    def _helper(self):
        with self._lock:
            self.n += 1
