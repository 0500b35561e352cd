"""CC204 suppressed: the cycle's anchor (earliest edge site) carries
an explicit waiver, so the finding must not surface."""
import threading


class EngineLike:
    def __init__(self):
        self._lock = threading.Lock()
        self._pool_lock = threading.Lock()

    def tick(self):
        with self._lock:
            self._grow()  # tpushare: ignore[CC204]

    def _grow(self):
        with self._pool_lock:
            self.blocks += 1

    def stats(self):
        with self._pool_lock:
            with self._lock:
                return dict(self.counters)
