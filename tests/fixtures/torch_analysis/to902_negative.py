"""TO902 negative fixture — the sanctioned read disciplines.
Parsed by the analyzer, never run.

The POST-FIX snapshot shapes: a declared reader taking exactly one
atomic ``dict()`` copy per contested field (then iterating ITS copy
freely — derived locals are not field reads), a locked reader of
lock[attr] fields, and an owner-side reader (same role as the owner
needs no discipline at all)."""
import threading


class CalmQuota:
    def __init__(self):
        self._lock = threading.Lock()
        self.used = {"tenant-a": 0}       # tpushare: owner[engine]
        self.capacity = {"tenant-a": 8}   # tpushare: owner[engine]
        self._scores = {"tenant-a": 0.0}  # tpushare: lock[_lock]
        self._loop_thread = threading.Thread(target=self._loop,
                                             daemon=True)

    def _loop(self):
        while True:
            self.used["tenant-a"] += 1        # owner: fine
            head = self.capacity["tenant-a"] - self.used["tenant-a"]
            with self._lock:
                self._scores["tenant-a"] = float(head)

    # tpushare: reader
    def do_GET(self):
        # one GIL-atomic copy per contested field, then local work
        used = dict(self.used)
        cap = dict(self.capacity)
        return {t: cap[t] - used.get(t, 0) for t in cap}

    def do_POST(self):
        # lock[attr] fields read under the lock: fine without any
        # reader declaration
        with self._lock:
            return dict(self._scores)
