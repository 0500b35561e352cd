"""TO902 suppressed fixture — the torn read, acknowledged in place.
Parsed by the analyzer, never run. The suppression sits on the line
the finding anchors to (the FIRST contested read site)."""
import threading


class HushedQuota:
    def __init__(self):
        self.used = {"tenant-a": 0}       # tpushare: owner[engine]
        self.capacity = {"tenant-a": 8}   # tpushare: owner[engine]
        self._loop_thread = threading.Thread(target=self._loop,
                                             daemon=True)

    def _loop(self):
        while True:
            self.used["tenant-a"] += 1

    def do_POST(self):
        # approximate headroom is fine for this surface — reviewed
        cap = dict(self.capacity)  # tpushare: ignore[TO902]
        return {t: cap[t] - self.used.get(t, 0) for t in cap}
