"""CC201 fixture — the ROUTER-shaped positive. Parsed by
the analyzer, never run.

Preserves the exact hazard the tpushare/router sweep exists to catch:
a stats-poll thread rescoring the per-replica score map while an HTTP
handler thread records proxy outcomes into the same maps, with the
poll-side stores holding no lock. The real Router (router/core.py)
takes ``self._lock`` around every one of these stores and is pinned
clean by tests/test_router.py — this fixture is what it would look
like the day someone "simplifies" that away."""
import threading


class LeakyRouter:
    def __init__(self, urls):
        self._lock = threading.Lock()
        self._scores = {u: 1.0 for u in urls}
        self._breaker_failures = {u: 0 for u in urls}
        self._poll = threading.Thread(target=self._poll_loop,
                                      daemon=True)

    def _poll_loop(self):
        while True:
            for url in list(self._scores):
                # CC201: poll-thread store into the score map, no lock
                self._scores[url] = self._scores[url] * 0.9 + 0.1
                # CC201: same hazard on the breaker map
                self._breaker_failures[url] = 0

    def do_POST(self):
        url = "http://r0:8478"
        with self._lock:
            self._scores[url] = 0.5         # locked: not a finding
        # CC201: handler-side store outside the lock
        self._breaker_failures[url] = self._breaker_failures[url] + 1
