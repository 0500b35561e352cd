"""TO901 negative fixture — every declared contract honored.
Parsed by the analyzer, never run.

The same storm-ledger shape as to901_positive.py, written the way the
real tree writes it: owner-role writes stay on the owner thread,
supervisor writes ride the declared serialized pair (it only runs
after joining the dead engine), lock[attr] writes hold the lock —
including through a helper whose every call site holds it (the
entry-lock fold must prove the helper, not just lexical ``with``
blocks), and a no-role external API helper stays out of scope."""
import threading

TPUSHARE_OWNERSHIP = {
    "serialized": [["engine", "supervisor"]],
}


class QuietTierLedger:
    def __init__(self):
        self._lock = threading.Lock()
        self._tier_breaches = {"interactive": 0}  # tpushare: owner[engine]
        self._shed_by_tier = {"interactive": 0}   # tpushare: lock[_lock]
        self._loop_thread = threading.Thread(target=self._loop,
                                             daemon=True)
        self._sup = threading.Thread(target=self._supervise,
                                     daemon=True)

    def _fold_locked(self, tier):
        # bare store, but every resolved call site holds _lock: the
        # entry-lock intersection proves it
        self._shed_by_tier[tier] = 0

    def _loop(self):
        while True:
            self._tier_breaches["interactive"] += 1   # owner: fine
            with self._lock:
                self._shed_by_tier["interactive"] += 1
                self._fold_locked("interactive")

    def _supervise(self):
        self._loop_thread.join()
        # serialized with the owner (runs only after the join): fine
        self._tier_breaches["interactive"] = 0
        with self._lock:
            self._fold_locked("interactive")

    def reset(self):
        # no inferred role (external API, main thread): out of scope
        self._tier_breaches["interactive"] = 0
