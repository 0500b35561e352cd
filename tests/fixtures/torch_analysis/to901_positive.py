"""TO901 fixture — cross-thread writes to declared-owner fields.
Parsed by the analyzer, never run.

The tier-counter shape from cc201_tier_counters.py, re-stated with
the ownership declarations: the counter maps are OWNED by the
engine loop (not merely "should hold a lock"), so a handler-side
store is a race even when it politely takes some lock — the owner
writes bare by contract, and a lock only one side holds serializes
nothing. Also seeds the lock[attr] dual (a declared locked field
written bare) and a registry-declared cross-class owner."""
import threading

TPUSHARE_OWNERSHIP = {
    "owners": {"SideLedger.totals": "engine"},
}


class SideLedger:
    def __init__(self):
        self.totals = {}

    def fold(self, tier):
        # TO901: registry-declared engine-owned map, handler chain
        self.totals[tier] = self.totals.get(tier, 0) + 1


class StormTierLedger:
    def __init__(self):
        self._lock = threading.Lock()
        self._tier_breaches = {"interactive": 0}  # tpushare: owner[engine]
        self._shed_by_tier = {"interactive": 0}   # tpushare: lock[_lock]
        self._ledger = SideLedger()
        self._loop_thread = threading.Thread(target=self._loop,
                                             daemon=True)

    def _loop(self):
        while True:
            # owner writing its own field bare: the contract
            self._tier_breaches["interactive"] += 1
            with self._lock:
                self._shed_by_tier["interactive"] = 0   # locked: fine

    def do_POST(self):
        # TO901: handler write to an engine-owned field
        self._tier_breaches["interactive"] = 0
        with self._lock:
            # TO901: a lock the OWNER never takes serializes nothing
            self._tier_breaches["interactive"] += 1
        # TO901: lock[_lock] field written without the lock
        self._shed_by_tier["interactive"] += 1
        self._ledger.fold("interactive")
