"""TO902 fixture — torn multi-field / live-dict reads.
Parsed by the analyzer, never run.

Preserves the PRE-FIX ``KvQuota.snapshot`` shape: a handler
surface iterating the engine's live ledger dict key-by-key (every
``self.used[...]`` hit is another chance to see a mid-charge state),
plus the two-field torn read (capacity vs used, each individually
GIL-atomic, together an inconsistent admission verdict). The reader
declaration does NOT excuse the live iteration — a declared reader is
held to one atomic-copy read per contested field."""
import threading


class TornQuota:
    def __init__(self):
        self.used = {"tenant-a": 0}       # tpushare: owner[engine]
        self.capacity = {"tenant-a": 8}   # tpushare: owner[engine]
        self._loop_thread = threading.Thread(target=self._loop,
                                             daemon=True)

    def _loop(self):
        while True:
            self.used["tenant-a"] += 1    # owner: fine

    # tpushare: reader
    def do_GET(self):
        # TO902: declared reader, but the live-dict iteration reads
        # ``used`` at multiple sites — the pre-fix snapshot shape
        out = {}
        for tenant in list(self.used):
            out[tenant] = self.used[tenant]
        return out

    def do_POST(self):
        # TO902: undeclared reader, two owned fields read bare — the
        # verdict can see used from one tick and capacity from another
        headroom = {}
        for tenant in list(self.capacity):
            headroom[tenant] = (self.capacity[tenant]
                                - self.used.get(tenant, 0))
        return headroom
