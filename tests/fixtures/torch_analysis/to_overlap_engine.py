"""Overlap-report golden fixture of the port — a miniature overlapped
tick. Parsed by the analyzer, never run.

tick() is the dispatch surface: it runs the step, then plans the next
pick inside the step's flight window, as ``ServeEngine._tick`` runs
``_plan_next_pick``; plan() is the schedule surface. Shared mutable
state: ``plan_cell`` (written by plan(), so on both sides) and
``MiniLedger.used`` (dispatch debits it, the plan reads it). ``queue``
and ``limits`` are read by both sides and written by neither — the
read set the report must stay empty on; ``slots`` and ``counters`` are
dispatch-only."""


class MiniLedger:
    def __init__(self):
        self.used = {}
        self.limits = {"acme": 4}

    def debit(self, tenant):
        self.used[tenant] = self.used.get(tenant, 0) + 1

    def room(self, tenant):
        return self.limits.get(tenant, 0) - self.used.get(tenant, 0)


class MiniEngine:
    def __init__(self):
        self.slots = {}
        self.queue = []
        self.counters = {"ticks": 0}
        self.ledger = MiniLedger()
        self.plan_cell = None

    def plan(self):
        if not self.queue:
            return None
        head = self.queue[-1]
        self.plan_cell = (head, self.ledger.room(head))
        return head

    def tick(self):
        self.counters["ticks"] += 1
        for req in list(self.slots):
            self.slots[req] = "ran"
            self.ledger.debit(req)
        self.plan()
