"""RL401/RL402 true positives: exception edges escaping an
acquire..release region.

The raise sits TWO frames below the escaping call site in every case
(helper indirection), so no intra-function rule can see it — the
region analysis must consult the call-graph may-raise summaries.
Expected: two RL401 findings (escape + never-released) and one RL402.
"""


class ServeEngineLike:
    def admit_one(self, req):
        slot = self.srv.admit(req.prompt)    # slot goes ACTIVE here
        self._register(slot, req)            # RL401: raises at depth 2
        self._active[slot] = req             # registration comes too late

    def _register(self, slot, req):
        self._validate(req)

    def _validate(self, req):
        if req.bad:
            raise RuntimeError("bad request")

    def forgotten(self, req):
        slot = self.srv.admit_start(req.prompt)   # RL401: never released,
        self.count += 1                           # never handed off —
        return True                               # leaks with no exception

    def grow(self, cache, req):
        blocks = alloc_blocks(cache, req.need)    # blocks reserved here
        self._register(blocks, req)               # RL402: raises at depth 2
        cache.table.append(blocks)                # attach comes too late
