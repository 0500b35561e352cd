"""RL401/RL402 suppressed: the escaping call sites carry explicit
per-rule waivers, so neither finding may surface."""


class ServeEngineLike:
    def admit_one(self, req):
        slot = self.srv.admit(req.prompt)
        self._register(slot, req)  # tpushare: ignore[RL401]
        self._active[slot] = req

    def grow(self, cache, req):
        blocks = alloc_blocks(cache, req.need)
        self._register(blocks, req)  # tpushare: ignore[RL402]
        cache.table.append(blocks)

    def _register(self, slot, req):
        self._validate(req)

    def _validate(self, req):
        if req.bad:
            raise RuntimeError("bad request")
