"""RL401/RL402 negatives: every region here is closed correctly —
nothing may be flagged.

Shapes proven legal: register-before-fallible-work, except-handler
release (+ re-raise), finally release, handing the handle to a callee
whose summary releases it (the _safe_evict pattern), and handing it
to a callee that stores it (ownership transfer by registration)."""


class ServeEngineLike:
    def admit_registered_first(self, req):
        slot = self.srv.admit(req.prompt)
        self._active[slot] = req          # ownership moved before any
        self._notify(req)                 # fallible work runs

    def admit_guarded(self, req):
        slot = self.srv.admit(req.prompt)
        try:
            self._notify(req)
        except Exception:
            self._safe_evict(slot)
            raise
        self._active[slot] = req

    def admit_finally(self, req):
        slot = self.srv.admit(req.prompt)
        try:
            self._notify(req)
        finally:
            self.srv.evict(slot)

    def admit_handoff(self, req):
        slot = self.srv.admit(req.prompt)
        self._quarantine(slot)            # callee releases the param

    def admit_registrar(self, req):
        slot = self.srv.admit(req.prompt)
        self._place(slot, req)            # callee stores the param
        self._notify(req)

    def grow_attached(self, cache, req):
        blocks = alloc_blocks(cache, req.need)
        cache.table.append(blocks)        # attached before fallible work
        self._notify(req)

    def _notify(self, req):
        if req.bad:
            raise RuntimeError("bad request")

    def _safe_evict(self, slot):
        self.srv.evict(slot)

    def _quarantine(self, slot):
        self._safe_evict(slot)

    def _place(self, slot, req):
        self._active[slot] = req
