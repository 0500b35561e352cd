"""The orphaned-slot code shape, preserved as a fixture.

ServeEngine's admission path once looked like this: ``srv.admit``
activates the slot, then the first-token fetch (a fallible step, a
CUDA error say, here ``_first_token`` ->
``_fetch``) runs BEFORE the request is registered in ``_active``. An
exception between activation and registration left a permanently
ACTIVE server slot no bookkeeping knew about — it consumed engine
capacity forever. Human review caught it once, and the fix was
deregister+evict in the caller's except; RL401 exists so the next
path with this shape cannot land unreviewed. The acceptance test pins
that the analyzer yields an RL401 on exactly this shape."""


class ServeEngineShape:
    def _admit_popped(self, req):
        slot = self.srv.admit(req.prompt)     # slot goes ACTIVE
        first = self._first_token(slot, req)  # fallible: fetch may fail
        req.tokens.append(first)
        self._active[slot] = req              # registration (too late)

    def _first_token(self, slot, req):
        return self._fetch(slot)

    def _fetch(self, slot):
        if slot < 0:
            raise RuntimeError("INTERNAL: token fetch failed")
        return slot + 1
