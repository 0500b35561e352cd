"""TS103 fixture — the tick's one token fetch, suppressed with its
cause."""


class FakeSlotServer:
    def step_async(self):
        nxt = self.sample()

        def _finalize(invalid):
            toks = nxt.tolist()  # tpushare: ignore[TS103] the one token fetch
            return {s: toks[s] for s in self.slots if s not in invalid}
        return _finalize
