"""TS104 fixture — a justified transitive sync, suppressed at the
tick-side call site."""


class FakeSlotServer:
    def step(self):
        return self._fetch()  # tpushare: ignore[TS104] the one token fetch

    def _fetch(self):
        return self.tok.tolist()
