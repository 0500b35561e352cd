"""CC203 fixture — a deliberate swallow silenced per-line (the tree's
pre-existing judged cases are baselined; both mechanisms must work)."""


class QuietSlotServer:
    def step(self):
        try:
            return self._decode()
        except Exception:  # tpushare: ignore[CC203]
            pass
