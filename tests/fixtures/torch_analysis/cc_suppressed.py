"""CC fixture — violations silenced by per-line suppressions."""
import threading
import time


class Daemon:
    def __init__(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self):
        self.state = "hot"   # tpushare: ignore[CC201]

    def Allocate(self, request, context):
        self.state = "cold"  # tpushare: ignore[CC201]
        return None


async def slow(request):
    time.sleep(1.0)  # tpushare: ignore[CC202]
