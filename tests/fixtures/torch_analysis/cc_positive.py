"""CC fixture — true positives. Parsed by the analyzer, never run."""
import threading
import time


class Daemon:
    def __init__(self):
        self._lock = threading.Lock()
        self.devices = []
        self.version = 0
        self._thread = threading.Thread(target=self._watch_loop, daemon=True)

    def _watch_loop(self):
        while True:
            self.devices = ["chip0"]        # CC201 unlocked, thread side
            self.version += 1               # CC201 unlocked, thread side

    def Allocate(self, request, context):
        self.devices = []                   # CC201 unlocked, handler side
        with self._lock:
            self.version += 1               # locked: not a finding
        return None


async def async_handler(request):
    time.sleep(1.0)                         # CC202 blocking in async
    return request


class HttpThing:
    def do_POST(self):
        time.sleep(0.5)                     # CC202 blocking in handler
