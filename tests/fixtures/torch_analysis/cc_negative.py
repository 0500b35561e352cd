"""CC fixture — clean concurrency the rules must NOT flag."""
import threading
import time


class LockedDaemon:
    def __init__(self):
        self._lock = threading.Lock()
        self.devices = []

    def start(self):
        threading.Thread(target=self._watch_loop, daemon=True).start()

    def _watch_loop(self):
        with self._lock:
            self.devices = ["chip0"]

    def Allocate(self, request, context):
        with self._lock:
            self.devices = []
        return None


class NoThreads:
    # A handler may mutate freely when the class spawns no threads.
    def Allocate(self, request, context):
        self.count = 1
        return None


def sleep_outside_handlers():
    time.sleep(0.1)   # not async, not a handler method
