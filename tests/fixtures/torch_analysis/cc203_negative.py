"""CC203 fixture — negatives the rule must NOT flag: narrow handlers,
broad handlers that count/re-raise/return, and broad swallows outside
the policed classes."""
import logging

log = logging.getLogger(__name__)


class FakeSlotServer:
    def step(self):
        try:
            return self._decode()
        except OSError:                      # narrow: a judgment call
            pass

    def evict(self, slot):
        try:
            self._release(slot)
        except Exception as e:
            self._stats["evict_errors"] += 1  # counter = handling
            log.warning("evict failed: %s", e)

    def admit(self, prompt):
        try:
            return self._prefill(prompt)
        except Exception:
            raise                            # re-raise = handling


class ServeEngineLike:
    def _tick(self):
        try:
            self._step()
        except Exception as e:
            self.metrics.inc("engine_errors")  # non-logging call
            log.error("tick: %s", e)

    def _probe(self):
        try:
            return self._backend.probe()
        except Exception:
            return None                      # return = handling

    def _emit(self, pod):
        try:
            self._push(pod)
        except Exception as e:
            # A non-logger self attribute's .error() is a real
            # handling action (e.g. an event recorder), not a log.
            self.recorder.error(pod, str(e))


class Helper:
    """Not a *SlotServer / ServeEngine* class: a models/cli helper may
    best-effort a broad except (scope only polices the hot classes
    outside the daemon trees)."""

    def cleanup(self):
        try:
            self._rm()
        except Exception:
            pass
