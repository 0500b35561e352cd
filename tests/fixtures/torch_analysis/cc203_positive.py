"""CC203 fixture — true positives. Parsed by the analyzer, never
imported: broad except handlers that swallow the failure (no
re-raise, counter, or state change) in the policed scopes."""
import logging

log = logging.getLogger(__name__)


class FakeSlotServer:
    def step(self):
        try:
            return self._decode()
        except Exception:                    # CC203 pass-only
            pass

    def evict(self, slot):
        try:
            self._release(slot)
        except:                              # CC203 bare except  # noqa: E722
            pass


class ServeEngineLike:
    def _tick(self):
        for slot in self.slots:
            try:
                self.advance(slot)
            except Exception as e:           # CC203 log-and-continue
                log.warning("tick failed: %s", e)
                continue

    def _loop(self):
        try:
            self._tick()
        except BaseException as e:           # CC203 log-only broad
            log.error("engine error: %s", e)

    def _probe(self):
        try:
            self._backend.probe()
        except Exception as e:               # CC203 self-held logger
            self._log.warning("probe failed: %s", e)
