"""TS104 true positives: host syncs hiding BELOW the engine tick.

Every sync here lives in a helper, not in the tick body itself, so
TS103 is structurally blind to all of them — exactly the hole TS104
closes. Expected: three findings, each anchored at the tick-side call
site that starts the chain."""
import torch


class FakeSlotServer:
    def step(self):
        toks = self._advance()        # chain: step -> _advance (sync)
        self._retire(toks)            # chain: step -> _retire -> _mirror
        return toks

    def _spec_step(self):
        return self._advance()        # second entry, same depth-1 helper

    def _advance(self):
        return self.buf.tolist()

    def _retire(self, toks):
        self._mirror(toks)

    def _mirror(self, toks):
        self.lengths = self.dev_lengths.cpu().numpy()
