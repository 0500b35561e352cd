"""TS104 negatives: nothing here may be flagged.

- helpers that read HOST MIRRORS (plain attribute reads, an upload
  with ``torch.as_tensor`` which is async host->device) are the
  sanctioned pattern;
- a sync-bearing helper that is only reachable from NON-tick methods
  is out of scope;
- a tick calling ANOTHER step-loop method (admit_step) is TS103's
  jurisdiction — its direct syncs carry their own suppressions, so
  TS104 must not double-report them.
"""
import torch


class FakeSlotServer:
    def step(self):
        self._grow()                  # mirror reads only: clean
        if self._admitting:
            self.admit_step(0)        # step-loop callee: TS103's beat
        return self._lengths_np

    def admit_step(self, slot):
        return self.tok.item()  # tpushare: ignore[TS103]

    def _grow(self):
        self.table = torch.as_tensor(self.table_np)

    def debug_dump(self):             # never called from a tick
        return self._snapshot()

    def _snapshot(self):
        return self.buf.tolist()
