"""TS103 fixture — negatives: nothing here may be flagged.

- host mirrors read in the tick (numpy arrays, Python ints);
- a non_blocking copy to the host (a copy, not a wait);
- host->device uploads (``torch.as_tensor``, ``.to(device)``);
- syncs in NON-tick methods, and in classes that are not slot servers.
"""
import numpy as np
import torch


class FakeSlotServer:
    def step(self):
        slots = [int(s) for s in np.nonzero(self.active)[0]]
        lengths = self.lengths_np[slots]
        staged = self.tokens.to("cpu", non_blocking=True)
        table = torch.as_tensor(self.table_np).to(self.device)
        return lengths, staged, table

    def stats(self):
        return self.lengths.tolist()                  # not a tick method


class Helper:
    def step(self):
        return self.x.item()                          # not a slot server
