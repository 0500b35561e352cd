"""TS103 fixture — true positives. Parsed by the analyzer, never
imported: host-device syncs inside *SlotServer engine-tick methods and
the speculative mixin's."""
import torch


class FakeSlotServer:
    def step(self):
        lengths = self.lengths.cpu()                  # TS103 .cpu()
        table = self.block_table.to("cpu")            # TS103 blocking .to
        return lengths, table

    def _spec_step(self):
        return self.lengths.tolist()                  # TS103 .tolist()

    def admit_step(self, slot):
        return self.last_token[slot, 0].item()        # TS103 .item()

    def _fused_tick(self, slot):
        torch.cuda.synchronize()                      # TS103 synchronize
        done = bool(self.finished.any())              # TS103 bool() of a tensor
        return done

    def step_async(self):
        nxt = self.sample()

        def _finalize(invalid):
            return nxt.numpy()                        # TS103 in the closure
        return _finalize


class SpecDecodeMixin:
    def _spec_step_async(self):
        return self.packed.tolist()                   # TS103 mixin tick
