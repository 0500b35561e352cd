"""TE701 fixture — true positives. Parsed by the analyzer, never
imported: tensors escaping autograd scope."""
import torch
from torch.utils.checkpoint import checkpoint

ACTIVATIONS = []
_last = None


class Gated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        global _last
        out = torch.sigmoid(x @ w)
        ctx.out = out                             # TE701 output on ctx
        _last = out                               # TE701 global
        ACTIVATIONS.append(out)                   # TE701 captured mutable
        ctx.save_for_backward(x, w)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return g, g


class Model:
    def run(self, x, blocks):
        def block(h):
            h = blocks[0](h)
            self.last_hidden = h                  # TE701 on self, twice
            return h
        return checkpoint(block, x, use_reentrant=False)
