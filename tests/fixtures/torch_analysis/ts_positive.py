"""TS101 fixture — true positives. Parsed by the analyzer, never
imported: host syncs inside autograd scope, and side effects in a
checkpointed function."""
import time

import torch
from torch.utils.checkpoint import checkpoint


class ScaledMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        scale = float(x.abs().max())              # TS101 float() of a tensor
        ctx.save_for_backward(x, w)
        return x @ w / scale

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        if g.isnan().any().item():                # TS101 .item()
            raise FloatingPointError("nan grad")
        return g @ w.t(), x.t() @ g


def layers(x, blocks):
    def block(h, i):
        print("layer", i)                         # TS101 twice per step
        t0 = time.perf_counter()                  # TS101 twice per step
        h = blocks[i](h)
        h.cpu()                                   # TS101 .cpu()
        return h
    for i in range(len(blocks)):
        x = checkpoint(block, x, i, use_reentrant=False)
    return x
