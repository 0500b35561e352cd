"""TS101 fixture — negatives: nothing here may be flagged.

- ``ctx`` bookkeeping, shapes and host ints in forward/backward;
- a sync OUTSIDE autograd scope (the caller reads the loss);
- ``print`` in a Function's forward (runs once per step, not twice);
- a method named ``forward`` on an nn.Module (not a Function).
"""
import torch
from torch.utils.checkpoint import checkpoint


class RowSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = int(dim)                        # a host int, no tensor
        ctx.shape = x.shape
        print("forward")                          # once per step
        return x.sum(dim)

    @staticmethod
    def backward(ctx, g):
        return g.unsqueeze(ctx.dim).expand(ctx.shape), None


class Block(torch.nn.Module):
    def forward(self, x):
        return float(x.sum())                     # a Module, not autograd


def train_step(x, blocks):
    def block(h, i):
        return blocks[i](h)
    for i in range(len(blocks)):
        x = checkpoint(block, x, i, use_reentrant=False)
    loss = x.square().mean()
    return loss.item()                            # outside autograd scope
