"""TE701 fixture — negatives: outputs saved with save_for_backward,
non-tensor config on ctx, local containers, constants."""
import torch
from torch.utils.checkpoint import checkpoint


class Gated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, causal):
        out = torch.sigmoid(x @ w)
        ctx.causal = causal                       # config on ctx
        ctx.shape = x.shape
        parts = []
        parts.append(out)                         # a local container
        ctx.save_for_backward(x, w, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, out = ctx.saved_tensors
        return g * out, g, None


def layers(x, blocks):
    def block(h, i):
        return blocks[i](h)
    for i in range(len(blocks)):
        x = checkpoint(block, x, i, use_reentrant=False)
    return x
