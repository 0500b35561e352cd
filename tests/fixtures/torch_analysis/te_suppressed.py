"""TE701 fixture — suppressed on its line with a cause."""
import torch

STATS = []


class Probe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        STATS.append(x.detach())  # tpushare: ignore[TE701] detached debug probe
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g
