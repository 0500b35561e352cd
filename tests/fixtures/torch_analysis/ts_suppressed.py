"""TS101 fixture — a justified sync, suppressed on its line."""
import torch


class HostStagedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.cpu().to(x.device)  # tpushare: ignore[TS101] gloo needs host buffers

    @staticmethod
    def backward(ctx, g):
        return g, None
