"""PK fixture — suppressed on their lines with a cause."""
import torch


def warm_up(x):
    return torch.randn_like(x)  # tpushare: ignore[PK501] warm-up data, discarded


def bench_entry(seed):
    torch.manual_seed(seed)  # tpushare: ignore[PK502] owns the process
