"""tpushare_torch.router — the port's copy of the prefix chain keys."""
