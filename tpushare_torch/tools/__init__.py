"""tpushare_torch.tools — measurement scripts that run on a CUDA card."""
