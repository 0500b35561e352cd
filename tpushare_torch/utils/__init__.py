"""tpushare_torch.utils — the port's copies of the host-side helpers the
serving engine needs: ``ownership`` (the opt-in thread-ownership
checks), ``tenant`` (the plugin's injected env: chip grant and KV-block
quota), ``profiling`` (the host-gap percentiles), ``atomicio`` (the
journal's atomic checkpoint writes) and ``data`` (the training data
pipeline); and the port's own ``checkpoint`` (safetensors files for
workload checkpoints)."""
