"""tpushare_torch.models — the PyTorch port's workload families.

The dense decoder LM (``transformer``) and what serves it: ``paged``
(PagedSlotServer over the paged KV pool), ``serving`` (SlotServer over
dense rows, TokenSampler, PendingStep), ``spec`` (speculative decoding),
``quant`` (int8 weights and KV), ``generate`` (sampling);
the MoE LM (``moe``, ``convert``); what trains the dense LM:
``training`` (losses, SGD/AdamW steps, single device and over a dp × sp
mesh) and ``trainer`` (``fit``); and ``bridge`` (JAX weights and
optimizer state -> torch).
"""
