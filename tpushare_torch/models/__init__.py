"""tpushare_torch.models — the PyTorch port's workload families.

This slice ports the dense decoder LM (``transformer``) and what serves
it over the paged KV pool: ``paged`` (PagedSlotServer), ``serving``
(TokenSampler, PendingStep), ``generate`` (greedy sample_logits) and
``bridge`` (JAX weights -> torch).
"""
