"""tpushare_torch.models — the PyTorch port's workload families.

The dense decoder LM (``transformer``) and what serves it: ``paged``
(PagedSlotServer over the paged KV pool), ``serving`` (SlotServer over
dense rows, TokenSampler, PendingStep), ``spec`` (the speculation
seam), ``speculative`` (the generate-level speculative loops), ``quant``
(int8 weights and KV), ``generate`` (sampling and the generate loop),
``lora`` (adapters, the bank, LoRA training); the MoE LM (``moe``, with
its training steps); ``convert`` (Hugging Face configs and weights);
what trains: ``training`` (losses, SGD/AdamW steps, single device,
over a dp × sp mesh and the manual fsdp steps), ``pipeline`` and
``moe_pipeline`` (pp schedules) and ``trainer`` (``fit`` with
checkpoint and resume); ``resnet`` (the saturation eval workload); and
``bridge`` (JAX weights and optimizer state -> torch).
"""
