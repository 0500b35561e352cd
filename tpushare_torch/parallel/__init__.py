"""tpushare_torch.parallel — sequence parallelism of the port's training
path: ``mesh`` (a ``torch.distributed`` DeviceMesh over ``("dp",
"sp")``) and ``ring_attention`` (exact causal attention over the ``sp``
process group, K/V rotating by point-to-point sends). Counterparts of
``tpushare/parallel/mesh.py`` and ``tpushare/parallel/ring_attention.py``.
"""
