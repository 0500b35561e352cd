"""tpushare_torch.parallel — sequence parallelism of the port's training
path: ``mesh`` (a ``torch.distributed`` DeviceMesh over ``("dp",
"sp")``), ``ring_attention`` (exact causal attention over the ``sp``
process group, K/V rotating by point-to-point sends) and ``ulysses``
(all-to-all head re-sharding, then whole attention per head slice).
Counterparts of ``tpushare/parallel/mesh.py``,
``tpushare/parallel/ring_attention.py`` and
``tpushare/parallel/ulysses.py``.
"""
