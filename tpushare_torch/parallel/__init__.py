"""tpushare_torch.parallel — the port's training meshes and sequence
parallelism: ``mesh`` (a ``torch.distributed`` DeviceMesh over ``("pp",
"dp", "fsdp", "sp")``), ``ring_attention`` (exact causal attention over the ``sp``
process group, K/V rotating by point-to-point sends) and ``ulysses``
(all-to-all head re-sharding, then whole attention per head slice).
Counterparts of ``tpushare/parallel/mesh.py``,
``tpushare/parallel/ring_attention.py`` and
``tpushare/parallel/ulysses.py``.
"""
