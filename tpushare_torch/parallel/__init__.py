"""tpushare_torch.parallel — the port's meshes, sequence parallelism and
sharded serving: ``mesh`` (a ``torch.distributed`` DeviceMesh for the
training steps; ``ServingMesh`` for serving over tp and ep, one process
per rank), ``sharding`` (spec trees and per-rank slices), ``control``
(rank 0 broadcasts its slot server's calls, the other ranks replay
them), ``ring_attention`` (exact causal attention over the ``sp``
process group, K/V rotating by point-to-point sends) and ``ulysses``
(all-to-all head re-sharding, then whole attention per head slice).
Counterparts of ``tpushare/parallel/mesh.py``, ``sharding.py``,
``ring_attention.py`` and ``ulysses.py``.
"""
