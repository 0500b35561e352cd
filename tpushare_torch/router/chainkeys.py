"""Block-chain prefix digests — the port's own copy of
``tpushare/router/chainkeys.py:chain_keys``.

The paged prefix cache identifies a published block by the incremental
sha256 over the int32 token bytes of the prompt's chain up to that
block. The digests must be byte-identical to the JAX package's, so that
prefix keys (and the router's affinity keys built from them) agree
across the two packages; a test pins the identity.
"""

from __future__ import annotations

import hashlib
from typing import List

import numpy as np


def chain_keys(prompt: np.ndarray, block_size: int, n_full: int,
               salt: bytes = b"") -> List[bytes]:
    """Incremental chain digests: keys[i] identifies tokens[0:(i+1)*bs].
    ``prompt`` is a host numpy array; ``salt`` folds extra identity
    into the chain (e.g. an adapter id)."""
    h = hashlib.sha256(salt)
    keys: List[bytes] = []
    toks = prompt.astype(np.int32, copy=False)
    for i in range(n_full):
        h.update(toks[i * block_size:(i + 1) * block_size].tobytes())
        keys.append(h.digest())
    return keys
