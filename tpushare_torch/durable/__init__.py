"""The port's copy of ``tpushare/durable``: the write-ahead request
journal (``journal.py``, stdlib only) behind the serving engine's
process failure domain. The record format is byte-identical to the
original's, so a journal written by either engine replays in the other
(a test holds the two equal)."""

from tpushare_torch.durable.journal import (  # noqa: F401
    FSYNC_POLICIES,
    Journal,
    RecoveredRequest,
    prompt_hash,
    scan,
)
