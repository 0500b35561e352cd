"""tpushare_torch.router — the cluster front door in front of the port's
engines: the port's copies of ``tpushare/router`` (``chainkeys``,
``core``, ``daemon``), held equal to the originals by tests, so the
router and the engines hash prompts to the same chain keys.
"""

from tpushare_torch.router.chainkeys import chain_keys, chain_keys_hex  # noqa: F401
from tpushare_torch.router.core import (  # noqa: F401
    CLOSED, HALF_OPEN, OPEN, NoReplicaAvailable, Replica, Router)
from tpushare_torch.router.daemon import (  # noqa: F401
    build_arg_parser, build_router, make_handler, serve_router)
