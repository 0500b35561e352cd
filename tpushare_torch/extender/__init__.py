"""tpushare_torch.extender: the scheduler extender, the port's copy of
``tpushare/extender/``. It picks each pod's card and writes the
assumed-pod annotations the plugin's Allocate reads back (the reference
plugin relies on an out-of-tree gpushare extender for this). The
resource stays ``aliyun.com/tpu-mem`` with ``aliyun.com/gpu-mem`` read as
the legacy fallback, so one extender drives both plugins.
"""

from tpushare_torch.extender.core import (  # noqa: F401
    assume_pod, chip_free, choose_chips, filter_nodes, fits, score,
)
from tpushare_torch.extender.server import ExtenderService, make_server  # noqa: F401
