"""Rule families. Importing this package registers every rule with the
engine's registry (the ``@register`` decorators run at import)."""

from tpushare_torch.analysis.rules import concurrency  # noqa: F401
from tpushare_torch.analysis.rules import donation  # noqa: F401
from tpushare_torch.analysis.rules import interproc  # noqa: F401
from tpushare_torch.analysis.rules import keylineage  # noqa: F401
from tpushare_torch.analysis.rules import ownership  # noqa: F401
from tpushare_torch.analysis.rules import persistence  # noqa: F401
from tpushare_torch.analysis.rules import recompile  # noqa: F401
from tpushare_torch.analysis.rules import tracer_escape  # noqa: F401
from tpushare_torch.analysis.rules import tracer_safety  # noqa: F401
from tpushare_torch.analysis.rules import wire_contract  # noqa: F401
