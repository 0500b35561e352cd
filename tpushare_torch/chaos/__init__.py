"""The port's copy of ``tpushare/chaos``: deterministic fault
injection at the serving engine's seams (``injector.py``, stdlib
only; a test holds the two equal)."""

from tpushare_torch.chaos.injector import (  # noqa: F401
    ALIASES,
    ENV_CHAOS,
    KINDS,
    NOOP,
    POINTS,
    FaultSpec,
    InjectedFault,
    InjectedUnavailable,
    InjectedXlaRuntimeError,
    Injector,
    canonical_point,
    default_injector,
    fault_point,
    parse_spec,
    reset_default_injector,
)
