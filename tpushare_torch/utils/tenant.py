"""In-pod tenant contract: consume the env the plugin injected. The
port's counterpart of ``tpushare/utils/tenant.py``.

The env half (``AllocationError``, ``TenantSpec``, ``read_tenant_env``,
``kv_quota_env``) is the original's, plus the card selector: the card
list comes from ``NVIDIA_VISIBLE_DEVICES`` where the plugin wrote it
(falling back to ``ALIYUN_COM_TPU_MEM_IDX`` where that variable names no
index), else from the TPU variables exactly as the JAX function reads
them.

The guard half (``SoftHbmOom``, the enforce signal,
``get_enforcing_guard``, ``apply_tenant_limits``, ``HbmGuard``) keeps the
original's modes (``raise | log | off``, failing closed), its cooldown and
``CTPU_DISABLE``, with two changes a card allows:

- The hard half exists here. The JAX package's runtime ignores a memory
  fraction; PyTorch's caching allocator honours one, so
  ``apply_tenant_limits`` caps each visible card at
  ``TPUSHARE_HBM_LIMIT_BYTES`` (over the cards, of each card's
  ``total_memory``) with ``torch.cuda.set_per_process_memory_fraction``:
  an allocation past the grant raises ``torch.OutOfMemoryError``. It is
  applied lazily, when the process first initializes CUDA (or at once by
  ``tenant_device()``), so importing this module or calling
  ``apply_tenant_limits`` never initializes CUDA.
- ``HbmGuard`` reads ``torch.cuda.memory_reserved()`` over the visible
  cards: what the allocator holds and what the fraction caps. The CUDA
  context (~0.6 GB on an H100) and memory taken outside the allocator
  lie outside both.

Card selection in a bare process: ``NVIDIA_VISIBLE_DEVICES`` selects
nothing outside a container runtime, and inside one the card it exposes
is CUDA device 0. So it is mirrored into ``CUDA_VISIBLE_DEVICES`` (as
the cards' UUIDs) only when NVML, which makes no CUDA context, sees more
cards than the grant names, and only before CUDA is initialized.
"""

from __future__ import annotations

import logging
import os
import signal
import sys
import threading
from dataclasses import dataclass
from typing import Callable, List, Optional

from tpushare_torch.plugin import const

# The env the plugin's Allocate injects, by the plugin's own names: the
# wire contract has one home (plugin/const.py), so a renamed variable
# cannot reach the daemon and miss the tenant.
ENV_NVIDIA_VISIBLE_DEVICES = const.ENV_NVIDIA_VISIBLE_DEVICES
ENV_TPU_VISIBLE_CHIPS = const.ENV_TPU_VISIBLE_CHIPS
ENV_TPU_VISIBLE_DEVICES = const.ENV_TPU_VISIBLE_DEVICES
ENV_RESOURCE_INDEX = const.ENV_RESOURCE_INDEX
ENV_RESOURCE_BY_POD = const.ENV_RESOURCE_BY_POD
ENV_RESOURCE_BY_CONTAINER = const.ENV_RESOURCE_BY_CONTAINER
ENV_RESOURCE_BY_DEV = const.ENV_RESOURCE_BY_DEV
ENV_HBM_LIMIT_BYTES = const.ENV_HBM_LIMIT_BYTES
ENV_HBM_ENFORCE = const.ENV_HBM_ENFORCE
ENV_DISABLE_ISOLATION = const.ENV_DISABLE_ISOLATION
ENV_KV_BLOCK_RESERVE = const.ENV_KV_BLOCK_RESERVE
ENV_KV_BLOCK_LIMIT = const.ENV_KV_BLOCK_LIMIT
ENV_CUDA_VISIBLE_DEVICES = "CUDA_VISIBLE_DEVICES"

log = logging.getLogger("tpushare.tenant")


class SoftHbmOom(MemoryError):
    """Raised in the MAIN thread when this process exceeds its memory
    grant and enforcement is on (TPUSHARE_HBM_ENFORCE=raise): the
    watchdog half, for memory the allocator's fraction does not see or
    when the fraction is not in force."""


class AllocationError(RuntimeError):
    """The scheduler could not satisfy this pod's memory request; the
    plugin injected the poisoned env instead of failing the RPC."""


@dataclass(frozen=True)
class TenantSpec:
    chips: List[int]               # physical chip indices visible to this pod
    hbm_limit_bytes: Optional[int]
    pod_units: Optional[int]       # memory units requested by the pod
    container_units: Optional[int]
    units_per_chip: Optional[int]
    isolation_disabled: bool
    # KV-pool block quota: a guaranteed reserve floor and a burstable
    # ceiling, in paged-pool blocks. None = the env didn't grant one.
    kv_block_reserve: Optional[int] = None
    kv_block_limit: Optional[int] = None

    @property
    def hbm_fraction(self) -> Optional[float]:
        """This container's share of its chip's advertised memory."""
        if self.container_units is None or not self.units_per_chip:
            return None
        return min(1.0, self.container_units / self.units_per_chip)


def _int_env(key: str) -> Optional[int]:
    v = os.environ.get(key)
    try:
        return int(v) if v is not None else None
    except ValueError:
        return None


def _indices(text: str) -> List[int]:
    return [int(p) for p in text.split(",") if p.strip().isdigit()]


def read_tenant_env() -> TenantSpec:
    nvidia = os.environ.get(ENV_NVIDIA_VISIBLE_DEVICES)
    if nvidia is not None:
        key, visible = ENV_NVIDIA_VISIBLE_DEVICES, nvidia
    else:
        key, visible = ENV_TPU_VISIBLE_CHIPS, os.environ.get(
            ENV_TPU_VISIBLE_CHIPS, os.environ.get(ENV_TPU_VISIBLE_DEVICES,
                                                  ""))
    if visible.startswith("no-tpu-has-") or visible.startswith("no-gpu-has-"):
        raise AllocationError(
            f"tpushare could not satisfy this pod's memory request "
            f"({key}={visible!r}); the scheduler "
            f"admitted the pod but no chip had room — fix the request or "
            f"free capacity")
    chips = _indices(visible)
    if nvidia is not None and not chips:
        chips = _indices(os.environ.get(ENV_RESOURCE_INDEX, ""))
    return TenantSpec(
        chips=chips,
        hbm_limit_bytes=_int_env(ENV_HBM_LIMIT_BYTES),
        pod_units=_int_env(ENV_RESOURCE_BY_POD),
        container_units=_int_env(ENV_RESOURCE_BY_CONTAINER),
        units_per_chip=_int_env(ENV_RESOURCE_BY_DEV),
        isolation_disabled=os.environ.get(ENV_DISABLE_ISOLATION) == "true",
        kv_block_reserve=_int_env(ENV_KV_BLOCK_RESERVE),
        kv_block_limit=_int_env(ENV_KV_BLOCK_LIMIT),
    )


def kv_quota_env(tenant: str = "default"):
    """The in-pod KV-block grant as a ``slo.quota`` spec map for this
    pod's engine: ``{tenant: TenantQuotaSpec}`` from the injected
    TPUSHARE_KV_BLOCK_RESERVE / TPUSHARE_KV_BLOCK_LIMIT, or None when
    the env grants neither. A limit below the reserve is the err-as-env
    poison class read_tenant_env rejects for chips — fail loudly."""
    from tpushare_torch.slo.quota import TenantQuotaSpec
    spec = read_tenant_env()
    if spec.kv_block_reserve is None and spec.kv_block_limit is None:
        return None
    reserve = spec.kv_block_reserve or 0
    limit = spec.kv_block_limit
    if limit is not None and limit < reserve:
        raise AllocationError(
            f"poisoned KV-block grant: {ENV_KV_BLOCK_LIMIT}="
            f"{limit} < {ENV_KV_BLOCK_RESERVE}={reserve}")
    return {tenant: TenantQuotaSpec(reserve=reserve, ceiling=limit)}


#: Signal the enforcing guard uses to move the breach from its watchdog
#: thread into the main thread (handlers only run there). A real-time
#: signal where the platform has them: SIGUSR1/2 are commonly claimed
#: by app servers, and clobbering them would turn a routine log
#: rotation into a SoftHbmOom.
_ENFORCE_SIGNAL = (signal.SIGRTMIN + 7 if hasattr(signal, "SIGRTMIN")
                   else signal.SIGUSR1)
_enforcing_guard: Optional["HbmGuard"] = None


def get_enforcing_guard() -> Optional["HbmGuard"]:
    """The guard apply_tenant_limits() armed, if any — the process's
    single source of breach telemetry (tools/colocate.py reports its
    count)."""
    return _enforcing_guard


def _install_soft_oom_handler() -> bool:
    """Install the main-thread SoftHbmOom handler; False when this is
    not the main thread (signal.signal refuses there — enforcement
    degrades to log-only with a loud warning rather than crashing)."""
    def _handler(signum, frame):
        g = _enforcing_guard
        used = g.last_used if g else 0
        limit = g.limit if g else 0
        raise SoftHbmOom(
            f"tpu-mem grant exceeded: using {used} bytes of {limit} "
            f"allowed (TPUSHARE_HBM_ENFORCE=raise; set =log for the "
            f"watchdog-only behavior)")
    try:
        prev = signal.getsignal(_ENFORCE_SIGNAL)
        if prev not in (signal.SIG_DFL, signal.SIG_IGN, None) \
                and getattr(prev, "__qualname__", "") != _handler.__qualname__:
            log.warning("HBM enforcement is replacing an existing handler "
                        "for signal %d; if the application claims this "
                        "signal after apply_tenant_limits(), enforcement "
                        "is silently lost", _ENFORCE_SIGNAL)
        signal.signal(_ENFORCE_SIGNAL, _handler)
        return True
    except ValueError:
        log.error("HBM enforcement needs the main thread (signal "
                  "handlers install there only); falling back to "
                  "log-only watchdog")
        return False


def mirror_visible_cards(spec: TenantSpec, nvml_lib=None) -> Optional[str]:
    """Mirror the plugin's card grant into ``CUDA_VISIBLE_DEVICES`` where
    a bare process needs it: only when the plugin wrote
    ``NVIDIA_VISIBLE_DEVICES``, nobody set ``CUDA_VISIBLE_DEVICES``, CUDA
    is not yet initialized, and NVML sees more cards than the grant names
    (inside a container the runtime already exposed just those, as CUDA
    device 0..). Returns the value written, else None. ``nvml_lib``
    injects an NVML library object (tests)."""
    if (not spec.chips or ENV_NVIDIA_VISIBLE_DEVICES not in os.environ
            or ENV_CUDA_VISIBLE_DEVICES in os.environ):
        return None
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        log.warning("CUDA was initialized before apply_tenant_limits(); "
                    "the card grant %s cannot be mirrored", spec.chips)
        return None
    from tpushare_torch.plugin.nvmldisc import (LIBRARY, Nvml, NvmlError,
                                                load_library)
    try:
        lib = nvml_lib if nvml_lib is not None else load_library(LIBRARY)
        with Nvml(lib) as nv:
            n = nv.count()
            if n <= len(spec.chips):
                return None
            uuids = [nv.uuid(nv.handle(i)) for i in spec.chips]
    except (OSError, NvmlError) as e:
        log.warning("no NVML to mirror the card grant %s (%s)", spec.chips, e)
        return None
    value = ",".join(uuids)
    os.environ[ENV_CUDA_VISIBLE_DEVICES] = value
    return value


def _apply_fraction(limit_bytes: int) -> None:
    """Cap every visible card's allocator at its share of the grant
    (spread evenly over the cards, of each card's own total; runs inside
    CUDA's lazy init, or at once when CUDA is up)."""
    import torch
    n = torch.cuda.device_count()
    for i in range(n):
        total = torch.cuda.get_device_properties(i).total_memory
        torch.cuda.set_per_process_memory_fraction(
            min(1.0, limit_bytes / n / total), device=i)


def apply_tenant_limits(enforce: Optional[str] = None, nvml_lib=None,
                        used_bytes_fn: Optional[Callable[[], int]] = None
                        ) -> TenantSpec:
    """Call in a card-sharing pod (main thread), before the first use of
    the card.

    - raises AllocationError on the poisoned err-as-env value;
    - mirrors the card grant into CUDA_VISIBLE_DEVICES where a bare
      process needs it (``mirror_visible_cards``);
    - caps the caching allocator at TPUSHARE_HBM_LIMIT_BYTES through
      ``torch.cuda.set_per_process_memory_fraction``, applied when CUDA
      initializes (``tenant_device()`` does it at once);
    - starts the ENFORCING HbmGuard (``enforce`` arg, default from
      TPUSHARE_HBM_ENFORCE, default "raise"): a watchdog that delivers
      SoftHbmOom to the main thread when the process's reserved bytes
      exceed its grant. "log" only logs; "off" disables the guard.
      CTPU_DISABLE=true (the node-label escape hatch) disables the
      fraction and the guard, mirroring the reference's cgpu-isolation
      switch (allocate.go:163-178).

    ``nvml_lib`` injects an NVML library object for the mirroring;
    ``used_bytes_fn`` replaces what the guard reads (a process on the
    host, which has no allocator figure, passes the bytes it holds).
    """
    global _enforcing_guard
    spec = read_tenant_env()
    mirror_visible_cards(spec, nvml_lib)
    if spec.hbm_limit_bytes and not spec.isolation_disabled:
        import torch
        limit = spec.hbm_limit_bytes
        torch.cuda._lazy_call(lambda: _apply_fraction(limit))
    mode = (enforce if enforce is not None
            else os.environ.get(ENV_HBM_ENFORCE, "raise"))
    if mode not in ("raise", "log", "off"):
        # An isolation knob fails CLOSED: a typo'd mode must not run
        # the pod with zero enforcement while the operator believes
        # it is on.
        log.error("unknown %s=%r; enforcing (valid: raise|log|off)",
                  ENV_HBM_ENFORCE, mode)
        mode = "raise"
    if _enforcing_guard is not None:     # re-init (incl. mode=off) never
        _enforcing_guard.stop()          # leaks the previous guard
        _enforcing_guard = None
    if (mode in ("raise", "log") and spec.hbm_limit_bytes
            and not spec.isolation_disabled):
        do_raise = mode == "raise" and _install_soft_oom_handler()
        _enforcing_guard = HbmGuard(
            limit_bytes=spec.hbm_limit_bytes,
            interval=0.05 if do_raise else 1.0,
            enforce=do_raise, used_bytes_fn=used_bytes_fn).start()
    log.info("tenant: chips=%s hbm_limit=%s enforce=%s "
             "isolation_disabled=%s", spec.chips, spec.hbm_limit_bytes,
             mode, spec.isolation_disabled)
    return spec


def tenant_device():
    """The tenant's card, CUDA initialized with the grant's fraction in
    force (``apply_tenant_limits`` first)."""
    import torch
    torch.cuda.init()
    return torch.device("cuda", 0)


class HbmGuard:
    """Cooperative memory watchdog: polls the process's reserved device
    bytes and calls ``on_breach`` (default: log an error) when they
    exceed its grant. With ``enforce=True`` a breach additionally raises
    SoftHbmOom in the main thread (via _ENFORCE_SIGNAL).

    Usage is ``torch.cuda.memory_reserved()`` summed over the visible
    cards: what the caching allocator holds, the figure the fraction
    caps. The CUDA context (~0.6 GB on an H100) and memory taken outside
    the allocator are not in it. The guard thread never initializes
    CUDA: before the process's own first use it reads 0."""

    #: min seconds between enforcement signals, so the tenant's
    #: MemoryError cleanup (free + report) isn't itself re-signaled.
    ENFORCE_COOLDOWN_S = 2.0

    def __init__(self, limit_bytes: Optional[int] = None, interval: float = 1.0,
                 on_breach=None, enforce: bool = False,
                 used_bytes_fn: Optional[Callable[[], int]] = None):
        spec = read_tenant_env() if limit_bytes is None else None
        self.limit = limit_bytes if limit_bytes is not None else (
            spec.hbm_limit_bytes if spec else None)
        self.interval = interval
        self.enforce = enforce
        self.on_breach = on_breach or (
            lambda used, limit: log.error(
                "HBM over budget: using %d bytes of %d allowed", used, limit))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._used_bytes_fn = used_bytes_fn
        self._last_signal = 0.0
        self.last_used = 0
        self.breaches = 0

    def _used_bytes(self) -> int:
        if self._used_bytes_fn is not None:
            return self._used_bytes_fn()
        torch = sys.modules.get("torch")
        if torch is None or not torch.cuda.is_initialized():
            return 0
        return sum(torch.cuda.memory_reserved(i)
                   for i in range(torch.cuda.device_count()))

    def _loop(self) -> None:
        import time as _time
        while not self._stop.wait(self.interval):
            used = self.last_used = self._used_bytes()
            if self.limit and used > self.limit:
                self.breaches += 1
                self.on_breach(used, self.limit)
                now = _time.monotonic()
                if (self.enforce
                        and now - self._last_signal > self.ENFORCE_COOLDOWN_S):
                    self._last_signal = now
                    signal.raise_signal(_ENFORCE_SIGNAL)

    def start(self) -> "HbmGuard":
        if self.enforce:
            # Direct HbmGuard(enforce=True) use (without
            # apply_tenant_limits) must still end in SoftHbmOom, not in
            # the signal's default disposition killing the process.
            global _enforcing_guard
            if not _install_soft_oom_handler():
                self.enforce = False
            elif _enforcing_guard is None:
                _enforcing_guard = self
        if self.limit:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="tpushare-hbm-guard")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2 * self.interval)

    def __enter__(self) -> "HbmGuard":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
