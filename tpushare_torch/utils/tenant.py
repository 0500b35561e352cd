"""In-pod tenant contract: read the env the plugin injected. The port's
copy of the env half of ``tpushare/utils/tenant.py`` (``AllocationError``,
``TenantSpec``, ``_int_env``, ``read_tenant_env``, ``kv_quota_env``),
with the env-var names it reads from ``tpushare/plugin/const.py``. The
HBM guard (``HbmGuard``, ``apply_tenant_limits``) waits for ROADMAP
A11; a test holds the copies equal to the originals."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

ENV_TPU_VISIBLE_CHIPS = "TPU_VISIBLE_CHIPS"
ENV_TPU_VISIBLE_DEVICES = "TPU_VISIBLE_DEVICES"
ENV_RESOURCE_BY_POD = "ALIYUN_COM_TPU_MEM_POD"
ENV_RESOURCE_BY_CONTAINER = "ALIYUN_COM_TPU_MEM_CONTAINER"
ENV_RESOURCE_BY_DEV = "ALIYUN_COM_TPU_MEM_DEV"
ENV_HBM_LIMIT_BYTES = "TPUSHARE_HBM_LIMIT_BYTES"
ENV_DISABLE_ISOLATION = "CTPU_DISABLE"
ENV_KV_BLOCK_RESERVE = "TPUSHARE_KV_BLOCK_RESERVE"
ENV_KV_BLOCK_LIMIT = "TPUSHARE_KV_BLOCK_LIMIT"


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


def read_tenant_env() -> TenantSpec:
    visible = os.environ.get(ENV_TPU_VISIBLE_CHIPS,
                             os.environ.get(ENV_TPU_VISIBLE_DEVICES, ""))
    if visible.startswith("no-tpu-has-") or visible.startswith("no-gpu-has-"):
        raise AllocationError(
            f"tpushare could not satisfy this pod's memory request "
            f"({ENV_TPU_VISIBLE_CHIPS}={visible!r}); the scheduler "
            f"admitted the pod but no chip had room — fix the request or "
            f"free capacity")
    chips = [int(p) for p in visible.split(",") if p.strip().isdigit()]
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
