"""The port's copy of ``tpushare/slo/__init__.py`` (stdlib only; a test holds it
equal to the original).

Multi-tenant SLO serving policy — jax-free.

The admission/scheduling brain the ServeEngine and the router both
consume: per-request priority tiers with deadlines, a deadline-aware
tick scheduler over the engine's ``--tick-token-budget``, per-tenant
KV-block quotas layered on the paged pool counters, and the per-tier
fairness/SLO counters ``/stats`` publishes for the router's shed
order and the ``/scale`` advisory.

jax-free by design (stdlib only): the router imports this in a
process with no device runtime, and the engine's tick must never pay
a device sync for a scheduling decision — every policy in here is
pure host arithmetic over host state.

Pieces:

- :mod:`tpushare_torch.slo.tiers` — the tier model (``interactive`` /
  ``standard`` / ``batch``): rank, weight, TTFT + per-token deadlines.
- :mod:`tpushare_torch.slo.sched` — ``TickScheduler``: priority admission
  queues (weighted fairness, strict-priority override on deadline
  risk), fused-chunk arbitration, preemption victim choice.
- :mod:`tpushare_torch.slo.quota` — ``KvQuota``: per-tenant KV-block
  reserve floor + burstable ceiling over the pool's free/LRU counters
  (the utils/tenant.py contract extended from HBM bytes to blocks).
- :mod:`tpushare_torch.slo.stats` — ``TierStats``: per-tier admitted /
  completed / preempted / breach counters and TTFT / per-token
  latency percentiles.
"""

from tpushare_torch.slo.quota import KvQuota, TenantQuotaSpec, parse_quota_spec
from tpushare_torch.slo.sched import TickScheduler, choose_victim
from tpushare_torch.slo.stats import TierStats
from tpushare_torch.slo.tiers import (DEFAULT_TIER, SHED_ORDER, TIER_ORDER,
                                TIERS, TierSpec, parse_tier, tier_rank)

__all__ = [
    "DEFAULT_TIER", "KvQuota", "SHED_ORDER", "TIER_ORDER", "TIERS",
    "TenantQuotaSpec", "TickScheduler", "TierSpec", "TierStats",
    "choose_victim", "parse_quota_spec", "parse_tier", "tier_rank",
]
