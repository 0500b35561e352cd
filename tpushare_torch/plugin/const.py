"""Resource names, socket paths, annotation/env contract: the port's copy
of ``tpushare/plugin/const.py``.

Every name and value of the original is kept (the ``aliyun.com/tpu-mem``
resource, the ``ALIYUN_COM_TPU_MEM_*`` annotations and env, the legacy
GPU-spelled keys read as fallbacks, ``TPUSHARE_HBM_LIMIT_BYTES``), so the
scheduler extender drives this plugin and the TPU one unchanged. One name
is added: ``ENV_NVIDIA_VISIBLE_DEVICES``, the reference plugin's card
selector (allocate.go:114-128). A test holds every other name equal to
the original's.
"""

# Extended resources advertised to the cluster.
RESOURCE_NAME = "aliyun.com/tpu-mem"     # fake-device resource (per memory unit)
RESOURCE_COUNT = "aliyun.com/tpu-count"  # physical chip count, patched on node status
RESOURCE_CORE = "aliyun.com/tpu-core"    # per-host TensorCore count, patched on node status

# Legacy resource name accepted when summing a pod's request so GPU-era
# pod specs keep scheduling during migration (podutils.pod_requested_mem).
LEGACY_RESOURCE_NAME = "aliyun.com/gpu-mem"
# Legacy chip-count resource read by the inspect CLI on GPU-era nodes.
LEGACY_RESOURCE_COUNT = "aliyun.com/gpu-count"

# Plugin socket inside the kubelet device-plugin dir
# (reference: const.go:13 "aliyungpushare.sock").
SERVER_SOCK_NAME = "aliyuntpushare.sock"

# Exact string match used to detect an apiserver optimistic-lock
# conflict on annotation patch (reference: const.go:15, allocate.go:140).
OPTIMISTIC_LOCK_ERROR_MSG = (
    "the object has been modified; please apply your changes to the "
    "latest version and try again"
)

# ---------------------------------------------------------------------------
# Scheduler-extender <-> plugin annotation keys (on the Pod).
# Reference GPU dialect: const.go:25-31. TPU dialect is primary.
# ---------------------------------------------------------------------------
ANN_RESOURCE_INDEX = "ALIYUN_COM_TPU_MEM_IDX"          # extender's chosen chip index(es)
ANN_RESOURCE_BY_POD = "ALIYUN_COM_TPU_MEM_POD"
ANN_RESOURCE_BY_CONTAINER = "ALIYUN_COM_TPU_MEM_CONTAINER"
ANN_RESOURCE_BY_DEV = "ALIYUN_COM_TPU_MEM_DEV"
ANN_ASSIGNED_FLAG = "ALIYUN_COM_TPU_MEM_ASSIGNED"      # "false" until plugin flips it
ANN_ASSUME_TIME = "ALIYUN_COM_TPU_MEM_ASSUME_TIME"     # ns timestamp set by extender
ANN_ASSIGN_TIME = "ALIYUN_COM_TPU_MEM_ASSIGN_TIME"     # ns timestamp set by plugin

# Legacy (GPU-spelled) fallbacks, read-compatible with the unmodified
# gpushare scheduler extender (reference const.go:25-31).
LEGACY_ANN_RESOURCE_INDEX = "ALIYUN_COM_GPU_MEM_IDX"
LEGACY_ANN_ASSIGNED_FLAG = "ALIYUN_COM_GPU_MEM_ASSIGNED"
LEGACY_ANN_ASSUME_TIME = "ALIYUN_COM_GPU_MEM_ASSUME_TIME"

# Newer per-container allocation map written by the scheduler-framework
# flavor of the extender (reference: cmd/inspect/main.go:25).
ANN_ALLOCATION_JSON = "scheduler.framework.tpushare.allocation"
LEGACY_ANN_ALLOCATION_JSON = "scheduler.framework.gpushare.allocation"

# ---------------------------------------------------------------------------
# Env vars injected into allocated containers (reference: allocate.go:114-128
# injects NVIDIA_VISIBLE_DEVICES + ALIYUN_COM_GPU_MEM_*).
# ---------------------------------------------------------------------------
ENV_TPU_VISIBLE_CHIPS = "TPU_VISIBLE_CHIPS"        # libtpu chip selector ("0" / "0,1")
ENV_TPU_VISIBLE_DEVICES = "TPU_VISIBLE_DEVICES"    # older libtpu spelling, injected too
ENV_TPU_PROCESS_BOUNDS = "TPU_PROCESS_BOUNDS"      # sub-host mesh: process grid, e.g. "1,1,1"
ENV_TPU_CHIPS_PER_PROCESS_BOUNDS = "TPU_CHIPS_PER_PROCESS_BOUNDS"  # e.g. "2,2,1"
# The card selector the NVIDIA container runtime reads ("0" / "0,1"),
# written by the port's Allocate in place of the TPU_* selection env.
ENV_NVIDIA_VISIBLE_DEVICES = "NVIDIA_VISIBLE_DEVICES"
ENV_RESOURCE_INDEX = ANN_RESOURCE_INDEX            # chip index(es) chosen for this pod
ENV_RESOURCE_BY_POD = ANN_RESOURCE_BY_POD          # mem units requested by the whole pod
ENV_RESOURCE_BY_CONTAINER = ANN_RESOURCE_BY_CONTAINER  # mem units for this container
ENV_RESOURCE_BY_DEV = ANN_RESOURCE_BY_DEV          # mem units per physical chip
# Cooperative HBM ceiling for the tenant process, consumed by
# tpushare.utils.tenant.apply_tenant_limits() inside the pod (the
# TPU-side replacement for the cGPU kernel module's hard isolation).
ENV_HBM_LIMIT_BYTES = "TPUSHARE_HBM_LIMIT_BYTES"
ENV_HBM_ENFORCE = "TPUSHARE_HBM_ENFORCE"           # raise | log | off (tenant-side soft OOM)
ENV_DISABLE_ISOLATION = "CTPU_DISABLE"             # analog of CGPU_DISABLE (allocate.go:163-178)
# KV-pool block quota for the tenant's serving engine — the HBM-byte
# contract extended to the unit the engine actually allocates
# (tpushare.utils.tenant.kv_quota_env / tpushare.slo.quota.KvQuota):
# a guaranteed reserve floor and a burstable ceiling, in pool blocks.
ENV_KV_BLOCK_RESERVE = "TPUSHARE_KV_BLOCK_RESERVE"
ENV_KV_BLOCK_LIMIT = "TPUSHARE_KV_BLOCK_LIMIT"

# Node annotation where the plugin publishes its host ICI mesh so the
# scheduler extender can make topology-aware multi-chip choices without
# a daemon RPC (no reference analog: GPU indices are flat, a TPU host
# is a mesh and diagonal chip pairs cannot form a JAX sub-mesh).
ANN_NODE_TOPOLOGY = "aliyun.com/tpu-topology"

# Node label that turns off isolation-env injection per node
# (reference: const.go:32 "cgpu.disable.isolation", podmanager.go:62-75).
NODE_LABEL_DISABLE_ISOLATION = "ctpu.disable.isolation"

# ---------------------------------------------------------------------------
# Multi-host gang contract (no reference analog: the reference shares
# one GPU among pods; a TPU *slice* spans hosts and its pods must form
# one jax.distributed job). The operator marks every pod of the tenant
# with the user-set keys; the extender assigns ranks in bind order and
# stamps the coordinator (rank 0's node address); the plugin's Allocate
# injects the env contract parallel/multihost.initialize() consumes.
# ---------------------------------------------------------------------------
ANN_GANG_NAME = "aliyun.com/tpu-gang-name"   # user-set, shared within the gang (per namespace)
ANN_GANG_SIZE = "aliyun.com/tpu-gang-size"   # user-set, total processes
ANN_GANG_PORT = "aliyun.com/tpu-gang-port"   # user-set, coordinator port (optional)
# Extender-written. DNS-prefixed like their user-set siblings — the
# uppercase ALIYUN_COM_* spelling elsewhere in this file mirrors the
# reference's wire contract (const.go:25-31); the gang keys are new
# and follow the k8s convention instead.
ANN_GANG_RANK = "aliyun.com/tpu-gang-rank"
ANN_GANG_COORDINATOR = "aliyun.com/tpu-gang-coordinator"
DEFAULT_GANG_PORT = 8476

# Env injected for gang members; spellings match
# tpushare/parallel/multihost.py (which must not be imported here — it
# pulls in jax).
ENV_COORDINATOR = "TPUSHARE_COORDINATOR"
ENV_NUM_PROCESSES = "TPUSHARE_NUM_PROCESSES"
ENV_PROCESS_ID = "TPUSHARE_PROCESS_ID"

# Pod annotation selecting the extender's chip-choice policy (no
# reference analog — its companion extender is bin-pack only).
# "binpack" (default): fullest chip that fits, consolidating small
# tenants so whole chips stay free for multi-chip grants.
# "spread": emptiest chip that fits — for compute-bound saturation
# workloads (BASELINE.md row 4) that want one pod per chip.
ANN_PLACEMENT_POLICY = "aliyun.com/tpu-placement"
PLACEMENT_BINPACK = "binpack"
PLACEMENT_SPREAD = "spread"
LEGACY_NODE_LABEL_DISABLE_ISOLATION = "cgpu.disable.isolation"

# Node labels read by the inspect CLI (reference: cmd/inspect/main.go:16-18).
LABEL_CHIP_COUNT = "aliyun.accelerator/tpu_count"
LABEL_CHIP_NAME = "aliyun.accelerator/tpu_name"
LABEL_CHIP_MEM = "aliyun.accelerator/tpu_mem"

# Memory units (reference: const.go:34-35 + cmd/nvidia/main.go:67-78).
GIB = "GiB"
MIB = "MiB"
MEMORY_UNIT_BYTES = {GIB: 1 << 30, MIB: 1 << 20}


def normalize_memory_unit(unit: str) -> str:
    """Normalize a --memory-unit flag value; TPU analog of
    translatememoryUnits (reference: cmd/nvidia/main.go:67-78)."""
    u = unit.strip()
    if u.lower() in ("gib", "gi", "g"):
        return GIB
    if u.lower() in ("mib", "mi", "m"):
        return MIB
    raise ValueError(f"unsupported memory unit {unit!r}; use GiB or MiB")
