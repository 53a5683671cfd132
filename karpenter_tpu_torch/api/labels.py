"""Well-known labels and resource names.

Mirrors the label vocabulary of the reference: core labels consumed at
pkg/providers/instancetype/types.go:70-149 and provider labels declared at
pkg/apis/v1beta1/labels.go:104-125.  We keep the upstream Kubernetes and
karpenter.sh core labels verbatim (so pod specs are portable) and place
provider-specific labels under the ``karpenter.tpu`` domain.

Port copy of ``karpenter_tpu/api/labels.py``.
"""

# --- core kubernetes topology/identity labels -------------------------------
LABEL_ARCH = "kubernetes.io/arch"
LABEL_OS = "kubernetes.io/os"
LABEL_ZONE = "topology.kubernetes.io/zone"
LABEL_REGION = "topology.kubernetes.io/region"
LABEL_INSTANCE_TYPE = "node.kubernetes.io/instance-type"
LABEL_HOSTNAME = "kubernetes.io/hostname"
LABEL_WINDOWS_BUILD = "node.kubernetes.io/windows-build"

# --- karpenter core labels (reference: karpenter-core v1beta1) --------------
LABEL_CAPACITY_TYPE = "karpenter.sh/capacity-type"
LABEL_NODEPOOL = "karpenter.sh/nodepool"
LABEL_NODE_INITIALIZED = "karpenter.sh/initialized"
LABEL_NODE_REGISTERED = "karpenter.sh/registered"

ANNOTATION_DO_NOT_EVICT = "karpenter.sh/do-not-evict"
ANNOTATION_DO_NOT_CONSOLIDATE = "karpenter.sh/do-not-consolidate"
ANNOTATION_NODECLASS_HASH = "karpenter.tpu/nodeclass-hash"
ANNOTATION_POD_DELETION_COST = "controller.kubernetes.io/pod-deletion-cost"
ANNOTATION_MANAGED_BY = "karpenter.sh/managed-by"

CAPACITY_TYPE_ON_DEMAND = "on-demand"
CAPACITY_TYPE_SPOT = "spot"
CAPACITY_TYPE_RESERVED = "reserved"

# --- provider (instance-type catalog) labels --------------------------------
# Reference analogues: pkg/apis/v1beta1/labels.go:104-125 (instance-category,
# -family, -generation, -size, -cpu, -memory, -network-bandwidth, gpu/accel).
LABEL_INSTANCE_CATEGORY = "karpenter.tpu/instance-category"
LABEL_INSTANCE_FAMILY = "karpenter.tpu/instance-family"
LABEL_INSTANCE_GENERATION = "karpenter.tpu/instance-generation"
LABEL_INSTANCE_SIZE = "karpenter.tpu/instance-size"
LABEL_INSTANCE_CPU = "karpenter.tpu/instance-cpu"
LABEL_INSTANCE_MEMORY = "karpenter.tpu/instance-memory"
LABEL_INSTANCE_NETWORK_BANDWIDTH = "karpenter.tpu/instance-network-bandwidth"
LABEL_INSTANCE_HYPERVISOR = "karpenter.tpu/instance-hypervisor"
LABEL_INSTANCE_ENCRYPTION_IN_TRANSIT = (
    "karpenter.tpu/instance-encryption-in-transit-supported"
)
LABEL_INSTANCE_LOCAL_NVME = "karpenter.tpu/instance-local-nvme"
LABEL_INSTANCE_GPU_NAME = "karpenter.tpu/instance-gpu-name"
LABEL_INSTANCE_GPU_MANUFACTURER = "karpenter.tpu/instance-gpu-manufacturer"
LABEL_INSTANCE_GPU_COUNT = "karpenter.tpu/instance-gpu-count"
LABEL_INSTANCE_GPU_MEMORY = "karpenter.tpu/instance-gpu-memory"
LABEL_INSTANCE_ACCELERATOR_NAME = "karpenter.tpu/instance-accelerator-name"
LABEL_INSTANCE_ACCELERATOR_MANUFACTURER = (
    "karpenter.tpu/instance-accelerator-manufacturer"
)
LABEL_INSTANCE_ACCELERATOR_COUNT = "karpenter.tpu/instance-accelerator-count"

# Labels that are per-node-unique and therefore never constrain instance-type
# selection (reference: karpenter-core scheduling ignores hostname when
# matching instance types).
RESTRICTED_FROM_TYPE_MATCHING = frozenset({LABEL_HOSTNAME})

# Catalog labels: the labels an instance type itself defines.  When matching
# requirements against instance types, a requirement on a key OUTSIDE this
# set that the type doesn't define is satisfiable anyway — it becomes a node
# label stamped by the pool (karpenter-core's
# AllowUndefinedWellKnownLabels compatibility mode).
CATALOG_LABELS = frozenset(
    {
        LABEL_ARCH,
        LABEL_OS,
        LABEL_ZONE,
        LABEL_REGION,
        LABEL_INSTANCE_TYPE,
        LABEL_WINDOWS_BUILD,
        LABEL_CAPACITY_TYPE,
        LABEL_INSTANCE_CATEGORY,
        LABEL_INSTANCE_FAMILY,
        LABEL_INSTANCE_GENERATION,
        LABEL_INSTANCE_SIZE,
        LABEL_INSTANCE_CPU,
        LABEL_INSTANCE_MEMORY,
        LABEL_INSTANCE_NETWORK_BANDWIDTH,
        LABEL_INSTANCE_HYPERVISOR,
        LABEL_INSTANCE_ENCRYPTION_IN_TRANSIT,
        LABEL_INSTANCE_LOCAL_NVME,
        LABEL_INSTANCE_GPU_NAME,
        LABEL_INSTANCE_GPU_MANUFACTURER,
        LABEL_INSTANCE_GPU_COUNT,
        LABEL_INSTANCE_GPU_MEMORY,
        LABEL_INSTANCE_ACCELERATOR_NAME,
        LABEL_INSTANCE_ACCELERATOR_MANUFACTURER,
        LABEL_INSTANCE_ACCELERATOR_COUNT,
    }
)

# --- resource names ---------------------------------------------------------
RESOURCE_CPU = "cpu"
RESOURCE_MEMORY = "memory"
RESOURCE_PODS = "pods"
RESOURCE_EPHEMERAL_STORAGE = "ephemeral-storage"
RESOURCE_GPU = "gpu.karpenter.tpu/accelerator"
RESOURCE_TPU = "tpu.karpenter.tpu/chips"
RESOURCE_POD_ENI = "vpc.karpenter.tpu/pod-eni"

# Canonical axis order of the dense resource tensors; every Resources vector
# is projected onto this basis plus any extended names discovered at
# tensorization time (scheduling/tensorize.py).
WELL_KNOWN_RESOURCES = (
    RESOURCE_CPU,
    RESOURCE_MEMORY,
    RESOURCE_PODS,
    RESOURCE_EPHEMERAL_STORAGE,
    RESOURCE_GPU,
    RESOURCE_TPU,
)

TAINT_EFFECT_NO_SCHEDULE = "NoSchedule"
TAINT_EFFECT_PREFER_NO_SCHEDULE = "PreferNoSchedule"
TAINT_EFFECT_NO_EXECUTE = "NoExecute"

# Karpenter-core taints the node while disrupting it.
TAINT_DISRUPTION_KEY = "karpenter.sh/disruption"
