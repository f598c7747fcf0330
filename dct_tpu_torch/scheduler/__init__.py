"""Multi-tenant workload scheduler (counterpart of ``dct_tpu/scheduler``):
N always-on tenants sharing one card with chip-time quota, priority
classes, and fault isolation at round-lease granularity."""

from dct_tpu_torch.scheduler.quota import QuotaLedger, TenantLedger
from dct_tpu_torch.scheduler.scheduler import TenantRuntime, WorkloadScheduler
from dct_tpu_torch.scheduler.spec import (
    PRIORITIES,
    RESERVED_ENV,
    TenantSpec,
    TenantSpecError,
    parse_tenants,
    tenants_from_env,
)

__all__ = [
    "PRIORITIES",
    "RESERVED_ENV",
    "QuotaLedger",
    "TenantLedger",
    "TenantRuntime",
    "TenantSpec",
    "TenantSpecError",
    "WorkloadScheduler",
    "parse_tenants",
    "tenants_from_env",
]
