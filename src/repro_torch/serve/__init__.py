"""Serving on the port: multi-tenant arenas with fused cross-tenant reads
(``tenants``) and the closed-loop load harness that verifies them
(``loadgen``).  The reference's pager and LM engine are later slices."""

from repro_torch.core.snapshot import (  # noqa: F401
    AdmissionShed,
    IndexSnapshot,
    SnapshotCell,
    SnapshotPin,
)

from . import loadgen, tenants  # noqa: F401
from .tenants import (  # noqa: F401
    Arena,
    MultiTenantEngine,
    SLOAdmissionController,
    SLOConfig,
    TenantRegistry,
)

__all__ = [
    "AdmissionShed",
    "Arena",
    "IndexSnapshot",
    "MultiTenantEngine",
    "SLOAdmissionController",
    "SLOConfig",
    "SnapshotCell",
    "SnapshotPin",
    "TenantRegistry",
    "loadgen",
    "tenants",
]
