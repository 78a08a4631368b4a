"""Serving on the port: the paged KV-cache manager whose page index is a
reconstructable B-tree (``pager``), multi-tenant arenas with fused
cross-tenant reads (``tenants``), and the closed-loop load harnesses that
verify reads racing rebuilds on both (``loadgen``).  The LM engine is a
later slice."""

from repro_torch.core.snapshot import (  # noqa: F401
    AdmissionShed,
    IndexSnapshot,
    SnapshotCell,
    SnapshotPin,
)

from . import loadgen, pager, tenants  # noqa: F401
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
    "pager",
    "tenants",
]
