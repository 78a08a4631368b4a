"""Serving on the port: the paged KV-cache manager whose page index is a
reconstructable B-tree (``pager``), multi-tenant arenas with fused
cross-tenant reads (``tenants``), and the closed-loop load harnesses that
verify reads racing rebuilds on both (``loadgen``), and the LM serving
engine over the pager (``engine.ServeEngine``)."""

from repro_torch.core.snapshot import (  # noqa: F401
    AdmissionShed,
    IndexSnapshot,
    SnapshotCell,
    SnapshotPin,
)

from . import engine, loadgen, pager, tenants  # noqa: F401
from .engine import ServeEngine  # noqa: F401
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
    "ServeEngine",
    "SnapshotPin",
    "TenantRegistry",
    "engine",
    "loadgen",
    "pager",
    "tenants",
]
