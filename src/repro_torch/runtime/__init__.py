"""Runtime of the port: the Level-2 co-residency executor."""
from repro_torch.runtime.multitenant import FusedCoRunner, QuantumExecutor, Tenant, fuse_tenants

__all__ = ["FusedCoRunner", "QuantumExecutor", "Tenant", "fuse_tenants"]
