"""Runtime of the port: the Level-2 co-residency executor and LM train tenants."""
from repro_torch.runtime.lm_train import make_train_tenant, train_step
from repro_torch.runtime.multitenant import FusedCoRunner, QuantumExecutor, Tenant, fuse_tenants

__all__ = ["FusedCoRunner", "QuantumExecutor", "Tenant", "fuse_tenants", "make_train_tenant",
           "train_step"]
