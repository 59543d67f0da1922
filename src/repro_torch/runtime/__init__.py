"""Runtime of the port: the Level-2 co-residency executor, LM train tenants
and the serve step factories."""
from repro_torch.runtime.lm_train import make_train_tenant, train_step
from repro_torch.runtime.multitenant import FusedCoRunner, QuantumExecutor, Tenant, fuse_tenants
from repro_torch.runtime.steps import make_decode_step, make_prefill_step

__all__ = ["FusedCoRunner", "QuantumExecutor", "Tenant", "fuse_tenants", "make_decode_step",
           "make_prefill_step", "make_train_tenant", "train_step"]
