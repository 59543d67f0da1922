"""Runtime of the port: the Level-2 co-residency executor, LM train tenants,
the train and serve step factories and the elastic checkpoint-restart loop."""
from repro_torch.runtime.elastic import (
    ElasticTrainer, FailureEvent, Mesh, make_mesh, rebalance_bounds, surviving_mesh,
)
from repro_torch.runtime.lm_train import make_train_tenant
from repro_torch.runtime.multitenant import FusedCoRunner, QuantumExecutor, Tenant, fuse_tenants
from repro_torch.runtime.steps import (
    abstract_state, batch_specs, make_decode_step, make_prefill_step, make_train_step,
    train_input_specs, train_step,
)

__all__ = ["ElasticTrainer", "FailureEvent", "FusedCoRunner", "Mesh", "QuantumExecutor",
           "Tenant", "abstract_state", "batch_specs", "fuse_tenants", "make_decode_step",
           "make_mesh", "make_prefill_step", "make_train_step", "make_train_tenant",
           "rebalance_bounds", "surviving_mesh", "train_input_specs", "train_step"]
