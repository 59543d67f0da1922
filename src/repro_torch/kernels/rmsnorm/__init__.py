from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_plain

__all__ = ["rmsnorm", "rmsnorm_plain"]
