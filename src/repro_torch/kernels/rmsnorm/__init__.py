from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_ref  # noqa: F401
