from repro_torch.kernels.rmsnorm.ops import (  # noqa: F401
    rmsnorm, rmsnorm_bwd, rmsnorm_bwd_ref, rmsnorm_ref)
