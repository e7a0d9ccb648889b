from repro_torch.kernels.topk_router.ops import (  # noqa: F401
    topk_router, topk_router_bwd, topk_router_bwd_ref, topk_router_ref)
