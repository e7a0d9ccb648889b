from repro_torch.kernels.selective_flush.ops import (  # noqa: F401
    drain_writeback, drain_writeback_bool, drain_writeback_bool_many,
    drain_writeback_many, drain_writeback_ref,
    selective_apply, selective_flush, selective_flush_ref)
