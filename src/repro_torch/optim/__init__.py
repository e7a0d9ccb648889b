"""Optimizers (`repro.optim`): AdamW and Adafactor as plain functions on
dicts of tensors."""
from repro_torch.optim.optimizers import (  # noqa: F401
    cosine_schedule, make_optimizer)
