"""Optimizers of the port (`optimizers`) and the int8 gradient codes of
`compress`, counterparts of `repro.optim`."""
from repro_torch.optim.optimizers import (
    Optimizer, adafactor, adamw, clip_by_global_norm, get_optimizer,
    warmup_cosine_schedule,
)
from repro_torch.optim import compress

__all__ = [
    "Optimizer", "adamw", "adafactor", "get_optimizer",
    "clip_by_global_norm", "warmup_cosine_schedule", "compress",
]
