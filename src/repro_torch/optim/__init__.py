"""The port's optimizer: the JAX package's AdamW (:mod:`repro_torch.optim.adamw`)."""
from repro_torch.optim.adamw import (
    OptState,
    compress_int8,
    cosine_lr,
    global_norm,
    init_opt,
    opt_update,
)

__all__ = ["OptState", "init_opt", "opt_update", "cosine_lr", "global_norm", "compress_int8"]
