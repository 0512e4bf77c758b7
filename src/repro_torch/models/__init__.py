"""The port's language models (:mod:`repro_torch.models.api`), weights
carried across from the JAX package by :mod:`repro_torch.models.interop`."""
from repro_torch.models.api import Model, build
from repro_torch.models.common import Params
from repro_torch.models.interop import lm_from_numpy, lm_to_numpy
from repro_torch.models.moe import MeshCtx

__all__ = ["Model", "build", "MeshCtx", "Params", "lm_from_numpy", "lm_to_numpy"]
