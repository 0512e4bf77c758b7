"""The mesh context threaded through the models.

The JAX package's MoE layer lives in this module there; the port holds
only :class:`MeshCtx` so far, so that ``build`` and the serving engine
keep the reference's signatures. The expert-parallel layer and the
sharded (mesh) paths are still to be ported (ROADMAP.md, Queue 1,
item 8).
"""
from __future__ import annotations

from typing import Tuple

__all__ = ["MeshCtx"]


class MeshCtx:
    """Mesh + axis-name context threaded through models.

    ``batch_axes`` shard the token batch; ``model_axis`` shards heads /
    ffn / experts. ``mesh=None`` is the single-device path, the only one
    the port has: a device mesh raises ``NotImplementedError``.
    """

    def __init__(
        self,
        mesh=None,
        batch_axes: Tuple[str, ...] = ("data",),
        model_axis: str = "model",
    ):
        if mesh is not None:
            raise NotImplementedError(
                "sharded model paths are not ported yet (ROADMAP.md, Queue 1, item 8): "
                "pass mesh=None"
            )
        self.mesh = mesh
        self.batch_axes = tuple(batch_axes)
        self.model_axis = model_axis
