"""Production mesh construction.

Defined as functions (never module-level constants) so importing this
module initialises no process group and no CUDA: a caller starts the
group (torchrun's environment, a ``file://`` store, or the dry-run's
fake group) and only then calls these.

Axis semantics (DESIGN.md §2): ``pod`` = inter-pod DP (the paper's
grid-site level), ``data`` = intra-pod DP / sequence sharding (the
paper's cluster nodes), ``model`` = TP/EP (the paper's cores). A mesh is
a ``torch.distributed`` ``DeviceMesh`` whose dimensions carry these
names; :func:`make_abstract_mesh` is its shape alone, for the sharding
rules.
"""
from __future__ import annotations

from typing import Dict, Tuple

__all__ = [
    "make_production_mesh",
    "make_test_mesh",
    "make_abstract_mesh",
    "batch_axes_of",
    "axis_sizes",
    "AbstractMesh",
]


class AbstractMesh:
    """A mesh's named shape and nothing else: no devices, no group.
    ``shape`` maps each axis name to its size, as JAX's ``AbstractMesh``."""

    def __init__(self, shape: Tuple[int, ...], names: Tuple[str, ...]):
        if len(shape) != len(names):
            raise ValueError(f"{len(names)} axis names {names} for a {len(shape)}-d mesh {shape}")
        self.axis_names = tuple(names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(n) for n in shape)))

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def make_abstract_mesh(shape: Tuple[int, ...], names: Tuple[str, ...]) -> AbstractMesh:
    return AbstractMesh(shape, names)


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of an :class:`AbstractMesh` or a named
    ``DeviceMesh``."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _device_mesh(shape: Tuple[int, ...], names: Tuple[str, ...], device_type: str):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The (16, 16) ``(data, model)`` mesh, or (2, 16, 16) ``(pod, data,
    model)``, over the running process group of 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(shape, axes, device_type)


def make_test_mesh(data: int = 1, model: int = 1, *, device_type: str = "cuda"):
    """A small ``(data, model)`` mesh over the running process group."""
    return _device_mesh((data, model), ("data", "model"), device_type)


def batch_axes_of(mesh) -> Tuple[str, ...]:
    names = tuple(getattr(mesh, "axis_names", None) or mesh.mesh_dim_names)
    return tuple(a for a in ("pod", "data") if a in names)
