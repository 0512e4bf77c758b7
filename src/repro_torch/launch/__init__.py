"""Launch layer: production meshes, sharding rules, dry-run, drivers.

Importing it starts no process group and touches no device: the mesh
factories run over a group the caller started. ``repro_torch.launch.dryrun``
and ``repro_torch.launch.train`` are entry points, run as modules.
"""
from repro_torch.launch.mesh import (
    batch_axes_of,
    make_abstract_mesh,
    make_production_mesh,
    make_test_mesh,
)
from repro_torch.launch.shardings import (
    batch_shardings,
    decode_state_shardings,
    opt_shardings,
    param_shardings,
    param_spec,
)
from repro_torch.launch.specs import abstract_params, abstract_state, input_specs, make_step_bundle

__all__ = [
    "make_production_mesh", "make_test_mesh", "make_abstract_mesh", "batch_axes_of",
    "param_shardings", "opt_shardings", "batch_shardings",
    "decode_state_shardings", "param_spec", "input_specs",
    "abstract_params", "abstract_state", "make_step_bundle",
]
