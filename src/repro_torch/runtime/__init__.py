"""The runtime of the port: failure injection, heartbeats and straggler
monitors (:mod:`repro_torch.runtime.fault`, a copy of the JAX
package's) and elastic re-placement on a mesh of devices
(:mod:`repro_torch.runtime.elastic`) — the names the JAX package's
``repro.runtime`` exports. Importing it loads neither JAX nor any module
of the JAX package."""
from repro_torch.runtime.fault import FaultInjector, Heartbeat, StragglerMonitor, WorkerFailure
from repro_torch.runtime.elastic import elastic_restart, make_mesh_any, reshard_tree

__all__ = ["FaultInjector", "WorkerFailure", "Heartbeat", "StragglerMonitor",
           "make_mesh_any", "reshard_tree", "elastic_restart"]
