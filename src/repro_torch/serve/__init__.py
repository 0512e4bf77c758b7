"""Serving layer of the port: continuous-batched multi-tenant sparse
solving (:mod:`repro_torch.serve.sparse`), driven by a background tick
thread (:mod:`repro_torch.serve.driver`) — the sparse-serving names of
the JAX package's ``repro.serve``. Its wave-batched LM engine is not
ported yet (ROADMAP.md, Queue 1, item 8)."""
from repro_torch.serve.driver import ServeDriver
from repro_torch.serve.metrics import ServeMetrics, TenantMetrics, percentile
from repro_torch.serve.sparse import (
    QueueFullError,
    SparseServeEngine,
    Status,
    TenantQuotaError,
    Ticket,
)

__all__ = [
    "ServeDriver",
    "ServeMetrics",
    "TenantMetrics",
    "percentile",
    "QueueFullError",
    "TenantQuotaError",
    "SparseServeEngine",
    "Status",
    "Ticket",
]
