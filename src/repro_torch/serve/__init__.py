"""Serving layer of the port: wave-batched LM decoding
(:mod:`repro_torch.serve.engine`) and continuous-batched multi-tenant
sparse solving (:mod:`repro_torch.serve.sparse`), driven by a background
tick thread (:mod:`repro_torch.serve.driver`) — the names of the JAX
package's ``repro.serve``."""
from repro_torch.serve.driver import ServeDriver
from repro_torch.serve.engine import Request, ServeEngine, greedy_generate
from repro_torch.serve.metrics import ServeMetrics, TenantMetrics, percentile
from repro_torch.serve.sparse import (
    QueueFullError,
    SparseServeEngine,
    Status,
    TenantQuotaError,
    Ticket,
)

__all__ = [
    "Request",
    "ServeEngine",
    "greedy_generate",
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
