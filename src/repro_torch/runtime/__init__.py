"""Multi-tenant runtime: the batched fleet scheduler and the typed errors
of the serving stack."""

from repro_torch.runtime.fleet import FleetRequest, FleetStats, LRUCache, PixieFleet
from repro_torch.runtime.resilience import (
    DispatchError, JobTimeout, QuarantinedError, ServiceError,
)

__all__ = [
    "FleetRequest", "FleetStats", "LRUCache", "PixieFleet",
    "ServiceError", "DispatchError", "QuarantinedError", "JobTimeout",
]
