"""Serving surface: the futures API and the synchronous fleet front-end."""

from repro_torch.serve.fleet_frontend import FleetFrontend
from repro_torch.serve.service import (
    AdmissionError, DispatchError, ImageJob, ImageService, JobHandle,
    JobTimeout, LatencyStats, QuarantinedError, ServiceError,
)

__all__ = [
    "FleetFrontend",
    "ImageService", "ImageJob", "JobHandle",
    "LatencyStats", "AdmissionError",
    "ServiceError", "DispatchError", "QuarantinedError", "JobTimeout",
]
