"""Serving surface: the futures API, the synchronous and streaming fleet
front-ends and the LM serving engine."""

from repro_torch.serve.engine import ServeConfig, ServeEngine, SlotServer
from repro_torch.serve.fleet_frontend import FleetFrontend
from repro_torch.serve.service import (
    AdmissionError, DispatchError, ImageJob, ImageService, JobHandle,
    JobTimeout, LatencyStats, QuarantinedError, ServiceError,
)
from repro_torch.serve.streaming import StreamingFrontend

__all__ = [
    "ServeConfig", "ServeEngine", "SlotServer",
    "FleetFrontend", "StreamingFrontend",
    "ImageService", "ImageJob", "JobHandle",
    "LatencyStats", "AdmissionError",
    "ServiceError", "DispatchError", "QuarantinedError", "JobTimeout",
]
