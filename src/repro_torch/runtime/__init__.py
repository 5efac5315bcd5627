"""Multi-tenant runtime: the batched fleet scheduler with its self-healing
ladder, deterministic fault injection, the crash-restart protocol,
straggler detection and the typed errors of the serving stack."""

from repro_torch.runtime.chaos import FaultInjector, FaultSpec, InjectedFault
from repro_torch.runtime.fault_tolerance import (
    ElasticPlan, HeartbeatMonitor, RunState, resume_or_init,
)
from repro_torch.runtime.fleet import (
    FleetRequest, FleetStats, LazyOutput, LRUCache, PixieFleet,
)
from repro_torch.runtime.resilience import (
    BreakerBoard, CircuitBreaker, DispatchError, JobTimeout,
    PoisonedOutputError, QuarantinedError, RetryPolicy, ServiceError,
    TransientError,
)

__all__ = [
    "ElasticPlan", "HeartbeatMonitor", "RunState", "resume_or_init",
    "FleetRequest", "FleetStats", "LazyOutput", "LRUCache", "PixieFleet",
    "FaultInjector", "FaultSpec", "InjectedFault",
    "BreakerBoard", "CircuitBreaker", "RetryPolicy",
    "ServiceError", "DispatchError", "QuarantinedError", "JobTimeout",
    "PoisonedOutputError", "TransientError",
]
