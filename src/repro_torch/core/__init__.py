"""Core homogenization library — the paper's contribution (port of
``repro.core``; the control plane is a JAX-free copy).

Control-plane (pure Python, coordinator-side):
  homogenization  — scope lengths, N_H, overhead model, speedup (Eqs. 1-9)
  performance     — heartbeat EMA tracker producing homogenized performance
  scheduler       — grain plans with hysteresis + elastic replan
  runtime         — async event loop: per-worker grain queues, completion-
                    event heartbeats, mid-job re-homogenization + stealing
  tda             — client/server/service-provider triangle, real execution
                    (torch tensors on one device)
  simulate        — discrete-event heterogeneous cluster (paper §3 testbed)
  wallclock       — measured ExecutionBackend: grains run as real torch
                    computations on the CUDA devices (wall-clock times)
"""

from .homogenization import (
    MAX_OVERHEAD_SLOPE,
    OverheadModel,
    equal_split,
    finish_times,
    homogenization_quality,
    overhead_slope_fit,
    predicted_speedup,
    predicted_time,
    scope_lengths,
    virtual_machine_count,
)
from .performance import PerformanceTracker, PerfReport, WorkerState
from .runtime import (
    ArrivalSource,
    AsyncRuntime,
    CallableGrainExecutor,
    DispatchAuthority,
    ExecutionBackend,
    GrainExecutor,
    GrainRecord,
    JobContext,
    RuntimeResult,
    SimBackend,
    SimWorker,
    SingleCoordinator,
    TimelineEvent,
)
from .wallclock import WallclockBackend, WallclockStats
from .scheduler import GrainPlan, HomogenizedScheduler, should_replan
from .simulate import PAPER_MACHINES, REF_SIZE, ClusterSim, JobResult, Machine
from .tda import ServiceProvider, TDAServer, ThinClient

__all__ = [
    "MAX_OVERHEAD_SLOPE",
    "OverheadModel",
    "equal_split",
    "finish_times",
    "homogenization_quality",
    "overhead_slope_fit",
    "predicted_speedup",
    "predicted_time",
    "scope_lengths",
    "virtual_machine_count",
    "PerformanceTracker",
    "PerfReport",
    "WorkerState",
    "GrainPlan",
    "HomogenizedScheduler",
    "should_replan",
    "ArrivalSource",
    "AsyncRuntime",
    "CallableGrainExecutor",
    "DispatchAuthority",
    "ExecutionBackend",
    "SimBackend",
    "WallclockBackend",
    "WallclockStats",
    "GrainExecutor",
    "GrainRecord",
    "JobContext",
    "RuntimeResult",
    "SimWorker",
    "SingleCoordinator",
    "TimelineEvent",
    "PAPER_MACHINES",
    "REF_SIZE",
    "ClusterSim",
    "JobResult",
    "Machine",
    "ServiceProvider",
    "TDAServer",
    "ThinClient",
]
