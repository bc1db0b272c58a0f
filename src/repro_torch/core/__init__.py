"""Core homogenization library — the paper's contribution (JAX-free copy).

Control-plane (pure Python, coordinator-side):
  homogenization  — scope lengths, N_H, overhead model, speedup (Eqs. 1-9)
  performance     — heartbeat EMA tracker producing homogenized performance
  scheduler       — grain plans with hysteresis + elastic replan
  runtime         — async event loop: per-worker grain queues, completion-
                    event heartbeats, mid-job re-homogenization + stealing
  simulate        — discrete-event heterogeneous cluster (paper §3 testbed)

``tda`` (the client/server/provider triangle) and ``wallclock`` (the
measured backend) come with the matmul slice of the port.
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
from .scheduler import GrainPlan, HomogenizedScheduler, should_replan
from .simulate import PAPER_MACHINES, REF_SIZE, ClusterSim, JobResult, Machine

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
]
