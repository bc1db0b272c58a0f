"""One declarative Cluster API: fleet spec, scenario DSL, unified run reports.

  spec      FleetSpec / WorkerSpec — the declarative fleet description
            (compact-string grammar generalizing --replicas PERFxBATCH)
  scenario  Scenario — named fault scripts compiled to TimelineEvent streams
  profiles  BackendProfile — per-backend overhead slopes, calibrated via
            overhead_slope_fit (never hand-picked constants)
  report    RunReport / PhaseStats / WorkerTimeline — the one result type
  api       Cluster — .simulate(job) / .train(job) / .serve(job)
"""

from ..coord import CoordSpec, CoordStats
from .api import Cluster, MatmulJob, ServeJob, SimJob, TrainJob
from .profiles import (
    DEFAULT_PROFILE,
    PROFILES,
    BackendProfile,
    get_profile,
    load_profiles,
    refit_profile,
    register_profile,
    save_profiles,
    select_profile,
)
from .report import PhaseStats, RunReport, WorkerTimeline
from .scenario import Clause, ScaleRule, Scenario, ScenarioSchedule, TimeRef
from .spec import FleetSpec, WorkerSpec
from .workload import ArrivalPlan, materialize_workload

__all__ = [
    "Cluster",
    "SimJob",
    "MatmulJob",
    "TrainJob",
    "ServeJob",
    "FleetSpec",
    "WorkerSpec",
    "Scenario",
    "ScenarioSchedule",
    "Clause",
    "ScaleRule",
    "TimeRef",
    "ArrivalPlan",
    "materialize_workload",
    "CoordSpec",
    "CoordStats",
    "BackendProfile",
    "PROFILES",
    "DEFAULT_PROFILE",
    "get_profile",
    "register_profile",
    "select_profile",
    "refit_profile",
    "save_profiles",
    "load_profiles",
    "RunReport",
    "PhaseStats",
    "WorkerTimeline",
]
