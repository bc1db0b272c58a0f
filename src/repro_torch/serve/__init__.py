from .disagg import DisaggExecutor, RoleStats, TTFTSplit
from .dispatch import DispatchResult, HomogenizedDispatcher, Replica
from .engine import DecodeEngine, KVHandoff, Request
from .executor import EngineExecutor
from .fleet import (
    BundleStats,
    FleetReport,
    FleetServer,
    LatencyStats,
    RequestTrace,
    StreamReport,
)

__all__ = [
    "DisaggExecutor",
    "DispatchResult",
    "HomogenizedDispatcher",
    "Replica",
    "RoleStats",
    "TTFTSplit",
    "DecodeEngine",
    "KVHandoff",
    "Request",
    "EngineExecutor",
    "BundleStats",
    "FleetReport",
    "FleetServer",
    "LatencyStats",
    "RequestTrace",
    "StreamReport",
]
