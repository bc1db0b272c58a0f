"""Coordination plane: sharded dispatch authority with gossiped perf views.

  gossip   PerfView / GossipBus — deterministic round-based dissemination of
           per-shard performance tables (staleness-aware merge)
  sharded  CoordSpec / ShardedCoordinator / CoordStats — K coordinator
           replicas over one event loop: consistent worker->shard
           assignment, intra-shard re-homogenization, cross-shard stealing,
           ckill/partition/heal fault semantics
"""

from .gossip import GossipBus, PerfEntry, PerfView
from .sharded import CoordSpec, CoordStats, ShardedCoordinator, rendezvous_shard

__all__ = [
    "GossipBus",
    "PerfEntry",
    "PerfView",
    "CoordSpec",
    "CoordStats",
    "ShardedCoordinator",
    "rendezvous_shard",
]
