"""Triangular Dynamic Architecture (TDA) roles, with *real* execution.

Port of ``repro/core/tda.py``.  The matrices are torch tensors on one
device (CUDA unless the caller asks for the CPU): ``ThinClient.matmul``
moves ``a`` and ``b`` there once, every grain computes there, and the
client combines the parts into a tensor there.  CUDA runs asynchronously,
so a grain ends by waiting for its stream (``matmul_block``), where the
reference's ``np.asarray`` blocks: the runtime's measured-execution time
then covers the grain's device work, not just its launch.  The reference's
description follows.

The triangle (paper Fig. 2): a thin client sends a request to the TDA server;
the server granulizes it into sub-requests sized by homogenization and sends
them to service-providers; each provider computes its part and returns it
*directly to the client*, which combines the parts.

Execution now rides the async event-loop runtime (``core/runtime.py``): the
runtime plans row-block grains (2 rows each) from the server's homogenized
perf vector and streams them through the providers, feeding every observed
grain latency back to the server's PerformanceTracker and re-homogenizing
mid-job — so a provider that slows down, dies or joins *during* a request
still converges to equal finish times.  ``TDAServer.granulize`` remains the
inspectable one-shot row-level plan (same tracker, same allotment math), but
the executed assignment is the runtime's and shifts as grains migrate.  The
default workload is the paper's
row-granulized matrix multiplication (optionally via the matmul kernel K3),
so tests can assert that the distributed product is exactly the
single-machine product.  *Timing* comes from the ClusterSim cost model
unless a measuring backend (``core.wallclock``) is plugged in, while
*values* are computed for real.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..device import resolve_device
from .performance import PerformanceTracker, PerfReport
from .runtime import (
    AsyncRuntime,
    ExecutionBackend,
    RuntimeResult,
    SimBackend,
    TimelineEvent,
)
from .scheduler import GrainPlan, HomogenizedScheduler
from .simulate import ClusterSim

__all__ = ["SubRequest", "SubResult", "ServiceProvider", "TDAServer", "ThinClient"]


@dataclasses.dataclass(frozen=True)
class SubRequest:
    job_id: int
    worker: str
    row_start: int
    row_stop: int


@dataclasses.dataclass(frozen=True)
class SubResult:
    job_id: int
    worker: str
    row_start: int
    row_stop: int
    value: torch.Tensor
    elapsed_s: float  # simulated


class ServiceProvider:
    """Executes sub-requests; reports heartbeats to the server (background
    process).  ``matmul_fn`` defaults to the plain product ``a @ b``;
    callers swap in the kernel op (``kernels.matmul.ops.matmul``).  ``perf``
    is the *true* instantaneous speed — mutable, so
    mid-job degradation scenarios just assign to it (or script a
    ``TimelineEvent``); the server only learns of the change through observed
    grain latencies.

    ``profile`` names a backend provider profile (``cluster.profiles``):
    the provider's link overhead slope ``OverheadModel.m`` is then the
    profile's *calibrated* fit (via ``overhead_slope_fit``), not the single
    fleet-wide hardcoded slope — heterogeneous backends pay heterogeneous
    distribution costs (see ``ThinClient.matmul``)."""

    def __init__(
        self,
        name: str,
        perf: float,
        matmul_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
        | None = None,
        profile: str | None = None,
    ):
        self.name = name
        self.perf = perf
        self.matmul_fn = matmul_fn or (lambda a, b: a @ b)
        self.profile = profile

    def overhead_slope(self, default: float) -> float:
        """This provider's link slope: the calibrated profile fit when a
        profile is set, else the fleet-wide ``default``."""
        if self.profile is None:
            return default
        from ..cluster.profiles import get_profile  # layered above core

        return get_profile(self.profile).overhead_slope

    def execute(
        self, req: SubRequest, a: torch.Tensor, b: torch.Tensor, sim: ClusterSim
    ) -> SubResult:
        rows = a[req.row_start : req.row_stop]
        value = self.matmul_fn(rows, b)
        elapsed = sim._worker_time(req.row_stop - req.row_start, self.perf, a.shape[0])
        return SubResult(req.job_id, self.name, req.row_start, req.row_stop, value, elapsed)


class TDAServer:
    """Granulizes requests using homogenized performance (paper §2)."""

    def __init__(self, providers: list[ServiceProvider], homogenize: bool = True):
        self.providers = providers
        self.tracker = PerformanceTracker(alpha=0.5)
        self.clock = 0.0
        for p in providers:
            # Neutral prior until heartbeats arrive.
            self.tracker.observe(PerfReport(p.name, 1.0, 1.0, self.clock))
        self.homogenize = homogenize
        self._job_id = 0

    def granulize(self, n_rows: int) -> tuple[int, list[SubRequest], GrainPlan]:
        sched = HomogenizedScheduler(
            self.tracker, total_grains=n_rows, homogenize=self.homogenize
        )
        plan = sched.plan(now_s=self.clock, force=True)
        self._job_id += 1
        reqs, start = [], 0
        by_name = {p.name: p for p in self.providers}
        for w, share in zip(plan.workers, plan.shares, strict=True):
            if share > 0:
                reqs.append(SubRequest(self._job_id, by_name[w].name, start, start + share))
            start += share
        return self._job_id, reqs, plan

    def heartbeat(self, report: PerfReport) -> None:
        self.tracker.observe(report)
        self.clock = max(self.clock, report.time_s)


class ThinClient:
    """Sends the request, receives parts directly from providers, combines.

    A thin client of the async runtime: grains are 2-row result blocks,
    queues are planned by the runtime from the server's tracker, and the
    runtime's completion events are the provider->server heartbeats.
    ``homogenize=False`` on the server degrades to the paper's static
    equal-split baseline (no re-homogenization, no stealing).  ``device``
    is where the matrices live and the grains compute (CUDA unless asked
    for another; see ``device.py``)."""

    def __init__(self, server: TDAServer, sim: ClusterSim | None = None,
                 authority=None, backend=None, eta_mode: str | None = None,
                 device: str | torch.device | None = None):
        self.server = server
        self.device = resolve_device(device)
        self.sim = sim or ClusterSim(
            perfs=[p.perf for p in server.providers]
        )
        # ``authority`` plugs a coordination plane under the triangle: the
        # default is the paper's single TDA; a coord.ShardedCoordinator
        # partitions dispatch across K replicas (``FleetSpec`` '/cK').
        # ``backend`` swaps grain execution: None keeps the logical-clock
        # simulator; a measuring ExecutionBackend (core.wallclock) runs each
        # row-block as real device work and the modeled duration_fn and
        # distribution-overhead terms stop applying (durations and total
        # time are *measured*).
        self.runtime = AsyncRuntime(
            server.providers,
            tracker=server.tracker,
            homogenize=server.homogenize,
            rehomogenize=server.homogenize,
            steal=server.homogenize,
            authority=authority,
            eta_mode=eta_mode,
            backend=backend,
        )
        self._measured = backend is not None and type(backend) not in (
            SimBackend, ExecutionBackend
        )
        self.last_result: RuntimeResult | None = None

    def matmul(
        self,
        a,
        b,
        timeline: tuple[TimelineEvent, ...] = (),
        block_rows: int = 2,
    ) -> tuple[torch.Tensor, float]:
        """Distributed a @ b.  Returns (product, simulated_total_time).

        ``a`` and ``b`` are numpy arrays or tensors; they are moved to this
        client's device (no copy when they are there already) and the
        product is a tensor there.

        Grains are ``block_rows``-row blocks (2 by default: single-row
        products may take a gemv path, whose accumulation order differs from
        the full product — >=2-row blocks are bitwise identical to the
        single-machine result, which the exactness tests rely on).

        ``timeline`` scripts mid-job fleet changes (perf shifts / deaths),
        with times relative to the start of this job."""
        a = torch.as_tensor(a, device=self.device)
        b = torch.as_tensor(b, device=self.device)
        if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
            raise ValueError(f"bad matmul shapes {tuple(a.shape)} x {tuple(b.shape)}")
        n = a.shape[0]
        n_grains = -(-n // block_rows)
        def rows_of(g):
            return g * block_rows, min(n, (g + 1) * block_rows)

        unit = self.sim.unit_cost(n)
        self.runtime.clock = max(self.runtime.clock, self.server.clock)
        res = self.runtime.run(
            n_grains,
            grain_cost=lambda g: (rows_of(g)[1] - rows_of(g)[0]) * unit,
            execute=lambda p, g: self.matmul_block(p, a, b, *rows_of(g)),
            # Route timing through the sim's cost model so its jitter term
            # (runtime performance varying during operation, paper §3) applies.
            duration_fn=lambda p, cost, t: self.sim._worker_time(
                cost / unit, p.perf, n
            ),
            timeline=timeline,
            timeline_relative=True,
        )
        self.last_result = res
        self.server.clock = max(self.server.clock, res.end_s)
        # Client-side combine (triangle edge: provider -> client).
        out = torch.zeros((n, b.shape[1]), device=self.device,
                          dtype=torch.promote_types(a.dtype, b.dtype))
        for g, value in res.values.items():
            lo, hi = rows_of(g)
            out[lo:hi] = value
        if self._measured:
            # Measured backends pay no *modeled* distribution overhead; the
            # wall cost of moving data is already inside the measured grain
            # durations (dispatch + compute + combine happen for real).
            sim_time = res.makespan
        else:
            sim_time = res.makespan + self._distribution_overhead(
                res, rows_of, n)
        return out, sim_time

    def _distribution_overhead(self, res: RuntimeResult, rows_of, n: int) -> float:
        """Distribution overhead O(L) of one job.  Without provider profiles
        this is the paper's fleet-wide ``sim.overhead(n)``.  When any provider
        declares a backend ``profile``, each provider's executed rows cross
        *its own* link: O = sum_i rows_i / m_i (+ the fleet's fixed term),
        with m_i the provider's calibrated slope — so a slow-link backend
        pays its measured cost instead of the fleet average."""
        # Initial providers plus any that joined mid-job (runtime workers
        # *are* the provider objects on this path).
        providers = {p.name: p for p in self.server.providers}
        providers.update(self.runtime.workers)
        if not any(
            getattr(p, "profile", None) is not None for p in providers.values()
        ):
            return self.sim.overhead(n)
        default_m = self.sim.overhead.m
        rows_by_worker: dict[str, int] = {}
        for g, w in res.executed_by.items():
            lo, hi = rows_of(g)
            rows_by_worker[w] = rows_by_worker.get(w, 0) + (hi - lo)
        total = 0.0
        for w, rows in rows_by_worker.items():
            p = providers.get(w)
            m = p.overhead_slope(default_m) if p is not None else default_m
            total += rows / m
        return total + self.sim.overhead.fixed

    @staticmethod
    def matmul_block(
        provider: ServiceProvider, a: torch.Tensor, b: torch.Tensor,
        lo: int, hi: int,
    ) -> torch.Tensor:
        """Compute rows [lo, hi) of a @ b on one provider.  A stray 1-row tail
        block is widened to 2 rows and sliced, keeping every real product on
        the (bitwise-reproducible) multi-row path.  On CUDA it returns once
        the grain's work on the card is done."""
        if hi - lo == 1 and a.shape[0] > 1:
            if lo > 0:
                value = provider.matmul_fn(a[lo - 1 : hi], b)[1:]
            else:
                value = provider.matmul_fn(a[lo : hi + 1], b)[:1]
        else:
            value = provider.matmul_fn(a[lo:hi], b)
        if value.device.type == "cuda":
            torch.cuda.current_stream(value.device).synchronize()
        return value
