"""The Cluster facade: one declarative entry point for sim, train and serve.

Port of ``repro/cluster/api.py``: ``simulate`` (``SimJob`` and the
paper's ``MatmulJob`` through the TDA triangle, the matrices on ``device``),
``train`` (runtime-driven HDP, each grain's gradient on the model's device)
and ``serve`` (wave and open-loop/disaggregated paths, driving the port's
``DecodeEngine``s on ``device``), on the sim clock or the measured
wall-clock backend.  ``device`` is CUDA unless the caller asks for another.
The reference's description follows.

The paper's promise is that homogenization is *transparent*: you describe
your fleet once and the TDA machinery does the rest.  PRs 1-3 converged the
execution layer onto one ``AsyncRuntime``/``GrainExecutor`` substrate, but
the entry layer stayed four parallel APIs.  ``Cluster`` closes that gap:

    cluster = Cluster("fast=8x4,mid=4x2,slow=2x1")
    sim   = cluster.simulate(SimJob(size=800, n_jobs=3))
    train = cluster.train(TrainJob(model, steps=50), scenario="halve:mid@3:25%")
    serve = cluster.serve(ServeJob(requests, model=m, params=p),
                          scenario="kill:slow@25%")

Same ``FleetSpec``, same ``Scenario`` DSL, same ``RunReport`` out — the
workloads differ only in what a grain *is* (a matrix row-block, a microbatch
gradient, a decode request), which is exactly the ``GrainExecutor`` seam's
job to hide.

Construction knobs (all fleet-wide):

  ``homogenize``  scope-length allotment vs the paper's equal-split baseline,
  ``adaptive``    mid-run re-homogenization + stealing vs frozen initial plans,
  ``priors``      'neutral' (tracker learns perfs from heartbeats — the
                  closed-loop story) or 'spec' (the declared perfs are oracle
                  priors — isolates mid-run fault response, as benchmarks do),
  ``backend``     where grain durations come from: 'sim' (default — logical
                  clock over modeled costs, bitwise-stable and instant) or
                  'wallclock' (each grain runs as a real async torch
                  computation on a CUDA device, or on ``device`` when that
                  is not CUDA; durations, busy times and heartbeats are
                  *measured* wall seconds — the paper's claim checked on
                  real execution).  An
                  ``ExecutionBackend`` instance plugs in a custom one,
  ``eta_mode``    queue-ETA bookkeeping: 'incremental' (O(1) maintained
                  totals, default) or 'recompute' (re-sum queues per ETA
                  call — the pre-optimization reference path, for bitwise
                  A/B checks).  None defers to ``REPRO_ETA_MODE``/default,
  ``coord``       the coordination plane: a ``coord.CoordSpec`` (or a bare K)
                  shards dispatch across K coordinator replicas with gossiped
                  perf views; defaults to the fleet's ``/cK`` declaration
                  (single coordinator when absent).  Scenario clauses
                  ``ckill``/``partition``/``heal`` script coordinator faults,
                  and ``RunReport.coord`` carries the per-shard event counts,
                  gossip-staleness and dispatch-throughput stats,
  ``trace``       an ``obs.Tracer`` (or ``True`` for a default one) records
                  grain-lifecycle/coordinator/gossip/serve events across
                  every run this Cluster executes; ``tracer.export(path)``
                  writes Perfetto or JSONL, and ``RunReport.telemetry``
                  carries the metrics rollup.  None (default) keeps the
                  untraced path bitwise-identical and overhead-free.

A ``Cluster`` is long-lived: repeated ``.simulate``/``.serve`` calls reuse
the same runtime/fleet-server, so learned perf state persists across calls
(warm-up waves teach the tracker exactly like production traffic would).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from ..coord import CoordSpec, ShardedCoordinator
from ..core.homogenization import OverheadModel, predicted_speedup, scope_lengths
from ..core.performance import PerformanceTracker
from ..core.runtime import AsyncRuntime, ExecutionBackend, SimBackend, SimWorker
from ..core.simulate import ClusterSim
from ..device import resolve_device
from ..obs import Tracer
from .profiles import DEFAULT_PROFILE, select_profile
from .report import PhaseStats, RunReport, merge_worker_timelines
from .scenario import Scenario
from .spec import FleetSpec, WorkerSpec

__all__ = ["SimJob", "MatmulJob", "TrainJob", "ServeJob", "Cluster"]

_EPS = 1e-12



# --------------------------------------------------------------- job specs
@dataclasses.dataclass(frozen=True)
class SimJob:
    """Timing-only granulized job (the paper's §3 testbed): ``size`` rows of
    a size-``size`` matmul per job, ``n_jobs`` jobs back-to-back on the same
    learning tracker."""

    size: int = 800
    n_jobs: int = 1
    jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class MatmulJob:
    """Real distributed matmul through the TDA triangle: values computed for
    real (optionally via the kernel K3: ``matmul_fn=kernels.matmul.ops.
    matmul``), timing from the cost model or measured.  ``a`` and ``b`` are
    numpy arrays or tensors; they move to the Cluster's device once."""

    a: Any
    b: Any
    n_jobs: int = 1
    block_rows: int = 2
    matmul_fn: Callable | None = None
    verify: bool = True


@dataclasses.dataclass(frozen=True)
class TrainJob:
    """Homogenized Data Parallel training of ``model`` for ``steps`` steps;
    each step is one runtime job of ``grains`` microbatch grains.
    ``compile_steps``: the trainer's grain gradient and update run as
    compiled steps (CUDA graphs on the card; ``HDPTrainer``); False is the
    eager route."""

    model: Any
    steps: int
    grains: int = 8
    seq_len: int = 64
    vocab_size: int | None = None
    grain_size: int = 1
    opt: Any = None
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    compress_grads: bool = False
    jitter: float = 0.0
    seed: int = 0
    compile_steps: bool = True


@dataclasses.dataclass(frozen=True)
class ServeJob:
    """A request workload over real (or stub) decode engines.  Engines come
    from ``engine_factory(spec)`` or are built from ``model``/``params`` with
    ``spec.concurrency`` slots each."""

    requests: Sequence
    model: Any = None
    params: Any = None
    engine_factory: Callable[[WorkerSpec], Any] | None = None
    max_seq: int = 64
    max_queue_depth: int = 8
    batched: bool = True
    fresh: bool = False          # force a new fleet server (fresh engines + tracker)
    # Open-loop knobs (used when the scenario has workload clauses —
    # ``arrive:``/``burst:``/``mix:``/``scale:``; ignored in wave mode):
    overflow: str = "queue"      # full queues: 'queue' (backlog) or 'shed'
    deadline_s: float | None = None   # SLO deadline for goodput accounting
    window_s: float | None = None     # SLO-window length (phase anchor);
                                      # default: one admission quota's
                                      # estimated homogenized drain time


# ------------------------------------------------------------------ facade
class Cluster:
    def __init__(
        self,
        fleet: FleetSpec | str | Sequence,
        *,
        homogenize: bool = True,
        adaptive: bool = True,
        priors: str = "neutral",
        default_profile: str | None = None,
        replan_threshold: float = 0.05,
        seed: int = 0,
        name_prefix: str = "w",
        coord: CoordSpec | int | None = None,
        backend: str | ExecutionBackend = "sim",
        eta_mode: str | None = None,
        trace: Tracer | bool | None = None,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.fleet = FleetSpec.parse(fleet, prefix=name_prefix)
        # Reports trace back to the *declared* spec (auto-selected backend
        # profiles refine self.fleet later without rewriting history).
        self._declared_fleet = str(self.fleet)
        if priors not in ("neutral", "spec"):
            raise ValueError(
                f"priors must be 'neutral' or 'spec', got {priors!r}"
            )
        if isinstance(backend, str) and backend not in ("sim", "wallclock"):
            raise ValueError(
                f"backend must be 'sim' (logical clock, modeled durations — "
                f"the default) or 'wallclock' (grains run as real torch "
                f"computations on the CUDA devices, durations are "
                f"measured), or an ExecutionBackend instance; got {backend!r}"
            )
        if not isinstance(backend, (str, ExecutionBackend)):
            raise TypeError(
                f"backend must be 'sim', 'wallclock' or an ExecutionBackend "
                f"instance, got {type(backend).__name__}"
            )
        if eta_mode is not None and eta_mode not in (
            "incremental", "recompute"
        ):
            raise ValueError(
                f"eta_mode must be 'incremental' (O(1) maintained queue "
                f"ETAs, the default) or 'recompute' (re-sum queues on every "
                f"ETA call — the reference path for bitwise A/B checks), "
                f"got {eta_mode!r}; None defers to $REPRO_ETA_MODE"
            )
        self.backend = backend
        self.eta_mode = eta_mode
        # Observability: a shared obs.Tracer threaded into every workload
        # runtime this Cluster builds.  ``trace=True`` constructs a default
        # one; None keeps the zero-overhead untraced path (the runtimes
        # never even branch into emit sites).  Long-lived like the tracker:
        # repeated simulate/train/serve calls append to the same event log.
        if trace is True:
            trace = Tracer()
        elif trace is not None and not isinstance(trace, Tracer):
            raise TypeError(
                f"trace must be an obs.Tracer, True (build a default one) "
                f"or None, got {type(trace).__name__}"
            )
        self.tracer: Tracer | None = trace or None
        self.homogenize = homogenize
        self.adaptive = adaptive
        self.priors = priors
        self.default_profile = default_profile
        self.replan_threshold = replan_threshold
        self.seed = seed
        if isinstance(coord, int):
            coord = CoordSpec(coordinators=coord)
        if coord is None and self.fleet.coordinators > 1:
            coord = CoordSpec(coordinators=self.fleet.coordinators)
        self.coord = coord
        self._auto_profiles: dict[str, str] = {}
        # One measuring backend per Cluster (lazy): its device assignments
        # and unit-time calibration persist across simulate/train/serve
        # calls, like the learned tracker state.
        self._wallclock: ExecutionBackend | None = (
            backend if isinstance(backend, ExecutionBackend) else None
        )
        # Long-lived executors (lazy; learned perf state persists across calls).
        self._sim_rt: AsyncRuntime | None = None
        self._sim_rng: np.random.Generator | None = None
        self._tda_client = None
        self._server = None
        self._serve_signature: tuple | None = None
        self._serve_specs: dict[str, WorkerSpec] = {}
        self._engine_factory: Callable[[WorkerSpec], Any] | None = None

    # -- shared helpers ------------------------------------------------------
    @property
    def _rehomogenize(self) -> bool:
        return self.adaptive and self.homogenize

    def _new_backend(self) -> ExecutionBackend | None:
        """The runtime execution backend: None keeps the sim fast path
        (``backend='sim'``); 'wallclock' lazily builds one shared
        ``WallclockBackend`` on this Cluster's device (every visible CUDA
        device when that is CUDA); an explicit instance is used as-is."""
        if self._wallclock is not None:
            return self._wallclock
        if self.backend == "sim":
            return None
        from ..core.wallclock import WallclockBackend, wallclock_devices

        self._wallclock = WallclockBackend(
            devices=wallclock_devices(self.device))
        return self._wallclock

    def _measured(self) -> bool:
        """True when grain durations are measured (not the sim clock)."""
        b = self._wallclock
        if b is None:
            return not isinstance(self.backend, str) or \
                self.backend == "wallclock"
        return type(b) not in (SimBackend, ExecutionBackend)

    def _backend_label(self) -> str:
        """RunReport provenance: 'sim' or '<name>[<n>d]' for measured
        backends (device count included so two hosts' BENCH entries stay
        distinguishable)."""
        if not self._measured():
            return "sim"
        b = self._new_backend()
        name = getattr(b, "name", type(b).__name__)
        devices = getattr(b, "devices", None)
        return f"{name}[{len(devices)}d]" if devices else name

    def _time_scale(self, cost_ref: float) -> float:
        """Wall seconds per modeled second for a job whose reference grain
        cost is ``cost_ref`` (1.0 on the sim path).  Converts phase
        estimates, spec priors and standalone-time baselines between the two
        clocks."""
        if not self._measured():
            return 1.0
        b = self._new_backend()
        ts = getattr(b, "time_scale", None)
        return ts(cost_ref) if ts is not None else 1.0

    def _overhead_model(self):
        return self.fleet.overhead_model(self.default_profile)

    def _n_coordinators(self) -> int:
        return self.coord.coordinators if self.coord else self.fleet.coordinators

    def _new_authority(self):
        """A fresh dispatch authority for one long-lived workload runtime
        (None = the paper's single coordinator)."""
        return ShardedCoordinator(self.coord) if self.coord else None

    @staticmethod
    def _coord_stats(runtime):
        return runtime.authority.stats()

    def _telemetry(self):
        """RunReport.telemetry payload: the tracer's metrics rollup (None
        when this Cluster is untraced, keeping reports byte-identical)."""
        return self.tracer.telemetry() if self.tracer is not None else None

    def _autoselect_profiles(self, tracker: PerformanceTracker,
                             per_slot: bool = False) -> dict[str, str]:
        """Workers the FleetSpec left unprofiled get a ``BackendProfile``
        selected from their first *measured* heartbeats (>= 1 real report
        beyond the registration prior) instead of silently defaulting.  The
        refined fleet drives later overhead models; the report's ``fleet``
        string stays the declared spec.  ``per_slot`` divides the measured
        throughput by the worker's concurrency first — serving trackers run
        in rate units (perf x slots), and the profile bands are per-worker
        perf, so identical backends must classify alike whatever their slot
        count."""
        if self.default_profile is not None:
            return {}   # an explicit cluster-wide default is not silent
        if self._measured():
            # Measured backends report perfs in wall units; the registry's
            # bands are modeled work-units/sec, so classification would be
            # meaningless.  launch/calibrate.py refits bands in wall units.
            return {}
        updated = list(self.fleet.workers)
        chosen: dict[str, str] = {}
        for i, w in enumerate(updated):
            if w.profile is not None or tracker.n_reports(w.name) < 2:
                continue
            measured = tracker.perf(w.name)
            if per_slot:
                measured /= w.concurrency
            prof = select_profile(max(measured, _EPS))
            updated[i] = dataclasses.replace(w, profile=prof.name)
            chosen[w.name] = prof.name
        if chosen:
            self.fleet = FleetSpec(tuple(updated),
                                   coordinators=self.fleet.coordinators)
            self._auto_profiles.update(chosen)
        return chosen

    def _spec_priors(self, tracker: PerformanceTracker, rate: bool = False,
                     now_s: float = 0.0, scale: float = 1.0) -> None:
        """Seed declared perfs as oracle priors.  ``scale`` converts to the
        tracker's clock: wall-time backends measure work-units per wall
        second, so the modeled prior divides by the backend's time scale."""
        for w in self.fleet.workers:
            p = w.rate if rate else w.perf
            tracker.rejoin(w.name, p if scale == 1.0 else p / scale, now_s)

    def _phase_estimate(self, work: int, unit: float,
                        rates: Sequence[float]) -> float:
        """Estimated duration of one phase: the slowest worker's share under
        the homogenized scope-length plan (tighter than work/sum(rates) under
        integer rounding).  Deliberately independent of the homogenize/
        adaptive flags so adaptive-vs-static comparisons compile a Scenario
        to identical event times."""
        shares = scope_lengths(int(work), list(rates))
        return max(
            (s * unit / r for s, r in zip(shares, rates) if s > 0),
            default=0.0,
        )

    @staticmethod
    def _reject_workload(sc: Scenario, kind: str) -> None:
        if sc.has_workload:
            raise ValueError(
                f"scenario {str(sc)!r} drives a request workload "
                "(arrive:/burst:/mix:/scale: clauses), which only "
                f"Cluster.serve supports — {kind} takes fault clauses only"
            )

    def _reject_roles(self, kind: str) -> None:
        if self.fleet.has_roles:
            raise ValueError(
                f"fleet {self._declared_fleet!r} declares prefill/decode "
                f"roles, which only Cluster.serve understands "
                f"(role-disaggregated serving); {kind} needs an all-mixed "
                "fleet — drop the '^prefill'/'^decode' suffixes"
            )

    def _speedups(self, work: float, rates: Sequence[float], measured_s: float,
                  overhead=None, load: float = 0.0) -> tuple[float, float]:
        """(predicted, measured) speedup vs the best single worker, paper
        Eq. 6 semantics: T_standalone / T_fleet.  ``work`` is in time-scaled
        units (drives T_standalone); ``load`` is the overhead model's input
        (work *units* — rows/grains — matching what the run itself charges)."""
        r_max = max(rates)
        t_alone = work / r_max
        pred = predicted_speedup(t_alone, list(rates), r_max,
                                 load=load if overhead else 0.0,
                                 overhead=overhead)
        return pred, t_alone / max(measured_s, _EPS)

    # =================================================================== sim
    def simulate(self, job: SimJob | MatmulJob | int = SimJob(), *,
                 scenario: Scenario | str | None = None) -> RunReport:
        """Run a granulized job (timing-only ``SimJob`` or real-values
        ``MatmulJob``) under an optional fault ``scenario``."""
        sc = Scenario.parse(scenario)
        self._reject_workload(sc, "simulate")
        self._reject_roles("simulate")
        if isinstance(job, int):
            job = SimJob(size=job)
        if isinstance(job, MatmulJob):
            return self._simulate_matmul(job, sc)
        return self._simulate_timing(job, sc)

    def _simulate_timing(self, job: SimJob, sc: Scenario) -> RunReport:
        if job.size < 1 or job.n_jobs < 1:
            raise ValueError("SimJob needs size >= 1 and n_jobs >= 1")
        unit = ClusterSim.unit_cost(job.size)
        # Wall-time scale of this job (1.0 on the sim path): grains of cost
        # ``unit`` are the backend's reference work item.
        scale = self._time_scale(unit)
        measured = self._measured()
        if self._sim_rt is None:
            tracker = PerformanceTracker(alpha=0.5, dead_after_s=1e18)
            if self.priors == "spec":
                self._spec_priors(tracker, scale=scale)
            self._sim_rt = AsyncRuntime(
                [SimWorker(w.name, w.perf) for w in self.fleet.workers],
                tracker=tracker,
                homogenize=self.homogenize,
                rehomogenize=self._rehomogenize,
                steal=self._rehomogenize,
                replan_threshold=self.replan_threshold,
                authority=self._new_authority(),
                eta_mode=self.eta_mode,
                backend=self._new_backend(),
                tracer=self.tracer,
            )
            self._sim_rng = np.random.default_rng(self.seed)
        rt = self._sim_rt
        ovh_model = self._overhead_model()
        # Measured runs pay no modeled distribution overhead — whatever
        # dispatch really costs is inside the measured durations.
        ovh = 0.0 if measured else ovh_model(job.size)
        est_phase = scale * self._phase_estimate(
            job.size, unit, self.fleet.perfs)
        # Phase-anchored scheduling: each job's events are re-timed against
        # its *true* start (the per-phase run call is the callback), so
        # '@k:frac%' never drifts with accumulated estimate error.
        sched = sc.schedule(self.fleet, phase_s=est_phase,
                            stride_s=est_phase + ovh,
                            coordinators=self._n_coordinators())
        jit = sc.jitter or job.jitter
        rng = self._sim_rng

        def duration(worker, cost, now_s):
            t = cost / max(worker.perf, _EPS)
            if jit:
                t *= 1.0 + jit * float(rng.standard_normal())
            return max(t, 0.0)

        phases, spans = [], []
        elapsed = 0.0
        for k in range(job.n_jobs):
            res = rt.run(job.size, grain_cost=unit, duration_fn=duration,
                         timeline=sched.phase_events(k, 0.0),
                         timeline_relative=True)
            start = res.end_s - res.makespan
            counts = res.shares()
            phases.append(PhaseStats(
                k, "job", float(job.size), res.makespan + ovh,
                res.homogenization_quality(), res.n_migrated, counts,
                metrics={"compute_s": res.makespan, "overhead_s": ovh,
                         "n_steals": res.n_steals},
            ))
            spans.append((res.worker_busy,
                          {w: f - start + elapsed
                           for w, f in res.worker_finish.items()},
                          counts))
            elapsed += res.makespan + ovh
            rt.clock += ovh
            if k == 0 and k < job.n_jobs - 1 and \
                    self._autoselect_profiles(rt.tracker):
                # Later phases pay the *measured* backends' overhead.
                ovh_model = self._overhead_model()
                ovh = ovh_model(job.size)
        work = float(job.size * job.n_jobs)
        total_s = sum(p.sim_time_s for p in phases)
        pred, meas = self._speedups(
            job.size * unit * scale, [p for p in self.fleet.perfs],
            phases[-1].sim_time_s,
            overhead=None if measured else ovh_model, load=float(job.size),
        )
        self._autoselect_profiles(rt.tracker)
        metrics = {"overhead_slope": ovh_model.m, "unit_cost": unit}
        if measured and res.backend is not None:
            metrics["wallclock"] = res.backend.summary()
        if self._auto_profiles:
            metrics["auto_profiles"] = dict(self._auto_profiles)
        return RunReport(
            kind="simulate", fleet=self._declared_fleet, scenario=str(sc),
            phases=tuple(phases), work_done=work, sim_time_s=total_s,
            throughput=work / max(total_s, _EPS),
            predicted_speedup=pred, measured_speedup=meas,
            worker_timelines=merge_worker_timelines(spans),
            metrics=metrics, coord=self._coord_stats(rt),
            backend=self._backend_label(), telemetry=self._telemetry(),
        )

    def _simulate_matmul(self, job: MatmulJob, sc: Scenario) -> RunReport:
        from ..core.tda import ServiceProvider, TDAServer, ThinClient

        # The matrices move to this Cluster's device once; every job and
        # grain below computes there.
        a = torch.as_tensor(job.a, device=self.device)
        b = torch.as_tensor(job.b, device=self.device)
        n = a.shape[0]

        def provider(spec: WorkerSpec) -> ServiceProvider:
            # Always resolve to a concrete profile: an unprofiled provider
            # would otherwise fall back to the sim's *blended* fleet slope,
            # double-counting the mix (see ThinClient._distribution_overhead).
            return ServiceProvider(
                spec.name, spec.perf, matmul_fn=job.matmul_fn,
                profile=spec.profile or self.default_profile or DEFAULT_PROFILE,
            )

        measured = self._measured()
        # Reference grain: the first (full) row-block — what the measuring
        # backend calibrates its per-grain work volume against.
        scale = self._time_scale(
            min(n, job.block_rows) * ClusterSim.unit_cost(n))
        if self._tda_client is None:
            server = TDAServer(
                [provider(w) for w in self.fleet.workers],
                homogenize=self.homogenize,
            )
            if self.priors == "spec":
                self._spec_priors(server.tracker, scale=scale)
            client = ThinClient(server, sim=ClusterSim(
                perfs=list(self.fleet.perfs),
                overhead=self._overhead_model(),
                jitter=sc.jitter, seed=self.seed,
            ), authority=self._new_authority(),
                backend=self._new_backend(), eta_mode=self.eta_mode,
                device=self.device)
            # ThinClient's constructor predates the obs plane; attach the
            # tracer to its runtime directly (same seam, same zero-overhead
            # guard when None).
            client.runtime.tracer = self.tracer
            client.runtime.rehomogenize = self._rehomogenize
            client.runtime.steal = self._rehomogenize
            client.runtime.replan_threshold = self.replan_threshold
            self._tda_client = client
        client = self._tda_client
        unit = client.sim.unit_cost(n)
        est_phase = scale * self._phase_estimate(n, unit, self.fleet.perfs)
        ovh_est = 0.0 if measured else client.sim.overhead(n)
        sched = sc.schedule(self.fleet, phase_s=est_phase,
                            stride_s=est_phase + ovh_est,
                            make_worker=provider,
                            coordinators=self._n_coordinators())

        phases, spans = [], []
        out = None
        elapsed = 0.0
        for k in range(job.n_jobs):
            out, t = client.matmul(a, b, timeline=sched.phase_events(k, 0.0),
                                   block_rows=job.block_rows)
            res = client.last_result
            start = res.end_s - res.makespan
            counts = res.shares()
            phases.append(PhaseStats(
                k, "job", float(n), t,
                res.homogenization_quality(), res.n_migrated, counts,
                metrics={"compute_s": res.makespan,
                         "overhead_s": t - res.makespan},
            ))
            spans.append((res.worker_busy,
                          {w: f - start + elapsed
                           for w, f in res.worker_finish.items()},
                          counts))
            elapsed += t
        metrics: dict[str, Any] = {"n": n, "block_rows": job.block_rows}
        if job.verify:
            # Against the plain product on the same device: 0.0 where the
            # grains take the same path as the full product (the default
            # ``a @ b`` at small shapes on the CPU), a rounding difference
            # where they do not (K3 on the card against ``torch.matmul``).
            metrics["max_abs_err"] = float((out - a @ b).abs().max())
        work = float(n * job.n_jobs)
        total_s = sum(p.sim_time_s for p in phases)
        pred, meas = self._speedups(
            n * unit * scale, list(self.fleet.perfs), phases[-1].sim_time_s,
            overhead=None if measured else self._overhead_model(),
            load=float(n),
        )
        if measured and client.last_result.backend is not None:
            metrics["wallclock"] = client.last_result.backend.summary()
        return RunReport(
            kind="simulate", fleet=self._declared_fleet, scenario=str(sc),
            phases=tuple(phases), work_done=work, sim_time_s=total_s,
            predicted_speedup=pred, measured_speedup=meas,
            throughput=work / max(total_s, _EPS),
            worker_timelines=merge_worker_timelines(spans),
            metrics=metrics, artifact=out, coord=self._coord_stats(client.runtime),
            backend=self._backend_label(), telemetry=self._telemetry(),
        )

    # ================================================================= train
    def train(self, job: TrainJob, *,
              scenario: Scenario | str | None = None) -> RunReport:
        """Train ``job.model`` with runtime-driven HDP across this fleet.
        Returns a RunReport whose phases are training steps; the live
        ``HDPTrainer`` rides along as ``report.artifact`` (checkpoint
        handles, ``plan_preview``, further steps)."""
        from ..data.pipeline import GrainSpec
        from ..train.loop import HDPConfig, HDPTrainer, Pod

        if job.model.device.type != self.device.type:
            raise ValueError(
                f"TrainJob's model is on {job.model.device}, this Cluster "
                f"runs on {self.device}; build both on one device"
            )
        sc = Scenario.parse(scenario)
        self._reject_workload(sc, "train")
        self._reject_roles("train")
        vocab = job.vocab_size or job.model.cfg.vocab_size
        measured = self._measured()
        # Training grains are uniform cost 1.0 — the backend's reference.
        scale = self._time_scale(1.0)
        ovh_model = self._overhead_model()
        if measured:
            # No modeled per-step overhead on measured runs (see simulate);
            # a huge slope makes the trainer's charged overhead negligible.
            ovh_model = OverheadModel(m=1e15)
        cfg = HDPConfig(
            total_grains=job.grains,
            grain_spec=GrainSpec(job.grain_size, job.seq_len, vocab),
            homogenize=self.homogenize,
            adaptive=self.adaptive,
            compress_grads=job.compress_grads,
            overhead=ovh_model,
            ckpt_dir=job.ckpt_dir,
            ckpt_every=job.ckpt_every,
            replan_threshold=self.replan_threshold,
            jitter=sc.jitter or job.jitter,
            seed=job.seed,
        )
        trainer = HDPTrainer(
            job.model, [Pod(w.name, w.perf) for w in self.fleet.workers],
            cfg, opt_cfg=job.opt, authority=self._new_authority(),
            backend=self._new_backend(), eta_mode=self.eta_mode,
            compile_steps=job.compile_steps,
        )
        trainer.runtime.tracer = self.tracer
        if self.priors == "spec":
            self._spec_priors(trainer.tracker, now_s=trainer.clock,
                              scale=scale)
        est_phase = scale * self._phase_estimate(
            job.grains, 1.0, self.fleet.perfs)
        ovh = ovh_model(job.grains)
        # Phase-anchored scheduling: the trainer's step-start hook re-times
        # each '@k:frac%' clause against step k's *true* start clock, so long
        # runs never accumulate plan-estimate drift (phase index = training
        # step; steps skipped by a checkpoint restore fire at the restart).
        sched = sc.schedule(self.fleet, phase_s=est_phase,
                            stride_s=est_phase + ovh,
                            make_worker=lambda s: Pod(s.name, s.perf),
                            coordinators=self._n_coordinators())
        trainer.add_step_hook(
            lambda step, clock: sched.phase_events(step, clock))
        history = trainer.run(job.steps)

        phases, spans = [], []
        elapsed = 0.0
        for rec in history:
            phases.append(PhaseStats(
                rec["step"], "step", float(job.grains), rec["step_time"],
                rec["quality"], rec["n_migrated"], dict(rec["plan"]),
                metrics={"loss": rec["loss"], "grad_norm": rec["grad_norm"],
                         "tokens": rec["tokens"], "n_steals": rec["n_steals"],
                         "overhead_s": ovh},
            ))
            spans.append((rec.get("worker_busy", {}),
                          {w: f + elapsed
                           for w, f in rec.get("worker_finish", {}).items()},
                          dict(rec["plan"])))
            elapsed += rec["step_time"]
        if not phases:
            raise ValueError(
                f"TrainJob ran no steps (steps={job.steps}, trainer resumed at "
                f"step {trainer.start_step}); raise steps past the restore point"
            )
        work = float(job.grains * len(phases))
        total_s = sum(p.sim_time_s for p in phases)
        pred, meas = self._speedups(
            job.grains * scale, list(self.fleet.perfs),
            phases[-1].sim_time_s,
            overhead=None if measured else ovh_model, load=float(job.grains),
        )
        self._autoselect_profiles(trainer.tracker)
        metrics = {"final_loss": history[-1]["loss"],
                   "first_loss": history[0]["loss"],
                   "start_step": trainer.start_step,
                   "overhead_slope": ovh_model.m}
        if self._auto_profiles:
            metrics["auto_profiles"] = dict(self._auto_profiles)
        return RunReport(
            kind="train", fleet=self._declared_fleet, scenario=str(sc),
            phases=tuple(phases), work_done=work, sim_time_s=total_s,
            throughput=work / max(total_s, _EPS),
            predicted_speedup=pred, measured_speedup=meas,
            worker_timelines=merge_worker_timelines(spans),
            metrics=metrics,
            artifact=trainer, coord=self._coord_stats(trainer.runtime),
            backend=self._backend_label(), telemetry=self._telemetry(),
        )

    # ================================================================= serve
    def serve(self, job: ServeJob, *,
              scenario: Scenario | str | None = None) -> RunReport:
        """Serve ``job.requests`` over this fleet's engines in
        admission-controlled waves.  The fleet server (engines + learned
        tracker state) persists across calls — warm-up traffic teaches the
        dispatcher measured rates, exactly like production."""
        from ..serve.dispatch import Replica
        from ..serve.fleet import FleetServer

        sc = Scenario.parse(scenario)
        if sc.jitter:
            raise ValueError(
                "jitter: clauses don't apply to serving — engine timing is "
                "measured (step clocks), not modeled"
            )
        roles: dict[str, str] | None = None
        if self.fleet.has_roles:
            self.fleet.validate_roles()
            self._validate_role_scenario(sc)
            roles = {w.name: w.role for w in self.fleet.workers}
        if self._measured() and str(sc):
            raise ValueError(
                f"scenario {str(sc)!r} is not supported with "
                f"backend='wallclock' serving yet: scenario clauses anchor "
                "to modeled phase estimates, which have no calibrated wall "
                "equivalent for engine step clocks — serve without a "
                "scenario, or use backend='sim' for scenario studies"
            )
        # The fleet server persists across calls; the fields that define its
        # engines must not silently change between jobs (a new model served
        # by old engines would mislabel the results).
        signature = (job.engine_factory, job.model, job.params, job.max_seq)
        if self._server is not None and not job.fresh:
            old_factory, old_model, old_params, old_seq = self._serve_signature
            if (job.engine_factory is not old_factory
                    or job.model is not old_model
                    or job.params is not old_params
                    or job.max_seq != old_seq):
                raise ValueError(
                    "ServeJob's engine-defining fields (engine_factory/model/"
                    "params/max_seq) differ from the ones this Cluster's "
                    "fleet server was built with; pass fresh=True to rebuild "
                    "the fleet (engines + tracker state are discarded)"
                )
        if self._server is None or job.fresh:
            self._serve_signature = signature
            self._serve_specs = {w.name: w for w in self.fleet.workers}
            self._engine_factory = job.engine_factory or self._model_factory(job)
            engines = {
                w.name: self._build_engine(w) for w in self.fleet.workers
            }
            server = FleetServer(
                [Replica(w.name, w.perf) for w in self.fleet.workers],
                engines,
                max_queue_depth=job.max_queue_depth,
                homogenize=self.homogenize,
                engine_factory=self._engine_for_worker,
                authority=self._new_authority(),
                backend=self._new_backend(),
                eta_mode=self.eta_mode,
                tracer=self.tracer,
            )
            server.dispatcher.runtime.rehomogenize = self._rehomogenize
            server.dispatcher.runtime.steal = self._rehomogenize
            server.dispatcher.runtime.replan_threshold = self.replan_threshold
            if self.priors == "spec":
                self._spec_priors(server.tracker, rate=True)
            self._server = server
        server = self._server
        server.max_queue_depth = job.max_queue_depth

        if sc.has_workload or roles:
            # Workload clauses turn the job open-loop: requests *arrive* on
            # the scenario's schedule instead of being planned as waves.
            # Role-disaggregated fleets are open-loop-only — the wave
            # planner has no notion of a two-stage (prefill -> decode)
            # request, so without workload clauses the whole pool arrives
            # at t=0 (an implicit burst).
            return self._serve_stream(job, sc, server, roles=roles)

        requests = list(job.requests)
        cost = sum(len(r.prompt) + r.max_new_tokens for r in requests)
        quota = job.max_queue_depth * max(len(server.live_replicas()), 1)
        wave_cost = sum(
            len(r.prompt) + r.max_new_tokens for r in requests[:quota]
        )
        rates = [w.rate for w in self.fleet.workers]
        est_phase = self._phase_estimate(wave_cost, 1.0, rates)

        def join_replica(spec: WorkerSpec) -> Replica:
            self._serve_specs[spec.name] = spec
            return Replica(spec.name, spec.perf)

        # Phase-anchored scheduling: the server calls back at each *true*
        # wave start, so '@k:frac%' clauses land inside wave k exactly.
        sched = sc.schedule(self.fleet, phase_s=est_phase,
                            make_worker=join_replica,
                            coordinators=self._n_coordinators())

        def wave_events(wave_idx: int):
            # Serving trackers run in rate units (perf x slots — measured
            # tokens/sec); a joiner's prior must match, or identical hardware
            # starts with a ~concurrency-times-too-low allotment.
            return tuple(
                dataclasses.replace(
                    ev, perf=self._serve_specs[ev.worker.name].rate)
                if ev.kind == "join" else ev
                for ev in sched.phase_events(wave_idx, 0.0)
            )

        rep = server.serve(requests, timeline_fn=wave_events,
                           batched=job.batched)

        phases, spans = [], []
        elapsed = 0.0
        for k, bstat in enumerate(rep.bundles):
            phases.append(PhaseStats(
                k, "wave", float(bstat.tokens_out), bstat.sim_time_s,
                bstat.quality, bstat.n_migrated, dict(bstat.shares),
                metrics={"n_requests": bstat.n_requests,
                         "tokens_per_s": bstat.tokens_per_s},
            ))
            counts = {w: n for w, n in bstat.shares.items() if n > 0}
            spans.append((dict(bstat.worker_busy),
                          {w: f + elapsed
                           for w, f in bstat.worker_finish.items()},
                          counts))
            elapsed += bstat.sim_time_s
        pred, meas = self._speedups(float(cost), rates, rep.sim_time_s)
        if self._measured():
            # Wall-clock serving: the tracker's learned rates ARE measured
            # (work-units per wall second), so the standalone baseline uses
            # the best *measured* replica, not the declared spec rate.
            live = server.live_replicas()
            r_meas = max(
                (server.tracker.perf(w) for w in live), default=0.0)
            meas = (cost / max(r_meas, _EPS)) / max(rep.sim_time_s, _EPS)
        self._autoselect_profiles(server.tracker, per_slot=True)
        metrics = {"n_requests": rep.n_requests, "batched": job.batched,
                   "n_waves": len(rep.bundles)}
        if self._auto_profiles:
            metrics["auto_profiles"] = dict(self._auto_profiles)
        return RunReport(
            kind="serve", fleet=self._declared_fleet, scenario=str(sc),
            phases=tuple(phases), work_done=float(rep.tokens_out),
            sim_time_s=rep.sim_time_s, throughput=rep.tokens_per_s,
            predicted_speedup=pred, measured_speedup=meas,
            worker_timelines=merge_worker_timelines(spans),
            metrics=metrics,
            artifact=requests, coord=self._coord_stats(
                server.dispatcher.runtime),
            backend=self._backend_label(), telemetry=self._telemetry(),
        )

    def _validate_role_scenario(self, sc: Scenario) -> None:
        """Fail fast on scenario/role combinations that cannot mean anything
        coherent, instead of mid-stream RuntimeErrors or silent mixed-role
        joins."""
        if self._n_coordinators() > 1:
            raise ValueError(
                "role-disaggregated serving runs on a single coordinator: "
                "sharded dispatch ('/cK', ckill:/partition: clauses) has no "
                "pool-aware gossip plane yet — drop the '/cK' suffix or the "
                "role suffixes"
            )
        joins = [c for c in sc.clauses if c.action == "join"]
        if joins:
            raise ValueError(
                f"join: clauses cannot target a role-disaggregated fleet "
                f"({'; '.join(str(c) for c in joins)}): a joined replica "
                "has no role, and a mixed replica would defeat the "
                "disaggregation — pre-provision the pool in the fleet spec "
                "(e.g. 'fast=2^prefill*2')"
            )
        killed = {c.worker for c in sc.clauses if c.action == "kill"}
        for role in ("prefill", "decode"):
            members = set(self.fleet.role_names(role))
            if members and members <= killed:
                raise ValueError(
                    f"scenario {str(sc)!r} kills every '{role}' replica "
                    f"({sorted(members)}); a role-disaggregated stream "
                    "cannot continue with an empty pool — keep at least one "
                    f"'{role}' replica alive"
                )

    def _serve_stream(self, job: ServeJob, sc: Scenario, server,
                      roles: dict[str, str] | None = None) -> RunReport:
        """Open-loop serving: materialize the scenario's workload clauses
        into concrete arrival times, stream ``job.requests`` through
        ``FleetServer.serve_stream`` (continuous admission, per-request
        latency traces, SLO autoscaling), and wrap the result as a
        single-phase ``RunReport`` carrying ``LatencyStats``.

        ``roles`` (worker -> 'prefill'|'decode', from a roled FleetSpec)
        switches the stream to the disaggregated plane; the report's metrics
        then carry the TTFT split, per-role quality and handoff count."""
        from ..serve.dispatch import Replica
        from .workload import materialize_workload

        requests = list(job.requests)
        rates = [w.rate for w in self.fleet.workers]
        # The SLO window is the open-loop phase: window k starts at exactly
        # k * window_s on the stream clock.  Default to one admission
        # quota's estimated homogenized drain time — the same phase estimate
        # wave mode uses, so '@k:frac%' clauses mean comparable spans in
        # both modes.
        quota = job.max_queue_depth * max(len(server.live_replicas()), 1)
        quota_cost = sum(
            len(r.prompt) + r.max_new_tokens for r in requests[:quota]
        )
        window_s = job.window_s or max(
            self._phase_estimate(quota_cost, 1.0, rates), _EPS
        )

        def join_replica(spec: WorkerSpec) -> Replica:
            self._serve_specs[spec.name] = spec
            return Replica(spec.name, spec.perf)

        sched = sc.schedule(self.fleet, phase_s=window_s, stride_s=window_s,
                            make_worker=join_replica,
                            coordinators=self._n_coordinators(),
                            seed=self.seed)
        plan = materialize_workload(sched, window_s)

        if plan.n_requests == 0:
            # Scale-only scenario: every pooled request arrives at t=0 (an
            # implicit burst), so the SLO rules still have traffic to watch.
            used, arrive = requests, [0.0] * len(requests)
        else:
            if plan.n_requests > len(requests):
                raise ValueError(
                    f"scenario {str(sc)!r} generates {plan.n_requests} "
                    f"arrivals but ServeJob.requests holds only "
                    f"{len(requests)}; provide a request pool at least as "
                    "large as the arrival process (lower the rate / window "
                    "or pass more requests)"
                )
            used, arrive = requests[:plan.n_requests], list(plan.arrive_s)
        # mix:len*F shifts the *composition* of later traffic: requests
        # arriving at/after the shift get their decode budget scaled (in
        # place — the pool objects are the report artifact), clamped to what
        # the engines can hold.
        if plan.mix:
            for g, t in enumerate(arrive):
                f = plan.lengths_factor(t)
                if f != 1.0:
                    r = used[g]
                    r.max_new_tokens = max(1, min(
                        int(round(r.max_new_tokens * f)),
                        job.max_seq - len(r.prompt),
                    ))

        # Fault-clause joiners' priors go in rate units (see wave_events).
        faults = tuple(
            dataclasses.replace(
                ev, perf=self._serve_specs[ev.worker.name].rate)
            if ev.kind == "join" else ev
            for ev in plan.timeline
        )

        def scale_worker(i: int) -> Replica:
            # Autoscaled replicas clone the fastest declared spec so
            # _engine_for_worker can build a real engine for them.
            fastest = max(self._serve_specs.values(), key=lambda s: s.rate)
            spec = dataclasses.replace(fastest, name=f"scale{i}")
            self._serve_specs[spec.name] = spec
            return Replica(spec.name, spec.perf)

        srep = server.serve_stream(
            used, arrive,
            timeline=faults,
            overflow=job.overflow,
            deadline_s=job.deadline_s,
            scale_rules=sc.scale_rules,
            scale_worker=scale_worker,
            roles=roles,
        )

        # Speedup compares *served* work only — shed requests cost the fleet
        # nothing, so counting them would flatter the measured speedup.
        cost = sum(
            len(r.prompt) + r.max_new_tokens
            for r, t in zip(used, srep.traces) if not t.shed
        )
        pred, meas = self._speedups(float(cost), rates, srep.sim_time_s)
        self._autoselect_profiles(server.tracker, per_slot=True)
        lat = srep.latency
        phase = PhaseStats(
            0, "stream", float(srep.tokens_out), srep.sim_time_s,
            srep.quality, srep.n_migrated, dict(srep.shares),
            metrics={"n_requests": srep.n_requests,
                     "n_shed": srep.n_shed,
                     "tokens_per_s": srep.tokens_per_s,
                     "p50_ttft_s": lat.p50_ttft_s,
                     "p99_ttft_s": lat.p99_ttft_s},
        )
        spans = [(dict(srep.worker_busy), dict(srep.worker_finish),
                  {w: n for w, n in srep.shares.items() if n > 0})]
        metrics: dict[str, Any] = {
            "mode": "open-loop",
            "window_s": window_s,
            "n_requests": srep.n_requests,
            "n_served": srep.n_served,
            "n_shed": srep.n_shed,
            "shed_rate": srep.shed_rate,
            "joined": list(srep.joined),
            "p50_ttft_s": lat.p50_ttft_s,
            "p99_ttft_s": lat.p99_ttft_s,
            "goodput_rps": lat.goodput_rps,
        }
        if roles:
            metrics["mode"] = "disaggregated"
            metrics["roles"] = {
                rs.role: list(rs.workers) for rs in srep.role_stats
            }
            metrics["role_quality"] = {
                rs.role: rs.quality for rs in srep.role_stats
            }
            metrics["role_shares"] = {
                rs.role: dict(rs.shares) for rs in srep.role_stats
            }
            metrics["ttft_split"] = (
                srep.ttft_split.as_dict() if srep.ttft_split else None
            )
            metrics["n_handoffs"] = srep.n_handoffs
        if self._auto_profiles:
            metrics["auto_profiles"] = dict(self._auto_profiles)
        return RunReport(
            kind="serve", fleet=self._declared_fleet, scenario=str(sc),
            phases=(phase,), work_done=float(srep.tokens_out),
            sim_time_s=srep.sim_time_s, throughput=srep.tokens_per_s,
            predicted_speedup=pred, measured_speedup=meas,
            worker_timelines=merge_worker_timelines(spans),
            metrics=metrics, artifact=used,
            coord=self._coord_stats(server.dispatcher.runtime),
            latency=lat, backend=self._backend_label(),
            telemetry=self._telemetry(),
        )

    # -- serve internals -----------------------------------------------------
    def _model_factory(self, job: ServeJob) -> Callable[[WorkerSpec], Any]:
        if job.model is None or job.params is None:
            raise ValueError(
                "ServeJob needs either engine_factory= or model= and params= "
                "(the factory builds one DecodeEngine per WorkerSpec)"
            )
        from ..serve.engine import DecodeEngine

        def make(spec: WorkerSpec):
            cfg: Mapping[str, Any] = spec.config or {}
            return DecodeEngine(
                job.model, job.params,
                max_batch=spec.concurrency,
                max_seq=int(cfg.get("max_seq", job.max_seq)),
                name=spec.name, device=self.device,
            )
        return make

    def _build_engine(self, spec: WorkerSpec):
        return self._engine_factory(spec)

    def _engine_for_worker(self, worker):
        """Engine factory handed to the fleet server: a worker joined via a
        Scenario (or rejoined between waves) lazily gets an engine built from
        its recorded WorkerSpec — the ROADMAP join-without-engine fix."""
        spec = self._serve_specs.get(worker.name)
        if spec is None:
            spec = WorkerSpec(worker.name, getattr(worker, "perf", 1.0))
            self._serve_specs[worker.name] = spec
        return self._engine_factory(spec)
