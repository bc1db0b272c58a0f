"""Scenario DSL: named fault scripts compiled to ``TimelineEvent`` streams.

Every mid-run fault experiment in this repo used to be a hand-rolled
timeline builder — ``scenario_timeline`` in the serve launcher, the
``fault_step`` arithmetic in ``bench_hdp``, per-test ``TimelineEvent``
tuples.  A ``Scenario`` is the declarative form: a small string of clauses
that compiles against a ``FleetSpec`` (and a phase-duration estimate) into
the exact ``TimelineEvent`` stream the async runtime already consumes.

Grammar — clauses separated by ``;`` (or ``,``):

Fault clauses (the fleet plane: what the *servers* do):

    halve:W@T          worker W's true perf halves at time T
    degrade:W*F@T      perf becomes F x current scripted perf (F > 0)
    perf:W=V@T         perf becomes the absolute value V
    kill:W@T           W dies (in-flight work re-homes to survivors)
    join:W@T           W (re)joins; perf/slots from the fleet spec if known
    join:W=PxC@T       W joins as a new worker with perf P and C slots
    ramp:W*F@T1..T2/K  staged degradation: K perf steps from T1 to T2,
                       geometrically interpolating down to F x current
    jitter:S           execution-time jitter profile sigma=S (no event; the
                       workload applies it to its duration model)

Coordinator-plane clauses (need a multi-coordinator fleet, ``/cK``):

    ckill:S@T          coordinator shard S dies; its queues and in-flight
                       bookkeeping are taken over by its ring successor
    partition:0+1|2@T  gossip/steal connectivity splits into groups
                       (shards joined by '+', groups separated by '|')
    heal@T             the partition heals

Workload clauses (the traffic plane: what the *clients* do — open-loop
serving only; ``simulate``/``train`` reject them):

    arrive:poisson(L)@T1-T2   Poisson request arrivals at rate L per
                              simulated second over [T1, T2); omitting
                              ``-T2`` spans one phase estimate from T1
    burst:N@T                 N requests arrive at once at time T
    mix:len*F@T               request-mix shift: max-new-token lengths of
                              requests arriving at or after T scale by F
    scale:+N@pQQ>X            reactive autoscaling rule (not a timed event):
                              join N replicas when the rolling TTFT pQQ
                              percentile exceeds X seconds; optional ``/W``
                              suffix sets the rolling-window sample count

Arrival randomness is seeded per clause (``seed`` argument to ``compile`` /
``schedule``), so the same Scenario string always materializes the same
arrival timeline — bitwise.

Times ``T``:

    12.5       absolute simulated seconds from the run start
    25%        25% into the first phase (job / training step / serve wave)
    3:25%      25% into phase 3

Two resolution modes: ``compile`` resolves everything up front against
plan-based *estimates* (phase starts at k x stride) — drift accumulates on
long runs.  ``schedule`` returns a ``ScenarioSchedule`` whose events are
anchored to *true* phase boundaries: the workload calls ``phase_events(k,
start_s)`` at each real job/step/wave start (the runtime callback), so a
``@k:frac%`` time is exact to within one phase's duration estimate no matter
how far the run has drifted.  ``str(scenario)`` is canonical and parses back
to an equal scenario.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable

import numpy as np

from ..core.runtime import SimWorker, TimelineEvent
from .spec import FleetSpec, WorkerSpec

__all__ = ["TimeRef", "Clause", "ScaleRule", "Scenario", "ScenarioSchedule"]

_ACTIONS = ("halve", "degrade", "perf", "kill", "join", "ramp",
            "ckill", "partition", "heal", "arrive", "burst", "mix")
_COORD_ACTIONS = ("ckill", "partition", "heal")
_WORKLOAD_ACTIONS = ("arrive", "burst", "mix")

_GRAMMAR_HINT = (
    "clauses are ACTION:WORKER...@TIME separated by ';' (or ',' or "
    "whitespace) — e.g. "
    "'halve:w0@25%', 'degrade:w1*0.2@3:30%', 'kill:w2@9', 'join:w3=1.5x4@12', "
    "'ramp:w0*0.25@2..8/4', 'ckill:1@25%', 'partition:0+1|2@5', 'heal@9', "
    "'jitter:0.1', 'arrive:poisson(8)@0-30', 'burst:64@10', 'mix:len*1.5@12', "
    "'scale:+2@p99>0.5'"
)


@dataclasses.dataclass(frozen=True)
class TimeRef:
    """One scenario time: absolute seconds, or a fraction of a phase."""

    abs_s: float | None = None
    phase: int = 0
    frac: float | None = None

    @classmethod
    def parse(cls, text: str) -> "TimeRef":
        text = text.strip()
        m = re.match(r"^(?:(\d+):)?(\d+(?:\.\d+)?)%$", text)
        if m:
            phase = int(m.group(1)) if m.group(1) else 0
            frac = float(m.group(2)) / 100.0
            if frac > 1.0:
                raise ValueError(
                    f"bad scenario time {text!r}: a phase fraction must be <= 100%"
                )
            return cls(phase=phase, frac=frac)
        try:
            return cls(abs_s=float(text))
        except ValueError:
            raise ValueError(
                f"bad scenario time {text!r}: want seconds ('12.5'), a phase "
                "fraction ('25%'), or a phase-qualified fraction ('3:25%')"
            ) from None

    @property
    def relative(self) -> bool:
        return self.abs_s is None

    def resolve(self, phase_s: float | None, stride_s: float | None) -> float:
        if not self.relative:
            return self.abs_s
        if phase_s is None:
            raise ValueError(
                f"scenario time {self} is phase-relative; compiling it needs "
                "a phase_s estimate (the Cluster facade supplies one)"
            )
        stride = phase_s if stride_s is None else stride_s
        return self.phase * stride + self.frac * phase_s

    def __str__(self) -> str:
        if not self.relative:
            return f"{self.abs_s:g}"
        pct = f"{self.frac * 100:g}%"
        return pct if self.phase == 0 else f"{self.phase}:{pct}"


@dataclasses.dataclass(frozen=True)
class ScaleRule:
    """A reactive autoscaling rule (``scale:+N@pQQ>X[/W]``): join ``add``
    replicas when the rolling-window TTFT percentile breaches ``threshold``
    seconds.  Not a timed event — the serving layer evaluates it on every
    completed decode and fires at most once per rule."""

    add: int
    metric: str                      # "p50" | "p99" | any "pQQ"
    threshold: float                 # seconds
    window: int = 20                 # rolling TTFT sample count

    def __post_init__(self):
        if self.add < 1:
            raise ValueError(f"scale rule must add >= 1 replicas, got {self.add}")
        if not re.match(r"^p\d+(\.\d+)?$", self.metric) or \
                not 0 < float(self.metric[1:]) <= 100:
            raise ValueError(
                f"bad scale metric {self.metric!r}: want a TTFT percentile "
                "like 'p50' or 'p99'"
            )
        if self.threshold <= 0:
            raise ValueError("scale threshold must be > 0 seconds")
        if self.window < 1:
            raise ValueError("scale window must be >= 1 samples")

    def __str__(self) -> str:
        s = f"scale:+{self.add}@{self.metric}>{self.threshold:g}"
        if self.window != 20:
            s += f"/{self.window}"
        return s


@dataclasses.dataclass(frozen=True)
class Clause:
    action: str                      # halve | degrade | perf | kill | join | ramp
    worker: str
    at: TimeRef
    value: float | None = None       # degrade/ramp factor, perf value, join perf
    concurrency: int | None = None   # join slot count
    until: TimeRef | None = None     # ramp / arrive-window end time
    steps: int | None = None         # ramp step count

    def __str__(self) -> str:
        a = self.action
        if a == "heal":
            return f"heal@{self.at}"
        if a == "arrive":
            head = f"arrive:{self.worker}({self.value:g})"
            if self.until is not None:
                return f"{head}@{self.at}-{self.until}"
            return f"{head}@{self.at}"
        if a == "burst":
            return f"burst:{int(self.value)}@{self.at}"
        if a == "mix":
            return f"mix:{self.worker}*{self.value:g}@{self.at}"
        if a == "halve" or a == "kill" or a == "ckill" or a == "partition":
            head = f"{a}:{self.worker}"
        elif a == "degrade":
            head = f"{a}:{self.worker}*{self.value:g}"
        elif a == "perf":
            head = f"{a}:{self.worker}={self.value:g}"
        elif a == "join":
            head = f"{a}:{self.worker}"
            if self.value is not None:
                head += f"={self.value:g}"
                if self.concurrency is not None and self.concurrency != 1:
                    head += f"x{self.concurrency}"
        elif a == "ramp":
            return (f"ramp:{self.worker}*{self.value:g}"
                    f"@{self.at}..{self.until}/{self.steps}")
        else:  # pragma: no cover - parse() rejects unknown actions
            raise ValueError(f"unknown action {a!r}")
        return f"{head}@{self.at}"


def _parse_clause(text: str) -> Clause:
    healm = re.match(r"^heal\s*@(.+)$", text)
    if healm:
        return Clause("heal", "", TimeRef.parse(healm.group(1)))
    action, sep, rest = text.partition(":")
    action = action.strip()
    if not sep or action not in _ACTIONS:
        raise ValueError(f"bad scenario clause {text!r}: {_GRAMMAR_HINT}")
    body, sep, t = rest.rpartition("@")
    if not sep:
        raise ValueError(
            f"bad scenario clause {text!r}: missing '@TIME' ({_GRAMMAR_HINT})"
        )
    body = body.strip()

    if action == "ckill":
        at = TimeRef.parse(t)
        if not re.match(r"^\d+$", body):
            raise ValueError(
                f"bad ckill clause {text!r}: want ckill:SHARD@TIME "
                "(SHARD a coordinator shard id, e.g. 'ckill:1@25%')"
            )
        return Clause("ckill", body, at)
    if action == "partition":
        at = TimeRef.parse(t)
        if not re.match(r"^\d+(\+\d+)*(\|\d+(\+\d+)*)+$", body):
            raise ValueError(
                f"bad partition clause {text!r}: want partition:GROUPS@TIME "
                "with shard ids joined by '+' and groups separated by '|' "
                "(e.g. 'partition:0+1|2+3@5')"
            )
        return Clause("partition", body, at)
    if action == "heal":
        raise ValueError(
            f"bad heal clause {text!r}: want heal@TIME (no target)"
        )

    if action == "arrive":
        m = re.match(r"^poisson\((\d+(?:\.\d+)?(?:e-?\d+)?)\)$", body)
        if m is None:
            raise ValueError(
                f"bad arrive clause {text!r}: want arrive:poisson(RATE)@T1-T2 "
                "(RATE in requests per simulated second; '-T2' optional, "
                "defaulting the window to one phase from T1)"
            )
        rate = float(m.group(1))
        if rate <= 0:
            raise ValueError(f"bad arrive clause {text!r}: rate must be > 0")
        parts = t.split("-")
        if len(parts) == 1:
            at, until = TimeRef.parse(parts[0]), None
        elif len(parts) == 2:
            at, until = TimeRef.parse(parts[0]), TimeRef.parse(parts[1])
        else:
            raise ValueError(
                f"bad arrive clause {text!r}: want a T1-T2 window"
            )
        return Clause("arrive", "poisson", at, value=rate, until=until)
    if action == "burst":
        at = TimeRef.parse(t)
        if not re.match(r"^\d+$", body) or int(body) < 1:
            raise ValueError(
                f"bad burst clause {text!r}: want burst:N@TIME (N >= 1 "
                "requests arriving at once)"
            )
        return Clause("burst", "", at, value=float(int(body)))
    if action == "mix":
        at = TimeRef.parse(t)
        m = re.match(r"^len\*(\d+(?:\.\d+)?(?:e-?\d+)?)$", body)
        if m is None or float(m.group(1)) <= 0:
            raise ValueError(
                f"bad mix clause {text!r}: want mix:len*FACTOR@TIME "
                "(FACTOR > 0 scales max-new-token lengths of later arrivals)"
            )
        return Clause("mix", "len", at, value=float(m.group(1)))

    if action == "ramp":
        m = re.match(r"^(.+?)\.\.(.+?)/(\d+)$", t.strip())
        if m is None:
            raise ValueError(
                f"bad ramp clause {text!r}: want ramp:W*F@T1..T2/K"
            )
        t1, t2, k = TimeRef.parse(m.group(1)), TimeRef.parse(m.group(2)), int(m.group(3))
        if k < 1:
            raise ValueError(f"bad ramp clause {text!r}: K must be >= 1")
        wm = re.match(r"^([\w.-]+)\*(\d+(?:\.\d+)?(?:e-?\d+)?)$", body)
        if wm is None:
            raise ValueError(f"bad ramp clause {text!r}: want ramp:W*F@T1..T2/K")
        factor = float(wm.group(2))
        if not 0 < factor:
            raise ValueError(f"bad ramp clause {text!r}: factor must be > 0")
        return Clause("ramp", wm.group(1), t1, value=factor, until=t2, steps=k)

    at = TimeRef.parse(t)
    if action in ("halve", "kill"):
        if not re.match(r"^[\w.-]+$", body):
            raise ValueError(f"bad {action} clause {text!r}: want {action}:WORKER@TIME")
        return Clause(action, body, at)
    if action == "degrade":
        m = re.match(r"^([\w.-]+)\*(\d+(?:\.\d+)?(?:e-?\d+)?)$", body)
        if m is None:
            raise ValueError(f"bad degrade clause {text!r}: want degrade:W*FACTOR@TIME")
        factor = float(m.group(2))
        if factor <= 0:
            raise ValueError(
                f"bad degrade clause {text!r}: factor must be > 0 (use kill: "
                "to remove a worker)"
            )
        return Clause("degrade", m.group(1), at, value=factor)
    if action == "perf":
        m = re.match(r"^([\w.-]+)=(\d+(?:\.\d+)?(?:e-?\d+)?)$", body)
        if m is None:
            raise ValueError(f"bad perf clause {text!r}: want perf:W=VALUE@TIME")
        value = float(m.group(2))
        if value <= 0:
            raise ValueError(f"bad perf clause {text!r}: perf must be > 0")
        return Clause("perf", m.group(1), at, value=value)
    # join
    m = re.match(
        r"^([\w.-]+)(?:=(\d+(?:\.\d+)?(?:e-?\d+)?)(?:x(\d+))?)?$", body
    )
    if m is None:
        raise ValueError(
            f"bad join clause {text!r}: want join:W@TIME or join:W=PERFxSLOTS@TIME"
        )
    perf = float(m.group(2)) if m.group(2) else None
    conc = int(m.group(3)) if m.group(3) else None
    if perf is not None and perf <= 0:
        raise ValueError(f"bad join clause {text!r}: perf must be > 0")
    return Clause("join", m.group(1), at, value=perf, concurrency=conc)


_SCALE_RE = re.compile(
    r"^scale:\+(\d+)@(p\d+(?:\.\d+)?)>(\d+(?:\.\d+)?(?:e-?\d+)?)(?:/(\d+))?$"
)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A parsed fault + workload script.  Immutable; compile against any
    fleet.  ``scale_rules`` ride alongside the timed clauses: they are
    metric-triggered, so they compile to no ``TimelineEvent`` — the serving
    layer evaluates them against live TTFT measurements."""

    clauses: tuple[Clause, ...] = ()
    jitter: float = 0.0
    scale_rules: tuple[ScaleRule, ...] = ()

    # -- construction --------------------------------------------------------
    @classmethod
    def parse(cls, text: "Scenario | str | None") -> "Scenario":
        if text is None:
            return cls()
        if isinstance(text, Scenario):
            return text
        if not isinstance(text, str):
            raise TypeError(
                f"cannot build a Scenario from {type(text).__name__}; pass a "
                "DSL string or a Scenario"
            )
        clauses: list[Clause] = []
        scale_rules: list[ScaleRule] = []
        jitter = 0.0
        # Clauses never contain whitespace, so spaces separate too — shell
        # one-liners read naturally: --scenario 'arrive:poisson(8)@0-30
        # burst:64@10 scale:+2@p99>0.5'.
        for raw in re.split(r"[;,\n\s]+", text):
            raw = raw.strip()
            if not raw:
                continue
            if raw.startswith("jitter:"):
                try:
                    jitter = float(raw[len("jitter:"):])
                except ValueError:
                    raise ValueError(
                        f"bad jitter clause {raw!r}: want jitter:SIGMA"
                    ) from None
                if jitter < 0:
                    raise ValueError(f"bad jitter clause {raw!r}: sigma must be >= 0")
                continue
            if raw.startswith("scale:"):
                m = _SCALE_RE.match(raw)
                if m is None:
                    raise ValueError(
                        f"bad scale clause {raw!r}: want scale:+N@pQQ>X "
                        "(join N replicas when the rolling TTFT pQQ "
                        "percentile exceeds X seconds; optional /W window)"
                    )
                scale_rules.append(ScaleRule(
                    add=int(m.group(1)),
                    metric=m.group(2),
                    threshold=float(m.group(3)),
                    window=int(m.group(4)) if m.group(4) else 20,
                ))
                continue
            clauses.append(_parse_clause(raw))
        return cls(tuple(clauses), jitter, tuple(scale_rules))

    @classmethod
    def none(cls) -> "Scenario":
        return cls()

    @classmethod
    def from_arg(cls, arg: str | None, default_worker: str) -> "Scenario":
        """CLI-friendly resolution: the legacy named scenarios ('none',
        'halving', 'kill' — fault 25% into the first phase, aimed at the
        first worker) or any raw DSL string."""
        if arg is None or arg == "none":
            return cls()
        if arg == "halving":
            return cls.parse(f"halve:{default_worker}@25%")
        if arg == "kill":
            return cls.parse(f"kill:{default_worker}@25%")
        return cls.parse(arg)

    # -- views ---------------------------------------------------------------
    def __bool__(self) -> bool:
        return bool(self.clauses) or bool(self.scale_rules) or self.jitter > 0

    @property
    def needs_estimates(self) -> bool:
        return any(
            c.at.relative or (c.until is not None and c.until.relative)
            or (c.action == "arrive" and c.until is None)
            for c in self.clauses
        )

    @property
    def has_workload(self) -> bool:
        """True when the script drives traffic (``arrive:``/``burst:``/
        ``mix:`` clauses or ``scale:`` rules) — open-loop serving territory;
        ``simulate``/``train`` reject such scenarios."""
        return bool(self.scale_rules) or any(
            c.action in _WORKLOAD_ACTIONS for c in self.clauses
        )

    def __str__(self) -> str:
        parts = [str(c) for c in self.clauses]
        parts.extend(str(r) for r in self.scale_rules)
        if self.jitter:
            parts.append(f"jitter:{self.jitter:g}")
        return ";".join(parts)

    # -- compilation ---------------------------------------------------------
    def compile(
        self,
        fleet: FleetSpec,
        *,
        phase_s: float | None = None,
        stride_s: float | None = None,
        make_worker: Callable[[WorkerSpec], Any] | None = None,
        coordinators: int | None = None,
        seed: int = 0,
    ) -> tuple[TimelineEvent, ...]:
        """Compile to the runtime's ``TimelineEvent`` stream (times relative
        to the run start — feed with ``timeline_relative=True`` or offset by
        the runtime clock).

        ``phase_s`` is the estimated duration of one phase (job / step /
        wave); ``stride_s`` the estimated start-to-start spacing of phases
        (``phase_s`` + any inter-phase overhead).  ``make_worker`` builds the
        runtime worker object for ``join`` clauses (default: ``SimWorker``).
        ``coordinators`` overrides the fleet's declared shard count for
        coordinator-plane clause validation.  ``seed`` drives per-clause
        arrival randomness (``arrive:poisson``): the same (scenario, seed)
        always materializes the same arrival offsets.

        Every time resolves against the *estimates* here; prefer
        ``schedule`` when the workload can report true phase starts.
        """
        return tuple(
            dataclasses.replace(p.event, time_s=p.est_t)
            for p in self._plan(fleet, phase_s, stride_s, make_worker,
                                coordinators, seed)
        )

    def schedule(
        self,
        fleet: FleetSpec,
        *,
        phase_s: float | None = None,
        stride_s: float | None = None,
        make_worker: Callable[[WorkerSpec], Any] | None = None,
        coordinators: int | None = None,
        seed: int = 0,
    ) -> "ScenarioSchedule":
        """The phase-anchored form of ``compile``: returns a
        ``ScenarioSchedule`` the workload drains via ``phase_events(k,
        start_s)`` at each *true* phase start (job/step/wave callback), so
        ``@k:frac%`` times never accumulate plan-estimate drift."""
        return ScenarioSchedule(
            self._plan(fleet, phase_s, stride_s, make_worker, coordinators,
                       seed)
        )

    def _plan(self, fleet, phase_s, stride_s, make_worker,
              coordinators, seed: int = 0) -> "list[_Planned]":
        make_worker = make_worker or (lambda spec: SimWorker(spec.name, spec.perf))
        n_shards = coordinators if coordinators is not None else fleet.coordinators
        # Scripted perf is cumulative: two halves quarter the worker.  Track
        # it per worker, seeded from the fleet spec, applying clauses in
        # resolved-time order.
        current: dict[str, float] = {w.name: w.perf for w in fleet.workers}
        known: dict[str, WorkerSpec] = {w.name: w for w in fleet.workers}

        resolved: list[tuple[float, int, Clause]] = []
        for i, c in enumerate(self.clauses):
            resolved.append((c.at.resolve(phase_s, stride_s), i, c))
        resolved.sort(key=lambda x: (x[0], x[1]))

        planned: list[_Planned] = []

        def emit(t: float, c: Clause, event: TimelineEvent) -> None:
            if c.at.relative:
                planned.append(_Planned(
                    t, c.at.phase, c.at.frac * phase_s, event))
            else:
                planned.append(_Planned(t, None, c.at.abs_s, event))

        for t, idx, c in resolved:
            if c.action in _COORD_ACTIONS:
                emit(t, c, self._coord_event(c, t, n_shards))
                continue
            if c.action == "arrive":
                # Per-clause seeded stream: the same (scenario, seed) pair
                # materializes bitwise-identical arrival offsets no matter
                # what other clauses say.
                if c.until is not None:
                    window = c.until.resolve(phase_s, stride_s) - t
                    if window <= 0:
                        raise ValueError(
                            f"arrive clause {c}: window end precedes start"
                        )
                elif phase_s is not None:
                    window = phase_s
                else:
                    raise ValueError(
                        f"arrive clause {c} has no -T2 window end; resolving "
                        "the default one-phase window needs a phase_s "
                        "estimate (the Cluster facade supplies one)"
                    )
                rng = np.random.default_rng([seed, idx])
                offsets, cum = [], 0.0
                while True:
                    cum += float(rng.exponential(1.0 / c.value))
                    if cum >= window:
                        break
                    offsets.append(cum)
                emit(t, c, TimelineEvent(t, "arrive", tuple(offsets)))
                continue
            if c.action == "burst":
                emit(t, c, TimelineEvent(
                    t, "arrive", tuple(0.0 for _ in range(int(c.value)))))
                continue
            if c.action == "mix":
                emit(t, c, TimelineEvent(t, "mix", c.worker, perf=c.value))
                continue
            if c.action == "join":
                spec = known.get(c.worker)
                if spec is None and c.value is None:
                    raise ValueError(
                        f"join clause for unknown worker {c.worker!r} needs an "
                        f"explicit spec (join:{c.worker}=PERFxSLOTS@...); fleet "
                        f"workers: {list(fleet.names)}"
                    )
                spec = WorkerSpec(
                    name=c.worker,
                    perf=c.value if c.value is not None else spec.perf,
                    concurrency=(
                        c.concurrency if c.concurrency is not None
                        else (spec.concurrency if spec else 1)
                    ),
                    profile=spec.profile if spec else None,
                )
                known[c.worker] = spec
                current[c.worker] = spec.perf
                emit(t, c, TimelineEvent(t, "join", make_worker(spec),
                                         perf=spec.perf))
                continue
            if c.worker not in known:
                raise ValueError(
                    f"scenario clause {c} names unknown worker {c.worker!r}; "
                    f"fleet workers: {list(fleet.names)} (a join: clause can "
                    "introduce new ones)"
                )
            if c.action == "kill":
                emit(t, c, TimelineEvent(t, "kill", c.worker))
            elif c.action == "halve":
                current[c.worker] *= 0.5
                emit(t, c, TimelineEvent(t, "perf", c.worker,
                                         perf=current[c.worker]))
            elif c.action == "degrade":
                current[c.worker] *= c.value
                emit(t, c, TimelineEvent(t, "perf", c.worker,
                                         perf=current[c.worker]))
            elif c.action == "perf":
                current[c.worker] = c.value
                emit(t, c, TimelineEvent(t, "perf", c.worker,
                                         perf=current[c.worker]))
            elif c.action == "ramp":
                t2 = c.until.resolve(phase_s, stride_s)
                if t2 < t:
                    raise ValueError(f"ramp clause {c}: end time precedes start")
                k = c.steps
                base = current[c.worker]
                # Fully phase-relative ramps anchor *each stage* to its own
                # phase by interpolating in phase-fraction space (phase +
                # frac), so no stage drifts when real phases run longer than
                # estimated.  Mixed or absolute ramps keep absolute times.
                per_phase = c.at.relative and c.until.relative
                if per_phase:
                    pos1 = c.at.phase + c.at.frac
                    pos2 = c.until.phase + c.until.frac
                for i in range(1, k + 1):
                    ti = t if k == 1 else t + (t2 - t) * (i - 1) / (k - 1)
                    pi = base * (c.value ** (i / k))
                    if per_phase:
                        pos = pos1 if k == 1 else (
                            pos1 + (pos2 - pos1) * (i - 1) / (k - 1)
                        )
                        phase_i = min(int(pos), c.until.phase)
                        planned.append(_Planned(
                            ti, phase_i, (pos - phase_i) * phase_s,
                            TimelineEvent(ti, "perf", c.worker, perf=pi),
                        ))
                    else:
                        planned.append(_Planned(
                            ti, None, ti,
                            TimelineEvent(ti, "perf", c.worker, perf=pi),
                        ))
                current[c.worker] = base * c.value
        return planned

    @staticmethod
    def _coord_event(c: Clause, t: float, n_shards: int) -> TimelineEvent:
        if n_shards < 2:
            raise ValueError(
                f"scenario clause {c} targets the coordination plane, but the "
                f"fleet declares {n_shards} coordinator(s); add the '/cK' "
                "fleet suffix (e.g. '4:3:2:1/c2')"
            )
        if c.action == "heal":
            return TimelineEvent(t, "heal", None)
        if c.action == "ckill":
            shard = int(c.worker)
            if shard >= n_shards:
                raise ValueError(
                    f"ckill clause {c} names shard {shard}, but the fleet has "
                    f"coordinator shards 0..{n_shards - 1}"
                )
            return TimelineEvent(t, "ckill", shard)
        groups = tuple(
            tuple(int(x) for x in g.split("+")) for g in c.worker.split("|")
        )
        seen: set[int] = set()
        for g in groups:
            for s in g:
                if s >= n_shards:
                    raise ValueError(
                        f"partition clause {c} names shard {s}, but the fleet "
                        f"has coordinator shards 0..{n_shards - 1}"
                    )
                if s in seen:
                    raise ValueError(
                        f"partition clause {c} lists shard {s} twice"
                    )
                seen.add(s)
        return TimelineEvent(t, "partition", groups)


@dataclasses.dataclass
class _Planned:
    """One compiled event with both resolutions: the up-front estimate
    (``est_t``) and the phase anchor (``phase``/``offset``) the schedule
    re-times against true phase starts."""

    est_t: float
    phase: int | None          # None = absolute from run start
    offset: float              # seconds into the phase (or from run start)
    event: TimelineEvent
    emitted: bool = False


class ScenarioSchedule:
    """Phase-anchored event delivery.  The workload calls ``phase_events(k,
    start_s)`` when phase ``k`` *actually* starts (``start_s`` in the same
    clock the returned event times should use — 0.0 for phase-relative
    feeding, the runtime clock for absolute feeding); events anchored to
    phase ``k`` fire at ``start_s + frac * phase_s_estimate``.  Absolute-time
    clauses are all delivered with the first phase (late ones ride the
    runtime's pending-event carryover).  Events for phases the run never
    reaches are never delivered."""

    def __init__(self, planned: list[_Planned]):
        self._planned = planned
        self._started = False
        self._last_k = -1

    def phase_events(self, k: int, start_s: float) -> tuple[TimelineEvent, ...]:
        if k <= self._last_k:
            raise ValueError(
                f"phase_events({k}) after phase {self._last_k}: phases must "
                "be visited in increasing order"
            )
        out: list[TimelineEvent] = []
        for p in self._planned:
            if p.emitted:
                continue
            if p.phase is None:
                if not self._started:
                    out.append(dataclasses.replace(
                        p.event, time_s=start_s + p.offset))
                    p.emitted = True
            elif p.phase <= k:
                # A clause for a phase this run skipped (checkpoint restore)
                # fires at the current phase start instead of vanishing.
                off = p.offset if p.phase == k else 0.0
                out.append(dataclasses.replace(
                    p.event, time_s=start_s + off))
                p.emitted = True
        self._started = True
        self._last_k = k
        return tuple(sorted(out, key=lambda ev: ev.time_s))

    @property
    def exhausted(self) -> bool:
        return all(p.emitted for p in self._planned)
