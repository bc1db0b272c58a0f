"""FleetSpec / WorkerSpec: one declarative description of a heterogeneous fleet.

Every workload in this repo used to build its fleet its own way — ``Machine``
lists for the sim, ``ServiceProvider`` lists for TDA, ``Pod`` lists for HDP
training, ``Replica``+engine dicts for serving.  A ``FleetSpec`` is the single
source all of those are constructed *from*: each ``WorkerSpec`` carries the
worker's perf prior, its concurrency (engine slots for serving), its backend
``profile`` (per-link overhead calibration, see ``profiles.py``) and an
optional free-form ``config`` mapping (engine/model knobs).

The compact string grammar generalizes the old ``--replicas PERFxBATCH``
launcher flag; items are comma- or colon-separated, with an optional
coordination-plane suffix:

    spec    :=  item (","|":") item ... ["/cK"]
    item    :=  [NAME=]PERF[xCONC][@PROFILE][^ROLE][*COUNT]

    "2.0x8,2.0x8,1.0x4"        three workers, slot counts 8/8/4
    "8x4:4x2:2x1"              the old --replicas grammar, unchanged
    "4:3:2:1"                  the old --pods grammar (perf-only), unchanged
    "fast=8x4@dcn,edge=1x2"    named workers, per-backend profiles
    "2.0x4*3"                  three identical 2.0x4 workers
    "1.0*32/c4"                32 workers dispatched by 4 coordinator shards
    "fast=2.0^prefill,1x4^decode"  role-disaggregated serving fleet

Roles (``^prefill`` / ``^decode``; default ``mixed``) split a *serving*
fleet into a prompt-consuming pool and a token-generating pool — see
``repro.serve.disagg``.  A fleet must be all-mixed or fully role-split
(at least one of each); sim/train workloads reject roled fleets.

``str(fleet)`` emits the canonical form, which parses back to an equal spec
(the round-trip the scenario/benchmark traceability relies on) — with one
documented exception: the free-form ``config`` mapping has no string form,
so config-bearing fleets must be rebuilt from dicts/WorkerSpecs.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Mapping, Sequence

from ..core.homogenization import OverheadModel
from .profiles import DEFAULT_PROFILE, get_profile

__all__ = ["WorkerSpec", "FleetSpec", "ROLES"]

_ITEM_RE = re.compile(
    r"^(?:(?P<name>[A-Za-z_][\w.-]*)=)?"      # NAME=
    r"(?P<perf>\d+(?:\.\d+)?(?:e-?\d+)?)"     # PERF
    r"(?:x(?P<conc>\d+))?"                    # xCONC
    r"(?:@(?P<profile>[A-Za-z_][\w.-]*))?"    # @PROFILE
    r"(?:\^(?P<role>[A-Za-z]+))?"             # ^ROLE
    r"(?:\*(?P<count>\d+))?$"                 # *COUNT
)

_GRAMMAR_HINT = (
    "expected [NAME=]PERF[xSLOTS][@PROFILE][^ROLE][*COUNT] "
    "(e.g. '8x4', 'fast=8x4@dcn', '2.0*3', '2.0^prefill'); items separated "
    "by ',' or ':', optional '/cK' suffix for K coordinator shards"
)

ROLES = ("mixed", "prefill", "decode")

_COORD_RE = re.compile(r"^c(\d+)$")


@dataclasses.dataclass(frozen=True)
class WorkerSpec:
    """One worker: perf prior, concurrency (engine slots), backend profile,
    optional engine/model config."""

    name: str
    perf: float
    concurrency: int = 1
    profile: str | None = None
    role: str = "mixed"
    config: Mapping[str, Any] | None = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("worker name must be non-empty")
        if not (self.perf > 0):
            raise ValueError(f"worker {self.name!r}: perf must be > 0, got {self.perf}")
        if self.concurrency < 1:
            raise ValueError(
                f"worker {self.name!r}: concurrency must be >= 1, got {self.concurrency}"
            )
        if self.role not in ROLES:
            raise ValueError(
                f"worker {self.name!r}: unknown role {self.role!r}; "
                f"known roles: {list(ROLES)}"
            )
        if self.profile is not None:
            get_profile(self.profile)  # fail fast on unknown profiles

    @property
    def rate(self) -> float:
        """Effective work rate prior: perf x concurrency (a 4-slot replica on
        a 2 steps/sec clock serves ~8 slot-tokens per second)."""
        return self.perf * self.concurrency

    def compact(self) -> str:
        """Canonical item string.  Parses back to an equal spec *except* for
        ``config``, which the compact grammar cannot express — rebuild
        config-bearing fleets from their dict form, not the string."""
        s = f"{self.name}={self.perf:g}"
        if self.concurrency != 1:
            s += f"x{self.concurrency}"
        if self.profile is not None:
            s += f"@{self.profile}"
        if self.role != "mixed":
            s += f"^{self.role}"
        return s


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """An ordered set of ``WorkerSpec``s — the declarative fleet.

    ``coordinators`` declares the coordination plane: 1 is the paper's single
    TDA; K > 1 shards dispatch across K coordinator replicas (grammar suffix
    ``/cK``, executed by ``repro.coord.ShardedCoordinator``)."""

    workers: tuple[WorkerSpec, ...]
    coordinators: int = 1

    def __post_init__(self):
        if not self.workers:
            raise ValueError("a fleet needs at least one worker")
        if self.coordinators < 1:
            raise ValueError(
                f"coordinators must be >= 1, got {self.coordinators}"
            )
        seen = set()
        for w in self.workers:
            if w.name in seen:
                raise ValueError(f"duplicate worker name {w.name!r} in fleet spec")
            seen.add(w.name)

    # -- construction --------------------------------------------------------
    @classmethod
    def parse(cls, spec: "FleetSpec | str | Sequence", prefix: str = "w") -> "FleetSpec":
        """Build a FleetSpec from a compact string, a dict/WorkerSpec
        sequence, or pass an existing FleetSpec through unchanged.
        Anonymous items are named ``{prefix}0..{prefix}N`` in order."""
        if isinstance(spec, FleetSpec):
            return spec
        if isinstance(spec, str):
            return cls._parse_str(spec, prefix)
        if isinstance(spec, Sequence):
            return cls.from_dicts(spec, prefix=prefix)
        raise TypeError(
            f"cannot build a FleetSpec from {type(spec).__name__}; "
            "pass a spec string, a sequence of dicts/WorkerSpecs, or a FleetSpec"
        )

    @classmethod
    def _parse_str(cls, spec: str, prefix: str) -> "FleetSpec":
        body, sep, suffix = spec.partition("/")
        coordinators = 1
        if sep:
            m = _COORD_RE.match(suffix.strip())
            if m is None:
                raise ValueError(
                    f"bad fleet suffix {'/' + suffix!r}: want '/cK' "
                    f"(K coordinator shards, e.g. '4:3:2:1/c2')"
                )
            coordinators = int(m.group(1))
            if coordinators < 1:
                raise ValueError("fleet suffix '/cK' needs K >= 1")
        items = [s.strip() for s in re.split(r"[,:]", body) if s.strip()]
        if not items:
            raise ValueError(f"empty fleet spec {spec!r}: {_GRAMMAR_HINT}")
        workers: list[WorkerSpec] = []
        for item in items:
            m = _ITEM_RE.match(item)
            if m is None:
                raise ValueError(f"bad worker spec {item!r}: {_GRAMMAR_HINT}")
            count = int(m["count"]) if m["count"] else 1
            if count < 1:
                raise ValueError(f"bad worker spec {item!r}: *COUNT must be >= 1")
            if m["name"] and count > 1:
                raise ValueError(
                    f"bad worker spec {item!r}: *COUNT needs anonymous workers "
                    "(a name can only belong to one)"
                )
            for _ in range(count):
                name = m["name"] or f"{prefix}{len(workers)}"
                workers.append(WorkerSpec(
                    name=name,
                    perf=float(m["perf"]),
                    concurrency=int(m["conc"]) if m["conc"] else 1,
                    profile=m["profile"],
                    role=m["role"] or "mixed",
                ))
        return cls(tuple(workers), coordinators=coordinators)

    @classmethod
    def from_dicts(cls, items: Sequence, prefix: str = "w") -> "FleetSpec":
        """Build from ``[{'perf': 2.0, 'concurrency': 8, ...}, ...]`` (items
        may also be WorkerSpecs, or ``(perf, concurrency)`` tuples)."""
        workers: list[WorkerSpec] = []
        for i, item in enumerate(items):
            if isinstance(item, WorkerSpec):
                workers.append(item)
            elif isinstance(item, Mapping):
                d = dict(item)
                d.setdefault("name", f"{prefix}{i}")
                try:
                    workers.append(WorkerSpec(**d))
                except TypeError as e:
                    raise ValueError(
                        f"bad worker dict at index {i}: {e}; known keys are "
                        "name, perf, concurrency, profile, role, config"
                    ) from None
            elif isinstance(item, tuple) and len(item) == 2:
                workers.append(WorkerSpec(f"{prefix}{i}", float(item[0]), int(item[1])))
            else:
                raise ValueError(
                    f"bad worker item at index {i}: {item!r} (want a dict, a "
                    "WorkerSpec, or a (perf, concurrency) tuple)"
                )
        return cls(tuple(workers))

    @classmethod
    def from_perfs(cls, perfs: Sequence[float], prefix: str = "w",
                   concurrency: int = 1, profile: str | None = None) -> "FleetSpec":
        """Perf-vector shorthand (the ``PAPER_MACHINES`` form)."""
        return cls(tuple(
            WorkerSpec(f"{prefix}{i}", float(p), concurrency, profile)
            for i, p in enumerate(perfs)
        ))

    # -- views ---------------------------------------------------------------
    @property
    def names(self) -> tuple[str, ...]:
        return tuple(w.name for w in self.workers)

    @property
    def perfs(self) -> tuple[float, ...]:
        return tuple(w.perf for w in self.workers)

    @property
    def has_roles(self) -> bool:
        """True when any worker is role-specialized (prefill/decode)."""
        return any(w.role != "mixed" for w in self.workers)

    def role_names(self, role: str) -> tuple[str, ...]:
        return tuple(w.name for w in self.workers if w.role == role)

    def validate_roles(self) -> None:
        """A roled fleet must be *fully* split: at least one prefill and one
        decode replica, and no mixed stragglers (a mixed replica would need
        both grain classes routed to it, defeating the disaggregation)."""
        if not self.has_roles:
            return
        pre, dec = self.role_names("prefill"), self.role_names("decode")
        mixed = self.role_names("mixed")
        if mixed:
            raise ValueError(
                f"role-disaggregated fleet mixes roled and mixed workers "
                f"({list(mixed)} have no role); mark every worker "
                f"'^prefill' or '^decode', or none"
            )
        if not pre or not dec:
            raise ValueError(
                "role-disaggregated fleet needs at least one '^prefill' AND "
                f"one '^decode' worker; got prefill={list(pre)}, "
                f"decode={list(dec)}"
            )

    def worker(self, name: str) -> WorkerSpec:
        for w in self.workers:
            if w.name == name:
                return w
        raise KeyError(
            f"no worker {name!r} in fleet; known workers: {list(self.names)}"
        )

    def __contains__(self, name: str) -> bool:
        return name in self.names

    def __len__(self) -> int:
        return len(self.workers)

    def take(self, k: int) -> "FleetSpec":
        """The first ``k`` workers (worker-count sweeps, Fig 3/6 style)."""
        if not 1 <= k <= len(self.workers):
            raise ValueError(f"take({k}) out of range for a {len(self.workers)}-worker fleet")
        return FleetSpec(self.workers[:k], coordinators=self.coordinators)

    def with_worker(self, spec: WorkerSpec) -> "FleetSpec":
        """A new fleet with ``spec`` appended (or replaced, by name)."""
        kept = tuple(w for w in self.workers if w.name != spec.name)
        return FleetSpec(kept + (spec,), coordinators=self.coordinators)

    def with_coordinators(self, k: int) -> "FleetSpec":
        """The same fleet dispatched by ``k`` coordinator shards."""
        return FleetSpec(self.workers, coordinators=k)

    def total_rate(self) -> float:
        return sum(w.rate for w in self.workers)

    def total_perf(self) -> float:
        return sum(w.perf for w in self.workers)

    # -- backend profiles ----------------------------------------------------
    def overhead_model(self, default_profile: str | None = None) -> OverheadModel:
        """Effective fleet overhead model from the per-worker backend
        profiles.  Each worker's scope crosses its own link, so a load ``L``
        split proportionally to perf costs ``sum_i (share_i / m_i)`` seconds —
        i.e. an effective slope ``M_eff = 1 / sum_i (frac_i / m_i)``.  With a
        single shared profile this is exactly the paper's ``L / M``."""
        default = default_profile or DEFAULT_PROFILE
        total = self.total_perf()
        inv = sum(
            (w.perf / total) / get_profile(w.profile or default).overhead_slope
            for w in self.workers
        )
        return OverheadModel(m=1.0 / max(inv, 1e-12))

    # -- canonical form ------------------------------------------------------
    def __str__(self) -> str:
        s = ",".join(w.compact() for w in self.workers)
        if self.coordinators > 1:
            s += f"/c{self.coordinators}"
        return s
