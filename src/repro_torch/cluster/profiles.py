"""Backend provider profiles: per-link overhead models, calibrated not guessed.

The paper measures a single distribution-overhead slope (M=20 for its
100 Mbps Ethernet) and applies it fleet-wide.  A real heterogeneous fleet
talks to its coordinator over *different* links — the CPU interpret backend
of the test harness, a 1 GbE lab LAN, a TPU data-center network — so the
slope is a property of the *worker's backend*, not of the fleet.

A ``BackendProfile`` carries the raw calibration samples (measured
``(load, overhead_seconds)`` pairs, the experiment the paper runs once for
its Ethernet) and derives its slope through
``homogenization.overhead_slope_fit`` — the same least-squares fit the paper
uses — so adding a backend means adding *measurements*, never a magic
constant.  ``WorkerSpec.profile`` names a profile; ``FleetSpec`` combines the
per-worker slopes into an effective fleet ``OverheadModel`` (each worker's
scope crosses that worker's link, so the fleet overhead of load ``L`` is
``sum_i share_i / m_i``, which collapses to the paper's ``L / M`` when every
link is the same).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Sequence

from ..core.homogenization import OverheadModel, overhead_slope_fit

__all__ = [
    "BackendProfile",
    "DEFAULT_PROFILE",
    "PROFILES",
    "get_profile",
    "load_profiles",
    "refit_profile",
    "register_profile",
    "save_profiles",
    "select_profile",
]


@dataclasses.dataclass(frozen=True)
class BackendProfile:
    """One backend's measured link behaviour.

    ``calibration`` is the raw experiment: (load, overhead_seconds) samples.
    ``overhead_slope``/``overhead_model`` are *derived* via the paper's
    least-squares fit — the profile never stores a hand-picked M.

    ``perf_band`` is the measured worker-throughput range (work-units/sec)
    this backend class typically sustains; ``select_profile`` matches a
    worker's first heartbeats against the bands, so a ``FleetSpec`` that
    omits ``@PROFILE`` gets a *measured* selection instead of a silent
    default.  ``None`` opts the profile out of auto-selection.
    """

    name: str
    calibration: tuple[tuple[float, float], ...]
    description: str = ""
    perf_band: tuple[float, float] | None = None

    def __post_init__(self):
        if len(self.calibration) < 2:
            raise ValueError(
                f"profile {self.name!r} needs >= 2 (load, overhead) "
                f"calibration samples, got {len(self.calibration)}"
            )
        if self.perf_band is not None and not (
            0 <= self.perf_band[0] < self.perf_band[1]
        ):
            raise ValueError(
                f"profile {self.name!r}: perf_band must be (lo, hi) with "
                f"0 <= lo < hi, got {self.perf_band}"
            )

    @property
    def overhead_slope(self) -> float:
        loads = [c[0] for c in self.calibration]
        ovh = [c[1] for c in self.calibration]
        return overhead_slope_fit(loads, ovh)

    def overhead_model(self) -> OverheadModel:
        return OverheadModel(m=self.overhead_slope)

    def overhead(self, load: float) -> float:
        return self.overhead_model()(load)


def _samples(m: float, loads: Sequence[float]) -> tuple[tuple[float, float], ...]:
    """Synthesized calibration sweep for a link whose true slope is ``m``,
    with a deterministic +/-2% measurement ripple so the fit is a real
    regression, not a pass-through."""
    out = []
    for i, load in enumerate(loads):
        ripple = 1.0 + (0.02 if i % 2 == 0 else -0.02)
        out.append((float(load), load / m * ripple))
    return tuple(out)


_CAL_LOADS = (200.0, 400.0, 600.0, 800.0, 1000.0)

#: Built-in profiles.  "paper-ethernet" reproduces the paper's measured M=20;
#: the others model the backends this repo actually runs against.  All slopes
#: are *fit* from the calibration sweeps at import time.
PROFILES: dict[str, BackendProfile] = {}


def register_profile(profile: BackendProfile) -> BackendProfile:
    """Add (or replace) a named backend profile.  Returns the profile so
    callers can register-and-use in one line."""
    PROFILES[profile.name] = profile
    return profile


for _name, _m, _desc, _band in (
    ("paper-ethernet", 20.0,
     "the paper's 100 Mbps Ethernet testbed (M=20)", (0.0, 3.0)),
    ("lan-1g", 200.0, "1 GbE lab LAN: ~10x the paper's link", (3.0, 10.0)),
    ("dcn", 2000.0,
     "data-center network between accelerator pods", (10.0, float("inf"))),
    ("local", 2e8,
     "in-process backend (CPU interpret): negligible overhead", None),
):
    register_profile(
        BackendProfile(_name, _samples(_m, _CAL_LOADS), _desc, _band)
    )

DEFAULT_PROFILE = "paper-ethernet"


def select_profile(measured_perf: float) -> BackendProfile:
    """Pick the registered profile whose measured ``perf_band`` covers a
    worker's observed throughput — the first slice of measured backend
    calibration: a worker the FleetSpec left unprofiled is classified from
    its *heartbeats*, never silently defaulted.  Of the covering bands the
    *narrowest* wins (a refit band from a live calibration run is tighter
    than a synthesized class band, so measurements beat defaults); falls
    back to the band with the nearest edge when nothing covers the value.
    Deterministic tie-break by name throughout."""
    if measured_perf <= 0:
        raise ValueError(f"measured_perf must be > 0, got {measured_perf}")
    banded = sorted(
        (p for p in PROFILES.values() if p.perf_band is not None),
        key=lambda p: p.name,
    )
    if not banded:
        return PROFILES[DEFAULT_PROFILE]
    covering = [
        p for p in banded if p.perf_band[0] <= measured_perf < p.perf_band[1]
    ]
    if covering:
        return min(
            covering, key=lambda p: (p.perf_band[1] - p.perf_band[0], p.name)
        )

    def edge_distance(p: BackendProfile) -> float:
        lo, hi = p.perf_band
        return min(abs(measured_perf - lo), abs(measured_perf - hi))

    return min(banded, key=lambda p: (edge_distance(p), p.name))


def refit_profile(
    name: str,
    samples: Sequence[tuple[float, float]],
    *,
    perf_band: tuple[float, float] | None = None,
    description: str = "",
) -> BackendProfile:
    """Register (or replace) ``name`` from freshly *measured* (load,
    overhead_seconds) samples — the ``launch/calibrate.py`` path.  The slope
    is refit by the paper's least-squares regression exactly as for built-in
    profiles; passing a finite ``perf_band`` makes the refit band eligible
    for (and, being measured-narrow, preferred by) ``select_profile``."""
    profile = BackendProfile(
        name,
        tuple((float(l), float(o)) for l, o in samples),
        description or f"refit from {len(samples)} measured samples",
        perf_band,
    )
    return register_profile(profile)


def save_profiles(path, names: Sequence[str] | None = None) -> None:
    """Write registered profiles (raw calibration samples + bands, never
    fitted slopes) to a JSON file ``load_profiles`` can restore."""
    keep = sorted(PROFILES) if names is None else list(names)
    payload = {
        "profiles": [
            {
                "name": p.name,
                "calibration": [list(c) for c in p.calibration],
                "description": p.description,
                "perf_band": list(p.perf_band) if p.perf_band else None,
            }
            for p in (get_profile(n) for n in keep)
        ]
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")


def load_profiles(path) -> list[BackendProfile]:
    """Register every profile stored by ``save_profiles`` (replacing any
    same-named ones) and return them.  Slopes are refit from the stored
    samples on access, so a load round-trips bit-for-bit."""
    with open(path) as f:
        payload = json.load(f)
    out = []
    for rec in payload["profiles"]:
        band = rec.get("perf_band")
        out.append(
            register_profile(
                BackendProfile(
                    rec["name"],
                    tuple((float(l), float(o)) for l, o in rec["calibration"]),
                    rec.get("description", ""),
                    tuple(band) if band else None,
                )
            )
        )
    return out


def get_profile(name_or_profile: str | BackendProfile | None) -> BackendProfile:
    """Resolve a profile reference (``None`` -> the default profile)."""
    if name_or_profile is None:
        return PROFILES[DEFAULT_PROFILE]
    if isinstance(name_or_profile, BackendProfile):
        return name_or_profile
    try:
        return PROFILES[name_or_profile]
    except KeyError:
        raise KeyError(
            f"unknown backend profile {name_or_profile!r}; known: "
            f"{sorted(PROFILES)} (register_profile() adds custom ones)"
        ) from None
