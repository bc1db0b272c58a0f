"""Homogenization: the paper's load-balancing mathematics (Eqs. 1-9).

The paper's contribution is a *proportional allotment* rule plus a
*performance model*:

  - scope length  s_i = L * P_i / sum_j P_j          (largest-remainder rounded)
  - virtual count N_H = sum_i P_i / P_S              (Eq. 4)
  - time          T_NH = T / N_H + O(L)              (Eq. 5)
  - overhead      O(L) = L / M   (linear, M fleet-specific; paper: M=20)
  - speedup       S_NH = T / T_NH -> N_H for compute-dominated loads (Eqs. 6-8)

Everything here is plain Python/numpy on purpose: it is coordinator-side
control-plane logic (the "TDA server"), never traced into XLA programs.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "MAX_OVERHEAD_SLOPE",
    "OverheadModel",
    "scope_lengths",
    "virtual_machine_count",
    "predicted_time",
    "predicted_speedup",
    "equal_split",
    "finish_times",
    "homogenization_quality",
]


@dataclasses.dataclass(frozen=True)
class OverheadModel:
    """Linear distribution-overhead model O(L) = L / M  (paper §2, §3).

    ``m`` is the paper's network-specific slope (paper measures M=20 on
    100 Mbps Ethernet: overhead seconds per unit load).  ``fixed`` adds a
    constant decision-making term (paper: "overhead is an additive function of
    communication time and decision making time of the server"); the paper
    treats it as negligible, so it defaults to 0.
    """

    m: float = 20.0
    fixed: float = 0.0

    def __call__(self, load: float) -> float:
        if load < 0:
            raise ValueError(f"load must be >= 0, got {load}")
        return load / self.m + self.fixed


def _validate_perfs(perfs: Sequence[float]) -> np.ndarray:
    p = np.asarray(perfs, dtype=np.float64)
    if p.ndim != 1 or p.size == 0:
        raise ValueError("perfs must be a non-empty 1-D sequence")
    if not np.all(np.isfinite(p)) or np.any(p <= 0):
        raise ValueError(f"performance factors must be finite and > 0, got {perfs}")
    return p


def scope_lengths(total: int, perfs: Sequence[float]) -> list[int]:
    """Split ``total`` integer work units proportionally to ``perfs``.

    This is the paper's scope-length allotment: worker i receives
    ``total * P_i / sum(P)`` units, rounded by the largest-remainder method so
    that (a) the shares sum exactly to ``total`` and (b) every share is within
    1 unit of the exact proportional value (the fairness bound the
    homogenization line relies on).
    """
    if total < 0:
        raise ValueError(f"total must be >= 0, got {total}")
    p = _validate_perfs(perfs)
    exact = total * p / p.sum()
    base = np.floor(exact).astype(np.int64)
    remainder = int(total - base.sum())
    # Largest remainders get the leftover units; ties broken by perf then index
    # so the plan is deterministic (restarted coordinators recompute identically).
    frac = exact - base
    order = sorted(range(p.size), key=lambda i: (-frac[i], -p[i], i))
    shares = base.copy()
    for i in order[:remainder]:
        shares[i] += 1
    return [int(s) for s in shares]


def equal_split(total: int, n: int) -> list[int]:
    """The paper's *heterogeneous* baseline: equal allotment regardless of P_i."""
    if n <= 0:
        raise ValueError(f"n must be > 0, got {n}")
    return scope_lengths(total, [1.0] * n)


def virtual_machine_count(perfs: Sequence[float], p_standalone: float) -> float:
    """N_H = sum_i P_i / P_S  (Eq. 4)."""
    p = _validate_perfs(perfs)
    if p_standalone <= 0:
        raise ValueError("standalone performance must be > 0")
    return float(p.sum() / p_standalone)


def predicted_time(
    t_standalone: float,
    perfs: Sequence[float],
    p_standalone: float,
    load: float = 0.0,
    overhead: OverheadModel | None = None,
) -> float:
    """T_NH = T / N_H + O(L)  (Eq. 5)."""
    n_h = virtual_machine_count(perfs, p_standalone)
    o = (overhead or OverheadModel())(load) if load else 0.0
    return t_standalone / n_h + o


def predicted_speedup(
    t_standalone: float,
    perfs: Sequence[float],
    p_standalone: float,
    load: float = 0.0,
    overhead: OverheadModel | None = None,
) -> float:
    """S_NH = T / T_NH  (Eq. 6);  -> N_H when overhead is negligible (Eq. 8)."""
    return t_standalone / predicted_time(
        t_standalone, perfs, p_standalone, load, overhead
    )


def finish_times(
    shares: Sequence[int], perfs: Sequence[float], unit_cost: float = 1.0
) -> list[float]:
    """Wall-clock each worker takes for its share: s_i * unit_cost / P_i.

    Under exact proportional allotment all entries are equal — that is the
    homogenization-line invariant the tests assert.
    """
    p = _validate_perfs(perfs)
    s = np.asarray(shares, dtype=np.float64)
    if s.shape != p.shape:
        raise ValueError("shares and perfs must have matching length")
    return [float(x) for x in s * unit_cost / p]


def homogenization_quality(shares: Sequence[int], perfs: Sequence[float]) -> float:
    """Max/min finish-time ratio (1.0 = perfectly homogenized).

    Integer rounding makes tiny deviations unavoidable; the scheduler uses this
    as its replan trigger metric.
    """
    ft = [t for t in finish_times(shares, perfs) if t > 0]
    if not ft:
        return 1.0
    return max(ft) / min(ft)


#: Largest slope ``overhead_slope_fit`` will report.  A calibration run that
#: measures zero (or, through noise, negative) total overhead means M is
#: unidentifiable — "no measurable overhead" — and used to come back as
#: ``math.inf``, silently poisoning any ``OverheadModel(m=inf)`` built from it
#: (non-serializable, breaks slope comparisons).  We clamp instead: at M=1e9
#: the modelled overhead of any realistic load is sub-nanosecond, i.e. zero
#: for scheduling purposes, while staying a well-behaved finite float.
MAX_OVERHEAD_SLOPE = 1e9


def overhead_slope_fit(loads: Sequence[float], overheads: Sequence[float]) -> float:
    """Least-squares fit of M in O(L) = L/M (used to calibrate the fleet model,
    mirroring the paper's measurement of M=20 for its Ethernet).

    Contract: always returns a finite slope in (0, MAX_OVERHEAD_SLOPE].
    Degenerate calibrations (all-zero or net-negative measured overhead)
    return MAX_OVERHEAD_SLOPE rather than ``inf`` — see its docstring.
    """
    l = np.asarray(loads, dtype=np.float64)
    o = np.asarray(overheads, dtype=np.float64)
    if l.shape != o.shape or l.size < 2:
        raise ValueError("need >= 2 (load, overhead) samples")
    denom = float(l @ o)
    if denom <= 0:
        return MAX_OVERHEAD_SLOPE
    return float(min(max(float(l @ l) / denom, 1e-9), MAX_OVERHEAD_SLOPE))
