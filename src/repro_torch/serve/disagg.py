"""Prefill/decode disaggregation: role-specialized replicas + KV handoff.

The homogenizer from the source paper balances one scalar workload class;
real inference fleets carry two coupled classes — compute-bound prefill and
latency-bound decode.  This executor runs both through the async runtime's
*pooled* seam (``core/runtime.py``): request ``i`` is **two grains** —
prefill grain ``i`` (cost = prompt tokens, runs only on the ``prefill``
pool) and decode grain ``n + i`` (cost = max_new tokens, runs only on the
``decode`` pool, *deferred*: it has no scheduled arrival and materializes
via ``followups`` when its prefill completes).  Admission, rebalance,
stealing and kill-heir choice all stay within a pool — per-role homogenized
queues.

Prefill timing is modeled in chunks (``prefill_chunk`` prompt tokens per
engine step) while the *real* bucketed jitted prefill
(``DecodeEngine.prefill``, one compiled shape per power-of-two length
bucket) runs atomically at the completion tick.  That makes exactly-once
trivial under kill: a prefill replica dying mid-prefill loses only a
progress counter — the heir restarts the modeled clock and the single real
``prefill`` call happens once, on the survivor.  On the decode side the
produced ``KVHandoff`` is retained by the executor: a decode replica dying
mid-stream cancels the slot (``DecodeEngine.cancel``) and the heir
``insert``s the *same* handoff — the first token is never recomputed, the
continuation is bitwise-identical, and the request completes exactly once.

Every request carries TTFT-split timestamps: queue (arrival -> prefill
begin), prefill (begin -> handoff ready), handoff (ready -> decode insert,
including the modeled transfer delay), decode (insert -> completion).  The
first output token exists at prefill completion — TTFT = queue + prefill.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

from ..core.performance import PerfReport
from ..core.runtime import GrainExecutor
from .engine import KVHandoff

__all__ = ["DisaggExecutor", "RoleStats", "TTFTSplit"]

_EPS = 1e-12


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    n = len(sorted_vals)
    if n == 0:
        return float("nan")
    return sorted_vals[min(n - 1, max(0, math.ceil(q * n) - 1))]


def _stats(vals: Sequence[float]) -> dict[str, float]:
    s = sorted(vals)
    return {
        "mean": sum(s) / len(s) if s else float("nan"),
        "p50": _percentile(s, 0.50),
        "p99": _percentile(s, 0.99),
    }


@dataclasses.dataclass(frozen=True)
class TTFTSplit:
    """Where time-to-first-token went, across served requests.  Each
    component is a ``{"mean", "p50", "p99"}`` summary in seconds."""

    n: int                      # requests with a complete split
    queue: dict[str, float]     # arrival -> prefill begin
    prefill: dict[str, float]   # prefill begin -> handoff ready
    handoff: dict[str, float]   # handoff ready -> decode insert
    decode: dict[str, float]    # decode insert -> completion

    def as_dict(self) -> dict:
        return {
            "n": self.n,
            "queue_s": dict(self.queue),
            "prefill_s": dict(self.prefill),
            "handoff_s": dict(self.handoff),
            "decode_s": dict(self.decode),
        }


@dataclasses.dataclass(frozen=True)
class RoleStats:
    """One pool's view of the stream: its replicas, their grain shares, and
    the pool-local homogenization quality (survivor drain-time spread)."""

    role: str
    workers: tuple[str, ...]
    quality: float
    shares: dict[str, int]

    def as_dict(self) -> dict:
        return {
            "role": self.role,
            "workers": list(self.workers),
            "quality": self.quality,
            "shares": dict(self.shares),
        }


def build_ttft_split(executor: "DisaggExecutor", arrive_s: Sequence[float],
                     finish_s: Mapping[int, float]) -> TTFTSplit:
    """Roll per-request timestamps into the TTFT-split summary.
    ``finish_s`` maps request index -> completion time (same clock as the
    executor's timestamps); requests missing any timestamp are skipped."""
    qs, ps, hs, ds = [], [], [], []
    for i in executor.ready_s:
        beg = executor.prefill_begin_s.get(i)
        ins = executor.insert_s.get(i)
        fin = finish_s.get(i)
        if beg is None or ins is None or fin is None:
            continue
        qs.append(beg - arrive_s[i])
        ps.append(executor.ready_s[i] - beg)
        hs.append(ins - executor.ready_s[i])
        ds.append(fin - ins)
    return TTFTSplit(
        n=len(qs), queue=_stats(qs), prefill=_stats(ps),
        handoff=_stats(hs), decode=_stats(ds),
    )


class DisaggExecutor(GrainExecutor):
    """Role-disaggregated serving bundle over ``2n`` grains.

    ``roles[name]`` must be ``"prefill"`` or ``"decode"`` for every replica;
    ``engines`` may hold any ``DecodeEngine``-duck-typed object that also
    provides ``prefill``/``insert`` (``tests/stub_engine.py`` mirrors the
    surface at timing scale).  Run it with
    ``AsyncRuntime.run(2n, executor=..., arrivals=<n times>, n_deferred=n)``.
    """

    incremental = True
    pooled = True
    uniform_cost = None
    step_clock = None   # wall-clock backend seam, as on EngineExecutor
    tracer = None       # serve-plane tracing seam, as on EngineExecutor

    def __init__(
        self,
        engines: Mapping[str, object],
        requests: Sequence,
        roles: Mapping[str, str],
        *,
        engine_factory=None,
        on_finish=None,
        prefill_chunk: int = 16,
        handoff_latency_s: float = 0.005,
        handoff_per_token_s: float = 0.0,
    ):
        self.engines = dict(engines)
        self.engine_factory = engine_factory
        self.requests = list(requests)
        self.roles = dict(roles)
        self.n = len(self.requests)
        self.on_finish = on_finish
        if prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.prefill_chunk = int(prefill_chunk)
        self.handoff_latency_s = float(handoff_latency_s)
        self.handoff_per_token_s = float(handoff_per_token_s)
        bad = {n for n, r in self.roles.items()
               if r not in ("prefill", "decode")}
        if bad:
            raise ValueError(
                "disaggregated serving needs every replica role-specialized "
                f"(prefill|decode); got mixed/unknown roles for {sorted(bad)}"
            )
        rids = [r.rid for r in self.requests]
        if len(set(rids)) != len(rids):
            raise ValueError("request rids must be unique within a bundle")
        self._grain_of = {r.rid: g for g, r in enumerate(self.requests)}
        self._max_positions = max(
            (len(r.prompt) + r.max_new_tokens for r in self.requests),
            default=0,
        )
        for name, eng in self.engines.items():
            self._validate_engine(name, eng)
        # KV handoffs, retained past insertion: the exactly-once anchor — a
        # killed decode replica's heir re-inserts the same handoff.
        self.handoffs: dict[int, KVHandoff] = {}
        self.n_handoffs = 0
        # Observability (all keyed by request index, runtime-clock seconds).
        self.first_token_s: dict[int, float] = {}
        self.prefill_begin_s: dict[int, float] = {}
        self.ready_s: dict[int, float] = {}
        self.insert_s: dict[int, float] = {}
        # Modeled prefill progress: request idx -> prompt tokens consumed.
        self._pf: dict[int, int] = {}
        self._pf_lane: dict[str, list[int]] = {}   # worker -> admission order
        # Prefill-pool heartbeat counters (executor-side: the engine's step
        # clock never runs for prefill grains).
        self._pf_steps: dict[str, int] = {}
        self._pf_work: dict[str, int] = {}
        self._pf_hb_steps: dict[str, int] = {}
        self._pf_hb_work: dict[str, int] = {}
        # Decode grains whose request finished *at* insert (max_new == 1 /
        # EOS first token): emitted at the worker's next tick.
        self._instant: dict[str, list[int]] = {}

    def _validate_engine(self, name: str, eng) -> None:
        if eng.active or eng.queue:
            raise ValueError(
                f"engine {name!r} is not idle; one bundle per fleet at a time"
            )
        if eng.name != name:
            raise ValueError(
                f"engine for replica {name!r} reports as {eng.name!r}"
            )
        if self._max_positions > eng.max_seq:
            raise ValueError(
                f"engine {name!r} max_seq {eng.max_seq} cannot hold this "
                f"bundle's largest request ({self._max_positions} positions)"
            )

    def engine_for(self, worker):
        eng = self.engines.get(worker.name)
        if eng is None:
            if self.engine_factory is None:
                raise KeyError(
                    f"replica {worker.name!r} has no engine and the bundle "
                    "has no engine_factory to build one"
                )
            eng = self.engine_factory(worker)
            self._validate_engine(worker.name, eng)
            self.engines[worker.name] = eng
        return eng

    # -- pooled seam ---------------------------------------------------------
    def worker_pool(self, name: str) -> str:
        role = self.roles.get(name)
        if role is None:
            raise KeyError(
                f"worker {name!r} has no role: replicas joining a "
                "role-disaggregated stream must declare '^prefill' or "
                "'^decode'"
            )
        return role

    def grain_pool(self, grain: int) -> str:
        return "prefill" if grain < self.n else "decode"

    def followups(self, grain: int, value, now_s: float):
        if grain >= self.n:
            return []
        delay = self.handoff_latency_s + self.handoff_per_token_s * len(
            self.requests[grain].prompt
        )
        return [(self.n + grain, delay)]

    def shed_with(self, grain: int) -> list[int]:
        return [self.n + grain] if grain < self.n else []

    # -- cost model ----------------------------------------------------------
    def cost(self, grain: int) -> float:
        if grain < self.n:
            return float(len(self.requests[grain].prompt))
        return float(self.requests[grain - self.n].max_new_tokens)

    def remaining_cost(self, worker, grain: int) -> float:
        if grain < self.n:
            return max(1.0, self.cost(grain) - self._pf.get(grain, 0))
        r = self.requests[grain - self.n]
        return max(1.0, float(r.max_new_tokens) - len(r.out_tokens))

    # -- incremental seam ----------------------------------------------------
    def concurrency(self, worker) -> int:
        if self.roles.get(worker.name) == "prefill":
            # Prefill is compute-bound: one prompt at a time per replica;
            # waiting prompts stay runtime-side (hence migratable).
            return 1
        return self.engine_for(worker).max_batch

    def step_seconds(self, worker) -> float:
        if self.step_clock is not None:
            return self.step_clock(worker)
        return 1.0 / max(worker.perf, _EPS)

    def tick_s(self, worker, now_s: float) -> float:
        return self.step_seconds(worker)

    def begin(self, worker, grain: int, now_s: float) -> None:
        if grain < self.n:
            self._pf[grain] = 0
            self._pf_lane.setdefault(worker.name, []).append(grain)
            self.prefill_begin_s[grain] = now_s
            return
        i = grain - self.n
        self.insert_s[i] = now_s
        if self.engine_for(worker).insert(self.handoffs[i]) < 0:
            self._instant.setdefault(worker.name, []).append(grain)

    def tick(self, worker, now_s: float):
        name = worker.name
        if self.roles.get(name) == "prefill":
            self._pf_steps[name] = self._pf_steps.get(name, 0) + 1
            lane = self._pf_lane.get(name, [])
            budget = self.prefill_chunk
            done = []
            while lane and budget > 0:
                g = lane[0]
                r = self.requests[g]
                adv = min(budget, len(r.prompt) - self._pf[g])
                self._pf[g] += adv
                budget -= adv
                self._pf_work[name] = self._pf_work.get(name, 0) + adv
                if self._pf[g] < len(r.prompt):
                    break
                # Completion: the one real bucketed jitted prefill call.
                lane.pop(0)
                self._pf.pop(g)
                h = self.engine_for(worker).prefill(r)
                self.handoffs[g] = h
                self.n_handoffs += 1
                self.ready_s[g] = now_s
                self.first_token_s[g] = now_s
                if self.tracer is not None:
                    self.tracer.emit("first_token", t_s=now_s, worker=name,
                                     grain=g)
                done.append((g, h))
            return done
        finished = self.engine_for(worker).step()
        out = [(self.n + self._grain_of[r.rid], r) for r in finished]
        for g in self._instant.pop(name, []):
            out.append((g, self.requests[g - self.n]))
        if self.on_finish is not None:
            for g, r in out:
                i = g - self.n
                self.on_finish(i, r, name, now_s,
                               self.first_token_s.get(i, now_s))
        if self.tracer is not None:
            for g, r in out:
                self.tracer.emit("request_done", t_s=now_s, worker=name,
                                 grain=g - self.n, rid=r.rid,
                                 tokens=len(r.out_tokens))
        return out

    def abort(self, worker, grain: int) -> None:
        name = worker.name
        if grain < self.n:
            # Mid-prefill kill: the real prefill never ran — drop the modeled
            # progress counter and let the heir restart it (exactly-once
            # trivially: zero real work is discarded).
            self._pf.pop(grain, None)
            lane = self._pf_lane.get(name)
            if lane and grain in lane:
                lane.remove(grain)
            self.prefill_begin_s.pop(grain, None)
            return
        i = grain - self.n
        inst = self._instant.get(name)
        if inst and grain in inst:
            # Finished-at-insert request: nothing to cancel; the heir's
            # re-insert is idempotent.
            inst.remove(grain)
        eng = self.engines.get(name)
        if eng is not None:
            eng.cancel(self.requests[i].rid)
        # The handoff (and its first token) survives in self.handoffs: the
        # heir re-inserts the same prefill output — never recomputed, and
        # the re-decode is bitwise the same continuation.  Hence no
        # 'ttft_drop' here, unlike EngineExecutor.abort: the TTFT sample in
        # first_token_s stays valid.
        self.insert_s.pop(i, None)

    def heartbeat(self, worker, now_s: float) -> PerfReport | None:
        name = worker.name
        if self.roles.get(name) == "prefill":
            steps = self._pf_steps.get(name, 0) - self._pf_hb_steps.get(name, 0)
            work = self._pf_work.get(name, 0) - self._pf_hb_work.get(name, 0)
            if steps <= 0 or work <= 0:
                return None
            self._pf_hb_steps[name] = self._pf_steps.get(name, 0)
            self._pf_hb_work[name] = self._pf_work.get(name, 0)
            return PerfReport(
                worker=name,
                work_done=float(work),
                elapsed_s=steps * self.step_seconds(worker),
                time_s=now_s,
            )
        return self.engines[name].heartbeat(
            now_s, seconds_per_step=self.step_seconds(worker)
        )
