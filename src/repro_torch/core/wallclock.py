"""Wall-clock execution backend: grains run as real torch computations.

Port of ``repro/core/wallclock.py``.  Workers sit on the CUDA devices that
``device.resolve_device`` allows, round-robin (one card gives every worker
``cuda:0`` and the label ``wallclock[1d]``); ``devices=[torch.device("cpu")]``
runs on the host, for the tests.  CUDA launches return before the device
finishes, so where the reference calls ``block_until_ready`` this backend
waits for the grain's stream (``overlap=False``) or for an event recorded
after the grain's chain (``overlap=True``, one CUDA stream per worker): a
host clock around a launch alone would measure the launch, not the work.
The reference's description follows.

The runtime's default ``SimBackend`` is a logical clock over modeled costs —
it can *predict* the paper's homogenization speedup but never measure one.
``WallclockBackend`` closes that gap: every grain launches a real chained
matmul workload on a real device (each worker's operand is a tensor on its
device), and the duration that reaches ``GrainRecord``/``worker_busy``/the
``PerformanceTracker`` heartbeat is a *measured* wall time, not
``cost / perf``.

Heterogeneity on homogeneous devices
------------------------------------
Devices are identical, so declared worker speed is emulated by
*work volume*: a grain of cost ``c`` on a worker of declared perf ``p`` runs
``k = round(base_repeats * (c / cost_ref) / p)`` chained unit ops (one
``tanh(h @ x)`` per op — the data dependency keeps the chain a single async
stream; ``tanh`` keeps magnitudes bounded at any depth).  A perf-4 worker
thus really does a quarter of a perf-1 worker's device work per grain, and
homogenized shares ∝ perf really do equalize measured busy time.  A
``perf:`` timeline event changes ``p`` mid-job, so faults slow the *device*
work, not a model.

Overlap
-------
``overlap=False`` (default) blocks on each grain at launch: per-grain
measurements are uncontended device times, so the event-loop combination of
measured durations is the fleet makespan a truly parallel deployment would
see — comparable against the simulator's prediction on any host.
``overlap=True`` dispatches asynchronously on the worker's own stream and
blocks only at the completion event (``settle``), making intra-step overlap
real: while one worker's chain runs, the loop launches other workers'
chains.  Measured durations then include real device contention, which is
the honest number when workers have devices of their own and a pessimistic
one when they share a device.

The unit op is plain torch (``torch.tanh(h @ x)``), as the reference leaves
it to XLA; no kernel of the port is involved.  Where the reference jits it,
the port captures it on CUDA (``compile_op=True``, the default) as CUDA
graphs (``serve/compiled.py``): three a chain, over two buffers, x -> a,
a -> b and b -> a, steps without inputs, so that each unit op of a chain is
one graph launch and no copy.  One chain a device, and in
overlap mode one a worker, on the worker's stream.  ``compile_op=False`` is
the eager route, two launches a unit op; the two give the same bits.  On
the CPU the op runs eagerly either way.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from ..device import resolve_device
from .runtime import ExecutionBackend, GrainExecutor, RuntimeResult

__all__ = ["WallclockBackend", "WallclockStats", "wallclock_devices"]

_EPS = 1e-12
_MIN_DT = 1e-9


def wallclock_devices(device: str | torch.device | None = None,
                      count: int | None = None) -> list[torch.device]:
    """The devices a ``WallclockBackend`` round-robins over.  For CUDA (the
    default ``device``): the first ``count`` visible CUDA devices, all of
    them when ``count`` is None; raises above what is visible.  For another
    device (the CPU, in the tests): that one device."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        if count not in (None, 1):
            raise ValueError(f"{dev.type} is one device; got count={count}")
        return [dev]
    visible = torch.cuda.device_count()
    n = visible if count is None else int(count)
    if not 1 <= n <= visible:
        raise ValueError(
            f"asked for {n} CUDA device(s); {visible} visible — the "
            "wall-clock backend round-robins workers over 1..visible devices"
        )
    return [torch.device("cuda", i) for i in range(n)]


@dataclasses.dataclass
class WallclockStats:
    """Backend provenance attached to ``RuntimeResult.backend`` (and rolled
    into ``RunReport`` metrics by the Cluster facade)."""

    name: str                      # "wallclock"
    platform: str                  # device type ("cuda", "cpu")
    n_devices: int                 # devices the backend round-robins over
    device_of: dict[str, int]      # worker -> device index (sticky)
    unit_s: float                  # calibrated seconds per unit op (EMA)
    wall_s: float                  # real wall span of the job (begin -> end)
    n_launched: int                # grains launched (>= completed under kills)
    overlap: bool

    def summary(self) -> str:
        return (
            f"{self.name}/{self.platform} x{self.n_devices}dev "
            f"unit={self.unit_s * 1e6:.1f}us wall={self.wall_s:.3f}s "
            f"launched={self.n_launched}"
            + (" overlap" if self.overlap else "")
        )


def _op(h: torch.Tensor, x: torch.Tensor, out=None) -> torch.Tensor:
    # Chained unit op: tanh keeps values in (-1, 1) so arbitrary-depth
    # chains neither overflow nor denormalize.
    return torch.tanh(h @ x, out=out)


class _UnitChain:
    """Chains of the unit op over ``x``, as three compiled steps over two
    buffers: x -> a, a -> b and b -> a (``serve/compiled.py``; captured on
    ``stream``, from one pool: a chain's steps follow each other on one
    stream, never at once).  On CUDA each step runs twice here, its warm-up
    and its capture, so that a chain of ``k`` ops is ``k`` replays: the
    first step, then the other two in turn.  It ends in ``a`` (k odd) or
    ``b`` (k even), which the next chain overwrites."""

    def __init__(self, x: torch.Tensor, stream=None, name: str = "unit_op"):
        # Here, not at the top: ``serve`` imports the models, which import
        # ``core``.
        from ..serve.compiled import CompiledStep, new_pool

        a, b = torch.empty_like(x), torch.empty_like(x)
        self.a, self.b = a, b
        pool = new_pool(x.device)
        if stream is None and x.device.type == "cuda":
            stream = torch.cuda.Stream(x.device)

        def step(tag, fn):
            return CompiledStep(f"{name}[{tag}]", fn, x.device, pool=pool,
                                stream=stream)

        self.first = step("x->a", lambda: _op(x, x, out=a))
        self.ab = step("a->b", lambda: _op(a, x, out=b))
        self.ba = step("b->a", lambda: _op(b, x, out=a))
        if x.device.type == "cuda":
            for s in (self.first, self.ab, self.ba) * 2:
                s()

    def run(self, k: int) -> torch.Tensor:
        self.first()
        for i in range(1, k):
            (self.ab if i % 2 else self.ba)()
        return self.a if k % 2 else self.b


@dataclasses.dataclass(slots=True)
class _Handle:
    """One launched grain: the chain's last tensor plus its timing state."""

    value: Any                # tensor at the end of the chain
    k: int                    # unit ops in the chain
    t0: float                 # perf_counter at dispatch
    measured: float | None    # wall seconds (set at launch or at settle)
    done: Any = None          # CUDA event recorded after the chain (overlap)


class WallclockBackend(ExecutionBackend):
    """Measured execution of runtime grains on torch devices.

    Parameters:

      side          unit-op operand is (side, side) float32 — sized so one
                    matmul dominates its dispatch overhead but stays far under
                    a millisecond on CPU (on an H100 a 96 x 96 product is far
                    below one launch: pass a larger side there),
      base_repeats  unit ops for a reference-cost grain on a perf-1.0 worker.
                    12 keeps k integral for the canonical 4:3:2:1 fleets,
      overlap       False: block at launch (uncontended measurements, see
                    module docstring).  True: async dispatch on the worker's
                    own CUDA stream, block at the completion event,
      devices       explicit torch device list (default:
                    ``wallclock_devices()``, every visible CUDA device);
                    workers are assigned round-robin and stick,
      calibration_reps  unit ops timed at startup to seed the unit-time EMA,
      seed          seeds the ``torch.Generator`` that draws the operand,
      compile_op    on CUDA, the unit op as captured graphs, one launch an
                    op (the reference's ``jax.jit``); False: eager, every
                    op dispatched from Python.
    """

    name = "wallclock"

    def __init__(
        self,
        *,
        side: int = 96,
        base_repeats: int = 12,
        overlap: bool = False,
        devices: list | None = None,
        calibration_reps: int = 24,
        seed: int = 0,
        compile_op: bool = True,
    ):
        if side < 2 or base_repeats < 1:
            raise ValueError("need side >= 2 and base_repeats >= 1")
        self.devices = [torch.device(d) for d in (
            devices if devices is not None else wallclock_devices())]
        if not self.devices:
            raise RuntimeError("no devices given to WallclockBackend")
        self.platform = self.devices[0].type
        self.side = int(side)
        self.base_repeats = int(base_repeats)
        self.overlap = bool(overlap)
        gen = torch.Generator().manual_seed(int(seed))
        x0 = torch.randn((self.side, self.side), generator=gen,
                         dtype=torch.float32) / float(self.side) ** 0.5
        self._x = [x0.to(d) for d in self.devices]
        self.compile_op = bool(compile_op)
        # Captured chains: one a device, and one a worker in overlap mode
        # (None where the op runs eagerly).
        self._chains: list[_UnitChain | None] = [None] * len(self._x)
        self._streams: dict[str, Any] = {}    # worker -> (CUDA stream, chain)
        self._dev_of: dict[str, int] = {}     # worker name -> device index
        self._next_dev = 0
        self._cost_ref = 1.0
        self._unit_s = 0.0                    # global EMA, seeded below
        self._unit_alpha = 0.3
        self._tick_ema: dict[str, float] = {}
        self._job_t0: float | None = None
        self._n_launched = 0
        self._last_stats: WallclockStats | None = None
        self._calibrate(max(int(calibration_reps), 4))

    # -- the unit op ---------------------------------------------------------
    def _chain_for(self, x: torch.Tensor, stream=None) -> _UnitChain | None:
        """A captured chain over ``x`` (on ``stream``), or None where the
        op runs eagerly: on the CPU, or with ``compile_op=False``."""
        if not self.compile_op or x.device.type != "cuda":
            return None
        return _UnitChain(x, stream)

    @staticmethod
    def _chain(x: torch.Tensor, k: int, chain: _UnitChain | None):
        """``k`` chained unit ops from ``x``: ``k`` graph launches, or
        ``2k`` eager ones."""
        if chain is not None:
            return chain.run(k)
        h = x
        for _ in range(k):
            h = _op(h, x)
        return h

    @staticmethod
    def _wait(t: torch.Tensor) -> None:
        """Block until the work queued so far on ``t``'s device stream is
        done (CPU work is done when the call returns)."""
        if t.device.type == "cuda":
            torch.cuda.current_stream(t.device).synchronize()

    # -- calibration ---------------------------------------------------------
    def _calibrate(self, reps: int) -> None:
        """Warm the unit op on every device (and capture its chain there),
        then seed the unit-time EMA from a measured chain on device 0."""
        for i, x in enumerate(self._x):
            self._wait(_op(x, x))
            self._chains[i] = self._chain_for(x)
        x = self._x[0]
        t0 = time.perf_counter()
        h = self._chain(x, reps, self._chains[0])
        self._wait(h)
        self._unit_s = max((time.perf_counter() - t0) / reps, _MIN_DT)

    def _learn_unit(self, dt_per_op: float) -> None:
        a = self._unit_alpha
        self._unit_s = (1.0 - a) * self._unit_s + a * max(dt_per_op, _MIN_DT)

    @property
    def unit_s(self) -> float:
        """Calibrated wall seconds per unit op (EMA over measured chains)."""
        return self._unit_s

    # -- facade helpers (known before any job runs) -------------------------
    def repeats(self, cost: float, perf: float,
                cost_ref: float | None = None) -> int:
        ref = self._cost_ref if cost_ref is None else cost_ref
        return max(1, round(
            self.base_repeats * (cost / max(ref, _EPS)) / max(perf, _EPS)
        ))

    def grain_seconds(self, cost: float, perf: float,
                      cost_ref: float | None = None) -> float:
        """Calibrated wall-time estimate for one grain — what a standalone
        run of the same grain on the same device class would measure."""
        return self.repeats(cost, perf, cost_ref) * self._unit_s

    def time_scale(self, cost_ref: float) -> float:
        """Expected wall seconds per modeled second: a grain modeled at
        ``cost / perf`` runs ``base_repeats * cost / (cost_ref * perf)`` unit
        ops, so the ratio is cost- and perf-independent.  The Cluster facade
        multiplies scenario phase estimates (and divides spec perf priors) by
        this so '@k:frac%' anchoring survives the switch to wall time."""
        return self.base_repeats * self._unit_s / max(cost_ref, _EPS)

    def step_clock(self, worker: Any) -> float:
        """Measured wall seconds per engine step for ``worker`` (EMA over
        ``timed_tick``), seeded at the calibrated unit time until the first
        real tick lands — never the modeled ``1/perf`` clock, which is on a
        different (simulated-seconds) scale entirely.  Wired into
        ``EngineExecutor.step_clock`` so serve heartbeats report measured
        tokens/sec."""
        return self._tick_ema.get(getattr(worker, "name", ""), self._unit_s)

    # -- device assignment ---------------------------------------------------
    def device_index(self, name: str) -> int:
        i = self._dev_of.get(name)
        if i is None:
            i = self._next_dev % len(self.devices)
            self._dev_of[name] = i
            self._next_dev += 1
        return i

    def _stream(self, name: str, x: torch.Tensor):
        """The worker's own CUDA stream (overlap mode) and its chain over
        ``x`` captured on that stream, made on first use."""
        got = self._streams.get(name)
        if got is None:
            s = torch.cuda.Stream(device=x.device)
            got = self._streams[name] = (s, self._chain_for(x, s))
        return got

    # -- ExecutionBackend: lifecycle ----------------------------------------
    def begin_job(self, executor: GrainExecutor, n_grains: int,
                  now_s: float) -> None:
        u = executor.uniform_cost
        if u is not None:
            self._cost_ref = max(float(u), _EPS)
        elif n_grains > 0:
            self._cost_ref = max(float(executor.cost(0)), _EPS)
        self._job_t0 = time.perf_counter()
        self._n_launched = 0

    def end_job(self, res: RuntimeResult) -> None:
        wall = (time.perf_counter() - self._job_t0) if self._job_t0 else 0.0
        self._last_stats = WallclockStats(
            name=self.name, platform=self.platform,
            n_devices=len(self.devices), device_of=dict(self._dev_of),
            unit_s=self._unit_s, wall_s=wall, n_launched=self._n_launched,
            overlap=self.overlap,
        )
        self._job_t0 = None

    def stats(self) -> WallclockStats | None:
        return self._last_stats

    # -- ExecutionBackend: modeled-path grains ------------------------------
    def launch(self, executor: GrainExecutor, worker: Any, grain: int,
               cost: float, now_s: float) -> _Handle:
        k = self.repeats(cost, getattr(worker, "perf", 1.0))
        i = self.device_index(worker.name)
        x = self._x[i]
        self._n_launched += 1
        if self.tracer is not None:
            # 'start' marks the *real* device launch (the runtime's
            # 'dispatch' is the scheduling decision at the same logical t).
            self.tracer.emit("start", t_s=now_s, worker=worker.name,
                             grain=grain, repeats=k, device=i)
        if self.overlap and x.device.type == "cuda":
            stream, chain = self._stream(worker.name, x)
            t0 = time.perf_counter()
            with torch.cuda.stream(stream):
                h = self._chain(x, k, chain)
                done = torch.cuda.Event()
                done.record(stream)
            return _Handle(h, k, t0, None, done)
        t0 = time.perf_counter()
        h = self._chain(x, k, self._chains[i])
        if self.overlap:
            return _Handle(h, k, t0, None)
        self._wait(h)
        dt = max(time.perf_counter() - t0, _MIN_DT)
        self._learn_unit(dt / k)
        return _Handle(h, k, t0, dt)

    def duration_s(self, executor: GrainExecutor, worker: Any, grain: int,
                   cost: float, now_s: float, handle: _Handle) -> float:
        if handle.measured is not None:
            return handle.measured
        # Overlap mode: schedule the completion at the calibrated estimate;
        # settle() trues it up against the real wall time.
        return handle.k * self._unit_s

    def settle(self, executor: GrainExecutor, worker: Any, grain: int,
               handle: _Handle, event_dur_s: float) -> float:
        if handle.measured is None:
            if handle.done is not None:
                handle.done.synchronize()
            handle.measured = max(time.perf_counter() - handle.t0, _MIN_DT)
            self._learn_unit(handle.measured / handle.k)
        if self.tracer is not None:
            self.tracer.emit("settle", worker=worker.name, grain=grain,
                             measured_s=handle.measured,
                             modeled_s=event_dur_s)
        return handle.measured

    def observe_execute(self, worker: Any, elapsed_s: float) -> float:
        # Real per-grain compute (grad step, matmul block) is measured work;
        # a grain's execute ends once its device work is done
        # (``ThinClient.matmul_block``).
        return elapsed_s

    # -- ExecutionBackend: incremental (engine) grains ----------------------
    def tick_s(self, executor: GrainExecutor, worker: Any,
               now_s: float) -> float:
        # Seed unmeasured workers at the calibrated unit time: one engine
        # step is one real forward, the same order of work as a unit op.
        # The modeled executor.tick_s is simulated seconds — wrong scale.
        return self._tick_ema.get(worker.name, self._unit_s)

    def timed_tick(self, executor: GrainExecutor, worker: Any,
                   now_s: float) -> list[tuple[int, Any]]:
        # An engine step ends by copying its logits to the host, which waits
        # for the device, so the host clock covers its device work.
        t0 = time.perf_counter()
        finished = executor.tick(worker, now_s)
        dt = max(time.perf_counter() - t0, _MIN_DT)
        prev = self._tick_ema.get(worker.name)
        a = self._unit_alpha
        self._tick_ema[worker.name] = (
            dt if prev is None else (1.0 - a) * prev + a * dt
        )
        return finished
