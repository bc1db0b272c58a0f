"""One step compiled once per shape: the port's counterpart of the
reference's ``jax.jit`` on ``DecodeEngine``'s decode step and on each
length bucket's prefill (``repro/serve/engine.py``), and on the training
steps: the grain gradient, ``HDPTrainer``'s AdamW update and
``train_single``'s step (``repro/train/{step,loop}.py``), and on the
wall-clock backend's unit op (``repro/core/wallclock.py``).

On CUDA the step is captured as a CUDA graph, which the card replays with
no Python dispatch; the hand-written kernels it launches (K1, K2; K4's and
K5's forwards and, from autograd's device thread, their backwards) are
captured with it.  ``CompiledStep`` owns:

  - the step function, which reads its inputs from static buffers and may
    read (and write in place) tensors it closes over: the engine's
    parameters and caches, a trainer's parameters, optimizer state and
    gradient buffers, whose addresses the graph keeps;
  - the static input buffers, filled by each call;
  - the static outputs, which each replay overwrites;
  - a graph memory pool, which an engine (or a trainer) shares among its
    steps.

A step's calls go through three stages on CUDA.  The first call for its
shape runs eagerly on a side stream (the warm-up: lazy initialisation,
cuBLAS workspaces, ``cudaFuncSetAttribute``) and returns its own result,
so a prefill bucket used once is never captured.  The second call captures
the step and replays it.  Every later call copies its inputs into the
static buffers and replays.  A capture that fails raises, naming the step
and CUDA's error: there is no return to the eager route.

On the CPU (asked for explicitly, as the tests do) the step runs eagerly
over the same static buffers, and its outputs are copied into static
outputs that the next call overwrites, so the CPU runs the aliasing rules
of the card.

A replay makes no Python call, so the kernels' wrappers count nothing: the
launches each graph made at its capture are recorded and added to the
kernel modules' ``LAUNCHES`` on every replay (the capture itself runs no
kernel, and its counts are taken back).  ``STATS`` counts captures,
replays, capture seconds and the bytes the graph pools reserved.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Callable

import torch

from ..kernels.flash_attention import flash_attention as _k4
from ..kernels.mamba_scan import mamba_scan as _k5
from ..kernels.matmul import matmul as _k3
from ..kernels.prefill import prefill as _k12
from ..tree import tree_flatten

__all__ = ["CompiledStep", "STATS", "new_pool"]

#: The kernel modules' launch counters that a replay adds to.
_COUNTERS = (_k12.LAUNCHES, _k3.LAUNCHES, _k4.LAUNCHES, _k5.LAUNCHES)

#: Since the counts were last set to 0: graphs captured, graph replays, host
#: seconds spent capturing (the capture's own replay excluded), and the
#: device memory the graph pools reserved while capturing.
STATS: dict[str, float] = {"captures": 0, "replays": 0, "capture_s": 0.0,
                           "pool_bytes": 0}


def _counts() -> list[dict[str, int]]:
    return [dict(c) for c in _COUNTERS]


def new_pool(device: torch.device):
    """A graph memory pool for one engine's (or trainer's) steps on
    ``device`` (None on the CPU).  An engine runs one step at a time on one
    stream, so its graphs share the pool's intermediates; each graph's
    outputs stay held by its step."""
    if device.type != "cuda":
        return None
    return torch.cuda.graph_pool_handle()


class CompiledStep:
    """``fn(*inputs)`` for one set of input shapes, captured on CUDA.

    ``fn`` takes the static input buffers and returns a tensor or a pytree
    of tensors (``repro_torch.tree``).  Call the step with tensors of the
    shapes and dtypes of its first call; it returns the step's result,
    which on CUDA from the second call on (on the CPU from the first) is
    the static outputs: the next call overwrites them, so a caller that
    keeps a result past the next call clones it."""

    def __init__(self, name: str, fn: Callable[..., Any],
                 device: str | torch.device, pool=None,
                 stream: torch.cuda.Stream | None = None):
        self.name = name
        self.fn = fn
        self.device = torch.device(device)
        if self.device.type == "cuda" and stream is None:
            stream = torch.cuda.Stream(self.device)
        self.pool = pool
        self.stream = stream
        self.inputs: list[torch.Tensor] | None = None
        self.outputs: Any = None
        self.graph: torch.cuda.CUDAGraph | None = None
        self.calls = 0
        self.capture_s = 0.0
        self.pool_bytes = 0
        self._launches: list[tuple[dict, str, int]] = []

    def _fill(self, inputs) -> None:
        if self.inputs is None:
            self.inputs = [torch.empty(x.shape, dtype=x.dtype,
                                       device=self.device) for x in inputs]
        if len(inputs) != len(self.inputs) or any(
                tuple(x.shape) != tuple(s.shape) or x.dtype != s.dtype
                for x, s in zip(inputs, self.inputs)):
            raise ValueError(
                f"{self.name}: inputs {[(tuple(x.shape), x.dtype) for x in inputs]}"
                f" do not match the step's "
                f"{[(tuple(s.shape), s.dtype) for s in self.inputs]}")
        for s, x in zip(self.inputs, inputs):
            s.copy_(x)

    def _run(self) -> Any:
        """The step over the static inputs (warm-up, capture, CPU)."""
        return self.fn(*self.inputs)

    def __call__(self, *inputs: torch.Tensor) -> Any:
        self._fill(inputs)
        self.calls += 1
        if self.device.type != "cuda":
            return self._call_cpu()
        if self.calls == 1:
            main = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(main)
            with torch.cuda.stream(self.stream):
                out = self._run()
            main.wait_stream(self.stream)
            return out
        if self.graph is None:
            self._capture()
        self.graph.replay()
        for counter, key, n in self._launches:
            counter[key] += n
        STATS["replays"] += 1
        return self.outputs

    def _call_cpu(self) -> Any:
        out = self._run()
        if self.outputs is None:
            self.outputs = out
            return out
        new, _ = tree_flatten(out)
        for dst, src in zip(tree_flatten(self.outputs)[0], new, strict=True):
            if dst is not src:
                dst.copy_(src)
        return self.outputs

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        before = _counts()
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        # No cyclic garbage collection while capturing: a collection that
        # frees an unreachable engine destroys its graphs, and destroying a
        # graph is not permitted while a stream captures (it invalidates
        # this capture: seen on the card, a step captured after another
        # model's engines were dropped).
        collecting = gc.isenabled()
        gc.disable()
        # The graph allocates from its private pool, which cannot take the
        # blocks the allocator keeps cached for eager tensors: hand those
        # back to the device first (on the card a training step's capture
        # ran out of memory beside 46 GiB of cached, unused blocks).
        torch.cuda.empty_cache()
        try:
            # ``torch.cuda.graph`` would leave the side stream current when
            # its capture fails; this block restores the caller's stream.
            # "thread_local": autograd's device thread launches the
            # backward's kernels into this stream; the mode bars unsafe
            # calls from this thread only (``global`` and ``relaxed``
            # capture the same bits: scripts/train_capture_probe.py).
            with torch.cuda.stream(self.stream):
                graph.capture_begin(pool=self.pool,
                                    capture_error_mode="thread_local")
                try:
                    reserved = torch.cuda.memory_reserved(self.device)
                    out = self._run()
                    grown = torch.cuda.memory_reserved(self.device) - reserved
                finally:
                    graph.capture_end()
        except Exception as err:
            raise RuntimeError(f"CUDA graph capture of {self.name} failed: "
                               f"{type(err).__name__}: {err}") from err
        finally:
            if collecting:
                gc.enable()
            # The capture ran no kernel: take back what the wrappers counted
            # and keep it as the graph's launches, added on every replay.
            after = _counts()
            self._launches = []
            for counter, b, a in zip(_COUNTERS, before, after):
                for key in a:
                    if a[key] != b.get(key, 0):
                        self._launches.append((counter, key,
                                               a[key] - b.get(key, 0)))
                        counter[key] = b.get(key, 0)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = grown
        self.graph = graph
        self.outputs = out
        STATS["captures"] += 1
        STATS["capture_s"] += self.capture_s
        STATS["pool_bytes"] += grown

