"""Grain-addressed deterministic data pipeline.

Port of ``repro/data/pipeline.py``.  The schedulable unit is a *grain*: a
fixed-shape microbatch of token sequences, addressed by (step, grain_id)
and generated deterministically, so any worker can (re)produce any grain —
homogenized re-allotment and elastic recovery need no data redistribution.
Grains are numpy arrays made exactly as the reference makes them (the same
``SeedSequence([seed, step, gid])`` draws), so both packages train on the
same tokens; ``batch_from_grains`` hands them over as tensors on the
caller's device.

Two sources:
  SyntheticSource — deterministic PRNG tokens (tests, smoke runs).
  MemmapSource    — tokenized corpus in a flat .npy memmap, grains are strided
                    windows (production path; one 1-D array, no headers).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.scheduler import GrainPlan

__all__ = ["GrainSpec", "SyntheticSource", "MemmapSource",
           "batch_from_grains", "worker_batch"]


@dataclasses.dataclass(frozen=True)
class GrainSpec:
    grain_size: int          # sequences per grain
    seq_len: int
    vocab_size: int


class SyntheticSource:
    """Deterministic tokens: grain (step, gid) is a pure function of seed."""

    def __init__(self, spec: GrainSpec, seed: int = 0):
        self.spec = spec
        self.seed = seed

    def grain(self, step: int, gid: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, gid])
        )
        s = self.spec
        return rng.integers(
            0, s.vocab_size, (s.grain_size, s.seq_len + 1), dtype=np.int64
        )


class MemmapSource:
    """Flat token stream (np.memmap of int32); grain (step,gid) reads a
    deterministic window.  Document layout: one 1-D array, no headers."""

    def __init__(self, path: str, spec: GrainSpec):
        self.tokens = np.load(path, mmap_mode="r")
        self.spec = spec
        s = spec
        self.n_windows = (len(self.tokens) - 1) // s.seq_len

    def grain(self, step: int, gid: int) -> np.ndarray:
        s = self.spec
        out = np.empty((s.grain_size, s.seq_len + 1), np.int64)
        for i in range(s.grain_size):
            w = (step * 1_000_003 + gid * s.grain_size + i) % self.n_windows
            out[i] = self.tokens[w * s.seq_len : w * s.seq_len + s.seq_len + 1]
        return out


def batch_from_grains(
    source, step: int, grain_ids: list[int], spec: GrainSpec,
    pad_to_grains: int | None = None, device=None,
) -> dict:
    """Materialize a worker's grains into a model batch on ``device`` (the
    CPU when None): tokens and targets int32, loss_mask f32.

    ``pad_to_grains`` keeps the shape fixed while the *real* grain count
    varies with the homogenized allotment: padded grains carry loss_mask=0 so
    they contribute nothing (and the weighted combine stays unbiased).
    """
    n_real = len(grain_ids)
    n_total = pad_to_grains or n_real
    if n_total < n_real:
        raise ValueError("pad_to_grains < real grain count")
    gs, sl = spec.grain_size, spec.seq_len
    toks = np.zeros((n_total * gs, sl + 1), np.int64)
    mask = np.zeros((n_total * gs, sl), np.float32)
    for i, gid in enumerate(grain_ids):
        toks[i * gs : (i + 1) * gs] = source.grain(step, gid)
        mask[i * gs : (i + 1) * gs] = 1.0
    return {
        "tokens": torch.as_tensor(toks[:, :-1].astype(np.int32), device=device),
        "targets": torch.as_tensor(toks[:, 1:].astype(np.int32), device=device),
        "loss_mask": torch.as_tensor(mask, device=device),
    }


def worker_batch(
    source, step: int, plan: GrainPlan, worker: str, spec: GrainSpec,
    pad_to_grains: int | None = None, device=None,
) -> dict:
    return batch_from_grains(
        source, step, list(plan.range_for(worker)), spec, pad_to_grains,
        device=device,
    )
