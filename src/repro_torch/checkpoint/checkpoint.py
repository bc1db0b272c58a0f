"""Atomic, async, keep-k pytree checkpoints (fault-tolerance substrate).

Port of ``repro/checkpoint/checkpoint.py`` with the same on-disk format, so
a checkpoint written by either package restores in the other: one
``step_<N>/`` directory per checkpoint containing ``arrays.npz`` (leaf i as
``leaf_i``, its raw bytes as a flat uint8 array) + ``tree.json`` (the step,
the structure and each leaf's shape and numpy dtype name) + optional
``extras.json`` (JSON coordinator sidecar state — the perf tracker's EMA
table and the fleet clock — written inside the same atomic rename).  Leaves
are numbered in ``jax.tree_util``'s order (``repro_torch.tree``).  Writes go
to ``.tmp-<N>`` then ``os.rename`` (atomic on POSIX) so a killed worker
never leaves a torn checkpoint; restore picks the highest complete step.
``AsyncCheckpointer`` copies leaves to host memory synchronously and writes
on a background thread.

bfloat16 leaves are recorded as ``"bfloat16"`` (the name ``ml_dtypes`` gives
numpy) and their bytes are reinterpreted through int16, so the port needs
no ``ml_dtypes``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from ..tree import tree_flatten, tree_map, tree_unflatten

__all__ = ["AsyncCheckpointer", "available_steps", "prune", "read_extras",
           "restore", "save"]

_TREE_FILE = "tree.json"
_ARR_FILE = "arrays.npz"
_EXTRAS_FILE = "extras.json"

#: torch dtype <-> numpy dtype name as ``str(np.dtype(...))`` gives it.
_NAMES = {
    torch.float32: "float32", torch.float64: "float64",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
    torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool",
}
_DTYPES = {name: dt for dt, name in _NAMES.items()}


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return _NAMES[leaf.dtype]
    return str(np.dtype(leaf.dtype))


def _leaf_bytes(leaf) -> np.ndarray:
    """A host leaf's raw bytes as a flat uint8 array."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous().reshape(-1)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().view(np.uint8)
    return np.ascontiguousarray(np.asarray(leaf)).reshape(-1).view(np.uint8)


def _leaf_from_bytes(raw: np.ndarray, meta: dict) -> torch.Tensor:
    name, shape = meta["dtype"], meta["shape"]
    if name == "bfloat16":
        t = torch.from_numpy(raw.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(raw.view(np.dtype(name)).copy())
    return t.reshape(shape)


def save(ckpt_dir: str, step: int, tree, extras: dict | None = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    leaves, treedef = tree_flatten(tree)
    tmp = os.path.join(ckpt_dir, f".tmp-{step}")
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, _ARR_FILE),
             **{f"leaf_{i}": _leaf_bytes(l) for i, l in enumerate(leaves)})
    meta = {
        "step": step,
        "treedef": str(treedef),
        "leaves": [{"shape": list(l.shape), "dtype": _dtype_name(l)}
                   for l in leaves],
    }
    with open(os.path.join(tmp, _TREE_FILE), "w") as f:
        json.dump(meta, f)
    if extras is not None:
        with open(os.path.join(tmp, _EXTRAS_FILE), "w") as f:
            json.dump(extras, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def available_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            path = os.path.join(ckpt_dir, name, _TREE_FILE)
            if os.path.exists(path):
                out.append(int(name.split("_")[1]))
    return sorted(out)


def _resolve_step(ckpt_dir: str, step: int | None) -> int | None:
    """Latest complete step, or validate an explicitly requested one.  An
    explicit step that doesn't exist (never written, or pruned by keep-last)
    raises here with the available list — not deep inside ``open``."""
    steps = available_steps(ckpt_dir)
    if not steps:
        if step is not None:
            raise FileNotFoundError(
                f"no checkpoint for step {step}: {ckpt_dir!r} has no complete "
                "checkpoints"
            )
        return None
    if step is None:
        return steps[-1]
    if step not in steps:
        raise FileNotFoundError(
            f"no checkpoint for step {step} in {ckpt_dir!r}; available steps: "
            f"{steps}"
        )
    return step


def restore(ckpt_dir: str, like, step: int | None = None):
    """Restore into the structure of ``like`` (validates shapes/dtypes);
    each leaf lands on the device of ``like``'s leaf.  Returns (tree, step)
    or (None, None) when no checkpoint exists.  An explicit ``step`` that is
    missing (or was pruned) raises ``FileNotFoundError`` listing what is
    available."""
    step = _resolve_step(ckpt_dir, step)
    if step is None:
        return None, None
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, _TREE_FILE)) as f:
        meta = json.load(f)
    data = np.load(os.path.join(path, _ARR_FILE))
    leaves, treedef = tree_flatten(like)
    if len(leaves) != len(meta["leaves"]):
        raise ValueError(
            f"checkpoint has {len(meta['leaves'])} leaves, expected {len(leaves)}"
        )
    restored = []
    for i, ref in enumerate(leaves):
        m = meta["leaves"][i]
        if tuple(m["shape"]) != tuple(ref.shape) or \
                m["dtype"] != _dtype_name(ref):
            raise ValueError(
                f"leaf {i}: saved {m} != expected {tuple(ref.shape)}/"
                f"{_dtype_name(ref)}"
            )
        restored.append(_leaf_from_bytes(data[f"leaf_{i}"], m).to(ref.device))
    return tree_unflatten(treedef, restored), step


def read_extras(ckpt_dir: str, step: int | None = None) -> dict | None:
    """Sidecar coordinator state saved with a checkpoint (see ``save``).
    Returns None when there is no checkpoint or the step carries no extras;
    an explicit missing ``step`` raises like ``restore`` does."""
    step = _resolve_step(ckpt_dir, step)
    if step is None:
        return None
    path = os.path.join(ckpt_dir, f"step_{step:09d}", _EXTRAS_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def prune(ckpt_dir: str, keep_last: int = 3) -> None:
    steps = available_steps(ckpt_dir)
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:09d}"), ignore_errors=True)


class AsyncCheckpointer:
    """Snapshot-to-host synchronously, write on a daemon thread."""

    def __init__(self, ckpt_dir: str, keep_last: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None
        self.errors: list[Exception] = []

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.errors:
            raise self.errors[-1]

    def save(self, step: int, tree, extras: dict | None = None) -> None:
        self.wait()
        host_tree = tree_map(lambda x: x.detach().to("cpu", copy=True), tree)

        def work():
            try:
                save(self.ckpt_dir, step, host_tree, extras=extras)
                prune(self.ckpt_dir, self.keep_last)
            except Exception as e:  # surfaced on next wait()
                self.errors.append(e)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
