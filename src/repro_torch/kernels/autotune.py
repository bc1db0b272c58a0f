"""Kernel block autotuning: the shape-bucketed registry, keyed by torch device.

Port of the registry half of ``repro/kernels/autotune.py``: winners are
keyed by

    op | backend | shape bucket

where every shape dimension is bucketed to its next power of two (close
shapes share tiles; an unswept shape falls back to the op's built-in
defaults).  The backend is the torch device: ``cpu`` or ``cuda:<card
name>``.  The port keeps its own registry file beside this module and never
reads or writes the JAX package's.  The JAX compile-cache half has no
counterpart: PyTorch runs eagerly, and the kernels' libraries are cached by
content (``kernels/build.py``'s ``_build/``).  No op of the port consults
it yet: the CUDA prefill kernel has one compiled tile, and the registry is
empty; ``save_registry`` writes what a sweep finds.
"""

from __future__ import annotations

import functools
import json
import os

import torch

__all__ = [
    "shape_bucket", "registry_key", "device_backend", "lookup",
    "load_registry", "save_registry", "REGISTRY_PATH",
]

REGISTRY_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "autotune_registry.json")


def shape_bucket(dims: dict[str, int]) -> str:
    """Bucket each dimension to its next power of two: ``m=1000, k=512`` ->
    ``"k512_m1024"`` (sorted for key stability)."""
    parts = []
    for name in sorted(dims):
        v = int(dims[name])
        if v < 1:
            raise ValueError(f"shape dim {name}={v} must be >= 1")
        parts.append(f"{name}{1 << (v - 1).bit_length()}")
    return "_".join(parts)


def device_backend(device: str | torch.device) -> str:
    """Registry backend label of a torch device: ``cpu`` or
    ``cuda:<card name>`` (two card models never share tuned tiles)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return dev.type


def registry_key(op: str, dims: dict[str, int], device) -> str:
    return f"{op}|{device_backend(device)}|{shape_bucket(dims)}"


@functools.lru_cache(maxsize=1)
def load_registry(path: str = REGISTRY_PATH) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def save_registry(registry: dict, path: str = REGISTRY_PATH) -> None:
    """Write ``registry`` (key -> ``{"blocks": {...}, ...}``) as sorted JSON;
    the next ``load_registry`` reads it anew."""
    with open(path, "w") as f:
        json.dump(registry, f, indent=2, sort_keys=True)
        f.write("\n")
    load_registry.cache_clear()


def lookup(op: str, dims: dict[str, int], device,
           path: str = REGISTRY_PATH) -> dict:
    """Tuned block params for this op/device/shape bucket, or ``{}`` when the
    bucket was never swept (callers then keep their built-in defaults)."""
    entry = load_registry(path).get(registry_key(op, dims, device))
    if not isinstance(entry, dict):
        return {}
    return entry.get("blocks", {})
