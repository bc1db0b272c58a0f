"""Architecture registry of the port: ``--arch <id>`` resolution, holding
only the architectures the port runs (a dense GQA decoder and an SSD mamba
stack).  The others join with the port slices that bring their layers (see
ROADMAP.md)."""

from __future__ import annotations

import dataclasses
import importlib

from ..models.config import ModelConfig

_MODULES = {
    "qwen2-1.5b": "qwen2_1_5b",
    "mamba2-2.7b": "mamba2_2_7b",
}

ARCH_IDS = tuple(_MODULES)


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port runs: {sorted(_MODULES)}")
    return importlib.import_module(f".{_MODULES[arch]}", __package__)


def get_config(arch: str, reduced: bool = False, **overrides) -> ModelConfig:
    """The arch's config (or its reduced test size) with top-level fields
    replaced by ``overrides``."""
    cfg = _mod(arch).reduced() if reduced else _mod(arch).config()
    return dataclasses.replace(cfg, **overrides).validate()
