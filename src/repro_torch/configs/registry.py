"""Architecture registry of the port: ``--arch <id>`` resolution, holding
only the architectures the port runs: dense GQA/MHA/MQA decoders, an SSD
mamba stack, MoE decoders and the mamba + attention + MoE hybrid.  The
others (MLA, M-RoPE with embeds input, enc-dec) join with the port slices
that bring their layers (see ROADMAP.md)."""

from __future__ import annotations

import dataclasses
import importlib

from ..models.config import ModelConfig

_MODULES = {
    "qwen2-1.5b": "qwen2_1_5b",
    "mamba2-2.7b": "mamba2_2_7b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "qwen3-8b": "qwen3_8b",
    "granite-34b": "granite_34b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
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
