"""Architecture registry of the port: ``--arch <id>`` resolution for the
reference's ten architectures: dense GQA/MHA/MQA decoders, an SSD mamba
stack, MoE decoders, the mamba + attention + MoE hybrid, MLA with MoE
(DeepSeek-V2), an embeds-input decoder with M-RoPE (Qwen2-VL) and an
enc-dec model (SeamlessM4T)."""

from __future__ import annotations

import dataclasses
import importlib

from ..models.config import ModelConfig

_MODULES = {
    "qwen2-vl-7b": "qwen2_vl_7b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "mamba2-2.7b": "mamba2_2_7b",
    "granite-34b": "granite_34b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "qwen3-8b": "qwen3_8b",
    "qwen2-1.5b": "qwen2_1_5b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "seamless-m4t-medium": "seamless_m4t_medium",
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


def all_configs(reduced: bool = False) -> dict[str, ModelConfig]:
    """Every arch's config (or its reduced test size), by arch id."""
    return {a: get_config(a, reduced) for a in ARCH_IDS}
