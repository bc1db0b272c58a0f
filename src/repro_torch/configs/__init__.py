from .registry import ARCH_IDS, get_config

__all__ = ["ARCH_IDS", "get_config"]
