from .registry import ARCH_IDS, get_config
from .shapes import SHAPES, ShapeSpec, cell_status, input_specs

__all__ = ["ARCH_IDS", "get_config", "SHAPES", "ShapeSpec", "cell_status",
           "input_specs"]
