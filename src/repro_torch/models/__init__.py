from .bridge import params_from_numpy
from .config import (
    EncoderConfig,
    LayerSpec,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
)
from .model import Model

__all__ = ["EncoderConfig", "LayerSpec", "MLAConfig", "ModelConfig",
           "MoEConfig", "SSMConfig", "Model", "params_from_numpy"]
