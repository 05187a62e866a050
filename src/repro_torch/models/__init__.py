from .config import ModelConfig
from . import layers, transformer, xlstm, rglru

__all__ = ["ModelConfig", "layers", "transformer", "xlstm", "rglru"]
