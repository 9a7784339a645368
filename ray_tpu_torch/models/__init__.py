"""The port's decoder (configs, transformer) and generation path."""

from . import configs
from .configs import TransformerConfig

__all__ = ["TransformerConfig", "configs"]
