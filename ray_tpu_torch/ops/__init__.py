"""The port's kernels: hand-written CUDA for Hopper, each beside its plain
PyTorch version. Sources live in ``csrc/`` and are built at first use."""

from .flash_attention import (
    flash_attention,
    flash_attention_fwd,
    flash_attention_plain,
    fwd_launches,
)

__all__ = [
    "flash_attention",
    "flash_attention_fwd",
    "flash_attention_plain",
    "fwd_launches",
]
