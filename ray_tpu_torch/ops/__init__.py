"""The port's kernels: hand-written CUDA for Hopper, each beside its plain
PyTorch version. Sources live in ``csrc/`` and are built at first use."""

from .flash_attention import (
    dkv_launches,
    dq_launches,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_plain,
    fwd_launches,
)

__all__ = [
    "dkv_launches",
    "dq_launches",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_plain",
    "flash_attention_fwd",
    "flash_attention_plain",
    "fwd_launches",
]
