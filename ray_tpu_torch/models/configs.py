"""Model configuration and the named configs of the decoder.

The port's own copy of ``TransformerConfig`` (field for field the JAX
package's, with torch dtypes) and of the named-config table. The MoE
configs stay in the table so the names line up with the JAX package, but
this slice serves the dense path only: asking for one raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    n_kv_heads: int = 12
    d_ff: int = 3072
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16        # activation dtype
    param_dtype: Any = torch.float32   # master weights
    tie_embeddings: bool = True
    remat: bool = True
    remat_policy: Optional[str] = None
    ce_chunk: int = 0
    # "auto" = the flash-attention kernel on a CUDA tensor (its plain
    # version on a CPU tensor); "reference" forces the plain attention in
    # transformer.forward.
    attn_impl: str = "auto"
    seq_parallel: str = "ring"
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_loss_weight: float = 0.02

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    def num_params(self) -> int:
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        hd = self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.is_moe:
            ffn = self.moe_experts * 3 * d * f + d * self.moe_experts
        else:
            ffn = 3 * d * f
        per_layer = attn + ffn + 2 * d
        emb = v * d if self.tie_embeddings else 2 * v * d
        return L * per_layer + emb + d


def require_dense(cfg: TransformerConfig) -> None:
    """The port serves dense models only; MoE arrives with a later slice."""
    if cfg.is_moe:
        raise NotImplementedError(
            "MoE configs are not ported yet: the MoE FFN (moe_ffn) lands "
            "with the MoE slice of the PyTorch port (ROADMAP.md)")


def tiny_test(vocab: int = 256) -> TransformerConfig:
    """Milliseconds-scale config for unit tests."""
    return TransformerConfig(
        vocab_size=vocab, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=128, dtype=torch.float32,
        param_dtype=torch.float32, remat=False)


def tiny_moe_test(vocab: int = 256) -> TransformerConfig:
    return TransformerConfig(
        vocab_size=vocab, d_model=64, n_layers=2, n_heads=4, n_kv_heads=4,
        d_ff=128, max_seq_len=128, dtype=torch.float32,
        param_dtype=torch.float32, remat=False,
        moe_experts=4, moe_top_k=2)


def gpt2_125m() -> TransformerConfig:
    """BASELINE config 1 (GPT-2 125M equivalent param count, rotary)."""
    return TransformerConfig(
        vocab_size=50304,
        d_model=768, n_layers=12, n_heads=12, n_kv_heads=12, d_ff=3072,
        max_seq_len=1024, tie_embeddings=True)


def llama_654m() -> TransformerConfig:
    """Llama-family 654M: GQA 12/4, SwiGLU, untied head."""
    return TransformerConfig(
        vocab_size=32768, d_model=1536, n_layers=16, n_heads=12,
        n_kv_heads=4, d_ff=6144, max_seq_len=1024,
        tie_embeddings=False, remat=True, remat_policy=None)


def llama_1b4() -> TransformerConfig:
    """Llama-family ~1.46B with bf16 params and chunked cross-entropy."""
    return TransformerConfig(
        vocab_size=32768, d_model=2048, n_layers=28, n_heads=16,
        n_kv_heads=8, d_ff=5632, max_seq_len=1024,
        tie_embeddings=False, remat=True, remat_policy=None,
        param_dtype=torch.bfloat16, ce_chunk=512)


def llama3_8b() -> TransformerConfig:
    """BASELINE config 2 (Llama-3-8B shapes)."""
    return TransformerConfig(
        vocab_size=128256, d_model=4096, n_layers=32, n_heads=32,
        n_kv_heads=8, d_ff=14336, max_seq_len=8192, rope_theta=500000.0,
        tie_embeddings=False)


def mixtral_8x7b() -> TransformerConfig:
    """BASELINE config 3 (Mixtral 8x7B shapes, top-2 MoE)."""
    return TransformerConfig(
        vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
        n_kv_heads=8, d_ff=14336, max_seq_len=8192, rope_theta=1e6,
        tie_embeddings=False, moe_experts=8, moe_top_k=2)


NAMED = {
    "tiny": tiny_test,
    "tiny_moe": tiny_moe_test,
    "gpt2-125m": gpt2_125m,
    "llama-654m": llama_654m,
    "llama-1b4": llama_1b4,
    "llama3-8b": llama3_8b,
    "mixtral-8x7b": mixtral_8x7b,
}


def get(name: str) -> TransformerConfig:
    """Named config; MoE names raise NotImplementedError in this port."""
    if name not in NAMED:
        raise ValueError(f"Unknown config {name!r}; have {sorted(NAMED)}")
    cfg = NAMED[name]()
    require_dense(cfg)
    return cfg
