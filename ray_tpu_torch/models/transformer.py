"""Decoder-only transformer (dense path), PyTorch.

The JAX package's Llama-family decoder (GQA, rotary, RMSNorm, SwiGLU) as
plain functions over a parameter dictionary of the JAX package's layout:
``embed`` (V, D), ``layers/*`` stacked on a leading L axis in ``x @ W``
orientation, ``final_norm`` and, when untied, ``lm_head`` (D, V). Layers
run in a Python loop where the JAX package scans.

Storage dtypes, for serving: matmul weights and the embedding are kept in
``cfg.dtype`` (bf16 for llama3-8b), the norm scales in ``cfg.param_dtype``.
The JAX package keeps every weight in ``param_dtype`` and casts each one to
the activation dtype at every use; storing the cast once computes exactly
the same values and is what lets Llama-3-8B fit in 16 GB instead of 32 GB.
The norm scales stay in ``param_dtype`` because ``rms_norm`` multiplies by
them in f32.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from ..ops.flash_attention import flash_attention, flash_attention_plain
from .configs import TransformerConfig, require_dense

Params = Dict[str, Any]


def _dense_layer_shapes(cfg: TransformerConfig) -> Dict[str, Tuple[int, ...]]:
    d, hd = cfg.d_model, cfg.head_dim
    return {
        "attn_norm": (d,),
        "wq": (d, cfg.n_heads * hd),
        "wk": (d, cfg.n_kv_heads * hd),
        "wv": (d, cfg.n_kv_heads * hd),
        "wo": (cfg.n_heads * hd, d),
        "ffn_norm": (d,),
        "w_gate": (d, cfg.d_ff),
        "w_up": (d, cfg.d_ff),
        "w_down": (cfg.d_ff, d),
    }


def is_norm(name: str) -> bool:
    return name.endswith("norm")


def storage_dtype(cfg: TransformerConfig, name: str) -> torch.dtype:
    """Norm scales in param_dtype, every other weight in cfg.dtype."""
    return cfg.param_dtype if is_norm(name) else cfg.dtype


def param_shapes(cfg: TransformerConfig) -> Params:
    """Same structure as the parameters, leaves = shapes."""
    shapes: Params = {
        "embed": (cfg.vocab_size, cfg.d_model),
        "layers": {k: (cfg.n_layers,) + s
                   for k, s in _dense_layer_shapes(cfg).items()},
        "final_norm": (cfg.d_model,),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (cfg.d_model, cfg.vocab_size)
    return shapes


def init_params(cfg: TransformerConfig, seed: int = 0, *,
                device: DeviceLike = "cuda") -> Params:
    """Scaled-normal init from a seeded torch.Generator on `device`; the
    residual-branch outputs (wo, w_down) are scaled down by depth. Layer
    weights are drawn one layer at a time so the f32 draw of a stacked
    weight is never held whole."""
    require_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def normal(shape, scale, dtype):
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * scale).to(dtype)

    layers = {}
    for name, shape in sorted(_dense_layer_shapes(cfg).items()):
        dt = storage_dtype(cfg, name)
        if is_norm(name):
            layers[name] = torch.ones((cfg.n_layers,) + shape, dtype=dt,
                                      device=dev)
            continue
        scale = (0.02 / math.sqrt(2 * cfg.n_layers)
                 if name in ("wo", "w_down") else 0.02)
        w = torch.empty((cfg.n_layers,) + shape, dtype=dt, device=dev)
        for i in range(cfg.n_layers):
            w[i] = normal(shape, scale, dt)
        layers[name] = w
    params: Params = {
        "embed": normal((cfg.vocab_size, cfg.d_model), 0.02, cfg.dtype),
        "layers": layers,
        "final_norm": torch.ones((cfg.d_model,), dtype=cfg.param_dtype,
                                 device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((cfg.d_model, cfg.vocab_size), 0.02,
                                   cfg.dtype)
    return params


def params_to(params: Params, device: torch.device) -> Params:
    """The parameter dictionary on `device` (no copy where it already is)."""
    return {k: (params_to(v, device) if isinstance(v, dict)
                else v.to(device))
            for k, v in params.items()}


def layer_params(params: Params, i: int) -> Dict[str, torch.Tensor]:
    return {k: w[i] for k, w in params["layers"].items()}


# ---------------------------------------------------------------------------
# Model pieces
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def rope_tables(cfg: TransformerConfig, seq_len: int,
                device: Optional[torch.device] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    half = cfg.head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    freqs = torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32,
                                   device=device), exps)
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    ang = pos[:, None] * freqs[None, :]                   # (S, half)
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, Dh). Rotate the half-split pairs (x[..., :half],
    x[..., half:]); sin/cos are cast to x's dtype before the rotation."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin = sin[None, :, None, :].to(x.dtype)
    cos = cos[None, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(cfg: TransformerConfig, q, k, v) -> torch.Tensor:
    """Causal attention: the flash-attention kernel (its plain version on
    a CPU tensor), or the plain version when cfg.attn_impl asks for it."""
    if cfg.attn_impl == "reference":
        return flash_attention_plain(q, k, v, causal=True)[0]
    return flash_attention(q, k, v, causal=True)


def attention(cfg: TransformerConfig, lp: Dict[str, torch.Tensor],
              x: torch.Tensor, sin: torch.Tensor,
              cos: torch.Tensor) -> torch.Tensor:
    """Causal self-attention with GQA. x: (B, S, D) in activation dtype."""
    B, S, _ = x.shape
    H, KVH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ lp["wq"].to(x.dtype)).reshape(B, S, H, Dh)
    k = (x @ lp["wk"].to(x.dtype)).reshape(B, S, KVH, Dh)
    v = (x @ lp["wv"].to(x.dtype)).reshape(B, S, KVH, Dh)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    out = _attend(cfg, q, k, v).reshape(B, S, H * Dh)
    return out @ lp["wo"].to(x.dtype)


def dense_ffn(lp: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ lp["w_gate"].to(x.dtype)) * (x @ lp["w_up"].to(x.dtype))
    return h @ lp["w_down"].to(x.dtype)


def _layer(cfg: TransformerConfig, lp, x, sin, cos) -> torch.Tensor:
    x = x + attention(cfg, lp, rms_norm(x, lp["attn_norm"], cfg.norm_eps),
                      sin, cos)
    return x + dense_ffn(lp, rms_norm(x, lp["ffn_norm"], cfg.norm_eps))


@torch.no_grad()
def forward_hidden(cfg: TransformerConfig, params: Params,
                   tokens: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (final-normed hidden states (B, S, D), aux loss)."""
    require_dense(cfg)
    embed = params["embed"]
    tokens = tokens.to(embed.device)
    S = tokens.shape[1]
    x = embed.to(cfg.dtype)[tokens]
    sin, cos = rope_tables(cfg, S, embed.device)
    for i in range(cfg.n_layers):
        x = _layer(cfg, layer_params(params, i), x, sin, cos)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=embed.device)


def _lm_head(cfg: TransformerConfig, params: Params) -> torch.Tensor:
    return (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(cfg.dtype)


@torch.no_grad()
def forward(cfg: TransformerConfig, params: Params, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V) float32, aux loss)."""
    x, aux = forward_hidden(cfg, params, tokens)
    return (x @ _lm_head(cfg, params)).float(), aux
