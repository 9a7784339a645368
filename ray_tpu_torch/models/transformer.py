"""Decoder-only transformer (dense path), PyTorch.

The JAX package's Llama-family decoder (GQA, rotary, RMSNorm, SwiGLU) as
plain functions over a parameter dictionary of the JAX package's layout:
``embed`` (V, D), ``layers/*`` stacked on a leading L axis in ``x @ W``
orientation, ``final_norm`` and, when untied, ``lm_head`` (D, V). Layers
run in a Python loop where the JAX package scans.

Storage dtypes. For serving (the default): matmul weights and the
embedding are kept in ``cfg.dtype`` (bf16 for llama3-8b), the norm scales
in ``cfg.param_dtype``. The JAX package keeps every weight in
``param_dtype`` and casts each one to the activation dtype at every use;
storing the cast once computes exactly the same values and is what lets
Llama-3-8B fit in 16 GB instead of 32 GB. The norm scales stay in
``param_dtype`` because ``rms_norm`` multiplies by them in f32. For
training (``master_weights=True``): every leaf in ``param_dtype``, as the
JAX package stores it (f32 master weights, cast in each matmul).

``forward``, ``forward_hidden`` and ``loss_fn`` record autograd when grad
is enabled (training); the serving callers run them under
``torch.no_grad()``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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


def storage_dtype(cfg: TransformerConfig, name: str,
                  master_weights: bool = False) -> torch.dtype:
    """Serving: norm scales in param_dtype, every other weight in
    cfg.dtype. Master weights: every leaf in param_dtype."""
    return cfg.param_dtype if master_weights or is_norm(name) else cfg.dtype


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
                device: DeviceLike = "cuda",
                master_weights: bool = False) -> Params:
    """Scaled-normal init from a seeded torch.Generator on `device`; the
    residual-branch outputs (wo, w_down) are scaled down by depth. Layer
    weights are drawn one layer at a time so the f32 draw of a stacked
    weight is never held whole. `master_weights` stores every leaf in
    cfg.param_dtype (training) instead of the serving storage."""
    require_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def normal(shape, scale, dtype):
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * scale).to(dtype)

    layers = {}
    for name, shape in sorted(_dense_layer_shapes(cfg).items()):
        dt = storage_dtype(cfg, name, master_weights)
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
        "embed": normal((cfg.vocab_size, cfg.d_model), 0.02,
                        storage_dtype(cfg, "embed", master_weights)),
        "layers": layers,
        "final_norm": torch.ones((cfg.d_model,), dtype=cfg.param_dtype,
                                 device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((cfg.d_model, cfg.vocab_size), 0.02,
                                   storage_dtype(cfg, "lm_head",
                                                 master_weights))
    return params


def params_to(params: Params, device: torch.device) -> Params:
    """The parameter dictionary on `device` (no copy where it already is)."""
    return {k: (params_to(v, device) if isinstance(v, dict)
                else v.to(device))
            for k, v in params.items()}


def serving_params(cfg: TransformerConfig, params: Params,
                   device: torch.device) -> Params:
    """A copy of every leaf (a tensor or anything torch.as_tensor takes)
    on `device` in the serving storage, never the tensor given, so the
    holder owns it: f32 master weights are cast once here, where the JAX
    package keeps them and casts at each use (the same values: every
    matmul casts its weight to cfg.dtype)."""
    def copy(name, w):
        return torch.as_tensor(w).to(device=device,
                                     dtype=storage_dtype(cfg, name),
                                     copy=True)
    return {k: ({n: copy(n, w) for n, w in v.items()}
                if isinstance(v, dict) else copy(k, v))
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


def _remat_layer(cfg: TransformerConfig):
    """The layer function, checkpointed per layer when training with
    cfg.remat (policy None: keep only the layer's input, recompute the
    rest in the backward, as jax.checkpoint does)."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return _layer
    if cfg.remat_policy == "dots":
        raise NotImplementedError(
            "remat_policy='dots' is not ported yet (ROADMAP.md, Queue 1 "
            "item 3: what the training slice left out)")
    if cfg.remat_policy is not None:
        raise ValueError(f"remat_policy must be None or 'dots', got "
                         f"{cfg.remat_policy!r}")

    def layer(cfg, lp, x, sin, cos):
        return checkpoint(_layer, cfg, lp, x, sin, cos, use_reentrant=False)
    return layer


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
    layer = _remat_layer(cfg)
    # Unbind each stacked (L, ...) weight once: the backward of unbind
    # stacks the L layer grads in one pass, where indexing w[i] per layer
    # would zero-fill and add a whole (L, ...) grad for every layer.
    per_layer = {k: w.unbind(0) for k, w in params["layers"].items()}
    for i in range(cfg.n_layers):
        x = layer(cfg, {k: ws[i] for k, ws in per_layer.items()}, x, sin,
                  cos)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=embed.device)


def _lm_head(cfg: TransformerConfig, params: Params) -> torch.Tensor:
    return (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(cfg.dtype)


def forward(cfg: TransformerConfig, params: Params, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V) float32, aux loss)."""
    x, aux = forward_hidden(cfg, params, tokens)
    return (x @ _lm_head(cfg, params)).float(), aux


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

Metrics = Dict[str, torch.Tensor]


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-position logsumexp(logits) - logits[target], f32."""
    gold = logits.gather(-1, targets[..., None].long())[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def _metrics(ce: torch.Tensor, aux: torch.Tensor, tokens: torch.Tensor
             ) -> Tuple[torch.Tensor, Metrics]:
    total = ce + aux
    return total, {"loss": total, "ce": ce, "aux": aux, "tokens": tokens}


def token_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                        mask: Optional[torch.Tensor], aux: torch.Tensor
                        ) -> Tuple[torch.Tensor, Metrics]:
    """Next-token cross entropy (mean over unmasked positions) + metrics."""
    nll = _nll(logits, targets)
    mask = (torch.ones_like(nll) if mask is None
            else mask.to(device=nll.device, dtype=torch.float32))
    denom = torch.clamp(mask.sum(), min=1.0)
    return _metrics((nll * mask).sum() / denom, aux, mask.sum())


def chunked_cross_entropy(cfg: TransformerConfig, params: Params,
                          x: torch.Tensor, targets: torch.Tensor,
                          mask: Optional[torch.Tensor], aux: torch.Tensor,
                          chunk: int) -> Tuple[torch.Tensor, Metrics]:
    """Blockwise vocab projection + cross entropy: each sequence chunk's
    logits are computed inside a checkpoint, so the f32 (B, S, V) logits
    are never held whole (recomputed chunk by chunk in the backward).
    The same per-position logsumexp in f32 as token_cross_entropy."""
    B, S, _ = x.shape
    head = _lm_head(cfg, params)
    targets = targets.to(x.device)
    mask = (torch.ones((B, S), dtype=torch.float32, device=x.device)
            if mask is None
            else mask.to(device=x.device, dtype=torch.float32))

    def body(xc, tc, mc):
        logits = (xc @ head).float()
        return (_nll(logits, tc) * mc).sum()

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        tot = tot + checkpoint(body, x[:, sl], targets[:, sl], mask[:, sl],
                               use_reentrant=False)
    cnt = mask.sum()
    return _metrics(tot / torch.clamp(cnt, min=1.0), aux, cnt)


def loss_fn(cfg: TransformerConfig, params: Params, tokens: torch.Tensor,
            targets: torch.Tensor, mask: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Metrics]:
    """Training loss of the JAX package's loss_fn: token cross entropy
    over forward's logits, or the chunked form when cfg.ce_chunk > 0."""
    S = tokens.shape[1]
    if cfg.ce_chunk > 0:
        if S % cfg.ce_chunk != 0:
            # Silently materialising the full logits is exactly what the
            # option exists to avoid.
            raise ValueError(
                f"ce_chunk={cfg.ce_chunk} must divide the sequence "
                f"length (got S={S})")
        if S > cfg.ce_chunk:
            x, aux = forward_hidden(cfg, params, tokens)
            return chunked_cross_entropy(cfg, params, x, targets, mask,
                                         aux, cfg.ce_chunk)
    logits, aux = forward(cfg, params, tokens)
    return token_cross_entropy(logits, targets.to(logits.device), mask, aux)
