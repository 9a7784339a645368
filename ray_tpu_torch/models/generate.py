"""Autoregressive generation: prefill/decode split with a static KV cache.

The JAX package's serving path in PyTorch. The KV cache keeps the
contiguous per-slot layout, (L, B, S_max, KVH, Dh) plus ``seq_lens``;
prompts are padded to length buckets, decode runs one token for every slot
with per-slot rotary positions.

Differences of idiom from the JAX package:
- The cache is updated IN PLACE (JAX donates and rebuilds it). Every
  function that writes it also returns it, so call sites read the same.
- Each layer writes its K/V straight into the cache instead of returning
  a stacked (L, W, S, KVH, Dh) buffer for a later scatter.
- Slot indices are host values. A row whose slot is outside
  [0, num_slots) (the padding rows of a fixed-width tile carry
  slot == num_slots) is dropped from every cache write, as the JAX
  scatters' mode="drop" drops it.
- Random draws come from an explicit torch.Generator in place of a key.

Prefill attention (full and prefix-suffix) goes through
``ops.flash_attention``: the CUDA kernel on the card. Decode attention is
a plain einsum over the cache, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..ops.flash_attention import flash_attention
from .configs import TransformerConfig
from .transformer import (
    Params,
    _lm_head,
    apply_rope,
    dense_ffn,
    forward_hidden,
    layer_params,
    params_to,
    rms_norm,
    rope_tables,
)


class KVCache:
    """Decode state: k/v (L, B, S_max, KVH, Dh) in the activation dtype,
    seq_lens (B,) int64 — tokens already written per slot. Mutated in
    place by this module's prefill and decode functions."""

    __slots__ = ("k", "v", "seq_lens")

    def __init__(self, k: torch.Tensor, v: torch.Tensor,
                 seq_lens: torch.Tensor):
        self.k, self.v, self.seq_lens = k, v, seq_lens

    @property
    def max_seq_len(self) -> int:
        return self.k.shape[2]

    @property
    def num_slots(self) -> int:
        return self.k.shape[1]


def init_kv_cache(cfg: TransformerConfig, num_slots: int,
                  max_seq_len: Optional[int] = None, *,
                  device: DeviceLike = "cuda") -> KVCache:
    dev = resolve_device(device)
    S = max_seq_len or cfg.max_seq_len
    shape = (cfg.n_layers, num_slots, S, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   seq_lens=torch.zeros((num_slots,), dtype=torch.long,
                                        device=dev))


def _host_list(x) -> List[int]:
    if isinstance(x, torch.Tensor):
        return [int(v) for v in x.reshape(-1).tolist()]
    return [int(v) for v in np.asarray(x).reshape(-1)]


def kept_rows(slots, num_slots: int, device
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, slots) index tensors of the rows whose slot is in range —
    the rest are dropped, as JAX's scatter mode="drop" drops them."""
    pairs = [(j, s) for j, s in enumerate(_host_list(slots))
             if 0 <= s < num_slots]
    rows = torch.tensor([j for j, _ in pairs], dtype=torch.long,
                        device=device)
    kept = torch.tensor([s for _, s in pairs], dtype=torch.long,
                        device=device)
    return rows, kept


def _as_long(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                           else x).to(device=device, dtype=torch.long)


# ---------------------------------------------------------------------------
# Layer bodies
# ---------------------------------------------------------------------------

def _rope(x, sin, cos):
    """apply_rope with shared (S, half) tables or per-slot (B, S, half)
    tables (decode: every slot is at its own position)."""
    if sin.dim() == 2:
        return apply_rope(x, sin, cos)
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin = sin[:, :, None, :].to(x.dtype)
    cos = cos[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _qkv(cfg: TransformerConfig, lp, x, sin, cos):
    B, S, _ = x.shape
    H, KVH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ lp["wq"].to(x.dtype)).reshape(B, S, H, Dh)
    k = (x @ lp["wk"].to(x.dtype)).reshape(B, S, KVH, Dh)
    v = (x @ lp["wv"].to(x.dtype)).reshape(B, S, KVH, Dh)
    return _rope(q, sin, cos), _rope(k, sin, cos), v


def _ffn(cfg: TransformerConfig, lp, x):
    return x + dense_ffn(lp, rms_norm(x, lp["ffn_norm"], cfg.norm_eps))


def _prefill_layer(cfg: TransformerConfig, lp, x, sin, cos):
    """Full-prompt layer body; returns (x, this layer's k, v)."""
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(cfg, lp, h, sin, cos)
    out = flash_attention(q, k, v, causal=True)
    B, S = q.shape[:2]
    x = x + out.reshape(B, S, -1) @ lp["wo"].to(x.dtype)
    return _ffn(cfg, lp, x), k, v


def _decode_layer(cfg: TransformerConfig, lp, x, sin, cos, positions,
                  k_cache, v_cache):
    """One-token layer body; writes this token's k/v into the layer's
    cache rows (B, S, KVH, Dh) in place and attends over them."""
    B, S = k_cache.shape[0], k_cache.shape[1]
    H, KVH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(cfg, lp, h, sin, cos)         # q (B,1,H,Dh), k/v (B,1,KVH,Dh)

    # One row per slot at its position, overwriting. A position past the
    # cache end (an idle slot that kept advancing) writes nothing, as the
    # JAX scatter drops out-of-bounds updates.
    rows = torch.arange(B, device=x.device)
    inb = (positions < S)[:, None, None]
    pos = positions.clamp(max=S - 1)
    k_cache[rows, pos] = torch.where(inb, k[:, 0].to(k_cache.dtype),
                                     k_cache[rows, pos])
    v_cache[rows, pos] = torch.where(inb, v[:, 0].to(v_cache.dtype),
                                     v_cache[rows, pos])

    G = H // KVH
    qg = q.reshape(B, KVH, G, Dh)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                          k_cache.float()) / (Dh ** 0.5)
    valid = torch.arange(S, device=x.device)[None, :] <= positions[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(k_cache.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v_cache)
    out = out.reshape(B, 1, H * Dh)
    x = x + out @ lp["wo"].to(x.dtype)
    return _ffn(cfg, lp, x)


# ---------------------------------------------------------------------------
# Prefill / decode steps
# ---------------------------------------------------------------------------

def _head_logits(cfg: TransformerConfig, params: Params, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ _lm_head(cfg, params)).float()


def _embed(cfg: TransformerConfig, params: Params, tokens) -> torch.Tensor:
    embed = params["embed"]
    return embed.to(cfg.dtype)[_as_long(tokens, embed.device)]


def _prefill_core(cfg: TransformerConfig, params: Params, cache: KVCache,
                  tokens, length: int, slot: int
                  ) -> Tuple[KVCache, torch.Tensor]:
    S = tokens.shape[1]
    x = _embed(cfg, params, tokens)                        # (1, S, D)
    sin, cos = rope_tables(cfg, S, x.device)
    for i in range(cfg.n_layers):
        x, k, v = _prefill_layer(cfg, layer_params(params, i), x, sin, cos)
        cache.k[i, slot, :S] = k[0].to(cache.k.dtype)
        cache.v[i, slot, :S] = v[0].to(cache.v.dtype)
    cache.seq_lens[slot] = int(length)
    logits = _head_logits(cfg, params, x)                  # (1, S, V)
    return cache, logits[0, int(length) - 1]


@torch.no_grad()
def prefill(cfg: TransformerConfig, params: Params, cache: KVCache,
            tokens, length: int, slot: int) -> Tuple[KVCache, torch.Tensor]:
    """Run one padded prompt (1, S_bucket) through the model, write its
    KV into `slot`, return the last real token's logits (V,)."""
    return _prefill_core(cfg, params, cache, tokens, length, slot)


@torch.no_grad()
def prefill_sample(cfg: TransformerConfig, params: Params, cache: KVCache,
                   tokens, length: int, slot: int, top_k: int,
                   temperature, generator: Optional[torch.Generator] = None
                   ) -> Tuple[KVCache, torch.Tensor]:
    """prefill + first-token sampling. Returns (cache, token ())."""
    cache, last = _prefill_core(cfg, params, cache, tokens, length, slot)
    temps = torch.as_tensor(temperature, dtype=torch.float32,
                            device=last.device).reshape(1)
    return cache, sample(last[None], generator, temperature=temps,
                         top_k=top_k)[0]


def token_logp(logits: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """log pi(tok): log_softmax of the RAW logits (no temperature, no
    top-k mask) at the sampled token. (..., V), (...,) -> (...,) f32."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(lp, -1, toks[..., None].long())[..., 0]


def _last_token_logits(cfg: TransformerConfig, params: Params, x, lens):
    """Head logits at the last REAL position of a final-normed batch
    (W, S, D) -> (W, V)."""
    idx = _as_long(lens, x.device) - 1
    last = x[torch.arange(x.shape[0], device=x.device), idx]   # (W, D)
    return (last @ _lm_head(cfg, params)).float()


def _prefill_batch_core(cfg: TransformerConfig, params: Params,
                        cache: KVCache, tokens, lengths, slots
                        ) -> Tuple[KVCache, torch.Tensor]:
    """Write each prompt's KV into its slot (padding rows dropped); return
    (cache, last-real-token logits (W, V))."""
    W, S = tokens.shape
    x = _embed(cfg, params, tokens)                        # (W, S, D)
    rows, kept = kept_rows(slots, cache.num_slots, x.device)
    sin, cos = rope_tables(cfg, S, x.device)
    for i in range(cfg.n_layers):
        x, k, v = _prefill_layer(cfg, layer_params(params, i), x, sin, cos)
        cache.k[i, kept, :S] = k[rows].to(cache.k.dtype)
        cache.v[i, kept, :S] = v[rows].to(cache.v.dtype)
    lengths = _as_long(lengths, x.device)
    cache.seq_lens[kept] = lengths[rows]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return cache, _last_token_logits(cfg, params, x, lengths)


@torch.no_grad()
def prefill_sample_batch(cfg: TransformerConfig, params: Params,
                         cache: KVCache, tokens, lengths, slots, top_k: int,
                         temps, generator: Optional[torch.Generator] = None
                         ) -> Tuple[KVCache, torch.Tensor]:
    """Prefill a batch of padded prompts (W, S_bucket) into their cache
    slots and sample each one's first token. Rows whose slot is out of
    range (the fixed-W tile's padding) are dropped from the cache; their
    sampled token is garbage the caller ignores."""
    cache, logits = _prefill_batch_core(cfg, params, cache, tokens,
                                        lengths, slots)
    return cache, sample(logits, generator, temperature=temps, top_k=top_k)


@torch.no_grad()
def prefill_sample_batch_lp(cfg: TransformerConfig, params: Params,
                            cache: KVCache, tokens, lengths, slots,
                            top_k: int, temps,
                            generator: Optional[torch.Generator] = None
                            ) -> Tuple[KVCache, torch.Tensor, torch.Tensor]:
    """prefill_sample_batch plus each sampled token's log-probability."""
    cache, logits = _prefill_batch_core(cfg, params, cache, tokens,
                                        lengths, slots)
    toks = sample(logits, generator, temperature=temps, top_k=top_k)
    return cache, toks, token_logp(logits, toks)


def _suffix_layer(cfg: TransformerConfig, q_offset: int, sin, cos, lp,
                  x, pk, pv):
    """Suffix-prefill layer: queries at global positions [Sp, Sp+Sq)
    attend to the shared prefix KV plus their own causal block."""
    W, Sq, _ = x.shape
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q, k_s, v_s = _qkv(cfg, lp, h, sin, cos)
    kk = torch.cat([pk[None].to(q.dtype).expand((W,) + tuple(pk.shape)),
                    k_s], dim=1)                      # (W, Sp+Sq, KVH, Dh)
    vv = torch.cat([pv[None].to(q.dtype).expand((W,) + tuple(pv.shape)),
                    v_s], dim=1)
    out = flash_attention(q, kk, vv, causal=True, q_offset=q_offset)
    x = x + out.reshape(W, Sq, -1) @ lp["wo"].to(x.dtype)
    return _ffn(cfg, lp, x), k_s, v_s


def _suffix_forward(cfg: TransformerConfig, params: Params, prefix_k,
                    prefix_v, tokens,
                    on_kv: Optional[Callable[[int, torch.Tensor,
                                              torch.Tensor], None]] = None):
    """Shared suffix forward (admission prefill AND queue-side first
    token): returns x final-normed (W, Sq, D); each layer's suffix k/v go
    to `on_kv(layer, k, v)` when given."""
    W, Sq = tokens.shape
    Sp = prefix_k.shape[1]
    x = _embed(cfg, params, tokens)
    sin_t, cos_t = rope_tables(cfg, Sp + Sq, x.device)
    sin, cos = sin_t[Sp:], cos_t[Sp:]
    for i in range(cfg.n_layers):
        x, k_s, v_s = _suffix_layer(cfg, Sp, sin, cos,
                                    layer_params(params, i), x,
                                    prefix_k[i], prefix_v[i])
        if on_kv is not None:
            on_kv(i, k_s, v_s)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def _prefill_suffix_core(cfg: TransformerConfig, params: Params,
                         cache: KVCache, prefix_k, prefix_v, tokens,
                         suffix_lens, slots
                         ) -> Tuple[KVCache, torch.Tensor]:
    W, Sq = tokens.shape
    Sp = prefix_k.shape[1]
    dev = cache.k.device
    rows, kept = kept_rows(slots, cache.num_slots, dev)
    # 1. Prefix KV into the slot rows (padding rows dropped).
    cache.k[:, kept, :Sp] = prefix_k[:, None].to(cache.k.dtype)
    cache.v[:, kept, :Sp] = prefix_v[:, None].to(cache.v.dtype)

    # 2. Suffix forward at offset positions; 3. its KV behind the prefix.
    def write(i, k_s, v_s):
        cache.k[i, kept, Sp:Sp + Sq] = k_s[rows].to(cache.k.dtype)
        cache.v[i, kept, Sp:Sp + Sq] = v_s[rows].to(cache.v.dtype)

    x = _suffix_forward(cfg, params, prefix_k, prefix_v, tokens, write)
    suffix_lens = _as_long(suffix_lens, dev)
    cache.seq_lens[kept] = Sp + suffix_lens[rows]
    # 4. Logits at the last REAL suffix position.
    return cache, _last_token_logits(cfg, params, x, suffix_lens)


@torch.no_grad()
def prefill_suffix_batch(cfg: TransformerConfig, params: Params,
                         cache: KVCache, prefix_k, prefix_v, tokens,
                         suffix_lens, slots, top_k: int, temps,
                         generator: Optional[torch.Generator] = None
                         ) -> Tuple[KVCache, torch.Tensor]:
    """Prefix-cached admission: copy a REGISTERED prefix's KV
    (prefix_k/v: (L, Sp, KVH, Dh)) into each request's slot, then prefill
    only the suffix tokens (W, Sq_bucket) at global positions
    [Sp, Sp+Sq), attending to the prefix through flash attention's
    q_offset. suffix_lens are the REAL suffix counts (>= 1). Returns
    (cache, first tokens (W,))."""
    cache, logits = _prefill_suffix_core(cfg, params, cache, prefix_k,
                                         prefix_v, tokens, suffix_lens,
                                         slots)
    return cache, sample(logits, generator, temperature=temps, top_k=top_k)


@torch.no_grad()
def prefill_suffix_batch_lp(cfg: TransformerConfig, params: Params,
                            cache: KVCache, prefix_k, prefix_v, tokens,
                            suffix_lens, slots, top_k: int, temps,
                            generator: Optional[torch.Generator] = None
                            ) -> Tuple[KVCache, torch.Tensor, torch.Tensor]:
    """prefill_suffix_batch plus each first token's log-probability."""
    cache, logits = _prefill_suffix_core(cfg, params, cache, prefix_k,
                                         prefix_v, tokens, suffix_lens,
                                         slots)
    toks = sample(logits, generator, temperature=temps, top_k=top_k)
    return cache, toks, token_logp(logits, toks)


@torch.no_grad()
def first_token_suffix_sample(cfg: TransformerConfig, params: Params,
                              prefix_k, prefix_v, tokens, suffix_lens,
                              temps, top_k: int,
                              generator: Optional[torch.Generator] = None
                              ) -> torch.Tensor:
    """Cache-free first token for prompts sharing a REGISTERED prefix:
    only the suffix forward, against the stored prefix KV."""
    x = _suffix_forward(cfg, params, prefix_k, prefix_v, tokens)
    logits = _last_token_logits(cfg, params, x, suffix_lens)
    return sample(logits, generator, temperature=temps, top_k=top_k)


@torch.no_grad()
def first_token_suffix_sample_lp(cfg: TransformerConfig, params: Params,
                                 prefix_k, prefix_v, tokens, suffix_lens,
                                 temps, top_k: int,
                                 generator: Optional[torch.Generator] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """first_token_suffix_sample plus per-token log-probability."""
    x = _suffix_forward(cfg, params, prefix_k, prefix_v, tokens)
    logits = _last_token_logits(cfg, params, x, suffix_lens)
    toks = sample(logits, generator, temperature=temps, top_k=top_k)
    return toks, token_logp(logits, toks)


@torch.no_grad()
def compute_prefix_kv(cfg: TransformerConfig, params: Params,
                      prefix: Sequence[int]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KV of a prompt prefix, computed ONCE (registration-time half of
    prefix caching): (L, Sp, KVH, Dh) k/v in the cache dtype."""
    Sp = len(prefix)
    dev = params["embed"].device
    scratch = init_kv_cache(cfg, 1, Sp, device=dev)
    tokens = torch.tensor([list(prefix)], dtype=torch.long, device=dev)
    scratch, _ = prefill(cfg, params, scratch, tokens, Sp, 0)
    return scratch.k[:, 0], scratch.v[:, 0]


def _first_token_logits(cfg: TransformerConfig, params: Params, tokens,
                        lengths):
    # forward_hidden's output is ALREADY final-normed: apply the head
    # directly (going through _head_logits would norm twice).
    x, _aux = forward_hidden(cfg, params, _as_long(tokens,
                                                   params["embed"].device))
    return _last_token_logits(cfg, params, x, lengths)


@torch.no_grad()
def first_token_sample(cfg: TransformerConfig, params: Params, tokens,
                       lengths, temps, top_k: int,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """First token for a BATCH of prompts without touching any KV cache
    (tokens (W, S_bucket), lengths (W,), temps (W,) -> (W,) tokens): the
    engine gives QUEUED requests their first token while every slot is
    busy."""
    logits = _first_token_logits(cfg, params, tokens, lengths)
    return sample(logits, generator, temperature=temps, top_k=top_k)


@torch.no_grad()
def first_token_sample_lp(cfg: TransformerConfig, params: Params, tokens,
                          lengths, temps, top_k: int,
                          generator: Optional[torch.Generator] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """first_token_sample plus per-token log-probability."""
    logits = _first_token_logits(cfg, params, tokens, lengths)
    toks = sample(logits, generator, temperature=temps, top_k=top_k)
    return toks, token_logp(logits, toks)


def _decode_core(cfg: TransformerConfig, params: Params, cache: KVCache,
                 tokens) -> Tuple[KVCache, torch.Tensor]:
    positions = cache.seq_lens.clone()                      # (B,)
    x = _embed(cfg, params, tokens)[:, None, :]             # (B, 1, D)
    sin_t, cos_t = rope_tables(cfg, cache.max_seq_len, x.device)
    pos = positions.clamp(max=cache.max_seq_len - 1)        # gather clamps
    sin, cos = sin_t[pos][:, None, :], cos_t[pos][:, None, :]
    for i in range(cfg.n_layers):
        x = _decode_layer(cfg, layer_params(params, i), x, sin, cos,
                          positions, cache.k[i], cache.v[i])
    logits = _head_logits(cfg, params, x)[:, 0]             # (B, V)
    cache.seq_lens.add_(1)
    return cache, logits


@torch.no_grad()
def decode_step(cfg: TransformerConfig, params: Params, cache: KVCache,
                tokens) -> Tuple[KVCache, torch.Tensor]:
    """One decode step for every slot. tokens: (B,) last emitted token per
    slot. Returns (cache, logits (B, V)); every slot's seq_len advances by
    1 (the engine ignores idle slots' output)."""
    return _decode_core(cfg, params, cache, tokens)


@torch.no_grad()
def decode_multi(cfg: TransformerConfig, params: Params, cache: KVCache,
                 tokens, temps, num_steps: int, top_k: int,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[KVCache, torch.Tensor]:
    """`num_steps` decode+sample ticks. Returns (cache, toks
    (num_steps, B))."""
    out = []
    tok = tokens
    for _ in range(num_steps):
        cache, logits = _decode_core(cfg, params, cache, tok)
        tok = sample(logits, generator, temperature=temps, top_k=top_k)
        out.append(tok)
    return cache, torch.stack(out)


@torch.no_grad()
def decode_multi_lp(cfg: TransformerConfig, params: Params, cache: KVCache,
                    tokens, temps, num_steps: int, top_k: int,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[KVCache, torch.Tensor, torch.Tensor]:
    """decode_multi plus each sampled token's log-probability
    (num_steps, B)."""
    toks, lps = [], []
    tok = tokens
    for _ in range(num_steps):
        cache, logits = _decode_core(cfg, params, cache, tok)
        tok = sample(logits, generator, temperature=temps, top_k=top_k)
        toks.append(tok)
        lps.append(token_logp(logits, tok))
    return cache, torch.stack(toks), torch.stack(lps)


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
           *, temperature=0.0, top_k: int = 0) -> torch.Tensor:
    """Greedy (temperature <= 0) or temperature/top-k sampling,
    (..., V) -> (...,) int64. `temperature` is a scalar or per-row.
    Top-k keeps every logit >= the k-th largest, so ties at the threshold
    survive. Sampling is Gumbel-max with noise from `generator`."""
    temps = torch.as_tensor(temperature, dtype=torch.float32,
                            device=logits.device)
    temps = torch.broadcast_to(temps, logits.shape[:-1])
    greedy = torch.argmax(logits, dim=-1)
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    scaled = logits / torch.clamp(temps, min=1e-6)[..., None]
    u = torch.rand(scaled.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp(min=tiny, max=1.0 - 1e-7)))
    sampled = torch.argmax(scaled + gumbel, dim=-1)
    return torch.where(temps <= 0.0, greedy, sampled)


@torch.no_grad()
def greedy_generate(cfg: TransformerConfig, params: Params, prompt,
                    max_new_tokens: int, *, device: DeviceLike = "cuda"
                    ) -> torch.Tensor:
    """Reference single-sequence generation: prefill then greedy decode on
    `device` (weights are moved there if they are elsewhere).
    prompt: (S,) ints -> (max_new_tokens,) int64 on the CPU."""
    dev = resolve_device(device)
    params = params_to(params, dev)
    prompt = _host_list(prompt)
    S = len(prompt)
    bucket = max(8, 1 << (S - 1).bit_length())
    cache = init_kv_cache(cfg, num_slots=1,
                          max_seq_len=bucket + max_new_tokens, device=dev)
    padded = torch.zeros((1, bucket), dtype=torch.long, device=dev)
    padded[0, :S] = torch.tensor(prompt, dtype=torch.long, device=dev)
    cache, logits = prefill(cfg, params, cache, padded, S, 0)
    tok = torch.argmax(logits)[None]
    out = []
    for _ in range(max_new_tokens):
        out.append(tok)
        cache, logits = decode_step(cfg, params, cache, tok)
        tok = torch.argmax(logits, dim=-1)
    return torch.cat(out).cpu()
