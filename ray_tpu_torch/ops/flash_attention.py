"""Flash attention: the CUDA kernels' wrappers and their plain versions.

Public layout is the JAX package's: q (B, Sq, H, D), k/v (B, Skv, KVH, D)
with H % KVH == 0 (GQA), output (B, Sq, H, D). Offsets are the global
token positions of element 0 of the q / kv sequences; the causal mask is
(q_offset + i) >= (kv_offset + j).

``flash_attention`` is differentiable (a ``torch.autograd.Function``, the
counterpart of the JAX package's ``jax.custom_vjp``): its forward saves
(q, k, v, out, lse) and the offsets, and its backward is
``flash_attention_bwd``, which takes the lse from outside so that ring
attention can later feed it a global one.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/flash_attn_fwd.cu``; ``csrc/flash_attn_bwd.cu`` for dq and
dk/dv, built with nvcc at first use) or raises; it never drops to the
plain version. On a CPU tensor it runs the plain version:
``flash_attention_plain`` mirrors the JAX package's ``_reference``
(scores in f32, NEG_INF masking) and, like the TPU kernel, gives 0 for a
query row that sees no key; ``flash_attention_bwd_plain`` follows the
backward kernels' formula step by step.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e30
SOURCE = "flash_attn_fwd.cu"
BWD_SOURCE = "flash_attn_bwd.cu"
HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class LaunchCounter:
    """Kernel launches counted by the wrapper, at the launch and nowhere
    else (thread-safe: the serving engine launches from its own thread)."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self.count += 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0


fwd_launches = LaunchCounter("flash_attn_fwd")
dq_launches = LaunchCounter("flash_attn_bwd_dq")
dkv_launches = LaunchCounter("flash_attn_bwd_dkv")


def _expand_kv(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, KVH, S, D) -> (B, H, S, D); head h reads kv head h // (H/KVH)."""
    kvh = x.shape[1]
    if kvh == n_heads:
        return x
    return x.repeat_interleave(n_heads // kvh, dim=1)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          sm_scale: Optional[float] = None,
                          q_offset: int = 0, kv_offset: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch attention forward. Returns (out (B, Sq, H, D) in q's
    dtype, lse (B, H, Sq) f32)."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    qt = q.transpose(1, 2).float()
    kt = _expand_kv(k.transpose(1, 2), H).float()
    vt = _expand_kv(v.transpose(1, 2), H)
    s = torch.matmul(qt, kt.transpose(-1, -2)) * sm_scale   # (B,H,Sq,Skv)
    seen = None
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
        k_pos = kv_offset + torch.arange(Skv, device=q.device)[None, :]
        mask = q_pos >= k_pos
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        seen = mask.any(dim=-1)                              # (Sq,)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.matmul(p.to(v.dtype), vt)                    # (B,H,Sq,D)
    if seen is not None:
        out = out * seen[:, None].to(out.dtype)
    return out.transpose(1, 2).to(q.dtype), lse


def _aligned(x: torch.Tensor) -> bool:
    elems = 16 // x.element_size()
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(st % elems == 0 for st in x.stride()[:-1]))


def _kernel_layout(x: torch.Tensor) -> torch.Tensor:
    """`x` itself when the kernels can read it in place, else a copy in a
    fresh (aligned) allocation: `contiguous()` would hand back a
    contiguous tensor whose base is misaligned unchanged."""
    return x if _aligned(x) else x.clone(memory_format=torch.contiguous_format)


_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signatures: pointers, ints (dtype code and sizes), strides, then
# (scale, q_offset, kv_offset, causal, stream).
_TAIL = [ctypes.c_float, _I, _I, _I, _VP]
_ARGTYPES = {
    "flash_attn_fwd": [_VP] * 5 + [_I] * 7 + [_LL] * 12 + _TAIL,
    "flash_attn_bwd_dq": [_VP] * 9 + [_I] * 7 + [_LL] * 21 + _TAIL,
    "flash_attn_bwd_dkv": [_VP] * 9 + [_I] * 7 + [_LL] * 21 + _TAIL,
}
_entries = {}


def _entry(source: str, name: str):
    """The C entry point `name` of `source`, built and loaded at first
    use."""
    if name not in _entries:
        fn = getattr(_build.load(source), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return _entries[name]


def _check(name: str, q, k, v, *more) -> None:
    """Raise for what the kernels do not take (before any build)."""
    B, Sq, H, D = q.shape
    KVH = k.shape[2]
    if q.dtype not in _DTYPE_CODE or any(
            x.dtype != q.dtype for x in (k, v) + more):
        raise TypeError(f"{name} takes float32 or bfloat16 q/k/v of one "
                        f"dtype, got {[x.dtype for x in (q, k, v) + more]}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name} supports head dims {HEAD_DIMS}, got {D}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D or \
            H % KVH or any(x.shape != q.shape for x in more):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)}"
                         f" v {tuple(v.shape)}")
    if any(x.device != q.device for x in (k, v) + more):
        raise ValueError(f"{name}: all tensors must be on one device")


def _strides(*xs) -> list:
    return [st for x in xs for st in x.stride()[:3]]


def _fwd_cuda(q, k, v, causal, sm_scale, q_offset, kv_offset):
    _check("flash_attn_fwd", q, k, v)
    B, Sq, H, D = q.shape
    _, Skv, KVH, _ = k.shape
    q, k, v = (_kernel_layout(x) for x in (q, k, v))
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    fn = _entry(SOURCE, "flash_attn_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), _DTYPE_CODE[q.dtype], B, H, KVH, Sq, Skv, D,
                 *_strides(q, k, v, out),
                 float(sm_scale), int(q_offset), int(kv_offset),
                 int(bool(causal)), stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: error {err}")
    fwd_launches.add()
    return out, lse


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        sm_scale: Optional[float] = None,
                        q_offset: int = 0, kv_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (out (B, Sq, H, D), lse (B, H, Sq) f32). CUDA tensors launch the
    kernel; CPU tensors take the plain version."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        return _fwd_cuda(q, k, v, causal, sm_scale, q_offset, kv_offset)
    if q.device.type != "cpu":
        raise RuntimeError(f"no flash-attention kernel for {q.device}")
    return flash_attention_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                                 q_offset=q_offset, kv_offset=kv_offset)


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------

def _delta(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Delta = rowsum(dO * O) in f32, (B, H, Sq); as `_bwd_impl` does,
    outside the kernels."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2)


def flash_attention_bwd_plain(q, k, v, do, out, lse, *, causal: bool = True,
                              sm_scale: Optional[float] = None,
                              q_offset: int = 0, kv_offset: int = 0
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain PyTorch attention backward, the kernels' formula written out:
    P = exp(Q K^T * scale - lse) recomputed from the given lse and
    where-masked, dP = dO V^T, dS = P * (dP - Delta) * scale with
    Delta = rowsum(dO * O); dQ = dS K, dV = P^T dO, dK = dS^T Q, with P
    cast to dO's dtype and dS to the input dtype before those products
    (as the Pallas kernels cast), and dK / dV summed over each GQA group.
    Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    qt = q.transpose(1, 2).float()                           # (B,H,Sq,D)
    kt = _expand_kv(k.transpose(1, 2), H).float()            # (B,H,Skv,D)
    vt = _expand_kv(v.transpose(1, 2), H).float()
    dot = do.transpose(1, 2).float()
    x = torch.matmul(qt, kt.transpose(-1, -2)) * sm_scale - lse[..., None]
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
        k_pos = kv_offset + torch.arange(Skv, device=q.device)[None, :]
        p = torch.where(q_pos >= k_pos, torch.exp(x), torch.zeros_like(x))
    else:
        p = torch.exp(x)
    dp = torch.matmul(dot, vt.transpose(-1, -2))
    ds = p * (dp - _delta(do, out)[..., None]) * sm_scale
    dq = torch.matmul(ds.to(k.dtype).float(), kt)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dot)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), qt)

    def group_sum(x):                                        # -> (B,Skv,KVH,D)
        return x.reshape(B, KVH, H // KVH, Skv, D).sum(2).transpose(1, 2)

    return (dq.transpose(1, 2).to(q.dtype), group_sum(dk).to(k.dtype),
            group_sum(dv).to(v.dtype))


def _bwd_prepare(q, k, v, do, out, lse, causal, sm_scale, q_offset,
                 kv_offset):
    """Check the inputs, compute Delta and allocate dq / dk / dv: ->
    (the C arguments but the stream, (dq, dk, dv), the tensors the
    pointers point into, which must outlive the launches)."""
    _check("flash_attn_bwd", q, k, v, do, out)
    B, Sq, H, D = q.shape
    _, Skv, KVH, _ = k.shape
    if lse.dtype != torch.float32 or lse.shape != (B, H, Sq):
        raise ValueError(f"lse must be float32 (B, H, Sq) = {(B, H, Sq)}, "
                         f"got {lse.dtype} {tuple(lse.shape)}")
    q, k, v, do = (_kernel_layout(x) for x in (q, k, v, do))
    lse = lse.contiguous()
    delta = _delta(do, out).contiguous()
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Skv, KVH, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, Skv, KVH, D), dtype=v.dtype, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), _DTYPE_CODE[q.dtype], B, H, KVH, Sq, Skv, D,
            *_strides(q, k, v, do, dq, dk, dv), float(sm_scale),
            int(q_offset), int(kv_offset), int(bool(causal)))
    return args, (dq, dk, dv), (q, k, v, do, lse, delta)


def _bwd_launch(name: str, args, device: torch.device) -> None:
    """Launch the backward kernel `name` ("flash_attn_bwd_dq" or
    "flash_attn_bwd_dkv") on `device`'s current stream with the C
    arguments of _bwd_prepare; raise if the launch fails."""
    fn = _entry(BWD_SOURCE, name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: error {err}")


def _bwd_cuda(q, k, v, do, out, lse, causal, sm_scale, q_offset,
              kv_offset):
    args, grads, _keep = _bwd_prepare(q, k, v, do, out, lse, causal,
                                      sm_scale, q_offset, kv_offset)
    for name, counter in (("flash_attn_bwd_dq", dq_launches),
                          ("flash_attn_bwd_dkv", dkv_launches)):
        _bwd_launch(name, args, q.device)
        counter.add()
    return grads


def flash_attention_bwd(q, k, v, do, out, lse, *, causal: bool = True,
                        sm_scale: Optional[float] = None,
                        q_offset: int = 0, kv_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of attention, from the forward's out and its lse
    (B, H, Sq) f32, which may come from outside (a global lse). CUDA
    tensors launch the dq and dk/dv kernels; CPU tensors take the plain
    version."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        return _bwd_cuda(q, k, v, do, out, lse, causal, sm_scale, q_offset,
                         kv_offset)
    if q.device.type != "cpu":
        raise RuntimeError(f"no flash-attention kernel for {q.device}")
    return flash_attention_bwd_plain(q, k, v, do, out, lse, causal=causal,
                                     sm_scale=sm_scale, q_offset=q_offset,
                                     kv_offset=kv_offset)


class _FlashAttention(torch.autograd.Function):
    """Forward through flash_attention_fwd, backward through
    flash_attention_bwd; residuals (q, k, v, out, lse) and the offsets,
    as the JAX package's `_flash_fwd` keeps."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, q_offset, kv_offset):
        out, lse = flash_attention_fwd(q, k, v, causal=causal,
                                       sm_scale=sm_scale, q_offset=q_offset,
                                       kv_offset=kv_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(causal=causal, sm_scale=sm_scale, q_offset=q_offset,
                        kv_offset=kv_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, do, out, lse, **ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: Optional[float] = None,
                    q_offset: int = 0, kv_offset: int = 0) -> torch.Tensor:
    """Fused multi-head attention, differentiable. Returns (B, Sq, H, D)."""
    return _FlashAttention.apply(q, k, v, causal, sm_scale, q_offset,
                                 kv_offset)
