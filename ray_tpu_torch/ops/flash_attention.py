"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Public layout is the JAX package's: q (B, Sq, H, D), k/v (B, Skv, KVH, D)
with H % KVH == 0 (GQA), output (B, Sq, H, D). Offsets are the global
token positions of element 0 of the q / kv sequences; the causal mask is
(q_offset + i) >= (kv_offset + j).

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/flash_attn_fwd.cu`` (built with nvcc at first use) or raises; it
never drops to the plain version. On a CPU tensor it runs the plain
version, ``flash_attention_plain``, which mirrors the JAX package's
``_reference`` (scores in f32, NEG_INF masking) and, like the TPU kernel,
gives 0 for a query row that sees no key.
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


_kernel_fn = None


def _kernel():
    """The C entry point, built and loaded at first use."""
    global _kernel_fn
    if _kernel_fn is None:
        fn = _build.load(SOURCE).flash_attn_fwd
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([vp] * 5 + [i] * 7 + [ll] * 12
                       + [ctypes.c_float, i, i, i, vp])
        fn.restype = ctypes.c_int
        _kernel_fn = fn
    return _kernel_fn


def _fwd_cuda(q, k, v, causal, sm_scale, q_offset, kv_offset):
    B, Sq, H, D = q.shape
    _, Skv, KVH, _ = k.shape
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"flash_attn_fwd takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attn_fwd supports head dims {HEAD_DIMS}, "
                         f"got {D}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D or \
            H % KVH:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)}"
                         f" v {tuple(v.shape)}")
    if not (k.device == q.device == v.device):
        raise ValueError("q, k and v must be on one device")
    q, k, v = (x if _aligned(x) else x.contiguous() for x in (q, k, v))
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), _DTYPE_CODE[q.dtype], B, H, KVH, Sq, Skv, D,
                 q.stride(0), q.stride(1), q.stride(2),
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2),
                 out.stride(0), out.stride(1), out.stride(2),
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


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: Optional[float] = None,
                    q_offset: int = 0, kv_offset: int = 0) -> torch.Tensor:
    """Fused multi-head attention forward. Returns (B, Sq, H, D)."""
    return flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                               q_offset=q_offset, kv_offset=kv_offset)[0]

