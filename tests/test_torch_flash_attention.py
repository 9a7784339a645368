"""The port's flash-attention forward (ray_tpu_torch.ops) against the JAX
package's, which on the CPU runs the Pallas kernel in interpret mode.

On the CPU the port's wrapper runs the kernel's plain version; the CUDA
kernel itself is held against that plain version on the card by
chip_smoke.py. Tolerance 2e-5 at f32, the tests/test_ops.py bound."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.flash_attention import _expand_kv, _fwd_impl
from ray_tpu.ops.flash_attention import flash_attention as jax_flash
from ray_tpu_torch.ops.flash_attention import (
    _fwd_cuda,
    flash_attention,
    flash_attention_fwd,
    flash_attention_plain,
    fwd_launches,
)

ATOL = RTOL = 2e-5


def qkv(seed, B=2, Sq=128, Skv=None, H=4, KVH=None, D=64):
    rng = np.random.RandomState(seed)
    Skv = Skv or Sq
    KVH = KVH or H
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Skv, KVH, D)).astype(np.float32),
            rng.standard_normal((B, Skv, KVH, D)).astype(np.float32))


def both(q, k, v, **kw):
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), **kw))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), **kw).numpy()
    return got, want


@pytest.mark.parametrize("case", [
    dict(causal=True),
    dict(causal=False),
    dict(causal=True, H=4, KVH=2),                       # GQA 4/2
    dict(causal=True, Sq=64, Skv=192, q_offset=128),     # suffix prefill
    dict(causal=True, Sq=100, D=60),                     # ragged S, odd D
    dict(causal=True, B=1, Sq=128, H=2, kv_offset=64),   # rows that see
                                                         # no key give 0
], ids=["causal", "noncausal", "gqa", "suffix", "ragged", "masked_rows"])
def test_matches_jax(case):
    case = dict(case)
    shape = {k: case.pop(k) for k in ("B", "Sq", "Skv", "H", "KVH", "D")
             if k in case}
    got, want = both(*qkv(len(shape) + 7, **shape), **case)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_decode_offset_matches_jax():
    """One query at global position 255 over a 256-token kv."""
    q, k, v = qkv(4, B=1, Sq=256, H=2)
    got, want = both(q[:, 255:256], k, v, causal=True, q_offset=255)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("causal,q_offset,Sq,Skv", [
    (True, 0, 128, 128), (False, 0, 128, 128), (True, 128, 64, 192)])
def test_lse_matches_jax_kernel(causal, q_offset, Sq, Skv):
    """lse against the Pallas forward kernel itself (interpret mode)."""
    q, k, v = qkv(11, B=2, Sq=Sq, Skv=Skv, H=4, KVH=2)
    D = q.shape[-1]
    qt = jnp.swapaxes(jnp.asarray(q), 1, 2)
    kt = _expand_kv(jnp.swapaxes(jnp.asarray(k), 1, 2), 4)
    vt = _expand_kv(jnp.swapaxes(jnp.asarray(v), 1, 2), 4)
    offs = jnp.asarray([[q_offset, 0]], jnp.float32)
    out_j, lse_j = _fwd_impl(qt, kt, vt, offs, sm_scale=1 / math.sqrt(D),
                             block_q=64, block_k=64, causal=causal,
                             interpret=True)
    out, lse = flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal,
                                   q_offset=q_offset)
    assert lse.shape == (2, 4, Sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jnp.swapaxes(out_j, 1, 2)),
                               atol=ATOL, rtol=RTOL)


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    q, k, v = (torch.from_numpy(x) for x in qkv(3, B=1, Sq=32, H=2))
    before = fwd_launches.count
    out, lse = flash_attention_fwd(q, k, v)
    ref, ref_lse = flash_attention_plain(q, k, v)
    assert fwd_launches.count == before
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)


def test_bf16_plain_keeps_dtype():
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in qkv(5, B=1, Sq=48, H=4, KVH=2))
    out, lse = flash_attention_fwd(q, k, v)
    ref, _ = flash_attention_plain(q.float(), k.float(), v.float())
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    # Rounding P and O to bf16 moves O by at most 2 * 2^-8 * max|v|.
    assert (out.float() - ref).abs().max() <= 2 ** -7 * v.abs().max()


def test_other_devices_raise():
    q = torch.empty((1, 8, 2, 64), device="meta")
    with pytest.raises(RuntimeError, match="no flash-attention kernel"):
        flash_attention_fwd(q, q, q)


@pytest.mark.parametrize("D,dtype,err", [
    (60, torch.float32, ValueError),     # head dim the kernel lacks
    (96, torch.bfloat16, ValueError),
    (64, torch.float16, TypeError),      # dtype the kernel lacks
])
def test_kernel_wrapper_refuses_what_it_cannot_run(D, dtype, err):
    """The CUDA wrapper raises for shapes and dtypes the kernel does not
    take (it never routes them to the plain version). Its checks run
    before the kernel is built, so they are testable without a card."""
    q = torch.zeros((1, 16, 4, D), dtype=dtype)
    k = torch.zeros((1, 16, 2, D), dtype=dtype)
    with pytest.raises(err):
        _fwd_cuda(q, k, k, True, 1.0, 0, 0)


def test_kernel_wrapper_refuses_bad_gqa():
    q = torch.zeros((1, 16, 4, 64))
    k = torch.zeros((1, 16, 3, 64))
    with pytest.raises(ValueError, match="bad shapes"):
        _fwd_cuda(q, k, k, True, 1.0, 0, 0)
