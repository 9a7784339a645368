"""The port's flash-attention backward (ray_tpu_torch.ops) against the JAX
package's, whose custom VJP on the CPU runs the Pallas `_dq_kernel` and
`_dkv_kernel` in interpret mode.

On the CPU the port's autograd.Function runs the kernels' plain version,
flash_attention_bwd_plain; the CUDA kernels are held against that plain
version on the card by chip_smoke.py. Tolerance 5e-4 at f32, the
tests/test_ops.py grad bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.flash_attention import flash_attention as jax_flash
from ray_tpu_torch.ops.flash_attention import (
    _bwd_cuda,
    dkv_launches,
    dq_launches,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_plain,
)

GRAD_TOL = 5e-4

CASES = {
    "causal": dict(causal=True),
    "noncausal": dict(causal=False),
    "gqa": dict(causal=True, H=4, KVH=2),                    # GQA 4/2
    "suffix": dict(causal=True, Sq=64, Skv=192, q_offset=128),
    # Rows 0..63 see no key: their output is 0 and their grads are 0.
    "masked_rows": dict(causal=True, B=1, H=2, kv_offset=64),
    # Several blocks on the JAX side, so its kv loop, q loop and block
    # skip all run.
    "multiblock": dict(causal=True, Sq=128, H=4, KVH=2,
                       jax=dict(block_q=32, block_k=64)),
}


def inputs(seed, B=2, Sq=128, Skv=None, H=4, KVH=None, D=64):
    rng = np.random.RandomState(seed)
    Skv = Skv or Sq
    KVH = KVH or H
    shapes = [(B, Sq, H, D), (B, Skv, KVH, D), (B, Skv, KVH, D),
              (B, Sq, H, D)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def split(case):
    case = dict(case)
    shape = {k: case.pop(k) for k in ("B", "Sq", "Skv", "H", "KVH", "D")
             if k in case}
    jax_kw = case.pop("jax", {})
    return shape, case, jax_kw


def port_grads(q, k, v, g, **kw):
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(q, k, v, **kw)
    return [x.numpy() for x in torch.autograd.grad(out, (q, k, v),
                                                   torch.from_numpy(g))]


@pytest.fixture(scope="module")
def jax_grads():
    """One JAX VJP (interpret-mode Pallas backward kernels) per case."""
    out = {}
    for i, (name, case) in enumerate(CASES.items()):
        shape, kw, jax_kw = split(case)
        q, k, v, g = inputs(20 + i, **shape)

        def f(q, k, v):
            return jax_flash(q, k, v, interpret=True, **kw, **jax_kw)

        _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        out[name] = ((q, k, v, g), [np.asarray(x)
                                    for x in vjp(jnp.asarray(g))])
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_grads_match_jax_kernels(name, jax_grads):
    (q, k, v, g), want = jax_grads[name]
    _, kw, _ = split(CASES[name])
    got = port_grads(q, k, v, g, **kw)
    for label, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=label)
    if name == "masked_rows":
        assert not got[0][:, :64].any()


@pytest.mark.parametrize("name", ["causal", "noncausal", "gqa", "suffix",
                                  "masked_rows"])
def test_plain_backward_matches_autograd_of_plain_forward(name):
    """flash_attention_bwd_plain (the kernels' formula, from the saved
    lse) against torch autograd through flash_attention_plain; the same
    f32 arithmetic in another order, so 1e-5."""
    shape, kw, _ = split(CASES[name])
    q, k, v, g = (torch.from_numpy(x) for x in inputs(40, **shape))
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    out, lse = flash_attention_plain(qr, kr, vr, **kw)
    want = torch.autograd.grad(out, (qr, kr, vr), g)
    got = flash_attention_bwd_plain(q, k, v, g, out.detach(), lse.detach(),
                                    **kw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_cpu_backward_takes_plain_version_and_counts_no_launch():
    q, k, v, g = (torch.from_numpy(x) for x in inputs(3, B=1, Sq=32, H=2))
    out, lse = flash_attention_plain(q, k, v)
    before = (dq_launches.count, dkv_launches.count)
    got = flash_attention_bwd(q, k, v, g, out, lse)
    want = flash_attention_bwd_plain(q, k, v, g, out, lse)
    assert (dq_launches.count, dkv_launches.count) == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_bf16_plain_backward_keeps_dtypes():
    q, k, v, g = (torch.from_numpy(x).bfloat16()
                  for x in inputs(5, B=1, Sq=48, H=4, KVH=2))
    out, lse = flash_attention_plain(q, k, v)
    dq, dk, dv = flash_attention_bwd(q, k, v, g, out, lse)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    ref = flash_attention_bwd_plain(*(x.float() for x in (q, k, v, g, out)),
                                    lse)
    for a, b in zip((dq, dk, dv), ref):
        # P and dS rounded to bf16 before the products, and the result
        # rounded to bf16: a few bf16 units of the largest grad.
        assert (a.float() - b).abs().max() <= 2 ** -5 * b.abs().max()


def test_other_devices_raise():
    q = torch.empty((1, 8, 2, 64), device="meta")
    lse = torch.empty((1, 2, 8), device="meta")
    with pytest.raises(RuntimeError, match="no flash-attention kernel"):
        flash_attention_bwd(q, q, q, q, q, lse)


@pytest.mark.parametrize("D,dtype,lse_shape,err", [
    (60, torch.float32, None, ValueError),      # head dim the kernels lack
    (64, torch.float16, None, TypeError),       # dtype the kernels lack
    (64, torch.bfloat16, (1, 4, 15), ValueError),   # lse of another shape
])
def test_backward_wrapper_refuses_what_it_cannot_run(D, dtype, lse_shape,
                                                     err):
    """The CUDA wrapper raises for what the kernels do not take, never
    routing it to the plain version. Its checks run before the kernels
    are built, so they are testable without a card."""
    q = torch.zeros((1, 16, 4, D), dtype=dtype)
    k = torch.zeros((1, 16, 2, D), dtype=dtype)
    lse = torch.zeros(lse_shape or (1, 4, 16))
    with pytest.raises(err):
        _bwd_cuda(q, k, k, q, q, lse, True, 1.0, 0, 0)
