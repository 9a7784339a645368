"""The port's flash-attention backward (ray_tpu_torch.ops) against the JAX
package's, whose custom VJP on the CPU runs the Pallas `_dq_kernel` and
`_dkv_kernel` in interpret mode.

On the CPU the port's autograd.Function runs the kernels' plain version,
flash_attention_bwd_plain; the CUDA kernels are held against that plain
version on the card by chip_smoke.py. Tolerance 5e-4 at f32, the
tests/test_ops.py grad bound."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.flash_attention import flash_attention as jax_flash
from ray_tpu_torch.ops.flash_attention import (
    _ARGTYPES,
    _aligned,
    _bwd_cuda,
    _bwd_prepare,
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


@pytest.mark.parametrize("call", ["direct", "autograd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_backward_takes_plain_version_and_counts_no_launch(dtype, call):
    """On CPU tensors the backward, called directly or through autograd,
    is exactly the plain version, and no kernel launch is counted."""
    q, k, v, g = (torch.from_numpy(x).to(dtype)
                  for x in inputs(3, B=1, Sq=32, H=4, KVH=2))
    out, lse = flash_attention_plain(q, k, v)
    before = (dq_launches.count, dkv_launches.count)
    if call == "autograd":
        qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
        got = torch.autograd.grad(flash_attention(qr, kr, vr), (qr, kr, vr),
                                  g)
    else:
        got = flash_attention_bwd(q, k, v, g, out, lse)
    assert (dq_launches.count, dkv_launches.count) == before
    want = flash_attention_bwd_plain(q, k, v, g, out, lse)
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


def _bwd_inputs_bf16(B=1, Sq=16, H=4, KVH=2, D=64):
    q, k, v, g = (torch.from_numpy(x).bfloat16()
                  for x in inputs(7, B=B, Sq=Sq, H=H, KVH=KVH, D=D))
    out, lse = flash_attention_plain(q, k, v)
    return q, k, v, g, out, lse


def _out_view(out, view):
    """`out` as the view `view`: itself, a copy one element off a 16-byte
    boundary (which the kernels cannot read in place), or a head slice of
    a wider (B, S, 2H, D) tensor (which they can)."""
    if view == "base_one_element_off":
        flat = torch.zeros(out.numel() + 1, dtype=out.dtype)
        x = flat[1:].view(out.shape)
    elif view == "head_slice":
        B, S, H, D = out.shape
        x = torch.zeros(B, S, 2 * H, D, dtype=out.dtype)[:, :, H:]
    else:
        return out
    x.copy_(out)
    return x


@pytest.mark.parametrize("view", ["contiguous", "base_one_element_off",
                                  "head_slice"])
def test_bwd_prepare_hands_the_kernels_out_and_an_f32_delta_buffer(view):
    """The dq kernel reads O (for Delta) through the C arguments: `out`
    goes through _kernel_layout like q, k, v and dO, and its pointer and
    strides sit in the argument list where the C signature takes them.
    Delta is a fresh (B, H, Sq) f32 buffer for the dq kernel to fill. No
    kernel runs: _bwd_prepare only checks, lays out and allocates."""
    q, k, v, g, out, lse = _bwd_inputs_bf16()
    out_arg = _out_view(out, view)
    args, grads, keep = _bwd_prepare(q, k, v, g, out_arg, lse, True, 0.125,
                                     0, 0)
    assert len(args) + 1 == len(_ARGTYPES["flash_attn_bwd_dq"])
    assert len(args) + 1 == len(_ARGTYPES["flash_attn_bwd_dkv"])
    out_k, delta = keep[4], keep[6]
    assert _aligned(out_k) and torch.equal(out_k, out_arg)
    assert (out_k is out_arg) == (view != "base_one_element_off")
    # Pointers: q, k, v, dO, O, lse, Delta, dq, dk, dv; then the dtype
    # code and 6 sizes; then 3 strides each of q, k, v, dO, O, ...
    assert args[4] == out_k.data_ptr()
    assert list(args[29:32]) == list(out_k.stride()[:3])
    assert args[6] == delta.data_ptr()
    assert delta.shape == (1, 4, 16) and delta.dtype == torch.float32
    assert delta.is_contiguous()
    assert [x.shape for x in grads] == [q.shape, k.shape, v.shape]


def test_kernel_path_runs_no_torch_delta_pass(monkeypatch):
    """Delta is the dq kernel's prologue on the card: preparing the
    kernels' arguments computes none in torch."""
    def no_delta(*_a, **_k):
        raise AssertionError("torch Delta pass on the kernel path")

    monkeypatch.setattr(sys.modules[_bwd_prepare.__module__], "_delta",
                        no_delta)
    _bwd_prepare(*_bwd_inputs_bf16(), True, 0.125, 0, 0)

