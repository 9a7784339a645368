"""The port's decoder (ray_tpu_torch.models) against the JAX package's on
the CPU: the same weights (JAX init_params carried across with
params_from_numpy) and the same tokens give the same logits, at
atol 2e-5 / rtol 2e-4 in f32 (the tests/test_llm.py bound)."""

import dataclasses
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import configs as jax_configs
from ray_tpu.models import transformer as jt
from ray_tpu_torch import convert
from ray_tpu_torch.models import configs
from ray_tpu_torch.models import transformer as tt

sys.path.insert(0, os.path.dirname(__file__))
from torch_port_util import both_params, numpy_params  # noqa: E402

ATOL, RTOL = 2e-5, 2e-4


def gqa_configs():
    """A small GQA config (8 query heads over 2 KV heads, untied head)."""
    kw = dict(vocab_size=300, d_model=128, n_layers=2, n_heads=8,
              n_kv_heads=2, d_ff=256, max_seq_len=128, rope_theta=5e5,
              tie_embeddings=False, remat=False)
    return (jt.TransformerConfig(dtype=jnp.float32, **kw),
            configs.TransformerConfig(dtype=torch.float32, **kw))


CONFIGS = {
    "tiny": lambda: (jax_configs.tiny_test(), configs.tiny_test()),
    "gqa": gqa_configs,
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_logits_match_jax(name):
    cfg_j, cfg_t = CONFIGS[name]()
    pj, pt = both_params(cfg_j, cfg_t, seed=3)
    toks = np.random.RandomState(1).randint(0, cfg_t.vocab_size, (2, 24))
    want = np.asarray(jax.jit(jt.forward, static_argnums=0)(
        cfg_j, pj, jnp.asarray(toks))[0])
    got, aux = tt.forward(cfg_t, pt, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_reference_attention_impl_matches_auto_on_cpu():
    cfg_t = configs.tiny_test()
    pt = convert.params_from_numpy(
        cfg_t, numpy_params(jax_configs.tiny_test(), 5), device="cpu")
    toks = torch.from_numpy(np.random.RandomState(3).randint(0, 256, (2, 9)))
    ref = tt.forward(dataclasses.replace(cfg_t, attn_impl="reference"), pt,
                     toks)[0]
    assert torch.equal(tt.forward(cfg_t, pt, toks)[0], ref)


def test_pieces_match_jax():
    cfg_j, cfg_t = gqa_configs()
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    np.testing.assert_allclose(
        tt.rms_norm(torch.from_numpy(x), torch.from_numpy(scale),
                    1e-5).numpy(),
        np.asarray(jt.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5)),
        atol=ATOL, rtol=RTOL)
    sin_j, cos_j = jt.rope_tables(cfg_j, 64)
    sin_t, cos_t = tt.rope_tables(cfg_t, 64)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=2e-5)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=2e-5)
    q = rng.standard_normal((2, 64, 8, 16)).astype(np.float32)
    np.testing.assert_allclose(
        tt.apply_rope(torch.from_numpy(q), sin_t, cos_t).numpy(),
        np.asarray(jt.apply_rope(jnp.asarray(q), sin_j, cos_j)),
        atol=ATOL, rtol=RTOL)


def test_apply_rope_is_half_split():
    """Pairs are (x[i], x[i + half]), not interleaved neighbours."""
    x = torch.zeros((1, 1, 1, 8))
    x[..., 0] = 1.0
    sin, cos = torch.ones((1, 4)), torch.zeros((1, 4))
    out = tt.apply_rope(x, sin, cos)[0, 0, 0]
    assert out[4] == 1.0 and out[1] == 0.0 and out[0] == 0.0


def test_init_params_layout_dtypes_and_depth_scaling():
    cfg = dataclasses.replace(configs.tiny_test(), n_layers=4,
                              dtype=torch.bfloat16, tie_embeddings=False)
    p = tt.init_params(cfg, 0, device="cpu")
    shapes = tt.param_shapes(cfg)
    assert p["lm_head"].shape == shapes["lm_head"]
    for name, shape in shapes["layers"].items():
        w = p["layers"][name]
        assert w.shape == shape
        want = torch.float32 if name.endswith("norm") else torch.bfloat16
        assert w.dtype == want, name
    assert p["embed"].dtype == torch.bfloat16
    assert p["final_norm"].dtype == torch.float32
    std = 0.02 / math.sqrt(2 * cfg.n_layers)
    assert abs(p["layers"]["wo"].float().std().item() - std) < 0.1 * std
    assert abs(p["layers"]["wq"].float().std().item() - 0.02) < 0.002
    again = tt.init_params(cfg, 0, device="cpu")
    assert torch.equal(p["layers"]["w_up"], again["layers"]["w_up"])
    other = tt.init_params(cfg, 1, device="cpu")
    assert not torch.equal(p["layers"]["w_up"], other["layers"]["w_up"])


def test_bf16_storage_computes_what_casting_at_use_computes():
    """Weights stored in bf16 give exactly the logits of f32 master
    weights cast to bf16 at every use (the JAX package's way)."""
    cfg = dataclasses.replace(configs.tiny_test(), dtype=torch.bfloat16)
    tree = numpy_params(jax_configs.tiny_test(), 2)
    stored = convert.params_from_numpy(cfg, tree, device="cpu")
    master = convert.params_from_numpy(
        dataclasses.replace(cfg, dtype=torch.float32), tree, device="cpu")
    assert stored["layers"]["wq"].dtype == torch.bfloat16
    assert stored["layers"]["attn_norm"].dtype == torch.float32
    assert master["layers"]["wq"].dtype == torch.float32
    toks = torch.from_numpy(np.random.RandomState(4).randint(0, 256, (2, 12)))
    assert torch.equal(tt.forward(cfg, stored, toks)[0],
                       tt.forward(cfg, master, toks)[0])


def test_params_from_numpy_checks_shapes_and_keys():
    cfg_j, cfg_t = jax_configs.tiny_test(), configs.tiny_test()
    tree = numpy_params(cfg_j, 0)
    bad = dict(tree, final_norm=np.ones((3,), np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        convert.params_from_numpy(cfg_t, bad, device="cpu")
    missing = {k: v for k, v in tree.items() if k != "embed"}
    with pytest.raises(KeyError, match="embed"):
        convert.params_from_numpy(cfg_t, missing, device="cpu")


def test_params_from_numpy_takes_bf16_arrays():
    """llama_1b4-style bf16 master weights (ml_dtypes arrays) convert
    exactly."""
    cfg_j = dataclasses.replace(jax_configs.tiny_test(),
                                param_dtype=jnp.bfloat16)
    cfg_t = dataclasses.replace(configs.tiny_test(),
                                param_dtype=torch.bfloat16)
    tree = jax.tree_util.tree_map(
        np.asarray, jt.init_params(cfg_j, jax.random.key(0)))
    pt = convert.params_from_numpy(cfg_t, tree, device="cpu")
    assert pt["final_norm"].dtype == torch.bfloat16
    np.testing.assert_array_equal(pt["layers"]["wq"].numpy(),
                                  tree["layers"]["wq"].astype(np.float32))


def test_moe_configs_are_refused():
    with pytest.raises(NotImplementedError, match="MoE"):
        configs.get("tiny_moe")
    with pytest.raises(NotImplementedError, match="MoE"):
        tt.init_params(configs.mixtral_8x7b(), device="cpu")
    assert configs.get("llama3-8b").head_dim == 128
    with pytest.raises(ValueError, match="Unknown"):
        configs.get("gpt5")


def test_named_configs_match_jax():
    for name in configs.NAMED:
        a, b = jax_configs.NAMED[name](), configs.NAMED[name]()
        for f in dataclasses.fields(a):
            if f.name not in ("dtype", "param_dtype"):
                assert getattr(a, f.name) == getattr(b, f.name), (name, f)
        assert a.num_params() == b.num_params()
        assert np.dtype(a.dtype).itemsize == b.dtype.itemsize


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tt.init_params(configs.tiny_test())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.params_from_numpy(
            configs.tiny_test(), numpy_params(jax_configs.tiny_test(), 0))
