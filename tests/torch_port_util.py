"""Shared helpers of the tests that hold the PyTorch port (ray_tpu_torch)
against the JAX package: one set of weights for both sides."""

import math

import jax
import jax.numpy as jnp
import numpy as np

from ray_tpu.models.transformer import init_params as jax_init_params
from ray_tpu_torch.convert import params_from_numpy


def numpy_params(cfg_j, seed: int = 0, gain: float = 8.0):
    """A parameter tree of the JAX init_params layout (its shapes and
    dtypes, read with jax.eval_shape), drawn with numpy: the init's
    scaled normals times `gain`, and norm scales jittered around 1, so
    logits spread and greedy continuations are not one repeated token."""
    shapes = jax.eval_shape(
        lambda: jax_init_params(cfg_j, jax.random.key(0)))
    rng = np.random.RandomState(seed)
    depth = 0.02 / math.sqrt(2 * cfg_j.n_layers)

    def draw(path, sds):
        name = str(path[-1].key)
        if name.endswith("norm"):
            a = 1.0 + 0.1 * rng.standard_normal(sds.shape)
        else:
            std = depth if name in ("wo", "w_down") else 0.02
            a = gain * std * rng.standard_normal(sds.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def both_params(cfg_j, cfg_t, seed: int = 0, gain: float = 8.0):
    """(JAX params, port params on the CPU) holding the same numbers."""
    tree = numpy_params(cfg_j, seed, gain)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(cfg_t, tree, device="cpu"))
