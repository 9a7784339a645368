"""Carry weights across from the JAX package's parameter layout.

The JAX package's params are a nested dict: ``embed`` (V, D),
``layers/{attn_norm, wq, wk, wv, wo, ffn_norm, w_gate, w_up, w_down}``
stacked on a leading L axis, ``final_norm`` (D,), and ``lm_head`` (D, V)
when untied. The port keeps that layout and the ``x @ W`` orientation, so
the mapping is leaf for leaf with no transpose; only the storage dtype
changes (see models/transformer.py): the serving storage by default, every
leaf in ``param_dtype`` with ``master_weights=True`` (training).

``learner_state_from_numpy`` carries a GRPO learner's whole state across:
the step, the params and optax's AdamW moments.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .models.configs import TransformerConfig, require_dense
from .models.transformer import Params, param_shapes, storage_dtype
from .train.step import AdamWState, _leaves


def _leaf(a: Any, shape, dtype: torch.dtype, device: torch.device,
          name: str) -> torch.Tensor:
    arr = np.asarray(a)
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(arr.shape)}, expected "
                         f"{tuple(shape)}")
    if arr.dtype.kind != "f" or arr.dtype.itemsize < 4:
        # bf16 (ml_dtypes) and f16 arrays widen exactly to f32 first:
        # torch.from_numpy takes neither.
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr, copy=True, order="C")).to(
        device=device, dtype=dtype)


def params_from_numpy(cfg: TransformerConfig, tree: Mapping[str, Any], *,
                      device: DeviceLike = "cuda",
                      master_weights: bool = False) -> Params:
    """The JAX package's params (nested dict of numpy arrays, or anything
    np.asarray takes) -> the port's parameter dictionary on `device`.
    `master_weights` stores every leaf in cfg.param_dtype (training)."""
    require_dense(cfg)
    dev = resolve_device(device)
    shapes = param_shapes(cfg)
    out: Params = {}
    for key, shape in shapes.items():
        if key not in tree:
            raise KeyError(f"params missing {key!r}")
        if key == "layers":
            layers = tree["layers"]
            out["layers"] = {
                name: _leaf(layers[name], s,
                            storage_dtype(cfg, name, master_weights), dev,
                            f"layers/{name}")
                for name, s in shape.items()}
        else:
            out[key] = _leaf(tree[key], shape,
                             storage_dtype(cfg, key, master_weights), dev,
                             key)
    return out


def _tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a host pytree in jax.tree.leaves' order: a dict by
    sorted key, a tuple, list or namedtuple by position, None and empty
    containers (optax's EmptyState) hold none."""
    if tree is None:
        return []
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _tree_leaves(t)]
    return [tree]


def learner_state_from_numpy(cfg: TransformerConfig,
                             state: Mapping[str, Any]) -> Dict[str, Any]:
    """The JAX GRPO learner's get_state() -> the port learner's (the
    form GRPOLearner.set_state takes). Its optax state is the chain
    clip_by_global_norm, adamw, whose leaves are Adam's count, its mu and
    nu trees (each in the params' leaf order) and the schedule's count;
    the step and the params pass through (set_state checks the shapes)."""
    n = len(_leaves(param_shapes(cfg)))
    leaves = _tree_leaves(state["opt_state"])
    if len(leaves) != 2 * n + 2:
        raise ValueError(f"optimizer state has {len(leaves)} leaves, "
                         f"expected {2 * n + 2} (count, mu and nu of {n} "
                         "parameter leaves, the schedule's count)")
    count, mu, nu, sched = (leaves[0], leaves[1:n + 1],
                            leaves[n + 1:2 * n + 1], leaves[-1])
    if int(count) != int(sched):
        raise ValueError(f"Adam's count {int(count)} and the schedule's "
                         f"{int(sched)} differ")
    return {"step": int(state["step"]), "params": state["params"],
            "opt_state": AdamWState(int(count),
                                    [np.asarray(m) for m in mu],
                                    [np.asarray(v) for v in nu])}
