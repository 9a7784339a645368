"""Carry weights across from the JAX package's parameter layout.

The JAX package's params are a nested dict: ``embed`` (V, D),
``layers/{attn_norm, wq, wk, wv, wo, ffn_norm, w_gate, w_up, w_down}``
stacked on a leading L axis, ``final_norm`` (D,), and ``lm_head`` (D, V)
when untied. The port keeps that layout and the ``x @ W`` orientation, so
the mapping is leaf for leaf with no transpose; only the storage dtype
changes (see models/transformer.py).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .models.configs import TransformerConfig, require_dense
from .models.transformer import Params, param_shapes, storage_dtype


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
                      device: DeviceLike = "cuda") -> Params:
    """The JAX package's params (nested dict of numpy arrays, or anything
    np.asarray takes) -> the port's parameter dictionary on `device`."""
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
                name: _leaf(layers[name], s, storage_dtype(cfg, name), dev,
                            f"layers/{name}")
                for name, s in shape.items()}
        else:
            out[key] = _leaf(tree[key], shape, storage_dtype(cfg, key), dev,
                             key)
    return out
