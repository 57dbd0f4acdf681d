"""Weights from the JAX package's layout into the port's.

``params_from_jax`` takes the pytree of ``repro.models.model.init_params``
with every leaf already a numpy array (``jax.tree.map(np.asarray,
params)``), so this module imports neither JAX nor the JAX package. The
JAX trunk is stacked by period position (``trunk[pos]`` leaves carry a
leading ``n_periods`` axis); the port keeps one dictionary per layer, so
layer ``i`` is ``trunk[i % P]`` at period ``i // P``, the way the JAX
``layer_params`` un-stacks it.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _to_torch(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret bits
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _convert(tree, device, index=None):
    if isinstance(tree, dict):
        return {k: _convert(v, device, index) for k, v in tree.items()}
    a = np.asarray(tree)
    return _to_torch(a if index is None else a[index], device)


def params_from_jax(np_params: Dict[str, Any], cfg: ModelConfig,
                    device) -> Dict[str, Any]:
    """The port's parameter dictionary holding the same values as the JAX
    pytree ``np_params`` (numpy leaves), on ``device``."""
    P = len(cfg.layer_pattern)
    trunk = np_params["trunk"]
    if len(trunk) != P:
        raise ValueError(f"trunk has {len(trunk)} period positions; "
                         f"{cfg.name} has a period of {P}")
    layers = []
    for i in range(cfg.num_layers):
        per, pos = divmod(i, P)
        layers.append(_convert(trunk[pos], device, per))
    out: Dict[str, Any] = {"layers": layers}
    for k, v in np_params.items():
        if k != "trunk":
            out[k] = _convert(v, device)
    return out
