"""Weights from the JAX package's layout into the port's.

``params_from_jax`` takes the pytree of ``repro.models.model.init_params``
with every leaf already a numpy array (``jax.tree.map(np.asarray,
params)``), so this module imports neither JAX nor the JAX package. The
JAX trunk is stacked by period position (``trunk[pos]`` leaves carry a
leading ``n_periods`` axis); the port keeps one dictionary per layer, so
layer ``i`` is ``trunk[i % P]`` at period ``i // P``, the way the JAX
``layer_params`` un-stacks it (a decoder layer's ``norm_x`` / ``xattn``
come with it). The JAX encoder stacks its layers on one leading axis
for ``lax.scan``; the port keeps them as a list, ``encoder["layers"]``.

``train_state_from_jax`` carries a trainer's state across the same way
(a ``RouterTrainer``, ``PretrainTrainer`` or ``ContinuedTrainer`` state,
its leaves numpy arrays or None): each parameter-shaped tree un-stacked
by period as ``params_from_jax`` does, the multipliers, both AdamW
states and the step.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _to_torch(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a).reshape(np.shape(a))  # keeps a 0-d shape
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret bits
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _convert(tree, device, index=None):
    if tree is None:  # a leaf outside a partitioned tree's group
        return None
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
        if k not in ("trunk", "encoder"):
            out[k] = _convert(v, device)
    if "encoder" in np_params:
        enc = np_params["encoder"]
        n = cfg.num_encoder_layers
        scale = enc["layers"]["norm1"]["scale"]
        if scale is not None and np.asarray(scale).shape[0] != n:
            raise ValueError(f"the encoder's layers are not stacked {n} "
                             f"deep; {cfg.name} has {n} encoder layers")
        out["encoder"] = {
            "layers": [_convert(enc["layers"], device, i) for i in range(n)],
            "final_norm": _convert(enc["final_norm"], device)}
    return out


def _state_tree(tree, cfg: ModelConfig, device):
    """A parameter-shaped tree (it has a ``trunk``) un-stacked by period,
    any other tree (the multipliers) converted leaf by leaf."""
    if isinstance(tree, dict) and "trunk" in tree:
        return params_from_jax(tree, cfg, device)
    return _convert(tree, device)


def train_state_from_jax(np_state: Dict[str, Any], cfg: ModelConfig,
                         device) -> Dict[str, Any]:
    """The port's trainer state holding the same values as the JAX
    trainer state ``np_state`` (``jax.tree.map(np.asarray, state)``):
    parameter trees on ``device``, the multipliers (``lagrange``) on
    ``device``, each AdamW state (an object with ``mu``, ``nu`` and
    ``count``) as the port's ``AdamState`` with its count on the CPU, and
    ``step`` as a 0-d int32 CPU tensor."""
    from repro_torch.train.optimizer import AdamState
    out: Dict[str, Any] = {}
    for k, v in np_state.items():
        if all(hasattr(v, f) for f in ("mu", "nu", "count")):
            out[k] = AdamState(mu=_state_tree(v.mu, cfg, device),
                               nu=_state_tree(v.nu, cfg, device),
                               count=_to_torch(np.asarray(v.count), "cpu"))
        elif k == "step":
            out[k] = _to_torch(np.asarray(v), "cpu")
        else:
            out[k] = _state_tree(v, cfg, device)
    return out
