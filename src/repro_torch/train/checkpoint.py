"""Checkpoints of the port's trees (port of ``repro/train/checkpoint.py``).

``save`` writes one flat dictionary {path: tensor} with ``torch.save``;
a path joins a leaf's keys, list indices and ``AdamState`` fields with
"/" as the JAX package's ``_path_str`` joins them (a field as ".mu", as
``str`` of JAX's attribute key reads), e.g. "layers/3/router/enc_w" or
"opt_router/.mu/layers/3/router/enc_w". None leaves are not stored.
Tensors keep their dtype (bf16 included), so a round trip is bitwise.
The port neither reads nor writes the JAX package's ``.msgpack`` files.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict

import torch


def _flatten(tree, prefix: str, out: Dict[str, Any]) -> None:
    def key(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, key(k), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, key(i), out)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            _flatten(getattr(tree, f.name), key(f".{f.name}"), out)
    else:
        out[prefix] = tree


def flatten(tree) -> Dict[str, Any]:
    """{path: leaf} of ``tree`` in its order (None leaves skipped)."""
    out: Dict[str, Any] = {}
    _flatten(tree, "", out)
    return out


def save(path: str, tree: Any) -> None:
    """Write ``tree``'s tensors (moved to the CPU) to ``path``, atomically
    (a temporary file, then a rename)."""
    payload = {k: (v.detach().cpu() if isinstance(v, torch.Tensor) else v)
               for k, v in flatten(tree).items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _restore(like, prefix: str, payload):
    def key(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _restore(v, key(k), payload) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_restore(v, key(i), payload)
                          for i, v in enumerate(like))
    if dataclasses.is_dataclass(like):
        return dataclasses.replace(like, **{
            f.name: _restore(getattr(like, f.name), key(f".{f.name}"),
                             payload) for f in dataclasses.fields(like)})
    if prefix not in payload:
        raise KeyError(f"checkpoint missing leaf {prefix!r}")
    v = payload[prefix]
    return v.to(like.device) if isinstance(like, torch.Tensor) else v


def load(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (the same paths required),
    each tensor on its ``like`` leaf's device."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return _restore(like, "", payload)
