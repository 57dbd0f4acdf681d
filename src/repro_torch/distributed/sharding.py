"""Tensor-parallel weight layout and the model's reduce points (the
counterpart of ``repro/distributed/sharding.py`` and of the tensor-
parallel half of ``repro/launch/shardings.py``).

Every rank of an N-way group holds 1/N of the attention heads, of the
KV heads and of the FFN width, by JAX's rules (``ROW_PARALLEL_NAMES``,
``ATTN_PARAM_NAMES``): ``wq`` / ``wk`` / ``wv`` and ``gate`` / ``up`` are
column-parallel (a rank's heads are contiguous, so its query heads read
exactly its KV heads), ``wo`` and ``down`` row-parallel, and the Layer
Router's ``enc_w`` row-parallel by head: its input is x_Q, the query
projection of every head, pooled per column, so each rank pools its own
heads' columns and takes the matching rows of each half of
``[prefix ‖ suffix]``. Embeddings, the unembedding, the norms and the
rest of the router are replicated.

A row-parallel product leaves a partial sum on each rank. The model adds
them at exactly three reduce points, each ``tp_reduce``: after ``@ wo``
(``models/attention.py`` ``gqa_out``), after ``@ down``
(``models/layers.py`` ``ffn_apply``) and after ``pooled @ enc_w``
(``core/router.py`` ``router_logits``, before ``+ enc_b``), so a bias is
added once and every rank reads the same routing logits. ``tp_reduce``
reads the ambient group that ``tensor_parallel`` sets, as JAX's
``constrain`` reads ``logical_rules``; outside it, it is the identity.

The archs this serves are those whose every layer is GQA attention
("attn" or "local") with a dense FFN; ``check_tp_supported`` refuses the
rest, naming ROADMAP item 16c.
"""
from __future__ import annotations

import dataclasses
import threading
from contextlib import contextmanager
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig

COLUMN_PARALLEL_NAMES = frozenset({"wq", "wk", "wv", "gate", "up"})
ROW_PARALLEL_NAMES = frozenset({"wo", "down"})
# the router's encoder weight: (2·q_dim, hidden), rows [prefix ‖ suffix]
ROUTER_ROW_NAMES = frozenset({"enc_w"})

_state = threading.local()


@contextmanager
def tensor_parallel(group):
    """Make ``group`` (a ``TPGroup``, or None) the ambient group that the
    model's reduce points sum over, for the calls inside the block."""
    prev = getattr(_state, "group", None)
    _state.group = group if group is not None and group.world > 1 else None
    try:
        yield
    finally:
        _state.group = prev


def tp_reduce(x: torch.Tensor) -> torch.Tensor:
    """Sum a row-parallel partial product over the ambient group's ranks
    (in place); ``x`` itself outside ``tensor_parallel``."""
    group = getattr(_state, "group", None)
    return x if group is None else group.all_reduce_sum(x)


def _item_16c(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"tensor-parallel serving of {what} is not ported yet (ROADMAP "
        f"item 16c); serve it on one device (tp=None)")


def check_tp_supported(cfg: ModelConfig, world: int, *,
                       routing_override=None,
                       fidelity_probe_every: int = 0) -> None:
    """Raise unless ``cfg`` can be served on ``world`` ranks: every layer
    GQA attention with a dense FFN, no encoder, the KV heads divisible by
    ``world`` (JAX replicates KV where they are not), no duo head-split
    override and no fidelity probe. World 1 serves everything."""
    if world < 1:
        raise ValueError(f"tensor parallel world={world} must be >= 1")
    if world == 1:
        return
    if cfg.num_experts or any(cfg.moe_layer_mask()):
        raise _item_16c(f"{cfg.name}'s MoE layers (expert FFN width)")
    if cfg.use_mla:
        raise _item_16c(f"{cfg.name}'s MLA layers (head-sharded absorbed "
                        f"projections over a replicated latent cache)")
    if "mamba" in cfg.layer_kinds:
        raise _item_16c(f"{cfg.name}'s Mamba layers")
    if cfg.num_encoder_layers:
        raise _item_16c(f"{cfg.name}'s encoder")
    if cfg.num_kv_heads % world:
        raise _item_16c(f"{cfg.num_kv_heads} KV heads over {world} ranks "
                        f"(KV replication)")
    if cfg.num_heads % world or cfg.d_ff % world:
        raise ValueError(
            f"{cfg.name}: {cfg.num_heads} heads and d_ff {cfg.d_ff} must "
            f"both divide by the {world} tensor-parallel ranks")
    if routing_override is not None and any(
            isinstance(p, tuple) for p in routing_override):
        raise _item_16c("a duo head-split routing override")
    if fidelity_probe_every:
        raise _item_16c("the fidelity probe (fidelity_probe_every > 0)")


def tp_config(cfg: ModelConfig, world: int) -> ModelConfig:
    """The config of one rank's share: the heads, KV heads and FFN width
    divided by ``world`` (``cfg`` itself at world 1)."""
    if world == 1:
        return cfg
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // world,
                               num_kv_heads=cfg.num_kv_heads // world,
                               d_ff=cfg.d_ff // world)


def _piece(t: torch.Tensor, dim: int, rank: int, world: int
           ) -> torch.Tensor:
    n = t.shape[dim] // world
    return t.narrow(dim, rank * n, n)


def _shard_leaf(name: str, t: torch.Tensor, rank: int, world: int
                ) -> torch.Tensor:
    if name in COLUMN_PARALLEL_NAMES:
        t = _piece(t, t.dim() - 1, rank, world)
    elif name in ROW_PARALLEL_NAMES:
        t = _piece(t, 0, rank, world)
    elif name in ROUTER_ROW_NAMES:
        half = t.shape[0] // 2  # rows [prefix ‖ suffix], q_dim each
        t = torch.cat([_piece(t[:half], 0, rank, world),
                       _piece(t[half:], 0, rank, world)])
    else:
        return t  # replicated
    # a copy of the rank's piece alone, so the whole weight can be freed
    return t.clone(memory_format=torch.contiguous_format)


def _walk(tree, rank: int, world: int, name: str = ""):
    if isinstance(tree, torch.Tensor):
        return _shard_leaf(name, tree, rank, world)
    if isinstance(tree, dict):
        return {k: _walk(v, rank, world, k) for k, v in tree.items()}
    return [_walk(v, rank, world, name) for v in tree]


def shard_params_tp(params: Dict[str, Any], cfg: ModelConfig, rank: int,
                    world: int) -> Dict[str, Any]:
    """Rank ``rank``'s share of the port's parameter dictionary (as
    ``init_params`` or ``bridge.params_from_jax`` give it), on the
    params' device: the column-parallel leaves' columns and the
    row-parallel leaves' rows of its heads or FFN width, the router's
    ``enc_w`` rows of its heads from both pooling halves, everything
    else shared with ``params``."""
    check_tp_supported(cfg, world)
    if world == 1:
        return params
    return _walk(params, rank, world)


def params_are_local(params: Dict[str, Any], cfg: ModelConfig,
                     world: int) -> bool:
    """True when ``params`` already hold one rank's share (the first
    layer's ``wq`` is q_dim / world wide)."""
    if world == 1:
        return True
    wq = params["layers"][0]["attn"]["wq"]
    return wq.shape[-1] == tp_config(cfg, world).q_dim


def global_param_bytes(params: Dict[str, Any], world: int) -> int:
    """The bytes of the whole model behind one rank's share: its sharded
    leaves ``world`` times, its replicated ones once."""
    def walk(tree, name: str = "") -> int:
        if isinstance(tree, torch.Tensor):
            shard = (name in COLUMN_PARALLEL_NAMES or name in
                     ROW_PARALLEL_NAMES or name in ROUTER_ROW_NAMES)
            return tree.nbytes * (world if shard else 1)
        if isinstance(tree, dict):
            return sum(walk(v, k) for k, v in tree.items())
        return sum(walk(v, name) for v in tree)
    return walk(params)


def init_params_tp(cfg: ModelConfig, gen: torch.Generator, rank: int,
                   world: int, device=None) -> Dict[str, Any]:
    """``models.model.init_params``'s weights, drawn in its order from
    ``gen``, kept as rank ``rank``'s share only: each layer is drawn
    whole and sharded before the next is drawn, so no rank holds more
    than one whole layer beside its share (command-r-plus-104b's 208 GB
    never meet on one card). The same seed gives the shares of the same
    weights."""
    from repro_torch.models import model as MD
    check_tp_supported(cfg, world)
    return MD.init_params(cfg, gen, device, block_map=lambda bp: _walk(
        bp, rank, world) if world > 1 else bp)
