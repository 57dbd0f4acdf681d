"""Tensor-parallel weight layout and the model's reduce points (the
counterpart of ``repro/distributed/sharding.py`` and of the tensor-
parallel half of ``repro/launch/shardings.py``).

Every rank of an N-way group holds 1/N of the attention heads, of the
KV heads and of the FFN width. Column-parallel (``COLUMN_PARALLEL_NAMES``,
the last axis): ``wq`` / ``wk`` / ``wv`` (a rank's heads are contiguous,
so its query heads read exactly its KV heads), MLA's ``w_uq`` (H·(nope +
rope) columns) and ``w_ukv`` (H·(nope + v) columns), both head-contiguous
as ``mla_q`` and ``_w_uk_uv`` reshape them, and ``gate`` / ``up``, a
dense FFN's (D, F) and an MoE layer's expert stacks (E, D, F) alike.
Row-parallel (``ROW_PARALLEL_NAMES``): ``wo`` and ``down`` on their
first axis, but the expert stack ``experts/down`` (E, F, D) on axis 1,
its F: the rule reads the leaf's parent as well as its name, since
narrowing axis 0 would hand a rank whole experts under an F-sharded
``gate`` / ``up``. The Layer Router's ``enc_w`` is row-parallel by head:
its input is x_Q, the query projection of every head (H·(nope + rope)
wide under MLA), pooled per column, so each rank pools its own heads'
columns and takes the matching rows of each half of ``[prefix ‖
suffix]``. The encoder's and the cross attention's ``wq`` / ``wk`` /
``wv`` / ``wo`` and FFNs take the decoder's rules. Replicated: the
embeddings, the unembedding, the norms, the rest of the router, an MoE
layer's gate ``gate_w`` (every rank computes the same dispatch from the
replicated residual), MLA's latent projections (``w_dq``, ``q_norm``,
``w_dkv``, ``kv_norm``, ``w_kr``: the latent has no head axis, so every
rank computes ``ckv`` / ``kr`` whole and its latent cache is whole) and
every leaf of a Mamba block (its state mixes channels).

A row-parallel product leaves a partial sum on each rank. The model adds
them at its reduce points, each a ``tp_reduce`` of (B, S, d_model) or,
for the router, of its pooled logits: after ``@ wo`` (``models/
attention.py`` ``gqa_out`` and ``mla_out``, which the MLA route chunk,
its absorbed chunk attention and its latent decode all end in; the
encoder's layers and the cross attention in ``models/model.py``
``encode`` and ``_cross_attention``), after a layer's FFN (``models/
layers.py`` ``ffn_apply``; an MoE layer sums its routed experts'
weighted gather and its shared experts' partial product first and
reduces once, ``models/moe.py`` ``moe_ffn``) and after ``pooled @
enc_w`` (``core/router.py`` ``router_logits``, before ``+ enc_b``), so a
bias is added once and every rank reads the same routing logits. A
decode step reduces once at each attention or MLA layer, once at each
FFN or MoE, once at each cross attention and never at a Mamba block.
``tp_reduce`` reads the ambient group that ``tensor_parallel`` sets, as
JAX's ``constrain`` reads ``logical_rules``; outside it, it is the
identity.

``check_tp_supported`` refuses what is not ported yet, naming ROADMAP
item 16c: KV replication (a GQA model whose KV heads do not divide by
the ranks), a duo head-split override and the fidelity probe.
"""
from __future__ import annotations

import dataclasses
import threading
from contextlib import contextmanager
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig

COLUMN_PARALLEL_NAMES = frozenset({"wq", "wk", "wv", "gate", "up",
                                   "w_uq", "w_ukv"})
ROW_PARALLEL_NAMES = frozenset({"wo", "down"})
# the router's encoder weight: (2·q_dim, hidden), rows [prefix ‖ suffix]
ROUTER_ROW_NAMES = frozenset({"enc_w"})
# an MoE layer's expert stacks: gate / up (E, D, F), down (E, F, D)
EXPERTS = "experts"

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
    """Raise unless ``cfg`` can be served on ``world`` ranks: the heads,
    the FFN width and the expert FFN width divisible by ``world``
    (ValueError), the KV heads too unless the model is MLA, whose latent
    cache has no KV heads (JAX replicates KV where they are not), no duo
    head-split override and no fidelity probe. World 1 serves
    everything."""
    if world < 1:
        raise ValueError(f"tensor parallel world={world} must be >= 1")
    if world == 1:
        return
    if cfg.num_heads % world or cfg.d_ff % world or cfg.moe_d_ff % world:
        raise ValueError(
            f"{cfg.name}: {cfg.num_heads} heads, d_ff {cfg.d_ff} and "
            f"moe_d_ff {cfg.moe_d_ff} must all divide by the {world} "
            f"tensor-parallel ranks")
    if not cfg.use_mla and cfg.num_kv_heads % world:
        raise _item_16c(f"{cfg.num_kv_heads} KV heads over {world} ranks "
                        f"(KV replication)")
    if routing_override is not None and any(
            isinstance(p, tuple) for p in routing_override):
        raise _item_16c("a duo head-split routing override")
    if fidelity_probe_every:
        raise _item_16c("the fidelity probe (fidelity_probe_every > 0)")


def tp_config(cfg: ModelConfig, world: int) -> ModelConfig:
    """The config of one rank's share: the heads, KV heads, FFN width
    and expert FFN width divided by ``world`` (``cfg`` itself at world
    1). The Mamba fields stay whole: its blocks are replicated."""
    if world == 1:
        return cfg
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // world,
                               num_kv_heads=cfg.num_kv_heads // world,
                               d_ff=cfg.d_ff // world,
                               moe_d_ff=cfg.moe_d_ff // world)


def _piece(t: torch.Tensor, dim: int, rank: int, world: int
           ) -> torch.Tensor:
    n = t.shape[dim] // world
    return t.narrow(dim, rank * n, n)


def shard_axis(parent: str, name: str) -> Optional[int]:
    """The axis a leaf named ``name`` in the dictionary ``parent`` is
    cut on (-1 the last), None when it is replicated. ``enc_w``'s axis 0
    is cut in each of its two halves."""
    if name in COLUMN_PARALLEL_NAMES:
        return -1
    if name in ROW_PARALLEL_NAMES:
        return 1 if parent == EXPERTS else 0
    if name in ROUTER_ROW_NAMES:
        return 0
    return None


def _shard_leaf(parent: str, name: str, t: torch.Tensor, rank: int,
                world: int) -> torch.Tensor:
    axis = shard_axis(parent, name)
    if axis is None:
        return t  # replicated
    if name in ROUTER_ROW_NAMES:
        half = t.shape[0] // 2  # rows [prefix ‖ suffix], q_dim each
        t = torch.cat([_piece(t[:half], 0, rank, world),
                       _piece(t[half:], 0, rank, world)])
    else:
        t = _piece(t, axis % t.dim(), rank, world)
    # a copy of the rank's piece alone, so the whole weight can be freed
    return t.clone(memory_format=torch.contiguous_format)


def _walk(tree, rank: int, world: int, parent: str = "", name: str = ""):
    if isinstance(tree, torch.Tensor):
        return _shard_leaf(parent, name, tree, rank, world)
    if isinstance(tree, dict):
        return {k: _walk(v, rank, world, name, k) for k, v in tree.items()}
    return [_walk(v, rank, world, parent, name) for v in tree]


def shard_params_tp(params: Dict[str, Any], cfg: ModelConfig, rank: int,
                    world: int) -> Dict[str, Any]:
    """Rank ``rank``'s share of the port's parameter dictionary (as
    ``init_params`` or ``bridge.params_from_jax`` give it), on the
    params' device: each sharded leaf's piece of its heads or FFN width
    along ``shard_axis`` (the router's ``enc_w`` rows of its heads from
    both pooling halves), everything else shared with ``params``."""
    check_tp_supported(cfg, world)
    if world == 1:
        return params
    return _walk(params, rank, world)


def _probe_width(params: Dict[str, Any], cfg: ModelConfig
                 ) -> Optional[Tuple[int, int]]:
    """(held, whole) width of the first layer's first sharded weight: an
    attention's or MLA's ``wo`` rows, an MoE layer's expert width or a
    dense FFN's; None when no layer has one (a model of Mamba blocks
    alone, which has no sharded leaf)."""
    for bp in params["layers"]:
        if "attn" in bp:
            hd = cfg.v_head_dim if cfg.use_mla else cfg.head_dim
            return bp["attn"]["wo"].shape[0], cfg.num_heads * hd
        if "moe" in bp:
            return bp["moe"][EXPERTS]["gate"].shape[-1], cfg.moe_d_ff
        if "ffn" in bp:
            return bp["ffn"]["gate"].shape[-1], cfg.d_ff
    return None


def params_are_local(params: Dict[str, Any], cfg: ModelConfig,
                     world: int) -> bool:
    """True when ``params`` already hold one rank's share (their first
    sharded weight is 1/world as wide as ``cfg``'s), and for a model
    with no sharded weight, whose share is the whole."""
    if world == 1:
        return True
    probe = _probe_width(params, cfg)
    return probe is None or probe[0] * world == probe[1]


def global_param_bytes(params: Dict[str, Any], world: int) -> int:
    """The bytes of the whole model behind one rank's share: its sharded
    leaves ``world`` times, its replicated ones once."""
    def walk(tree, parent: str = "", name: str = "") -> int:
        if isinstance(tree, torch.Tensor):
            shard = shard_axis(parent, name) is not None
            return tree.nbytes * (world if shard else 1)
        if isinstance(tree, dict):
            return sum(walk(v, name, k) for k, v in tree.items())
        return sum(walk(v, parent, name) for v in tree)
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
