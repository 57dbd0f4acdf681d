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

KV replication: where a GQA model's Hkv KV heads do not divide by the N
ranks but N divides by Hkv, each KV head is held by R = N / Hkv ranks
(JAX's ``constrain`` drops the axis there and replicates the KV). Rank
r keeps KV head r // R, the one its query heads [r·Hq/N, (r+1)·Hq/N)
read, as its one KV head (``tp_config``: Hkv = 1, Hq / N query heads,
so the kernels see an ordinary GQA layout of G = Hq / N), and the
matching columns of the decoder attention's ``wk`` / ``wv``. Ranks
that share a KV head compute the same k / v in the same order, so their
caches are bitwise equal. Where neither count divides the other (a
rank's query heads would read parts of two KV heads) ``check_tp_
supported`` raises ValueError; JAX replicates the whole KV there.
``kv_head_range`` tells the duo head split and the fidelity probe which
global KV heads the rank holds.
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
# the decoder attention's KV projections (``is_kv_leaf``)
KV_NAMES = frozenset({"wk", "wv"})
# the router's encoder weight: (2·q_dim, hidden), rows [prefix ‖ suffix]
ROUTER_ROW_NAMES = frozenset({"enc_w"})
# an MoE layer's expert stacks: gate / up (E, D, F), down (E, F, D)
EXPERTS = "experts"

_state = threading.local()


@contextmanager
def tensor_parallel(group, kv_heads: Optional[int] = None):
    """Make ``group`` (a ``TPGroup``, or None) the ambient group that the
    model's reduce points sum over, for the calls inside the block.
    ``kv_heads``, the whole model's KV heads, is what ``kv_head_range``
    (the duo head split's) needs beside the rank's share."""
    prev = (getattr(_state, "group", None),
            getattr(_state, "kv_heads", None))
    _state.group = group if group is not None and group.world > 1 else None
    _state.kv_heads = kv_heads
    try:
        yield
    finally:
        _state.group, _state.kv_heads = prev


def tp_reduce(x: torch.Tensor) -> torch.Tensor:
    """Sum a row-parallel partial product over the ambient group's ranks
    (in place); ``x`` itself outside ``tensor_parallel``."""
    group = getattr(_state, "group", None)
    return x if group is None else group.all_reduce_sum(x)


def tp_world() -> int:
    """The ambient group's ranks; 1 outside ``tensor_parallel``."""
    group = getattr(_state, "group", None)
    return 1 if group is None else group.world


def kv_head_range(cfg: ModelConfig) -> Tuple[int, int]:
    """(the rank's first global KV head, the whole model's KV heads)
    under the ambient group, for ``cfg`` the rank's share (``tp_config``;
    the rank holds ``cfg.num_kv_heads`` heads from the first on); (0,
    ``cfg.num_kv_heads``) outside ``tensor_parallel``."""
    group = getattr(_state, "group", None)
    if group is None:
        return 0, cfg.num_kv_heads
    whole = getattr(_state, "kv_heads", None)
    if whole is None:
        raise RuntimeError(
            "kv_head_range: the ambient group was entered without the "
            "whole model's KV heads; enter it as tensor_parallel(group, "
            "kv_heads=<the whole config's num_kv_heads>)")
    R = max(1, group.world // whole)  # ranks a KV head (kv_replicas)
    return (group.rank // R if R > 1
            else group.rank * cfg.num_kv_heads), whole


def kv_replicas(cfg: ModelConfig, world: int) -> int:
    """R, the ranks that hold each KV head of ``cfg`` (the whole model)
    on ``world`` ranks: 1 where the KV heads divide by the ranks (and
    for MLA, whose latent cache has no KV heads), world / Hkv where the
    ranks divide by the KV heads. ValueError, naming both counts, where
    neither divides the other."""
    Hkv = cfg.num_kv_heads
    if world == 1 or cfg.use_mla or Hkv % world == 0:
        return 1
    if world % Hkv:
        raise ValueError(
            f"{cfg.name}: {Hkv} KV heads over {world} tensor-parallel "
            f"ranks: neither count divides the other, so a rank's query "
            f"heads would read parts of two KV heads; serve it on a rank "
            f"count that divides {Hkv} or that {Hkv} divides")
    return world // Hkv


def check_tp_supported(cfg: ModelConfig, world: int) -> None:
    """Raise ValueError unless ``cfg`` can be served on ``world`` ranks:
    the heads, the FFN width and the expert FFN width divisible by
    ``world``, and the KV heads divisible by ``world`` or ``world`` by
    them (``kv_replicas``), unless the model is MLA, whose latent cache
    has no KV heads. World 1 serves everything."""
    if world < 1:
        raise ValueError(f"tensor parallel world={world} must be >= 1")
    if world == 1:
        return
    if cfg.num_heads % world or cfg.d_ff % world or cfg.moe_d_ff % world:
        raise ValueError(
            f"{cfg.name}: {cfg.num_heads} heads, d_ff {cfg.d_ff} and "
            f"moe_d_ff {cfg.moe_d_ff} must all divide by the {world} "
            f"tensor-parallel ranks")
    if kv_replicas(cfg, world) > 1 and cfg.num_encoder_layers:
        raise ValueError(
            f"{cfg.name}: {cfg.num_kv_heads} KV heads over {world} ranks "
            f"would replicate the decoder's KV, and an encoder's "
            f"attention is cut by its query heads: no model of the repo "
            f"has both")


def tp_config(cfg: ModelConfig, world: int) -> ModelConfig:
    """The config of one rank's share: the heads, KV heads, FFN width
    and expert FFN width divided by ``world`` (``cfg`` itself at world
    1); under KV replication one KV head. The Mamba fields stay whole:
    its blocks are replicated."""
    if world == 1:
        return cfg
    kv = (cfg.num_kv_heads // world if kv_replicas(cfg, world) == 1
          else 1)
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // world,
                               num_kv_heads=kv,
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


def is_kv_leaf(parent: str, name: str) -> bool:
    """The decoder attention's KV projections, whose columns are whole
    KV heads: under KV replication a rank keeps one head's."""
    return parent == "attn" and name in KV_NAMES


def _shard_leaf(parent: str, name: str, t: torch.Tensor, rank: int,
                world: int, kv_reps: int = 1) -> torch.Tensor:
    axis = shard_axis(parent, name)
    if axis is None:
        return t  # replicated
    if name in ROUTER_ROW_NAMES:
        half = t.shape[0] // 2  # rows [prefix ‖ suffix], q_dim each
        t = torch.cat([_piece(t[:half], 0, rank, world),
                       _piece(t[half:], 0, rank, world)])
    elif kv_reps > 1 and is_kv_leaf(parent, name):
        # one KV head of world / kv_reps, shared by kv_reps ranks
        t = _piece(t, t.dim() - 1, rank // kv_reps, world // kv_reps)
    else:
        t = _piece(t, axis % t.dim(), rank, world)
    # a copy of the rank's piece alone, so the whole weight can be freed
    return t.clone(memory_format=torch.contiguous_format)


def _walk(tree, rank: int, world: int, kv_reps: int = 1, parent: str = "",
          name: str = ""):
    if isinstance(tree, torch.Tensor):
        return _shard_leaf(parent, name, tree, rank, world, kv_reps)
    if isinstance(tree, dict):
        return {k: _walk(v, rank, world, kv_reps, name, k)
                for k, v in tree.items()}
    return [_walk(v, rank, world, kv_reps, parent, name) for v in tree]


def shard_params_tp(params: Dict[str, Any], cfg: ModelConfig, rank: int,
                    world: int) -> Dict[str, Any]:
    """Rank ``rank``'s share of the port's parameter dictionary (as
    ``init_params`` or ``bridge.params_from_jax`` give it), on the
    params' device: each sharded leaf's piece of its heads or FFN width
    along ``shard_axis`` (the router's ``enc_w`` rows of its heads from
    both pooling halves; under KV replication ``wk`` / ``wv``'s columns
    of the rank's one KV head), everything else shared with ``params``."""
    check_tp_supported(cfg, world)
    if world == 1:
        return params
    return _walk(params, rank, world, kv_replicas(cfg, world))


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
    sharded weight is 1/world as wide as ``cfg``'s: ``wo``'s rows are
    the rank's query heads', under KV replication too), and for a model
    with no sharded weight, whose share is the whole."""
    if world == 1:
        return True
    probe = _probe_width(params, cfg)
    return probe is None or probe[0] * world == probe[1]


def global_param_bytes(params: Dict[str, Any], cfg: ModelConfig,
                       world: int) -> int:
    """The bytes of the whole model behind one rank's share: its sharded
    leaves ``world`` times, its replicated ones once, and under KV
    replication its KV projections once a KV head (Hkv times: the whole
    holds each head once, not once a rank)."""
    kv_pieces = world // kv_replicas(cfg, world)

    def walk(tree, parent: str = "", name: str = "") -> int:
        if isinstance(tree, torch.Tensor):
            if shard_axis(parent, name) is None:
                return tree.nbytes
            return tree.nbytes * (kv_pieces if is_kv_leaf(parent, name)
                                  else world)
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
    reps = kv_replicas(cfg, world)
    return MD.init_params(cfg, gen, device, block_map=lambda bp: _walk(
        bp, rank, world, reps) if world > 1 else bp)
