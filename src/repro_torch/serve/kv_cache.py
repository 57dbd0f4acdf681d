"""Decode-time caches (port of ``repro/serve/kv_cache.py``, its
whisper ``CrossKV`` aside).

FA layers keep the complete KV history (``FullKV``); SA layers keep only
the sink+local ring (``RingKV``), whose size is independent of the
context length, and a sliding-window ("local") layer a ``RingKV`` of
min(sliding_window, max_len) slots with no sink. MLA layers cache the
compressed latent and the one shared roped key instead of per-head K /
V, in the same two geometries (``LatentKV``, ``RingLatentKV``). Keys are
stored with RoPE already applied at absolute positions. A Mamba2 layer's
cache is its SSD state and conv tail (``MambaCache``), whose size is
independent of the position.

Unlike the JAX package, whose arrays are immutable, every insert here
writes into the cache's own buffers in place and returns the same cache:
a copy of a multi-GB decode cache per token would cost more than the
step itself. A single-token insert takes its position as a Python int
(every row at one position) or, in the continuous-batching slot pool, as
a (B,) int32 device tensor (one position per row, written by a scatter
at (arange(B), slot)). Neither reads the device.

A FA layer's cache can also be cut along its sequence axis over the
ranks of a group (``SeqShardKV``, JAX's ``cache_shardings`` at B = 1 with
``distributed_kv``): rank r holds slots [r·S/N, (r+1)·S/N) of the
capacity S, so no rank ever holds the whole cache. Its inserts and its
decode are in ``distributed/decode.py``. Only a GQA ``FullKV`` of at
least ``min_seq`` slots whose capacity the N ranks divide is cut
(``seq_shardable``, JAX's rule); rings, latents and Mamba states stay
whole on every rank.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, List, Sequence, Tuple

import torch

from repro_torch.configs.base import FluxConfig, ModelConfig


@dataclass
class FullKV:
    """Complete KV history, appended at ``length``."""
    k: torch.Tensor  # (B, Hkv, Smax, D)
    v: torch.Tensor  # (B, Hkv, Smax, D)
    length: torch.Tensor  # (B,) int32 — tokens currently valid


@dataclass
class SeqShardKV:
    """One rank's shard of a FullKV cut along the sequence axis over the
    ``group.world`` ranks of ``group``: slots [start, start + shard) of
    the capacity shard·world, ``positions`` their absolute positions (the
    decode kernel's (L,) vector). ``length`` is the whole cache's."""
    k: torch.Tensor  # (B, Hkv, shard, D)
    v: torch.Tensor  # (B, Hkv, shard, D)
    positions: torch.Tensor  # (shard,) int32: arange(start, start + shard)
    length: torch.Tensor  # (B,) int32 — tokens valid in the whole cache
    start: int = 0
    group: Any = field(default=None, repr=False, compare=False)


@dataclass
class RingKV:
    """Sink + local ring buffer (StreamingLLM geometry).

    Slots [0, sink) hold the attention-sink tokens; slots
    [sink, sink+local) are a ring over the most recent ``local``
    positions. ``positions`` records each slot's absolute position
    (-1 = empty) per batch row."""
    k: torch.Tensor  # (B, Hkv, sink+local, D)
    v: torch.Tensor
    positions: torch.Tensor  # (B, sink+local) int32
    length: torch.Tensor  # (B,) int32 — absolute position of next token


@dataclass
class LatentKV:
    """MLA: the compressed latent and the shared roped key, complete
    history."""
    ckv: torch.Tensor  # (B, Smax, R)
    kr: torch.Tensor   # (B, 1, Smax, rope)
    length: torch.Tensor  # (B,) int32


@dataclass
class RingLatentKV:
    """MLA's sink + local ring (the ``RingKV`` geometry over latents)."""
    ckv: torch.Tensor  # (B, ring, R)
    kr: torch.Tensor   # (B, 1, ring, rope)
    positions: torch.Tensor  # (B, ring) int32
    length: torch.Tensor  # (B,) int32


@dataclass
class MambaCache:
    """A Mamba2 layer's recurrent state: the SSD state and the last W-1
    conv inputs. It has no positions and no capacity."""
    h: torch.Tensor          # (B, H, P, N) f32 SSD state
    conv_tail: torch.Tensor  # (B, W-1, inner + 2N)


def mamba_update(cache: MambaCache, h: torch.Tensor,
                 conv_tail: torch.Tensor) -> MambaCache:
    """Write a chunk's or a decode step's new state into the cache's own
    buffers (a slot pool's rows stay the pool's; a snapshot that copied
    the old state keeps it)."""
    cache.h.copy_(h)
    cache.conv_tail.copy_(conv_tail)
    return cache


def ring_slot(pos, sink: int, local: int):
    """Absolute position → ring slot: for an int, or elementwise for a
    (B,) tensor."""
    if isinstance(pos, torch.Tensor):
        return torch.where(pos < sink, pos,
                           sink + torch.remainder(pos - sink, local))
    return pos if pos < sink else sink + (pos - sink) % local


def ring_insert(cache: RingKV, k_new: torch.Tensor, v_new: torch.Tensor,
                pos, sink: int, local: int) -> RingKV:
    """Insert one token (k_new/v_new (B, Hkv, 1, D)) at position ``pos``:
    an int shared by every row, or (B,) int32, one per row."""
    if isinstance(pos, torch.Tensor):  # per row: each writes its own slot
        b = torch.arange(k_new.shape[0], device=pos.device)
        slot = ring_slot(pos, sink, local).long()
        cache.k[b, :, slot] = k_new[:, :, 0]
        cache.v[b, :, slot] = v_new[:, :, 0]
        cache.positions[b, slot] = pos
        cache.length.copy_(pos + 1)
        return cache
    slot = ring_slot(pos, sink, local)
    cache.k[:, :, slot] = k_new[:, :, 0]
    cache.v[:, :, slot] = v_new[:, :, 0]
    cache.positions[:, slot] = pos
    cache.length.fill_(pos + 1)
    return cache


def full_insert(cache: FullKV, k_new: torch.Tensor, v_new: torch.Tensor,
                pos) -> FullKV:
    """Insert one token at position ``pos``.

    An int position is shared by every row and raises past the capacity
    (torch indexing does not clamp as ``dynamic_update_slice`` does). A
    (B,) int32 position is per row, and a row at or past the capacity
    keeps its buffers as they were, as JAX's scatter drops such a write:
    the slot pool decodes whole chunks, so a request that finishes
    inside its last chunk runs a few steps past the cache it was sized
    for, and nobody reads those steps. ``length`` records ``pos + 1``
    either way."""
    cap = cache.k.shape[2]
    if isinstance(pos, torch.Tensor):
        b = torch.arange(k_new.shape[0], device=pos.device)
        idx = pos.clamp(0, cap - 1).long()
        drop = ((pos < 0) | (pos >= cap))[:, None, None]
        cache.k[b, :, idx] = torch.where(drop, cache.k[b, :, idx],
                                         k_new[:, :, 0])
        cache.v[b, :, idx] = torch.where(drop, cache.v[b, :, idx],
                                         v_new[:, :, 0])
        cache.length.copy_(pos + 1)
        return cache
    if not 0 <= pos < cap:
        raise IndexError(f"full_insert: position {pos} outside the cache "
                         f"capacity {cap}")
    cache.k[:, :, pos] = k_new[:, :, 0]
    cache.v[:, :, pos] = v_new[:, :, 0]
    cache.length.fill_(pos + 1)
    return cache


def ring_latent_insert(cache: RingLatentKV, ckv_new: torch.Tensor,
                       kr_new: torch.Tensor, pos, sink: int,
                       local: int) -> RingLatentKV:
    """``ring_insert`` for a latent ring: ckv_new (B, 1, R), kr_new
    (B, 1, 1, rope)."""
    if isinstance(pos, torch.Tensor):
        b = torch.arange(ckv_new.shape[0], device=pos.device)
        slot = ring_slot(pos, sink, local).long()
        cache.ckv[b, slot] = ckv_new[:, 0]
        cache.kr[b, :, slot] = kr_new[:, :, 0]
        cache.positions[b, slot] = pos
        cache.length.copy_(pos + 1)
        return cache
    slot = ring_slot(pos, sink, local)
    cache.ckv[:, slot] = ckv_new[:, 0]
    cache.kr[:, :, slot] = kr_new[:, :, 0]
    cache.positions[:, slot] = pos
    cache.length.fill_(pos + 1)
    return cache


def latent_insert(cache: LatentKV, ckv_new: torch.Tensor,
                  kr_new: torch.Tensor, pos) -> LatentKV:
    """``full_insert`` for a latent cache, with its capacity rules: an int
    position raises past the capacity, a per-row write past it is
    dropped."""
    cap = cache.ckv.shape[1]
    if isinstance(pos, torch.Tensor):
        b = torch.arange(ckv_new.shape[0], device=pos.device)
        idx = pos.clamp(0, cap - 1).long()
        drop = (pos < 0) | (pos >= cap)
        cache.ckv[b, idx] = torch.where(drop[:, None], cache.ckv[b, idx],
                                        ckv_new[:, 0])
        cache.kr[b, :, idx] = torch.where(drop[:, None, None],
                                          cache.kr[b, :, idx],
                                          kr_new[:, :, 0])
        cache.length.copy_(pos + 1)
        return cache
    if not 0 <= pos < cap:
        raise IndexError(f"latent_insert: position {pos} outside the cache "
                         f"capacity {cap}")
    cache.ckv[:, pos] = ckv_new[:, 0]
    cache.kr[:, :, pos] = kr_new[:, :, 0]
    cache.length.fill_(pos + 1)
    return cache


def _ring_chunk_sources(start: int, C: int, sink: int, local: int,
                        device=None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ring occupancy after inserting positions [start, start+C).

    Per buffer slot, the *latest* inserted position that lands in it (a
    chunk longer than ``local`` wraps). Returns (src (ring,), pos (ring,)
    int32, valid (ring,) bool): the chunk index to gather from, the
    absolute position it carries, and whether the slot is written."""
    ring = sink + local
    s = torch.arange(ring, device=device)
    e = start + C - 1  # last inserted position
    sink_valid = (s < sink) & (s >= start) & (s <= e)
    r = s - sink
    q = e - sink
    p = sink + q - torch.remainder(q - r, local)
    loc_valid = (s >= sink) & (e >= sink) & (p >= start) & (p >= sink)
    src = torch.where(s < sink, s, p) - start
    pos = torch.where(s < sink, s, p)
    valid = torch.where(s < sink, sink_valid, loc_valid)
    return src, pos.to(torch.int32), valid


def ring_insert_chunk(cache: RingKV, k_new: torch.Tensor,
                      v_new: torch.Tensor, start: int, sink: int,
                      local: int) -> RingKV:
    """Insert C tokens (k_new/v_new (B, Hkv, C, D)) at [start, start+C)."""
    C = k_new.shape[2]
    src, pos, valid = _ring_chunk_sources(start, C, sink, local,
                                          k_new.device)
    idx = src.clamp(0, C - 1)
    m = valid[None, None, :, None]
    cache.k.copy_(torch.where(m, k_new.index_select(2, idx), cache.k))
    cache.v.copy_(torch.where(m, v_new.index_select(2, idx), cache.v))
    cache.positions.copy_(torch.where(valid[None, :], pos[None, :],
                                      cache.positions))
    cache.length.fill_(start + C)
    return cache


def full_insert_chunk(cache: FullKV, k_new: torch.Tensor,
                      v_new: torch.Tensor, start: int) -> FullKV:
    """Insert C tokens at [start, start+C); raises past the capacity."""
    C, cap = k_new.shape[2], cache.k.shape[2]
    if start < 0 or start + C > cap:
        raise IndexError(f"full_insert_chunk: positions [{start}, "
                         f"{start + C}) outside the cache capacity {cap}")
    cache.k[:, :, start:start + C] = k_new
    cache.v[:, :, start:start + C] = v_new
    cache.length.fill_(start + C)
    return cache


def ring_latent_insert_chunk(cache: RingLatentKV, ckv_new: torch.Tensor,
                             kr_new: torch.Tensor, start: int, sink: int,
                             local: int) -> RingLatentKV:
    """Insert C latents (ckv_new (B, C, R), kr_new (B, 1, C, rope)) at
    [start, start+C)."""
    C = ckv_new.shape[1]
    src, pos, valid = _ring_chunk_sources(start, C, sink, local,
                                          ckv_new.device)
    idx = src.clamp(0, C - 1)
    cache.ckv.copy_(torch.where(valid[None, :, None],
                                ckv_new.index_select(1, idx), cache.ckv))
    cache.kr.copy_(torch.where(valid[None, None, :, None],
                               kr_new.index_select(2, idx), cache.kr))
    cache.positions.copy_(torch.where(valid[None, :], pos[None, :],
                                      cache.positions))
    cache.length.fill_(start + C)
    return cache


def latent_insert_chunk(cache: LatentKV, ckv_new: torch.Tensor,
                        kr_new: torch.Tensor, start: int) -> LatentKV:
    """Insert C latents at [start, start+C); raises past the capacity."""
    C, cap = ckv_new.shape[1], cache.ckv.shape[1]
    if start < 0 or start + C > cap:
        raise IndexError(f"latent_insert_chunk: positions [{start}, "
                         f"{start + C}) outside the cache capacity {cap}")
    cache.ckv[:, start:start + C] = ckv_new
    cache.kr[:, :, start:start + C] = kr_new
    cache.length.fill_(start + C)
    return cache


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------

# a cache type's buffer names in the JAX package's leaf order (its
# constructor takes them in this order)
_FIELDS = {FullKV: ("k", "v", "length"),
           SeqShardKV: ("k", "v", "positions", "length"),
           RingKV: ("k", "v", "positions", "length"),
           LatentKV: ("ckv", "kr", "length"),
           RingLatentKV: ("ckv", "kr", "positions", "length"),
           MambaCache: ("h", "conv_tail")}
# the payload among them (KV, latents, SSD state); ``positions`` /
# ``length`` are bookkeeping
_PAYLOAD = ("k", "v", "ckv", "kr", "h", "conv_tail")


def cache_fields(cache) -> Tuple[torch.Tensor, ...]:
    """A cache's buffers in the JAX package's leaf order."""
    return tuple(getattr(cache, f) for f in _FIELDS[type(cache)])


def is_ring(cache) -> bool:
    """True for the sink + local geometries (``RingKV``, ``RingLatentKV``)."""
    return isinstance(cache, (RingKV, RingLatentKV))


def capacity(cache) -> int:
    """The token slots of a cache's buffers (its ring size for a ring);
    a ``MambaCache`` has none and raises."""
    if isinstance(cache, MambaCache):
        raise TypeError("capacity: a MambaCache holds a recurrent state, "
                        "not token slots")
    if is_ring(cache):
        return cache.positions.shape[1]
    if isinstance(cache, SeqShardKV):  # the whole cache's
        return cache.k.shape[2] * cache.group.world
    return (cache.k.shape[2] if isinstance(cache, FullKV)
            else cache.ckv.shape[1])


def map_buffers(caches: Sequence, fn) -> List:
    """A new cache list whose every buffer is ``fn`` of the old one (a
    shard keeps its place and group)."""
    return [dataclasses.replace(c, **{f: fn(getattr(c, f))
                                      for f in _FIELDS[type(c)]})
            for c in caches]


def cache_geometry(caches: Sequence, lead: int = 0) -> Tuple:
    """Hashable per-layer geometry signature of a decode-cache list: the
    cache type and each buffer's shape (from axis ``lead`` on) and dtype
    name, spelled as the JAX package spells them (so the two packages'
    signatures compare)."""
    return tuple((type(c).__name__,)
                 + tuple((tuple(a.shape[lead:]), str(a.dtype).split(".")[-1])
                         for a in cache_fields(c))
                 for c in caches)


def slot_geometry(caches: Sequence) -> Tuple:
    """``cache_geometry`` without the leading batch/slot axis: a B = 1
    request and a slot pool that can hold it have the same slot
    geometry. The scheduler keys its pools on it."""
    return cache_geometry(caches, lead=1)


def kv_cache_bytes(caches: Sequence) -> int:
    """*Payload* bytes (k and v, ckv and kr, a Mamba layer's h and conv
    tail); ``positions`` / ``length`` are bookkeeping and not counted, as
    in the JAX package."""
    return sum(getattr(c, f).nbytes for c in caches
               for f in _FIELDS[type(c)] if f in _PAYLOAD)


def ring_size(flux: FluxConfig) -> int:
    return flux.sink + flux.local


def sa_ring(flux: FluxConfig, max_len: int) -> Tuple[int, int]:
    """(ring, sink) geometry of an SA decode cache under a ``max_len``
    capacity cap. The ring must keep at least one local slot beyond the
    sink."""
    ring = min(ring_size(flux), max_len)
    if ring <= flux.sink:
        raise ValueError(
            f"max_len={max_len} leaves no local slots beyond the "
            f"sink ({flux.sink}); raise max_len or shrink flux.sink")
    return ring, flux.sink


# the shortest cache JAX's distributed decode shards (its adapters'
# ``min_seq``): shorter ones, rings among them, stay whole on every rank
MIN_SEQ = 8192


def seq_shardable(capacity: int, world: int, min_seq: int = MIN_SEQ) -> bool:
    """Whether a full cache of ``capacity`` slots is cut over ``world``
    ranks: more than one rank, at least ``min_seq`` slots, and a capacity
    the ranks divide (``repro/launch/shardings.py`` ``cache_shardings``)."""
    return world > 1 and capacity >= min_seq and capacity % world == 0


def seq_shard_range(capacity: int, world: int, rank: int) -> Tuple[int, int]:
    """[start, end) of the slots rank ``rank`` of ``world`` holds of a
    ``capacity``-slot cache cut along its sequence axis."""
    if world < 1 or capacity % world or not 0 <= rank < world:
        raise ValueError(f"seq_shard_range: {capacity} slots over {world} "
                         f"ranks (rank {rank}): the ranks must divide them")
    shard = capacity // world
    return rank * shard, (rank + 1) * shard


def init_layer_cache(cfg: ModelConfig, kind: str, mode: str, batch: int,
                     max_len: int, device, dtype=None, seq_shard=None,
                     min_seq: int = MIN_SEQ):
    """Fresh (empty) cache for one layer; mode ∈ {"fa", "sa"} for an
    attention layer (not read for a local or a Mamba layer). An MLA
    model's layers cache latents (``LatentKV`` / ``RingLatentKV``), a
    local layer a ``RingKV`` of min(sliding_window, max_len) slots with
    no sink, a Mamba layer a zero ``MambaCache``. With ``seq_shard`` (a
    ``TPGroup``), a GQA FA layer's cache that ``seq_shardable`` admits is
    this rank's ``SeqShardKV``."""
    if max_len <= 0:
        raise ValueError(f"init_layer_cache: max_len={max_len} must be "
                         f"positive")
    dtype = dtype or cfg.dtype
    if kind == "mamba":
        return MambaCache(
            h=torch.zeros((batch, cfg.ssm_num_heads, cfg.ssm_head_dim,
                           cfg.ssm_state_dim), dtype=torch.float32,
                          device=device),
            conv_tail=torch.zeros(
                (batch, cfg.ssm_conv_width - 1,
                 cfg.ssm_inner + 2 * cfg.ssm_state_dim), dtype=dtype,
                device=device))
    H, D = cfg.num_kv_heads, cfg.head_dim
    length = torch.zeros((batch,), dtype=torch.int32, device=device)
    if kind == "local":
        L = min(cfg.sliding_window, max_len)
        return RingKV(
            k=torch.zeros((batch, H, L, D), dtype=dtype, device=device),
            v=torch.zeros((batch, H, L, D), dtype=dtype, device=device),
            positions=torch.full((batch, L), -1, dtype=torch.int32,
                                 device=device),
            length=length)
    if kind != "attn":
        raise ValueError(f"init_layer_cache: unknown layer kind {kind!r}")
    if cfg.use_mla:
        R, rope = cfg.kv_lora_rank, cfg.qk_rope_head_dim
        L = sa_ring(cfg.flux, max_len)[0] if mode == "sa" else max_len
        ckv = torch.zeros((batch, L, R), dtype=dtype, device=device)
        kr = torch.zeros((batch, 1, L, rope), dtype=dtype, device=device)
        if mode == "sa":
            return RingLatentKV(
                ckv=ckv, kr=kr,
                positions=torch.full((batch, L), -1, dtype=torch.int32,
                                     device=device),
                length=length)
        return LatentKV(ckv=ckv, kr=kr, length=length)
    if mode == "sa":
        L, _ = sa_ring(cfg.flux, max_len)
        return RingKV(
            k=torch.zeros((batch, H, L, D), dtype=dtype, device=device),
            v=torch.zeros((batch, H, L, D), dtype=dtype, device=device),
            positions=torch.full((batch, L), -1, dtype=torch.int32,
                                 device=device),
            length=length)
    if seq_shard is not None and seq_shardable(max_len, seq_shard.world,
                                               min_seq):
        start, end = seq_shard_range(max_len, seq_shard.world,
                                     seq_shard.rank)
        return SeqShardKV(
            k=torch.zeros((batch, H, end - start, D), dtype=dtype,
                          device=device),
            v=torch.zeros((batch, H, end - start, D), dtype=dtype,
                          device=device),
            positions=torch.arange(start, end, dtype=torch.int32,
                                   device=device),
            length=length, start=start, group=seq_shard)
    return FullKV(
        k=torch.zeros((batch, H, max_len, D), dtype=dtype, device=device),
        v=torch.zeros((batch, H, max_len, D), dtype=dtype, device=device),
        length=length)


def init_decode_caches(cfg: ModelConfig, routing: Tuple[str, ...],
                       batch: int, max_len: int, device, seq_shard=None,
                       min_seq: int = MIN_SEQ) -> List:
    """Per-layer cache list for a static routing pattern
    (routing[i] ∈ {"fa", "sa"} at an attention layer; a local or a Mamba
    layer's entry is not read); ``seq_shard`` / ``min_seq`` as
    ``init_layer_cache`` takes them."""
    return [init_layer_cache(cfg, kind, routing[i], batch, max_len, device,
                             seq_shard=seq_shard, min_seq=min_seq)
            for i, kind in enumerate(cfg.layer_kinds)]
