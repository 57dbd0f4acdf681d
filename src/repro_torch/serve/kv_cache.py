"""Decode-time KV caches (port of the ``FullKV``/``RingKV`` half of
``repro/serve/kv_cache.py``).

FA layers keep the complete KV history (``FullKV``); SA layers keep only
the sink+local ring (``RingKV``), whose size is independent of the
context length. Keys are stored with RoPE already applied at absolute
positions.

Unlike the JAX package, whose arrays are immutable, every insert here
writes into the cache's own buffers in place and returns the same cache:
a copy of a multi-GB decode cache per token would cost more than the
step itself. A single-token insert takes its position as a Python int
(every row at one position) or, in the continuous-batching slot pool, as
a (B,) int32 device tensor (one position per row, written by a scatter
at (arange(B), slot)). Neither reads the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from repro_torch.configs.base import FluxConfig, ModelConfig


@dataclass
class FullKV:
    """Complete KV history, appended at ``length``."""
    k: torch.Tensor  # (B, Hkv, Smax, D)
    v: torch.Tensor  # (B, Hkv, Smax, D)
    length: torch.Tensor  # (B,) int32 — tokens currently valid


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


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------

def cache_fields(cache) -> Tuple[torch.Tensor, ...]:
    """A cache's buffers in the JAX package's leaf order."""
    if isinstance(cache, RingKV):
        return cache.k, cache.v, cache.positions, cache.length
    return cache.k, cache.v, cache.length


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
    """KV *payload* bytes (k and v); ``positions``/``length`` are
    bookkeeping and not counted, as in the JAX package."""
    return sum(c.k.nbytes + c.v.nbytes for c in caches)


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


def init_layer_cache(cfg: ModelConfig, kind: str, mode: str, batch: int,
                     max_len: int, device, dtype=None):
    """Fresh (empty) cache for one layer; mode ∈ {"fa", "sa"}."""
    if max_len <= 0:
        raise ValueError(f"init_layer_cache: max_len={max_len} must be "
                         f"positive")
    if kind != "attn":
        raise NotImplementedError(
            f"layer kind {kind!r}: this slice caches global attention "
            f"layers only; local and mamba layers wait for ROADMAP "
            f"Queue 1 items 14 and 12")
    dtype = dtype or cfg.dtype
    H, D = cfg.num_kv_heads, cfg.head_dim
    length = torch.zeros((batch,), dtype=torch.int32, device=device)
    if mode == "sa":
        L, _ = sa_ring(cfg.flux, max_len)
        return RingKV(
            k=torch.zeros((batch, H, L, D), dtype=dtype, device=device),
            v=torch.zeros((batch, H, L, D), dtype=dtype, device=device),
            positions=torch.full((batch, L), -1, dtype=torch.int32,
                                 device=device),
            length=length)
    return FullKV(
        k=torch.zeros((batch, H, max_len, D), dtype=dtype, device=device),
        v=torch.zeros((batch, H, max_len, D), dtype=dtype, device=device),
        length=length)


def init_decode_caches(cfg: ModelConfig, routing: Tuple[str, ...],
                       batch: int, max_len: int, device) -> List:
    """Per-layer cache list for a static routing pattern
    (routing[i] ∈ {"fa", "sa"})."""
    return [init_layer_cache(cfg, kind, routing[i], batch, max_len, device)
            for i, kind in enumerate(cfg.layer_kinds)]
