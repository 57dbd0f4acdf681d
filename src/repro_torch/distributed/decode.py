"""Attention over a sequence-sharded KV cache (the port of
``repro/distributed/decode.py``).

At B = 1 and a long context (``long_500k``: a 524,288-token cache) the
batch axis cannot cover the ranks, so a FA layer's cache is cut along
its sequence axis (``serve/kv_cache.py`` ``SeqShardKV``): rank r holds
slots [r·S/N, (r+1)·S/N). Every rank runs the whole model on the same
tokens with whole weights; only these caches are cut.

- Decode (``lse_combine_decode``): each rank attends its shard with the
  decode kernel's partial state (``kernels/decode_attention_partial``:
  its normalized output and base-2 log-sum-exp), the ranks' states are
  gathered once, B·Hq·(D + 1) fp32 a rank, and merged by their
  log-sum-exps (``kernels/decode_merge_ranks``). One collective a layer
  a step, O(H·D) bytes, where JAX's shard_map runs three (a ``pmax`` and
  two ``psum``); none of it is O(S·D).
- Inserts (``sharded_seq_insert``, ``sharded_seq_insert_chunk``): each
  rank writes the part of a token or chunk that falls in its range, with
  no collective; a position past the capacity raises IndexError, as
  ``full_insert`` / ``full_insert_chunk`` do.
- The chunked prefill (``gather_prefix``): a chunk's causal attention
  needs every key before it, so the live prefix [0, start) is gathered
  into a transient buffer beside the chunk's own keys, one broadcast of
  k and one of v from each rank that holds a live part, and the chunk
  runs on the block-sparse kernel over it, as on one device. JAX's XLA
  gathers the shards there too. The buffer is freed with the layer.

JAX's adapters decline a short cache or a per-slot mask at every call
(``make_distributed_dot_decode``); here the cache's type decides, once,
when it is built (``kv_cache.seq_shardable``), and the slot pool, which
batches short requests, never holds a sharded cache.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.decode_attention_partial import \
    decode_attention_partial_bh
from repro_torch.kernels.decode_merge_ranks import decode_merge_ranks_bh
from repro_torch.serve import kv_cache as KC
from repro_torch.serve.kv_cache import (SeqShardKV,  # noqa: F401
                                        seq_shard_range)


def _shard(cache: SeqShardKV) -> int:
    return cache.k.shape[2]


def sharded_seq_insert(cache: SeqShardKV, k_new: torch.Tensor,
                       v_new: torch.Tensor, pos: int) -> SeqShardKV:
    """Insert one token (k_new / v_new (B, Hkv, 1, D)) at position ``pos``,
    an int shared by every row: the rank whose range holds it writes it,
    every rank records ``length`` pos + 1. Raises IndexError past the
    capacity."""
    if isinstance(pos, torch.Tensor):
        raise TypeError("sharded_seq_insert: a sequence-sharded cache "
                        "takes one position shared by every row (the slot "
                        "pool's per-row positions are not sharded)")
    cap = KC.capacity(cache)
    if not 0 <= pos < cap:
        raise IndexError(f"sharded_seq_insert: position {pos} outside the "
                         f"cache capacity {cap}")
    local = pos - cache.start
    if 0 <= local < _shard(cache):
        cache.k[:, :, local] = k_new[:, :, 0]
        cache.v[:, :, local] = v_new[:, :, 0]
    cache.length.fill_(pos + 1)
    return cache


def sharded_seq_insert_chunk(cache: SeqShardKV, k_new: torch.Tensor,
                             v_new: torch.Tensor, start: int) -> SeqShardKV:
    """Insert C tokens at [start, start+C), which may straddle shard
    boundaries: each rank writes the part in its range. Raises IndexError
    past the capacity."""
    C, cap = k_new.shape[2], KC.capacity(cache)
    if start < 0 or start + C > cap:
        raise IndexError(f"sharded_seq_insert_chunk: positions [{start}, "
                         f"{start + C}) outside the cache capacity {cap}")
    lo = max(start, cache.start)
    hi = min(start + C, cache.start + _shard(cache))
    if lo < hi:
        cache.k[:, :, lo - cache.start:hi - cache.start] = \
            k_new[:, :, lo - start:hi - start]
        cache.v[:, :, lo - cache.start:hi - cache.start] = \
            v_new[:, :, lo - start:hi - start]
    cache.length.fill_(start + C)
    return cache


def gather_prefix(cache: SeqShardKV, start: int, k_new: torch.Tensor,
                  v_new: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The keys and values of positions [0, start + C) on every rank, (B,
    Hkv, start + C, D) each: [0, start) from the ranks that hold them, one
    broadcast of k and one of v from each rank with a live part (rank r
    sends its first min(shard, start - r·shard) slots), and the chunk's
    own [start, start + C) from k_new / v_new, which every rank computed.
    A transient buffer of the live prefix; the cache is not changed."""
    group, shard = cache.group, _shard(cache)
    B, H, C, D = k_new.shape
    out = []
    for cached, new in ((cache.k, k_new), (cache.v, v_new)):
        buf = torch.empty((B, H, start + C, D), dtype=new.dtype,
                          device=new.device)
        buf[:, :, start:] = new
        for r in range(-(-start // shard)):
            n = min(shard, start - r * shard)
            if r == group.rank:
                part = cached if n == shard else \
                    cached[:, :, :n].contiguous()
            else:
                part = torch.empty((B, H, n, D), dtype=new.dtype,
                                   device=new.device)
            group.broadcast(part, r)
            buf[:, :, r * shard:r * shard + n] = part
        out.append(buf)
    return out[0], out[1]


def lse_combine_decode(q: torch.Tensor, cache: SeqShardKV, pos: int,
                       scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, 1, D), every rank's the same; ``cache`` this rank's
    shard, with the token at ``pos`` already inserted. Returns the exact
    softmax attention of q over the whole cache's positions [0, pos],
    (B, Hq, 1, D) in q's dtype, on every rank: this rank's partial state
    on the decode kernel, one gather of every rank's (o ‖ lse), B·Hq·(D +
    1) fp32, and their merge."""
    B, Hq, _, D = q.shape
    Hkv, L = cache.k.shape[1], _shard(cache)
    BH = B * Hq
    buf = torch.empty(BH * (D + 1), dtype=torch.float32, device=q.device)
    decode_attention_partial_bh(
        q.reshape(BH, 1, D), cache.k.reshape(B * Hkv, L, D),
        cache.v.reshape(B * Hkv, L, D), cache.positions, pos, scale=scale,
        out=(buf[:BH * D].view(BH, D), buf[BH * D:]))
    parts = cache.group.all_gather(buf)
    o = decode_merge_ranks_bh(parts[:, :BH * D].view(-1, BH, D),
                              parts[:, BH * D:], q.dtype)
    return o.reshape(B, Hq, 1, D)
