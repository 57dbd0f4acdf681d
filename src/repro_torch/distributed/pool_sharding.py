"""Decode caches under tensor parallelism (the counterpart of
``repro/distributed/pool_sharding.py``).

Head sharding: a rank's ``FullKV`` / ``RingKV`` ``k`` / ``v`` (slots or
B, Hkv / world, S, D; under KV replication (slots or B, 1, S, D), the
one KV head its query heads read, the same on the world / Hkv ranks
that share it) hold the KV heads of its query heads, so each rank's
attention over its cache is complete for its heads and the cache never
moves; the only per-step collectives are the reduce points'
activation sums (``distributed/sharding.py``). Every other buffer is
replicated, the same on every rank: MLA's ``LatentKV`` / ``RingLatentKV``
(``ckv`` has no head axis; its R is the score product's contraction, so
sharding it would sum cache-sized scores every step), Mamba's
``MambaCache`` (its blocks are replicated), ``positions``, ``length``, a
slot pool's ``logits`` and ``pos``, which the scheduler reads on the
host.
A slot pool (``serve/slots.py`` ``SlotPool.create``) and a request's
caches (``serve/kv_cache.py`` ``init_decode_caches`` under
``sharding.tp_config``) are built in the local shape.

Sequence sharding (``distributed/decode.py``): a ``SeqShardKV``'s k, v
and positions hold 1/N of the whole cache's slots on each of its N
ranks, so the global figure counts them N times, each slot once.

The byte counts here are JAX's: a committed sharded ``jax.Array``
reports its global size, the logical array's, so the global figure
counts a head-sharded buffer once a distinct piece (``world`` times, or
Hkv times under KV replication, where world / Hkv ranks hold copies of
each piece) and a replicated one once, and the shard figure is what one
rank holds. The memory ledger and the prefix store's budget count the
global bytes, so the same budget keeps the same snapshots as on one
device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from repro_torch.serve import kv_cache as KC

# the cache fields with a (B, Hkv, S, D) layout: the only head-sharded ones
HEAD_SHARDED_FIELDS = ("k", "v")


@dataclass(frozen=True)
class CacheBytes:
    """Global and per-rank bytes of a cache list, split as ``KVStats``
    splits them: payload (k / v) and overhead (positions / length)."""
    payload: int
    overhead: int
    payload_shard: int
    overhead_shard: int


def head_sharded_bytes(caches: Sequence) -> int:
    """The bytes one rank holds of its caches' head-sharded buffers."""
    return sum(getattr(c, f).nbytes for c in caches
               if isinstance(c, (KC.FullKV, KC.RingKV))
               for f in HEAD_SHARDED_FIELDS)


def cache_bytes(caches: Sequence, world: int = 1,
                kv_replicas: int = 1) -> CacheBytes:
    """``CacheBytes`` of one rank's ``caches`` in a ``world``-way group
    whose KV heads are each held by ``kv_replicas`` ranks
    (``sharding.kv_replicas``): the global figures are the logical
    pool's, each KV head once (the head-sharded buffers world /
    kv_replicas times), everything else once; the shard figures are the
    bytes the rank holds. At world 1 global equals shard."""
    payload = KC.kv_cache_bytes(caches)
    total = sum(t.nbytes for c in caches for t in KC.cache_fields(c))
    extra = (world // kv_replicas - 1) * head_sharded_bytes(caches)
    # the other ranks' sequence shards: their slots, counted once each
    seq = [c for c in caches if isinstance(c, KC.SeqShardKV)]
    extra += sum((c.group.world - 1) * (c.k.nbytes + c.v.nbytes)
                 for c in seq)
    over = sum((c.group.world - 1) * c.positions.nbytes for c in seq)
    return CacheBytes(payload=payload + extra,
                      overhead=total - payload + over,
                      payload_shard=payload,
                      overhead_shard=total - payload)

