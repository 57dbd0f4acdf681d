"""Slot-pool decode state for continuous batching (port of
``repro/serve/slots.py``).

A ``SlotPool`` is the device half of the continuous-batching scheduler:
one batched decode-cache list whose leading axis is *slots*, plus the
per-slot last logits and per-slot absolute positions. A request joins by
having its B = 1 decode caches copied into a free slot row (``write``)
and leaves by being marked free; the row's stale state is overwritten by
the next admission, and free rows decode garbage that nobody reads
(parked at position 0, their masks stay self-consistent and their logits
finite).

Every pool holds exactly one cache geometry (the per-layer FullKV/RingKV
buffer shapes the routing pattern dictates), so requests of different
lengths and depths share one decode batch through per-slot positions,
lengths and RoPE angles. Unlike the JAX package, ``write`` copies into
the pool's buffers in place.

The pool also carries what the serving guardrails and telemetry read:
its byte split for the memory ledger (per slot row, fixed at
``create``) and ``poison_slot``,
the fault-injection hook behind ``ServeEngine.inject_fault``.

Under ``world``-way tensor parallelism a pool holds one rank's share:
``create`` builds its caches from ``sharding.tp_config`` (k / v hold the
rank's KV heads; positions, lengths, logits and pos are replicated,
``distributed/pool_sharding.py``), and its ledger bytes are global.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import pool_sharding as PSH
from repro_torch.distributed.sharding import kv_replicas, tp_config
from repro_torch.serve import kv_cache as KC


@dataclass
class SlotPool:
    """Fixed-capacity batched decode state for one cache geometry."""

    caches: List[Any]         # per-layer caches, leading axis = slots
    logits: torch.Tensor      # (capacity, V) last logits per slot
    pos: torch.Tensor         # (capacity,) int32 next absolute position
    pattern: Tuple[Any, ...]  # representative routing pattern
    capacity: int
    free: List[int] = field(default_factory=list)
    active: Dict[int, Any] = field(default_factory=dict)  # slot → request
    steps: int = 0            # decode steps run over the pool's lifetime
    # byte accounting for the memory ledger (telemetry.PoolLedgerEntry),
    # fixed at create() from the buffers' shapes: ``slot_*`` per slot
    # row (global under tensor parallelism), ``aux_bytes`` the pool's
    # logits and pos, which ``kv_cache_stats`` never sees
    slot_payload_bytes: int = 0
    slot_overhead_bytes: int = 0
    aux_bytes: int = 0

    @classmethod
    def create(cls, cfg: ModelConfig, pattern, capacity: int, max_len: int,
               logits_like: torch.Tensor, world: int = 1) -> "SlotPool":
        """An empty pool for ``pattern``; ``cfg`` the whole model's, the
        caches one rank's share of ``world``."""
        dev = logits_like.device
        caches = KC.init_decode_caches(tp_config(cfg, world), pattern,
                                       capacity, max_len, dev)
        logits = torch.zeros((capacity,) + tuple(logits_like.shape[1:]),
                             dtype=logits_like.dtype, device=dev)
        pos = torch.zeros((capacity,), dtype=torch.int32, device=dev)
        # every buffer's leading axis is ``capacity``, so the division is
        # exact: the ledger's slot bytes reconcile with kv_cache_stats to
        # the byte at any occupancy
        b = PSH.cache_bytes(caches, world, kv_replicas(cfg, world))
        return cls(
            caches=caches, logits=logits, pos=pos,
            pattern=pattern, capacity=capacity,
            free=list(range(capacity - 1, -1, -1)),  # pop() → slot 0 first
            slot_payload_bytes=b.payload // capacity,
            slot_overhead_bytes=b.overhead // capacity,
            aux_bytes=logits.nbytes + pos.nbytes)

    def geometry(self) -> Tuple:
        return KC.cache_geometry(self.caches)

    def slot_geometry(self) -> Tuple:
        return KC.slot_geometry(self.caches)

    def occupancy(self) -> int:
        """Resident slots: the pool's decode batch."""
        return len(self.active)

    def write(self, slot: int, req_caches, req_logits: torch.Tensor,
              seq_len: int) -> None:
        """Admit a B = 1 request into row ``slot``, in place."""
        if KC.slot_geometry(req_caches) != self.slot_geometry():
            raise ValueError(
                "slot-pool geometry mismatch: admission must bucket "
                "requests by cache geometry before packing them")
        for pool_c, one_c in zip(self.caches, req_caches):
            for dst, src in zip(KC.cache_fields(pool_c),
                                KC.cache_fields(one_c)):
                dst[slot].copy_(src[0])
        self.logits[slot].copy_(req_logits[0])
        self.pos[slot].fill_(seq_len)

    def poison_slot(self, slot: int) -> None:
        """Fault-injection hook: overwrite row ``slot`` of every
        floating-point cache buffer, and its last-logits row, with NaN,
        in place: the persistent shape of a real fault (a poisoned KV row
        keeps giving non-finite logits every step, so the scheduler's
        per-tick sentinel is sure to see it). Integer bookkeeping
        (``positions`` / ``length``) is left intact, so the faulted row
        keeps decoding self-consistent garbage and its siblings see the
        shapes and masks of an unfaulted run. The next admission's
        ``write`` copies every buffer of the row, so a quarantined slot
        is safe to reuse."""
        for c in self.caches:
            for t in KC.cache_fields(c):
                if t.is_floating_point():
                    t[slot].fill_(float("nan"))
        self.logits[slot].fill_(float("nan"))

    def advance(self, steps: int) -> None:
        """Advance active rows by ``steps`` decode positions; park free
        rows at 0 so their garbage decode never runs past the buffers."""
        self.steps += steps
        active = torch.zeros((self.capacity,), dtype=torch.bool)
        active[list(self.active)] = True
        self.pos = torch.where(active.to(self.pos.device), self.pos + steps,
                               torch.zeros_like(self.pos))
