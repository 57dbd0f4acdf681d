"""Shared-prefix radix cache: chunk-boundary snapshot reuse for admission
(port of ``repro/serve/prefix_cache.py``).

Prompt traffic is dominated by shared prefixes (system preambles,
few-shot scaffolds, multi-turn histories), yet a cold admission streams
the whole prompt through the chunked prefill. With prefix-only router
pooling (``routing_ctx="hard_prefix"``) two requests that share the first
``pool_size`` tokens share their routing decision and so their cache
geometry, so a cached prefix state is reusable across requests; and since
the ring state is part of the snapshot, reuse stays exact at SA layers.

The store is a radix tree over token ids at chunk-plan boundaries: every
edge is exactly one full prefill chunk, so two prompts sharing k·chunk
tokens share the first k nodes of a path. Those are the boundaries where
the chunked admission (``engine.ChunkedPrefill``) has a complete state:
the per-layer decode caches (FullKV / RingKV with their ring
``positions``), the boundary's last-token logits and the frozen routing
pattern. A node holds that state as a :class:`Snapshot`; matching a
prompt walks full-chunk edges and returns the deepest snapshot-bearing
node, turning prefill work from O(prompt) into O(unique suffix).

Memory policy: snapshots are refcounted (``acquire`` / ``release`` pin a
node against eviction while an admission restores from it) and live in
two byte-budgeted tiers, the device under ``budget_bytes`` and an
optional host tier under ``host_budget_bytes``. Going over the device
budget demotes the least recently used unpinned snapshot to the host
when that tier is enabled, else drops it; host overflow drops. A CUDA
snapshot demotes into pinned CPU tensors (raising if pinning fails); a
snapshot already on the CPU, as in the tests, demotes into fresh CPU
copies, with the same byte accounting. A hit on a host-resident node is
copied back to the device by the engine and promoted. Evicted nodes stay
in the tree as pass-throughs so deeper snapshots remain reachable; empty
leaves are pruned.

The store holds one radix tree per routing key: router-driven admissions
share one tree (same weights, same prefix-pooled decisions), while each
``routing_override`` pattern gets its own.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import pool_sharding as PSH
from repro_torch.serve import kv_cache as KC


def routing_key(override, sa_level: int = 0) -> Tuple:
    """Radix-tree namespace for an admission's routing source.

    Router-driven admissions (``override is None``) share one tree per
    load-adaptive sparsity rung ``sa_level`` (``serve/slo.py``): a rung
    moves the FA-decision threshold, so decisions taken at one rung do
    not transfer to another, and a warm snapshot must never hand a
    pressured admission the relaxed rung's pattern (or the reverse).
    Every forced pattern gets its own tree and ignores the dial, so a
    snapshot taken under one override is never offered to a request
    running another. ``router.prefix_routing_reusable`` guards the
    router trees."""
    if override is not None:
        return ("override", tuple(override))
    return ("router", int(sa_level))


def state_bytes(caches, logits: torch.Tensor, world: int = 1,
                kv_replicas: int = 1) -> int:
    """Bytes of one boundary state (every cache buffer and the logits).
    Under ``world``-way tensor parallelism ``caches`` are one rank's
    share and the count is global, as a sharded JAX array reports it
    (each KV head once, ``PSH.cache_bytes``), so the same budget keeps
    the same snapshots as on one device."""
    b = PSH.cache_bytes(caches, world, kv_replicas)
    return b.payload + b.overhead + logits.nbytes


def snapshot_spec_bytes(cfg: ModelConfig, pattern, max_len: int) -> int:
    """Bytes of one boundary snapshot for ``pattern``, from ``meta``
    tensors only, so validating a budget allocates nothing."""
    spec = KC.init_decode_caches(cfg, pattern, 1, max_len, "meta")
    n = sum(t.nbytes for c in spec for t in KC.cache_fields(c))
    return n + cfg.vocab_size * cfg.dtype.itemsize


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``: pinned when it lies on the card (the copy is
    synchronous, so the device tensor may be released at once), a plain
    clone when it is already on the CPU."""
    if t.device.type != "cuda":
        return t.clone()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    if not host.is_pinned():
        raise RuntimeError(
            f"PrefixStore: could not pin {t.nbytes} bytes of host memory "
            f"for a demoted snapshot; lower prefix_cache_host_mb")
    host.copy_(t)
    return host


def host_state(caches, logits: torch.Tensor):
    """A snapshot's buffers copied to the host tier (``_host_copy``)."""
    return KC.map_buffers(caches, _host_copy), _host_copy(logits)


def device_state(caches, logits: torch.Tensor, device):
    """Fresh copies of a snapshot's buffers on ``device``: a host-tier
    hit's prefetch (synchronous from pinned memory)."""
    def copy(t):
        return t.to(device, copy=True)
    return KC.map_buffers(caches, copy), copy(logits)


@dataclass
class Snapshot:
    """Admission state at one chunk boundary, never written after it is
    made.

    ``caches`` is the B = 1 per-layer decode-cache list as
    ``ChunkedPrefill`` carries it: restoring is a bitwise copy into fresh
    buffers and streaming the uncovered suffix; nothing is repacked or
    re-routed on the hit path."""
    caches: List[Any]             # per-layer caches, B = 1
    logits: torch.Tensor          # (1, V) last-token logits at boundary
    pattern: Tuple[Any, ...]      # frozen per-layer routing pattern
    p_fa: Optional[np.ndarray]    # router probabilities (metrics only)
    boundary: int                 # prompt tokens covered
    nbytes: int                   # buffer bytes (device or host tier)


@dataclass
class _Node:
    """One radix node = one chunk boundary of some published prompt."""
    depth: int                    # tokens covered by the path to here
    parent: Optional["_Node"] = None
    edge: Optional[bytes] = None  # key in parent.children
    children: Dict[bytes, "_Node"] = field(default_factory=dict)
    snap: Optional[Snapshot] = None
    on_host: bool = False
    refs: int = 0                 # in-use pins; evictable iff 0


@dataclass
class PrefixStoreStats:
    device_bytes: int
    host_bytes: int
    snapshots: int
    nodes: int
    hits: int
    misses: int
    hit_tokens: int
    inserts: int
    demotions: int
    drops: int
    # per-tier byte high watermarks over the store's lifetime
    device_high_watermark: int = 0
    host_high_watermark: int = 0

    def as_dict(self) -> Dict[str, int]:
        return self.__dict__.copy()


class PrefixStore:
    """Refcounted, byte-budgeted radix store of chunk-boundary snapshots.
    Host-side bookkeeping; the engine makes every device copy but the
    demotion to the host tier, which is made here."""

    def __init__(self, chunk: int, budget_bytes: int,
                 host_budget_bytes: int = 0):
        if chunk <= 0:
            raise ValueError(
                f"PrefixStore: chunk={chunk} must be positive — snapshots "
                f"are keyed at chunk-plan boundaries")
        if budget_bytes <= 0:
            raise ValueError(
                f"PrefixStore: budget_bytes={budget_bytes} must be "
                f"positive; to disable prefix caching leave the engine's "
                f"prefix_cache_mb unset instead")
        self.chunk = int(chunk)
        self.budget_bytes = int(budget_bytes)
        self.host_budget_bytes = int(host_budget_bytes)
        # optional hook, called with an event name ("insert" / "demotion"
        # / "drop" / "promotion"), so a metrics registry can observe the
        # store without the store importing it. None = no-op; an engine
        # built with telemetry sets it (hits and misses it counts itself)
        self.on_event: Optional[Any] = None
        self._roots: Dict[Tuple, _Node] = {}
        # LRU over snapshot-bearing nodes (both tiers), least recent first
        self._lru: "OrderedDict[int, _Node]" = OrderedDict()
        self.device_bytes = 0
        self.host_bytes = 0
        self.device_high_watermark = 0
        self.host_high_watermark = 0
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.inserts = 0
        self.demotions = 0
        self.drops = 0

    # -- keys ----------------------------------------------------------------
    def _edge(self, toks: np.ndarray, depth: int) -> bytes:
        return np.ascontiguousarray(
            toks[depth:depth + self.chunk], np.int32).tobytes()

    def _touch(self, node: _Node) -> None:
        self._lru.move_to_end(id(node))

    def _event(self, name: str) -> None:
        if self.on_event is not None:
            self.on_event(name)

    def _note_watermarks(self) -> None:
        """Bump the per-tier high watermarks after any byte increase."""
        if self.device_bytes > self.device_high_watermark:
            self.device_high_watermark = self.device_bytes
        if self.host_bytes > self.host_high_watermark:
            self.host_high_watermark = self.host_bytes

    # -- lookup --------------------------------------------------------------
    def match(self, tokens, key: Tuple) -> Optional[_Node]:
        """Deepest snapshot-bearing node whose path is a prefix of
        ``tokens`` at full-chunk boundaries. Bumps the returned node's LRU
        position; hit / miss counters are the caller's (the engine tells a
        miss from a request that opted out of reuse)."""
        toks = np.asarray(tokens)
        node = self._roots.get(key)
        best = None
        depth = 0
        while node is not None and depth + self.chunk <= toks.size:
            node = node.children.get(self._edge(toks, depth))
            depth += self.chunk
            if node is not None and node.snap is not None:
                best = node
        if best is not None:
            self._touch(best)
        return best

    def covered(self, tokens, boundary: int, key: Tuple) -> bool:
        """True iff a snapshot already exists at exactly ``boundary`` for
        this prefix: publication dedupe (bumps its LRU slot)."""
        toks = np.asarray(tokens)
        node = self._roots.get(key)
        depth = 0
        while node is not None and depth < boundary:
            node = node.children.get(self._edge(toks, depth))
            depth += self.chunk
        if node is not None and node.snap is not None:
            self._touch(node)
            return True
        return False

    # -- refcounting ---------------------------------------------------------
    def acquire(self, node: _Node) -> None:
        """Pin ``node`` against eviction (an admission is restoring from
        it)."""
        node.refs += 1

    def release(self, node: _Node) -> None:
        if node.refs <= 0:
            raise RuntimeError(
                "PrefixStore.release: refcount underflow — release() "
                "without a matching acquire(); node refcounts must never "
                "go negative")
        node.refs -= 1

    # -- insertion -----------------------------------------------------------
    def insert(self, tokens, snap: Snapshot, key: Tuple) -> _Node:
        """Attach ``snap`` at its boundary, creating the path as needed,
        then enforce the byte budgets. The snapshot's buffers must be the
        store's own copies (``MD.snapshot_state``): the live admission
        keeps writing into its caches in place."""
        boundary = snap.boundary
        if boundary <= 0 or boundary % self.chunk:
            raise ValueError(
                f"PrefixStore.insert: boundary={boundary} is not a "
                f"positive multiple of chunk={self.chunk} — snapshots "
                f"exist only at full-chunk plan boundaries")
        toks = np.asarray(tokens)
        if boundary > toks.size:
            raise ValueError(
                f"PrefixStore.insert: boundary={boundary} exceeds the "
                f"prompt length {toks.size}")
        node = self._roots.setdefault(key, _Node(depth=0))
        depth = 0
        while depth < boundary:
            ek = self._edge(toks, depth)
            nxt = node.children.get(ek)
            if nxt is None:
                nxt = _Node(depth=depth + self.chunk, parent=node, edge=ek)
                node.children[ek] = nxt
            node = nxt
            depth += self.chunk
        if node.snap is not None:  # already covered — keep the older copy
            self._touch(node)
            return node
        node.snap = snap
        node.on_host = False
        self.device_bytes += snap.nbytes
        self._note_watermarks()
        self.inserts += 1
        self._event("insert")
        self._lru[id(node)] = node
        self._touch(node)
        self.enforce_budget()
        return node

    # -- eviction ------------------------------------------------------------
    def _lru_victim(self, on_host: bool) -> Optional[_Node]:
        for node in self._lru.values():
            if node.on_host is on_host and node.refs == 0:
                return node
        return None

    def _demote(self, node: _Node) -> None:
        """Device → host: copy the snapshot's buffers into pinned CPU
        tensors (fresh CPU copies when they already lie on the CPU). The
        copy is bit-identical, so a later hit restores the exact boundary
        state."""
        snap = node.snap
        caches, logits = host_state(snap.caches, snap.logits)
        node.snap = Snapshot(caches=caches, logits=logits,
                             pattern=snap.pattern, p_fa=snap.p_fa,
                             boundary=snap.boundary, nbytes=snap.nbytes)
        node.on_host = True
        self.device_bytes -= snap.nbytes
        self.host_bytes += snap.nbytes
        self._note_watermarks()
        self.demotions += 1
        self._event("demotion")

    def _drop(self, node: _Node) -> None:
        nbytes = node.snap.nbytes
        if node.on_host:
            self.host_bytes -= nbytes
        else:
            self.device_bytes -= nbytes
        node.snap = None
        node.on_host = False
        self._lru.pop(id(node), None)
        self.drops += 1
        self._event("drop")
        # prune structural leaves so dropped paths don't accumulate
        while (node.parent is not None and not node.children
               and node.snap is None and node.refs == 0):
            node.parent.children.pop(node.edge, None)
            node = node.parent

    def enforce_budget(self) -> None:
        """LRU-evict until both tiers fit their budgets; pinned nodes
        (refs > 0) are never touched, so a burst of pins may hold the
        store over budget until they release."""
        while self.device_bytes > self.budget_bytes:
            victim = self._lru_victim(on_host=False)
            if victim is None:
                break  # everything device-resident is pinned
            if self.host_budget_bytes > 0:
                self._demote(victim)
            else:
                self._drop(victim)
        while self.host_bytes > self.host_budget_bytes:
            victim = self._lru_victim(on_host=True)
            if victim is None:
                break
            self._drop(victim)

    def promote(self, node: _Node, caches, logits: torch.Tensor) -> None:
        """Host → device: adopt ``caches`` / ``logits``, the device copies
        a hit just prefetched, as the node's snapshot, so the next hit on
        this prefix skips the transfer. The budgets re-settle afterwards:
        a colder device snapshot may demote in its place."""
        snap = node.snap
        if snap is None or not node.on_host:
            return
        node.snap = Snapshot(caches=caches, logits=logits,
                             pattern=snap.pattern, p_fa=snap.p_fa,
                             boundary=snap.boundary, nbytes=snap.nbytes)
        node.on_host = False
        self.host_bytes -= snap.nbytes
        self.device_bytes += snap.nbytes
        self._note_watermarks()
        self._event("promotion")
        self._touch(node)
        self.enforce_budget()

    def offload_all(self) -> int:
        """Demote every unpinned device-resident snapshot to the host tier
        (frees device memory without losing warmth). Returns the number
        demoted. Requires the host tier."""
        if self.host_budget_bytes <= 0:
            raise ValueError(
                "PrefixStore.offload_all: host tier disabled "
                "(host_budget_bytes=0); set the engine's "
                "prefix_cache_host_mb to enable host offload")
        n = 0
        for node in list(self._lru.values()):
            if not node.on_host and node.refs == 0:
                self._demote(node)
                n += 1
        self.enforce_budget()
        return n

    # -- introspection -------------------------------------------------------
    def _count_nodes(self) -> int:
        total = 0
        stack = list(self._roots.values())
        while stack:
            n = stack.pop()
            total += 1
            stack.extend(n.children.values())
        return total

    def stats(self) -> PrefixStoreStats:
        return PrefixStoreStats(
            device_bytes=self.device_bytes, host_bytes=self.host_bytes,
            snapshots=len(self._lru), nodes=self._count_nodes(),
            hits=self.hits, misses=self.misses, hit_tokens=self.hit_tokens,
            inserts=self.inserts, demotions=self.demotions,
            drops=self.drops,
            device_high_watermark=self.device_high_watermark,
            host_high_watermark=self.host_high_watermark)
