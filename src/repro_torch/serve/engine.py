"""Serving engine: route on the first chunk → stream the rest into
decode-geometry caches → decode (port of the single-request half
of ``repro/serve/engine.py``).

Admission is the chunked, cache-resident pipeline of the JAX engine:
  1. The prompt is cut into bucketed chunks (``chunk_plan``). The first
     chunk runs as a small monolithic prefill with prefix-pooled hard
     routing: the Layer Router fires once per layer and the FA/SA pattern
     is frozen (paper §3.3). FA layers run the flash kernel, SA layers
     the sink+local streaming kernel.
  2. Decode-geometry caches are allocated from the pattern and seeded
     with the first chunk's KV (``seed_caches``): a ``FullKV`` per FA
     layer, a sink+local ``RingKV`` per SA layer (an MLA model's
     ``LatentKV`` / ``RingLatentKV`` hold its latents; a Mamba layer's
     ``MambaCache`` its SSD state and conv tail). Later chunks stream
     through ``prefill_chunk`` straight into them (FA layers on the
     block-sparse kernel, ring layers on a dense masked softmax, Mamba
     layers through the chunked SSD with the state carried).
  3. ``decode_many`` generates greedily (or samples, given a seeded
     generator), a Python loop of decode steps on the decode kernel.
``prefill_route_repack`` (full prefill → repack) is the fallback for
prompts the chunked path excludes (``chunked_eligible``): the paper's
prefix+suffix pooling, DuoAttention head-split overrides (``("duo",
n)`` entries, decoded over full caches with a per-KV-head mask) and the
``xa`` / ``ta`` SA modes, whose prefill has no ring-resident form, and
requests with a modality side input (phi-3-vision's prefix embeddings,
whisper's encoder frames) or for a model that takes one. As in the JAX
engine, a duo layer's admission prefill runs full attention (the "fixed"
context maps every entry but "sa" to FA); only its decode is head-split.
A model with an encoder encodes its frames once per ``generate`` (the
flash kernel with ``causal=False``); the prefill's and every decode
step's cross attention read that one output.

Shared-prefix reuse: an engine built with ``prefix_cache_mb`` keeps a
radix store of chunk-boundary snapshots (``serve/prefix_cache.py``). A
B = 1 admission restores a copy of the deepest snapshot its prompt
matches and streams only the uncovered suffix (block-sparse at a
``q_offset`` equal to the hit boundary, no routing chunk), and publishes
a copy of its state at every full-chunk boundary it streams.

Two frontends: ``serve_batch`` buckets requests and runs each bucket
through ``generate``; ``submit`` / ``step`` / ``drain`` feed the
continuous-batching slot pool (``serve/scheduler.py``), whose decode runs
one position per slot on the pooled decode kernel.

Guardrails and observability (``serve/slo.py``, ``serve/telemetry.py``,
``serve/tracing.py``), all off by default: the SLO config and the
load-adaptive sparsity rung (``set_sa_level`` raises the router's FA
threshold for later admissions); a metrics registry, a request-span
tracer and a tick flight recorder (``metrics_text``, ``export_trace``);
a sampled tick profiler with the analytic expressed decode cost, a
memory ledger and routing-fidelity probes (``profiler_report``,
``ledger_report``, ``attribution_report``); and ``cancel`` /
``inject_fault`` on the slot pool. Off, the engine runs exactly the
kernels and device reads it runs without them.

Tensor parallelism (``tp``, a ``distributed.group.TPGroup``; JAX's
``mesh=``): one engine a rank, each holding 1/N of the heads, KV heads
(or, where N divides by the KV heads, the one its query heads read),
FFN width and expert FFN width (``distributed/sharding.py``; ``self.cfg``
stays the whole model's config, ``self.model_cfg`` is the rank's share;
a duo override counts the whole model's KV heads)
and slot pools whose k / v hold its KV heads, with MLA's latent caches
and Mamba's states whole on every rank (``distributed/
pool_sharding.py``). An encoder runs under the group too: each rank
encodes with its heads.
Every model call runs under ``tensor_parallel(tp)`` (``parallel``), so the reduce
points sum over the ranks; every rank runs the same host code on the
same submissions, the scheduler's clock is rank 0's, and each tick ends
with a digest check of the ranks' decisions. The byte figures (the
prefix store's budget, ``kv_bytes``, the ledger) count global bytes, as
JAX's sharded arrays report them, with per-rank figures beside them.
``tp=None`` runs exactly as a single-device engine.

Sequence sharding (``seq_shard``, a ``TPGroup``; JAX's ``distributed_kv``
at B = 1): every rank holds the whole weights and runs the whole model
on the same tokens, and each FA layer's cache of at least ``min_seq``
slots that the ranks divide is cut along its sequence axis
(``KC.SeqShardKV``), so the longest context is bounded by the ranks'
memory together. A decode step gathers the ranks' partial attention
states once a sharded layer; a prefill chunk gathers the layer's live
prefix (``distributed/decode.py``). ``generate`` serves it, B >= 1 at
uniform positions, through the chunked prefill only: a request that
would take the monolithic repack path (xa, ta, duo, side inputs), the
slot pool and a prefix store raise ValueError, as ``tp=`` beside it does
(the 2-D head x sequence layout is not ported). ``kv_bytes`` counts the
whole cache once, the rank's share beside it.
"""
from __future__ import annotations

import time
import warnings
from contextlib import nullcontext
from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import router as RT
from repro_torch.distributed import decode as DD
from repro_torch.distributed import pool_sharding as PSH
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.group import digest
from repro_torch.kernels import launch_counts
from repro_torch.launch import hlo_costs as HL
from repro_torch.models import model as MD
from repro_torch.serve import kv_cache as KC
from repro_torch.serve import prefix_cache as PXC
from repro_torch.serve import slo as SLO
from repro_torch.serve import telemetry as TM
from repro_torch.serve import tracing as TR

# the key tile of the pooled decode kernel (``csrc/decode_split.cuh``):
# the profiler's expressed cost counts a kernel layer's live keys in it
POOLED_KERNEL_BLOCK_K = 64


# ---------------------------------------------------------------------------
# Chunk planning (host-side, static)
# ---------------------------------------------------------------------------

def chunk_plan(seq_len: int, chunk: int) -> List[Tuple[int, int]]:
    """Decompose a prompt into bucketed chunks: [(start, size), ...].

    Sizes are drawn from the ladder {chunk} ∪ {2^k : 2^k < chunk},
    largest first, covering ``seq_len`` exactly (padded tokens would be
    ring-inserted and corrupt ``positions``)."""
    if seq_len <= 0:
        raise ValueError(f"chunk_plan: seq_len={seq_len} must be positive")
    if chunk <= 0:
        raise ValueError(f"chunk_plan: chunk={chunk} must be positive")
    plan: List[Tuple[int, int]] = []
    start = 0
    while seq_len - start >= chunk:
        plan.append((start, chunk))
        start += chunk
    rem = seq_len - start
    if rem:
        b = 1 << (rem.bit_length() - 1)  # largest power of two <= rem
        while rem:
            if b <= rem:
                plan.append((start, b))
                start += b
                rem -= b
            b >>= 1
    return plan


# ---------------------------------------------------------------------------
# Chunk-0 seeding and the monolithic repack fallback
# ---------------------------------------------------------------------------

def seed_caches(cfg: ModelConfig, prefill_caches, pattern, batch: int,
                max_len: int, device, seq_shard=None,
                min_seq: int = KC.MIN_SEQ) -> List:
    """Decode-geometry caches for ``pattern``, seeded with a routing
    chunk's per-layer (k, v), an MLA model's (ckv, kr) or a Mamba
    layer's (SSD state, conv tail), at position 0. A ring's sink is its
    layer's (``MD.ring_sink``: none at a local layer). ``seq_shard`` /
    ``min_seq``: the FA caches this rank holds a sequence shard of
    (``KC.init_decode_caches``)."""
    caches = KC.init_decode_caches(cfg, pattern, batch, max_len, device,
                                   seq_shard=seq_shard, min_seq=min_seq)
    for i, (kv, dec) in enumerate(zip(prefill_caches, caches)):
        if isinstance(dec, KC.MambaCache):
            KC.mamba_update(dec, *kv)
            continue
        sink = MD.ring_sink(cfg, i)
        local = KC.capacity(dec) - sink
        if isinstance(dec, KC.RingLatentKV):
            KC.ring_latent_insert_chunk(dec, *kv, 0, sink, local)
        elif isinstance(dec, KC.LatentKV):
            KC.latent_insert_chunk(dec, *kv, 0)
        elif isinstance(dec, KC.RingKV):
            KC.ring_insert_chunk(dec, *kv, 0, sink, local)
        elif isinstance(dec, KC.SeqShardKV):
            DD.sharded_seq_insert_chunk(dec, *kv, 0)
        else:
            KC.full_insert_chunk(dec, *kv, 0)
    return caches


def _ring_src(seq_len: int, sink: int, local: int, ring: int) -> np.ndarray:
    """Per-ring-slot source position in the prefill KV (-1 = empty)."""
    src = np.full((ring,), -1, np.int64)
    ns = min(sink, seq_len, ring)
    src[:ns] = np.arange(ns)
    for p in range(max(sink, seq_len - local), seq_len):
        src[sink + (p - sink) % local] = p
    return src


def _gather_ring(x: torch.Tensor, src: np.ndarray,
                 axis: int = 2) -> torch.Tensor:
    """Entries of ``x`` at ``src`` along its sequence ``axis`` (2 of a
    (B, H, S, D) k or kr, 1 of a (B, S, R) ckv); -1 → zeros."""
    idx = torch.as_tensor(np.maximum(src, 0), device=x.device)
    g = x.index_select(axis, idx)
    shape = [1] * g.dim()
    shape[axis] = len(src)
    mask = torch.as_tensor(src >= 0, device=x.device).reshape(shape)
    return torch.where(mask, g, torch.zeros_like(g))


def repack_caches(cfg: ModelConfig, prefill_caches, routing,
                  seq_len: int, max_len: int) -> List:
    """Whole-prompt prefill KV (per layer (k, v), an MLA model's (ckv,
    kr), a Mamba layer's (SSD state, conv tail)) → decode cache list.
    FALLBACK PATH for admissions ``chunked_eligible`` excludes.
    routing[i] ∈ {"fa", "sa", ("duo", n), None}: "sa" makes a sink +
    local ring; a duo layer keeps its full cache; a local layer keeps a
    ring of min(sliding_window, max_len) slots with no sink, whatever
    its entry; a Mamba layer's state is its cache."""
    flux = cfg.flux
    # the sequence axis of each buffer: ckv (B, S, R) holds it at 1
    axes = (1, 2) if cfg.use_mla else (2, 2)
    out = []
    for i, (a, b) in enumerate(prefill_caches):
        if cfg.layer_kinds[i] == "mamba":
            out.append(KC.MambaCache(a, b))
            continue
        B = a.shape[0]
        length = torch.full((B,), seq_len, dtype=torch.int32,
                            device=a.device)
        local = cfg.layer_kinds[i] == "local"
        if local or routing[i] == "sa":
            ring, sink = ((min(cfg.sliding_window, max_len), 0) if local
                          else KC.sa_ring(flux, max_len))
            src = _ring_src(seq_len, sink, ring - sink, ring)
            pos = torch.as_tensor(src, dtype=torch.int32, device=a.device)
            kind = KC.RingLatentKV if cfg.use_mla else KC.RingKV
            out.append(kind(_gather_ring(a, src, axes[0]),
                            _gather_ring(b, src, axes[1]),
                            pos[None].repeat(B, 1), length))
        else:
            if seq_len > max_len:
                raise ValueError(
                    f"repack_caches: prompt length seq_len={seq_len} "
                    f"exceeds the decode cache capacity max_len={max_len} "
                    f"at full-cache layer {i}; raise the engine's max_len "
                    f"or truncate the prompt")
            pad = max_len - seq_len
            kind = KC.LatentKV if cfg.use_mla else KC.FullKV
            out.append(kind(_pad_seq(a, axes[0], pad),
                            _pad_seq(b, axes[1], pad), length))
    return out


def _pad_seq(x: torch.Tensor, axis: int, pad: int) -> torch.Tensor:
    """``x`` with ``pad`` zero entries appended along dimension ``axis``."""
    return F.pad(x, (0, 0) * (x.dim() - 1 - axis) + (0, pad))


# ---------------------------------------------------------------------------
# Cache accounting: KV payload vs. bookkeeping overhead
# ---------------------------------------------------------------------------

@dataclass
class KVStats:
    """Decode-cache footprint, split the way the paper counts it:
    ``payload_bytes`` is the k / v tensors the routing decision shrinks,
    ``overhead_bytes`` the bookkeeping (``positions`` / ``length``) every
    geometry has. ``prefix_device_bytes`` / ``prefix_host_bytes`` report
    the prefix store's tiers beside them: the store holds whole boundary
    states, which are neither payload nor overhead of a live request.
    Under tensor parallelism the payload and overhead are global, the
    whole model's (head-sharded k / v counted on every rank), and
    ``payload_shard_bytes`` / ``overhead_shard_bytes`` what one rank
    holds; on one device they are equal."""
    payload_bytes: int
    overhead_bytes: int
    prefix_device_bytes: int = 0
    prefix_host_bytes: int = 0
    payload_shard_bytes: int = 0
    overhead_shard_bytes: int = 0

    @property
    def total_bytes(self) -> int:
        return self.payload_bytes + self.overhead_bytes


def kv_cache_stats(caches, prefix_store=None, world: int = 1,
                   kv_replicas: int = 1) -> KVStats:
    """``KVStats`` of a list of caches (of one request or several pools)
    and of the prefix store's tiers; ``world`` the tensor-parallel ranks
    the caches are one rank's share of, ``kv_replicas`` the ranks that
    hold each KV head (``PSH.cache_bytes``)."""
    b = PSH.cache_bytes(caches, world, kv_replicas)
    return KVStats(
        payload_bytes=b.payload, overhead_bytes=b.overhead,
        prefix_device_bytes=(prefix_store.device_bytes
                             if prefix_store is not None else 0),
        prefix_host_bytes=(prefix_store.host_bytes
                           if prefix_store is not None else 0),
        payload_shard_bytes=b.payload_shard,
        overhead_shard_bytes=b.overhead_shard)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

@dataclass
class ChunkedPrefill:
    """An in-flight route-then-stream admission. ``step()`` processes one
    chunk: step 0 is the routing chunk (monolithic prefill over the first
    bucket, then seeded decode caches), every later step streams one
    chunk into those caches. After ``done`` the results live in
    ``pattern`` / ``caches`` / ``logits`` / ``p_fa``.

    With the engine's prefix store and ``reuse``, the job starts from the
    deepest matching chunk-boundary snapshot (its ``prefix_hit_tokens``
    skip straight past their chunks: no prefill work is issued for them)
    and publishes a snapshot at every full-chunk boundary it streams.

    ``sa_level`` is the sparsity rung at the job's start, frozen so that
    a dial change mid-prefill cannot split one request across two
    routing regimes. ``dispatches`` counts its engine calls the way the
    JAX engine counts compiled calls (routing chunk 2, a streamed chunk
    1, a prefix restore 1, a published snapshot 1)."""
    engine: "ServeEngine"
    tokens: torch.Tensor                   # (B, S) on the engine's device
    host_tokens: np.ndarray                # the same (B, S), on the host
    override: Optional[Tuple[Any, ...]]
    plan: List[Tuple[int, int]]
    idx: int = 0
    pattern: Optional[Tuple[Any, ...]] = None
    caches: Any = None
    logits: Optional[torch.Tensor] = None
    p_fa: Optional[np.ndarray] = None
    reuse: bool = True                     # participate in the prefix store
    sa_level: int = 0                      # sparsity rung at the start
    dispatches: int = 0                    # engine calls issued so far
    prefix_hit_tokens: int = 0             # prompt tokens seeded from a hit
    chunks_streamed: int = 0               # chunks actually computed
    published: int = 0                     # boundary snapshots published

    @property
    def seq_len(self) -> int:
        return self.tokens.shape[1]

    @property
    def done(self) -> bool:
        return self.idx >= len(self.plan)

    def step(self) -> None:
        """Process the next chunk (no-op when done)."""
        if self.done:
            return
        eng = self.engine
        start, size = self.plan[self.idx]
        chunk = self.tokens[:, start:start + size]
        if self.idx == 0:
            self._route_chunk(chunk)
        else:
            with eng.parallel():
                self.logits, self.caches = MD.prefill_chunk(
                    eng.params, eng.model_cfg, chunk, self.caches, start)
            self.dispatches += 1
        self.chunks_streamed += 1
        self.idx += 1
        eng._maybe_publish(self, start, size)

    def _route_chunk(self, chunk: torch.Tensor) -> None:
        eng, cfg = self.engine, self.engine.model_cfg
        routing_ctx, fixed = eng._routing_ctx(self.override)
        with eng.parallel():
            pf = MD.prefill(eng.params, cfg, chunk, routing_ctx=routing_ctx,
                            fixed_pattern=fixed,
                            fa_threshold=eng._rung_threshold(self.sa_level,
                                                             routing_ctx))
        decisions = (pf.routing.numpy() if pf.routing is not None
                     else None)
        self.pattern = eng._pattern(decisions, self.override)
        self.p_fa = None if pf.p_fa is None else pf.p_fa.numpy()
        eng._record_routing(self.pattern, self.p_fa, self.sa_level)
        self.caches = seed_caches(cfg, pf.caches, self.pattern,
                                  chunk.shape[0], eng.max_len, eng.device,
                                  seq_shard=eng.seq_shard,
                                  min_seq=eng.min_seq)
        self.logits = pf.logits
        self.dispatches += 2  # routing prefill + the seed insert


@dataclass
class GenerationResult:
    tokens: np.ndarray            # (B, n_steps)
    routing: Tuple[Any, ...]      # per-layer decode pattern
    msr: float                    # SA fraction over routed layers
    kv_bytes: int                 # decode-cache KV payload, global
    p_fa: Optional[np.ndarray] = None
    logits: Optional[torch.Tensor] = None  # (B, V) first-step logits
    final_logits: Optional[torch.Tensor] = None  # (B, V) after the last step
    prefill_s: float = 0.0        # host clock, admission incl. routing
    decode_s: float = 0.0         # host clock, the n_steps decode
    prefix_hit_tokens: int = 0    # prompt tokens served from a warm prefix
    dispatches: int = 0           # engine calls, as the JAX engine counts
    encode_s: float = 0.0         # host clock, the encoder (whisper)
    kv_shard_bytes: int = 0       # the payload this rank holds


class ServeEngine:
    """Single-model serving with flux routing.

    ``routing_override``: force a per-layer pattern ("fa" | "sa") instead
    of consulting the router; ``generate`` also accepts a per-request
    override. ``sparse_decode=False`` keeps full KV at every layer
    (routing then affects prefill only). ``prefill_chunk`` is the chunked
    prefill's largest chunk (None/0 = every admission takes the repack
    fallback). ``device`` defaults to cuda; the weights are moved there.
    ``prefix_cache_mb`` enables the shared-prefix snapshot store with that
    device budget (MB), ``prefix_cache_host_mb`` its pinned host tier.

    Guardrails and observability, all off by default: ``slo`` the
    guardrail config (``serve/slo.py``); ``telemetry`` a metrics
    registry, a request-span tracer and a flight recorder of the last
    ``flight_recorder_ticks`` scheduler ticks; ``profile_every`` > 0
    samples every Nth tick for the host / device cost profiler;
    ``fidelity_probe_every`` > 0 probes every Nth admission's attention
    mass coverage; ``memory_ledger`` the device-byte ledger. Each of the
    last three turns telemetry on.

    ``tp``: this rank's ``TPGroup`` for tensor-parallel serving (see the
    module's docstring); ``params`` are the whole model's (sharded here)
    or already the rank's share, and ``device`` defaults to the group's.
    A config the ranks cannot divide raises ValueError
    (``SH.check_tp_supported``).

    ``seq_shard``: this rank's ``TPGroup`` for sequence-sharded FA
    caches of at least ``min_seq`` slots (see the module's docstring);
    the weights stay whole, and ``device`` defaults to the group's.
    """

    def __init__(self, params, cfg: ModelConfig, *, max_len: int = 4096,
                 sparse_decode: bool = True, routing_override=None,
                 prefill_chunk: Optional[int] = 512,
                 routing_pooling: str = "prefix",
                 prefix_cache_mb: Optional[float] = None,
                 prefix_cache_host_mb: float = 0.0,
                 slo: Optional[SLO.SLOConfig] = None,
                 telemetry: bool = False,
                 flight_recorder_ticks: int = 512,
                 profile_every: int = 0,
                 fidelity_probe_every: int = 0,
                 memory_ledger: bool = False, device=None, tp=None,
                 seq_shard=None, min_seq: int = KC.MIN_SEQ):
        if routing_pooling not in ("prefix", "prefix_suffix"):
            raise ValueError(
                f"routing_pooling={routing_pooling!r}: expected 'prefix' "
                f"(chunk-invariant serving default) or 'prefix_suffix' "
                f"(the paper's pooling; forces the monolithic prefill)")
        if profile_every < 0 or fidelity_probe_every < 0:
            raise ValueError(
                f"profile_every={profile_every} / fidelity_probe_every="
                f"{fidelity_probe_every} must be >= 0 (0 disables)")
        MD.check_supported(cfg)
        if seq_shard is not None and tp is not None:
            raise ValueError(
                "seq_shard with tp: sequence-sharded caches beside "
                "head-sharded weights (JAX's decode_tp with "
                "distributed_kv) are not ported; pass one of the two")
        if seq_shard is not None and prefix_cache_mb:
            raise ValueError(
                "seq_shard with a prefix store (prefix_cache_mb): a "
                "snapshot would hold one rank's shards of the caches; "
                "drop prefix_cache_mb")
        self.seq_shard = seq_shard
        self.min_seq = int(min_seq)
        if device is None and seq_shard is not None:
            device = seq_shard.device
        self.tp = tp
        self.world = 1 if tp is None else tp.world
        SH.check_tp_supported(cfg, self.world)
        # the ranks that hold each KV head (1 unless KV is replicated)
        self.kv_replicas = SH.kv_replicas(cfg, self.world)
        self.device = resolve_device(
            tp.device if device is None and tp is not None else device)
        if not SH.params_are_local(params, cfg, self.world):
            params = SH.shard_params_tp(params, cfg, tp.rank, tp.world)
        self.params = MD.params_to(params, self.device)
        self.cfg = cfg
        # the rank's share of the model: what the model functions run
        self.model_cfg = SH.tp_config(cfg, self.world)
        self.max_len = max_len
        self.sparse_decode = sparse_decode
        self.routing_override = routing_override
        self.prefill_chunk = int(prefill_chunk) if prefill_chunk else 0
        self.routing_pooling = routing_pooling
        # the encoder's call over a request's frames (whisper; a
        # ValueError naming encoder_frames without them), else None
        self._encode = (partial(MD.encode_side_input, self.params,
                                self.model_cfg)
                        if cfg.num_encoder_layers else None)
        self._scheduler = None  # ContinuousScheduler, created by scheduler()
        # geometries whose over-budget publication was already warned of
        self._snap_skip_warned: set = set()
        self.prefix_store = self._build_prefix_store(prefix_cache_mb,
                                                     prefix_cache_host_mb)
        # engine calls (prefill, seed, stream chunk, decode chunk, snapshot
        # copy, probe), counted as the JAX engine counts compiled calls
        self.dispatch_count = 0
        # SLO guardrails; ``sa_level`` is the load-adaptive sparsity rung,
        # 0 (the router's argmax) unless a scheduler's LoadTracker turns it
        self.slo = slo if slo is not None else SLO.SLOConfig()
        self.sa_level = 0
        self.profiler = (TM.TickProfiler(profile_every)
                         if profile_every else None)
        self.fidelity_probe_every = int(fidelity_probe_every)
        self._probe_admissions = 0    # admissions seen by the probe dial
        self._params_cost_cache: Optional[Tuple[int, int]] = None
        self._cost_specs: Dict[Tuple, List[Tuple]] = {}
        telemetry = bool(telemetry or profile_every or fidelity_probe_every
                         or memory_ledger)
        # decision-margin drift per (layer, sa_level), fed by
        # _record_routing from host floats
        self.margin_drift = (RT.MarginDriftTracker() if telemetry
                             else None)
        self.ledger = (TM.MemoryLedger(params_bytes=(
            self._params_cost()[1] if self.world == 1
            else SH.global_param_bytes(self.params, cfg, self.world)))
                       if memory_ledger else None)
        # off, every instrumented path is one ``is not None`` test, so the
        # engine launches and reads exactly what it does without telemetry
        if telemetry:
            self.telemetry: Optional[TM.MetricsRegistry] = \
                TM.MetricsRegistry()
            self.tracer: Optional[TR.SpanTracer] = TR.SpanTracer()
            self.flight_recorder: Optional[TM.FlightRecorder] = \
                TM.FlightRecorder(flight_recorder_ticks)
            self._register_core_metrics()
        else:
            self.telemetry = None
            self.tracer = None
            self.flight_recorder = None

    def _build_prefix_store(self, prefix_cache_mb, prefix_cache_host_mb
                            ) -> Optional[PXC.PrefixStore]:
        if not prefix_cache_mb:
            return None
        cfg = self.cfg
        if not self.prefill_chunk:
            raise ValueError(
                f"prefix_cache_mb={prefix_cache_mb:g} requires the chunked "
                f"prefill: prefix snapshots are chunk-boundary objects and "
                f"the monolithic prefill→repack path has no boundaries to "
                f"snapshot — set prefill_chunk (or drop prefix_cache_mb)")
        override = self.routing_override
        budget = int(prefix_cache_mb * 2 ** 20)
        host_budget = int(prefix_cache_host_mb * 2 ** 20)
        if override is not None and any(isinstance(p, tuple)
                                        for p in override):
            raise ValueError(
                f"prefix_cache_mb={prefix_cache_mb:g} with a duo "
                f"head-split routing_override: duo admissions take the "
                f"repack fallback (chunked_eligible=False), so the store "
                f"could never hold a snapshot — drop the duo override or "
                f"the prefix cache")
        if override is not None:
            self._check_override(override)
            pattern = self._pattern(None, override)
            what = "the overridden routing geometry"
        else:
            # smallest geometry the router can pick: SA rings wherever a
            # routed layer may stream — if even that snapshot overflows
            # the budget, no admission could ever publish
            can_sa = cfg.flux.enabled and cfg.flux.sa_mode == "ssa"
            pattern = tuple(
                ("sa" if can_sa else "fa") if k == "attn" else None
                for k in cfg.layer_kinds)
            what = "the smallest routed geometry"
        need = PXC.snapshot_spec_bytes(cfg, pattern, self.max_len)
        if budget < need:
            raise ValueError(
                f"prefix_cache_mb={prefix_cache_mb:g} ({budget} bytes) "
                f"cannot hold one chunk-boundary snapshot for {what} "
                f"({need} bytes at max_len={self.max_len}): raise "
                f"prefix_cache_mb to at least {need / 2 ** 20:.2f} MB or "
                f"lower max_len")
        return PXC.PrefixStore(chunk=self.prefill_chunk,
                               budget_bytes=budget,
                               host_budget_bytes=host_budget)

    # -- routing pattern ---------------------------------------------------
    def _pattern(self, decisions: Optional[np.ndarray],
                 override=None) -> Tuple[Any, ...]:
        cfg = self.cfg
        override = override if override is not None else \
            self.routing_override
        routed = list(cfg.routable_layers())
        pattern: List[Any] = [None] * cfg.num_layers
        for i, kind in enumerate(cfg.layer_kinds):
            if kind != "attn":
                continue
            if not cfg.flux.enabled:
                pattern[i] = "fa"
            elif override is not None:
                pattern[i] = override[i]
            elif decisions is None or not self.sparse_decode:
                pattern[i] = "fa"
            else:
                pattern[i] = "fa" if int(decisions[routed.index(i)]) \
                    else "sa"
        return tuple(pattern)

    def _routing_ctx(self, override=None):
        """(routing_ctx, fixed_pattern) for an admission prefill: hard
        routing without an override, the "fixed" context with one (so SA
        layers really run sparse attention during prefill)."""
        cfg = self.cfg
        override = (override if override is not None
                    else self.routing_override)
        if not (cfg.flux.enabled and cfg.routable_layers()):
            return "fa_only", None
        if override is None:
            return ("hard" if self.routing_pooling == "prefix_suffix"
                    else "hard_prefix"), None
        return "fixed", [0 if override[i] == "sa" else 1
                         for i in range(cfg.num_layers)]

    # -- load-adaptive sparsity dial (serve/slo.py) -------------------------
    def set_sa_level(self, level: int) -> None:
        """Set the sparsity rung for later admissions (running jobs keep
        the rung they started with), clamped to the config's ladder."""
        self.sa_level = max(0, min(int(level), self.slo.sa_level_max))

    def fa_threshold(self, level: Optional[int] = None) -> float:
        """FA-decision threshold at ``level`` (default: the current rung)
        on the config's ladder."""
        lv = self.sa_level if level is None else level
        return RT.sa_biased_threshold(lv, step=self.slo.sa_threshold_step,
                                      max_level=self.slo.sa_level_max)

    def _rung_threshold(self, level: int, routing_ctx: str
                        ) -> Optional[float]:
        """The router threshold an admission at ``level`` prefills with:
        None (the 0.5 argmax, as without the dial) at rung 0 or outside
        the hard routing contexts."""
        if level > 0 and routing_ctx in ("hard", "hard_prefix"):
            return self.fa_threshold(level)
        return None

    # -- telemetry -----------------------------------------------------------
    def _register_core_metrics(self) -> None:
        """Pre-register the always-present metrics so ``metrics_text``
        has a stable schema from the first scrape, and hook the prefix
        store's events into the registry."""
        reg = self.telemetry
        reg.gauge("flux_sa_level",
                  "load-adaptive sparsity rung (0 = neutral routing)")
        reg.gauge("flux_load_pressure",
                  "LoadTracker queue-pressure signal in [0, 1]")
        reg.gauge("serve_queue_depth", "waiting requests after admission")
        reg.gauge("serve_slots_active", "resident decode slots, all pools")
        reg.gauge("serve_slots_capacity", "total decode slots, all pools")
        reg.counter("serve_ticks_total", "scheduler ticks")
        reg.counter("serve_tokens_generated_total",
                    "tokens accepted from decode chunks")
        reg.counter("serve_requests_submitted_total", "requests submitted")
        reg.counter("serve_prefill_chunks_total",
                    "prefill chunks streamed as tick work")
        reg.counter("serve_preemptions_total", "recompute preemptions")
        reg.counter("serve_dispatches_total", "engine calls issued")
        reg.counter("flux_sa_transitions_total",
                    "sparsity-dial rung changes, either direction")
        reg.gauge("prefix_store_device_bytes",
                  "prefix snapshot store occupancy, device tier")
        reg.gauge("prefix_store_host_bytes",
                  "prefix snapshot store occupancy, host tier")
        for status in SLO.STATUSES:
            reg.counter("serve_requests_finished_total",
                        "retired requests by terminal status",
                        status=status)
        for i in self.cfg.routable_layers():
            for d in ("fa", "sa"):
                reg.counter("flux_router_decisions_total",
                            "hard routing decisions at admission time",
                            layer=str(i), decision=d)
        if self.fidelity_probe_every:
            for i in self.cfg.routable_layers():
                for d in ("fa", "sa"):
                    reg.histogram(
                        "flux_fidelity_coverage",
                        "fraction of the full-attention mass of the last "
                        "prompt token retained by the routed SA window, "
                        "per routed layer (probe admissions only)",
                        layer=str(i), decision=d)
        if self.prefix_store is not None:
            self.prefix_store.on_event = self._prefix_store_event

    def _prefix_store_event(self, event: str) -> None:
        self.telemetry.counter("prefix_store_events_total",
                               "prefix store lifecycle events",
                               event=event).inc()

    def _record_routing(self, pattern, p_fa: Optional[np.ndarray],
                        sa_level: int) -> None:
        """Count one admission's per-layer FA/SA decisions and their
        threshold margins, from host values the admission already read."""
        reg = self.telemetry
        if reg is None or pattern is None:
            return
        for j, i in enumerate(self.cfg.routable_layers()):
            d = pattern[i]
            if d not in ("fa", "sa"):
                continue
            reg.counter("flux_router_decisions_total",
                        layer=str(i), decision=d).inc()
            if p_fa is not None and j < len(p_fa):
                margin = RT.decision_margin(
                    float(p_fa[j]), sa_level,
                    step=self.slo.sa_threshold_step,
                    max_level=self.slo.sa_level_max)
                reg.histogram(
                    "flux_router_margin",
                    "router p_fa minus the (possibly SA-biased) decision "
                    "threshold; positive = FA side",
                    layer=str(i)).observe(margin)
                self.margin_drift.observe(i, sa_level, margin)

    def _refresh_gauges(self) -> None:
        """Point-in-time gauges from host state (scheduler occupancy,
        prefix store tiers, the dial, the ledger), per tick and at scrape
        time."""
        reg = self.telemetry
        reg.gauge("flux_sa_level").set(self.sa_level)
        if self.prefix_store is not None:
            reg.gauge("prefix_store_device_bytes").set(
                self.prefix_store.device_bytes)
            reg.gauge("prefix_store_host_bytes").set(
                self.prefix_store.host_bytes)
        sched = self._scheduler
        if sched is not None:
            reg.gauge("flux_load_pressure").set(sched.load.pressure)
            reg.gauge("serve_queue_depth").set(len(sched.waiting))
            reg.gauge("serve_slots_active").set(sched.n_active())
            reg.gauge("serve_slots_capacity").set(
                sum(p.capacity for p in sched.pools.values()))
        md = self.margin_drift
        for layer, level in md.keys():
            reg.gauge(
                "flux_router_margin_drift",
                "recent-minus-lifetime mean router decision margin, per "
                "(layer, sparsity rung) — nonzero means the traffic mix "
                "shifted under a fixed dial setting",
                layer=str(layer), sa_level=str(level)).set(
                    md.drift(layer, level))
        led = self.ledger
        snap = led.last() if led is not None else None
        if snap is not None:
            reg.gauge("serve_ledger_device_bytes",
                      "memory ledger: tracked device bytes (pools + "
                      "prefix device tier + params)").set(snap.device_bytes)
            reg.gauge("serve_ledger_pool_live_bytes",
                      "memory ledger: payload bytes in occupied slots"
                      ).set(snap.pool_live_bytes)
            reg.gauge("serve_ledger_pool_stranded_bytes",
                      "memory ledger: payload bytes in empty slots"
                      ).set(snap.pool_stranded_bytes)
            reg.gauge("serve_ledger_fragmentation_bytes",
                      "memory ledger: empty-slot bytes in pools whose "
                      "geometry matches no queued work").set(
                          snap.fragmentation_bytes)
            reg.gauge("serve_ledger_device_high_watermark_bytes",
                      "memory ledger: lifetime peak of tracked device "
                      "bytes").set(led.high_watermark)

    def metrics_text(self) -> str:
        """Current metrics as Prometheus text exposition format."""
        if self.telemetry is None:
            raise ValueError(
                "metrics_text: telemetry is disabled — construct the "
                "ServeEngine with telemetry=True (or pass --metrics-out "
                "to launch/serve.py)")
        self._refresh_gauges()
        return self.telemetry.render()

    def export_trace(self, path: str) -> None:
        """Write the request-span trace as Chrome-trace / Perfetto JSON
        (open in chrome://tracing or https://ui.perfetto.dev)."""
        if self.tracer is None:
            raise ValueError(
                "export_trace: telemetry is disabled — construct the "
                "ServeEngine with telemetry=True (or pass --trace-out "
                "to launch/serve.py)")
        self.tracer.export(path)

    # -- cost attribution (profiler / ledger / probes) ----------------------
    def _params_cost(self) -> Tuple[int, int]:
        """(parameter count, parameter bytes), from shapes only, walked
        once (the linear decode cost and the ledger's params line)."""
        if self._params_cost_cache is None:
            leaves = []

            def walk(t):
                if isinstance(t, torch.Tensor):
                    leaves.append(t)
                else:
                    for v in (t.values() if isinstance(t, dict) else t):
                        walk(v)
            walk(self.params)
            self._params_cost_cache = (sum(t.numel() for t in leaves),
                                       sum(t.nbytes for t in leaves))
        return self._params_cost_cache

    def device_sync(self) -> None:
        """The profiler's timed sync boundary, taken on sampled ticks
        only: wait for the card's queued work (nothing to wait for on
        the CPU, where every operation has returned)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _pool_layer_specs(self, pool) -> List[Tuple]:
        """Per-attention-layer (buffer_len, n_q_heads, n_kv_heads, d_k,
        d_v, dtype_bytes) of one slot pool, from its cache shapes, cached
        per slot geometry. Mamba layers run no attention and have no
        spec."""
        key = pool.slot_geometry()
        specs = self._cost_specs.get(key)
        if specs is None:
            hq = self.model_cfg.num_heads
            specs = self._cost_specs[key] = [
                # absorbed MLA decode: one latent "kv head", scores over
                # ckv ‖ kr, values read from the latent
                (KC.capacity(c), hq, 1, c.ckv.shape[-1] + c.kr.shape[-1],
                 c.ckv.shape[-1], c.ckv.element_size())
                if isinstance(c, (KC.LatentKV, KC.RingLatentKV)) else
                (c.k.shape[2], hq, c.k.shape[1], c.k.shape[-1],
                 c.v.shape[-1], c.k.element_size()) for c in pool.caches
                if not isinstance(c, KC.MambaCache)]
        return specs

    def _expressed_decode_cost(self, pool, n_steps: int) -> Dict[str, Any]:
        """Analytic expressed FLOPs / HBM bytes of ``n_steps`` pooled
        decode steps on ``pool`` (``launch/hlo_costs`` conventions), from
        static shapes and host-known lengths. On the card every attention
        layer runs the pooled split kernel, which reads each slot's live
        keys in 64-key tiles; on the CPU the plain version sweeps the
        whole buffer (all dense)."""
        specs = self._pool_layer_specs(pool)
        lengths = [1] * pool.capacity  # free rows park at position 0
        for slot, inf in pool.active.items():
            lengths[slot] = max(
                1, inf.metrics.prompt_len + len(inf.generated))
        hits = ([True] * len(specs) if pool.logits.is_cuda else None)
        attn = HL.pooled_decode_tick_cost(lengths, specs, n_steps=n_steps,
                                          kernel_hits=hits,
                                          block_k=POOLED_KERNEL_BLOCK_K)
        n_params, params_bytes = self._params_cost()
        lin = HL.decode_linear_cost(n_params, params_bytes,
                                    batch=pool.capacity, n_steps=n_steps)
        return {
            "flops": attn["flops"] + lin["flops"],
            "hbm_bytes": attn["hbm_bytes"] + lin["hbm_bytes"],
            "kernel_hit": attn["kernel_hit"],
            "kernel_decline": attn["kernel_decline"],
        }

    def _maybe_fidelity_probe(self, tokens_1d, pattern, agree=None
                              ) -> Optional[np.ndarray]:
        """Every ``fidelity_probe_every``-th admission is a probe: one
        extra FA-only forward (``MD.attention_mass_coverage``; flash at
        every attention layer on the card) gives, per routed layer, the
        share of the last prompt token's FA attention mass that the SA
        window keeps. With the dial at 0 this is one int test. The JAX
        engine pads the prompt to its power-of-two bucket; the port runs
        it unpadded and gives MoE layers the bucket's capacity, which is
        the same result. Under tensor parallelism the forward runs on the
        rank's share and every rank reads the same coverage; ``agree``
        (the scheduler's digest check) is told whether this admission is
        probed before the probe's first reduce, so a rank that would skip
        it fails loudly instead of leaving the others in that reduce. The
        probe's reduces count apart from the serving ones
        (``TPGroup.probe_calls``)."""
        if not self.fidelity_probe_every:
            return None
        self._probe_admissions += 1
        routed = self.cfg.routable_layers()
        toks = np.asarray(tokens_1d).reshape(-1)
        due = (not (self._probe_admissions - 1) % self.fidelity_probe_every
               and bool(routed) and toks.size >= 1)
        if agree is not None:
            agree(due)
        if not due:
            return None
        bucket = 1 << (toks.size - 1).bit_length()
        with self.parallel(), (self.tp.probing() if self.tp is not None
                               else nullcontext()):
            cov = MD.attention_mass_coverage(self.params, self.model_cfg,
                                             self._tokens(toks[None]),
                                             capacity_len=bucket).numpy()
        self.dispatch_count += 1
        reg = self.telemetry
        for j, i in enumerate(routed):
            if j < cov.size and pattern[i] in ("fa", "sa"):
                reg.histogram("flux_fidelity_coverage", layer=str(i),
                              decision=pattern[i]).observe(float(cov[j]))
        return cov

    def parallel(self):
        """The ambient group of this engine's model calls
        (``SH.tensor_parallel``): the rank's group, with the whole
        model's KV heads for ``SH.kv_head_range``; a no-op at tp=None."""
        return SH.tensor_parallel(self.tp, kv_heads=self.cfg.num_kv_heads)

    def mesh_shape(self) -> Optional[Tuple[int, int]]:
        """The serving mesh JAX's engine would report, (1, world), for
        the flight recorder; None on the single-device path."""
        return None if self.tp is None else self.tp.mesh_shape()

    def ledger_report(self) -> Dict[str, Any]:
        """A fresh ledger snapshot reconciled against an independent
        ``kv_cache_stats`` walk of the same pools and prefix store: pool
        payload and prefix tiers agree exactly, and the ledger's overhead
        exceeds the walk's by the pools' aux buffers (logits, pos). Under
        tensor parallelism both count global bytes; the walk's per-rank
        figures stand beside them."""
        if self.ledger is None:
            raise ValueError(
                "ledger_report: the memory ledger is disabled — construct "
                "the ServeEngine with memory_ledger=True (or pass "
                "--ledger-out to launch/serve.py)")
        sched = self._scheduler
        snap = (sched.ledger_snapshot() if sched is not None
                else self.ledger.last())
        pools = list(sched.pools.values()) if sched is not None else []
        stats = kv_cache_stats([c for p in pools for c in p.caches],
                               self.prefix_store, self.world,
                               self.kv_replicas)
        mesh = self.mesh_shape()
        out: Dict[str, Any] = {
            "snapshot": snap.as_dict() if snap is not None else None,
            "kv_cache_stats": {
                "payload_bytes": stats.payload_bytes,
                "overhead_bytes": stats.overhead_bytes,
                "prefix_device_bytes": stats.prefix_device_bytes,
                "prefix_host_bytes": stats.prefix_host_bytes,
                # one rank's bytes: below the global ones when k / v are
                # head-sharded, equal on one device
                "payload_shard_bytes": stats.payload_shard_bytes,
                "overhead_shard_bytes": stats.overhead_shard_bytes,
            },
            "mesh": list(mesh) if mesh is not None else None,
            "reconciliation": None,
            "aux_bytes": 0,
        }
        if snap is not None:
            out["reconciliation"] = snap.reconcile(
                stats.payload_bytes, stats.overhead_bytes,
                stats.prefix_device_bytes, stats.prefix_host_bytes)
            out["aux_bytes"] = sum(p.aux_bytes for p in snap.pools)
        if self.prefix_store is not None:
            out["prefix_store"] = self.prefix_store.stats().as_dict()
        return out

    def profiler_report(self) -> Dict[str, Any]:
        """The sampled cost profiler's achieved-vs-expressed table."""
        if self.profiler is None:
            raise ValueError(
                "profiler_report: the tick profiler is disabled — "
                "construct the ServeEngine with profile_every=N (or pass "
                "--profile-every to launch/serve.py)")
        return self.profiler.report()

    def attribution_report(self) -> Dict[str, Any]:
        """Everything the attribution layer knows, JSON-ready: the
        profiler table, the reconciled ledger, decision-margin drift and
        the kernels' launch counts. Disabled parts report None."""
        return {
            "profiler": (self.profiler.report()
                         if self.profiler is not None else None),
            "ledger": (self.ledger_report()
                       if self.ledger is not None else None),
            "margin_drift": (self.margin_drift.report()
                             if self.margin_drift is not None else None),
            "kernel_launches": launch_counts(),
            "fidelity_probe_every": self.fidelity_probe_every,
            "probe_admissions": self._probe_admissions,
        }

    def _check_override(self, override) -> None:
        """Raise on a malformed routing override: each layer's entry must
        be "fa", "sa", None or ("duo", n) with 0 <= n <= num_kv_heads,
        the whole model's (under tensor parallelism each rank runs FA on
        its share of the first n global KV heads)."""
        cfg = self.cfg
        if override is None:
            return

        def ok(p):
            if isinstance(p, tuple):
                return (len(p) == 2 and p[0] == "duo"
                        and 0 <= int(p[1]) <= cfg.num_kv_heads)
            return p in ("fa", "sa", None)
        if len(override) != cfg.num_layers or not all(map(ok, override)):
            raise ValueError(
                f"routing override must give 'fa', 'sa' or ('duo', n) with "
                f"0 <= n <= {cfg.num_kv_heads} for each of "
                f"{cfg.num_layers} layers; got {override!r}")

    def chunked_eligible(self, seq_len: int, override=None, *,
                         prefix_embeddings=None,
                         encoder_frames=None) -> bool:
        """True when the chunked cache-resident admission can serve this
        request; False routes it to the monolithic repack fallback
        (``repack_reason`` says why)."""
        return self.repack_reason(
            seq_len, override, prefix_embeddings=prefix_embeddings,
            encoder_frames=encoder_frames) is None

    def repack_reason(self, seq_len: int, override=None, *,
                      prefix_embeddings=None,
                      encoder_frames=None) -> Optional[str]:
        """Why this request takes the monolithic repack fallback, in words
        (duo head splits, the xa / ta SA modes and modality side inputs
        among others, as in the JAX engine), or None where the chunked
        cache-resident admission serves it."""
        cfg = self.cfg
        override = (override if override is not None
                    else self.routing_override)
        self._check_override(override)
        if not self.prefill_chunk:
            return "prefill_chunk unset"
        if seq_len <= 0:
            return "an empty prompt"
        if (prefix_embeddings is not None or encoder_frames is not None
                or cfg.num_encoder_layers or cfg.num_prefix_tokens):
            return "a modality side input"
        if override is not None and any(isinstance(p, tuple)
                                        for p in override):
            return "a duo head-split override"
        routable = bool(cfg.flux.enabled and cfg.routable_layers())
        if routable and override is None:
            if not self.sparse_decode:
                # decisions would diverge from geometry
                return "router-driven routing with sparse_decode off"
            if self.routing_pooling != "prefix":
                return (f"{self.routing_pooling} routing pooling, which "
                        f"needs the full sequence")
            if (chunk_plan(seq_len, self.prefill_chunk)[0][1]
                    < min(cfg.flux.pool_size, seq_len)):
                return "a first chunk shorter than the router's pool"
        needs_sa = routable and (override is None
                                 or any(p == "sa" for p in override))
        if needs_sa and cfg.flux.sa_mode != "ssa":
            # xa/ta prefill has no ring-resident equivalent
            return f"the {cfg.flux.sa_mode} SA mode"
        return None

    def _tokens(self, tokens) -> torch.Tensor:
        if isinstance(tokens, torch.Tensor):
            return tokens.to(device=self.device, dtype=torch.long)
        return torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                               device=self.device)

    def _side_input(self, x) -> Optional[torch.Tensor]:
        """A side input (prefix embeddings, encoder frames; numpy or a
        tensor) on the engine's device, None kept."""
        return None if x is None else torch.as_tensor(x, device=self.device)

    def start_chunked_prefill(self, tokens, override=None, *,
                              reuse: bool = True) -> ChunkedPrefill:
        """Begin a route-then-stream admission; the caller drives
        ``job.step()`` (the continuous scheduler interleaves steps with
        decode ticks; ``prefill_chunked`` runs them back to back).

        With a prefix store and ``reuse``, a B = 1 job starts from the
        deepest matching chunk-boundary snapshot: its covered chunks are
        skipped (``prefix_hit_tokens``) and only the suffix streams.
        ``reuse=False`` opts the request out of lookup and publication."""
        host = (tokens.cpu().numpy() if isinstance(tokens, torch.Tensor)
                else np.asarray(tokens))
        tokens = self._tokens(tokens)
        job = ChunkedPrefill(
            engine=self, tokens=tokens, host_tokens=host,
            override=(override if override is not None
                      else self.routing_override),
            plan=chunk_plan(tokens.shape[1], self.prefill_chunk),
            reuse=reuse, sa_level=self.sa_level)
        if (self.prefix_store is not None and reuse
                and tokens.shape[0] == 1
                and self.chunked_eligible(tokens.shape[1], job.override)):
            self._try_prefix_restore(job)
        return job

    def prefill_chunked(self, tokens, override=None, *,
                        reuse: bool = True) -> ChunkedPrefill:
        """The chunked admission run to completion. Returns the finished
        job (``pattern``/``caches``/``logits``/``p_fa``)."""
        job = self.start_chunked_prefill(tokens, override, reuse=reuse)
        while not job.done:
            job.step()
        return job

    # -- shared-prefix snapshot reuse --------------------------------------
    def _routable(self) -> bool:
        return bool(self.cfg.flux.enabled and self.cfg.routable_layers())

    def _restore_state(self, node: "PXC._Node"):
        """Snapshot → fresh buffers on the engine's device that the
        admission owns (it and its decode write into them in place). A
        host-tier snapshot is first copied to the device and those copies
        are promoted into the store (the next hit skips the transfer);
        either way the job gets a further copy, never a store buffer."""
        snap = node.snap
        caches, logits = snap.caches, snap.logits
        if node.on_host:
            caches, logits = PXC.device_state(caches, logits, self.device)
            self.prefix_store.promote(node, caches, logits)
        return MD.snapshot_state(caches, logits)

    def _try_prefix_restore(self, job: ChunkedPrefill) -> None:
        """Longest-prefix-match ``job``'s prompt against the store and,
        on a hit, seed the job from the snapshot: caches / logits /
        pattern adopted, ``idx`` advanced past every covered chunk."""
        store = self.prefix_store
        toks = job.host_tokens[0]
        node = store.match(toks, PXC.routing_key(job.override,
                                                 job.sa_level))
        if (node is not None and job.override is None
                and not RT.prefix_routing_reusable(
                    self.cfg.flux, node.depth, toks.size,
                    routable=self._routable())):
            node = None  # routing not prefix-determined for this pair
        if node is None:
            store.misses += 1
            if self.telemetry is not None:
                self._prefix_store_event("miss")
            return
        store.acquire(node)  # pin against eviction while restoring
        try:
            snap = node.snap
            job.caches, job.logits = self._restore_state(node)
        finally:
            store.release(node)
        store.hits += 1
        store.hit_tokens += snap.boundary
        if self.telemetry is not None:
            self._prefix_store_event("hit")
        job.pattern = snap.pattern
        job.p_fa = None if snap.p_fa is None else np.array(snap.p_fa)
        job.idx = snap.boundary // self.prefill_chunk
        job.prefix_hit_tokens = snap.boundary
        job.dispatches += 1  # the restore copy

    def _maybe_publish(self, job: ChunkedPrefill, start: int,
                       size: int) -> None:
        """Publish the boundary the job just crossed, when canonical:
        B = 1, a full-chunk boundary (ragged ladder tails differ per
        prompt length and are never shared), and, router-driven, a prefix
        the routing decision transfers across."""
        if (self.prefix_store is None or not job.reuse
                or job.tokens.shape[0] != 1
                or size != self.prefill_chunk
                or not self.chunked_eligible(job.seq_len, job.override)):
            return
        if self.publish_prefix(job.host_tokens[0], start + size,
                               job.caches, job.logits, job.pattern,
                               p_fa=job.p_fa, override=job.override,
                               sa_level=job.sa_level):
            job.dispatches += 1  # the snapshot copy
            job.published += 1

    def publish_prefix(self, tokens, boundary: int, caches, logits,
                       pattern, p_fa=None, override=None,
                       sa_level: int = 0) -> bool:
        """Insert a snapshot of the state at ``tokens[:boundary]`` into
        the prefix store. Returns True iff one was copied and inserted
        (False: a duplicate, routing that does not transfer, or a
        geometry over the whole budget, skipped with a warning).

        Raises ``ValueError`` for states that are not chunk-boundary
        snapshots: an admission that takes the repack fallback, or a
        boundary off the full-chunk grid."""
        store = self.prefix_store
        if store is None:
            raise ValueError(
                "publish_prefix: engine has no prefix store — construct "
                "the ServeEngine with prefix_cache_mb")
        toks = np.asarray(tokens)
        override = override if override is not None else \
            self.routing_override
        if not self.chunked_eligible(toks.size, override):
            raise ValueError(
                f"publish_prefix: this admission takes the monolithic "
                f"repack fallback (chunked_eligible=False for seq_len="
                f"{toks.size}), which has no chunk-boundary state to "
                f"snapshot — its caches are a full-sequence repack and "
                f"its routing may depend on the prompt suffix. Serve the "
                f"request through the chunked path (prefill_chunk set, "
                f"prefix-pooled routing) or skip publication for it")
        if (boundary <= 0 or boundary > toks.size
                or boundary % self.prefill_chunk):
            raise ValueError(
                f"publish_prefix: boundary={boundary} is not a full-chunk "
                f"plan boundary of a length-{toks.size} prompt (chunk="
                f"{self.prefill_chunk}) — snapshots are shareable only at "
                f"multiples of the chunk size")
        if override is None and not RT.prefix_routing_reusable(
                self.cfg.flux, boundary, toks.size,
                routable=self._routable()):
            return False  # decision pooled from tokens past the boundary
        key = PXC.routing_key(override, sa_level)
        if store.covered(toks, boundary, key):
            return False  # already published (LRU slot bumped)
        nbytes = PXC.state_bytes(caches, logits, self.world,
                                  self.kv_replicas)
        whole = store.budget_bytes + store.host_budget_bytes
        if nbytes > whole:
            geom = KC.cache_geometry(caches)
            if geom not in self._snap_skip_warned:
                self._snap_skip_warned.add(geom)
                warnings.warn(
                    f"prefix cache: one snapshot of this routed geometry "
                    f"({nbytes} bytes) exceeds the whole store budget "
                    f"({whole} bytes); skipping publication — raise "
                    f"prefix_cache_mb to cache these admissions")
            return False
        snap_caches, snap_logits = MD.snapshot_state(caches, logits)
        store.insert(toks, PXC.Snapshot(
            caches=snap_caches, logits=snap_logits, pattern=pattern,
            p_fa=None if p_fa is None else np.array(p_fa),
            boundary=boundary, nbytes=nbytes), key)
        return True

    def prefill_route_repack(self, tokens, override=None, *,
                             prefix_embeddings=None, encoder_frames=None,
                             enc_out: Optional[torch.Tensor] = None):
        """Monolithic admission FALLBACK: full-sequence prefill (router
        fires once) → per-request pattern → repack into decode geometry.
        Side inputs as ``MD.prefill`` takes them (``enc_out``: frames
        already encoded, which ``generate`` passes). Returns (pf,
        pattern, caches, seq_len), seq_len counting the prefix."""
        tokens = self._tokens(tokens)
        prefix_embeddings = self._side_input(prefix_embeddings)
        override = (override if override is not None
                    else self.routing_override)
        self._check_override(override)
        routing_ctx, fixed = self._routing_ctx(override)
        with self.parallel():
            pf = MD.prefill(self.params, self.model_cfg, tokens,
                            routing_ctx=routing_ctx, fixed_pattern=fixed,
                            prefix_embeddings=prefix_embeddings,
                            encoder_frames=self._side_input(encoder_frames),
                            fa_threshold=self._rung_threshold(
                                self.sa_level, routing_ctx),
                            enc_out=enc_out)
        decisions = pf.routing.numpy() if pf.routing is not None else None
        pattern = self._pattern(decisions, override)
        if self.telemetry is not None:
            self._record_routing(
                pattern, None if pf.p_fa is None else pf.p_fa.numpy(),
                self.sa_level)
        seq_len = tokens.shape[1] + (0 if prefix_embeddings is None
                                     else prefix_embeddings.shape[1])
        if seq_len > self.max_len:
            off = [i for i, k in enumerate(self.cfg.layer_kinds)
                   if k == "attn" and pattern[i] != "sa"]
            if off:
                raise ValueError(
                    f"prefill_route_repack: prompt length seq_len="
                    f"{seq_len} exceeds the decode cache capacity "
                    f"max_len={self.max_len} at full-cache layer "
                    f"{off[0]}; raise the engine's max_len or truncate "
                    f"the prompt")
        caches = repack_caches(self.model_cfg, pf.caches, pattern, seq_len,
                               self.max_len)
        return pf, pattern, caches, seq_len

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(self, tokens, n_steps: int, *, prefix_embeddings=None,
                 encoder_frames=None, greedy: bool = True,
                 rng=None, routing_override=None,
                 prefix_reuse: bool = True) -> GenerationResult:
        """Admit ``tokens`` (B, S) and decode ``n_steps`` tokens.
        ``prefix_embeddings`` (B, P, d) run before the tokens (a VLM's
        projected image patches: the prompt is P + S long);
        ``encoder_frames`` (B, E, d) are encoded once and attended by
        every decoder layer (a model with an encoder needs them). Either
        sends the request down the monolithic path, as in the JAX
        engine. ``greedy=False`` with an ``rng`` samples each token from
        the softmax of its logits: ``rng`` is a ``torch.Generator`` on
        the engine's device, or an int seed the engine makes one of (the
        same seed, the same tokens). ``greedy or rng is None`` decodes
        greedily, as the JAX engine does. ``prefix_reuse=False`` keeps
        the request out of the prefix store."""
        greedy = bool(greedy or rng is None)
        if not greedy and not isinstance(rng, torch.Generator):
            rng = torch.Generator(device=self.device).manual_seed(int(rng))
        tokens = self._tokens(tokens)
        prefix_embeddings = self._side_input(prefix_embeddings)
        encoder_frames = self._side_input(encoder_frames)
        seq_len = tokens.shape[1] + (0 if prefix_embeddings is None
                                     else prefix_embeddings.shape[1])
        if seq_len > self.max_len:
            raise ValueError(
                f"generate: prompt length {seq_len} exceeds the engine's "
                f"cache capacity max_len={self.max_len}; raise max_len "
                f"or truncate the prompt")
        t_enc = time.perf_counter()
        dispatches = 0
        enc_out = None
        if self._encode is not None:
            with self.parallel():  # each rank its heads
                enc_out = self._encode(encoder_frames)
            dispatches += 1
            self._sync()
        t0 = time.perf_counter()
        prefix_hit = 0
        why = self.repack_reason(seq_len, routing_override,
                                 prefix_embeddings=prefix_embeddings,
                                 encoder_frames=encoder_frames)
        chunked = why is None
        if self.seq_shard is not None and not chunked:
            raise ValueError(
                f"generate: seq_shard serves the chunked prefill only, and "
                f"this request takes the monolithic repack path ({why})")
        if chunked:
            job = self.prefill_chunked(tokens, routing_override,
                                       reuse=prefix_reuse)
            pattern, caches = job.pattern, job.caches
            logits, p_fa = job.logits, job.p_fa
            prefix_hit = job.prefix_hit_tokens
            dispatches += job.dispatches
        else:
            pf, pattern, caches, seq_len = self.prefill_route_repack(
                tokens, routing_override,
                prefix_embeddings=prefix_embeddings, enc_out=enc_out)
            logits = pf.logits
            p_fa = None if pf.p_fa is None else pf.p_fa.numpy()
            dispatches += 2  # prefill + the repack
        if (seq_len + n_steps > self.max_len
                and any(isinstance(c, (KC.FullKV, KC.LatentKV,
                                       KC.SeqShardKV)) for c in caches)):
            raise ValueError(
                f"generate: prompt ({seq_len}) + n_steps ({n_steps}) = "
                f"{seq_len + n_steps} exceeds the cache capacity "
                f"max_len={self.max_len} of the full-cache layers")
        if self.seq_shard is not None:  # every rank routed alike
            self.seq_shard.check_agree(digest(pattern, tuple(tokens.shape)),
                                       "generate: the routing")
        kv = PSH.cache_bytes(caches, self.world, self.kv_replicas)
        self._sync()
        t1 = time.perf_counter()
        fa_heads, duo_layers = MD.routing_head_split(self.cfg, pattern)
        with self.parallel():
            toks, final, _ = MD.decode_many(
                self.params, self.model_cfg, logits, caches, seq_len,
                n_steps=n_steps, greedy=greedy,
                generator=None if greedy else rng, fa_heads=fa_heads,
                duo_layers=duo_layers, enc_out=enc_out)
        toks = toks.cpu().numpy()  # waits for the decode to finish
        t2 = time.perf_counter()
        dispatches += 1  # and the decode
        self.dispatch_count += dispatches
        routed = [p for p in pattern if p is not None]
        msr = (sum(p == "sa" for p in routed) / len(routed)
               if routed else float("nan"))
        return GenerationResult(tokens=toks, routing=pattern, msr=msr,
                                kv_bytes=kv.payload, p_fa=p_fa,
                                logits=logits, final_logits=final,
                                prefill_s=t1 - t0,
                                decode_s=t2 - t1,
                                prefix_hit_tokens=prefix_hit,
                                dispatches=dispatches,
                                encode_s=t0 - t_enc,
                                kv_shard_bytes=kv.payload_shard)

    # -- continuous-batching frontend --------------------------------------
    def scheduler(self, **kw):
        """The engine's ``ContinuousScheduler``, created on first use;
        kwargs configure it then (slots_per_bucket, chunk,
        prefill_chunks_per_tick, clock, slo)."""
        if self._scheduler is None:
            from repro_torch.serve.scheduler import ContinuousScheduler
            kw.setdefault("slo", self.slo)
            self._scheduler = ContinuousScheduler(self, **kw)
        elif kw:
            raise ValueError(
                "scheduler already created; configure it on first call")
        return self._scheduler

    def submit(self, req: "Request") -> int:
        """Queue a request for continuous batching; returns its rid."""
        return self.scheduler().submit(req)

    def step(self):
        """One scheduling tick: stream prefill, admit, decode one chunk per
        geometry pool, retire. Returns the requests finished this tick."""
        return self.scheduler().tick()

    def drain(self) -> "DrainResult":
        """Tick until every submitted request retired. Returns the
        {rid: FinishedRequest} mapping with a ``.summary``: status counts
        and rates, the TTFT split medians, prefix hit accounting, the
        KV / prefix-store byte split and the fidelity probes'."""
        finished = self.scheduler().drain()
        return DrainResult(finished, self._drain_summary(finished))

    def cancel(self, rid: int) -> bool:
        """Cooperatively cancel a continuous-batching request (status
        ``cancelled``, partial tokens kept). False when unknown, already
        finished, or no scheduler exists yet."""
        if self._scheduler is None:
            return False
        return self._scheduler.cancel(rid)

    def inject_fault(self, rid: int) -> None:
        """Fault-injection hook: poison request ``rid``'s resident decode
        slot with NaNs (``SlotPool.poison_slot``). The next tick's
        non-finite sentinel retires exactly that request with status
        ``failed`` and frees the slot; its siblings continue bitwise as
        without the fault (every decode operation is row-independent).
        Raises ``ValueError`` when ``rid`` holds no slot."""
        if self._scheduler is None:
            raise ValueError(
                "inject_fault: no continuous scheduler exists — submit "
                "and tick the request into a decode slot first")
        self._scheduler.inject_fault(rid)

    def _drain_summary(self, finished) -> Dict[str, Any]:
        ms = [f.metrics for f in finished.values()]
        sched = self._scheduler
        pools = list(sched.pools.values()) if sched is not None else []
        stats = kv_cache_stats([c for p in pools for c in p.caches],
                               self.prefix_store, self.world,
                               self.kv_replicas)
        prompt_tokens = sum(m.prompt_len for m in ms)
        hit_tokens = sum(m.prefix_hit_tokens for m in ms)
        fid = [m.fidelity for m in ms if m.fidelity is not None]
        n = len(ms)
        statuses = [f.status for f in finished.values()]
        counts = {s: statuses.count(s) for s in SLO.STATUSES}

        def p50(xs: List[float]) -> float:
            # requests retired before a first token carry NaN TTFTs
            xs = [x for x in xs if np.isfinite(x)]
            return float(np.median(xs)) if xs else float("nan")

        return {
            "n_requests": n,
            "status_counts": counts,
            "shed_rate": counts[SLO.STATUS_SHED] / n if n else 0.0,
            "timeout_rate": counts[SLO.STATUS_TIMEOUT] / n if n else 0.0,
            "sa_level": self.sa_level,
            "ttft_p50_s": p50([m.ttft for m in ms]),
            "prefill_time_p50_s": p50([m.prefill_time for m in ms]),
            "slot_wait_p50_s": p50([m.slot_wait for m in ms]),
            "prompt_tokens": prompt_tokens,
            "prefix_hit_tokens": hit_tokens,
            "prefix_hit_fraction": (hit_tokens / prompt_tokens
                                    if prompt_tokens else 0.0),
            "kv_payload_bytes": stats.payload_bytes,
            "kv_overhead_bytes": stats.overhead_bytes,
            "prefix_device_bytes": stats.prefix_device_bytes,
            "prefix_host_bytes": stats.prefix_host_bytes,
            "prefix_store": (self.prefix_store.stats()
                             if self.prefix_store is not None else None),
            "fidelity_probed": len(fid),
            "fidelity_p50": p50(fid),
            "fidelity_min": min(fid) if fid else float("nan"),
        }


class DrainResult(dict):
    """``{rid: FinishedRequest}`` plus an aggregate ``summary`` dict."""

    def __init__(self, finished, summary: Dict[str, Any]):
        super().__init__(finished)
        self.summary = summary


# ---------------------------------------------------------------------------
# Batch frontend
# ---------------------------------------------------------------------------

@dataclass
class Request:
    rid: int
    tokens: np.ndarray  # (S,)
    n_steps: int        # max new tokens
    eos_id: Optional[int] = None   # stop early on this token
    # higher preempts lower when continuous-batching pools fill;
    # meaningless under serve_batch (no slot contention there)
    priority: int = 0
    routing_override: Optional[Tuple[Any, ...]] = None
    # opt this request out of shared-prefix snapshot reuse: neither
    # seeded from nor published to the engine's prefix store
    prefix_reuse: bool = True
    # TTFT / total budget in seconds from submission (None = the
    # engine's ``slo.default_deadline_s``, itself None by default). An
    # expired request retires with status ``timeout`` at the next tick
    # boundary, whether queued, mid-prefill or mid-decode.
    deadline_s: Optional[float] = None


@dataclass
class FinishedRequest:
    """A request the batch frontend served, with the continuous
    frontend's status vocabulary (``ok`` or ``timeout`` here)."""
    rid: int
    tokens: np.ndarray
    # the bucket's routing; None for a request whose deadline expired
    # before its bucket ran
    routing: Optional[Tuple[Any, ...]]
    # the bucket's result (None when it never ran) and wall time
    result: Optional[GenerationResult] = field(default=None, repr=False)
    wall_s: float = 0.0
    status: str = SLO.STATUS_OK
    metrics: Any = None  # scheduler.RequestMetrics, in the clock's domain


def _trim_eos(tokens: np.ndarray, eos_id: Optional[int]) -> np.ndarray:
    """Cut a generated stream after the first EOS (inclusive)."""
    if eos_id is None:
        return tokens
    hits = np.flatnonzero(tokens == eos_id)
    return tokens[:hits[0] + 1] if hits.size else tokens


def serve_batch_finished(engine: ServeEngine, requests: Sequence[Request],
                         clock: Callable[[], float] = time.monotonic
                         ) -> Dict[int, FinishedRequest]:
    """Bucket requests by (length, n_steps, routing_override,
    prefix_reuse), serve each bucket batched (routing is batch consensus
    inside a bucket; buckets of one request give the paper's per-request
    routing), and trim each stream after its ``eos_id``.

    Every request returns with the continuous frontend's status
    vocabulary. Deadlines count from the call (``clock``). Buckets run
    whole: a request whose deadline expired before its bucket starts
    retires ``timeout`` with no tokens; one that expires while its
    bucket decodes keeps its tokens but is marked ``timeout`` all the
    same. Shedding, preemption and quarantine are scheduler concepts."""
    from repro_torch.serve.scheduler import RequestMetrics
    if engine.tp is not None:  # every rank decides on rank 0's clock
        clock = engine.tp.host_clock(clock)
    t0 = clock()

    def _deadline(r: Request) -> Optional[float]:
        d = (r.deadline_s if r.deadline_s is not None
             else engine.slo.default_deadline_s)
        if d is not None and d <= 0:
            raise ValueError(
                f"request {r.rid}: deadline_s={d} must be positive — a "
                f"non-positive deadline is expired at submission")
        return None if d is None else t0 + d

    def _metrics(r: Request, n: int, now: float) -> "RequestMetrics":
        return RequestMetrics(prompt_len=len(r.tokens), n_generated=n,
                              arrival_t=t0, finish_t=now,
                              admitted_t=t0 if n else None)

    buckets: Dict[Tuple, List[Request]] = {}
    for r in requests:
        buckets.setdefault((len(r.tokens), r.n_steps, r.routing_override,
                            r.prefix_reuse), []).append(r)
    results: Dict[int, FinishedRequest] = {}
    for (_, n_steps, override, reuse), rs in buckets.items():
        now = clock()
        live = []
        for r in rs:
            dl = _deadline(r)
            if dl is not None and now >= dl:
                results[r.rid] = FinishedRequest(
                    rid=r.rid, tokens=np.zeros((0,), np.int64),
                    routing=None, status=SLO.STATUS_TIMEOUT,
                    metrics=_metrics(r, 0, now))
            else:
                live.append(r)
        if not live:
            continue
        w0 = time.perf_counter()
        gen = engine.generate(np.stack([r.tokens for r in live]), n_steps,
                              routing_override=override,
                              prefix_reuse=reuse)
        wall = time.perf_counter() - w0
        now = clock()
        for i, r in enumerate(live):
            dl = _deadline(r)
            toks = _trim_eos(gen.tokens[i], r.eos_id)
            results[r.rid] = FinishedRequest(
                rid=r.rid, tokens=toks, routing=gen.routing, result=gen,
                wall_s=wall,
                status=(SLO.STATUS_TIMEOUT if dl is not None and now >= dl
                        else SLO.STATUS_OK),
                metrics=_metrics(r, len(toks), now))
    return results


def serve_batch(engine: ServeEngine, requests: Sequence[Request]
                ) -> Dict[int, np.ndarray]:
    """Token-only view of ``serve_batch_finished``."""
    return {rid: f.tokens
            for rid, f in serve_batch_finished(engine, requests).items()}
