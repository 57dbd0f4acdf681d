"""Serving engine: route on the first chunk → stream the rest into
decode-geometry caches → greedy decode (port of the single-request half
of ``repro/serve/engine.py``).

Admission is the chunked, cache-resident pipeline of the JAX engine:
  1. The prompt is cut into bucketed chunks (``chunk_plan``). The first
     chunk runs as a small monolithic prefill with prefix-pooled hard
     routing: the Layer Router fires once per layer and the FA/SA pattern
     is frozen (paper §3.3). FA layers run the flash kernel, SA layers
     the sink+local streaming kernel.
  2. Decode-geometry caches are allocated from the pattern and seeded
     with the first chunk's KV (``seed_caches``): a ``FullKV`` per FA
     layer, a sink+local ``RingKV`` per SA layer. Later chunks stream
     through ``prefill_chunk`` straight into them (FA layers on the
     block-sparse kernel, ring layers on a dense masked softmax).
  3. ``decode_many`` generates greedily, a Python loop of decode steps
     on the decode kernel.
``prefill_route_repack`` (full prefill → repack) is the fallback for
prompts the chunked path excludes (``chunked_eligible``).

Two frontends: ``serve_batch`` buckets requests and runs each bucket
through ``generate``; ``submit`` / ``step`` / ``drain`` feed the
continuous-batching slot pool (``serve/scheduler.py``), whose decode runs
one position per slot on the pooled decode kernel.

Not ported yet: telemetry, SLO guardrails, the prefix cache and device
meshes (ROADMAP Queue 1 items 9, 10 and 16).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as MD
from repro_torch.serve import kv_cache as KC


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
                max_len: int, device) -> List:
    """Decode-geometry caches for ``pattern``, seeded with a routing
    chunk's per-layer (k, v) at position 0."""
    caches = KC.init_decode_caches(cfg, pattern, batch, max_len, device)
    sink = cfg.flux.sink
    for (k, v), dec in zip(prefill_caches, caches):
        if isinstance(dec, KC.RingKV):
            ring = dec.k.shape[2]
            KC.ring_insert_chunk(dec, k, v, 0, sink, ring - sink)
        else:
            KC.full_insert_chunk(dec, k, v, 0)
    return caches


def _ring_src(seq_len: int, sink: int, local: int, ring: int) -> np.ndarray:
    """Per-ring-slot source position in the prefill KV (-1 = empty)."""
    src = np.full((ring,), -1, np.int64)
    ns = min(sink, seq_len, ring)
    src[:ns] = np.arange(ns)
    for p in range(max(sink, seq_len - local), seq_len):
        src[sink + (p - sink) % local] = p
    return src


def _gather_ring(k_full: torch.Tensor, src: np.ndarray) -> torch.Tensor:
    """Slots of ``k_full`` (B, H, S, D) at ``src`` along S; -1 → zeros."""
    idx = torch.as_tensor(np.maximum(src, 0), device=k_full.device)
    g = k_full.index_select(2, idx)
    mask = torch.as_tensor(src >= 0, device=k_full.device)
    return torch.where(mask[None, None, :, None], g, torch.zeros_like(g))


def repack_caches(cfg: ModelConfig, prefill_caches, routing,
                  seq_len: int, max_len: int) -> List:
    """Whole-prompt prefill KV (per layer (k, v)) → decode cache list.
    FALLBACK PATH for admissions ``chunked_eligible`` excludes.
    routing[i] ∈ {"fa", "sa"}."""
    flux = cfg.flux
    out = []
    for i, (k, v) in enumerate(prefill_caches):
        B = k.shape[0]
        length = torch.full((B,), seq_len, dtype=torch.int32,
                            device=k.device)
        if routing[i] == "sa":
            ring, sink = KC.sa_ring(flux, max_len)
            src = _ring_src(seq_len, sink, ring - sink, ring)
            pos = torch.as_tensor(src, dtype=torch.int32, device=k.device)
            out.append(KC.RingKV(k=_gather_ring(k, src),
                                 v=_gather_ring(v, src),
                                 positions=pos[None].repeat(B, 1),
                                 length=length))
        else:
            if seq_len > max_len:
                raise ValueError(
                    f"repack_caches: prompt length seq_len={seq_len} "
                    f"exceeds the decode cache capacity max_len={max_len} "
                    f"at full-cache layer {i}; raise the engine's max_len "
                    f"or truncate the prompt")
            pad = max_len - seq_len
            out.append(KC.FullKV(k=F.pad(k, (0, 0, 0, pad)),
                                 v=F.pad(v, (0, 0, 0, pad)),
                                 length=length))
    return out


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

@dataclass
class ChunkedPrefill:
    """An in-flight route-then-stream admission. ``step()`` processes one
    chunk: step 0 is the routing chunk (monolithic prefill over the first
    bucket, then seeded decode caches), every later step streams one
    chunk into those caches. After ``done`` the results live in
    ``pattern`` / ``caches`` / ``logits`` / ``p_fa``."""
    engine: "ServeEngine"
    tokens: torch.Tensor                   # (B, S)
    override: Optional[Tuple[Any, ...]]
    plan: List[Tuple[int, int]]
    idx: int = 0
    pattern: Optional[Tuple[Any, ...]] = None
    caches: Any = None
    logits: Optional[torch.Tensor] = None
    p_fa: Optional[np.ndarray] = None

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
            self.logits, self.caches = MD.prefill_chunk(
                eng.params, eng.cfg, chunk, self.caches, start)
        self.idx += 1

    def _route_chunk(self, chunk: torch.Tensor) -> None:
        eng, cfg = self.engine, self.engine.cfg
        routing_ctx, fixed = eng._routing_ctx(self.override)
        pf = MD.prefill(eng.params, cfg, chunk, routing_ctx=routing_ctx,
                        fixed_pattern=fixed)
        decisions = (pf.routing.numpy() if pf.routing is not None
                     else None)
        self.pattern = eng._pattern(decisions, self.override)
        self.p_fa = None if pf.p_fa is None else pf.p_fa.numpy()
        self.caches = seed_caches(cfg, pf.caches, self.pattern,
                                  chunk.shape[0], eng.max_len, eng.device)
        self.logits = pf.logits


@dataclass
class GenerationResult:
    tokens: np.ndarray            # (B, n_steps)
    routing: Tuple[Any, ...]      # per-layer decode pattern
    msr: float                    # SA fraction over routed layers
    kv_bytes: int                 # decode-cache KV payload
    p_fa: Optional[np.ndarray] = None
    logits: Optional[torch.Tensor] = None  # (B, V) first-step logits
    final_logits: Optional[torch.Tensor] = None  # (B, V) after the last step
    prefill_s: float = 0.0        # host clock, admission incl. routing
    decode_s: float = 0.0         # host clock, the n_steps decode


class ServeEngine:
    """Single-model serving with flux routing.

    ``routing_override``: force a per-layer pattern ("fa" | "sa") instead
    of consulting the router; ``generate`` also accepts a per-request
    override. ``sparse_decode=False`` keeps full KV at every layer
    (routing then affects prefill only). ``prefill_chunk`` is the chunked
    prefill's largest chunk (None/0 = every admission takes the repack
    fallback). ``device`` defaults to cuda; the weights are moved there.
    """

    def __init__(self, params, cfg: ModelConfig, *, max_len: int = 4096,
                 sparse_decode: bool = True, routing_override=None,
                 prefill_chunk: Optional[int] = 512,
                 routing_pooling: str = "prefix", device=None):
        if routing_pooling not in ("prefix", "prefix_suffix"):
            raise ValueError(
                f"routing_pooling={routing_pooling!r}: expected 'prefix' "
                f"(chunk-invariant serving default) or 'prefix_suffix' "
                f"(the paper's pooling; forces the monolithic prefill)")
        MD.check_supported(cfg)
        self.device = resolve_device(device)
        self.params = MD.params_to(params, self.device)
        self.cfg = cfg
        self.max_len = max_len
        self.sparse_decode = sparse_decode
        self.routing_override = routing_override
        self.prefill_chunk = int(prefill_chunk) if prefill_chunk else 0
        self.routing_pooling = routing_pooling
        self._scheduler = None  # ContinuousScheduler, created by scheduler()

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

    def _check_override(self, override) -> None:
        """Raise on what this slice does not serve: duo head-split
        overrides and the xa/ta sparse modes."""
        cfg = self.cfg
        if override is not None:
            if any(isinstance(p, tuple) for p in override):
                raise NotImplementedError(
                    "duo head-split routing overrides wait for ROADMAP "
                    "Queue 1 item 14")
            bad = [p for p in override if p not in ("fa", "sa", None)]
            if bad or len(override) != cfg.num_layers:
                raise ValueError(
                    f"routing override must give 'fa' or 'sa' for each "
                    f"of {cfg.num_layers} layers; got {override!r}")
        routable = bool(cfg.flux.enabled and cfg.routable_layers())
        needs_sa = routable and (override is None
                                 or any(p == "sa" for p in override))
        if needs_sa and cfg.flux.sa_mode != "ssa":
            raise NotImplementedError(
                f"sa_mode={cfg.flux.sa_mode!r} waits for ROADMAP Queue 1 "
                f"item 14")

    def chunked_eligible(self, seq_len: int, override=None) -> bool:
        """True when the chunked cache-resident admission can serve this
        request; False routes it to the monolithic repack fallback."""
        cfg = self.cfg
        override = (override if override is not None
                    else self.routing_override)
        self._check_override(override)
        if not self.prefill_chunk or seq_len <= 0:
            return False
        routable = bool(cfg.flux.enabled and cfg.routable_layers())
        if routable and override is None:
            if not self.sparse_decode:
                return False  # decisions would diverge from geometry
            if self.routing_pooling != "prefix":
                return False  # paper pooling needs the full sequence
            if (chunk_plan(seq_len, self.prefill_chunk)[0][1]
                    < min(cfg.flux.pool_size, seq_len)):
                return False  # first chunk can't cover the router pool
        return True

    def _tokens(self, tokens) -> torch.Tensor:
        if isinstance(tokens, torch.Tensor):
            return tokens.to(device=self.device, dtype=torch.long)
        return torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                               device=self.device)

    def start_chunked_prefill(self, tokens, override=None
                              ) -> ChunkedPrefill:
        """Begin a route-then-stream admission; the caller drives
        ``job.step()`` (the continuous scheduler interleaves steps with
        decode ticks; ``prefill_chunked`` runs them back to back)."""
        tokens = self._tokens(tokens)
        return ChunkedPrefill(
            engine=self, tokens=tokens,
            override=(override if override is not None
                      else self.routing_override),
            plan=chunk_plan(tokens.shape[1], self.prefill_chunk))

    def prefill_chunked(self, tokens, override=None) -> ChunkedPrefill:
        """The chunked admission run to completion. Returns the finished
        job (``pattern``/``caches``/``logits``/``p_fa``)."""
        job = self.start_chunked_prefill(tokens, override)
        while not job.done:
            job.step()
        return job

    def prefill_route_repack(self, tokens, override=None):
        """Monolithic admission FALLBACK: full-sequence prefill (router
        fires once) → per-request pattern → repack into decode geometry.
        Returns (pf, pattern, caches, seq_len)."""
        tokens = self._tokens(tokens)
        override = (override if override is not None
                    else self.routing_override)
        self._check_override(override)
        routing_ctx, fixed = self._routing_ctx(override)
        pf = MD.prefill(self.params, self.cfg, tokens,
                        routing_ctx=routing_ctx, fixed_pattern=fixed)
        decisions = pf.routing.numpy() if pf.routing is not None else None
        pattern = self._pattern(decisions, override)
        seq_len = tokens.shape[1]
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
        caches = repack_caches(self.cfg, pf.caches, pattern, seq_len,
                               self.max_len)
        return pf, pattern, caches, seq_len

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(self, tokens, n_steps: int, *, greedy: bool = True,
                 routing_override=None) -> GenerationResult:
        """Admit ``tokens`` (B, S) and decode ``n_steps`` tokens greedily."""
        if not greedy:
            raise NotImplementedError(
                "sampled decoding (greedy=False) waits for ROADMAP Queue 1 "
                "item 17")
        tokens = self._tokens(tokens)
        seq_len = tokens.shape[1]
        if seq_len > self.max_len:
            raise ValueError(
                f"generate: prompt length {seq_len} exceeds the engine's "
                f"cache capacity max_len={self.max_len}; raise max_len "
                f"or truncate the prompt")
        t0 = time.perf_counter()
        if self.chunked_eligible(seq_len, routing_override):
            job = self.prefill_chunked(tokens, routing_override)
            pattern, caches = job.pattern, job.caches
            logits, p_fa = job.logits, job.p_fa
        else:
            pf, pattern, caches, seq_len = self.prefill_route_repack(
                tokens, routing_override)
            logits = pf.logits
            p_fa = None if pf.p_fa is None else pf.p_fa.numpy()
        if (seq_len + n_steps > self.max_len
                and any(isinstance(c, KC.FullKV) for c in caches)):
            raise ValueError(
                f"generate: prompt ({seq_len}) + n_steps ({n_steps}) = "
                f"{seq_len + n_steps} exceeds the cache capacity "
                f"max_len={self.max_len} of the full-cache layers")
        kv_bytes = KC.kv_cache_bytes(caches)
        self._sync()
        t1 = time.perf_counter()
        toks, final, _ = MD.decode_many(self.params, self.cfg, logits,
                                        caches, seq_len, n_steps=n_steps)
        toks = toks.cpu().numpy()  # waits for the decode to finish
        t2 = time.perf_counter()
        routed = [p for p in pattern if p is not None]
        msr = (sum(p == "sa" for p in routed) / len(routed)
               if routed else float("nan"))
        return GenerationResult(tokens=toks, routing=pattern, msr=msr,
                                kv_bytes=kv_bytes, p_fa=p_fa,
                                logits=logits, final_logits=final,
                                prefill_s=t1 - t0,
                                decode_s=t2 - t1)

    # -- continuous-batching frontend --------------------------------------
    def scheduler(self, **kw):
        """The engine's ``ContinuousScheduler``, created on first use;
        kwargs configure it then (slots_per_bucket, chunk,
        prefill_chunks_per_tick, clock)."""
        if self._scheduler is None:
            from repro_torch.serve.scheduler import ContinuousScheduler
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
        """Tick until every submitted request finished. Returns the
        {rid: FinishedRequest} mapping with a ``.summary``."""
        sched = self.scheduler()
        finished = sched.drain()
        return DrainResult(finished, sched.summary(finished))


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


@dataclass
class FinishedRequest:
    rid: int
    tokens: np.ndarray
    routing: Tuple[Any, ...]
    result: GenerationResult = field(repr=False)  # the bucket's result
    wall_s: float = 0.0                           # the bucket's wall time


def _trim_eos(tokens: np.ndarray, eos_id: Optional[int]) -> np.ndarray:
    """Cut a generated stream after the first EOS (inclusive)."""
    if eos_id is None:
        return tokens
    hits = np.flatnonzero(tokens == eos_id)
    return tokens[:hits[0] + 1] if hits.size else tokens


def serve_batch_finished(engine: ServeEngine, requests: Sequence[Request]
                         ) -> Dict[int, FinishedRequest]:
    """Bucket requests by (length, n_steps, routing_override), serve each
    bucket batched (routing is batch consensus inside a bucket; buckets
    of one request give the paper's per-request routing), and trim each
    stream after its ``eos_id``."""
    buckets: Dict[Tuple, List[Request]] = {}
    for r in requests:
        buckets.setdefault((len(r.tokens), r.n_steps, r.routing_override),
                           []).append(r)
    results: Dict[int, FinishedRequest] = {}
    for (_, n_steps, override), rs in buckets.items():
        t0 = time.perf_counter()
        gen = engine.generate(np.stack([r.tokens for r in rs]), n_steps,
                              routing_override=override)
        wall = time.perf_counter() - t0
        for i, r in enumerate(rs):
            results[r.rid] = FinishedRequest(
                rid=r.rid, tokens=_trim_eos(gen.tokens[i], r.eos_id),
                routing=gen.routing, result=gen, wall_s=wall)
    return results


def serve_batch(engine: ServeEngine, requests: Sequence[Request]
                ) -> Dict[int, np.ndarray]:
    """Token-only view of ``serve_batch_finished``."""
    return {rid: f.tokens
            for rid, f in serve_batch_finished(engine, requests).items()}
