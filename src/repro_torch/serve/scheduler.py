"""Continuous-batching admission/step scheduler (port of
``repro/serve/scheduler.py``).

The engine's ``generate`` serves one bucket end to end; this scheduler
keeps a persistent decode batch that requests join and leave per tick:

  admit   — stream a waiting request's prompt through the chunked
            cache-resident prefill at B = 1 (the Layer Router fires once
            per request, on the first chunk), then copy its decode caches
            into a free slot of the pool matching its *cache geometry*.
            Prefill chunks are tick work: at most
            ``prefill_chunks_per_tick`` run per tick, interleaved with the
            decode chunks below, so a long prompt cannot stall the
            resident batch. Requests ``chunked_eligible`` excludes (the
            ``xa`` / ``ta`` SA modes among them) admit through the
            monolithic repack fallback; a duo head-split pattern raises,
            as in the JAX scheduler (``generate`` serves it), and so
            does the constructor for a model whose requests carry a
            modality side input (phi-3-vision, whisper). With the engine's
            prefix store, an admission starts from the deepest matching
            chunk-boundary snapshot and streams only the suffix
            (``RequestMetrics.prefix_hit_tokens``), and publishes the
            boundaries it streams.
  step    — per tick, one ``decode_many`` chunk of ``chunk`` steps for
            every pool with active slots, with one position per slot, on
            the pooled decode kernel.
  retire  — finished slots (EOS / max new tokens) are freed; their rows
            are overwritten by the next admission.
  preempt — when a pool is full, an arrival with strictly higher
            priority evicts the lowest-priority slot; the victim is
            re-queued and later re-prefilled over its prompt plus the
            tokens generated so far (recompute preemption).

On top sits the SLO ladder (``serve/slo.py``): every request retires
exactly once with an explicit status — ``ok``, ``timeout`` (its deadline
expired, queued, mid-prefill or resident), ``shed`` (the bounded queue
rejected it), ``cancelled`` (``cancel``) or ``failed`` (the per-tick
non-finite sentinel quarantined its slot) — and overload walks a
degradation ladder instead of a cliff: shed at submission, budgeted
preemption with admission-only aging, and the load-adaptive sparsity
dial, which raises the router's FA threshold one rung at a time under
queue pressure. All guardrails default off; a default ``SLOConfig``
gives the unguarded scheduler's tokens, kernel launches and device reads.

With the engine's telemetry, each tick also feeds the metrics registry,
the request-span tracer and the flight recorder, the memory ledger
(pool bytes from shapes and occupancy), and on every ``profile_every``-th
tick the cost profiler, which alone adds device syncs.

Decoding is greedy, and every operation of the decode step is
row-independent, so a request's tokens equal those of ``generate`` of
that request alone, and a poisoned slot's siblings decode bitwise as in
an unfaulted run.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed import sharding as SH
from repro_torch.distributed.group import digest
from repro_torch.models import model as MD
from repro_torch.serve import kv_cache as KC
from repro_torch.serve import slo as SLO
from repro_torch.serve import telemetry as TM
from repro_torch.serve import tracing as TR
from repro_torch.serve.engine import _trim_eos
from repro_torch.serve.slo import (STATUS_CANCELLED, STATUS_FAILED,
                                   STATUS_OK, STATUS_SHED, STATUS_TIMEOUT)
from repro_torch.serve.slots import SlotPool


@dataclass
class RequestMetrics:
    """Per-request serving metrics (seconds, ``clock`` domain)."""
    prompt_len: int = 0
    n_generated: int = 0
    arrival_t: float = 0.0
    admitted_t: Optional[float] = None   # first admission
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    preemptions: int = 0
    # [prefill_start_t, prefill_done_t] brackets the chunked prefill of
    # the admission that finally landed (reset on preemption)
    prefill_start_t: Optional[float] = None
    prefill_done_t: Optional[float] = None
    # prompt tokens seeded from a warm prefix snapshot at the admission
    # that landed (0 on a miss, reset on preemption)
    prefix_hit_tokens: int = 0
    # fidelity probe of a sampled admission (None = not probed): mean
    # attention-mass coverage over the routed layers, and the lowest
    # among the layers routed SA
    fidelity: Optional[float] = None
    fidelity_sa_min: Optional[float] = None

    @property
    def queue_delay(self) -> float:
        return (self.admitted_t or self.arrival_t) - self.arrival_t

    @property
    def prefill_time(self) -> float:
        """Wall clock spent streaming this request's prefill chunks."""
        if self.prefill_start_t is None or self.prefill_done_t is None:
            return 0.0
        return self.prefill_done_t - self.prefill_start_t

    @property
    def slot_wait(self) -> float:
        """Queue delay net of prefill: time spent waiting for a tick's
        prefill budget or a free slot."""
        return max(self.queue_delay - self.prefill_time, 0.0)

    @property
    def ttft(self) -> float:
        """Time to first token, from arrival; NaN for a request that
        never produced one (shed, cancelled or expired before its first
        decode chunk)."""
        if self.first_token_t is None:
            return float("nan")
        return self.first_token_t - self.arrival_t

    @property
    def decode_tps(self) -> float:
        if self.finish_t is None or self.admitted_t is None:
            return float("nan")
        dt = self.finish_t - self.admitted_t
        return self.n_generated / dt if dt > 0 else float("inf")


@dataclass
class FinishedRequest:
    rid: int
    tokens: np.ndarray                   # (n_generated,)
    # pattern of the final admission; None when the request retired
    # before it ever routed (shed, expired or cancelled in the queue)
    routing: Optional[Tuple[Any, ...]]
    metrics: RequestMetrics
    status: str = STATUS_OK              # one of slo.STATUSES


@dataclass
class _InFlight:
    """Host-side record of a submitted request."""
    req: Any                     # serve.engine.Request
    metrics: RequestMetrics
    generated: List[int] = field(default_factory=list)
    pattern: Optional[Tuple[Any, ...]] = None
    # absolute expiry time in the clock's domain (None = no deadline)
    deadline_t: Optional[float] = None
    # in-flight chunked prefill (engine.ChunkedPrefill), advanced by the
    # tick's prefill budget and packed into a slot once done; a finished
    # job whose pool is full waits with its caches, nothing is recomputed
    job: Optional[Any] = None
    # pool key seen at the last failed MONOLITHIC admission: a fallback
    # request whose pool is still full skips its re-prefill
    cached_key: Optional[Tuple] = None


class ContinuousScheduler:
    """Slot-pool continuous batching over a ``ServeEngine``.

    ``slots_per_bucket``: capacity of each geometry bucket's pool.
    ``chunk``: decode steps per tick per pool, the scheduling quantum.
    ``prefill_chunks_per_tick``: prefill chunks streamed per tick across
    all in-flight admissions, the prefill quantum.
    ``clock``: injectable time source (tests pass a virtual clock).
    ``slo``: guardrail config (``serve/slo.py``); all off by default.
    """

    def __init__(self, engine, *, slots_per_bucket: int = 4,
                 chunk: int = 8, prefill_chunks_per_tick: int = 1,
                 clock: Callable[[], float] = time.monotonic,
                 slo: Optional[SLO.SLOConfig] = None):
        if engine.cfg.num_encoder_layers or engine.cfg.num_prefix_tokens:
            raise ValueError(
                "continuous batching supports decoder-only text requests; "
                "encoder/prefix modalities carry per-request side inputs "
                "the slot pool does not hold yet")
        if getattr(engine, "seq_shard", None) is not None:
            raise ValueError(
                "continuous batching conflicts with seq_shard: the slot "
                "pool batches short requests on per-slot positions and "
                "never shards a cache's sequence; serve seq_shard "
                "requests through generate")
        if slots_per_bucket < 1:
            raise ValueError(
                f"slots_per_bucket={slots_per_bucket} must be >= 1: a "
                f"zero-capacity pool can never admit, so every request "
                f"would wait forever")
        if chunk < 1:
            raise ValueError(
                f"chunk={chunk} must be >= 1 decode step per tick: a "
                f"zero-step chunk generates no tokens and no request can "
                f"ever finish")
        if prefill_chunks_per_tick < 1:
            raise ValueError(
                f"prefill_chunks_per_tick={prefill_chunks_per_tick} must "
                f"be >= 1: with a zero budget a chunked-eligible request "
                f"can never admit. To disable mixed ticks, build the "
                f"engine with prefill_chunk=None instead")
        self.engine = engine
        self.slots_per_bucket = int(slots_per_bucket)
        self.chunk = int(chunk)
        self.prefill_chunks_per_tick = int(prefill_chunks_per_tick)
        # under tensor parallelism every rank runs this scheduler on the
        # same submissions: the clock is rank 0's reading, and the ranks
        # compare a digest of their decisions at each tick's start
        # (submissions and cancels since the last tick) and end
        tp = engine.tp
        self.clock = clock if tp is None else tp.host_clock(clock)
        self._decisions: Optional[List[Tuple]] = \
            None if tp is None else []
        self.slo = slo if slo is not None else SLO.SLOConfig()
        # one source of truth for the sparsity ladder: the engine's dial
        # (generate and chunked admissions) follows this config
        engine.slo = self.slo
        # the engine's submit / step / drain and its reports drive the
        # newest scheduler
        engine._scheduler = self
        self.load = SLO.LoadTracker(self.slo)
        self.waiting: List[_InFlight] = []
        self.pools: Dict[Tuple, SlotPool] = {}
        self.finished: List[FinishedRequest] = []
        self.closed = False           # set by drain(); submit then raises
        self._announce: List[FinishedRequest] = []  # retired since last tick
        self.ticks = 0
        self.tokens_generated = 0
        self.prefill_chunk_ticks = 0  # prefill chunks streamed, lifetime
        # (pattern, prefill length, prefix hit boundary) of every
        # admission, in order: what the prefill kernels ran for (the
        # chunks past the hit), preemption recomputes included
        self.admissions: List[Tuple[Tuple[Any, ...], int, int]] = []
        # telemetry bookkeeping (read only when engine.telemetry is set):
        # non-ok lifecycle events since the last tick, a small-int id per
        # geometry pool for trace / recorder labels, and the watermarks
        # of the per-tick deltas
        self._tm_events: List[str] = []
        self._tm_pool_ids: Dict[Tuple, int] = {}
        self._tm_transitions = 0
        self._tm_prefix: Tuple[int, int] = (0, 0)
        self._tm_sa_level = engine.sa_level

    # -- submission --------------------------------------------------------
    def submit(self, req) -> int:
        """Queue a request (``serve.engine.Request``); returns its rid.

        A bounded queue (``slo.max_queue``) may retire the arrival, or a
        lower-priority waiter, at once with status ``shed``; the next
        ``tick`` announces it and ``drain`` returns it like any other."""
        if self.closed:
            raise ValueError(
                f"submit after drain: request {req.rid} would queue on a "
                f"drained scheduler that no longer ticks and would never "
                f"be served; create a new scheduler")
        max_len = self.engine.max_len
        if len(req.tokens) > max_len:
            raise ValueError(
                f"request {req.rid}: prompt length {len(req.tokens)} "
                f"exceeds the engine's cache capacity max_len={max_len}; "
                f"raise max_len or truncate the prompt")
        need = len(req.tokens) + req.n_steps
        if need > max_len:
            raise ValueError(
                f"request {req.rid}: prompt ({len(req.tokens)}) + n_steps "
                f"({req.n_steps}) = {need} exceeds the engine's cache "
                f"capacity max_len={max_len}; a preemption recompute "
                f"would not fit its cache")
        deadline = req.deadline_s
        if deadline is not None and deadline <= 0:
            raise ValueError(
                f"request {req.rid}: deadline_s={deadline} must be "
                f"positive — a non-positive deadline is expired at "
                f"submission and can never be served")
        if deadline is None:
            deadline = self.slo.default_deadline_s
        now = self.clock()
        inf = _InFlight(req=req, metrics=RequestMetrics(
            prompt_len=len(req.tokens), arrival_t=now),
            deadline_t=(now + deadline) if deadline is not None else None)
        eng = self.engine
        self._note("submit", req.rid,
                   digest(np.asarray(req.tokens).tobytes()), req.n_steps,
                   req.priority, req.routing_override, req.prefix_reuse,
                   deadline)
        if eng.telemetry is not None:
            eng.telemetry.counter("serve_requests_submitted_total").inc()
        if eng.tracer is not None:
            eng.tracer.name_thread(TR.PID_REQUESTS, req.rid,
                                   f"req{req.rid}", sort_index=req.rid)
            eng.tracer.instant(
                "submit", TR.PID_REQUESTS, req.rid, now,
                args={"prompt_len": len(req.tokens),
                      "n_steps": req.n_steps, "priority": req.priority})
        if (self.slo.max_queue is not None
                and len(self.waiting) >= self.slo.max_queue):
            victim = self._shed_victim(inf)
            if victim is not inf:
                self.waiting.remove(victim)
                self.waiting.append(inf)
            self._retire(victim, STATUS_SHED, now)
            return req.rid
        self.waiting.append(inf)
        return req.rid

    def _shed_victim(self, inf: _InFlight) -> _InFlight:
        """Whom the full queue rejects: the arrival (``reject_newest``), or
        the lowest-priority waiter when the arrival strictly outranks it
        (``drop_lowest_priority``; ties shed the arrival)."""
        if self.slo.shed_policy == SLO.SHED_REJECT_NEWEST:
            return inf
        victim = min(self.waiting,
                     key=lambda w: (w.req.priority, -w.metrics.arrival_t))
        return victim if victim.req.priority < inf.req.priority else inf

    # -- tensor-parallel agreement ------------------------------------------
    def _note(self, *event) -> None:
        """Record a host decision for the ranks' digest check."""
        if self._decisions is not None:
            self._decisions.append(event)

    def _check_decisions(self, what: str) -> None:
        """Every rank compares a digest of the decisions noted since the
        last check (``TPGroup.check_agree``); a mismatch raises
        ``TPDivergence`` naming ``what``."""
        if self._decisions is None:
            return
        events, self._decisions = self._decisions, []
        self.engine.tp.check_agree(digest(*events), what)

    # -- terminal transitions ----------------------------------------------
    def _retire(self, inf: _InFlight, status: str, now: float, *,
                pool: Optional[SlotPool] = None,
                slot: Optional[int] = None) -> FinishedRequest:
        """The one terminal transition: every request leaves through here
        exactly once, with its status and the tokens it generated, and
        frees its slot when it was resident."""
        m = inf.metrics
        m.finish_t = now
        m.n_generated = len(inf.generated)
        inf.job = None
        self._note("retire", inf.req.rid, status)
        if pool is not None:
            pool.active.pop(slot)
            pool.free.append(slot)
        f = FinishedRequest(rid=inf.req.rid,
                            tokens=np.asarray(inf.generated, np.int64),
                            routing=inf.pattern, metrics=m, status=status)
        self.finished.append(f)
        self._announce.append(f)
        if self.engine.telemetry is not None:
            self._tm_retire(f, now)
        return f

    def _tm_retire(self, f: FinishedRequest, now: float) -> None:
        """Telemetry of one retirement: the status counter, the latency
        histograms, and the request's lifetime span with its queue /
        prefill / decode phases, from timestamps already taken."""
        eng = self.engine
        m = f.metrics
        if f.status != STATUS_OK:
            self._tm_events.append(f"{f.status}:{f.rid}")
        reg = eng.telemetry
        reg.counter("serve_requests_finished_total", status=f.status).inc()
        if m.first_token_t is not None:
            reg.histogram("serve_ttft_seconds",
                          "time to first token, from arrival"
                          ).observe(m.ttft)
        if m.admitted_t is not None:
            reg.histogram("serve_queue_delay_seconds",
                          "arrival to (final) admission"
                          ).observe(m.queue_delay)
        if m.prefill_time > 0:
            reg.histogram("serve_prefill_seconds",
                          "wall clock streaming the landed admission's "
                          "prefill chunks").observe(m.prefill_time)
        tracer = eng.tracer
        rid = f.rid
        tracer.name_thread(TR.PID_REQUESTS, rid, f"req{rid}", sort_index=rid)
        span_args = {"status": f.status, "prompt_len": m.prompt_len,
                     "n_generated": m.n_generated,
                     "preemptions": m.preemptions,
                     "prefix_hit_tokens": m.prefix_hit_tokens}
        if m.fidelity is not None:
            span_args["fidelity"] = round(m.fidelity, 6)
            if m.fidelity_sa_min is not None:
                span_args["fidelity_sa_min"] = round(m.fidelity_sa_min, 6)
        tracer.complete(f"req{rid}", TR.PID_REQUESTS, rid, m.arrival_t, now,
                        args=span_args)
        if m.admitted_t is not None:
            tracer.complete("queue", TR.PID_REQUESTS, rid,
                            m.arrival_t, m.admitted_t, cat="phase")
            tracer.complete("decode", TR.PID_REQUESTS, rid,
                            m.admitted_t, now, cat="phase")
        if m.prefill_start_t is not None and m.prefill_done_t is not None:
            tracer.complete("prefill", TR.PID_REQUESTS, rid,
                            m.prefill_start_t, m.prefill_done_t,
                            cat="phase")
        tracer.instant(f"retire:{f.status}", TR.PID_REQUESTS, rid, now)

    def _resident(self, rid: int) -> Optional[Tuple[SlotPool, int]]:
        for pool in self.pools.values():
            for slot, inf in pool.active.items():
                if inf.req.rid == rid:
                    return pool, slot
        return None

    def cancel(self, rid: int) -> bool:
        """Cooperative cancellation: retire ``rid`` with status
        ``cancelled``, keeping its tokens. A resident request leaves at
        the current tick boundary and its slot frees at once. False when
        the rid is unknown or already finished."""
        now = self.clock()
        for inf in self.waiting:
            if inf.req.rid == rid:
                self.waiting.remove(inf)
                self._retire(inf, STATUS_CANCELLED, now)
                return True
        where = self._resident(rid)
        if where is None:
            return False
        pool, slot = where
        self._retire(pool.active[slot], STATUS_CANCELLED, now, pool=pool,
                     slot=slot)
        return True

    def inject_fault(self, rid: int) -> None:
        """Poison the resident decode state of ``rid`` with NaNs (see
        ``ServeEngine.inject_fault``)."""
        where = self._resident(rid)
        if where is None:
            raise ValueError(
                f"inject_fault: request {rid} is not resident in any decode "
                f"slot (still waiting, already finished, or unknown) — the "
                f"fault hook poisons live slot state, so admit the request "
                f"first (tick until it holds a slot)")
        pool, slot = where
        pool.poison_slot(slot)

    def _expire(self, now: float) -> None:
        """Retire everything past its deadline, queued (an in-flight
        prefill job is dropped) and resident alike. Expiry is checked at
        tick boundaries, so a resident request keeps the tokens of the
        chunks it finished."""
        keep = []
        for inf in self.waiting:
            if inf.deadline_t is not None and now >= inf.deadline_t:
                self._retire(inf, STATUS_TIMEOUT, now)
            else:
                keep.append(inf)
        self.waiting = keep
        for pool in self.pools.values():
            for slot, inf in list(pool.active.items()):
                if inf.deadline_t is not None and now >= inf.deadline_t:
                    self._retire(inf, STATUS_TIMEOUT, now, pool=pool,
                                 slot=slot)

    # -- priorities: aging + preemption budget ------------------------------
    def _eff_priority(self, inf: _InFlight, now: float) -> float:
        """Admission priority with aging: a waiter gains one unit per
        ``aging_s`` seconds. Admission only: ``_preempt`` compares raw
        priorities, so two aged requests cannot evict each other in
        turn."""
        if self.slo.aging_s is None:
            return float(inf.req.priority)
        return (inf.req.priority
                + (now - inf.metrics.arrival_t) / self.slo.aging_s)

    def _evictable(self, inf: _InFlight) -> bool:
        """Preemption budget: a request preempted ``preemption_budget``
        times keeps its slot from then on."""
        budget = self.slo.preemption_budget
        return budget is None or inf.metrics.preemptions < budget

    # -- admission ---------------------------------------------------------
    def _prefill_tokens(self, inf: _InFlight) -> np.ndarray:
        """Prompt plus tokens generated before a preemption: recompute
        preemption replays the request's own history through prefill."""
        if not inf.generated:
            return np.asarray(inf.req.tokens)
        return np.concatenate([np.asarray(inf.req.tokens),
                               np.asarray(inf.generated, np.int64)])

    def _has_victim(self, pool: SlotPool, priority: int) -> bool:
        return any(v.req.priority < priority and self._evictable(v)
                   for v in pool.active.values())

    def _prefill_work(self, pending: List[_InFlight]) -> Tuple[int, int]:
        """Stream up to ``prefill_chunks_per_tick`` chunks across the
        waiting requests' admission jobs, in (aged) priority-then-arrival
        order. Returns (chunks streamed, prompt tokens streamed) for the
        profiler."""
        eng = self.engine
        budget = self.prefill_chunks_per_tick
        chunks = tokens_streamed = 0
        for inf in pending:
            if budget <= 0:
                break
            if inf.job is None:
                tokens = self._prefill_tokens(inf)
                if not eng.chunked_eligible(len(tokens),
                                            inf.req.routing_override):
                    continue  # the monolithic fallback admits in _admit
                inf.job = eng.start_chunked_prefill(
                    tokens[None], inf.req.routing_override,
                    reuse=inf.req.prefix_reuse)
                # clamp to the prompt: a preemption recompute replays
                # prompt + generated, and its hit may cover tokens this
                # request generated itself, which are not prompt tokens
                # served warm
                inf.metrics.prefix_hit_tokens = min(
                    inf.job.prefix_hit_tokens, inf.metrics.prompt_len)
                inf.metrics.prefill_start_t = self.clock()
            while budget > 0 and not inf.job.done:
                t0 = self.clock() if eng.tracer is not None else 0.0
                tokens_streamed += inf.job.plan[inf.job.idx][1]
                inf.job.step()
                self.prefill_chunk_ticks += 1
                chunks += 1
                budget -= 1
                if eng.telemetry is not None:
                    eng.telemetry.counter("serve_prefill_chunks_total").inc()
                    eng.tracer.complete(
                        "prefill_chunk", TR.PID_REQUESTS, inf.req.rid,
                        t0, self.clock(), cat="phase")
            if inf.job.done and inf.metrics.prefill_done_t is None:
                inf.metrics.prefill_done_t = self.clock()
        return chunks, tokens_streamed

    def _admit(self, inf: _InFlight) -> bool:
        eng = self.engine
        if inf.job is not None:
            # chunked admission: pack only once the stream finished
            if not inf.job.done:
                return False
            pattern, caches = inf.job.pattern, inf.job.caches
            logits, seq_len = inf.job.logits, inf.job.seq_len
            hit = inf.job.prefix_hit_tokens
        elif eng.chunked_eligible(len(self._prefill_tokens(inf)),
                                  inf.req.routing_override):
            # eligible, but this tick's prefill budget ran out before its
            # job started: wait, don't fall back
            return False
        else:
            if inf.cached_key is not None:
                known = self.pools.get(inf.cached_key)
                if (known is not None and not known.free
                        and not self._has_victim(known, inf.req.priority)):
                    return False  # pool still full: skip the re-prefill
            pf, pattern, caches, seq_len = eng.prefill_route_repack(
                self._prefill_tokens(inf)[None], inf.req.routing_override)
            logits, hit = pf.logits, 0
            eng.dispatch_count += 2  # prefill + the repack
        if any(isinstance(p, tuple) for p in pattern):
            raise ValueError(
                "duo head-split patterns carry traced per-layer state the "
                "slot pool does not thread yet; serve them via generate()")
        key = KC.slot_geometry(caches)
        pool = self.pools.get(key)
        if pool is None:
            pool = SlotPool.create(eng.cfg, pattern, self.slots_per_bucket,
                                   eng.max_len, logits, world=eng.world)
            self.pools[key] = pool
        if pool.free:
            slot = pool.free.pop()
        else:
            slot = self._preempt(pool, inf.req.priority)
            if slot is None:
                inf.cached_key = key
                return False  # pool full of equal or higher priority work
        now = self.clock()
        if inf.metrics.admitted_t is None:
            inf.metrics.admitted_t = now
        inf.pattern, inf.cached_key = pattern, None
        pool.write(slot, caches, logits, seq_len)
        pool.active[slot] = inf
        self._note("admit", inf.req.rid, slot, seq_len, hit)
        self.admissions.append((pattern, seq_len, hit))
        if eng.fidelity_probe_every:
            rid = inf.req.rid

            def agree(due):
                # the ranks agree on the probe before its reduces
                self._note("probe", rid, bool(due))
                self._check_decisions(f"the fidelity probe of request {rid}")
            cov = eng._maybe_fidelity_probe(
                self._prefill_tokens(inf), pattern,
                agree=agree if eng.tp is not None else None)
            if cov is not None and cov.size:
                inf.metrics.fidelity = float(np.mean(cov))
                sa = [float(cov[j]) for j, i in
                      enumerate(eng.cfg.routable_layers())
                      if j < cov.size and pattern[i] == "sa"]
                if sa:
                    inf.metrics.fidelity_sa_min = min(sa)
        if inf.job is not None:
            eng.dispatch_count += inf.job.dispatches
            inf.job = None
        return True

    def _preempt(self, pool: SlotPool, priority: int) -> Optional[int]:
        """Evict the lowest-priority evictable slot (the newest arrival
        among equals) if it is strictly below ``priority``; the victim
        re-queues for a recompute admission. A request whose preemption
        budget is spent is skipped: it runs to completion."""
        cands = [(s, v) for s, v in pool.active.items()
                 if self._evictable(v)]
        if not cands:
            return None
        slot, victim = min(cands, key=lambda kv: (kv[1].req.priority,
                                                  -kv[1].metrics.arrival_t))
        if victim.req.priority >= priority:
            return None
        pool.active.pop(slot)
        self._note("preempt", victim.req.rid, slot)
        m = victim.metrics
        m.preemptions += 1
        victim.cached_key = None  # its tokens grew; routing may change
        victim.job = None         # recompute prefill over prompt+generated
        m.prefill_start_t = m.prefill_done_t = None
        m.prefix_hit_tokens = 0
        self.waiting.append(victim)
        eng = self.engine
        if eng.telemetry is not None:
            eng.telemetry.counter("serve_preemptions_total").inc()
            self._tm_events.append(f"preempt:{victim.req.rid}")
            eng.tracer.instant("preempt", TR.PID_REQUESTS, victim.req.rid,
                               self.clock(), args={"by_priority": priority})
        return slot

    # -- one scheduling tick -----------------------------------------------
    def tick(self) -> List[FinishedRequest]:
        """Expire deadlines, turn the sparsity dial, stream prefill
        chunks, admit finished admissions, decode one chunk per pool,
        retire finished slots and quarantine non-finite ones. Returns the
        requests that retired since the last tick (sheds at submission
        included).

        On a profiler-sampled tick each phase ends at a device sync. The
        port's kernels run while the host still enqueues, so a phase's
        ``device_s`` is the wall from its start to that sync (the card
        is idle at the start) and its ``host_s`` the enqueue inside it."""
        eng = self.engine
        self.ticks += 1
        self._check_decisions(f"submissions and cancels before tick "
                              f"{self.ticks}")
        now = self.clock()
        tm_on = eng.telemetry is not None
        prof = eng.profiler
        # prof_on gates every sync below: unsampled ticks read the device
        # exactly as a profiler-off run does
        prof_on = prof is not None and prof.should_sample(self.ticks)
        if prof_on:
            prof.note_sampled_tick()
        if tm_on:
            tm_t0, tm_d0 = now, eng.dispatch_count
            tm_p0, tm_tok0 = self.prefill_chunk_ticks, self.tokens_generated
        self._expire(now)
        if self.slo.adaptive_sparsity:
            cap = sum(p.capacity for p in self.pools.values())
            eng.set_sa_level(self.load.observe(
                len(self.waiting), cap or self.slots_per_bucket))
        # admit in (aged) priority order, oldest first within a priority;
        # _admit may re-queue preemption victims onto self.waiting, so
        # iterate a snapshot and let victims wait for the next tick
        pending = sorted(self.waiting,
                         key=lambda i: (-self._eff_priority(i, now),
                                        i.metrics.arrival_t))
        if prof_on:
            # pure host work so far: expiry, the dial, the sort
            prof.record("queue", host_s=self.clock() - now,
                        count=len(pending))
            eng.device_sync()  # the prefill phase starts on an idle card
        t_pf = self.clock() if prof_on else 0.0
        pf_chunks, pf_tokens = self._prefill_work(pending)
        if prof_on:
            t_host = self.clock()
            eng.device_sync()
            n_par, par_bytes = eng._params_cost()
            prof.record("prefill_chunk", host_s=t_host - t_pf,
                        device_s=self.clock() - t_pf,
                        flops=2.0 * n_par * pf_tokens,
                        hbm_bytes=float(par_bytes) * pf_chunks,
                        count=pf_chunks)
        t_ad = self.clock() if prof_on else 0.0
        self.waiting = []
        n_admitted = 0
        for inf in pending:
            if self._admit(inf):
                n_admitted += 1
            else:
                self.waiting.append(inf)
        if prof_on:
            t_host = self.clock()
            eng.device_sync()
            prof.record("admit", host_s=t_host - t_ad,
                        device_s=self.clock() - t_ad, count=n_admitted)

        for key, pool in self.pools.items():
            if not pool.active:
                continue
            t_decode = self.clock() if tm_on else 0.0
            with eng.parallel():
                toks, pool.logits, pool.caches = MD.decode_many(
                    eng.params, eng.model_cfg, pool.logits, pool.caches,
                    pool.pos, n_steps=self.chunk)
            eng.dispatch_count += 1
            t_disp = self.clock() if prof_on else 0.0
            pool.advance(self.chunk)
            # the tick's only reads of the device: the tokens and the
            # non-finite sentinel, a reduced (capacity,) bool. Fault
            # isolation is slot-granular: a poisoned row retires
            # ``failed`` (its chunk discarded) while sibling rows go on
            # untouched; free rows decode garbage that stays finite
            finite = torch.isfinite(pool.logits).all(dim=-1)
            toks_np = toks.cpu().numpy()
            finite = finite.cpu().numpy()
            now = self.clock()
            if prof_on:
                cost = eng._expressed_decode_cost(pool, self.chunk)
                prof.record("decode", host_s=t_disp - t_decode,
                            device_s=now - t_decode,
                            flops=cost["flops"],
                            hbm_bytes=cost["hbm_bytes"],
                            count=self.chunk * len(pool.active))
                for ph in ("kernel_hit", "kernel_decline"):
                    if cost[ph]["layers"]:
                        prof.record(ph, flops=cost[ph]["flops"],
                                    hbm_bytes=cost[ph]["hbm_bytes"],
                                    count=cost[ph]["layers"])
            if tm_on:
                # residency spans of the slots this chunk decoded
                pi = self._tm_pool_ids.setdefault(key,
                                                  len(self._tm_pool_ids))
                for slot, res in pool.active.items():
                    tid = pi * 1000 + slot
                    eng.tracer.name_thread(TR.PID_SLOTS, tid,
                                           f"g{pi}/slot{slot}",
                                           sort_index=tid)
                    eng.tracer.complete(f"rid{res.req.rid}", TR.PID_SLOTS,
                                        tid, t_decode, now, cat="slot")
                eng.tracer.complete(
                    f"decode g{pi}", TR.PID_SCHEDULER, 1, t_decode, now,
                    args={"batch": len(pool.active), "chunk": self.chunk})
            for slot in sorted(pool.active):
                inf = pool.active[slot]
                if not finite[slot]:
                    self._retire(inf, STATUS_FAILED, now, pool=pool,
                                 slot=slot)
                    continue
                if not inf.generated:
                    inf.metrics.first_token_t = now
                take = min(self.chunk, inf.req.n_steps - len(inf.generated))
                new = _trim_eos(toks_np[slot, :take], inf.req.eos_id).tolist()
                self._note("tokens", inf.req.rid, new)
                inf.generated.extend(new)
                self.tokens_generated += len(new)
                if len(new) < take or len(inf.generated) >= inf.req.n_steps \
                        or (new and new[-1] == inf.req.eos_id):
                    self._retire(inf, STATUS_OK, now, pool=pool, slot=slot)
        if tm_on:
            self._tm_tick(t0=tm_t0, d0=tm_d0, p0=tm_p0, tok0=tm_tok0)
        self._check_decisions(f"tick {self.ticks}")
        done, self._announce = self._announce, []
        return done

    # -- memory ledger ------------------------------------------------------
    def _ledger_entries(self) -> List[TM.PoolLedgerEntry]:
        """One ledger row per slot pool, from byte figures the pool fixed
        at create(): host arithmetic, no device reads. ``queued_match``
        marks pools whose geometry some waiting request already routed to
        (a chunked job past its routing chunk, or a cached monolithic
        key); empty slots of the other pools are fragmentation."""
        queued = set()
        for inf in self.waiting:
            if inf.job is not None and inf.job.caches is not None:
                queued.add(KC.slot_geometry(inf.job.caches))
            elif inf.cached_key is not None:
                queued.add(inf.cached_key)
        entries = []
        for key, pool in self.pools.items():
            pid = self._tm_pool_ids.setdefault(key, len(self._tm_pool_ids))
            entries.append(TM.PoolLedgerEntry(
                pool=f"g{pid}", capacity=pool.capacity,
                occupied=len(pool.active),
                slot_payload_bytes=pool.slot_payload_bytes,
                slot_overhead_bytes=pool.slot_overhead_bytes,
                aux_bytes=pool.aux_bytes,
                queued_match=key in queued))
        return entries

    def ledger_snapshot(self) -> Optional[TM.LedgerSnapshot]:
        """Append the current device-memory picture to the engine's
        ledger and return it (None when the ledger is off)."""
        eng = self.engine
        if eng.ledger is None:
            return None
        store = eng.prefix_store
        return eng.ledger.update(
            t=self.clock(), tick=self.ticks, pools=self._ledger_entries(),
            prefix_device_bytes=(store.device_bytes
                                 if store is not None else 0),
            prefix_host_bytes=(store.host_bytes
                               if store is not None else 0))

    def _tm_tick(self, t0: float, d0: int, p0: int, tok0: int) -> None:
        """End-of-tick telemetry: delta counters, the gauges, the tick
        span and counter samples, and the flight recorder's record, all
        from host state the tick already holds."""
        eng = self.engine
        now = self.clock()
        reg = eng.telemetry
        cap = sum(p.capacity for p in self.pools.values())
        reg.counter("serve_ticks_total").inc()
        reg.counter("serve_tokens_generated_total").inc(
            self.tokens_generated - tok0)
        reg.counter("serve_dispatches_total").inc(eng.dispatch_count - d0)
        reg.counter("flux_sa_transitions_total").inc(
            self.load.transitions - self._tm_transitions)
        self._tm_transitions = self.load.transitions
        if eng.sa_level != self._tm_sa_level:
            self._tm_events.append(
                f"sa_level:{self._tm_sa_level}->{eng.sa_level}")
            self._tm_sa_level = eng.sa_level
        store = eng.prefix_store
        hits = misses = 0
        if store is not None:
            hits = store.hits - self._tm_prefix[0]
            misses = store.misses - self._tm_prefix[1]
            self._tm_prefix = (store.hits, store.misses)
        # the ledger before the gauges, so they describe this tick
        snap = self.ledger_snapshot()
        eng._refresh_gauges()
        tracer = eng.tracer
        tracer.name_thread(TR.PID_SCHEDULER, 0, "ticks", sort_index=0)
        tracer.name_thread(TR.PID_SCHEDULER, 1, "decode", sort_index=1)
        tracer.complete("tick", TR.PID_SCHEDULER, 0, t0, now,
                        args={"tick": self.ticks,
                              "prefill_chunks": self.prefill_chunk_ticks - p0,
                              "dispatches": eng.dispatch_count - d0})
        tracer.counter("queue_depth", now, {"waiting": len(self.waiting)})
        tracer.counter("slots", now,
                       {"active": self.n_active(), "capacity": cap})
        tracer.counter("sparsity", now, {"sa_level": eng.sa_level,
                                         "pressure": self.load.pressure})
        if snap is not None:
            tracer.counter("ledger_bytes", now,
                           {"device": snap.device_bytes,
                            "pool_live": snap.pool_live_bytes,
                            "fragmentation": snap.fragmentation_bytes})
        batch = {
            f"g{self._tm_pool_ids.setdefault(k, len(self._tm_pool_ids))}":
            p.occupancy() for k, p in self.pools.items()}
        eng.flight_recorder.record(TM.TickRecord(
            tick=self.ticks, t=now, queue_depth=len(self.waiting),
            n_active=self.n_active(), capacity=cap,
            batch_by_geometry=batch,
            prefill_chunks=self.prefill_chunk_ticks - p0,
            dispatch_delta=eng.dispatch_count - d0,
            sa_level=eng.sa_level, pressure=self.load.pressure,
            prefix_device_bytes=(store.device_bytes
                                 if store is not None else 0),
            prefix_host_bytes=(store.host_bytes
                               if store is not None else 0),
            prefix_hits=hits, prefix_misses=misses,
            ledger_device_bytes=(snap.device_bytes
                                 if snap is not None else 0),
            ledger_fragmentation_bytes=(snap.fragmentation_bytes
                                        if snap is not None else 0),
            mesh=eng.mesh_shape(),
            events=tuple(self._tm_events)))
        self._tm_events = []

    def drain(self) -> Dict[int, FinishedRequest]:
        """Tick until every submitted request has retired (finished, shed,
        expired, cancelled or quarantined), then close the scheduler: a
        later ``submit`` raises."""
        guard = 0
        while self.waiting or self.n_active():
            before = (self.tokens_generated, self.n_active(),
                      len(self.finished), self.prefill_chunk_ticks)
            self.tick()
            progressed = before != (self.tokens_generated, self.n_active(),
                                    len(self.finished),
                                    self.prefill_chunk_ticks)
            guard = 0 if progressed else guard + 1
            if guard > 10_000:
                raise RuntimeError(
                    "scheduler made no progress (no tokens, admissions or "
                    "completions) for 10k ticks: a request can neither "
                    "finish nor admit (check slots_per_bucket and "
                    "priorities)")
        self.closed = True
        return {f.rid: f for f in self.finished}

    # -- introspection ------------------------------------------------------
    def n_active(self) -> int:
        return sum(len(p.active) for p in self.pools.values())

    def n_geometries(self) -> int:
        return len(self.pools)
