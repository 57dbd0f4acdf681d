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
            resident batch. Requests ``chunked_eligible`` excludes admit
            through the monolithic repack fallback.
  step    — per tick, one ``decode_many`` chunk of ``chunk`` steps for
            every pool with active slots, with one position per slot, on
            the pooled decode kernel.
  retire  — finished slots (EOS / max new tokens) are freed; their rows
            are overwritten by the next admission. A row whose logits are
            not finite retires with status ``failed``.
  preempt — when a pool is full, an arrival with strictly higher
            priority evicts the lowest-priority slot; the victim is
            re-queued and later re-prefilled over its prompt plus the
            tokens generated so far (recompute preemption).

Decoding is greedy, and every operation of the decode step is
row-independent, so a request's tokens equal those of ``generate`` of
that request alone.

Not ported yet (ROADMAP Queue 1 item 10): SLO deadlines, shedding,
aging, preemption budgets, the sparsity dial, ``cancel`` /
``inject_fault``, telemetry, tracing, the profiler, the memory ledger and
fidelity probes. The status vocabulary is the port's own constants.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import model as MD
from repro_torch.serve import kv_cache as KC
from repro_torch.serve.engine import _trim_eos
from repro_torch.serve.slots import SlotPool

STATUS_OK = "ok"          # finished: max new tokens or EOS
STATUS_FAILED = "failed"  # retired by the non-finite sentinel
STATUSES = (STATUS_OK, STATUS_FAILED)


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
        """Time to first token, from arrival; NaN before one exists."""
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
    routing: Optional[Tuple[Any, ...]]   # pattern of the final admission
    metrics: RequestMetrics
    status: str = STATUS_OK              # one of STATUSES


@dataclass
class _InFlight:
    """Host-side record of a submitted request."""
    req: Any                     # serve.engine.Request
    metrics: RequestMetrics
    generated: List[int] = field(default_factory=list)
    pattern: Optional[Tuple[Any, ...]] = None
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
    ``clock``: injectable time source.
    """

    def __init__(self, engine, *, slots_per_bucket: int = 4,
                 chunk: int = 8, prefill_chunks_per_tick: int = 1,
                 clock: Callable[[], float] = time.monotonic):
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
        # the engine's submit / step / drain drive the newest scheduler
        engine._scheduler = self
        self.slots_per_bucket = int(slots_per_bucket)
        self.chunk = int(chunk)
        self.prefill_chunks_per_tick = int(prefill_chunks_per_tick)
        self.clock = clock
        self.waiting: List[_InFlight] = []
        self.pools: Dict[Tuple, SlotPool] = {}
        self.finished: List[FinishedRequest] = []
        self.closed = False           # set by drain(); submit then raises
        self._announce: List[FinishedRequest] = []  # retired since last tick
        self.ticks = 0
        self.tokens_generated = 0
        self.prefill_chunk_ticks = 0  # prefill chunks streamed, lifetime
        # (pattern, prefill length) of every admission, in order: what
        # the prefill kernels ran for, preemption recomputes included
        self.admissions: List[Tuple[Tuple[Any, ...], int]] = []

    # -- submission --------------------------------------------------------
    def submit(self, req) -> int:
        """Queue a request (``serve.engine.Request``); returns its rid."""
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
        self.waiting.append(_InFlight(req=req, metrics=RequestMetrics(
            prompt_len=len(req.tokens), arrival_t=self.clock())))
        return req.rid

    # -- terminal transition -----------------------------------------------
    def _retire(self, inf: _InFlight, status: str, now: float,
                pool: SlotPool, slot: int) -> None:
        """Every request leaves through here exactly once, freeing its
        slot."""
        m = inf.metrics
        m.finish_t = now
        m.n_generated = len(inf.generated)
        pool.active.pop(slot)
        pool.free.append(slot)
        f = FinishedRequest(rid=inf.req.rid,
                            tokens=np.asarray(inf.generated, np.int64),
                            routing=inf.pattern, metrics=m, status=status)
        self.finished.append(f)
        self._announce.append(f)

    # -- admission ---------------------------------------------------------
    def _prefill_tokens(self, inf: _InFlight) -> np.ndarray:
        """Prompt plus tokens generated before a preemption: recompute
        preemption replays the request's own history through prefill."""
        if not inf.generated:
            return np.asarray(inf.req.tokens)
        return np.concatenate([np.asarray(inf.req.tokens),
                               np.asarray(inf.generated, np.int64)])

    def _has_victim(self, pool: SlotPool, priority: int) -> bool:
        return any(v.req.priority < priority for v in pool.active.values())

    def _prefill_work(self, pending: List[_InFlight]) -> None:
        """Stream up to ``prefill_chunks_per_tick`` chunks across the
        waiting requests' admission jobs, in priority-then-arrival
        order."""
        eng = self.engine
        budget = self.prefill_chunks_per_tick
        for inf in pending:
            if budget <= 0:
                break
            if inf.job is None:
                tokens = self._prefill_tokens(inf)
                if not eng.chunked_eligible(len(tokens),
                                            inf.req.routing_override):
                    continue  # the monolithic fallback admits in _admit
                inf.job = eng.start_chunked_prefill(
                    tokens[None], inf.req.routing_override)
                inf.metrics.prefill_start_t = self.clock()
            while budget > 0 and not inf.job.done:
                inf.job.step()
                self.prefill_chunk_ticks += 1
                budget -= 1
            if inf.job.done and inf.metrics.prefill_done_t is None:
                inf.metrics.prefill_done_t = self.clock()

    def _admit(self, inf: _InFlight) -> bool:
        eng = self.engine
        if inf.job is not None:
            # chunked admission: pack only once the stream finished
            if not inf.job.done:
                return False
            pattern, caches = inf.job.pattern, inf.job.caches
            logits, seq_len = inf.job.logits, inf.job.seq_len
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
            logits = pf.logits
        key = KC.slot_geometry(caches)
        pool = self.pools.get(key)
        if pool is None:
            pool = SlotPool.create(eng.cfg, pattern, self.slots_per_bucket,
                                   eng.max_len, logits)
            self.pools[key] = pool
        if pool.free:
            slot = pool.free.pop()
        else:
            slot = self._preempt(pool, inf.req.priority)
            if slot is None:
                inf.cached_key = key
                return False  # pool full of equal or higher priority work
        if inf.metrics.admitted_t is None:
            inf.metrics.admitted_t = self.clock()
        inf.pattern, inf.cached_key = pattern, None
        pool.write(slot, caches, logits, seq_len)
        pool.active[slot] = inf
        self.admissions.append((pattern, seq_len))
        inf.job = None
        return True

    def _preempt(self, pool: SlotPool, priority: int) -> Optional[int]:
        """Evict the lowest-priority active slot (the newest arrival among
        equals) if it is strictly below ``priority``; the victim re-queues
        for a recompute admission."""
        if not pool.active:
            return None
        slot, victim = min(pool.active.items(),
                           key=lambda kv: (kv[1].req.priority,
                                           -kv[1].metrics.arrival_t))
        if victim.req.priority >= priority:
            return None
        pool.active.pop(slot)
        m = victim.metrics
        m.preemptions += 1
        victim.cached_key = None  # its tokens grew; routing may change
        victim.job = None         # recompute prefill over prompt+generated
        m.prefill_start_t = m.prefill_done_t = None
        self.waiting.append(victim)
        return slot

    # -- one scheduling tick -----------------------------------------------
    def tick(self) -> List[FinishedRequest]:
        """Stream prefill chunks, admit finished admissions, decode one
        chunk per pool, retire finished and non-finite slots. Returns the
        requests that retired in this tick."""
        eng = self.engine
        self.ticks += 1
        # admit in priority order, oldest first within a priority;
        # _admit may re-queue preemption victims onto self.waiting, so
        # iterate a snapshot and let victims wait for the next tick
        pending = sorted(self.waiting, key=lambda i: (-i.req.priority,
                                                      i.metrics.arrival_t))
        self._prefill_work(pending)
        self.waiting = []
        for inf in pending:
            if not self._admit(inf):
                self.waiting.append(inf)

        for pool in self.pools.values():
            if not pool.active:
                continue
            toks, pool.logits, pool.caches = MD.decode_many(
                eng.params, eng.cfg, pool.logits, pool.caches, pool.pos,
                n_steps=self.chunk)
            pool.advance(self.chunk)
            # the tick's only reads of the device: the tokens and the
            # non-finite sentinel, a reduced (capacity,) bool; free rows
            # decode garbage that only needs to stay finite
            finite = torch.isfinite(pool.logits).all(dim=-1)
            toks_np = toks.cpu().numpy()
            finite = finite.cpu().numpy()
            now = self.clock()
            for slot in sorted(pool.active):
                inf = pool.active[slot]
                if not finite[slot]:
                    self._retire(inf, STATUS_FAILED, now, pool, slot)
                    continue
                if not inf.generated:
                    inf.metrics.first_token_t = now
                take = min(self.chunk, inf.req.n_steps - len(inf.generated))
                new = _trim_eos(toks_np[slot, :take], inf.req.eos_id).tolist()
                inf.generated.extend(new)
                self.tokens_generated += len(new)
                if len(new) < take or len(inf.generated) >= inf.req.n_steps \
                        or (new and new[-1] == inf.req.eos_id):
                    self._retire(inf, STATUS_OK, now, pool, slot)
        done, self._announce = self._announce, []
        return done

    def drain(self) -> Dict[int, FinishedRequest]:
        """Tick until every submitted request has retired, then close the
        scheduler: a later ``submit`` raises."""
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

    def summary(self, finished: Dict[int, FinishedRequest]
                ) -> Dict[str, Any]:
        """A drain's aggregates: status counts, the TTFT split medians
        (seconds, over the requests that produced a token), prompt tokens
        and the pools' KV payload bytes."""
        ms = [f.metrics for f in finished.values()]
        statuses = [f.status for f in finished.values()]

        def p50(xs: List[float]) -> float:
            xs = [x for x in xs if np.isfinite(x)]
            return float(np.median(xs)) if xs else float("nan")

        return {
            "n_requests": len(ms),
            "status_counts": {s: statuses.count(s) for s in STATUSES},
            "ttft_p50_s": p50([m.ttft for m in ms]),
            "prefill_time_p50_s": p50([m.prefill_time for m in ms]),
            "slot_wait_p50_s": p50([m.slot_wait for m in ms]),
            "prompt_tokens": sum(m.prompt_len for m in ms),
            "kv_payload_bytes": sum(KC.kv_cache_bytes(p.caches)
                                    for p in self.pools.values()),
        }

    # -- introspection ------------------------------------------------------
    def n_active(self) -> int:
        return sum(len(p.active) for p in self.pools.values())

    def n_geometries(self) -> int:
        return len(self.pools)
