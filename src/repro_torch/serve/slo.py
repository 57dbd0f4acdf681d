"""SLO guardrails and graceful degradation (port of
``repro/serve/slo.py``, pure host code, names kept).

Production traffic does not degrade politely: queues grow without
bound, a preemption storm can recompute one victim forever, and a
single non-finite logit row turns a pooled decode batch into silent
garbage.  This module gives the serving stack an explicit failure
vocabulary and a *degradation ladder* instead of a cliff:

  shed      — the waiting queue is bounded (``max_queue``); overflow is
              rejected at submission per ``shed_policy`` instead of
              accumulating unserveable work.
  expire    — every request may carry a ``deadline_s``; expired work is
              retired cooperatively (at tick boundaries) with status
              ``timeout`` whether it is queued, mid-prefill, or
              mid-decode.
  preempt   — recompute-preemption is budgeted (``preemption_budget``):
              a victim evicted that many times becomes non-evictable,
              so it ends in admission, never in livelock.  Aging
              (``aging_s``) raises the *admission* priority of old
              waiters so starvation is bounded too.
  sparsify  — under sustained queue pressure the scheduler turns the
              Layer Router's FA-decision threshold toward SA through a
              quantized ladder (``LoadTracker`` → ``engine.sa_level``),
              trading a little quality for admission throughput, and
              relaxes it when the queue drains.  Levels are clamped to
              the ladder, so routing still lands on a finite set of
              cache geometries (one slot pool each).
  quarantine— the scheduler checks decode logits for non-finite rows
              every tick and retires ONLY the poisoned slot (status
              ``failed``); sibling slots are untouched — every decode
              op, the pooled split decode kernel included, is
              row-independent, so their streams stay bitwise identical
              to an unfaulted run (chaos-tested via
              ``engine.inject_fault``).

Every request retires exactly once, as a ``FinishedRequest`` whose
``status`` is one of ``STATUSES`` below; ``ok`` is the only status in
an unstressed system and the only one guaranteed to carry all
``n_steps`` (or EOS-trimmed) tokens.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

# -- request lifecycle statuses ---------------------------------------------
STATUS_OK = "ok"                # finished normally (EOS or n_steps)
STATUS_TIMEOUT = "timeout"      # deadline expired (queued or resident)
STATUS_SHED = "shed"            # rejected by the bounded-queue policy
STATUS_CANCELLED = "cancelled"  # cooperative cancel() by the caller
STATUS_FAILED = "failed"        # quarantined: non-finite decode state

STATUSES = (STATUS_OK, STATUS_TIMEOUT, STATUS_SHED, STATUS_CANCELLED,
            STATUS_FAILED)

# -- shed policies ----------------------------------------------------------
SHED_REJECT_NEWEST = "reject_newest"
SHED_DROP_LOWEST = "drop_lowest_priority"
SHED_POLICIES = (SHED_REJECT_NEWEST, SHED_DROP_LOWEST)


@dataclass(frozen=True)
class SLOConfig:
    """Guardrail knobs for ``ContinuousScheduler`` / ``ServeEngine``.

    Every default is "off": a default-constructed ``SLOConfig`` changes
    no behavior, so the bitwise-parity guarantees of the unguarded
    scheduler are untouched unless a knob is turned.

    ``max_queue``           bound on the waiting queue; ``None`` = unbounded.
    ``shed_policy``         who is rejected when the queue is full:
                            ``reject_newest`` sheds the arrival;
                            ``drop_lowest_priority`` sheds the
                            lowest-priority waiter iff the arrival
                            outranks it (ties shed the arrival).
    ``default_deadline_s``  deadline applied to requests that carry none.
    ``preemption_budget``   max recompute-preemptions per request; once
                            exhausted the request is non-evictable.
    ``aging_s``             waiting seconds per +1 *admission* priority
                            (anti-starvation; raw priorities still
                            govern preemption, so aging cannot start
                            preemption ping-pong).
    ``adaptive_sparsity``   enable the load → SA-bias dial.
    ``sa_level_max``        top rung of the quantized sparsity ladder.
    ``sa_threshold_step``   FA-threshold increment per rung (level L
                            decides FA only when mean p_fa >
                            0.5 + L·step, clamped below 1).
    ``pressure_high/low``   hysteresis band on the queue-pressure signal
                            (waiting / max_queue, or waiting / total
                            slot capacity when unbounded).
    ``pressure_patience``   consecutive ticks outside the band before a
                            rung change — one noisy tick never flips
                            the dial.
    """
    max_queue: Optional[int] = None
    shed_policy: str = SHED_REJECT_NEWEST
    default_deadline_s: Optional[float] = None
    preemption_budget: Optional[int] = None
    aging_s: Optional[float] = None
    adaptive_sparsity: bool = False
    sa_level_max: int = 3
    sa_threshold_step: float = 0.15
    pressure_high: float = 0.75
    pressure_low: float = 0.25
    pressure_patience: int = 2

    def __post_init__(self):
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(
                f"max_queue={self.max_queue} must be >= 1 (or None for "
                f"unbounded): a zero-capacity queue sheds every request "
                f"before anything can admit")
        if self.shed_policy not in SHED_POLICIES:
            raise ValueError(
                f"shed_policy={self.shed_policy!r}: expected one of "
                f"{SHED_POLICIES}")
        if (self.default_deadline_s is not None
                and self.default_deadline_s <= 0):
            raise ValueError(
                f"default_deadline_s={self.default_deadline_s} must be "
                f"positive (or None): a non-positive deadline expires "
                f"every request at submission")
        if (self.preemption_budget is not None
                and self.preemption_budget < 0):
            raise ValueError(
                f"preemption_budget={self.preemption_budget} must be "
                f">= 0 (0 = never evictable) or None (unbudgeted)")
        if self.aging_s is not None and self.aging_s <= 0:
            raise ValueError(
                f"aging_s={self.aging_s} must be positive (or None to "
                f"disable aging): it divides waiting time")
        if self.sa_level_max < 0:
            raise ValueError(
                f"sa_level_max={self.sa_level_max} must be >= 0")
        if self.sa_threshold_step <= 0:
            raise ValueError(
                f"sa_threshold_step={self.sa_threshold_step} must be "
                f"positive: a zero step makes every ladder rung the "
                f"neutral threshold and the dial a no-op")
        if not (0.0 <= self.pressure_low < self.pressure_high <= 1.0):
            raise ValueError(
                f"pressure band must satisfy 0 <= low < high <= 1, got "
                f"low={self.pressure_low} high={self.pressure_high}")
        if self.pressure_patience < 1:
            raise ValueError(
                f"pressure_patience={self.pressure_patience} must be "
                f">= 1 tick")


class LoadTracker:
    """Queue-pressure signal → quantized sparsity level, with hysteresis.

    Pressure is the waiting-queue depth normalized by ``max_queue``
    (when bounded) or by the total resident slot capacity: a backlog the
    pools cannot absorb is the live "we are not keeping up" signal the
    ROADMAP's load-adaptive item calls for.  Slot *occupancy* is
    deliberately not part of the signal — a full pool with an empty
    queue is a healthy steady state, not overload.

    ``observe`` is called once per scheduler tick; the level moves one
    rung at a time, only after ``pressure_patience`` consecutive ticks
    beyond ``pressure_high`` (up) or at/below ``pressure_low`` (down).
    """

    def __init__(self, slo: SLOConfig):
        self.slo = slo
        self.level = 0
        self.pressure = 0.0
        # lifetime rung changes, either direction — a dial that flaps is
        # a tuning smell, and this is the cheapest signal of it (the
        # telemetry registry exposes it as flux_sa_transitions_total)
        self.transitions = 0
        self._hot = 0
        self._cold = 0

    def observe(self, queue_len: int, capacity: int) -> int:
        slo = self.slo
        denom = slo.max_queue if slo.max_queue else max(capacity, 1)
        self.pressure = min(queue_len / max(denom, 1), 1.0)
        if self.pressure >= slo.pressure_high:
            self._hot, self._cold = self._hot + 1, 0
            if (self._hot >= slo.pressure_patience
                    and self.level < slo.sa_level_max):
                self.level += 1
                self.transitions += 1
                self._hot = 0
        elif self.pressure <= slo.pressure_low:
            self._cold, self._hot = self._cold + 1, 0
            if self._cold >= slo.pressure_patience and self.level > 0:
                self.level -= 1
                self.transitions += 1
                self._cold = 0
        else:
            self._hot = self._cold = 0
        return self.level
