"""Serving metrics registry + tick flight recorder (port of
``repro/serve/telemetry.py``; standard library only).

Host-side telemetry primitives for the serving stack:

  MetricsRegistry — counters, gauges and histograms (with bounded
      quantile digests) keyed by (name, labels), rendered as Prometheus
      text exposition format (``ServeEngine.metrics_text()``,
      ``launch/serve.py --metrics-out``).  Histograms render as
      Prometheus *summaries*: ``name{quantile="0.5"} …`` plus
      ``name_sum`` / ``name_count``.
  FlightRecorder — a bounded ring of per-tick :class:`TickRecord`
      snapshots (batch size per geometry, prefill chunks, dispatch
      delta, occupancy, queue depth, load pressure, sa_level, prefix
      tier bytes, shed/quarantine events).  After an incident,
      ``engine.flight_recorder.dump()`` returns the last N ticks as
      plain dicts — the serving equivalent of a black box.
  MemoryLedger — unified byte accounting across slot pools, prefix-cache
      tiers and params: per-pool live/stranded/overhead split, a
      fragmentation metric (empty-slot bytes in pools whose geometry
      matches no queued work), and a device-byte high watermark.  The
      scheduler feeds it already-known host integers (static shapes ×
      occupancy); it never reads a device buffer.
  TickProfiler — sampled per-tick latency attribution.  Every Nth tick
      the scheduler brackets each phase (queue / prefill_chunk / admit /
      decode, split kernel-hit vs kernel-decline) with timed
      device-sync boundaries and records host-vs-device seconds plus
      the analytic expressed FLOPs/HBM cost from ``launch/hlo_costs``;
      unsampled ticks never sync.  ``report()`` emits the
      achieved-vs-expressed efficiency table.

Design rules (held by tests/test_torch_telemetry.py):

  * Host-side only.  Nothing in this module touches torch: no tensors,
    no device transfers.  Every recorded quantity is already-materialized
    host state (Python ints/floats the scheduler maintains anyway), so
    telemetry can never add a device sync or a kernel launch to the tick
    loop.
  * Allocation-light.  Histograms keep a bounded reservoir (Algorithm-R
    replacement when full, seeded per instance), the flight recorder is
    a ``deque(maxlen=…)``, and metric objects are created once and
    mutated in place.
  * Deterministic.  Any sampling decision is driven by injectable
    per-instance state (histogram reservoir seeds, profiler/probe
    cadence counters), never module-level randomness — paired runs of
    one workload (telemetry on against off) must not eat sampling
    noise.
  * Off is free.  The scheduler/engine hold ``None`` instead of these
    objects when telemetry is disabled; the instrumented paths reduce
    to a single ``is not None`` test, keeping the telemetry-off run
    bitwise-identical (and launch-count-identical) to the uninstrumented
    scheduler.

``python -m repro_torch.serve.telemetry metrics.prom`` validates a scraped
exposition file (used by the CI telemetry smoke).
"""
from __future__ import annotations

import math
import random
import re
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple
from zlib import crc32 as _crc32

# ---------------------------------------------------------------------------
# Quantile digest helpers
# ---------------------------------------------------------------------------


def quantile(xs: Iterable[float], q: float) -> float:
    """The q-th percentile (0..100) of the finite values in ``xs``;
    NaN when none are finite.  Linear interpolation between order
    statistics — the same estimator ``np.percentile`` defaults to, in
    pure Python so the registry never imports numpy on the hot path."""
    vals = sorted(x for x in xs if math.isfinite(x))
    if not vals:
        return float("nan")
    if len(vals) == 1:
        return float(vals[0])
    pos = (q / 100.0) * (len(vals) - 1)
    lo = max(0, min(int(math.floor(pos)), len(vals) - 1))
    hi = max(0, min(lo + 1, len(vals) - 1))
    frac = pos - lo
    return float(vals[lo] * (1.0 - frac) + vals[hi] * frac)


def summarize(xs: Iterable[float],
              qs: Sequence[float] = (50, 95, 99)) -> Dict[str, float]:
    """{"p50": …, "p95": …, "p99": …} digest of ``xs`` (NaN-filtered).
    The one percentile helper of the port's serving reports."""
    vals = [x for x in xs if math.isfinite(x)]
    return {f"p{q:g}": quantile(vals, q) for q in qs}


# ---------------------------------------------------------------------------
# Metric primitives
# ---------------------------------------------------------------------------


class Counter:
    """Monotonically increasing count."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"Counter.inc({n}): counters only go up — "
                             f"use a Gauge for values that can fall")
        self.value += n


class Gauge:
    """Point-in-time value (set, not accumulated)."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Streaming distribution with a bounded reservoir.

    Keeps exact ``count``/``sum``/``min``/``max`` plus a reservoir of at
    most ``reservoir`` observations for quantiles, maintained with
    Vitter's Algorithm R driven by an *injectable* seeded generator
    (``random.Random(seed)``) — the sample is uniform over the stream,
    allocation-bounded, and **deterministic for a fixed seed and
    observation order**, so two runs of the same workload render the
    same quantile digests (paired instrumented runs must not eat
    sampling noise).  Faithful
    enough for p50/p95/p99 serving digests."""
    __slots__ = ("count", "sum", "min", "max", "_res", "_cap", "_seen",
                 "_rng")

    def __init__(self, reservoir: int = 1024, seed: int = 0):
        if reservoir < 2:
            raise ValueError(f"Histogram: reservoir={reservoir} must be "
                             f">= 2 to hold a distribution")
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._res: List[float] = []
        self._cap = int(reservoir)
        self._seen = 0
        # per-instance generator: module-level randomness would couple
        # histograms to each other (and to anything else using
        # ``random``), destroying replayability
        self._rng = random.Random(seed)

    def observe(self, v: float) -> None:
        v = float(v)
        if not math.isfinite(v):
            return  # NaN TTFTs (never-served requests) are not latencies
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        self._seen += 1
        if len(self._res) < self._cap:
            self._res.append(v)
            return
        # Algorithm R: keep observation i with probability cap/i, into a
        # uniformly chosen slot — every prefix of the stream is equally
        # represented, unlike stride decimation which over-weights
        # whichever phase of the run aligned with the stride
        j = self._rng.randrange(self._seen)
        if j < self._cap:
            self._res[j] = v

    def percentile(self, q: float) -> float:
        return quantile(self._res, q)

    def digest(self, qs: Sequence[float] = (50, 95, 99)) -> Dict[str, float]:
        return {f"p{q:g}": self.percentile(q) for q in qs}


_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _unescape(v: str) -> str:
    """Inverse of :func:`_escape` — a scraped label value must round-trip
    to the string that was observed, or escaped payloads (request ids
    with quotes, multi-line event text) silently corrupt on re-ingest."""
    out: List[str] = []
    i, n = 0, len(v)
    while i < n:
        c = v[i]
        if c == "\\" and i + 1 < n:
            nxt = v[i + 1]
            if nxt == "n":
                out.append("\n")
            elif nxt in ('"', "\\"):
                out.append(nxt)
            else:  # unknown escape: Prometheus keeps it verbatim
                out.append(c)
                out.append(nxt)
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def _fmt(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


class MetricsRegistry:
    """Named metric store with Prometheus text rendering.

    ``counter``/``gauge``/``histogram`` get-or-create the metric for a
    (name, labels) pair, so call sites just
    ``reg.counter("requests_total", status="ok").inc()``; creation cost
    is paid once and steady-state updates are a dict hit plus a float
    add."""

    def __init__(self, seed: int = 0):
        # name -> (kind, help); (name, labels) -> metric object
        self._meta: "OrderedDict[str, Tuple[str, str]]" = OrderedDict()
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                            object] = {}
        # base seed for histogram reservoirs; each histogram derives a
        # distinct stable seed from its (name, labels) key so identical
        # runs render identical digests
        self._seed = int(seed)

    # -- registration --------------------------------------------------------
    def _get(self, kind: str, name: str, help_: str, labels: Dict[str, str],
             factory):
        if name not in self._meta:
            if not _NAME_RE.match(name):
                raise ValueError(
                    f"metric name {name!r} is not a valid Prometheus "
                    f"metric name ([a-zA-Z_:][a-zA-Z0-9_:]*)")
            for k in labels:
                if not _LABEL_RE.match(k):
                    raise ValueError(
                        f"label name {k!r} on metric {name!r} is not a "
                        f"valid Prometheus label name")
            self._meta[name] = (kind, help_)
        elif self._meta[name][0] != kind:
            raise ValueError(
                f"metric {name!r} already registered as "
                f"{self._meta[name][0]}, cannot re-register as {kind}")
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        m = self._metrics.get(key)
        if m is None:
            m = self._metrics[key] = factory()
        return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get("counter", name, help, labels, Counter)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get("gauge", name, help, labels, Gauge)

    def histogram(self, name: str, help: str = "", reservoir: int = 1024,
                  **labels) -> Histogram:
        # hash() is salted per-process for str; zlib.crc32 of the key is
        # stable across runs, which is the whole point of seeding
        key = ",".join([name] + sorted(f"{k}={v}"
                                       for k, v in labels.items()))
        seed = self._seed ^ _crc32(key.encode())
        return self._get("summary", name, help, labels,
                         lambda: Histogram(reservoir, seed=seed))

    # -- rendering -----------------------------------------------------------
    @staticmethod
    def _labels_str(labels: Tuple[Tuple[str, str], ...],
                    extra: Tuple[Tuple[str, str], ...] = ()) -> str:
        items = labels + extra
        if not items:
            return ""
        return ("{" + ",".join(f'{k}="{_escape(v)}"' for k, v in items)
                + "}")

    def render(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        out: List[str] = []
        for name, (kind, help_) in self._meta.items():
            if help_:
                out.append(f"# HELP {name} {help_}")
            out.append(f"# TYPE {name} {kind}")
            for (mname, labels), m in self._metrics.items():
                if mname != name:
                    continue
                if kind in ("counter", "gauge"):
                    out.append(f"{name}{self._labels_str(labels)} "
                               f"{_fmt(m.value)}")
                    continue
                for q in (0.5, 0.95, 0.99):
                    out.append(
                        f"{name}"
                        f"{self._labels_str(labels, (('quantile', f'{q:g}'),))}"
                        f" {_fmt(m.percentile(q * 100))}")
                out.append(f"{name}_sum{self._labels_str(labels)} "
                           f"{_fmt(m.sum)}")
                out.append(f"{name}_count{self._labels_str(labels)} "
                           f"{_fmt(float(m.count))}")
        return "\n".join(out) + "\n"


# -- exposition-format validation (tests + CI smoke) -------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>[+-]?(?:\d+\.?\d*(?:[eE][+-]?\d+)?|Inf|NaN))"
    r"(?:\s+\d+)?$")
_LABEL_PAIR_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus_text(text: str) -> Dict[str, List[Tuple[Dict[str, str],
                                                             float]]]:
    """Parse (and thereby validate) Prometheus text exposition.

    Returns {metric_name: [(labels, value), …]}.  Raises ``ValueError``
    on any malformed line — the CI telemetry smoke and the tests call
    this on ``ServeEngine.metrics_text()`` output so a rendering
    regression fails loudly instead of producing an unscrapeable
    endpoint."""
    samples: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                raise ValueError(
                    f"line {lineno}: malformed comment {line!r} — only "
                    f"'# HELP <name> …' and '# TYPE <name> <kind>' are "
                    f"valid exposition comments")
            if (parts[1] == "TYPE"
                    and parts[3].split()[0] not in (
                        "counter", "gauge", "histogram", "summary",
                        "untyped")):
                raise ValueError(
                    f"line {lineno}: unknown metric type in {line!r}")
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(
                f"line {lineno}: {line!r} is not a valid Prometheus "
                f"sample line")
        labels: Dict[str, str] = {}
        if m.group("labels"):
            body = m.group("labels")
            consumed = 0
            for pm in _LABEL_PAIR_RE.finditer(body):
                labels[pm.group(1)] = _unescape(pm.group(2))
                consumed = pm.end()
            rest = body[consumed:].strip().strip(",")
            if rest:
                raise ValueError(
                    f"line {lineno}: malformed label body {body!r}")
        v = m.group("value")
        val = float("nan") if v == "NaN" else float(v.replace("Inf", "inf"))
        samples.setdefault(m.group("name"), []).append((labels, val))
    if not samples:
        raise ValueError("no metric samples found in exposition text")
    return samples


# ---------------------------------------------------------------------------
# Tick flight recorder
# ---------------------------------------------------------------------------


@dataclass
class TickRecord:
    """One scheduler tick, as the flight recorder remembers it.  Every
    field is host state the scheduler already maintains — recording one
    is a dataclass allocation plus dict copies, never a device read."""
    tick: int                       # scheduler tick counter
    t: float                        # tick timestamp (scheduler clock)
    queue_depth: int                # waiting requests after admission
    n_active: int                   # resident decode slots, all pools
    capacity: int                   # total decode slots, all pools
    batch_by_geometry: Dict[str, int]  # active slots per geometry bucket
    prefill_chunks: int             # prefill chunks streamed this tick
    dispatch_delta: int             # engine calls issued this tick
    sa_level: int                   # sparsity rung after this tick
    pressure: float                 # LoadTracker queue-pressure signal
    prefix_device_bytes: int = 0    # prefix store occupancy, device tier
    prefix_host_bytes: int = 0      # prefix store occupancy, host tier
    prefix_hits: int = 0            # prefix-cache hits this tick
    prefix_misses: int = 0          # prefix-cache misses this tick
    ledger_device_bytes: int = 0    # MemoryLedger total (0 = ledger off)
    ledger_fragmentation_bytes: int = 0  # stranded empty-slot bytes
    mesh: Optional[Tuple[int, ...]] = None  # device-mesh shape, None =
                                    # single-device serving
    events: Tuple[str, ...] = ()    # non-ok retirements "status:rid",
                                    # sa_level moves "sa_level:old->new"

    def as_dict(self) -> Dict[str, object]:
        d = self.__dict__.copy()
        d["batch_by_geometry"] = dict(self.batch_by_geometry)
        d["mesh"] = list(self.mesh) if self.mesh is not None else None
        d["events"] = list(self.events)
        return d


class FlightRecorder:
    """Bounded ring of :class:`TickRecord` — the last ``capacity``
    scheduler ticks, oldest evicted first."""

    def __init__(self, capacity: int = 512):
        if capacity < 1:
            raise ValueError(
                f"FlightRecorder: capacity={capacity} must be >= 1 tick")
        self.capacity = int(capacity)
        self._ring: "deque[TickRecord]" = deque(maxlen=self.capacity)
        self.recorded = 0  # lifetime ticks seen (>= len(ring))

    def record(self, rec: TickRecord) -> None:
        self._ring.append(rec)
        self.recorded += 1

    def __len__(self) -> int:
        return len(self._ring)

    def dump(self) -> List[Dict[str, object]]:
        """The retained ticks, oldest first, as plain dicts (JSON-ready
        incident payload)."""
        return [r.as_dict() for r in self._ring]

    def last(self) -> Optional[TickRecord]:
        return self._ring[-1] if self._ring else None

    def clear(self) -> None:
        self._ring.clear()


# ---------------------------------------------------------------------------
# Memory ledger
# ---------------------------------------------------------------------------


@dataclass
class PoolLedgerEntry:
    """One slot pool's byte accounting, from static shapes × occupancy.

    ``slot_payload_bytes``/``slot_overhead_bytes`` are computed once at
    pool creation (cache shapes never change over a pool's lifetime);
    the per-tick update only multiplies them by host-side occupancy
    counts, so the ledger adds no device reads to the tick loop."""
    pool: str                   # geometry bucket id ("g0", "g1", …)
    capacity: int               # total slots
    occupied: int               # slots holding a resident request
    slot_payload_bytes: int     # KV/state payload bytes per slot
    slot_overhead_bytes: int    # positions/length metadata per slot
    aux_bytes: int              # pool-level logits/pos buffers
    queued_match: bool          # any queued request routes here?

    @property
    def live_bytes(self) -> int:
        return self.occupied * self.slot_payload_bytes

    @property
    def stranded_bytes(self) -> int:
        """Payload bytes held by empty slots — capacity paid for but
        not serving anyone right now."""
        return (self.capacity - self.occupied) * self.slot_payload_bytes

    @property
    def overhead_bytes(self) -> int:
        return self.capacity * self.slot_overhead_bytes + self.aux_bytes

    @property
    def total_bytes(self) -> int:
        return self.capacity * (self.slot_payload_bytes
                                + self.slot_overhead_bytes) + self.aux_bytes

    @property
    def fragmentation_bytes(self) -> int:
        """Stranded bytes that cannot help the queue: empty-slot payload
        in a pool whose geometry matches no queued request.  This is the
        signal the ROADMAP's pool-rebalancing tentpole needs — bytes a
        defragmenting allocator could reclaim right now."""
        return 0 if self.queued_match else self.stranded_bytes

    def as_dict(self) -> Dict[str, object]:
        return {
            "pool": self.pool,
            "capacity": self.capacity,
            "occupied": self.occupied,
            "live_bytes": self.live_bytes,
            "stranded_bytes": self.stranded_bytes,
            "overhead_bytes": self.overhead_bytes,
            "total_bytes": self.total_bytes,
            "fragmentation_bytes": self.fragmentation_bytes,
            "queued_match": self.queued_match,
        }


@dataclass
class LedgerSnapshot:
    """Point-in-time unified byte accounting across every HBM consumer
    the serving stack knows about."""
    t: float
    tick: int
    pools: Tuple[PoolLedgerEntry, ...]
    prefix_device_bytes: int
    prefix_host_bytes: int
    params_bytes: int
    device_high_watermark_bytes: int

    @property
    def pool_live_bytes(self) -> int:
        return sum(p.live_bytes for p in self.pools)

    @property
    def pool_stranded_bytes(self) -> int:
        return sum(p.stranded_bytes for p in self.pools)

    @property
    def pool_overhead_bytes(self) -> int:
        return sum(p.overhead_bytes for p in self.pools)

    @property
    def pool_payload_bytes(self) -> int:
        # live + stranded == capacity × per-slot payload, the quantity
        # kv_cache_stats reports as payload_bytes for the pool caches
        return self.pool_live_bytes + self.pool_stranded_bytes

    @property
    def fragmentation_bytes(self) -> int:
        return sum(p.fragmentation_bytes for p in self.pools)

    @property
    def device_bytes(self) -> int:
        """Everything resident in device memory that the ledger tracks
        (host prefix tier excluded by definition)."""
        return (self.pool_payload_bytes + self.pool_overhead_bytes
                + self.prefix_device_bytes + self.params_bytes)

    def reconcile(self, payload_bytes: int, overhead_bytes: int,
                  prefix_device_bytes: int,
                  prefix_host_bytes: int) -> Dict[str, int]:
        """Deltas vs an independent ``kv_cache_stats`` walk of the same
        pools+prefix store.  Payload and prefix tiers must agree exactly
        (both sides are shape arithmetic over the same arrays); overhead
        may differ by the pool-level aux buffers (logits/pos) that
        kv_cache_stats does not see — callers assert accordingly."""
        return {
            "payload_delta": self.pool_payload_bytes - int(payload_bytes),
            "overhead_delta": self.pool_overhead_bytes - int(overhead_bytes),
            "prefix_device_delta":
                self.prefix_device_bytes - int(prefix_device_bytes),
            "prefix_host_delta":
                self.prefix_host_bytes - int(prefix_host_bytes),
        }

    def as_dict(self) -> Dict[str, object]:
        return {
            "t": self.t,
            "tick": self.tick,
            "pools": [p.as_dict() for p in self.pools],
            "pool_live_bytes": self.pool_live_bytes,
            "pool_stranded_bytes": self.pool_stranded_bytes,
            "pool_overhead_bytes": self.pool_overhead_bytes,
            "fragmentation_bytes": self.fragmentation_bytes,
            "prefix_device_bytes": self.prefix_device_bytes,
            "prefix_host_bytes": self.prefix_host_bytes,
            "params_bytes": self.params_bytes,
            "device_bytes": self.device_bytes,
            "device_high_watermark_bytes": self.device_high_watermark_bytes,
        }


class MemoryLedger:
    """Unified byte-accounting registry.  The scheduler calls
    :meth:`update` each tick with per-pool occupancy; everything else
    (params bytes, per-slot byte constants) was measured once at
    engine/pool construction.  Tracks the device-byte high watermark
    across updates."""

    def __init__(self, params_bytes: int = 0):
        self.params_bytes = int(params_bytes)
        self.high_watermark = 0
        self.updates = 0
        self._last: Optional[LedgerSnapshot] = None

    def update(self, *, t: float, tick: int,
               pools: Sequence[PoolLedgerEntry],
               prefix_device_bytes: int = 0,
               prefix_host_bytes: int = 0) -> LedgerSnapshot:
        snap = LedgerSnapshot(
            t=float(t), tick=int(tick), pools=tuple(pools),
            prefix_device_bytes=int(prefix_device_bytes),
            prefix_host_bytes=int(prefix_host_bytes),
            params_bytes=self.params_bytes,
            device_high_watermark_bytes=self.high_watermark)
        if snap.device_bytes > self.high_watermark:
            self.high_watermark = snap.device_bytes
            snap.device_high_watermark_bytes = self.high_watermark
        self.updates += 1
        self._last = snap
        return snap

    def last(self) -> Optional[LedgerSnapshot]:
        return self._last


# ---------------------------------------------------------------------------
# Per-tick cost attribution profiler
# ---------------------------------------------------------------------------


@dataclass
class PhaseStat:
    """Accumulated attribution for one tick phase across all sampled
    ticks.  ``device_s`` is wall time between timed sync boundaries
    (host dispatch + device compute for that phase's work); ``host_s``
    is the phase's pure-host bookkeeping time.  ``flops``/``hbm_bytes``
    are the analytic *expressed* cost from ``launch/hlo_costs`` for the
    work the phase dispatched."""
    phase: str
    ticks: int = 0
    host_s: float = 0.0
    device_s: float = 0.0
    flops: float = 0.0
    hbm_bytes: float = 0.0
    count: int = 0  # phase-specific unit (chunks, decode steps, layers)

    def as_dict(self) -> Dict[str, object]:
        d = {
            "phase": self.phase, "ticks": self.ticks, "count": self.count,
            "host_s": self.host_s, "device_s": self.device_s,
            "expressed_flops": self.flops,
            "expressed_hbm_bytes": self.hbm_bytes,
        }
        wall = self.host_s + self.device_s
        d["host_frac"] = self.host_s / wall if wall > 0 else 0.0
        # achieved-vs-expressed: what rate did the device sustain against
        # the analytic cost the phase expressed?
        d["achieved_gflops_per_s"] = (
            self.flops / self.device_s / 1e9 if self.device_s > 0 else 0.0)
        d["achieved_gbytes_per_s"] = (
            self.hbm_bytes / self.device_s / 1e9
            if self.device_s > 0 else 0.0)
        return d


class TickProfiler:
    """Sampled per-tick latency/cost attribution.

    ``should_sample(tick)`` is a modulus test on the host tick counter —
    deterministic, so paired runs profile the same ticks.  On a
    sampled tick the *scheduler* brackets each phase with its clock and
    a device sync (the profiler itself never imports torch) and calls
    :meth:`record`; unsampled ticks skip both the syncs and the calls
    entirely, keeping the steady-state path dispatch-identical."""

    def __init__(self, every: int = 32):
        if every < 1:
            raise ValueError(
                f"TickProfiler: every={every} must be >= 1 "
                f"(1 = profile every tick)")
        self.every = int(every)
        self.sampled_ticks = 0
        self._phases: "OrderedDict[str, PhaseStat]" = OrderedDict()

    def should_sample(self, tick: int) -> bool:
        return tick % self.every == 0

    def note_sampled_tick(self) -> None:
        self.sampled_ticks += 1

    def record(self, phase: str, *, host_s: float = 0.0,
               device_s: float = 0.0, flops: float = 0.0,
               hbm_bytes: float = 0.0, count: int = 1) -> None:
        st = self._phases.get(phase)
        if st is None:
            st = self._phases[phase] = PhaseStat(phase=phase)
        st.ticks += 1
        st.host_s += float(host_s)
        st.device_s += float(device_s)
        st.flops += float(flops)
        st.hbm_bytes += float(hbm_bytes)
        st.count += int(count)

    def report(self) -> Dict[str, object]:
        """Per-phase achieved-vs-expressed efficiency table, JSON-ready."""
        phases = [st.as_dict() for st in self._phases.values()]
        total_host = sum(p["host_s"] for p in phases)
        total_dev = sum(p["device_s"] for p in phases)
        return {
            "every": self.every,
            "sampled_ticks": self.sampled_ticks,
            "total_host_s": total_host,
            "total_device_s": total_dev,
            "phases": phases,
        }


def main(argv: Optional[List[str]] = None) -> int:
    """CLI validator: ``python -m repro_torch.serve.telemetry metrics.prom``
    parses an exposition file and reports the metric census (exit 1 on
    malformed input) — the CI smoke's 'does the endpoint scrape' gate."""
    import sys
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print("usage: python -m repro_torch.serve.telemetry <metrics.prom>",
              file=sys.stderr)
        return 2
    with open(args[0]) as f:
        text = f.read()
    try:
        samples = parse_prometheus_text(text)
    except ValueError as e:
        print(f"INVALID prometheus text: {e}", file=sys.stderr)
        return 1
    n = sum(len(v) for v in samples.values())
    print(f"ok: {len(samples)} metrics, {n} samples")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
