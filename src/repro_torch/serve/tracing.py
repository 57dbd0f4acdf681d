"""Request-span tracing with Chrome-trace / Perfetto JSON export (port of
``repro/serve/tracing.py``).

The scheduler records each request's lifecycle as host-side span
events in the **scheduler's clock domain** (the injectable ``clock``
callable — ``time.monotonic`` in production, a virtual clock in
tests):

  submit → queue → admit → per-prefill-chunk → per-decode-tick slot
  residency → retire (ok / timeout / shed / cancelled / failed)

``ServeEngine.export_trace(path)`` serializes the run as Chrome Trace
Event Format JSON (the ``traceEvents`` array form), which
chrome://tracing and https://ui.perfetto.dev open directly.  Track
layout:

  pid 1 "requests"  — one thread per request (tid = rid): the request's
      lifetime span (named ``req<rid>``, args carry status/metrics),
      queue/prefill/decode phase sub-spans, per-chunk prefill spans,
      and instants for submit / preempt / retire.
  pid 2 "slots"     — one thread per (geometry bucket, slot): a span
      per decode tick labeled with the resident rid, so a drain
      renders as the slots × ticks occupancy grid.
  pid 3 "scheduler" — per-tick spans and counter tracks (queue depth,
      active slots, sa_level, load pressure).

Everything here is host-side bookkeeping: emitting an event is a dict
append, timestamps come from the scheduler clock, and nothing imports
torch — tracing can never add a device sync or a kernel launch.
The event buffer is bounded (``max_events``; overflow counts into
``dropped`` instead of growing without bound).

``python -m repro_torch.serve.tracing trace.json`` validates an exported
trace against the schema check used by the tests and the CI smoke.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

# fixed process ids of the three tracks (stable across exports so
# Perfetto queries / saved UI states keep working)
PID_REQUESTS = 1
PID_SLOTS = 2
PID_SCHEDULER = 3

_PROCESS_NAMES = {PID_REQUESTS: "requests", PID_SLOTS: "slots",
                  PID_SCHEDULER: "scheduler"}

# event phases this tracer emits (and the validator accepts)
_PHASES = ("X", "i", "I", "C", "M", "B", "E")


class SpanTracer:
    """Bounded host-side trace event buffer.

    Timestamps are seconds in the caller's clock domain; the tracer
    converts to the microseconds Chrome Trace Format expects at emit
    time.  ``complete``/``instant``/``counter`` are the only emitters
    the serving stack uses — complete ("X") events carry their duration
    inline, so no begin/end pairing state survives a crash-truncated
    export."""

    def __init__(self, max_events: int = 200_000):
        if max_events < 1:
            raise ValueError(
                f"SpanTracer: max_events={max_events} must be >= 1")
        self.max_events = int(max_events)
        self.events: List[Dict] = []
        self.dropped = 0
        self._named_threads: set = set()
        for pid, name in _PROCESS_NAMES.items():
            self._meta("process_name", pid, 0, {"name": name})
            self._meta("process_sort_index", pid, 0, {"sort_index": pid})

    # -- low-level emit ------------------------------------------------------
    def _emit(self, ev: Dict) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    def _meta(self, name: str, pid: int, tid: int, args: Dict) -> None:
        # metadata events bypass the budget: they are O(#tracks), and a
        # truncated trace with unnamed tracks is much harder to read
        self.events.append({"name": name, "ph": "M", "pid": pid,
                            "tid": tid, "args": args})

    def name_thread(self, pid: int, tid: int, name: str,
                    sort_index: Optional[int] = None) -> None:
        """Label a track once (idempotent per (pid, tid))."""
        key = (pid, tid)
        if key in self._named_threads:
            return
        self._named_threads.add(key)
        self._meta("thread_name", pid, tid, {"name": name})
        if sort_index is not None:
            self._meta("thread_sort_index", pid, tid,
                       {"sort_index": sort_index})

    # -- emitters ------------------------------------------------------------
    def complete(self, name: str, pid: int, tid: int, t0: float, t1: float,
                 cat: str = "serve", args: Optional[Dict] = None) -> None:
        """A span [t0, t1] (seconds, clock domain) as one "X" event."""
        ev = {"name": name, "cat": cat, "ph": "X", "pid": pid, "tid": tid,
              "ts": t0 * 1e6, "dur": max(t1 - t0, 0.0) * 1e6}
        if args:
            ev["args"] = args
        self._emit(ev)

    def instant(self, name: str, pid: int, tid: int, t: float,
                cat: str = "serve", args: Optional[Dict] = None) -> None:
        ev = {"name": name, "cat": cat, "ph": "i", "pid": pid, "tid": tid,
              "ts": t * 1e6, "s": "t"}
        if args:
            ev["args"] = args
        self._emit(ev)

    def counter(self, name: str, t: float, values: Dict[str, float],
                pid: int = PID_SCHEDULER) -> None:
        """A counter sample — Perfetto renders these as step plots."""
        self._emit({"name": name, "cat": "serve", "ph": "C", "pid": pid,
                    "tid": 0, "ts": t * 1e6,
                    "args": {k: float(v) for k, v in values.items()}})

    # -- export --------------------------------------------------------------
    def to_json(self) -> Dict:
        return {
            "traceEvents": list(self.events),
            "displayTimeUnit": "ms",
            "otherData": {
                "clock_domain": "scheduler clock (seconds → µs)",
                "dropped_events": self.dropped,
            },
        }

    def export(self, path: str) -> None:
        """Write the trace as Perfetto-loadable JSON."""
        with open(path, "w") as f:
            json.dump(self.to_json(), f)


# ---------------------------------------------------------------------------
# Schema validation (tests + CI smoke)
# ---------------------------------------------------------------------------


def validate_trace(obj) -> Dict[str, int]:
    """Check ``obj`` (a parsed trace JSON) against the Chrome Trace
    Event Format subset this tracer emits.  Raises ``ValueError`` on
    the first violation; returns a {phase: count} census on success —
    the tests assert on it, and the CI smoke prints it."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError(
            "trace must be a JSON object with a 'traceEvents' array "
            "(the Chrome Trace Event Format object form)")
    events = obj["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    census: Dict[str, int] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        ph = ev.get("ph")
        if ph not in _PHASES:
            raise ValueError(
                f"traceEvents[{i}]: unknown or missing phase {ph!r} "
                f"(expected one of {_PHASES})")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                raise ValueError(
                    f"traceEvents[{i}] ({ph}): {key!r} must be an int, "
                    f"got {ev.get(key)!r}")
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            raise ValueError(
                f"traceEvents[{i}] ({ph}): missing event name")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)):
                raise ValueError(
                    f"traceEvents[{i}] ({ph} {ev['name']!r}): 'ts' must "
                    f"be a number (µs), got {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(
                    f"traceEvents[{i}] (X {ev['name']!r}): 'dur' must be "
                    f"a non-negative number (µs), got {dur!r}")
        if ph == "C" and not isinstance(ev.get("args"), dict):
            raise ValueError(
                f"traceEvents[{i}] (C {ev['name']!r}): counter events "
                f"need an 'args' value mapping")
        census[ph] = census.get(ph, 0) + 1
    return census


def request_spans(obj) -> Dict[int, Dict]:
    """{rid: lifetime-span event} for every request track in a trace —
    the coverage check behind 'every request in DrainResult has a
    submit→retire span'."""
    out: Dict[int, Dict] = {}
    for ev in obj.get("traceEvents", ()):
        if (ev.get("ph") == "X" and ev.get("pid") == PID_REQUESTS
                and str(ev.get("name", "")).startswith("req")):
            out[int(ev["tid"])] = ev
    return out


def main(argv: Optional[List[str]] = None) -> int:
    """CLI validator: ``python -m repro_torch.serve.tracing trace.json``."""
    import sys
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print("usage: python -m repro_torch.serve.tracing <trace.json>",
              file=sys.stderr)
        return 2
    with open(args[0]) as f:
        obj = json.load(f)
    try:
        census = validate_trace(obj)
    except ValueError as e:
        print(f"INVALID trace: {e}", file=sys.stderr)
        return 1
    spans = request_spans(obj)
    probed = sum(1 for ev in spans.values()
                 if "fidelity" in ev.get("args", {}))
    print(f"ok: {sum(census.values())} events {census}; "
          f"{len(spans)} request lifetime spans ({probed} with fidelity)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
