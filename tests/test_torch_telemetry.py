"""The port's telemetry (``serve/telemetry.py``, ``serve/tracing.py``, the
analytic half of ``launch/hlo_costs.py``, the router's margin drift)
against the JAX package's.

The host-only modules are copies: on seeded inputs they must give the
JAX modules' answers exactly. Then one guarded drain (bounded queue, the
sparsity dial, a cancel, an injected fault, a preemption; telemetry, the
memory ledger, the profiler every 2 ticks and the fidelity probe every 2
admissions) runs through both engines under the same tick-advanced
virtual clock: statuses and tokens, every counter of ``metrics_text``,
the gauges (to 1e-5), the histograms' counts, the ledger snapshot after
every tick, the flight recorder's records and the profiler's expressed
FLOPs and bytes must agree. Last, the CLI writes both files and the
``python -m`` validators accept them.
"""
import json
import math
import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro import serve as JS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_variant as jax_smoke  # noqa: E402
from repro.core import router as JRT  # noqa: E402
from repro.launch import hlo_costs as JHL  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro.serve import telemetry as JTM  # noqa: E402
from repro.serve import tracing as JTR  # noqa: E402
from repro.serve.scheduler import \
    ContinuousScheduler as JaxScheduler  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.core import router as TRT  # noqa: E402
from repro_torch.launch import hlo_costs as THL  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.serve import slo as TSLO  # noqa: E402
from repro_torch.serve import telemetry as TTM  # noqa: E402
from repro_torch.serve import tracing as TTR  # noqa: E402
from repro_torch.serve.scheduler import ContinuousScheduler  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "phi3-mini-3.8b"


# ---------------------------------------------------------------------------
# The host-only copies give the JAX modules' answers
# ---------------------------------------------------------------------------

def test_quantile_and_summarize_match_jax():
    xs = list(np.random.default_rng(0).normal(size=257)) + [math.nan]
    for q in (0, 1, 37.5, 50, 95, 99, 100):
        assert TTM.quantile(xs, q) == JTM.quantile(xs, q)
    assert TTM.summarize(xs) == JTM.summarize(xs)
    assert math.isnan(TTM.quantile([math.nan], 50))


def test_histogram_reservoir_is_seeded_as_jax():
    vals = np.random.default_rng(1).exponential(size=5000).tolist()
    hs = []
    for mod in (JTM, TTM):
        reg = mod.MetricsRegistry(seed=3)
        h = reg.histogram("lat_seconds", reservoir=64, route="a")
        for v in vals + [math.nan, math.inf]:
            h.observe(v)
        hs.append(h)
    assert hs[0]._res == hs[1]._res and len(hs[1]._res) == 64
    assert hs[0].digest() == hs[1].digest()
    assert (hs[0].count, hs[0].sum) == (hs[1].count, hs[1].sum) == (
        5000, pytest.approx(sum(vals)))


def _registry(mod):
    reg = mod.MetricsRegistry(seed=0)
    reg.counter("req_total", "requests", status='we"ird\\n').inc(3)
    reg.counter("req_total", status="line\nbreak").inc()
    reg.gauge("level", "a gauge").set(math.nan)
    reg.gauge("inf_gauge").set(-math.inf)
    h = reg.histogram("ttft_seconds", "time to first token", layer="0")
    for v in (0.1, 0.5, 2.0):
        h.observe(v)
    return reg


def test_render_and_parse_round_trip_match_jax():
    texts = [_registry(mod).render() for mod in (JTM, TTM)]
    assert texts[0] == texts[1]
    parsed = [mod.parse_prometheus_text(texts[1]) for mod in (JTM, TTM)]
    assert str(parsed[0]) == str(parsed[1])  # NaN != NaN, so as text
    labels = [lb["status"] for lb, _ in parsed[1]["req_total"]]
    assert labels == ['we"ird\\n', "line\nbreak"]
    assert math.isnan(parsed[1]["level"][0][1])
    assert parsed[1]["inf_gauge"][0][1] == -math.inf
    for bad in ("metric{a=b} 1\n", "# BOGUS x\n", "x 1 2 3\n", ""):
        for mod in (JTM, TTM):
            with pytest.raises(ValueError):
                mod.parse_prometheus_text(bad)


def _trace(mod):
    tr = mod.SpanTracer(max_events=40)
    tr.name_thread(mod.PID_REQUESTS, 7, "req7", sort_index=7)
    for i in range(30):
        tr.complete(f"req{i}", mod.PID_REQUESTS, i, i * 0.5, i * 0.5 + 2,
                    args={"status": "ok"})
        tr.instant("submit", mod.PID_REQUESTS, i, i * 0.5)
        tr.counter("queue_depth", i * 0.5, {"waiting": i})
    return tr


def test_span_tracer_and_validator_match_jax():
    trs = [_trace(mod) for mod in (JTR, TTR)]
    objs = [t.to_json() for t in trs]
    assert objs[0] == objs[1] and trs[1].dropped == trs[0].dropped > 0
    assert TTR.validate_trace(objs[1]) == JTR.validate_trace(objs[0])
    assert TTR.request_spans(objs[1]).keys() == \
        JTR.request_spans(objs[0]).keys()
    for bad in ({}, {"traceEvents": [{"ph": "Q"}]},
                {"traceEvents": [{"ph": "X", "pid": 1, "tid": 1,
                                  "name": "a", "ts": 0, "dur": -1}]}):
        for mod in (JTR, TTR):
            with pytest.raises(ValueError):
                mod.validate_trace(bad)


def test_flight_recorder_ledger_and_profiler_copies_match_jax():
    out = []
    for mod in (JTM, TTM):
        fr = mod.FlightRecorder(capacity=3)
        for t in range(5):
            fr.record(mod.TickRecord(
                tick=t, t=t * 0.1, queue_depth=t, n_active=1, capacity=2,
                batch_by_geometry={"g0": 1}, prefill_chunks=t,
                dispatch_delta=2, sa_level=t % 2, pressure=0.5,
                events=(f"shed:{t}",)))
        led = mod.MemoryLedger(params_bytes=1000)
        snaps = [led.update(t=float(i), tick=i, pools=[mod.PoolLedgerEntry(
            pool="g0", capacity=4, occupied=i, slot_payload_bytes=100,
            slot_overhead_bytes=8, aux_bytes=16, queued_match=i == 2)],
            prefix_device_bytes=10 * i).as_dict() for i in range(4)]
        prof = mod.TickProfiler(every=3)
        for tick in range(1, 10):
            if prof.should_sample(tick):
                prof.note_sampled_tick()
                prof.record("decode", host_s=0.5, device_s=0.25,
                            flops=1e9, hbm_bytes=2e9, count=tick)
        out.append((fr.dump(), fr.recorded, snaps, led.high_watermark,
                    prof.report()))
    assert out[0] == out[1]
    assert len(out[1][0]) == 3 and out[1][1] == 5


def test_hlo_costs_analytic_half_matches_jax():
    specs = [(96, 4, 2, 16, 16, 4), (40, 4, 2, 16, 16, 2)]
    lengths = THL.ragged_lengths(5, 90)
    assert lengths == JHL.ragged_lengths(5, 90)
    for hits in (None, [True, False], [True, True]):
        for bk in (16, 64):
            assert THL.pooled_decode_tick_cost(
                lengths, specs, n_steps=3, kernel_hits=hits, block_k=bk
            ) == JHL.pooled_decode_tick_cost(
                lengths, specs, n_steps=3, kernel_hits=hits, block_k=bk)
    assert THL.decode_linear_cost(1234, 5678, batch=3, n_steps=2) == \
        JHL.decode_linear_cost(1234, 5678, batch=3, n_steps=2)
    with pytest.raises(ValueError, match="kernel_hits"):
        THL.pooled_decode_tick_cost(lengths, specs, kernel_hits=[True])


def test_margin_drift_tracker_matches_jax():
    rng = random.Random(5)
    obs = [(rng.randrange(3), rng.randrange(2), rng.uniform(-0.3, 0.3))
           for _ in range(400)]
    reps = []
    for mod in (JRT, TRT):
        md = mod.MarginDriftTracker(window=16)
        for layer, level, p in obs:
            md.observe(layer, level,
                       mod.decision_margin(0.5 + p, level, step=0.1,
                                           max_level=2))
        reps.append((md.report(), md.keys(), md.drift(1, 1)))
    assert reps[0] == reps[1]


# ---------------------------------------------------------------------------
# One guarded drain with every telemetry surface on, through both engines
# ---------------------------------------------------------------------------

class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 512, n).astype(np.int32)


def _guarded_drain(Engine, Request, SLOConfig, Sched, cfg, params, **kw):
    clk = Clock()
    eng = Engine(params, cfg, max_len=80, prefill_chunk=16, telemetry=True,
                 memory_ledger=True, profile_every=2,
                 fidelity_probe_every=2, **kw)
    slo = SLOConfig(max_queue=5, shed_policy="drop_lowest_priority",
                    preemption_budget=1, aging_s=6.0,
                    adaptive_sparsity=True, pressure_patience=1)
    sched = Sched(eng, slots_per_bucket=2, chunk=2,
                  prefill_chunks_per_tick=2, clock=clk, slo=slo)
    for rid, (n, prio) in enumerate([(20, 0), (24, 0), (28, 1), (36, 0),
                                     (20, 0), (24, 0)]):
        sched.submit(Request(rid=rid, tokens=_prompt(n, rid), n_steps=6,
                             priority=prio,
                             deadline_s=2.5 if rid == 4 else None))
    levels, ledger = [], []
    while sched.waiting or sched.n_active():
        resident = sorted(i.req.rid for p in sched.pools.values()
                          for i in p.active.values())
        if sched.ticks == 3:  # the pool is full: this arrival preempts
            sched.submit(Request(rid=6, tokens=_prompt(20, 6), n_steps=6,
                                 priority=5))
        if sched.ticks == 6:
            eng.cancel(resident[0])
        if sched.ticks == 8:
            eng.inject_fault(resident[0])
        sched.tick()
        clk.t += 1.0
        levels.append(eng.sa_level)
        ledger.append(eng.ledger.last().as_dict())
    out = {f.rid: f for f in sched.finished}
    return eng, out, levels, ledger


@pytest.fixture(scope="module")
def drains():
    jcfg = jax_smoke(jax_get_config(ARCH))
    tcfg = smoke_variant(get_config(ARCH))
    jparams = JMD.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              "cpu")
    j = _guarded_drain(JS.ServeEngine, JS.Request, JS.SLOConfig,
                       JaxScheduler, jcfg, jparams)
    t = _guarded_drain(TE.ServeEngine, TE.Request, TSLO.SLOConfig,
                       ContinuousScheduler, tcfg, tparams, device="cpu")
    return j, t


def test_guarded_drain_matches_jax(drains):
    (_, jout, jlev, _), (_, tout, tlev, _) = drains
    assert sorted(tout) == sorted(jout) == list(range(7))
    for rid in jout:
        j, t = jout[rid], tout[rid]
        assert (t.status, t.routing, t.metrics.preemptions) == \
            (j.status, j.routing, j.metrics.preemptions), rid
        assert np.array_equal(t.tokens, j.tokens), rid
    assert tlev == jlev and max(tlev) >= 1
    # every terminal status happens in this drain
    assert {f.status for f in tout.values()} == set(TSLO.STATUSES)


def _samples(text):
    return {(name, tuple(sorted(labels.items()))): v
            for name, rows in TTM.parse_prometheus_text(text).items()
            for labels, v in rows}


def test_metrics_text_matches_jax(drains):
    (jeng, *_), (teng, *_) = drains
    jtext, ttext = jeng.metrics_text(), teng.metrics_text()
    js, ts = _samples(jtext), _samples(ttext)
    kinds = {}
    for line in ttext.splitlines():
        if line.startswith("# TYPE"):
            _, _, name, kind = line.split()
            kinds[name] = kind
    # the JAX engine's decode-kernel adapter counters are not ported
    # (the port has no decline protocol); everything else is shared
    assert {k[0] for k in set(js) - set(ts)} <= {
        "decode_kernel_hit_layers_total",
        "decode_kernel_decline_layers_total"}
    assert set(ts) <= set(js)
    n_counters = 0
    for key, v in ts.items():
        name = key[0]
        base = name[:-len("_count")] if name.endswith("_count") else name
        kind = kinds.get(name, kinds.get(base))
        if kind == "counter":
            n_counters += 1
            assert v == js[key], key
        elif kind == "gauge":
            assert v == pytest.approx(js[key], abs=1e-5), key
        elif name.endswith("_count"):  # histograms: by count only
            assert v == js[key], key
    assert n_counters >= 16
    statuses = {k[1][0][1]: v for k, v in ts.items()
                if k[0] == "serve_requests_finished_total"}
    assert all(statuses[s] >= 1 for s in TSLO.STATUSES)


def test_ledger_reconciles_and_matches_jax_every_tick(drains):
    (jeng, _, _, jled), (teng, tout, _, tled) = drains
    assert tled == jled and len(tled) > 5
    rep = teng.ledger_report()
    recon = rep["reconciliation"]
    assert recon["payload_delta"] == recon["prefix_device_delta"] == 0
    assert recon["overhead_delta"] == rep["aux_bytes"] > 0
    j = jeng.ledger_report()
    assert rep["kv_cache_stats"]["payload_bytes"] == \
        j["kv_cache_stats"]["payload_bytes"]


def test_flight_recorder_matches_jax(drains):
    (jeng, *_), (teng, *_) = drains
    jd, td = jeng.flight_recorder.dump(), teng.flight_recorder.dump()
    assert td == jd
    events = [e for r in td for e in r["events"]]
    for kind in ("shed:", "timeout:", "cancelled:", "failed:", "preempt:",
                 "sa_level:"):
        assert any(e.startswith(kind) for e in events), kind


def test_profiler_expressed_costs_match_jax(drains):
    (jeng, *_), (teng, *_) = drains
    jr, tr = jeng.profiler_report(), teng.profiler_report()
    assert tr["sampled_ticks"] == jr["sampled_ticks"] > 0
    keys = ("phase", "ticks", "count", "expressed_flops",
            "expressed_hbm_bytes")
    assert [{k: p[k] for k in keys} for p in tr["phases"]] == \
        [{k: p[k] for k in keys} for p in jr["phases"]]
    assert any(p["phase"] == "decode" and p["expressed_hbm_bytes"] > 0
               for p in tr["phases"])


def test_trace_covers_every_request(drains, tmp_path):
    (_, jout, *_), (teng, *_) = drains
    path = tmp_path / "t.json"
    teng.export_trace(str(path))
    obj = json.loads(path.read_text())
    census = TTR.validate_trace(obj)
    assert census == JTR.validate_trace(obj)
    spans = TTR.request_spans(obj)
    assert sorted(spans) == sorted(jout)
    assert {s["args"]["status"] for s in spans.values()} == \
        set(TSLO.STATUSES)


def test_disabled_exports_raise(drains):
    (_, tout, *_), (teng, *_) = drains
    eng = TE.ServeEngine(teng.params, teng.cfg, max_len=80, device="cpu")
    for call, match in ((eng.metrics_text, "telemetry is disabled"),
                        (lambda: eng.export_trace("x"),
                         "telemetry is disabled"),
                        (eng.ledger_report, "ledger is disabled"),
                        (eng.profiler_report, "profiler is disabled")):
        with pytest.raises(ValueError, match=match):
            call()
    assert eng.telemetry is eng.tracer is eng.flight_recorder is None


# ---------------------------------------------------------------------------
# The CLI writes what the validators accept
# ---------------------------------------------------------------------------

def test_cli_writes_metrics_and_trace_the_validators_accept(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    m, t, led = (str(tmp_path / n) for n in ("m.prom", "t.json", "l.json"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--continuous", "--requests", "4",
         "--prompt-len", "48", "--gen-len", "4", "--prefill-chunk", "16",
         "--slots", "2", "--chunk", "2", "--mean-gap", "0",
         "--max-queue", "2",
         "--adaptive-sparsity", "--profile-every", "2",
         "--fidelity-probe-every", "1", "--metrics-out", m, "--trace-out",
         t, "--ledger-out", led], env=env, cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    assert '"status": "shed"' in run.stdout
    for mod, path in (("telemetry", m), ("tracing", t)):
        val = subprocess.run(
            [sys.executable, "-m", f"repro_torch.serve.{mod}", path],
            env=env, capture_output=True, text=True, timeout=300)
        assert val.returncode == 0 and val.stdout.startswith("ok:"), \
            val.stdout + val.stderr
    rep = json.loads(Path(led).read_text())
    assert rep["ledger"]["reconciliation"]["payload_delta"] == 0
    bad = tmp_path / "bad.prom"
    bad.write_text("not a metric line {\n")
    val = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve.telemetry", str(bad)],
        env=env, capture_output=True, text=True, timeout=300)
    assert val.returncode == 1
