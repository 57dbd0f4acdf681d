"""The port's SLO guardrails (``serve/slo.py`` and the scheduler's shed,
deadline, aging, preemption-budget, dial, cancel and fault paths) against
the JAX package's, on the phi3-mini smoke config with the same weights
(``params_from_jax``) and the same tick-advanced virtual clock.

Every scenario runs once through the JAX engine and once through the
port; statuses, routing patterns, greedy tokens, preemption counts and
the sparsity rung after every tick must be identical. Fault quarantine
is also held bitwise against the same drain without the fault, on each
package. One engine per package serves every scenario (a new scheduler
each time), so the JAX side compiles its executables once.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro import serve as JS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_variant as jax_smoke  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro.serve.scheduler import \
    ContinuousScheduler as JaxScheduler  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.serve import slo as TSLO  # noqa: E402
from repro_torch.serve.scheduler import ContinuousScheduler  # noqa: E402

ARCH = "phi3-mini-3.8b"
MAX_LEN, PREFILL_CHUNK = 80, 16


class Clock:
    """Virtual clock, advanced by hand."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke(jax_get_config(ARCH))
    tcfg = smoke_variant(get_config(ARCH))
    jparams = JMD.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              "cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def pkgs(models):
    """(JAX, port): one engine each and the classes a scenario needs."""
    jcfg, tcfg, jparams, tparams = models
    jax_pkg = SimpleNamespace(
        name="jax", Request=JS.Request, SLOConfig=JS.SLOConfig,
        Sched=JaxScheduler, serve_batch_finished=JS.serve_batch_finished,
        eng=JS.ServeEngine(jparams, jcfg, max_len=MAX_LEN,
                           prefill_chunk=PREFILL_CHUNK))
    port_pkg = SimpleNamespace(
        name="port", Request=TE.Request, SLOConfig=TSLO.SLOConfig,
        Sched=ContinuousScheduler,
        serve_batch_finished=TE.serve_batch_finished,
        eng=TE.ServeEngine(tparams, tcfg, max_len=MAX_LEN,
                           prefill_chunk=PREFILL_CHUNK, device="cpu"))
    return jax_pkg, port_pkg


def _prompt(n=20, seed=0):
    return np.random.default_rng(seed).integers(0, 512, n).astype(np.int32)


def _sched(P, clk=None, slo=None, **kw):
    """A fresh scheduler on P's engine, the dial back at rung 0."""
    P.eng.set_sa_level(0)
    kw.setdefault("chunk", 2)
    return P.Sched(P.eng, clock=clk or Clock(),
                   slo=slo if slo is not None else P.SLOConfig(), **kw)


def _record(out, levels=None):
    """What must agree between the packages, per rid."""
    rec = {rid: (f.status, f.routing, f.tokens.tolist(),
                 f.metrics.preemptions, f.metrics.n_generated)
           for rid, f in out.items()}
    return rec if levels is None else (rec, list(levels))


def _both(pkgs, scenario, **kw):
    """Run ``scenario`` on both packages; they must agree. Returns the
    port's result."""
    res = {P.name: scenario(P, **kw) for P in pkgs}
    assert res["port"][0] == res["jax"][0]
    return res["port"]


def _tick_until(sched, cond, limit=50):
    for _ in range(limit):
        if cond():
            return
        sched.tick()
    raise AssertionError("condition never held")


# ---------------------------------------------------------------------------
# Fault quarantine
# ---------------------------------------------------------------------------

def _fault_scenario(P, fault):
    sched = _sched(P, slots_per_bucket=3, prefill_chunks_per_tick=8)
    for rid in range(3):
        sched.submit(P.Request(rid=rid, tokens=_prompt(20), n_steps=8))
    _tick_until(sched, lambda: sched.n_active() == 3)
    if fault:
        P.eng.inject_fault(1)
    out = sched.drain()
    # rid r holds slot r; the pool keeps each row's last logits
    (pool,) = sched.pools.values()
    return _record(out), (out, np.asarray(pool.logits)[[0, 2]])


def test_fault_quarantines_one_slot_siblings_bitwise(pkgs):
    for P in pkgs:
        clean, (_, clean_logits) = _fault_scenario(P, fault=False)
        faulted, (out, logits) = _fault_scenario(P, fault=True)
        assert out[1].status == TSLO.STATUS_FAILED, P.name
        assert 0 < len(out[1].tokens) < 8
        for rid in (0, 2):  # the siblings never saw the fault
            assert faulted[rid] == clean[rid], (P.name, rid)
        # their last logits too, bit for bit
        assert np.array_equal(logits, clean_logits), P.name
    _both(pkgs, _fault_scenario, fault=True)


def _reuse_scenario(P):
    sched = _sched(P, slots_per_bucket=2, prefill_chunks_per_tick=8)
    for rid in range(2):
        sched.submit(P.Request(rid=rid, tokens=_prompt(20), n_steps=8))
    _tick_until(sched, lambda: sched.n_active() == 2)
    P.eng.inject_fault(0)
    sched.tick()  # the sentinel fires: slot freed, rid 0 failed
    sched.submit(P.Request(rid=2, tokens=_prompt(20), n_steps=8))
    out = sched.drain()
    return _record(out), out


def test_quarantined_slot_serves_again(pkgs):
    out = _both(pkgs, _reuse_scenario)[1]
    assert out[0].status == TSLO.STATUS_FAILED
    assert out[1].status == out[2].status == TSLO.STATUS_OK
    # the reused slot decodes cleanly: same prompt, same stream
    assert np.array_equal(out[2].tokens, out[1].tokens)


def test_inject_fault_requires_a_resident_request(pkgs):
    _, port = pkgs
    eng = TE.ServeEngine(port.eng.params, port.eng.cfg, max_len=MAX_LEN,
                         device="cpu")
    with pytest.raises(ValueError, match="no continuous scheduler"):
        eng.inject_fault(0)
    sched = eng.scheduler(slots_per_bucket=2, chunk=2)
    sched.submit(TE.Request(rid=0, tokens=_prompt(), n_steps=4))
    with pytest.raises(ValueError, match="not resident"):
        eng.inject_fault(0)


# ---------------------------------------------------------------------------
# Deadlines
# ---------------------------------------------------------------------------

def _deadline_scenario(P, where):
    clk = Clock()
    if where == "queue":
        sched = _sched(P, clk, slots_per_bucket=2)
        sched.submit(P.Request(rid=0, tokens=_prompt(), n_steps=4,
                               deadline_s=5.0))
        clk.advance(6.0)  # expires before any tick ran
    elif where == "prefill":
        # 48 tokens over chunks of 16: 3 prefill chunks, one a tick
        sched = _sched(P, clk, slots_per_bucket=2,
                       prefill_chunks_per_tick=1)
        sched.submit(P.Request(rid=0, tokens=_prompt(48), n_steps=4,
                               deadline_s=10.0))
        sched.tick()
        assert sched.waiting and sched.waiting[0].job is not None
        clk.advance(11.0)
    else:
        sched = _sched(P, clk, slots_per_bucket=2,
                       prefill_chunks_per_tick=8)
        sched.submit(P.Request(rid=0, tokens=_prompt(), n_steps=16,
                               deadline_s=5.0))
        _tick_until(sched, lambda: sched.n_active() == 1)
        sched.tick()  # at least one decode chunk landed
        clk.advance(6.0)
    out = sched.drain()
    return _record(out), out


@pytest.mark.parametrize("where", ["queue", "prefill", "decode"])
def test_deadline_expiry_matches_jax(pkgs, where):
    out = _both(pkgs, _deadline_scenario, where=where)[1]
    f = out[0]
    assert f.status == TSLO.STATUS_TIMEOUT
    if where == "decode":
        assert 0 < len(f.tokens) < 16  # the partial stream survives
        assert f.metrics.first_token_t is not None
    else:
        assert len(f.tokens) == 0 and np.isnan(f.metrics.ttft)
    if where == "prefill":
        assert f.metrics.prefill_start_t is not None
    if where == "queue":
        assert f.routing is None


def test_default_deadline_and_summary_rates(pkgs):
    _, port = pkgs
    clk = Clock()
    eng = TE.ServeEngine(port.eng.params, port.eng.cfg, max_len=MAX_LEN,
                         device="cpu",
                         slo=TSLO.SLOConfig(default_deadline_s=5.0))
    eng.scheduler(slots_per_bucket=2, chunk=2, clock=clk)
    eng.submit(TE.Request(rid=0, tokens=_prompt(), n_steps=4))
    clk.advance(6.0)
    out = eng.drain()
    assert out[0].status == TSLO.STATUS_TIMEOUT
    assert out.summary["timeout_rate"] == 1.0
    assert out.summary["status_counts"][TSLO.STATUS_TIMEOUT] == 1


# ---------------------------------------------------------------------------
# Bounded queue: both shed policies
# ---------------------------------------------------------------------------

def _shed_scenario(P, policy):
    sched = _sched(P, slots_per_bucket=2, prefill_chunks_per_tick=8,
                   slo=P.SLOConfig(max_queue=2, shed_policy=policy))
    for rid, prio in enumerate([5, 1, 9, 0, 2]):
        sched.submit(P.Request(rid=rid, tokens=_prompt(20, seed=rid),
                               n_steps=4, priority=prio))
    out = sched.drain()
    return _record(out), out


@pytest.mark.parametrize("policy,shed", [
    (TSLO.SHED_REJECT_NEWEST, {2, 3, 4}),
    (TSLO.SHED_DROP_LOWEST, {1, 3, 4})])
def test_bounded_queue_sheds_as_jax(pkgs, policy, shed):
    out = _both(pkgs, _shed_scenario, policy=policy)[1]
    assert {r for r, f in out.items()
            if f.status == TSLO.STATUS_SHED} == shed
    for r in shed:
        assert len(out[r].tokens) == 0 and out[r].routing is None


# ---------------------------------------------------------------------------
# Preemption budget and aging
# ---------------------------------------------------------------------------

def _budget_scenario(P):
    sched = _sched(P, slots_per_bucket=1, prefill_chunks_per_tick=8,
                   slo=P.SLOConfig(preemption_budget=1))
    toks = _prompt()
    sched.submit(P.Request(rid=0, tokens=toks, n_steps=24, priority=0))
    _tick_until(sched, lambda: sched.n_active() == 1)
    # a higher-priority arrival spends rid 0's only preemption
    sched.submit(P.Request(rid=1, tokens=toks, n_steps=4, priority=5))
    _tick_until(sched, lambda: any(f.rid == 1 for f in sched.finished))
    _tick_until(sched, lambda: sched.n_active() == 1)
    # rid 0 is back and no longer evictable: a prio-9 arrival waits
    sched.submit(P.Request(rid=2, tokens=toks, n_steps=4, priority=9))
    sched.tick()
    sched.tick()
    active = [i.req.rid for p in sched.pools.values()
              for i in p.active.values()]
    waiting = [i.req.rid for i in sched.waiting]
    out = sched.drain()
    return _record(out), (active, waiting, out)


def test_preemption_budget_exhaustion_matches_jax(pkgs):
    active, waiting, out = _both(pkgs, _budget_scenario)[1]
    assert active == [0] and waiting == [2]
    assert all(f.status == TSLO.STATUS_OK for f in out.values())
    assert out[0].metrics.preemptions == 1
    assert out[2].metrics.preemptions == 0


def _aging_scenario(P):
    clk = Clock()
    sched = _sched(P, clk, slots_per_bucket=1, prefill_chunks_per_tick=8,
                   slo=P.SLOConfig(aging_s=1.0))
    sched.submit(P.Request(rid=0, tokens=_prompt(), n_steps=4, priority=0))
    clk.advance(10.0)  # the old waiter's admission priority is now 10
    sched.submit(P.Request(rid=1, tokens=_prompt(24, 1), n_steps=4,
                           priority=3))
    infs = {i.req.rid: i for i in sched.waiting}
    eff = (sched._eff_priority(infs[0], clk()),
           sched._eff_priority(infs[1], clk()))
    out = sched.drain()
    return _record(out), (eff, out)


def test_aging_admits_the_starved_waiter_first(pkgs):
    (eff0, eff1), out = _both(pkgs, _aging_scenario)[1]
    assert eff0 > eff1
    assert out[0].metrics.admitted_t <= out[1].metrics.admitted_t


# ---------------------------------------------------------------------------
# The load-adaptive sparsity dial
# ---------------------------------------------------------------------------

def _dial_scenario(P):
    sched = _sched(P, slots_per_bucket=1, prefill_chunks_per_tick=2,
                   slo=P.SLOConfig(adaptive_sparsity=True,
                                   pressure_patience=1))
    for rid in range(6):
        sched.submit(P.Request(rid=rid, tokens=_prompt(20, seed=rid),
                               n_steps=4))
    levels = []
    while sched.waiting or sched.n_active():
        sched.tick()
        levels.append(P.eng.sa_level)
    out = {f.rid: f for f in sched.finished}
    return _record(out, levels), (levels, out, sched.load.transitions)


def test_dial_rises_under_pressure_with_jax_rung_trace(pkgs):
    levels, out, transitions = _both(pkgs, _dial_scenario)[1]
    assert max(levels) >= 1, "queue pressure never engaged the dial"
    assert levels[-1] < max(levels), "the dial never relaxed"
    assert transitions >= 2
    assert all(f.status == TSLO.STATUS_OK for f in out.values())


def test_raising_the_rung_only_moves_layers_to_sa(pkgs):
    _, port = pkgs
    eng = port.eng
    eng.slo = TSLO.SLOConfig()
    out = {}
    for level in (0, eng.slo.sa_level_max):
        eng.set_sa_level(level)
        out[level] = eng.generate(_prompt(24, 2)[None], 4)
    eng.set_sa_level(0)
    sa = {lv: {i for i, p in enumerate(g.routing) if p == "sa"}
          for lv, g in out.items()}
    assert sa[0] < sa[eng.slo.sa_level_max]  # this prompt moves a layer
    eng.set_sa_level(99)
    assert eng.sa_level == eng.slo.sa_level_max
    eng.set_sa_level(-4)
    assert eng.sa_level == 0 and eng.fa_threshold(0) == 0.5


def test_prefix_store_is_scoped_by_rung(models):
    jcfg, tcfg, jparams, tparams = models
    engines = (JS.ServeEngine(jparams, jcfg, max_len=64, prefill_chunk=16,
                              prefix_cache_mb=8.0),
               TE.ServeEngine(tparams, tcfg, max_len=64, prefill_chunk=16,
                              prefix_cache_mb=8.0, device="cpu"))
    toks = _prompt(32)[None]
    hits, tokens = [], []
    for eng in engines:
        h, t = [], []
        for level in (0, 2, 0):  # publish; other rung: miss; back: hit
            eng.set_sa_level(level)
            t.append(np.asarray(eng.generate(toks, 2).tokens).tolist())
            h.append(eng.prefix_store.stats().hits)
        hits.append(h)
        tokens.append(t)
    assert hits[0] == hits[1] == [0, 0, 1]
    assert tokens[0] == tokens[1]


def test_load_tracker_hysteresis_matches_jax():
    seq = [8, 8, 8, 8, 8, 5, 1, 1, 5, 0, 0, 0, 0]
    trackers = [mod.LoadTracker(mod.SLOConfig(
        max_queue=10, adaptive_sparsity=True, sa_level_max=2,
        pressure_patience=2)) for mod in (JS, TSLO)]
    trace = [[lt.observe(q, 0) for q in seq] for lt in trackers]
    assert trace[0] == trace[1] == [0, 1, 1, 2, 2, 2, 2, 1, 1, 1, 0, 0, 0]
    assert trackers[0].transitions == trackers[1].transitions == 4


# ---------------------------------------------------------------------------
# Cancellation
# ---------------------------------------------------------------------------

def _cancel_scenario(P):
    sched = _sched(P, slots_per_bucket=1, prefill_chunks_per_tick=8)
    for rid in range(2):
        sched.submit(P.Request(rid=rid, tokens=_prompt(), n_steps=16))
    _tick_until(sched, lambda: sched.n_active() == 1)
    sched.tick()  # rid 0 decodes a chunk; rid 1 waits on the full pool
    flags = (P.eng.cancel(1), P.eng.cancel(0), P.eng.cancel(0))
    out = sched.drain()
    return _record(out), (flags, out, sched.n_active())


def test_cancel_waiting_and_resident_match_jax(pkgs):
    flags, out, active = _both(pkgs, _cancel_scenario)[1]
    assert flags == (True, True, False)
    assert out[0].status == out[1].status == TSLO.STATUS_CANCELLED
    assert len(out[0].tokens) > 0 and len(out[1].tokens) == 0
    assert active == 0


def test_cancel_without_a_scheduler_is_false(models):
    _, tcfg, _, tparams = models
    eng = TE.ServeEngine(tparams, tcfg, max_len=64, device="cpu")
    assert eng.cancel(0) is False


# ---------------------------------------------------------------------------
# The batch frontend speaks the same vocabulary
# ---------------------------------------------------------------------------

def _batch_scenario(P):
    reqs = [P.Request(rid=i, tokens=_prompt(20 + 4 * i, seed=i), n_steps=4)
            for i in range(3)]
    reqs.append(P.Request(rid=3, tokens=_prompt(20, 7), n_steps=4,
                          deadline_s=0.5))
    clk = Clock()

    def slow_clock():  # every observation is one second after the last
        clk.advance(1.0)
        return clk()

    P.eng.slo = P.SLOConfig()
    P.eng.set_sa_level(0)
    out = P.serve_batch_finished(P.eng, reqs, clock=slow_clock)
    rec = {r: (f.status, np.asarray(f.tokens).tolist(), f.routing,
               f.metrics.n_generated) for r, f in out.items()}
    return rec, out


def test_serve_batch_finished_statuses_match_jax(pkgs):
    out = _both(pkgs, _batch_scenario)[1]
    assert [out[i].status for i in range(3)] == [TSLO.STATUS_OK] * 3
    assert out[3].status == TSLO.STATUS_TIMEOUT
    assert len(out[3].tokens) == 0 and out[3].result is None


# ---------------------------------------------------------------------------
# Validation raises as the JAX package does
# ---------------------------------------------------------------------------

BAD_SLO = [dict(max_queue=0), dict(shed_policy="drop_everything"),
           dict(default_deadline_s=0.0), dict(preemption_budget=-1),
           dict(aging_s=-1.0), dict(sa_level_max=-1),
           dict(sa_threshold_step=0.0),
           dict(pressure_low=0.8, pressure_high=0.2),
           dict(pressure_patience=0)]
BAD_SCHED = [dict(slots_per_bucket=0), dict(chunk=0),
             dict(prefill_chunks_per_tick=0)]


@pytest.mark.parametrize(
    "kind,kw", [("slo", kw) for kw in BAD_SLO]
    + [("scheduler", kw) for kw in BAD_SCHED] + [("deadline", {})],
    ids=lambda v: v if isinstance(v, str) else "-".join(v) or "submit")
def test_validation_raises_as_jax(pkgs, kind, kw):
    errors = []
    for P in pkgs:
        with pytest.raises(ValueError) as e:
            if kind == "slo":
                P.SLOConfig(**kw)
            elif kind == "scheduler":
                P.Sched(P.eng, **kw)
            else:
                _sched(P).submit(P.Request(rid=0, tokens=_prompt(),
                                           n_steps=4, deadline_s=0.0))
        errors.append(str(e.value))
    if kind == "slo":
        assert errors[0] == errors[1]  # the copied config, word for word
    else:
        key = next(iter(kw), "deadline_s")
        assert all(key in m for m in errors), errors


def test_submit_after_drain_raises(pkgs):
    _, port = pkgs
    sched = _sched(port, slots_per_bucket=2)
    sched.submit(TE.Request(rid=0, tokens=_prompt(), n_steps=4))
    sched.drain()
    with pytest.raises(ValueError, match="submit after drain"):
        sched.submit(TE.Request(rid=1, tokens=_prompt(), n_steps=4))
