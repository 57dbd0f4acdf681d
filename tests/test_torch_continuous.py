"""The port's continuous-batching frontend (``ServeEngine.submit`` /
``step`` / ``drain`` over the slot pool) against the JAX engine's, on the
phi3-mini smoke config with the same weights (``params_from_jax``).

Routing, greedy tokens and the number of geometry pools must be
identical: every decode operation is row-independent, so pooling changes
which requests share a batch, never a request's tokens. Preemption, EOS,
the monolithic fallback and a last decode chunk that runs past the cache
capacity are driven on purpose.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread: as fast at these small shapes, and it leaves the other
# cores to the test processes running beside this one
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_variant as jax_smoke  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.scheduler import (STATUS_OK,  # noqa: E402
                                         ContinuousScheduler)

ARCH = "phi3-mini-3.8b"
MAX_LEN = 64
LENS = (20, 28, 36)
PATTERNS = (None, ("fa", "fa"), ("sa", "sa"), ("fa", "sa"))


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke(jax_get_config(ARCH))
    tcfg = smoke_variant(get_config(ARCH))
    jparams = JMD.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              "cpu")
    return jcfg, tcfg, jparams, tparams


def _specs(n, seed=0, n_steps=7, lens=LENS):
    """(rid, tokens, n_steps, routing override): router-driven and three
    override geometries in turn."""
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 512, size=lens[i % len(lens)]), n_steps,
             PATTERNS[i % len(PATTERNS)]) for i in range(n)]


def _drain(engine, specs, req_cls, **sched_kw):
    engine.scheduler(**sched_kw)
    for rid, toks, n, ov in specs:
        engine.submit(req_cls(rid=rid, tokens=toks, n_steps=n,
                              routing_override=ov))
    return engine.drain(), engine.scheduler().n_geometries()


@pytest.fixture(scope="module")
def drains(models):
    """The same six requests drained by both engines."""
    jcfg, tcfg, jparams, tparams = models
    specs = _specs(6)
    kw = dict(slots_per_bucket=3, chunk=4)
    jout = _drain(JaxEngine(jparams, jcfg, max_len=MAX_LEN), specs,
                  JaxRequest, **kw)
    tout = _drain(ServeEngine(tparams, tcfg, max_len=MAX_LEN, device="cpu"),
                  specs, Request, **kw)
    return specs, jout, tout


@pytest.mark.parametrize("rid", range(6))
def test_drain_matches_jax(drains, rid):
    _, (jout, _), (tout, _) = drains
    assert tout[rid].routing == jout[rid].routing
    assert np.array_equal(tout[rid].tokens, jout[rid].tokens)
    assert tout[rid].status == jout[rid].status == STATUS_OK
    assert tout[rid].metrics.n_generated == jout[rid].metrics.n_generated


def test_drain_geometries_and_summary_match_jax(drains):
    specs, (jout, jgeo), (tout, tgeo) = drains
    assert tgeo == jgeo >= 3
    js, ts = jout.summary, tout.summary
    for key in ("n_requests", "prompt_tokens", "kv_payload_bytes"):
        assert ts[key] == js[key], key
    assert ts["status_counts"][STATUS_OK] == js["status_counts"]["ok"] == 6
    assert ts["ttft_p50_s"] > 0


def test_pooled_drain_equals_sequential_generate(models, drains):
    _, tcfg, _, tparams = models
    specs, _, (tout, _) = drains
    ref = ServeEngine(tparams, tcfg, max_len=MAX_LEN, device="cpu")
    for rid, toks, n, ov in specs:
        gen = ref.generate(toks[None], n, routing_override=ov)
        assert np.array_equal(tout[rid].tokens, gen.tokens[0]), rid
        assert tout[rid].routing == gen.routing


def test_last_chunk_past_capacity_matches_jax(models):
    """max_len = prompt + n_steps with n_steps = 6, not a multiple of
    chunk = 4: the FullKV rows' second chunk writes two positions past
    the capacity. JAX drops those writes; the port must drop them too,
    raise nothing, and give JAX's tokens."""
    jcfg, tcfg, jparams, tparams = models
    n = 6
    specs = [(i, np.random.default_rng(7 + i).integers(0, 512, 20), n, ov)
             for i, ov in enumerate((("fa", "fa"), ("fa", "sa"), None))]
    max_len = 20 + n
    kw = dict(slots_per_bucket=2, chunk=4)
    jout, _ = _drain(JaxEngine(jparams, jcfg, max_len=max_len), specs,
                     JaxRequest, **kw)
    tout, _ = _drain(ServeEngine(tparams, tcfg, max_len=max_len,
                                 device="cpu"), specs, Request, **kw)
    for rid, *_ in specs:
        assert len(tout[rid].tokens) == n
        assert tout[rid].routing == jout[rid].routing
        assert np.array_equal(tout[rid].tokens, jout[rid].tokens), rid


def test_preempted_request_output_is_unchanged(models):
    """Recompute preemption replays prompt + generated through prefill:
    the victim's final stream equals an uninterrupted generate."""
    _, tcfg, _, tparams = models
    sa = ("sa", "sa")
    rng = np.random.default_rng(5)
    t_low = rng.integers(0, 512, size=24)
    t_high = rng.integers(0, 512, size=28)
    eng = ServeEngine(tparams, tcfg, max_len=MAX_LEN, device="cpu")
    sched = eng.scheduler(slots_per_bucket=1, chunk=2)
    eng.submit(Request(rid=0, tokens=t_low, n_steps=10,
                       routing_override=sa))
    while not sched.n_active():
        eng.step()
    eng.submit(Request(rid=1, tokens=t_high, n_steps=4, routing_override=sa,
                       priority=9))
    out = eng.drain()
    assert out[0].metrics.preemptions >= 1
    assert out[1].metrics.preemptions == 0
    assert [p for p, *_ in sched.admissions].count(sa) == 3
    ref = ServeEngine(tparams, tcfg, max_len=MAX_LEN, device="cpu")
    for rid, toks, n in ((0, t_low, 10), (1, t_high, 4)):
        gen = ref.generate(toks[None], n, routing_override=sa)
        assert np.array_equal(out[rid].tokens, gen.tokens[0]), rid


def test_eos_retires_slot_early(models):
    _, tcfg, _, tparams = models
    toks = np.random.default_rng(6).integers(0, 512, size=24)
    full = ServeEngine(tparams, tcfg, max_len=MAX_LEN,
                       device="cpu").generate(toks[None], 8).tokens[0]
    eos = int(full[2])
    eng = ServeEngine(tparams, tcfg, max_len=MAX_LEN, device="cpu")
    eng.submit(Request(rid=0, tokens=toks, n_steps=8, eos_id=eos))
    out = eng.drain()
    stop = list(full).index(eos)
    assert out[0].tokens.tolist() == full[:stop + 1].tolist()
    assert out[0].metrics.n_generated == stop + 1
    assert not eng.scheduler().n_active()


def test_monolithic_fallback_admission(models):
    """prefill_chunk=None: every request admits through prefill →
    repack, with the same tokens as the chunked admission."""
    _, tcfg, _, tparams = models
    specs = _specs(4, seed=3, n_steps=5)
    mono = ServeEngine(tparams, tcfg, max_len=MAX_LEN, prefill_chunk=None,
                       device="cpu")
    out, geo = _drain(mono, specs, Request, slots_per_bucket=2, chunk=3)
    assert mono.scheduler().prefill_chunk_ticks == 0
    ref, _ = _drain(ServeEngine(tparams, tcfg, max_len=MAX_LEN,
                                device="cpu"), specs, Request,
                    slots_per_bucket=2, chunk=3)
    for rid, *_ in specs:
        assert np.array_equal(out[rid].tokens, ref[rid].tokens), rid
        assert out[rid].routing == ref[rid].routing


CHECKS = [("slots_per_bucket", 0), ("chunk", 0),
          ("prefill_chunks_per_tick", 0)]


@pytest.mark.parametrize("arg,value", CHECKS)
def test_constructor_checks_raise_as_jax(models, arg, value):
    jcfg, tcfg, jparams, tparams = models
    with pytest.raises(ValueError, match=arg):
        JaxEngine(jparams, jcfg, max_len=MAX_LEN).scheduler(**{arg: value})
    with pytest.raises(ValueError, match=arg):
        ContinuousScheduler(ServeEngine(tparams, tcfg, max_len=MAX_LEN,
                                        device="cpu"), **{arg: value})


@pytest.mark.parametrize("case", ["prompt_too_long", "prompt_plus_steps",
                                  "after_drain"])
def test_submit_checks_raise_as_jax(models, case):
    jcfg, tcfg, jparams, tparams = models
    toks = np.arange(MAX_LEN + 1 if case == "prompt_too_long" else 40)
    for eng, req_cls in ((JaxEngine(jparams, jcfg, max_len=MAX_LEN),
                          JaxRequest),
                         (ServeEngine(tparams, tcfg, max_len=MAX_LEN,
                                      device="cpu"), Request)):
        n_steps = 25
        if case == "after_drain":
            eng.drain()
            n_steps = 4
        with pytest.raises(ValueError, match="max_len|after drain"):
            eng.submit(req_cls(rid=0, tokens=toks, n_steps=n_steps))


def test_scheduler_is_created_once(models):
    _, tcfg, _, tparams = models
    eng = ServeEngine(tparams, tcfg, max_len=MAX_LEN, device="cpu")
    sched = eng.scheduler(chunk=2)
    assert eng.scheduler() is sched and sched.chunk == 2
    with pytest.raises(ValueError, match="already created"):
        eng.scheduler(chunk=4)
    assert eng.step() == [] and sched.ticks == 1
