"""The port's shared-prefix radix cache (``serve/prefix_cache.py`` and the
engine's restore / publish path) against the JAX package's, on the
phi3-mini smoke config with the same weights (``params_from_jax``).

Both engines run the same sequence (a cold admission that publishes every
full-chunk boundary, ``offload_all``, a full-cover hit from the host tier,
a partial hit) and must agree on routing, greedy tokens,
``prefix_hit_tokens``, ``chunks_streamed`` and the store's ``stats()``
after every step; boundary logits agree within ``TOL`` (float32,
summation order only), and the port's warm tokens and logits equal its
own cold ones bitwise. The port writes its caches in place, so the
aliasing guard decodes twice from the same snapshots and checks that no
stored buffer changed. The store alone is driven through one random
sequence of operations beside JAX's, with fake snapshots of equal
``nbytes``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread: as fast at these small shapes, and it leaves the other
# cores to the test processes running beside this one
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_variant as jax_smoke  # noqa: E402
from repro.core.router import \
    prefix_routing_reusable as jax_reusable  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro.serve import kv_cache_stats as jax_kv_cache_stats  # noqa: E402
from repro.serve import prefix_cache as JPXC  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.core.router import prefix_routing_reusable  # noqa: E402
from repro_torch.models.model import snapshot_state  # noqa: E402
from repro_torch.serve import kv_cache as KC  # noqa: E402
from repro_torch.serve import prefix_cache as PXC  # noqa: E402
from repro_torch.serve.engine import (Request, ServeEngine,  # noqa: E402
                                      kv_cache_stats)

ARCH = "phi3-mini-3.8b"
CH, N, MAX_LEN = 16, 6, 64
TOL = 1e-4  # as tests/test_torch_serve.py
PATTERNS = {"router": None, "mixed": ("fa", "sa")}
STORE = dict(prefix_cache_mb=64, prefix_cache_host_mb=64)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke(jax_get_config(ARCH))
    tcfg = smoke_variant(get_config(ARCH))
    jparams = JMD.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              "cpu")
    return jcfg, tcfg, jparams, tparams


def _prompts(vocab, prefix_len=32, tails=(16, 13), seed=0):
    """(1, S) prompts sharing a ``prefix_len``-token prefix."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, size=prefix_len).astype(np.int32)
    return [np.concatenate([
        prefix, rng.integers(0, vocab, size=t).astype(np.int32)])[None]
        for t in tails]


def _port(tparams, tcfg, **kw):
    return ServeEngine(tparams, tcfg, max_len=MAX_LEN, device="cpu", **kw)


def _stats(eng):
    return eng.prefix_store.stats().as_dict()


def _equal_state(a_caches, a_logits, b_caches, b_logits) -> bool:
    """Bitwise equality of two (caches, logits) states."""
    if not torch.equal(a_logits, b_logits) or len(a_caches) != len(b_caches):
        return False
    return all(type(x) is type(y) and all(
        torch.equal(s, t) for s, t in zip(KC.cache_fields(x),
                                          KC.cache_fields(y)))
        for x, y in zip(a_caches, b_caches))


# ---------------------------------------------------------------------------
# Batch path: cold → offload → full-cover hit → partial hit, against JAX
# ---------------------------------------------------------------------------

def _hit_sequence(eng, pA, pB, jax_side: bool):
    """The test sequence on one engine; per step (name, result, stats)."""
    to = jnp.asarray if jax_side else (lambda x: x)
    out = [("gen_A_cold", eng.generate(pA, N), _stats(eng))]
    eng.prefix_store.offload_all()
    out.append(("offload_all", None, _stats(eng)))
    out.append(("job_A_host_hit", eng.prefill_chunked(to(pA)), _stats(eng)))
    out.append(("gen_A_hit", eng.generate(pA, N), _stats(eng)))
    out.append(("gen_B_hit", eng.generate(pB, N), _stats(eng)))
    out.append(("job_B_hit", eng.prefill_chunked(to(pB)), _stats(eng)))
    return out


@pytest.fixture(scope="module")
def batch_runs(models):
    jcfg, tcfg, jparams, tparams = models
    pA, pB = _prompts(jcfg.vocab_size)
    runs = {}
    for name, ov in PATTERNS.items():
        jeng = JaxEngine(jparams, jcfg, max_len=MAX_LEN, prefill_chunk=CH,
                         routing_override=ov, **STORE)
        teng = _port(tparams, tcfg, prefill_chunk=CH, routing_override=ov,
                     **STORE)
        cold = _port(tparams, tcfg, prefill_chunk=CH, routing_override=ov)
        runs[name] = (_hit_sequence(jeng, pA, pB, True), jeng,
                      _hit_sequence(teng, pA, pB, False), teng,
                      {"A": cold.generate(pA, N), "B": cold.generate(pB, N)})
    return pA, pB, runs


@pytest.mark.parametrize("name", list(PATTERNS))
def test_hit_path_matches_jax(batch_runs, name):
    pA, pB, runs = batch_runs
    jseq, _, tseq, _, _ = runs[name]
    for (step, jres, jstats), (_, tres, tstats) in zip(jseq, tseq):
        assert tstats == jstats, step
        if jres is None:
            continue
        assert tres.prefix_hit_tokens == jres.prefix_hit_tokens, step
        if step.startswith("gen"):
            assert tres.routing == jres.routing, step
            assert np.array_equal(tres.tokens, np.asarray(jres.tokens)), step
        else:
            assert tres.pattern == jres.pattern, step
            assert tres.chunks_streamed == jres.chunks_streamed, step
            assert tres.idx == jres.idx == len(tres.plan), step
            err = float(np.abs(tres.logits.numpy()
                               - np.asarray(jres.logits)).max())
            assert err < TOL, (step, err)
    res = {step: r for step, r, _ in tseq}
    # boundaries 16 / 32 / 48 published by A, B's ragged tail never
    assert tseq[0][2]["snapshots"] == 3
    assert res["job_A_host_hit"].chunks_streamed == 0          # full cover
    assert res["job_A_host_hit"].prefix_hit_tokens == pA.shape[1]
    assert res["gen_B_hit"].prefix_hit_tokens == 32            # partial
    assert res["job_B_hit"].chunks_streamed == 3               # 8 + 4 + 1
    assert res["gen_A_cold"].prefix_hit_tokens == 0


@pytest.mark.parametrize("name", list(PATTERNS))
def test_warm_equals_cold_bitwise(batch_runs, name):
    """A warm admission repeats the cold one's arithmetic on the same
    buffers: tokens and first logits are bitwise equal."""
    _, _, runs = batch_runs
    _, _, tseq, _, cold = runs[name]
    res = {step: r for step, r, _ in tseq}
    for step, ref in (("gen_A_cold", "A"), ("gen_A_hit", "A"),
                      ("gen_B_hit", "B")):
        assert np.array_equal(res[step].tokens, cold[ref].tokens), step
        assert torch.equal(res[step].logits, cold[ref].logits), step
        assert res[step].routing == cold[ref].routing


def test_kv_cache_stats_matches_jax(batch_runs):
    """Payload / overhead / prefix-tier byte split of one job's caches."""
    _, _, runs = batch_runs
    jseq, jeng, tseq, teng, _ = runs["mixed"]
    jjob, tjob = jseq[-1][1], tseq[-1][1]
    js = jax_kv_cache_stats(jjob.caches, jeng.prefix_store)
    ts = kv_cache_stats(tjob.caches, teng.prefix_store)
    for f in ("payload_bytes", "overhead_bytes", "prefix_device_bytes",
              "prefix_host_bytes", "total_bytes"):
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.prefix_device_bytes > 0 and ts.prefix_host_bytes > 0


@pytest.mark.parametrize("pattern", [("fa", "fa"), ("sa", "sa"),
                                     ("fa", "sa")])
def test_snapshot_spec_bytes_matches_jax(models, pattern):
    jcfg, tcfg, _, _ = models
    assert (PXC.snapshot_spec_bytes(tcfg, pattern, MAX_LEN)
            == JPXC.snapshot_spec_bytes(jcfg, pattern, MAX_LEN))


# ---------------------------------------------------------------------------
# Bitwise store round trip and the aliasing guard (the port writes in place)
# ---------------------------------------------------------------------------

def test_host_round_trip_is_bitwise(models):
    """Store → offload_all → restore: the restored caches and logits equal
    the cold chunked admission's at that boundary, bit for bit."""
    jcfg, tcfg, _, tparams = models
    pA, _ = _prompts(jcfg.vocab_size)
    eng = _port(tparams, tcfg, prefill_chunk=CH, **STORE)
    eng.prefill_chunked(pA)
    assert eng.prefix_store.offload_all() == 3
    cold = _port(tparams, tcfg, prefill_chunk=CH)
    for boundary in (16, 32, 48):
        ref = cold.prefill_chunked(pA[:, :boundary], reuse=False)
        job = eng.start_chunked_prefill(pA[:, :boundary])
        assert job.done and job.chunks_streamed == 0
        assert job.prefix_hit_tokens == boundary
        assert job.pattern == ref.pattern
        assert _equal_state(job.caches, job.logits, ref.caches, ref.logits)
    s = eng.prefix_store.stats()
    assert s.hits == 3 and s.host_bytes == 0  # every hit promoted


def test_second_hit_leaves_the_store_unchanged(models):
    """Two warm hits on one prefix, each with decode: identical tokens,
    and every stored snapshot equals a copy taken before the hits. A
    restore that handed out the store's own buffers, or a publication
    that kept the live ones, would fail here."""
    jcfg, tcfg, _, tparams = models
    pA, pB = _prompts(jcfg.vocab_size)
    eng = _port(tparams, tcfg, prefill_chunk=CH, routing_override=("fa", "sa"),
                prefix_cache_mb=64)
    eng.generate(pA, N)
    store = eng.prefix_store
    before = {id(n): snapshot_state(n.snap.caches, n.snap.logits)
              for n in store._lru.values()}
    assert len(before) == 3
    outs = [eng.generate(p, N) for p in (pB, pB, pA, pA)]
    assert [o.prefix_hit_tokens for o in outs] == [32, 32, 48, 48]
    assert np.array_equal(outs[0].tokens, outs[1].tokens)
    assert np.array_equal(outs[2].tokens, outs[3].tokens)
    assert store.stats().inserts == 3  # nothing new was published
    for n in store._lru.values():
        caches, logits = before[id(n)]
        assert _equal_state(n.snap.caches, n.snap.logits, caches, logits)


# ---------------------------------------------------------------------------
# The store alone: one random operation sequence beside JAX's
# ---------------------------------------------------------------------------

def _fake_pair(rng, boundary):
    """The same fake boundary state for both stores, of equal nbytes."""
    k = rng.normal(size=(1, 1, 8, 4)).astype(np.float32)
    logits = rng.normal(size=(1, 8)).astype(np.float32)
    length = np.full((1,), boundary, np.int32)
    jcaches = [jnp.asarray(k)]
    tc = [KC.FullKV(k=torch.from_numpy(k), v=torch.from_numpy(k.copy()),
                    length=torch.from_numpy(length))]
    nbytes = 2 * k.nbytes + length.nbytes + logits.nbytes
    jsnap = JPXC.Snapshot(caches=jcaches, logits=jnp.asarray(logits),
                          pattern=("fa",), p_fa=None, boundary=boundary,
                          nbytes=nbytes)
    tsnap = PXC.Snapshot(caches=tc, logits=torch.from_numpy(logits),
                         pattern=("fa",), p_fa=None, boundary=boundary,
                         nbytes=nbytes)
    assert PXC.state_bytes(tc, tsnap.logits) == nbytes
    return jsnap, tsnap


def test_store_stats_match_jax_under_random_ops():
    rng = np.random.default_rng(7)
    one = _fake_pair(rng, 4)[1].nbytes
    kw = dict(chunk=4, budget_bytes=int(one * 3.5),
              host_budget_bytes=int(one * 2.5))
    jst, tst = JPXC.PrefixStore(**kw), PXC.PrefixStore(**kw)
    events = {"jax": [], "port": []}
    jst.on_event, tst.on_event = events["jax"].append, events["port"].append
    pins = []  # (jax node, port node) pairs held by acquire
    keys = [("router", 0), ("override", ("fa",))]
    ops = ["insert"] * 4 + ["match"] * 3 + ["release", "offload"]
    # prompts drawn as prefixes of three that share their first chunk,
    # so lookups hit at several depths
    bases = [np.concatenate([np.zeros(4, np.int32),
                             rng.integers(0, 2, size=16)]) for _ in range(3)]
    seen = set()
    for _ in range(160):
        op = ops[rng.integers(len(ops))]
        toks = bases[int(rng.integers(3))][:4 * int(rng.integers(1, 6))]
        key = keys[int(rng.integers(2))]
        seen.add(op)
        if op == "insert":
            b = 4 * int(rng.integers(1, toks.size // 4 + 1))
            js, ts = _fake_pair(rng, b)
            jn, tn = jst.insert(toks, js, key), tst.insert(toks, ts, key)
            assert jn.depth == tn.depth == b
        elif op == "match":
            jn, tn = jst.match(toks, key), tst.match(toks, key)
            assert (jn is None) == (tn is None)
            if jn is not None:
                assert (jn.depth, jn.on_host) == (tn.depth, tn.on_host)
                if tn.on_host:  # a host hit prefetches and promotes
                    seen.add("promote")
                    js, ts = _fake_pair(rng, tn.depth)
                    jst.promote(jn, js.caches, js.logits)
                    tst.promote(tn, ts.caches, ts.logits)
                if rng.random() < 0.5:
                    jst.acquire(jn)
                    tst.acquire(tn)
                    pins.append((jn, tn))
        elif op == "release" and pins:
            jn, tn = pins.pop(int(rng.integers(len(pins))))
            jst.release(jn)
            tst.release(tn)
        elif op == "offload":
            assert jst.offload_all() == tst.offload_all()
        assert tst.stats().as_dict() == jst.stats().as_dict(), op
        assert tst.covered(toks, 4, key) == jst.covered(toks, 4, key)
    s = tst.stats()
    assert seen >= {"insert", "match", "release", "offload", "promote"}
    assert s.demotions > 0 and s.drops > 0 and s.hits == 0
    assert events["port"] == events["jax"]
    for jn, tn in pins:
        jst.release(jn)
        tst.release(tn)
    with pytest.raises(RuntimeError, match="refcount"):
        tst.release(tn)


def test_demotion_keeps_a_cpu_snapshot_bitwise():
    """On the CPU a demoted snapshot is a fresh copy of each buffer."""
    rng = np.random.default_rng(8)
    _, ts = _fake_pair(rng, 4)
    store = PXC.PrefixStore(chunk=4, budget_bytes=ts.nbytes,
                            host_budget_bytes=ts.nbytes)
    node = store.insert(np.arange(4), ts, ("router", 0))
    store.offload_all()
    assert node.on_host and node.snap is not ts
    for a, b in zip(KC.cache_fields(node.snap.caches[0]),
                    KC.cache_fields(ts.caches[0])):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


# ---------------------------------------------------------------------------
# Routing compatibility, routing keys, opt-out, short prompts
# ---------------------------------------------------------------------------

def test_prefix_routing_reusable_matches_jax(models):
    jcfg, tcfg, _, _ = models
    for prefix_len in range(0, 20):
        for seq_len in range(0, 20):
            for pooling in ("prefix", "prefix_suffix"):
                for routable in (True, False):
                    kw = dict(pooling=pooling, routable=routable)
                    assert (prefix_routing_reusable(
                        tcfg.flux, prefix_len, seq_len, **kw)
                        == jax_reusable(jcfg.flux, prefix_len, seq_len,
                                        **kw)), (prefix_len, seq_len, kw)


def test_routing_key_mismatch_and_opt_out(models):
    """Router-keyed snapshots are never offered to an override (nor the
    reverse), and ``prefix_reuse=False`` neither hits nor publishes."""
    jcfg, tcfg, _, tparams = models
    pA, _ = _prompts(jcfg.vocab_size)
    assert PXC.routing_key(None) == JPXC.routing_key(None)
    assert PXC.routing_key(("fa", "sa")) == JPXC.routing_key(("fa", "sa"))
    eng = _port(tparams, tcfg, prefill_chunk=CH, prefix_cache_mb=64)
    out = eng.generate(pA, N, prefix_reuse=False)
    assert out.prefix_hit_tokens == 0 and _stats(eng)["inserts"] == 0
    assert _stats(eng)["misses"] == 0  # an opt-out is not a miss
    eng.generate(pA, N)                                # router snapshots
    gen = eng.generate(pA, N, routing_override=("fa", "sa"))
    assert gen.prefix_hit_tokens == 0                  # override ≠ router
    assert eng.generate(pA, N).prefix_hit_tokens == pA.shape[1]
    ref = _port(tparams, tcfg, prefill_chunk=CH).generate(pA, N)
    assert np.array_equal(out.tokens, ref.tokens)


def test_short_prompt_routing_neither_publishes_nor_hits(models):
    """chunk 4 < pool_size 8: a 4-token boundary predates the router's
    pool window, so nothing router-driven publishes."""
    jcfg, tcfg, jparams, tparams = models
    toks = np.arange(4, dtype=np.int32)[None] % tcfg.vocab_size
    out = {}
    for side, eng in (
            ("jax", JaxEngine(jparams, jcfg, max_len=MAX_LEN,
                              prefill_chunk=4, prefix_cache_mb=64)),
            ("port", _port(tparams, tcfg, prefill_chunk=4,
                           prefix_cache_mb=64))):
        eng.generate(toks, 2)
        out[side] = _stats(eng)
    assert out["port"] == out["jax"] and out["port"]["inserts"] == 0


# ---------------------------------------------------------------------------
# Configuration and publication errors
# ---------------------------------------------------------------------------

def test_budget_below_one_snapshot_raises(models):
    _, tcfg, _, tparams = models
    with pytest.raises(ValueError, match="prefix_cache_mb.*snapshot"):
        _port(tparams, tcfg, prefill_chunk=CH, prefix_cache_mb=1e-4)


def test_store_without_chunked_prefill_raises(models):
    _, tcfg, _, tparams = models
    with pytest.raises(ValueError, match="chunk"):
        _port(tparams, tcfg, prefill_chunk=None, prefix_cache_mb=64)


def test_duo_override_with_a_store_raises(models):
    _, tcfg, _, tparams = models
    with pytest.raises(ValueError, match="duo head-split"):
        _port(tparams, tcfg, prefill_chunk=CH, prefix_cache_mb=64,
              routing_override=(("duo", 1), ("duo", 1)))


def test_publish_from_repack_fallback_raises(models):
    _, tcfg, _, tparams = models
    eng = _port(tparams, tcfg, prefill_chunk=CH,
                routing_pooling="prefix_suffix", prefix_cache_mb=64)
    toks = np.arange(32, dtype=np.int32)[None] % tcfg.vocab_size
    assert not eng.chunked_eligible(32)
    pf, pattern, caches, _ = eng.prefill_route_repack(toks)
    with pytest.raises(ValueError, match="repack fallback"):
        eng.publish_prefix(toks[0], CH, caches, pf.logits, pattern)


def test_publish_off_boundary_raises(models):
    jcfg, tcfg, _, tparams = models
    pA, _ = _prompts(jcfg.vocab_size)
    eng = _port(tparams, tcfg, prefill_chunk=CH, prefix_cache_mb=64)
    job = eng.prefill_chunked(pA)
    with pytest.raises(ValueError, match="boundary"):
        eng.publish_prefix(pA[0], CH + 3, job.caches, job.logits,
                           job.pattern)


# ---------------------------------------------------------------------------
# The slot-pool scheduler: hit metrics, summary, preemption
# ---------------------------------------------------------------------------

SUMMARY_KEYS = ("n_requests", "prompt_tokens", "prefix_hit_tokens",
                "prefix_hit_fraction", "kv_payload_bytes",
                "prefix_device_bytes", "prefix_host_bytes")


def _shared_requests(vocab, req_cls):
    rng = np.random.default_rng(4)
    prefix = rng.integers(0, vocab, size=16).astype(np.int32)
    return [req_cls(rid=i, tokens=np.concatenate([
        prefix, rng.integers(0, vocab, size=t).astype(np.int32)]),
        n_steps=4) for i, t in enumerate((8, 11, 5))]


def test_drain_hit_metrics_and_summary_match_jax(models):
    jcfg, tcfg, jparams, tparams = models
    outs = {}
    for side, eng, req_cls in (
            ("jax", JaxEngine(jparams, jcfg, max_len=MAX_LEN,
                              prefill_chunk=8, prefix_cache_mb=64),
             JaxRequest),
            ("port", _port(tparams, tcfg, prefill_chunk=8,
                           prefix_cache_mb=64), Request)):
        eng.scheduler(slots_per_bucket=2, chunk=4)
        for r in _shared_requests(jcfg.vocab_size, req_cls):
            eng.submit(r)
        outs[side] = eng.drain()
    j, t = outs["jax"], outs["port"]
    for rid in range(3):
        assert np.array_equal(t[rid].tokens, j[rid].tokens), rid
        assert (t[rid].metrics.prefix_hit_tokens
                == j[rid].metrics.prefix_hit_tokens), rid
    for k in SUMMARY_KEYS:
        assert t.summary[k] == j.summary[k], k
    assert (t.summary["prefix_store"].as_dict()
            == j.summary["prefix_store"].as_dict())
    # the first request warms boundaries 8 and 16, later ones reuse 16
    assert [t[i].metrics.prefix_hit_tokens for i in range(3)] == [0, 16, 16]
    assert t.summary["prefix_hit_tokens"] == 32
    ref = _port(tparams, tcfg, prefill_chunk=8)
    for r in _shared_requests(jcfg.vocab_size, Request):
        gen = ref.generate(r.tokens[None], r.n_steps)
        assert np.array_equal(t[r.rid].tokens, gen.tokens[0]), r.rid


def _active(sched):
    return {inf.req.rid for p in sched.pools.values()
            for inf in p.active.values()}


def _preempt_drive(eng, req_cls, low, highs):
    """One slot; the low-priority request is preempted twice. Its first
    recompute publishes a boundary past its prompt, which the second
    recompute hits."""
    ov = ("fa", "sa")
    sched = eng.scheduler(slots_per_bucket=1, chunk=2)
    eng.submit(req_cls(rid=0, tokens=low, n_steps=36, routing_override=ov))
    for rid, toks in enumerate(highs, start=1):
        while 0 not in _active(sched):
            eng.step()
        for _ in range(5):  # 2 tokens a tick
            eng.step()
        eng.submit(req_cls(rid=rid, tokens=toks, n_steps=2, priority=9,
                           routing_override=ov))
        while 0 in _active(sched):  # until the arrival preempts it
            eng.step()
    return eng.drain(), sched


def test_preempted_hits_reset_and_clamp_as_jax(models):
    jcfg, tcfg, jparams, tparams = models
    rng = np.random.default_rng(5)
    low = rng.integers(0, jcfg.vocab_size, size=24).astype(np.int32)
    highs = [rng.integers(0, jcfg.vocab_size, size=20).astype(np.int32)
             for _ in range(2)]
    j, _ = _preempt_drive(JaxEngine(jparams, jcfg, max_len=MAX_LEN,
                                    prefill_chunk=8, prefix_cache_mb=64),
                          JaxRequest, low, highs)
    t, sched = _preempt_drive(_port(tparams, tcfg, prefill_chunk=8,
                                    prefix_cache_mb=64),
                              Request, low, highs)
    for rid in range(3):
        assert np.array_equal(t[rid].tokens, j[rid].tokens), rid
        assert (t[rid].metrics.preemptions
                == j[rid].metrics.preemptions), rid
        assert (t[rid].metrics.prefix_hit_tokens
                == j[rid].metrics.prefix_hit_tokens), rid
    for k in SUMMARY_KEYS:
        assert t.summary[k] == j.summary[k], k
    assert (t.summary["prefix_store"].as_dict()
            == j.summary["prefix_store"].as_dict())
    assert t[0].metrics.preemptions == 2
    # rid 0's last admission hit past its 24-token prompt: clamped
    last = [hit for pattern, n, hit in sched.admissions if n > 24][-1]
    assert last > 24 and t[0].metrics.prefix_hit_tokens == 24
    alone = _port(tparams, tcfg, prefill_chunk=8).generate(
        low[None], 36, routing_override=("fa", "sa"))
    assert np.array_equal(t[0].tokens, alone.tokens[0])
