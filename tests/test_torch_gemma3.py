"""The port's sliding-window ("local") layers and gemma3-12b against the
JAX package's, with the same weights (``params_from_jax``), in float32,
on gemma3's smoke variant: one period of 6 layers (5 local, then 1 routed
global layer), window 16, 4 heads over 2 KV heads (G = 2), head dim 32,
flux sink 8 / local 32.

Held:

- ``get_config`` and ``param_count`` (full and smoke) against JAX's;
- ``attention`` under ``window_mode`` against JAX's blocked engine, with
  the query rows longer and shorter than the window, at a ``q_offset``,
  G = 2, at head dims 32 and 256 (1e-5);
- ``seed_caches`` and ``repack_caches``: every ring's contents (1e-5),
  positions and lengths equal to JAX's; a local ring keeps no sink;
- ``generate`` (chunk 64 and the monolithic repack; router-driven,
  all-FA, all-SA and alternating overrides; prompts of 8, 16 and 100
  tokens against the window of 16; 40 decode steps, which wrap the local
  ring two and a half times): routing, greedy tokens and ``dispatches``
  identical, first-step logits within 1e-4;
- a slot-pool drain with staggered arrivals and one preemption:
  statuses, tokens and preemption counts equal to JAX's;
- the prefix store: a warm admission bitwise equal to the cold one and
  to JAX's tokens;
- the five kernels' plain versions at head dim 256, G = 2, against
  ``repro.kernels.ref`` (the pooled decode against the Pallas kernel in
  interpret mode), the streaming one also at sink 0 (1e-5);
- the serving CLI on the smoke variant, batch and continuous.

The router's hard decision is mean(p_fa) > 0.5 with a strict >, so every
router-driven case first checks that the routed layer's mean p_fa is
more than 1e-3 from 0.5. The JAX engines' runs are shared through the
module-scoped ``jax_runs`` fixture (their compiles are most of this
file's time).
"""
import functools
import json

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
from repro.core import modes as JM  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro.kernels.decode_attention import \
    decode_attention_pooled_bh as jax_pooled  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.core import modes as TM  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.kernels.block_sparse_attention import \
    block_sparse_attention_bh  # noqa: E402
from repro_torch.kernels.decode_attention import \
    decode_attention_bh  # noqa: E402
from repro_torch.kernels.decode_attention_pooled import \
    decode_attention_pooled_bh  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention_bh  # noqa: E402
from repro_torch.kernels.streaming_attention import \
    streaming_attention_bh  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.serve import kv_cache as TKC  # noqa: E402
from repro_torch.serve import prefix_cache as TPXC  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.slo import STATUS_OK  # noqa: E402

ARCH = "gemma3-12b"
B, N, MAX_LEN, CH = 2, 40, 160, 64
LENS = (8, 16, 100)  # shorter than, equal to and longer than the window
KTOL = 1e-5
TOL = 1e-4
MARGIN = 1e-3
ROUTINGS = {"router": None, "fa": ("fa",) * 6, "sa": ("sa",) * 6,
            "mixed": tuple("fa" if i % 2 == 0 else "sa" for i in range(6))}
# (prompt length, routing, chunk) of the JAX generate runs at B = 2
RUNS = [(S, "router", c) for c in (CH, None) for S in LENS] + [
    (LENS[-1], r, c) for c in (CH, None) for r in ("fa", "sa", "mixed")]
PREFIX_RUN = (LENS[-1], "router", CH, 1)  # the prefix store's B = 1 run


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@functools.lru_cache(maxsize=None)
def _models():
    """(JAX config, port config, JAX params, port params, prompts (B, S)
    per length) of gemma3's smoke variant."""
    jcfg = jax_smoke(jax_get_config(ARCH))
    tcfg = smoke_variant(get_config(ARCH))
    jparams = JMD.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              "cpu")
    rng = np.random.default_rng(0)
    toks = {S: rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
            for S in LENS}
    return jcfg, tcfg, jparams, tparams, toks


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

def test_config_and_param_count_match_jax():
    """11,765,391,360 parameters at full size, as JAX counts them; the
    smoke variant keeps one period of 6 layers and the window of 16."""
    tcfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    assert tcfg.param_count() == jcfg.param_count() == 11_765_391_360
    for key in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                "head_dim", "d_ff", "vocab_size", "layer_pattern",
                "sliding_window", "rope_theta", "tie_embeddings"):
        assert getattr(tcfg, key) == getattr(jcfg, key), key
    jcfg, tcfg, *_ = _models()
    assert tcfg.layer_kinds == jcfg.layer_kinds == ("local",) * 5 + (
        "attn",)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.sliding_window == 16 and tcfg.routable_layers() == (5,)
    assert TMD.check_supported(tcfg) is None


# ---------------------------------------------------------------------------
# window_mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [32, 256])
@pytest.mark.parametrize("Sq,Skv,q_offset", [(40, 40, 0), (12, 12, 0),
                                             (24, 64, 40)],
                         ids=["above_window", "below_window", "q_offset"])
def test_window_attention_matches_jax(Sq, Skv, q_offset, D):
    rng = np.random.default_rng(Sq + D)
    q = rng.standard_normal((2, 4, Sq, D)).astype(np.float32)
    k, v = (rng.standard_normal((2, 2, Skv, D)).astype(np.float32)
            for _ in range(2))
    want = JM.attention(*map(jnp.asarray, (q, k, v)), JM.window_mode(16),
                        q_offset=q_offset)
    got = TM.attention(*map(torch.tensor, (q, k, v)), TM.window_mode(16),
                       q_offset=q_offset)
    assert TM.window_mode(16) == TM.AttnMode("window", local=16)
    assert got.shape == (2, 4, Sq, D)
    assert float(np.abs(_np(got) - np.asarray(want)).max()) < KTOL


def test_window_runs_the_streaming_entry_at_sink_zero(monkeypatch):
    calls = []
    real = TM.streaming_attention_bh

    def spy(q, k, v, **kw):
        calls.append((kw["sink"], kw["local"], kw["q_offset"]))
        return real(q, k, v, **kw)
    monkeypatch.setattr(TM, "streaming_attention_bh", spy)
    x = torch.zeros((1, 4, 8, 32))
    TM.attention(x, x[:, :2], x[:, :2], TM.window_mode(16), q_offset=3)
    assert calls == [(0, 16, 3)]
    jm, tm = JM.window_mode(1024), TM.window_mode(1024)
    for Sq, Skv in ((512, 512), (4096, 4096)):
        assert TM.mode_flops(tm, Sq, Skv, 16, 256, 4) == \
            JM.mode_flops(jm, Sq, Skv, 16, 256, 4)


# ---------------------------------------------------------------------------
# seed_caches / repack_caches
# ---------------------------------------------------------------------------

PATTERN = (None,) * 5 + ("sa",)


def _jax_layer_caches(caches):
    return [{f: np.asarray(getattr(c, f)) for f in vars(c)} for c in caches]


def _assert_caches_equal(tcaches, jcaches):
    for i, (tc, jc) in enumerate(zip(tcaches, _jax_layer_caches(jcaches))):
        assert type(tc).__name__ == "RingKV", i
        for f in ("k", "v"):
            assert float(np.abs(_np(getattr(tc, f)) - jc[f]).max()) < KTOL
        assert np.array_equal(_np(tc.positions), jc["positions"]), i
        assert np.array_equal(_np(tc.length), jc["length"]), i


def _prefills(S):
    jcfg, tcfg, jparams, tparams, toks = _models()
    p = toks[LENS[-1]][:, :S]
    jpf = JMD.prefill(jparams, jcfg, jnp.asarray(p), routing_ctx="fa_only")
    tpf = TMD.prefill(tparams, tcfg, torch.tensor(p).long(),
                      routing_ctx="fa_only")
    return jcfg, tcfg, jpf, tpf


@pytest.mark.parametrize("S", [12, 40])
def test_seed_caches_match_jax(S):
    """A route chunk of 12 (inside the window) or 40 tokens (past the
    window of 16, and filling the SA ring of 8 + 32) seeded into the
    decode caches: the local rings hold the last 16 positions at slot
    p % 16, no sink; the SA ring keeps its sink."""
    jcfg, tcfg, jpf, tpf = _prefills(S)
    jc = JE.seed_caches(jcfg, jpf.caches, PATTERN, B, MAX_LEN)
    tc = TE.seed_caches(tcfg, tpf.caches, PATTERN, B, MAX_LEN, "cpu")
    _assert_caches_equal(tc, jc)
    for c in tc[:5]:
        assert TKC.capacity(c) == 16
        want = [p for p in range(max(0, S - 16), S)]
        assert sorted(p for p in _np(c.positions[0]) if p >= 0) == want
        for slot, p in enumerate(_np(c.positions[0])):
            assert p < 0 or p % 16 == slot
    assert TKC.capacity(tc[5]) == 40
    assert list(_np(tc[5].positions[0])[:8]) == list(range(min(8, S)))


@pytest.mark.parametrize("routing", ["sa", "fa"])
def test_repack_caches_match_jax(routing):
    jcfg, tcfg, jpf, tpf = _prefills(40)
    pattern = (None,) * 5 + (routing,)
    jc = JE.repack_caches(jcfg, jpf.caches, pattern, 40, MAX_LEN)
    tc = TE.repack_caches(tcfg, tpf.caches, pattern, 40, MAX_LEN)
    _assert_caches_equal(tc[:5], jc[:5])
    for c in tc[:5]:
        assert sorted(p for p in _np(c.positions[0]) if p >= 0) == list(
            range(24, 40))
    if routing == "sa":
        _assert_caches_equal(tc[5:], jc[5:])
    else:
        assert isinstance(tc[5], TKC.FullKV)
        assert float(np.abs(_np(tc[5].k) - np.asarray(jc[5].k)).max()) \
            < KTOL
        assert np.array_equal(_np(tc[5].length), np.asarray(jc[5].length))


def test_local_ring_ignores_mode_and_max_len_caps_it():
    """A local layer's ring is min(sliding_window, max_len) slots with no
    sink whatever the mode; the SA ring of the routed layer is
    sink + local."""
    _, tcfg, *_ = _models()
    for mode in ("fa", "sa", None):
        c = TKC.init_layer_cache(tcfg, "local", mode, 2, MAX_LEN, "cpu")
        assert isinstance(c, TKC.RingKV) and TKC.capacity(c) == 16
    assert TKC.capacity(TKC.init_layer_cache(tcfg, "local", None, 2, 10,
                                             "cpu")) == 10
    assert TMD.ring_sink(tcfg, 0) == 0 and TMD.ring_sink(tcfg, 5) == 8


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs():
    """JAX generate results and first-step logits per (prompt length,
    routing, chunk[, batch]) of ``RUNS`` and ``PREFIX_RUN``, one engine
    per chunk size."""
    jcfg, _, jparams, _, toks = _models()
    engines, out = {}, {}
    for S, routing, chunk, *b in RUNS + [PREFIX_RUN]:
        if chunk not in engines:
            engines[chunk] = JaxEngine(jparams, jcfg, max_len=MAX_LEN,
                                       prefill_chunk=chunk)
        eng = engines[chunk]
        ov = ROUTINGS[routing]
        p = toks[S][:b[0]] if b else toks[S]
        gen = eng.generate(p, N, routing_override=ov)
        if eng.chunked_eligible(S, ov):
            logits = eng.prefill_chunked(jnp.asarray(p), ov,
                                         reuse=False).logits
        else:
            logits = eng.prefill_route_repack(jnp.asarray(p), ov)[0].logits
        out[(S, routing, chunk, *b)] = (gen, np.asarray(logits))
    return out


@pytest.mark.parametrize("S,routing,chunk", RUNS,
                         ids=[f"S{S}-{r}-{'c64' if c else 'mono'}"
                              for S, r, c in RUNS])
def test_generate_matches_jax(jax_runs, S, routing, chunk):
    _, tcfg, _, tparams, toks = _models()
    jgen, jlogits = jax_runs[S, routing, chunk]
    ov = ROUTINGS[routing]
    eng = ServeEngine(tparams, tcfg, max_len=MAX_LEN, prefill_chunk=chunk,
                      device="cpu")
    gen = eng.generate(toks[S], N, routing_override=ov)
    if ov is None:
        assert np.all(np.abs(jgen.p_fa - 0.5) > MARGIN), jgen.p_fa
        np.testing.assert_allclose(gen.p_fa, jgen.p_fa, atol=1e-5)
    assert gen.routing == jgen.routing
    assert gen.routing[:5] == (None,) * 5  # local layers are never routed
    assert gen.msr == jgen.msr and gen.kv_bytes == jgen.kv_bytes
    assert gen.dispatches == jgen.dispatches
    assert np.array_equal(gen.tokens, np.asarray(jgen.tokens))
    assert float(np.abs(_np(gen.logits) - jlogits).max()) < TOL


def test_chunked_prefill_local_rings_hold_the_window():
    """After a chunked admission of 100 tokens (chunks of 64, 32 and 4,
    each longer or shorter than the ring) every local ring holds
    positions 84-99 at slot p % 16, and one decode step leaves 85-100:
    no slot is kept as a sink."""
    _, tcfg, _, tparams, toks = _models()
    eng = ServeEngine(tparams, tcfg, max_len=MAX_LEN, prefill_chunk=CH,
                      device="cpu")
    job = eng.prefill_chunked(torch.tensor(toks[100]).long(), None,
                              reuse=False)
    for want, caches in ((range(84, 100), job.caches), (range(85, 101),
                                                       None)):
        if caches is None:
            tok = torch.argmax(job.logits, dim=-1)[:, None]
            _, caches = TMD.decode_core(tparams, tcfg, tok, job.caches, 100)
        for c in caches[:5]:
            pos = _np(c.positions)
            assert sorted(pos[0]) == list(want)
            assert all(p % 16 == s for s, p in enumerate(pos[0]))
            assert np.array_equal(pos[0], pos[1])


# ---------------------------------------------------------------------------
# The slot pool and the prefix store
# ---------------------------------------------------------------------------

DRAIN_LENS = (20, 28, 9, 24)


def _drain(engine, req_cls):
    """Four requests into 2-slot pools in decode chunks of 4, all under
    the alternating override (one geometry), the last two arriving after
    the first tick; once both slots hold a request, a fifth at priority
    9 preempts one."""
    _, tcfg, *_ = _models()
    rng = np.random.default_rng(2)
    ov = ROUTINGS["mixed"]
    sched = engine.scheduler(slots_per_bucket=2, chunk=4,
                             prefill_chunks_per_tick=2)
    prompts = [rng.integers(0, tcfg.vocab_size, n) for n in DRAIN_LENS]
    for rid in (0, 1):
        engine.submit(req_cls(rid=rid, tokens=prompts[rid], n_steps=20,
                              routing_override=ov))
    engine.step()
    for rid in (2, 3):
        engine.submit(req_cls(rid=rid, tokens=prompts[rid], n_steps=20,
                              routing_override=ov))
    for _ in range(8):
        if sched.n_active() == 2:
            break
        engine.step()
    assert sched.n_active() == 2
    engine.submit(req_cls(rid=9, tokens=rng.integers(0, tcfg.vocab_size, 17),
                          n_steps=6, priority=9, routing_override=ov))
    return engine.drain(), sched


def test_drain_with_preemption_matches_jax():
    jcfg, tcfg, jparams, tparams, _ = _models()
    jout, jsched = _drain(JaxEngine(jparams, jcfg, max_len=MAX_LEN,
                                    prefill_chunk=16), JaxRequest)
    tout, tsched = _drain(ServeEngine(tparams, tcfg, max_len=MAX_LEN,
                                      prefill_chunk=16, device="cpu"),
                          Request)
    assert sorted(tout) == sorted(jout)
    for rid in jout:
        assert tout[rid].status == jout[rid].status == STATUS_OK
        assert np.array_equal(tout[rid].tokens, jout[rid].tokens), rid
        assert (tout[rid].metrics.preemptions
                == jout[rid].metrics.preemptions), rid
    assert sum(f.metrics.preemptions for f in tout.values()) >= 1
    (tpool,), (jpool,) = tsched.pools.values(), jsched.pools.values()
    assert tpool.geometry() == jpool.geometry()
    assert [TKC.capacity(c) for c in tpool.caches] == [16] * 5 + [40]


def test_prefix_store_warm_equals_cold_and_jax(jax_runs):
    """A 100-token prompt served cold (publishing its 64-token boundary),
    then again from the store: a 64-token hit, the 36-token suffix
    streamed into the restored local rings; tokens and first and last
    logits bitwise the cold run's, tokens JAX's."""
    _, tcfg, _, tparams, toks = _models()
    p = toks[100][:1]
    jgen, _ = jax_runs[PREFIX_RUN]
    need = TPXC.snapshot_spec_bytes(tcfg, (None,) * 5 + ("sa",), MAX_LEN)
    eng = ServeEngine(tparams, tcfg, max_len=MAX_LEN, prefill_chunk=CH,
                      prefix_cache_mb=4 * need / 2 ** 20, device="cpu")
    cold = eng.generate(p, N)
    warm = eng.generate(p, N)
    assert (cold.prefix_hit_tokens, warm.prefix_hit_tokens) == (0, 64)
    assert np.array_equal(cold.tokens, np.asarray(jgen.tokens))
    assert np.array_equal(warm.tokens, cold.tokens)
    assert torch.equal(warm.logits, cold.logits)
    assert torch.equal(warm.final_logits, cold.final_logits)
    assert warm.routing == cold.routing == jgen.routing


# ---------------------------------------------------------------------------
# The kernels' plain versions at head dim 256
# ---------------------------------------------------------------------------

def _qkv(seed, BH, BHkv, Sq, Skv, D=256):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BH, Sq, D)).astype(np.float32),
            rng.standard_normal((BHkv, Skv, D)).astype(np.float32),
            rng.standard_normal((BHkv, Skv, D)).astype(np.float32))


def _close(got, want):
    assert float(np.abs(_np(got) - np.asarray(want)).max()) < KTOL


@pytest.mark.parametrize("sink,local", [(0, 64), (0, 200), (8, 64)])
def test_streaming_plain_at_d256_matches_jax(sink, local):
    q, k, v = _qkv(sink + local, 4, 2, 130, 230)
    want = JR.streaming_attention_ref(*map(jnp.asarray, (q, k, v)),
                                      sink=sink, local=local, q_offset=100)
    got = streaming_attention_bh(*map(torch.tensor, (q, k, v)), sink=sink,
                                 local=local, q_offset=100)
    _close(got, want)


def test_flash_and_block_sparse_plain_at_d256_match_jax():
    q, k, v = _qkv(1, 4, 2, 130, 130)
    for causal in (True, False):
        want = JR.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                      causal=causal)
        _close(flash_attention_bh(*map(torch.tensor, (q, k, v)),
                                  causal=causal), want)
    sel = np.array([[0, 1, -1], [2, 0, 1], [-1, 2, 1]], np.int32)
    sel = np.broadcast_to(sel, (4, 3, 3)).copy()
    want = JR.block_sparse_attention_ref(*map(jnp.asarray, (q, k, v, sel)),
                                         block=64)
    _close(block_sparse_attention_bh(*map(torch.tensor, (q, k, v, sel))),
           want)


def test_decode_plains_at_d256_match_jax():
    """The batch decode over a ring with holes, and the pooled decode
    over FullKV rows of ragged lengths (a length-0 slot's rows zeros)."""
    q, k, v = _qkv(2, 4, 2, 1, 96)
    pos = np.random.default_rng(3).permutation(120)[:96].astype(np.int32)
    pos[::7] = -1
    want = JR.decode_attention_ref(*map(jnp.asarray, (q, k, v, pos)), 90)
    _close(decode_attention_bh(*map(torch.tensor, (q, k, v, pos)), 90),
           want)
    q, k, v = _qkv(4, 3 * 4, 3 * 2, 1, 96)
    lens = np.array([0, 37, 96], np.int32)
    full = np.broadcast_to(np.arange(96, dtype=np.int32), (3, 96)).copy()
    want = jax_pooled(*map(jnp.asarray, (q, k, v, full, lens)), n_heads=4,
                      block_k=32, interpret=True)
    got = decode_attention_pooled_bh(*map(torch.tensor, (q, k, v)), None,
                                     torch.tensor(lens), n_heads=4)
    _close(got, want)
    assert not got[:4].any()
    # and the port's own pooled plain against its batch plain per slot
    for b, n in enumerate(lens[1:], 1):
        one = TR.decode_attention_ref(
            torch.tensor(q[4 * b:4 * b + 4]), torch.tensor(k[2 * b:2 * b + 2]),
            torch.tensor(v[2 * b:2 * b + 2]),
            torch.arange(96, dtype=torch.int32), int(n) - 1)
        _close(got[4 * b:4 * b + 4], _np(one))


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--continuous", "--slots", "2",
                                        "--chunk", "4"]],
                         ids=["batch", "continuous"])
def test_cli_serves_gemma3_smoke(capsys, extra):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests",
                "2", "--prompt-len", "40", "--gen-len", "20",
                "--prefill-chunk", "16", *extra])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith('{"rid"')]
    assert [r["rid"] for r in rows] == [0, 1]
    assert all(r["status"] == "ok" and len(r["tokens"]) == 20 for r in rows)
