"""The paper's comparison set in the port against the JAX package, on the
phi3-mini smoke config (stablelm's for the G = 2 decode property) with
the same weights (``params_from_jax``), in float32:

- the head-level baselines (DuoAttention / PruLong): ``head_split_attention``
  under each SA mode, ``prefill(routing_ctx="head_split")``, the duo
  decode (``decode_step`` / ``decode_core`` with ``fa_heads`` and
  ``duo_layers``, one position and one a row), JAX's own consistency
  property (decode = teacher-forced head-split prefill) and
  ``routing_head_split`` with MLA's ``ValueError``;
- ``ServeEngine.generate`` with the ``xa`` and ``ta`` SA modes and with duo
  overrides: ``chunked_eligible`` False on both engines, identical
  routing and greedy tokens, first logits within 1e-4; deepseek-v2's
  smoke variant under ``xa`` at block 64 (the block-sparse entry at Dk !=
  Dv); the slot-pool drain under ``xa``; the scheduler's and the prefix
  store's duo refusals;
- every ``core/policies.py`` function, ``capture_hidden`` included.

Tolerances: 1e-5 of max |JAX| on attention outputs, 1e-4 on logits (f32,
summation order only). The xa variants keep more than the two forced
blocks a query block (block 16 over 96 tokens keeps 3 of 6; block 64 over
320 tokens keeps 3 of 5, through the expanded selection and the
block-sparse entry); ta's chunk of 40 puts its boundary at 56.
"""
import functools

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
from repro.core import policies as JP  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro.serve import repack_caches as jax_repack  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.core import modes as TM  # noqa: E402
from repro_torch.core import policies as TP  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.serve.engine import (Request, ServeEngine,  # noqa: E402
                                      repack_caches)

ARCH = "phi3-mini-3.8b"
TOL = 1e-4
ATTN_TOL = 1e-5
B, S, N = 2, 96, 6
# SA-mode variants of the smoke config: (sa_mode, flux fields, prompt)
VARIANTS = {
    "ssa": ("ssa", {}, S),
    "xa16": ("xa", dict(threshold=0.5), S),
    "xa64": ("xa", dict(block=64, stride=16, threshold=0.4), 320),
    "ta": ("ta", dict(chunk=40), S),
}
DUO = (("duo", 1), "sa")
MIXED = ("fa", "sa")
GENERATE_CASES = [("xa16", None), ("xa16", MIXED), ("xa64", None),
                  ("ta", None), ("ta", DUO),
                  ("ssa", (("duo", 1), ("duo", 3)))]


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@functools.lru_cache(maxsize=None)
def _models(arch=ARCH, variant="ssa"):
    """(JAX config, port config, JAX params, port params): the same
    weights for every SA mode (the mode adds no parameter)."""
    mode, kw, _ = VARIANTS[variant]
    jcfg = jax_smoke(jax_get_config(arch))
    tcfg = smoke_variant(get_config(arch))
    jcfg = jcfg.replace(flux=jcfg.flux.replace(sa_mode=mode, **kw))
    tcfg = tcfg.replace(flux=tcfg.flux.replace(sa_mode=mode, **kw))
    jparams = JMD.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              "cpu")
    return jcfg, tcfg, jparams, tparams


def _tokens(n, seed=1, batch=B):
    return np.random.default_rng(seed).integers(
        0, 512, size=(batch, n)).astype(np.int32)


# ---------------------------------------------------------------------------
# Head split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["ssa", "xa16", "ta"])
@pytest.mark.parametrize("n_fa_kv", [1, 2])
def test_head_split_attention_matches_jax(variant, n_fa_kv):
    rng = np.random.default_rng(n_fa_kv)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((2, 4, 96, 32), (2, 2, 96, 32), (2, 2, 96, 32)))
    jcfg, tcfg = _models(variant=variant)[:2]
    want = np.asarray(JM.head_split_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), n_fa_kv,
        JM.sa_mode_for(jcfg.flux)))
    got = TM.head_split_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), n_fa_kv,
                                  TM.sa_mode_for(tcfg.flux)).numpy()
    assert float(np.abs(got - want).max()) <= ATTN_TOL * float(
        np.abs(want).max())


@pytest.mark.parametrize("variant", ["ssa", "xa16", "ta"])
def test_prefill_head_split_matches_jax(variant):
    jcfg, tcfg, jparams, tparams = _models(variant=variant)
    toks = _tokens(S)
    jout = JMD.prefill(jparams, jcfg, jnp.asarray(toks),
                       routing_ctx="head_split", head_split_n=2)
    tout = TMD.prefill(tparams, tcfg, torch.from_numpy(toks).long(),
                       routing_ctx="head_split", head_split_n=2)
    assert tout.routing is None and jout.routing is None
    assert float(np.abs(_np(tout.logits) - _np(jout.logits)).max()) < TOL
    # JAX stacks its caches by period position (a period of 1 layer here)
    (jk, jv), = jout.caches
    assert len(tout.caches) == jk.shape[0] == 2
    for i, (tk, tv) in enumerate(tout.caches):
        np.testing.assert_allclose(_np(tk), _np(jk)[i], atol=TOL)
        np.testing.assert_allclose(_np(tv), _np(jv)[i], atol=TOL)


@pytest.mark.parametrize("per_row", [False, True])
def test_duo_decode_matches_jax(per_row):
    """A duo pattern's decode over full caches: logits after each of N
    steps within 1e-4 of JAX's, one position shared or one a row."""
    jcfg, tcfg, jparams, tparams = _models()
    toks = _tokens(S + N)
    pattern = (("duo", 1), ("duo", 3))
    full = ("fa", "fa")
    jpf = JMD.prefill(jparams, jcfg, jnp.asarray(toks[:, :S]),
                      routing_ctx="fixed",
                      fixed_pattern=jnp.ones((2,), jnp.int32))
    tpf = TMD.prefill(tparams, tcfg, torch.from_numpy(toks[:, :S]).long(),
                      routing_ctx="fixed", fixed_pattern=[1, 1])
    jc = jax_repack(jcfg, jpf.caches, full, S, S + N)
    tc = repack_caches(tcfg, tpf.caches, full, S, S + N)
    fa_heads, duo = JMD.routing_head_split(jcfg, pattern)
    t_heads, t_duo = TMD.routing_head_split(tcfg, pattern)
    assert t_duo == duo and list(t_heads) == np.asarray(fa_heads).tolist()
    for i in range(N):
        if per_row:
            jpos = jnp.full((B,), S + i, jnp.int32)
            tpos = torch.full((B,), S + i, dtype=torch.int32)
            jl, jc = JMD.decode_core(jparams, jcfg,
                                     jnp.asarray(toks[:, S + i:S + i + 1]),
                                     jc, jpos, fa_heads=fa_heads,
                                     duo_layers=duo)
            tl, tc = TMD.decode_core(
                tparams, tcfg, torch.from_numpy(toks[:, S + i:S + i + 1])
                .long(), tc, tpos, fa_heads=t_heads, duo_layers=t_duo)
        else:
            jl, jc = JMD.decode_step(jparams, jcfg,
                                     jnp.asarray(toks[:, S + i:S + i + 1]),
                                     jc, pattern, jnp.int32(S + i))
            tl, tc = TMD.decode_step(
                tparams, tcfg, torch.from_numpy(toks[:, S + i:S + i + 1])
                .long(), tc, pattern, S + i)
        assert float(np.abs(_np(tl) - _np(jl)).max()) < TOL, i


def test_duo_headsplit_decode_consistency():
    """JAX's property (``tests/test_serve.py::
    test_duo_headsplit_decode_consistency``) in the port, on stablelm's
    smoke config (G = 2): a head-split prefill of S tokens decoded N
    steps with the duo pattern equals the head-split prefill of S + N."""
    cfg = smoke_variant(get_config("stablelm-12b"))
    params = TMD.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(_tokens(S + N, seed=3)).long()
    n_fa = 1
    pf = TMD.prefill(params, cfg, toks[:, :S], routing_ctx="head_split",
                     head_split_n=n_fa)
    pattern = tuple(("duo", n_fa) if k == "attn" else None
                    for k in cfg.layer_kinds)
    full = tuple("fa" if k == "attn" else None for k in cfg.layer_kinds)
    caches = repack_caches(cfg, pf.caches, full, S, S + N)
    logits = pf.logits
    for i in range(N):
        logits, caches = TMD.decode_step(params, cfg,
                                         toks[:, S + i:S + i + 1], caches,
                                         pattern, S + i)
    ref = TMD.prefill(params, cfg, toks, routing_ctx="head_split",
                      head_split_n=n_fa).logits
    scale = float(ref.abs().max()) + 1e-6
    assert float((logits - ref).abs().max()) / scale < 1e-4


def test_routing_head_split_matches_jax():
    jcfg, tcfg = _models()[:2]
    for pattern in (("fa", "sa"), (("duo", 2), "sa"), (("duo", 1),
                                                       ("duo", 4))):
        jh, jd = JMD.routing_head_split(jcfg, pattern)
        th, td = TMD.routing_head_split(tcfg, pattern)
        assert td == jd
        assert (th is None and jh is None) or \
            list(th) == np.asarray(jh).tolist()
    jmla = jax_smoke(jax_get_config("deepseek-v2-236b"))
    tmla = smoke_variant(get_config("deepseek-v2-236b"))
    for fn, cfg in ((JMD.routing_head_split, jmla),
                    (TMD.routing_head_split, tmla)):
        with pytest.raises(ValueError, match="MLA shares one latent"):
            fn(cfg, (("duo", 1), "fa"))
        assert fn(cfg, ("fa", "sa")) == (None, None)


# ---------------------------------------------------------------------------
# The engine: xa / ta modes and duo overrides on the repack path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs():
    """One JAX engine a variant: generate and the first logits of each
    case."""
    out, engines = {}, {}
    for variant, ov in GENERATE_CASES:
        jcfg, _, jparams, _ = _models(variant=variant)
        n = VARIANTS[variant][2]
        if variant not in engines:
            engines[variant] = JaxEngine(jparams, jcfg, max_len=n + 32)
        eng = engines[variant]
        toks = _tokens(n)
        gen = eng.generate(toks, N, routing_override=ov)
        logits = eng.prefill_route_repack(jnp.asarray(toks), ov)[0].logits
        out[variant, ov] = (gen, np.asarray(logits),
                            eng.chunked_eligible(n, ov))
    return out


@pytest.mark.parametrize("case", GENERATE_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_generate_matches_jax(jax_runs, case):
    variant, ov = case
    jgen, jlogits, jeligible = jax_runs[case]
    _, tcfg, _, tparams = _models(variant=variant)
    n = VARIANTS[variant][2]
    eng = ServeEngine(tparams, tcfg, max_len=n + 32, device="cpu")
    assert eng.chunked_eligible(n, ov) is jeligible is False
    gen = eng.generate(_tokens(n), N, routing_override=ov)
    if ov is None:
        assert np.all(np.abs(jgen.p_fa - 0.5) > 1e-3), jgen.p_fa
        np.testing.assert_allclose(gen.p_fa, jgen.p_fa, atol=1e-5)
    assert gen.routing == jgen.routing
    assert gen.msr == jgen.msr and gen.kv_bytes == jgen.kv_bytes
    assert np.array_equal(gen.tokens, np.asarray(jgen.tokens))
    assert float(np.abs(gen.logits.numpy() - jlogits).max()) < TOL


def test_deepseek_xa_generate_matches_jax():
    """MLA under xa at block 64 (deepseek-v2's smoke variant, every layer
    SA over 320 tokens): the route chunk's block-sparse call runs at
    (Dk, Dv) = (48, 32), values narrower than queries and keys, through
    the expanded selection and the block-sparse entry; tokens, routing
    and first logits equal JAX's."""
    jcfg, tcfg, jparams, tparams = _models("deepseek-v2-236b", "xa64")
    n, ov = VARIANTS["xa64"][2], ("sa",) * tcfg.num_layers
    assert tcfg.qk_nope_head_dim + tcfg.qk_rope_head_dim != tcfg.v_head_dim
    toks = _tokens(n)
    jeng = JaxEngine(jparams, jcfg, max_len=n + 32)
    jgen = jeng.generate(toks, N, routing_override=ov)
    jlogits = jeng.prefill_route_repack(jnp.asarray(toks), ov)[0].logits
    gen = ServeEngine(tparams, tcfg, max_len=n + 32, device="cpu").generate(
        toks, N, routing_override=ov)
    assert gen.routing == jgen.routing == ov
    assert np.array_equal(gen.tokens, np.asarray(jgen.tokens))
    assert float(np.abs(gen.logits.numpy() - np.asarray(jlogits)).max()) \
        < TOL


def test_duo_prefill_runs_full_attention_as_jax(monkeypatch):
    """The reference's behaviour, reproduced: an engine admission maps a
    duo entry to 1 in the "fixed" context, so its prefill runs full
    attention there and only the decode splits the heads."""
    _, tcfg, _, tparams = _models(variant="ssa")
    eng = ServeEngine(tparams, tcfg, max_len=S + 32, device="cpu")
    assert eng._routing_ctx(DUO) == ("fixed", [1, 0])
    seen = []
    real = TM.head_split_attention
    monkeypatch.setattr(TM, "head_split_attention",
                        lambda *a, **kw: seen.append(1) or real(*a, **kw))
    eng.generate(_tokens(S), 2, routing_override=DUO)
    assert not seen


@pytest.fixture(scope="module")
def xa_drains():
    """The same five requests drained by both engines under xa (block
    16), router-driven and mixed, 2 slots a pool, decode chunks of 3."""
    jcfg, tcfg, jparams, tparams = _models(variant="xa16")
    rng = np.random.default_rng(4)
    specs = [(i, rng.integers(0, 512, size=n), (None, MIXED)[i % 2])
             for i, n in enumerate((96, 70, 96, 50, 80))]
    out = []
    for eng, req in ((JaxEngine(jparams, jcfg, max_len=S + 32), JaxRequest),
                     (ServeEngine(tparams, tcfg, max_len=S + 32,
                                  device="cpu"), Request)):
        eng.scheduler(slots_per_bucket=2, chunk=3)
        for rid, toks, ov in specs:
            eng.submit(req(rid=rid, tokens=toks, n_steps=N,
                           routing_override=ov))
        out.append((eng.drain(), eng.scheduler().n_geometries()))
    return specs, out


def test_xa_drain_matches_jax(xa_drains):
    specs, ((jout, jgeo), (tout, tgeo)) = xa_drains
    assert tgeo == jgeo
    for rid, _, _ in specs:
        assert tout[rid].status == jout[rid].status == "ok"
        assert tout[rid].routing == jout[rid].routing, rid
        assert np.array_equal(tout[rid].tokens, jout[rid].tokens), rid


def test_scheduler_refuses_a_duo_pattern_as_jax():
    jcfg, tcfg, jparams, tparams = _models()
    for eng, req in ((JaxEngine(jparams, jcfg, max_len=S + 32), JaxRequest),
                     (ServeEngine(tparams, tcfg, max_len=S + 32,
                                  device="cpu"), Request)):
        eng.submit(req(rid=0, tokens=_tokens(S)[0], n_steps=2,
                       routing_override=DUO))
        with pytest.raises(ValueError, match="serve them via generate"):
            eng.step()


def test_prefix_store_refuses_a_duo_override_as_jax():
    jcfg, tcfg, jparams, tparams = _models()
    for cls, params, cfg, kw in ((JaxEngine, jparams, jcfg, {}),
                                 (ServeEngine, tparams, tcfg,
                                  dict(device="cpu"))):
        with pytest.raises(ValueError, match="duo head-split"):
            cls(params, cfg, max_len=S + 32, prefill_chunk=16,
                prefix_cache_mb=64, routing_override=DUO, **kw)


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------

def test_layer_patterns_match_jax():
    jcfg, tcfg = _models()[:2]
    jbig, tbig = jax_get_config(ARCH), get_config(ARCH)
    for jc, tc in ((jcfg, tcfg), (jbig, tbig)):
        for msr in (0.0, 0.25, 0.5, 0.7, 1.0):
            for placement in ("deep", "shallow", "interleave"):
                assert np.array_equal(
                    TP.static_pattern(tc, msr, placement),
                    JP.static_pattern(jc, msr, placement))
            assert np.array_equal(TP.trianglemix_pattern(tc, msr),
                                  JP.trianglemix_pattern(jc, msr))
            assert TP.duo_n_fa_kv(tc, msr) == JP.duo_n_fa_kv(jc, msr)
            scores = np.random.default_rng(7).normal(size=tc.num_layers)
            assert np.array_equal(TP.entropy_pattern(tc, scores, msr),
                                  JP.entropy_pattern(jc, scores, msr))
    with pytest.raises(ValueError):
        TP.static_pattern(tcfg, 0.5, "middle")


def test_matrix_entropy_matches_jax():
    rng = np.random.default_rng(8)
    for shape, k in (((2, 48, 64), 32), ((1, 20, 96), 32), ((2, 8, 16), 4)):
        h = rng.normal(size=shape).astype(np.float32)
        h[..., : shape[-1] // 2] *= 5.0  # an uneven spectrum
        want = float(JP.matrix_entropy(jnp.asarray(h), k))
        got = float(TP.matrix_entropy(torch.from_numpy(h), k))
        assert abs(got - want) < 1e-5 * max(1.0, abs(want))


def test_capture_hidden_and_entropy_scores_match_jax():
    jcfg, tcfg, jparams, tparams = _models()
    toks = _tokens(48)
    want = np.asarray(JMD.capture_hidden(jparams, jcfg, jnp.asarray(toks)))
    got = TMD.capture_hidden(tparams, tcfg, torch.from_numpy(toks).long())
    assert got.shape == want.shape == (2, B, 48, tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    js = JP.entropy_scores(jparams, jcfg, jnp.asarray(toks))
    ts = TP.entropy_scores(tparams, tcfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(ts, js, rtol=1e-4)
    assert np.array_equal(TP.entropy_pattern(tcfg, ts, 0.5),
                          JP.entropy_pattern(jcfg, js, 0.5))
