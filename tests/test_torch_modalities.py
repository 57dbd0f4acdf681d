"""Modality side inputs: phi-3-vision-4.2b's prefix embeddings and
whisper-tiny's encoder and cross attention, the port against the JAX
package with the same weights (``params_from_jax``), in float32.

Variants, made the same way in both packages: ``phi`` and ``whisper``
are the smoke variants (8 prefix embeddings; 2 encoder layers over 16
frames, 2 decoder layers); ``whisper_d64`` is whisper's smoke variant at
head dim 64 over 75 frames, so the last 64-key tile of the encoder's
and the cross attention's keys is partial.

Held: ``param_count`` (full and smoke configs); the parameter tree
after ``params_from_jax`` (and a native ``init_params``'s keys and
shapes); ``encode``; ``_cross_attention`` (and its one-token decode
form on the batch decode kernel's plain version); ``prefill`` in each
routing context with its side input (logits, routing, p_fa, caches);
``decode_many`` and ``prefill_chunk`` with ``enc_out``;
``capture_hidden`` and ``attention_mass_coverage`` with side inputs;
``generate`` at B = 1 and 2, prompts past the sink + local ring of 40
positions (router-driven, all-fa, all-sa and mixed): tokens, routing,
kv_bytes, dispatches and dispatch_count equal, p_fa within 1e-5; the
max_len errors counting the prefix; the scheduler's, ``publish_prefix``'s
and the missing frames' refusals; and which kernel each attention call
reaches (each module's plain version wrapped).

Tolerance: TOL = 1e-4 absolute on logits, hidden states and caches (as
``test_torch_serve.py``: float32, summation order only), 1e-5 on p_fa
and coverage. A router-driven case first checks that every layer's mean
p_fa is more than 1e-3 from the 0.5 threshold.
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
from repro.models import model as JMD  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro.serve import kv_cache as JKC  # noqa: E402
from repro_torch import kernels as KN  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.serve import kv_cache as TKC  # noqa: E402
from repro_torch.serve.engine import (ServeEngine,  # noqa: E402
                                      repack_caches)

PHI, WHISPER = "phi-3-vision-4.2b", "whisper-tiny"
VARIANTS = {"phi": (PHI, {}), "whisper": (WHISPER, {}),
            "whisper_d64": (WHISPER, dict(head_dim=64, encoder_ctx=75))}
# each variant's prompt seed: its router margins exceed MARGIN at B = 1
# and 2, and its router-driven runs route FA at some layer and SA at
# another
SEEDS = {"phi": 2, "whisper": 10, "whisper_d64": 8}
WHISPERS = ["whisper", "whisper_d64"]
S, N, MAX_LEN, RING = 48, 6, 64, 40   # RING: the smoke sink + local
TOL, P_TOL, MARGIN = 1e-4, 1e-5, 1e-3
PATTERNS = {"router": None, "all_fa": ("fa", "fa"), "all_sa": ("sa", "sa"),
            "mixed": ("fa", "sa")}
BATCHES = (1, 2)


def t(x):
    return torch.from_numpy(np.array(x))


def err(port, ref):
    return float(np.abs(np.asarray(port) - np.asarray(ref)).max())


def _side(cfg, B, seed):
    """The request's side input, made with numpy from ``seed``: prefix
    embeddings (B, P, d) or encoder frames (B, E, d)."""
    rng = np.random.default_rng(seed + 100)
    if cfg.num_prefix_tokens:
        return {"prefix_embeddings": rng.standard_normal(
            (B, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)}
    return {"encoder_frames": rng.standard_normal(
        (B, cfg.encoder_ctx, cfg.d_model)).astype(np.float32)}


def _prompt_len(cfg):
    """Tokens a prompt holds: prefix + tokens = S positions past the
    ring."""
    return S - cfg.num_prefix_tokens


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, (arch, kw) in VARIANTS.items():
        jcfg = jax_smoke(jax_get_config(arch)).replace(**kw)
        tcfg = smoke_variant(get_config(arch)).replace(**kw)
        jparams = JMD.init_params(jax.random.key(0), jcfg)
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                  "cpu")
        toks = np.random.default_rng(SEEDS[name]).integers(
            0, jcfg.vocab_size, (2, _prompt_len(jcfg))).astype(np.int32)
        out[name] = (jcfg, tcfg, jparams, tparams, toks,
                     _side(jcfg, 2, SEEDS[name]))
    return out


def _jside(side):
    return {k: jnp.asarray(v) for k, v in side.items()}


def _tside(side):
    return {k: t(v) for k, v in side.items()}


@pytest.fixture(scope="module")
def jax_runs(models):
    """JAX ``generate`` of every variant, batch size and pattern, one
    engine a variant (its jit caches shared by the runs), with what each
    run added to the engine's dispatch_count."""
    out = {}
    for name, (jcfg, _, jparams, _, toks, side) in models.items():
        eng = JaxEngine(jparams, jcfg, max_len=MAX_LEN, prefill_chunk=16)
        for B in BATCHES:
            for pat, ov in PATTERNS.items():
                sb = {k: v[:B] for k, v in side.items()}
                before = eng.dispatch_count
                gen = eng.generate(toks[:B], N, routing_override=ov,
                                   **_jside(sb))
                out[name, B, pat] = (gen, eng.dispatch_count - before)
    return out


# ---------------------------------------------------------------------------
# Configs and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [PHI, WHISPER])
def test_param_count_matches_jax(arch):
    for jcfg, tcfg in ((jax_get_config(arch), get_config(arch)),
                       (jax_smoke(jax_get_config(arch)),
                        smoke_variant(get_config(arch)))):
        assert tcfg.param_count() == jcfg.param_count()
    if arch == WHISPER:  # the encoder and the cross attention counted
        cfg = get_config(arch)
        decoder_only = cfg.replace(num_encoder_layers=0).param_count()
        assert cfg.param_count() - decoder_only == (
            4 * (4 * 384 * 384 + 3 * 384 * 1536 + 2 * 384)
            + 4 * (4 * 384 * 384 + 384))


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    return {prefix: tuple(np.asarray(tree).shape)}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_param_tree_matches_jax(models, name):
    """Every decoder layer carries the JAX layer's leaves (norm_x and
    xattn for whisper), the encoder's layers are the JAX stack's slices,
    and a native init has the same keys and shapes."""
    jcfg, tcfg, jparams, tparams, _, _ = models[name]
    jp = jax.tree.map(np.asarray, jparams)
    want = {k: s[1:] for k, s in _shapes(jp["trunk"][0]).items()}
    for i, layer in enumerate(tparams["layers"]):
        assert _shapes(_np(layer)) == want
        assert np.array_equal(layer["norm1"]["scale"].numpy(),
                              jp["trunk"][0]["norm1"]["scale"][i])
    if jcfg.num_encoder_layers:
        assert "xattn" in tparams["layers"][0]
        enc = tparams["encoder"]
        assert len(enc["layers"]) == jcfg.num_encoder_layers
        for i, layer in enumerate(enc["layers"]):
            for k in ("wq", "wk", "wv", "wo"):
                assert np.array_equal(layer["attn"][k].numpy(),
                                      jp["encoder"]["layers"]["attn"][k][i])
    else:
        assert "encoder" not in tparams and "xattn" not in \
            tparams["layers"][0]
    native = TMD.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert _shapes(_np(native)) == _shapes(_np(tparams))


def _np(tree):
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return {str(i): _np(v) for i, v in enumerate(tree)}


# ---------------------------------------------------------------------------
# The encoder and the cross attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", WHISPERS)
def test_encode_matches_jax(models, name):
    jcfg, tcfg, jparams, tparams, _, side = models[name]
    frames = side["encoder_frames"]
    want = np.asarray(JMD.encode(jparams, jcfg, jnp.asarray(frames)))
    got = TMD.encode(tparams, tcfg, t(frames))
    assert got.shape == (2, jcfg.encoder_ctx, jcfg.d_model)
    assert err(got, want) < TOL


@pytest.mark.parametrize("name", WHISPERS)
def test_cross_attention_matches_jax(models, name):
    """At S prompt rows (flash, causal=False) and at one row (the batch
    decode kernel over every encoder key)."""
    jcfg, tcfg, jparams, tparams, _, _ = models[name]
    rng = np.random.default_rng(5)
    enc = rng.standard_normal((2, jcfg.encoder_ctx, jcfg.d_model)
                              ).astype(np.float32)
    jp = jax.tree.map(lambda a: a[1], jparams["trunk"][0]["xattn"])
    tp = tparams["layers"][1]["xattn"]
    for rows in (S, 1):
        h = rng.standard_normal((2, rows, jcfg.d_model)).astype(np.float32)
        want = np.asarray(JMD._cross_attention(jp, jcfg, jnp.asarray(h),
                                               jnp.asarray(enc)))
        got = TMD._cross_attention(tp, tcfg, t(h), t(enc))
        assert err(got, want) < TOL
        if rows == 1:
            pos = torch.arange(jcfg.encoder_ctx, dtype=torch.int32)
            got = TMD._cross_attention(tp, tcfg, t(h), t(enc), pos)
            assert err(got, want) < TOL


# ---------------------------------------------------------------------------
# prefill, decode_many, prefill_chunk, capture_hidden, the probe
# ---------------------------------------------------------------------------

CONTEXTS = [("hard_prefix", None), ("hard", None), ("fixed", (1, 0)),
            ("fa_only", None)]


@pytest.mark.parametrize("ctx,fixed", CONTEXTS)
@pytest.mark.parametrize("name", list(VARIANTS))
def test_prefill_matches_jax(models, name, ctx, fixed):
    jcfg, tcfg, jparams, tparams, toks, side = models[name]
    jf = JMD.prefill(jparams, jcfg, jnp.asarray(toks), routing_ctx=ctx,
                     fixed_pattern=None if fixed is None
                     else jnp.asarray(fixed), **_jside(side))
    tf = TMD.prefill(tparams, tcfg, t(toks), routing_ctx=ctx,
                     fixed_pattern=fixed, **_tside(side))
    assert err(tf.logits, jf.logits) < TOL
    jk, jv = jf.caches[0]  # period position 0, stacked over layers
    for i, (k, v) in enumerate(tf.caches):
        assert k.shape[2] == S  # the prefix's positions are cached too
        assert err(k, jk[i]) < TOL and err(v, jv[i]) < TOL
    if ctx == "fa_only":
        assert tf.routing is None and jf.routing is None
        return
    assert np.array_equal(tf.routing.numpy(), np.asarray(jf.routing))
    assert err(tf.p_fa, jf.p_fa) < P_TOL


def _repacked(models, name, pattern):
    """Both packages' decode caches of a fixed-routing prefill of the
    whole prompt, repacked into ``pattern``'s geometry."""
    jcfg, tcfg, jparams, tparams, toks, side = models[name]
    fixed = [1 if p == "fa" else 0 for p in pattern]
    jf = JMD.prefill(jparams, jcfg, jnp.asarray(toks), routing_ctx="fixed",
                     fixed_pattern=jnp.asarray(fixed), **_jside(side))
    tf = TMD.prefill(tparams, tcfg, t(toks), routing_ctx="fixed",
                     fixed_pattern=fixed, **_tside(side))
    from repro.serve.engine import repack_caches as jax_repack
    jc = jax_repack(jcfg, jf.caches, pattern, S, MAX_LEN)
    tc = repack_caches(tcfg, tf.caches, pattern, S, MAX_LEN)
    return jf, tf, jc, tc


def _same_caches(tc, jc):
    assert TKC.cache_geometry(tc) == JKC.cache_geometry(jc)
    for a, b in zip(tc, jc):
        assert err(a.k, b.k) < TOL and err(a.v, b.v) < TOL
        assert np.array_equal(a.length.numpy(), np.asarray(b.length))
        if isinstance(a, TKC.RingKV):
            assert np.array_equal(a.positions.numpy(),
                                  np.asarray(b.positions))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_decode_many_with_enc_out_matches_jax(models, name):
    """N greedy steps from position P + S over a FullKV and a wrapping
    ring, with whisper's cross attention over ``enc_out`` every step."""
    jcfg, tcfg, jparams, tparams, _, side = models[name]
    jf, tf, jc, tc = _repacked(models, name, ("fa", "sa"))
    j_enc = t_enc = None
    if jcfg.num_encoder_layers:
        j_enc = JMD.encode(jparams, jcfg, jnp.asarray(
            side["encoder_frames"]))
        t_enc = TMD.encode(tparams, tcfg, t(side["encoder_frames"]))
    jt, jl, jc = JMD.decode_many(jparams, jcfg, jf.logits, jc, jnp.int32(S),
                                 jax.random.key(0), n_steps=N,
                                 enc_out=j_enc)
    tt, tl, tc = TMD.decode_many(tparams, tcfg, tf.logits, tc, S,
                                 n_steps=N, enc_out=t_enc)
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    assert err(tl, jl) < TOL
    _same_caches(tc, jc)


@pytest.mark.parametrize("name", WHISPERS)
def test_prefill_chunk_with_enc_out_matches_jax(models, name):
    """Three 16-token chunks streamed into a FullKV and a ring (the last
    past the ring's 40), each decoder layer attending ``enc_out``."""
    jcfg, tcfg, jparams, tparams, toks, side = models[name]
    pattern = ("fa", "sa")
    jc = JKC.init_decode_caches(jcfg, pattern, 2, MAX_LEN)
    tc = TKC.init_decode_caches(tcfg, pattern, 2, MAX_LEN, "cpu")
    j_enc = JMD.encode(jparams, jcfg, jnp.asarray(side["encoder_frames"]))
    t_enc = TMD.encode(tparams, tcfg, t(side["encoder_frames"]))
    j_chunk = jax.jit(JMD.prefill_chunk, static_argnames=("cfg",))
    for start in (0, 16, 32):
        chunk = toks[:, start:start + 16]
        jl, jc = j_chunk(jparams, jcfg, jnp.asarray(chunk), jc,
                         jnp.int32(start), enc_out=j_enc)
        tl, tc = TMD.prefill_chunk(tparams, tcfg, t(chunk), tc, start,
                                   enc_out=t_enc)
        assert err(tl, jl) < TOL
        _same_caches(tc, jc)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_capture_hidden_and_coverage_match_jax(models, name):
    jcfg, tcfg, jparams, tparams, toks, side = models[name]
    jh = JMD.capture_hidden(jparams, jcfg, jnp.asarray(toks),
                            **_jside(side))
    th = TMD.capture_hidden(tparams, tcfg, t(toks), **_tside(side))
    assert th.shape == (jcfg.num_layers, 2, S, jcfg.d_model)
    assert err(th, jh) < TOL
    b1 = {k: v[:1] for k, v in side.items()}
    jcov = JMD.attention_mass_coverage(jparams, jcfg, jnp.asarray(toks[:1]),
                                       **_jside(b1))
    tcov = TMD.attention_mass_coverage(tparams, tcfg, t(toks[:1]),
                                       **_tside(b1))
    assert tcov.shape == (jcfg.num_layers,)
    assert err(tcov, jcov) < P_TOL


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pat", list(PATTERNS))
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("name", list(VARIANTS))
def test_generate_matches_jax(models, jax_runs, name, B, pat):
    _, tcfg, _, tparams, toks, side = models[name]
    jgen, j_count = jax_runs[name, B, pat]
    eng = ServeEngine(tparams, tcfg, max_len=MAX_LEN, prefill_chunk=16,
                      device="cpu")
    sb = {k: v[:B] for k, v in side.items()}
    gen = eng.generate(toks[:B], N, routing_override=PATTERNS[pat], **sb)
    if pat == "router":
        assert np.all(np.abs(jgen.p_fa - 0.5) > MARGIN), jgen.p_fa
        assert err(gen.p_fa, jgen.p_fa) < P_TOL
    assert gen.routing == jgen.routing
    assert gen.msr == jgen.msr and gen.kv_bytes == jgen.kv_bytes
    assert np.array_equal(gen.tokens, np.asarray(jgen.tokens))
    # the encode (whisper), the prefill, the repack and the decode
    assert gen.dispatches == jgen.dispatches == j_count
    assert eng.dispatch_count == j_count == 3 + bool(
        tcfg.num_encoder_layers)


def test_router_drives_a_mixed_pattern(jax_runs):
    """Across the variants the router picks FA and SA, so the router
    cases run both prefill kernels."""
    seen = {p for name in VARIANTS for B in BATCHES
            for p in jax_runs[name, B, "router"][0].routing}
    assert seen == {"fa", "sa"}


def test_max_len_counts_the_prefix(models):
    """A prompt whose tokens fit but whose prefix + tokens do not is
    refused, and so is one whose prefix + tokens + new tokens overflow a
    full-cache layer, in both engines."""
    jcfg, tcfg, jparams, tparams, toks, side = models["phi"]
    P = jcfg.num_prefix_tokens
    long = np.zeros((1, MAX_LEN - P + 1), np.int32)  # P + S = MAX_LEN + 1
    pre = {k: v[:1] for k, v in side.items()}
    jeng = JaxEngine(jparams, jcfg, max_len=MAX_LEN, prefill_chunk=16)
    teng = ServeEngine(tparams, tcfg, max_len=MAX_LEN, prefill_chunk=16,
                       device="cpu")
    for eng, sb in ((jeng, _jside(pre)), (teng, pre)):
        with pytest.raises(ValueError, match="max_len"):
            eng.generate(long, 1, **sb)
        with pytest.raises(ValueError, match="max_len"):
            eng.prefill_route_repack(long, ("fa", "fa"), **sb)
        with pytest.raises(ValueError, match="max_len"):  # 48 + 17 > 64
            eng.generate(toks[:1], MAX_LEN - S + 1,
                         routing_override=("fa", "fa"), **sb)
    # the tokens alone fit: without the prefix nothing is refused
    teng.generate(long[:, :MAX_LEN - 1], 1)


@pytest.mark.parametrize("name", ["phi", "whisper"])
def test_side_input_configs_refuse_the_slot_pool_and_prefix_store(models,
                                                                  name):
    _, tcfg, _, tparams, toks, side = models[name]
    eng = ServeEngine(tparams, tcfg, max_len=MAX_LEN, prefill_chunk=16,
                      prefix_cache_mb=1, device="cpu")
    with pytest.raises(ValueError, match="decoder-only"):
        eng.scheduler()
    assert not eng.chunked_eligible(S)
    assert not eng.chunked_eligible(
        S, **{k: v[:1] for k, v in side.items()})
    with pytest.raises(ValueError, match="monolithic"):
        eng.publish_prefix(toks[0, :16], 16, None, None, ("fa", "fa"))
    assert eng.prefix_store.stats().inserts == 0


def test_missing_encoder_frames_raise(models):
    """JAX fails inside its ``encode(None)``; the port raises a
    ValueError that names encoder_frames, from the engine and from the
    model's prefill."""
    _, tcfg, _, tparams, toks, _ = models["whisper"]
    eng = ServeEngine(tparams, tcfg, max_len=MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="encoder_frames"):
        eng.generate(toks, N)
    with pytest.raises(ValueError, match="encoder_frames"):
        TMD.prefill(tparams, tcfg, t(toks))
    assert eng.dispatch_count == 0


def _counting_plains(monkeypatch):
    """Each kernel's plain-version calls, by kernel name: flash's split
    by its ``causal`` argument, the batch decode's by its key count."""
    calls = []
    for name in KN.KERNELS:
        mod = getattr(KN, name)
        plain = getattr(mod, f"{name}_plain")

        def counted(*a, _plain=plain, _name=name, **kw):
            key = _name
            if _name == "flash_attention":
                key = f"flash causal={kw.get('causal', True)}"
            elif _name == "decode_attention":
                key = f"decode L={a[1].shape[1]}"
            calls.append(key)
            return _plain(*a, **kw)
        monkeypatch.setattr(mod, f"{name}_plain", counted)
    return calls


@pytest.mark.parametrize("name", list(VARIANTS))
def test_kernel_calls_with_side_inputs(models, monkeypatch, name):
    """Mixed routing ("fa", "sa"): the encoder runs flash with
    causal=False once a layer; the prefill runs flash (causal) at the FA
    layer, streaming at the SA layer and, for whisper, flash with
    causal=False once a decoder layer (the cross attention); each decode
    step runs the batch decode kernel once a layer for self attention
    (over the FullKV's MAX_LEN or the ring's 40 slots) and once a layer
    over the E encoder keys. Nothing reaches block-sparse or the pooled
    decode."""
    jcfg, tcfg, _, tparams, toks, side = models[name]
    calls = _counting_plains(monkeypatch)
    eng = ServeEngine(tparams, tcfg, max_len=MAX_LEN, prefill_chunk=16,
                      device="cpu")
    eng.generate(toks, N, routing_override=("fa", "sa"), **side)
    L, E = jcfg.num_layers, jcfg.num_encoder_layers
    want = {"flash causal=True": 1, "streaming_attention": 1,
            f"decode L={MAX_LEN}": N, f"decode L={RING}": N}
    if E:
        want["flash causal=False"] = E + L
        want[f"decode L={jcfg.encoder_ctx}"] = N * L
    counts = {k: calls.count(k) for k in set(calls)}
    assert counts == want, counts
