"""The port's Multi-head Latent Attention (deepseek-v2-236b) against the
JAX package's, with the same weights (``params_from_jax``), in float32,
on two variants made the same way in both packages:

- ``smoke``: ``smoke_variant`` of deepseek-v2-236b (2 layers, d_model
  256, 4 heads, 4 experts top-2 and 1 shared), whose latent widths
  (R 32, rope 16, nope 32, v 32) make nope + rope = R + rope, so a
  dropped decode scale or a swapped R / v would not show;
- ``wide``: the smoke variant with deepseek's real per-head widths
  (q_lora 1536, kv_lora 512, nope 128, rope 64, v 128): R != nope, the
  decode scale (nope + rope) ** -0.5 = 192 ** -0.5 is not Dk ** -0.5 =
  576 ** -0.5, and every width differs from every other.

Held: each ``mla_*`` function against its JAX twin; the latent inserts
bitwise (a per-row write past the capacity dropped, a ring that wraps);
the latent decode entry (plain version) against the Pallas pooled kernel
in interpret mode on ``mla_absorbed_qkv``'s operands at 2e-5; the route
chunk's flash and streaming plain versions at Dk != Dv against
``repro.core.modes.attention``; ``generate`` (chunks of 16 and the
monolithic repack, router-driven with the 1e-3 margin and mixed) and a
slot-pool drain: identical routing and greedy tokens, first logits
within 1e-4, equal cache geometries; a prefix-store hit warm = cold
bitwise with the JAX engine's store stats; ``attention_mass_coverage``;
and the CUDA entries' instance checks before any launch.
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
from repro.kernels.decode_attention import \
    decode_attention_pooled_bh as jax_pooled  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro.serve import kv_cache as JKC  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.kernels.decode_attention_mla import \
    decode_attention_mla_bh  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention_bh  # noqa: E402
from repro_torch.kernels.streaming_attention import \
    streaming_attention_bh  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.serve import kv_cache as TKC  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.scheduler import STATUS_OK  # noqa: E402

ARCH = "deepseek-v2-236b"
B, S, N, MAX_LEN = 2, 48, 6, 64
TOL = 1e-4
FN_TOL = 2e-5
MARGIN = 1e-3
CHUNKS = [16, None]
MIXED = ("fa", "sa")
WIDE = dict(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
            qk_rope_head_dim=64, v_head_dim=128)
VARIANTS = {"smoke": {}, "wide": WIDE}
DRAIN_LENS = (20, 28, 28, 20)


def _configs(name):
    return (jax_smoke(jax_get_config(ARCH)).replace(**VARIANTS[name]),
            smoke_variant(get_config(ARCH)).replace(**VARIANTS[name]))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@functools.lru_cache(maxsize=None)
def _models(name):
    """(name, JAX config, port config, JAX params, port params, prompts)."""
    jcfg, tcfg = _configs(name)
    jparams = JMD.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              "cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                             size=(B, S)).astype(np.int32)
    return name, jcfg, tcfg, jparams, tparams, toks


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant(request):
    return _models(request.param)


# ---------------------------------------------------------------------------
# Config, init and bridge
# ---------------------------------------------------------------------------

def test_config_and_param_count_match_jax():
    """The registered config and both variants carry the JAX package's
    widths, and ``param_count`` counts MLA layers as JAX does."""
    full_j, full_t = jax_get_config(ARCH), get_config(ARCH)
    keys = ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
            "vocab_size", "moe_layers", "num_experts", "num_shared_experts",
            "top_k", "moe_d_ff", "use_mla", "q_lora_rank", "kv_lora_rank",
            "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim",
            "rope_theta")
    for jcfg, tcfg in [(full_j, full_t)] + [_configs(n) for n in VARIANTS]:
        for key in keys:
            assert getattr(jcfg, key) == getattr(tcfg, key), key
        for active in (False, True):
            assert tcfg.param_count(active) == jcfg.param_count(active)
    assert TMD.router_in_dim(full_t) == JMD.router_in_dim(full_j) == 24576


def test_init_carries_every_leaf_of_the_jax_pytree(variant):
    """The port's own init has the JAX pytree's leaves, shapes and dtypes
    (so ``params_from_jax`` carries every one), the router reads
    H·(nope + rope), and the bridge copies every MLA weight bit for
    bit."""
    _, jcfg, tcfg, jparams, tparams, _ = variant
    own = TMD.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")

    def leaves(tree, prefix=()):
        if isinstance(tree, torch.Tensor):
            return {prefix: (tuple(tree.shape), tree.dtype)}
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(leaves(v, prefix + (k,)))
        return out
    assert leaves(own) == leaves(tparams)
    assert own["layers"][0]["router"]["enc_w"].shape[0] == \
        2 * TMD.router_in_dim(tcfg)
    for i, layer in enumerate(tparams["layers"]):
        for key, w in layer["attn"].items():
            want = jparams["trunk"][0]["attn"][key]
            want = (want["scale"] if isinstance(w, dict) else want)[i]
            got = w["scale"] if isinstance(w, dict) else w
            np.testing.assert_array_equal(_np(got), np.asarray(want))


# ---------------------------------------------------------------------------
# The MLA functions against their JAX twins
# ---------------------------------------------------------------------------

def _mla_inputs(jcfg, seed=3, Sq=5, S_cache=23):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, Sq, jcfg.d_model)).astype(np.float32)
    pos = np.arange(7, 7 + Sq, dtype=np.int32)
    ckv = rng.normal(size=(B, S_cache, jcfg.kv_lora_rank)).astype(np.float32)
    kr = rng.normal(size=(B, 1, S_cache, jcfg.qk_rope_head_dim)
                    ).astype(np.float32)
    valid = rng.random((B, Sq, S_cache)) < 0.7
    valid[:, :, 0] = True
    attn = rng.normal(size=(B, jcfg.num_heads, Sq, jcfg.v_head_dim)
                      ).astype(np.float32)
    ctx = rng.normal(size=(B, jcfg.num_heads, 1, jcfg.kv_lora_rank)
                     ).astype(np.float32)
    return x, pos, ckv, kr, valid, attn, ctx


MLA_FNS = ("mla_latent", "mla_q", "mla_expand_kv", "mla_out",
           "mla_absorbed_attend", "mla_absorbed_decode", "mla_absorbed_qkv",
           "mla_absorbed_finish")


@pytest.mark.parametrize("fn", MLA_FNS)
def test_mla_function_matches_jax(variant, fn):
    _, jcfg, tcfg, jparams, tparams, _ = variant
    jp = jax.tree.map(lambda a: a[0], jparams["trunk"][0]["attn"])
    tp = tparams["layers"][0]["attn"]
    x, pos, ckv, kr, valid, attn, ctx = _mla_inputs(jcfg)
    t = torch.as_tensor
    args = {
        "mla_latent": ((x, pos), (t(x), t(pos))),
        "mla_q": ((x, pos), (t(x), t(pos))),
        "mla_expand_kv": ((ckv, kr), (t(ckv), t(kr))),
        "mla_out": ((attn,), (t(attn),)),
        "mla_absorbed_attend": ((x, pos, ckv, kr, valid),
                                (t(x), t(pos), t(ckv), t(kr), t(valid))),
        "mla_absorbed_decode": (
            (x[:, :1], pos[:1], ckv, kr, valid[:, 0]),
            (t(x[:, :1]), t(pos[:1]), t(ckv), t(kr), t(valid[:, 0]))),
        "mla_absorbed_qkv": ((x[:, :1], pos[:1], ckv, kr),
                             (t(x[:, :1]), t(pos[:1]), t(ckv), t(kr))),
        "mla_absorbed_finish": ((ctx,), (t(ctx),)),
    }[fn]
    want = getattr(JA, fn)(jp, jcfg, *(jnp.asarray(a) for a in args[0]))
    got = getattr(TA, fn)(tp, tcfg, *args[1])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, float):  # the absorbed decode's scale
            assert g == w == (tcfg.qk_nope_head_dim
                              + tcfg.qk_rope_head_dim) ** -0.5
            continue
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0,
                                   atol=FN_TOL * max(1, float(
                                       np.abs(np.asarray(w)).max())))


# ---------------------------------------------------------------------------
# Latent caches
# ---------------------------------------------------------------------------

def _pair(cfg, kind, batch, L, rng):
    """The same random latent cache in both packages (JAX, port)."""
    R, rope = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    ckv = rng.normal(size=(batch, L, R)).astype(np.float32)
    kr = rng.normal(size=(batch, 1, L, rope)).astype(np.float32)
    length = rng.integers(0, L, batch).astype(np.int32)
    if kind == "ring":
        positions = rng.integers(-1, 3 * L, (batch, L)).astype(np.int32)
        return (JKC.RingLatentKV(jnp.asarray(ckv), jnp.asarray(kr),
                                 jnp.asarray(positions), jnp.asarray(length)),
                TKC.RingLatentKV(torch.tensor(ckv), torch.tensor(kr),
                                 torch.tensor(positions),
                                 torch.tensor(length)))
    return (JKC.LatentKV(jnp.asarray(ckv), jnp.asarray(kr),
                         jnp.asarray(length)),
            TKC.LatentKV(torch.tensor(ckv), torch.tensor(kr),
                         torch.tensor(length)))


def _same_cache(jc, tc):
    jl = jax.tree.leaves(jc)
    tl = TKC.cache_fields(tc)
    assert type(jc).__name__ == type(tc).__name__ and len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), _np(b))


@pytest.mark.parametrize("case", ["full_int", "full_rows_past_capacity",
                                  "ring_int", "ring_rows", "full_chunk",
                                  "ring_chunk_wraps"])
def test_latent_inserts_match_jax(case):
    """Bitwise against the JAX inserts: a per-row write at or past the
    capacity keeps the row's buffers (JAX's scatter drops it), and a
    chunk longer than the ring's local part wraps onto itself."""
    cfg = _configs("smoke")[1]
    rng = np.random.default_rng(len(case))
    L, Bc, sink, local = 12, 3, 2, 10
    kind = "ring" if case.startswith("ring") else "full"
    jc, tc = _pair(cfg, kind, Bc, L, rng)
    C = 15 if case.endswith("chunk_wraps") else (
        5 if case.endswith("chunk") else 1)
    ckv = rng.normal(size=(Bc, C, cfg.kv_lora_rank)).astype(np.float32)
    kr = rng.normal(size=(Bc, 1, C, cfg.qk_rope_head_dim)).astype(np.float32)
    jn, tn = (jnp.asarray(ckv), jnp.asarray(kr)), \
        (torch.tensor(ckv), torch.tensor(kr))
    if case == "full_int":
        jc = JKC.latent_insert(jc, *jn, jnp.int32(7))
        tc = TKC.latent_insert(tc, *tn, 7)
        with pytest.raises(IndexError):
            TKC.latent_insert(tc, *tn, L)
    elif case == "full_rows_past_capacity":
        pos = np.array([3, L, L + 4], np.int32)
        jc = JKC.latent_insert(jc, *jn, jnp.asarray(pos))
        tc = TKC.latent_insert(tc, *tn, torch.tensor(pos))
    elif case == "ring_int":
        jc = JKC.ring_latent_insert(jc, *jn, jnp.int32(17), sink, local)
        tc = TKC.ring_latent_insert(tc, *tn, 17, sink, local)
    elif case == "ring_rows":
        pos = np.array([0, 5, 23], np.int32)
        jc = JKC.ring_latent_insert(jc, *jn, jnp.asarray(pos), sink, local)
        tc = TKC.ring_latent_insert(tc, *tn, torch.tensor(pos), sink,
                                    local)
    elif case == "full_chunk":
        jc = JKC.latent_insert_chunk(jc, *jn, jnp.int32(4))
        tc = TKC.latent_insert_chunk(tc, *tn, 4)
        with pytest.raises(IndexError):
            TKC.latent_insert_chunk(tc, *tn, L - 2)
    else:
        jc = JKC.ring_latent_insert_chunk(jc, *jn, jnp.int32(3), sink,
                                          local)
        tc = TKC.ring_latent_insert_chunk(tc, *tn, 3, sink, local)
    _same_cache(jc, tc)


@pytest.mark.parametrize("mode", ["fa", "sa"])
def test_latent_cache_geometry_and_bytes_match_jax(variant, mode):
    _, jcfg, tcfg, *_ = variant
    jc = JKC.init_decode_caches(jcfg, (mode,) * jcfg.num_layers, 3, 50)
    tc = TKC.init_decode_caches(tcfg, (mode,) * tcfg.num_layers, 3, 50,
                                "cpu")
    assert TKC.cache_geometry(tc) == JKC.cache_geometry(jc)
    assert TKC.slot_geometry(tc) == JKC.slot_geometry(jc)
    payload = sum(c.ckv.nbytes + c.kr.nbytes for c in tc)
    assert TKC.kv_cache_bytes(tc) == payload
    assert TKC.capacity(tc[0]) == (TKC.sa_ring(tcfg.flux, 50)[0]
                                   if mode == "sa" else 50)


# ---------------------------------------------------------------------------
# The latent decode entry against the Pallas pooled kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["full", "ring_with_holes"])
def test_decode_entry_matches_pallas(variant, layout):
    """``decode_attention_mla_bh`` (its plain version on the CPU) against
    the Pallas pooled kernel in interpret mode on ``mla_absorbed_qkv``'s
    q_eff / k_eff / v_eff, ragged lengths, at the scale (nope + rope) **
    -0.5, within 2e-5; the wide variant's scale is not Dk ** -0.5."""
    _, jcfg, tcfg, jparams, tparams, _ = variant
    rng = np.random.default_rng(4)
    L, lengths = 40, np.array([1, 17, 40, 33], np.int32)
    Bp, H = len(lengths), jcfg.num_heads
    jp = jax.tree.map(lambda a: a[0], jparams["trunk"][0]["attn"])
    x = rng.normal(size=(Bp, 1, jcfg.d_model)).astype(np.float32)
    ckv = rng.normal(size=(Bp, L, jcfg.kv_lora_rank)).astype(np.float32)
    kr = rng.normal(size=(Bp, 1, L, jcfg.qk_rope_head_dim)
                    ).astype(np.float32)
    pos_arg = rng.integers(0, 50, (Bp, 1)).astype(np.int32)
    q_eff, k_eff, v_eff, scale = JA.mla_absorbed_qkv(
        jp, jcfg, jnp.asarray(x), jnp.asarray(pos_arg), jnp.asarray(ckv),
        jnp.asarray(kr))
    Dk, R = q_eff.shape[-1], jcfg.kv_lora_rank
    if layout == "full":
        positions = np.broadcast_to(np.arange(L, dtype=np.int32), (Bp, L))
        t_pos = None
    else:
        positions = np.full((Bp, L), -1, np.int32)
        for b, n in enumerate(lengths):
            positions[b, :n] = rng.permutation(3 * L)[:n]
            holes = rng.random(n) < 0.3
            holes[rng.integers(n)] = False
            positions[b, :n][holes] = -1
        t_pos = torch.tensor(positions)
    want = np.asarray(jax_pooled(
        q_eff.reshape(Bp * H, 1, Dk), k_eff.reshape(Bp, L, Dk),
        v_eff.reshape(Bp, L, R), jnp.asarray(positions),
        jnp.asarray(lengths), n_heads=H, scale=scale, block_k=16,
        interpret=True))
    q = TA.mla_absorbed_q(tparams["layers"][0]["attn"], tcfg, torch.tensor(x),
                          torch.tensor(pos_arg))
    got = decode_attention_mla_bh(q.reshape(Bp * H, 1, Dk), torch.tensor(ckv),
                                  torch.tensor(kr[:, 0]), t_pos,
                                  torch.tensor(lengths), n_heads=H,
                                  scale=TA.mla_scale(tcfg))
    assert got.shape == (Bp * H, 1, R)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=FN_TOL)
    if variant[0] == "wide":  # the default Dk ** -0.5 would be wrong
        assert TA.mla_scale(tcfg) != Dk ** -0.5
        off = decode_attention_mla_bh(
            q.reshape(Bp * H, 1, Dk), torch.tensor(ckv),
            torch.tensor(kr[:, 0]), t_pos, torch.tensor(lengths), n_heads=H,
            scale=Dk ** -0.5)
        assert float(np.abs(_np(off) - want).max()) > 100 * FN_TOL


# ---------------------------------------------------------------------------
# The route chunk's prefill kernels at Dk != Dv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["full", "streaming"])
def test_route_chunk_plain_at_split_dims(variant, kind):
    """Flash (causal) and streaming plain versions at (Dk, Dv) = (nope +
    rope, v) against ``repro.core.modes.attention`` on the same q, k, v:
    (48, 32) in the smoke variant, deepseek's (192, 128) in the wide."""
    _, jcfg, tcfg, *_ = variant
    rng = np.random.default_rng(5)
    H, Sq = jcfg.num_heads, 40
    Dk = jcfg.qk_nope_head_dim + jcfg.qk_rope_head_dim
    q = rng.normal(size=(B, H, Sq, Dk)).astype(np.float32)
    k = rng.normal(size=(B, H, Sq, Dk)).astype(np.float32)
    v = rng.normal(size=(B, H, Sq, jcfg.v_head_dim)).astype(np.float32)
    flat = [torch.tensor(a.reshape(B * H, Sq, -1)) for a in (q, k, v)]
    if kind == "full":
        mode = JM.FULL
        got = flash_attention_bh(*flat)
    else:
        mode = JM.AttnMode("streaming", sink=4, local=12)
        got = streaming_attention_bh(*flat, sink=4, local=12)
    want = np.asarray(JM.attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), mode))
    assert got.shape == (B * H, Sq, jcfg.v_head_dim)
    np.testing.assert_allclose(_np(got).reshape(want.shape), want, rtol=0,
                               atol=FN_TOL)


# ---------------------------------------------------------------------------
# Serving: generate, the slot pool, the prefix store, the probe
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs(variant):
    """JAX generate results, first-step logits and decode geometries, one
    engine per chunk size, router-driven and mixed."""
    name, jcfg, _, jparams, _, toks = variant
    out = {}
    for chunk in CHUNKS:
        eng = JaxEngine(jparams, jcfg, max_len=MAX_LEN, prefill_chunk=chunk)
        for ov in (None, MIXED):
            gen = eng.generate(toks, N, routing_override=ov)
            if eng.chunked_eligible(S, ov):
                job = eng.prefill_chunked(jnp.asarray(toks), ov, reuse=False)
                logits, caches = job.logits, job.caches
            else:
                pf, _, caches, _ = eng.prefill_route_repack(
                    jnp.asarray(toks), ov)
                logits = pf.logits
            out[chunk, ov] = (gen, np.asarray(logits),
                              JKC.cache_geometry(caches))
    return out


@pytest.mark.parametrize("override", [None, MIXED], ids=["router", "mixed"])
@pytest.mark.parametrize("chunk", CHUNKS, ids=["chunked", "monolithic"])
def test_generate_matches_jax(variant, jax_runs, chunk, override):
    _, _, tcfg, _, tparams, toks = variant
    jgen, jlogits, jgeom = jax_runs[chunk, override]
    eng = ServeEngine(tparams, tcfg, max_len=MAX_LEN, prefill_chunk=chunk,
                      device="cpu")
    gen = eng.generate(toks, N, routing_override=override)
    if override is None:
        assert np.all(np.abs(jgen.p_fa - 0.5) > MARGIN), jgen.p_fa
        np.testing.assert_allclose(gen.p_fa, jgen.p_fa, atol=1e-5)
    assert gen.routing == jgen.routing
    assert gen.msr == jgen.msr and gen.kv_bytes == jgen.kv_bytes
    assert np.array_equal(gen.tokens, np.asarray(jgen.tokens))
    assert float(np.abs(gen.logits.numpy() - jlogits).max()) < TOL
    if eng.chunked_eligible(S, override):
        caches = eng.prefill_chunked(torch.tensor(toks), override,
                                     reuse=False).caches
    else:
        caches = eng.prefill_route_repack(torch.tensor(toks), override)[2]
    assert TKC.cache_geometry(caches) == jgeom


def test_generate_past_capacity_raises(variant):
    """A latent full cache cannot hold prompt + n_steps past max_len: the
    engine refuses before decoding, as the JAX engine does."""
    _, _, tcfg, _, tparams, toks = variant
    eng = ServeEngine(tparams, tcfg, max_len=S + 2, prefill_chunk=16,
                      device="cpu")
    with pytest.raises(ValueError, match="exceeds the cache capacity"):
        eng.generate(toks, 3, routing_override=("fa", "fa"))


def _drain(engine, specs, req_cls):
    sched = engine.scheduler(slots_per_bucket=2, chunk=4)
    for rid, toks, ov in specs:
        engine.submit(req_cls(rid=rid, tokens=toks, n_steps=5,
                              routing_override=ov))
    return engine.drain(), sched


def test_drain_matches_jax(variant):
    """Four requests of 20 and 28 tokens, router-driven and mixed in turn,
    through 2-slot pools in decode chunks of 4 (the latent decode with a
    (B,) pos): statuses, routing and tokens as JAX's, the same pool
    geometries and the same expressed-cost specs (one latent KV head,
    Dk = R + rope, Dv = R)."""
    _, jcfg, tcfg, jparams, tparams, _ = variant
    rng = np.random.default_rng(2)
    specs = [(i, rng.integers(0, jcfg.vocab_size, n),
              (None, MIXED)[i % 2]) for i, n in enumerate(DRAIN_LENS)]
    jeng = JaxEngine(jparams, jcfg, max_len=MAX_LEN)
    teng = ServeEngine(tparams, tcfg, max_len=MAX_LEN, device="cpu")
    jout, jsched = _drain(jeng, specs, JaxRequest)
    tout, tsched = _drain(teng, specs, Request)
    for rid, *_ in specs:
        assert tout[rid].status == jout[rid].status == STATUS_OK
        assert tout[rid].routing == jout[rid].routing, rid
        assert np.array_equal(tout[rid].tokens, jout[rid].tokens), rid
    jpools = {p.geometry(): p for p in jsched.pools.values()}
    tpools = {p.geometry(): p for p in tsched.pools.values()}
    assert set(tpools) == set(jpools)
    for geom, pool in tpools.items():
        assert teng._pool_layer_specs(pool) == \
            jeng._pool_layer_specs(jpools[geom])
        assert teng._pool_layer_specs(pool)[0][2:5] == (
            1, tcfg.kv_lora_rank + tcfg.qk_rope_head_dim, tcfg.kv_lora_rank)


STORE = dict(prefix_cache_mb=64, prefix_cache_host_mb=64)


def test_prefix_hit_warm_equals_cold():
    """The wide variant's 48-token prompt served cold (publishing its 16-
    and 32-token boundaries), then again from the store: warm tokens and
    first logits bitwise equal to the cold ones, and the store's stats
    after each step equal to the JAX engine's."""
    _, jcfg, tcfg, jparams, tparams, toks = _models("wide")
    p = toks[:1]
    out = {}
    for side, eng in (
            ("jax", JaxEngine(jparams, jcfg, max_len=MAX_LEN,
                              prefill_chunk=16, **STORE)),
            ("port", ServeEngine(tparams, tcfg, max_len=MAX_LEN,
                                 prefill_chunk=16, device="cpu", **STORE))):
        cold = eng.generate(p, N, routing_override=MIXED)
        s1 = eng.prefix_store.stats().as_dict()
        warm = eng.generate(p, N, routing_override=MIXED)
        s2 = eng.prefix_store.stats().as_dict()
        out[side] = (cold, warm, s1, s2)
    (jc, jw, js1, js2), (tc, tw, ts1, ts2) = out["jax"], out["port"]
    assert (ts1, ts2) == (js1, js2)
    assert ts2["hits"] == 1
    assert tw.prefix_hit_tokens == jw.prefix_hit_tokens > 0
    assert np.array_equal(tw.tokens, tc.tokens)
    assert np.array_equal(tw.tokens, np.asarray(jw.tokens))
    assert torch.equal(tw.logits, tc.logits)


def test_coverage_matches_jax(variant):
    """``attention_mass_coverage`` of an MLA model (per-head K of the
    decompressed latent, scale (nope + rope) ** -0.5) against JAX's, on a
    prompt longer than sink + local."""
    _, jcfg, tcfg, jparams, tparams, toks = variant
    L = tcfg.flux.sink + tcfg.flux.local + 9
    prompt = np.random.default_rng(6).integers(0, jcfg.vocab_size,
                                               (1, L)).astype(np.int32)
    want = np.asarray(JMD.attention_mass_coverage(jparams, jcfg,
                                                  jnp.asarray(prompt)))
    got = TMD.attention_mass_coverage(tparams, tcfg, torch.tensor(prompt))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert (got < 1).all()


# ---------------------------------------------------------------------------
# The CUDA entries' instances
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("built", [True, False], ids=["built", "smoke"])
def test_cuda_entries_take_mla_widths(monkeypatch, built):
    """With the device test answering "cuda", flash and streaming launch
    at (Dk, Dv) = (192, 128) and the latent decode at (R, rope) = (512,
    64) with the explicit scale; at the smoke widths ((48, 32), (32, 16))
    each raises before any launch, naming the instances it is built
    for."""
    from repro_torch.kernels import (_build, decode_attention_mla,
                                     flash_attention, streaming_attention)
    mods = (flash_attention, streaming_attention, decode_attention_mla)
    launched = []
    monkeypatch.setattr(_build, "on_cpu", lambda name, t: False)
    for m in mods:
        monkeypatch.setattr(m.KERNEL, "launch",
                            lambda dev, *a, _m=m: launched.append((_m, a)))
    Dk, Dv, R, rope = (192, 128, 512, 64) if built else (48, 32, 32, 16)
    q, k, v = (torch.zeros((8, 64, Dk)), torch.zeros((8, 64, Dk)),
               torch.zeros((8, 64, Dv)))
    calls = [
        lambda: flash_attention.flash_attention_bh(q, k, v),
        lambda: streaming_attention.streaming_attention_bh(
            q, k, v, sink=4, local=8),
        lambda: decode_attention_mla.decode_attention_mla_bh(
            torch.zeros((2 * 8, 1, R + rope)), torch.zeros((2, 300, R)),
            torch.zeros((2, 300, rope)), None,
            torch.tensor([300, 5], dtype=torch.int32), n_heads=8,
            scale=0.125),
    ]
    for call in calls:
        if built:
            out = call()
            assert out.shape[-1] in (Dv, R)
        else:
            with pytest.raises((ValueError, NotImplementedError),
                               match=r"built for|\(192, 128\)"):
                call()
    if not built:
        assert launched == []
        return
    assert [m for m, _ in launched] == list(mods)
    fa = launched[0][1]
    assert fa[8:10] == (192, 128)  # Dk, Dv after q, k, v, o, BH, BHkv, Sq, Skv
    mla = launched[2][1]
    # B, n_heads, L, R, rope, dtype, tiles a range (4 of 64 keys), scale
    assert mla[9:] == (2, 8, 300, 512, 64, 0, 4, 0.125)
    assert all(mla[6:9])  # 300 keys are 2 ranges: fp32 scratch to merge
