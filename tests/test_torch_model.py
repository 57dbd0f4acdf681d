"""Each ported module against its JAX counterpart, on the same weights
(``repro_torch.bridge.params_from_jax``) and the same numpy inputs, at
the phi3-mini smoke size (2 layers, d_model 256, 4 heads, head_dim 32,
float32, sink 8, local 32, pool 8).

Logits tolerance 1e-4 in float32: the two frameworks sum matrix
products in different orders, and the error grows through the layers.
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
from repro.core import router as JR  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro.serve import kv_cache as JKC  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.core import router as TR  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.serve import kv_cache as TKC  # noqa: E402

ARCH = "phi3-mini-3.8b"
TOL = 1e-4
MAX_LEN = 64


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_smoke(jax_get_config(ARCH))
    tcfg = smoke_variant(get_config(ARCH))
    jparams = JMD.init_params(jax.random.key(0), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    tparams = params_from_jax(np_params, tcfg, "cpu")
    return jcfg, tcfg, jparams, np_params, tparams


def t(x):
    return torch.from_numpy(np.array(x))


def close(port, ref, tol=TOL):
    return float(np.abs(np.asarray(port) - np.asarray(ref)).max()) < tol


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# Weight bridge
# ---------------------------------------------------------------------------

def test_bridge_keeps_every_leaf(setup):
    jcfg, tcfg, _, np_params, tparams = setup
    jleaves = jax.tree.leaves(np_params)
    tleaves = jax.tree.leaves(tparams)
    per_layer = len(jax.tree.leaves(np_params["trunk"][0]))
    assert len(jleaves) == len(tleaves) - per_layer * (tcfg.num_layers - 1)
    assert len(tparams["layers"]) == tcfg.num_layers
    for i, layer in enumerate(tparams["layers"]):
        want = jax.tree.map(lambda a: a[i], np_params["trunk"][0])
        for path, a in jax.tree_util.tree_flatten_with_path(want)[0]:
            node = layer
            for p in path:
                node = node[p.key]
            assert tuple(node.shape) == a.shape
            assert np.array_equal(node.numpy(), a)
    for k in ("embed", "out_w"):
        assert np.array_equal(tparams[k].numpy(), np_params[k])


def test_native_init_is_deterministic():
    cfg = smoke_variant(get_config(ARCH))
    a = TMD.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = TMD.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))
    # init scales: 1/sqrt(in) normal projections, 0.02 embedding
    assert abs(float(a["embed"].std()) - 0.02) < 2e-3
    wq = a["layers"][0]["attn"]["wq"]
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 5e-3


# ---------------------------------------------------------------------------
# Layers, attention projections, router
# ---------------------------------------------------------------------------

def test_rms_norm_rope_ffn(setup):
    jcfg, tcfg, _, np_params, tparams = setup
    x = _rand(0, 2, 12, tcfg.d_model)
    scale = {"scale": _rand(1, tcfg.d_model)}
    assert close(TL.rms_norm({"scale": t(scale["scale"])}, t(x)),
                 JL.rms_norm(scale, jnp.asarray(x)), 1e-5)
    xr = _rand(2, 2, 4, 12, 32)
    pos = np.arange(5, 17)
    assert close(TL.apply_rope(t(xr), t(pos), tcfg.rope_theta),
                 JL.apply_rope(jnp.asarray(xr), jnp.asarray(pos),
                               jcfg.rope_theta), 1e-5)
    ffn_t = tparams["layers"][0]["ffn"]
    ffn_j = jax.tree.map(lambda a: a[0], np_params["trunk"][0]["ffn"])
    assert close(TL.ffn_apply(ffn_t, t(x)), JL.ffn_apply(ffn_j, x))


def test_gqa_qkv_and_out(setup):
    jcfg, tcfg, _, np_params, tparams = setup
    x = _rand(3, 2, 12, tcfg.d_model)
    pos = np.arange(12)
    aj = jax.tree.map(lambda a: a[1], np_params["trunk"][0]["attn"])
    at = tparams["layers"][1]["attn"]
    for got, want in zip(TA.gqa_qkv(at, tcfg, t(x), t(pos)),
                         JA.gqa_qkv(aj, jcfg, jnp.asarray(x),
                                    jnp.asarray(pos))):
        assert got.shape == want.shape and close(got, want)
    o = _rand(4, 2, tcfg.num_heads, 12, tcfg.head_dim)
    assert close(TA.gqa_out(at, tcfg, t(o)), JA.gqa_out(aj, jcfg, o))


@pytest.mark.parametrize("pooling", ["prefix", "prefix_suffix"])
def test_router_logits_tanh_gelu(setup, pooling):
    jcfg, tcfg, _, np_params, tparams = setup
    x_q = _rand(5, 2, 20, tcfg.q_dim) * 4
    rj = jax.tree.map(lambda a: a[0], np_params["trunk"][0]["router"])
    rt = tparams["layers"][0]["router"]
    want = JR.router_logits(rj, jnp.asarray(x_q), jcfg.flux.pool_size,
                            pooling)
    assert close(TR.router_logits(rt, t(x_q), tcfg.flux.pool_size,
                                  pooling), want, 1e-5)
    dj, pj = JR.hard_route(rj, jnp.asarray(x_q), jcfg.flux, pooling)
    dt, pt = TR.hard_route(rt, t(x_q), tcfg.flux, pooling)
    assert np.array_equal(dt.numpy(), np.asarray(dj))
    assert close(pt, pj, 1e-5)
    for lv in range(5):
        assert TR.sa_biased_threshold(lv) == JR.sa_biased_threshold(lv)


# ---------------------------------------------------------------------------
# KV-cache inserts and chunk planning
# ---------------------------------------------------------------------------

def _ring_pair(Bq, Hkv, D, sink, local):
    ring = sink + local
    j = JKC.RingKV(k=jnp.zeros((Bq, Hkv, ring, D)),
                   v=jnp.zeros((Bq, Hkv, ring, D)),
                   positions=jnp.full((Bq, ring), -1, jnp.int32),
                   length=jnp.zeros((Bq,), jnp.int32))
    tc = TKC.RingKV(k=torch.zeros((Bq, Hkv, ring, D)),
                    v=torch.zeros((Bq, Hkv, ring, D)),
                    positions=torch.full((Bq, ring), -1, dtype=torch.int32),
                    length=torch.zeros((Bq,), dtype=torch.int32))
    return j, tc


@pytest.mark.parametrize("start,C", [(0, 4), (6, 7), (9, 17), (0, 20),
                                     (30, 3)])
def test_ring_insert_chunk_matches_jax(start, C):
    """Chunks shorter and longer than the ring (ring = 8), from a ring
    already holding positions [0, start)."""
    Bq, Hkv, D, sink, local = 2, 2, 4, 3, 5
    j, tc = _ring_pair(Bq, Hkv, D, sink, local)
    if start:
        hist = _rand(6, Bq, Hkv, start, D)
        j = JKC.ring_insert_chunk(j, hist, hist, jnp.int32(0), sink, local)
        TKC.ring_insert_chunk(tc, t(hist), t(hist), 0, sink, local)
    new_k, new_v = _rand(7, Bq, Hkv, C, D), _rand(8, Bq, Hkv, C, D)
    j = JKC.ring_insert_chunk(j, new_k, new_v, jnp.int32(start), sink,
                              local)
    out = TKC.ring_insert_chunk(tc, t(new_k), t(new_v), start, sink, local)
    for f in ("k", "v", "positions", "length"):
        assert np.array_equal(getattr(out, f).numpy(),
                              np.asarray(getattr(j, f))), f
    for s in range(3 * (sink + local)):  # single-token slot arithmetic
        assert TKC.ring_slot(s, sink, local) == int(
            JKC.ring_slot(jnp.int32(s), sink, local))


def test_full_insert_chunk_and_capacity():
    Bq, Hkv, D, cap = 2, 2, 4, 16
    j = JKC.FullKV(k=jnp.zeros((Bq, Hkv, cap, D)),
                   v=jnp.zeros((Bq, Hkv, cap, D)),
                   length=jnp.zeros((Bq,), jnp.int32))
    tc = TKC.FullKV(k=torch.zeros((Bq, Hkv, cap, D)),
                    v=torch.zeros((Bq, Hkv, cap, D)),
                    length=torch.zeros((Bq,), dtype=torch.int32))
    kn, vn = _rand(9, Bq, Hkv, 5, D), _rand(10, Bq, Hkv, 5, D)
    j = JKC.full_insert_chunk(j, kn, vn, jnp.int32(3))
    out = TKC.full_insert_chunk(tc, t(kn), t(vn), 3)
    for f in ("k", "v", "length"):
        assert np.array_equal(getattr(out, f).numpy(),
                              np.asarray(getattr(j, f)))
    with pytest.raises(IndexError):  # no silent clamp past the capacity
        TKC.full_insert_chunk(tc, t(kn), t(vn), cap - 2)
    with pytest.raises(IndexError):
        TKC.full_insert(tc, t(kn[:, :, :1]), t(vn[:, :, :1]), cap)


def test_chunk_plan_and_ring_src_match_jax():
    for seq_len in (1, 7, 16, 48, 100, 513):
        for chunk in (1, 7, 8, 13, 16, 64, 512):
            assert TE.chunk_plan(seq_len, chunk) == JE.chunk_plan(seq_len,
                                                                  chunk)
    for seq_len in (3, 8, 40, 41, 100):
        assert np.array_equal(TE._ring_src(seq_len, 8, 32, 40),
                              JE._ring_src(seq_len, 8, 32, 40))
    with pytest.raises(ValueError):
        TE.chunk_plan(0, 16)


# ---------------------------------------------------------------------------
# Prefill, streamed chunks, decode
# ---------------------------------------------------------------------------

TOKS = np.random.default_rng(11).integers(0, 512, size=(2, 48))


@pytest.mark.parametrize("ctx,fixed", [("hard_prefix", None),
                                       ("hard", None),
                                       ("fixed", (1, 0)),
                                       ("fixed", (0, 0)),
                                       ("fa_only", None)])
def test_prefill_logits_and_decisions(setup, ctx, fixed):
    jcfg, tcfg, jparams, _, tparams = setup
    jf = JMD.prefill(jparams, jcfg, jnp.asarray(TOKS), routing_ctx=ctx,
                     fixed_pattern=None if fixed is None
                     else jnp.asarray(fixed))
    tf = TMD.prefill(tparams, tcfg, t(TOKS), routing_ctx=ctx,
                     fixed_pattern=fixed)
    assert close(tf.logits, jf.logits)
    if ctx == "fa_only":
        assert tf.routing is None and jf.routing is None
        return
    assert np.array_equal(tf.routing.numpy(), np.asarray(jf.routing))
    assert close(tf.p_fa, jf.p_fa, 1e-5)
    jk, jv = jf.caches[0]  # period position 0, stacked over layers
    for i, (k, v) in enumerate(tf.caches):
        assert close(k, jk[i]) and close(v, jv[i])


def _seeded(setup, pattern, route_len):
    """Both packages' decode caches after a fixed-routing first chunk."""
    jcfg, tcfg, jparams, _, tparams = setup
    fixed = [1 if p == "fa" else 0 for p in pattern]
    chunk = TOKS[:, :route_len]
    jf = JMD.prefill(jparams, jcfg, jnp.asarray(chunk), routing_ctx="fixed",
                     fixed_pattern=jnp.asarray(fixed))
    jc = JE.seed_caches(jcfg, jf.caches, pattern, 2, MAX_LEN)
    tf = TMD.prefill(tparams, tcfg, t(chunk), routing_ctx="fixed",
                     fixed_pattern=fixed)
    tc = TE.seed_caches(tcfg, tf.caches, pattern, 2, MAX_LEN, "cpu")
    return jc, tc


def _same_caches(tc, jc):
    assert TKC.cache_geometry(tc) == JKC.cache_geometry(jc)
    for a, b in zip(tc, jc):
        assert type(a).__name__ == type(b).__name__
        assert close(a.k, b.k) and close(a.v, b.v)
        assert np.array_equal(a.length.numpy(), np.asarray(b.length))
        if isinstance(a, TKC.RingKV):
            assert np.array_equal(a.positions.numpy(),
                                  np.asarray(b.positions))


@pytest.mark.parametrize("pattern", [("fa", "sa"), ("sa", "fa")])
def test_prefill_chunk_at_offset(setup, pattern):
    """Streamed chunks at start > 0 into a FullKV and a RingKV layer; the
    last one ends at 48 > sink + local = 40, so the ring wraps."""
    jcfg, tcfg, jparams, _, tparams = setup
    jc, tc = _seeded(setup, pattern, 16)
    _same_caches(tc, jc)
    for start, size in ((16, 16), (32, 16)):
        chunk = TOKS[:, start:start + size]
        jl, jc = JMD.prefill_chunk(jparams, jcfg, jnp.asarray(chunk), jc,
                                   jnp.int32(start))
        tl, tc = TMD.prefill_chunk(tparams, tcfg, t(chunk), tc, start)
        assert close(tl, jl)
        _same_caches(tc, jc)


@pytest.mark.parametrize("pattern", [("fa", "fa"), ("sa", "sa"),
                                     ("fa", "sa")])
def test_decode_core_full_and_ring(setup, pattern):
    """Decode steps over FullKV and RingKV, past the ring's wrap point
    (prompt 40 ≥ sink + local = 40)."""
    jcfg, tcfg, jparams, _, tparams = setup
    jc, tc = _seeded(setup, pattern, 40)
    tok = np.array([[3], [7]])
    for pos in (40, 41, 42):
        jl, jc = JMD.decode_core(jparams, jcfg, jnp.asarray(tok), jc,
                                 jnp.int32(pos))
        tl, tc = TMD.decode_core(tparams, tcfg, t(tok), tc, pos)
        assert close(tl, jl)
        _same_caches(tc, jc)
        tok = np.asarray(jnp.argmax(jl, -1))[:, None]
