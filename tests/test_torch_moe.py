"""The port's Mixture-of-Experts (``repro_torch/models/moe.py``) and its
serving of granite-moe-3b-a800m against the JAX package, on the same
weights (``params_from_jax``) and numpy-seeded inputs, float32 on both
sides:

- ``moe_apply`` against JAX's over dropless and capacity-bound calls
  (``moe_capacity_factor`` 1.25, granite's, and 1.0), S = 1 and 16,
  B = 1 and 3, with and without a shared expert: y within 1e-5
  (summation order only), ``load`` and ``drop_fraction`` exact, entropy
  and balance loss within 1e-6;
- all-equal gate rows pick experts 0..k-1, as ``lax.top_k`` orders ties;
  a NaN row leaves every other row bitwise as it was;
- ``param_count`` (all and active parameters) equal to JAX's;
- granite's smoke variant at capacity factor 1.25 (``smoke_variant`` is
  dropless, so the tests that must see drops set granite's factor on
  both sides) and a variant at head dim 64, G = 3 (granite's grouping)
  through ``generate`` (chunks of 16 and monolithic) and a small drain:
  routing and tokens identical, first-step logits within 1e-4. The
  router's decision is a strict mean(p_fa) > 0.5 and an expert choice a
  comparison of gate probabilities, so each case asserts a router margin
  above 1e-3 and a gap above 1e-5 between every token's k-th and
  (k+1)-th gate probability, and that JAX drops tokens in its calls;
- a 2-layer config whose even layer has an MoE and odd layer a dense FFN;
- the engine's fidelity probe at a prompt length that is not a power of
  two, with drops: the JAX engine pads the prompt to its power-of-two
  bucket, so its MoE capacity is the bucket's; the port's probe passes
  that capacity and agrees within 1e-5 (coverage is a float32 softmax
  sum), where the unpadded capacity would not.
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
from repro.models import moe as JMOE  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.models import model as MD  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.scheduler import STATUS_OK  # noqa: E402

ARCH = "granite-moe-3b-a800m"
B, S, N, MAX_LEN = 2, 48, 6, 64
TOL = 1e-4
MARGIN = 1e-3      # router: every layer's mean p_fa this far from 0.5
TOPK_GAP = 1e-5    # gate: every token's k-th and (k+1)-th prob this far
CHUNKS = [16, None]
MIXED = ("fa", "sa")
DRAIN_LENS = (20, 28, 36, 24)
GRANITE_CAP = 1.25  # granite's moe_capacity_factor (the config default)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _moe_configs(cap=None, shared=0):
    """Granite's smoke variant in both packages (4 experts, top 2, d 256,
    expert width 128), at capacity factor ``cap`` (None: the smoke
    variant's dropless 4.0) with ``shared`` shared experts."""
    kw = dict(num_shared_experts=shared)
    if cap is not None:
        kw["moe_capacity_factor"] = cap
    return (jax_smoke(jax_get_config(ARCH)).replace(**kw),
            smoke_variant(get_config(ARCH)).replace(**kw))


def _moe_params(jcfg, seed=0):
    jp = JMOE.moe_init(jax.random.key(seed), jcfg)
    return jp, _to_torch(jax.tree.map(np.asarray, jp))


def _x(b, s, d, seed=0):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# moe_apply against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shared", [0, 1], ids=["routed", "shared1"])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("s", [1, 16])
@pytest.mark.parametrize("cap", [None, GRANITE_CAP, 1.0],
                         ids=["dropless", "cap1.25", "cap1.0"])
def test_moe_apply_matches_jax(cap, s, b, shared):
    jcfg, tcfg = _moe_configs(cap, shared)
    jp, tp = _moe_params(jcfg, seed=s + b)
    x = _x(b, s, jcfg.d_model, seed=10 * s + b)
    jy, jaux = JMOE.moe_apply(jp, jcfg, jnp.asarray(x))
    ty, taux = MOE.moe_apply(tp, tcfg, torch.from_numpy(x))
    assert ty.dtype == torch.float32 and ty.shape == x.shape
    assert ("shared" in tp) == bool(shared)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(taux["load"].numpy(),
                                  np.asarray(jaux["load"]))
    drop = float(jaux["drop_fraction"])
    assert float(taux["drop_fraction"]) == drop
    for key in ("router_entropy", "balance_loss"):
        assert abs(float(taux[key]) - float(jaux[key])) < 1e-6, key
    # the dropped share is each row's overflow past C over its experts
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["gate_w"], axis=-1)
    top_i = np.asarray(jax.lax.top_k(probs, jcfg.top_k)[1])
    row_load = np.stack([np.bincount(r.reshape(-1),
                                     minlength=jcfg.num_experts)
                         for r in top_i])
    C = MOE.moe_capacity(tcfg, s)
    overflow = int(np.maximum(row_load - C, 0).sum())
    assert abs(drop - overflow / top_i.size) < 1e-6
    if cap is None or s == 1:
        # C = S (dropless), and at S = 1 C = 1: a token's experts are
        # distinct
        assert C == s and drop == 0.0
    elif cap == 1.0 or b == 3:
        assert drop > 0.0, "this capacity-bound case must drop"


def test_capacity_follows_the_jax_formula():
    """C = min(max(1, int(ceil(S·k/E) · cap)), S), truncated by int:
    granite's chunk of 512 gets int(103 · 1.25) = 128 slots an expert
    against a mean load of 102.4, and one decode token gets 1."""
    full = get_config(ARCH)
    assert MOE.moe_capacity(full, 512) == 128
    assert MOE.moe_capacity(full, 1) == 1
    _, tcfg = _moe_configs()
    for s in (1, 2, 5, 16, 48, 512):
        for cap in (None, 1.0, 1.25, 2.0):
            c = (cap if cap is not None else tcfg.moe_capacity_factor)
            want = min(max(1, int(-(-s * tcfg.top_k // tcfg.num_experts)
                                  * c)), s)
            assert MOE.moe_capacity(tcfg, s, cap) == want


def test_equal_gate_rows_pick_the_lowest_experts():
    """x = 0 makes every gate logit 0: each token picks experts 0..k-1,
    as ``lax.top_k`` breaks ties toward the lower index. Ties inside a
    row of distinct values keep that order too."""
    jcfg, tcfg = _moe_configs()
    jp, tp = _moe_params(jcfg)
    x = np.zeros((2, 5, jcfg.d_model), np.float32)
    _, jaux = JMOE.moe_apply(jp, jcfg, jnp.asarray(x))
    _, taux = MOE.moe_apply(tp, tcfg, torch.from_numpy(x))
    want = np.zeros(jcfg.num_experts, np.int64)
    want[:jcfg.top_k] = 2 * 5
    np.testing.assert_array_equal(np.asarray(jaux["load"]), want)
    np.testing.assert_array_equal(taux["load"].numpy(), want)
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.3, 0.3, 0.3],
                      [0.3, 0.1, 0.3, 0.3],
                      [0.2, 0.3, 0.2, 0.3]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = MOE.top_k_lower_first(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_a_nan_row_stays_in_its_row():
    """Row 1 of three holds a NaN: rows 0 and 2 are bitwise what they are
    with row 1 finite, at a capacity that drops (the dropped choices of
    the NaN row add NaN · 0 into its own buffer only)."""
    _, tcfg = _moe_configs(1.0, shared=1)
    _, tp = _moe_params(_moe_configs(1.0, shared=1)[0])
    x = torch.from_numpy(_x(3, 16, tcfg.d_model, seed=5))
    clean, aux = MOE.moe_apply(tp, tcfg, x)
    assert float(aux["drop_fraction"]) > 0
    bad = x.clone()
    bad[1, 7, 3] = float("nan")
    y, _ = MOE.moe_apply(tp, tcfg, bad)
    assert not bool(torch.isfinite(y[1]).all())
    assert torch.equal(y[0], clean[0]) and torch.equal(y[2], clean[2])


@pytest.mark.parametrize("active_only", [False, True])
@pytest.mark.parametrize("arch", [ARCH, "phi3-mini-3.8b", "stablelm-12b",
                                  "command-r-plus-104b"])
def test_param_count_matches_jax(arch, active_only):
    full_j, full_t = jax_get_config(arch), get_config(arch)
    for jcfg, tcfg in ((full_j, full_t),
                       (jax_smoke(full_j), smoke_variant(full_t))):
        assert (tcfg.param_count(active_only=active_only)
                == jcfg.param_count(active_only=active_only))
    if arch == ARCH:
        # ≈ 3.30 B parameters, ≈ 0.88 B of them active a token
        assert full_t.param_count() == 3_298_791_936
        assert full_t.param_count(active_only=True) == 882_872_832


# ---------------------------------------------------------------------------
# granite through the engine against JAX
# ---------------------------------------------------------------------------

VARIANTS = {  # name: what replaces granite's smoke variant, both packages
    "granite_smoke_cap1.25": dict(moe_capacity_factor=GRANITE_CAP),
    "granite_d64_g3": dict(moe_capacity_factor=GRANITE_CAP, num_heads=6,
                           num_kv_heads=2, head_dim=64),
    "moe_even_layers": dict(moe_capacity_factor=GRANITE_CAP,
                            layer_pattern=("attn", "attn"),
                            moe_layers="even"),
}


def _configs(name):
    kw = VARIANTS[name]
    return (jax_smoke(jax_get_config(ARCH)).replace(**kw),
            smoke_variant(get_config(ARCH)).replace(**kw))


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant(request):
    """(name, JAX config, port config, JAX params, port params, prompts)."""
    jcfg, tcfg = _configs(request.param)
    jparams = JMD.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              "cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                             size=(B, S)).astype(np.int32)
    return request.param, jcfg, tcfg, jparams, tparams, toks


def test_variants_keep_granite_geometry():
    for name in VARIANTS:
        jcfg, tcfg = _configs(name)
        for key in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                    "head_dim", "d_ff", "vocab_size", "num_experts",
                    "top_k", "moe_d_ff", "moe_capacity_factor",
                    "tie_embeddings", "layer_pattern", "moe_layers"):
            assert getattr(jcfg, key) == getattr(tcfg, key), (name, key)
    full = get_config(ARCH)
    assert (full.head_dim, full.num_heads // full.num_kv_heads) == (64, 3)
    g3 = _configs("granite_d64_g3")[1]
    assert (g3.head_dim, g3.num_heads // g3.num_kv_heads) == (64, 3)
    even = _configs("moe_even_layers")[1]
    assert even.moe_layer_mask() == (True, False)


def test_bridge_keeps_the_expert_leaves(variant):
    """Every MoE leaf bridged bit for bit, the period axis indexed first:
    ``gate_w`` float32 (the expert weights take ``param_dtype``, also in
    a bf16 config), experts (E, D, F) / (E, F, D); a dense layer keeps
    its ``ffn``."""
    name, jcfg, tcfg, jparams, tparams, _ = variant
    P = len(tcfg.layer_pattern)
    for i, layer in enumerate(tparams["layers"]):
        per, pos = divmod(i, P)
        jl = jparams["trunk"][pos]
        if tcfg.moe_layer_mask()[i]:
            assert "ffn" not in layer
            assert layer["moe"]["gate_w"].dtype == torch.float32
            np.testing.assert_array_equal(
                layer["moe"]["gate_w"].numpy(),
                np.asarray(jl["moe"]["gate_w"])[per])
            for key, shape in (("gate", (4, tcfg.d_model, 128)),
                               ("up", (4, tcfg.d_model, 128)),
                               ("down", (4, 128, tcfg.d_model))):
                t = layer["moe"]["experts"][key]
                assert tuple(t.shape) == shape
                np.testing.assert_array_equal(
                    t.numpy(), np.asarray(jl["moe"]["experts"][key])[per])
        else:
            assert name == "moe_even_layers" and "moe" not in layer
            np.testing.assert_array_equal(
                layer["ffn"]["up"].numpy(), np.asarray(jl["ffn"]["up"])[per])


def test_bridge_keeps_float32_gate_beside_bf16_experts():
    """granite's own dtypes, on a narrow copy: bf16 experts, an f32 gate,
    through the bridge and the port's own init alike."""
    jcfg = jax_smoke(jax_get_config(ARCH)).replace(
        dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    tcfg = smoke_variant(get_config(ARCH)).replace(
        dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    jparams = JMD.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              "cpu")
    native = MD.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    for params in (tparams, native):
        moe = params["layers"][1]["moe"]
        assert moe["gate_w"].dtype == torch.float32
        assert all(t.dtype == torch.bfloat16
                   for t in moe["experts"].values())
    np.testing.assert_array_equal(
        tparams["layers"][1]["moe"]["experts"]["down"].float().numpy(),
        np.asarray(jparams["trunk"][0]["moe"]["experts"]["down"][1],
                   np.float32))


def _gap_recorder(monkeypatch):
    """Record the smallest gap between a token's k-th and (k+1)-th gate
    probability over every port MoE call."""
    gaps = []
    dispatch = MOE.dispatch

    def recorded(params, cfg, *a, **kw):
        d = dispatch(params, cfg, *a, **kw)
        top = torch.sort(d.probs, dim=-1, descending=True).values
        gaps.append(float((top[..., cfg.top_k - 1]
                           - top[..., cfg.top_k]).min()))
        return d
    monkeypatch.setattr(MOE, "dispatch", recorded)
    return gaps


def _jax_drops(jparams, jcfg, toks, chunk, routing_ctx="hard_prefix"):
    """JAX's drop fraction per MoE layer over the route chunk (chunk
    tokens, or the whole prompt when monolithic)."""
    n = toks.shape[1] if chunk is None else chunk
    pf = JMD.prefill(jparams, jcfg, jnp.asarray(toks[:, :n]),
                     routing_ctx=routing_ctx, want_cache=False)
    return np.asarray(pf.aux["moe_drop"]).reshape(-1)


@pytest.fixture(scope="module")
def jax_runs(variant):
    name, jcfg, _, jparams, _, toks = variant
    out = {}
    for chunk in CHUNKS:
        eng = JaxEngine(jparams, jcfg, max_len=MAX_LEN, prefill_chunk=chunk)
        for ov in (None, MIXED):
            gen = eng.generate(toks, N, routing_override=ov)
            if eng.chunked_eligible(S, ov):
                logits = eng.prefill_chunked(jnp.asarray(toks), ov,
                                             reuse=False).logits
            else:
                logits = eng.prefill_route_repack(jnp.asarray(toks),
                                                  ov)[0].logits
            out[chunk, ov] = (gen, np.asarray(logits))
    return out


@pytest.mark.parametrize("override", [None, MIXED],
                         ids=["router", "mixed"])
@pytest.mark.parametrize("chunk", CHUNKS, ids=["chunked", "monolithic"])
def test_generate_matches_jax(variant, jax_runs, monkeypatch, chunk,
                              override):
    _, jcfg, tcfg, jparams, tparams, toks = variant
    jgen, jlogits = jax_runs[chunk, override]
    assert _jax_drops(jparams, jcfg, toks, chunk).max() > 0, \
        "JAX's route chunk drops no token"
    gaps = _gap_recorder(monkeypatch)
    eng = ServeEngine(tparams, tcfg, max_len=MAX_LEN, prefill_chunk=chunk,
                      device="cpu")
    gen = eng.generate(toks, N, routing_override=override)
    n_moe = sum(tcfg.moe_layer_mask())
    assert len(gaps) >= n_moe * (N + 1)  # prefill calls and every step
    assert min(gaps) > TOPK_GAP, min(gaps)
    if override is None:
        assert np.all(np.abs(jgen.p_fa - 0.5) > MARGIN), jgen.p_fa
        np.testing.assert_allclose(gen.p_fa, jgen.p_fa, atol=1e-5)
    assert gen.routing == jgen.routing
    assert gen.msr == jgen.msr and gen.kv_bytes == jgen.kv_bytes
    assert np.array_equal(gen.tokens, np.asarray(jgen.tokens))
    assert float(np.abs(gen.logits.numpy() - jlogits).max()) < TOL


def _drain(engine, specs, req_cls):
    engine.scheduler(slots_per_bucket=2, chunk=4)
    for rid, toks, ov in specs:
        engine.submit(req_cls(rid=rid, tokens=toks, n_steps=5,
                              routing_override=ov))
    return engine.drain()


def test_drain_matches_jax(variant, monkeypatch):
    """Four requests of 20-36 tokens, router-driven and mixed in turn,
    through 2-slot pools in decode chunks of 4: the MoE runs one token a
    slot, each slot its own row."""
    _, jcfg, tcfg, jparams, tparams, _ = variant
    rng = np.random.default_rng(2)
    specs = [(i, rng.integers(0, jcfg.vocab_size, n),
              (None, MIXED)[i % 2]) for i, n in enumerate(DRAIN_LENS)]
    jout = _drain(JaxEngine(jparams, jcfg, max_len=MAX_LEN), specs,
                  JaxRequest)
    gaps = _gap_recorder(monkeypatch)
    tout = _drain(ServeEngine(tparams, tcfg, max_len=MAX_LEN, device="cpu"),
                  specs, Request)
    assert min(gaps) > TOPK_GAP, min(gaps)
    for rid, *_ in specs:
        assert tout[rid].status == jout[rid].status == STATUS_OK
        assert tout[rid].routing == jout[rid].routing, rid
        assert np.array_equal(tout[rid].tokens, jout[rid].tokens), rid


# ---------------------------------------------------------------------------
# The fidelity probe pads like the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length", [45, 100])
def test_fidelity_probe_matches_jax_engine(length):
    """At a prompt that is not a power of two, with drops: the JAX engine
    probes the prompt padded to its bucket, whose MoE capacity is larger;
    the port passes the bucket's capacity and agrees, while the unpadded
    capacity gives another coverage."""
    jcfg, tcfg = _configs("granite_smoke_cap1.25")
    jparams = JMD.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              "cpu")
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size,
                                             length).astype(np.int32)
    bucket = 1 << (length - 1).bit_length()
    assert length > tcfg.flux.sink + tcfg.flux.local and bucket != length
    assert MOE.moe_capacity(tcfg, length) < MOE.moe_capacity(tcfg, bucket)
    # the unpadded FA-only forward drops tokens at the first MoE layer
    assert _jax_drops(jparams, jcfg, toks[None], None, "fa_only")[0] > 0
    pattern = ("fa", "sa")
    jeng = JaxEngine(jparams, jcfg, max_len=MAX_LEN, fidelity_probe_every=1)
    teng = ServeEngine(tparams, tcfg, max_len=MAX_LEN,
                       fidelity_probe_every=1, device="cpu")
    jcov = np.asarray(jeng._maybe_fidelity_probe(toks, pattern))
    tcov = teng._maybe_fidelity_probe(toks, pattern)
    np.testing.assert_allclose(tcov, jcov, rtol=0, atol=1e-5)
    unpadded = MD.attention_mass_coverage(
        tparams, tcfg, torch.as_tensor(toks[None].astype(np.int64))).numpy()
    # layer 0's coverage comes before any MoE; layer 1's after one
    np.testing.assert_allclose(unpadded[0], jcov[0], rtol=0, atol=1e-5)
    assert abs(float(unpadded[1]) - float(jcov[1])) > 1e-5


def test_preempted_moe_request_matches_jax():
    """Recompute preemption replays prompt + generated tokens through the
    chunked prefill, whose MoE capacity can drop some of them, where a
    decode step (one token a row, C = 1) drops none: the victim's stream
    is the JAX engine's, token for token, and the request that never
    left its slot equals its ``generate`` alone."""
    jcfg, tcfg = _configs("granite_smoke_cap1.25")
    jparams = JMD.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              "cpu")
    rng = np.random.default_rng(5)
    t_low = rng.integers(0, jcfg.vocab_size, size=24)
    t_high = rng.integers(0, jcfg.vocab_size, size=28)
    outs = {}
    for name, eng, req in (
            ("jax", JaxEngine(jparams, jcfg, max_len=MAX_LEN), JaxRequest),
            ("port", ServeEngine(tparams, tcfg, max_len=MAX_LEN,
                                 device="cpu"), Request)):
        sched = eng.scheduler(slots_per_bucket=1, chunk=2)
        eng.submit(req(rid=0, tokens=t_low, n_steps=10,
                       routing_override=MIXED))
        while not sched.n_active():
            eng.step()
        eng.submit(req(rid=1, tokens=t_high, n_steps=4,
                       routing_override=MIXED, priority=9))
        outs[name] = eng.drain()
    jout, tout = outs["jax"], outs["port"]
    assert tout[0].metrics.preemptions == jout[0].metrics.preemptions >= 1
    for rid in (0, 1):
        assert tout[rid].status == jout[rid].status == STATUS_OK
        assert np.array_equal(tout[rid].tokens, jout[rid].tokens), rid
    alone = ServeEngine(tparams, tcfg, max_len=MAX_LEN, device="cpu")
    assert np.array_equal(
        tout[1].tokens,
        alone.generate(t_high[None], 4, routing_override=MIXED).tokens[0])
    # here the replay's capacity drops tokens its decode kept, and the
    # victim leaves its uninterrupted stream, in JAX as in the port
    solo = alone.generate(t_low[None], 10, routing_override=MIXED).tokens[0]
    assert not np.array_equal(tout[0].tokens, solo)
