"""The port's Mamba2 SSD layers (``models/ssm.py`` and the serving path
that carries their state) against the JAX package's, with the same
weights (``params_from_jax``), in float32, on the smoke variants of
mamba2-780m (2 Mamba layers, no FFN, flux disabled) and
jamba-1.5-large-398b (one period of 8: Mamba layers around one routed
attention layer at index 3, MoE on the even layers).

Tolerances: 1e-5 on the SSD pieces, relative to the reference's largest
magnitude (the chunked form sums in another order than XLA's einsums);
1e-4 on logits, as the other port files hold them. Held:

- ``param_count`` (full, smoke, ``active_only``) and the init's leaves;
- ``ssd_chunked`` at S a multiple of Q, not a multiple, S < Q, S = 1
  and with an initial state; ``mamba_apply`` whole and split at 1-, 2-
  and 7-token chunks with the state carried; 8 ``mamba_decode_step``s;
- the bridge at a 16-layer, two-period jamba variant;
- ``generate`` at B = 1 and 2 (jamba router-driven, all-FA, all-SA and
  mixed): tokens, routing, ``kv_bytes``, ``cache_geometry`` and
  ``dispatches`` equal to JAX's, the router's margin asserted; chunk
  sizes 16, 7, > S and the monolithic repack give the same tokens;
- a slot-pool drain with a preemption (statuses and tokens as JAX's), and
  a poisoned slot whose siblings stay bitwise equal;
- a prefix store round trip through the host tier (warm = cold bitwise,
  ``snapshot_spec_bytes`` and the store's stats as JAX's);
- the memory ledger and ``_pool_layer_specs`` with Mamba layers;
  ``capture_hidden`` and ``attention_mass_coverage``.

The JAX engines' runs are shared through the module-scoped ``jax_runs``
fixture (their compiles are most of this file's time; mamba2's run in a
spawned worker beside jamba's).
"""
import functools
import inspect
import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor
from types import SimpleNamespace

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
from repro.models import ssm as JS  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro.serve import kv_cache as JKC  # noqa: E402
from repro.serve import prefix_cache as JPXC  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.serve import kv_cache as TKC  # noqa: E402
from repro_torch.serve import prefix_cache as TPXC  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.slo import STATUS_FAILED, STATUS_OK  # noqa: E402

MAMBA, JAMBA = "mamba2-780m", "jamba-1.5-large-398b"
B, S, N, MAX_LEN, CH = 2, 45, 6, 64, 16
SSD_TOL = 1e-5
TOL = 1e-4
MARGIN = 1e-3
ROUTINGS = {"router": None, "fa": ("fa",) * 8, "sa": ("sa",) * 8,
            "mixed": tuple("fa" if i % 2 == 0 else "sa" for i in range(8))}
# (arch, routing, batch) of the JAX generate runs
RUNS = ([(MAMBA, "router", 1), (MAMBA, "router", 2), (JAMBA, "router", 1)]
        + [(JAMBA, r, 2) for r in ROUTINGS])


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want, tol=SSD_TOL):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(_np(got) - want).max())
    assert err <= tol * scale, (err, scale)


@functools.lru_cache(maxsize=None)
def _models(arch, layers=None):
    """(JAX config, port config, JAX params, port params, prompts (B, S))
    of ``arch``'s smoke variant (at ``layers`` layers when given)."""
    jcfg = jax_smoke(jax_get_config(arch))
    tcfg = smoke_variant(get_config(arch))
    if layers:
        jcfg, tcfg = (jcfg.replace(num_layers=layers),
                      tcfg.replace(num_layers=layers))
    jparams = JMD.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              "cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                             size=(B, S)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, toks


# ---------------------------------------------------------------------------
# Configs, param_count, init, bridge
# ---------------------------------------------------------------------------

# the JAX package's counts (repro/configs/base.py)
PARAMS = {MAMBA: 779_907_072, JAMBA: 397_709_802_496}


def test_param_count_counts_mamba_layers_as_jax():
    """A Mamba layer counts in_proj, out_proj and the conv taps, not an
    attention block: the registered configs, jamba cut to one period,
    and a hand-made config that the count before the repair got wrong."""
    for arch, n in PARAMS.items():
        assert get_config(arch).param_count() == n
    jamba8 = get_config(JAMBA).replace(num_layers=8)
    assert jamba8.param_count() == 45_144_415_232
    made = ModelConfig(name="m", family="ssm", num_layers=3, d_model=64,
                       num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0,
                       vocab_size=100, layer_pattern=("mamba",),
                       ssm_state_dim=16, ssm_head_dim=32)
    # embedding and unembedding + 3 × (in_proj 64·(2·128 + 32 + 4)
    # + out_proj 128·64 + conv 4·(128 + 32) + norms 2·64)
    assert made.ssm_inner == 128 and made.ssm_num_heads == 4
    assert made.param_count() == 2 * 100 * 64 + 3 * (64 * 292 + 128 * 64
                                                    + 4 * 160 + 128)


@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
@pytest.mark.parametrize("which", ["full", "smoke", "one_period"])
def test_param_count_matches_jax(arch, which):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    if which == "smoke":
        jcfg, tcfg = jax_smoke(jcfg), smoke_variant(tcfg)
    elif which == "one_period":
        n = len(tcfg.layer_pattern)
        jcfg, tcfg = jcfg.replace(num_layers=n), tcfg.replace(num_layers=n)
    for key in ("num_layers", "d_model", "vocab_size", "layer_pattern",
                "ssm_state_dim", "ssm_head_dim", "ssm_expand",
                "ssm_conv_width", "ssm_chunk", "ssm_inner", "ssm_num_heads",
                "moe_layers", "num_experts", "top_k", "tie_embeddings"):
        assert getattr(tcfg, key) == getattr(jcfg, key), key
    assert tcfg.flux.enabled == jcfg.flux.enabled
    for active in (False, True):
        assert tcfg.param_count(active) == jcfg.param_count(active)


def _leaves(tree, prefix=()):
    if isinstance(tree, torch.Tensor):
        return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_leaves(v, prefix + (k,)))
    return out


@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
def test_init_has_the_jax_leaves_in_bf16(arch):
    """The port's own init at bf16 gives JAX's tree, shapes and dtypes
    (A_log, dt_bias and D stay float32), so the bridge carries every
    leaf; and its scales are JAX's."""
    bf = dict(dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    jcfg = jax_smoke(jax_get_config(arch)).replace(**bf)
    tcfg = smoke_variant(get_config(arch)).replace(
        dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    jparams = JMD.init_params(jax.random.key(0), jcfg)
    bridged = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              "cpu")
    own = TMD.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert _leaves(own) == _leaves(bridged)
    m = own["layers"][0]["mamba"]
    for k in ("A_log", "dt_bias", "D"):
        assert m[k].dtype == torch.float32
        # linspace and log may round their last bit differently
        np.testing.assert_allclose(_np(m[k]),
                                   _np(bridged["layers"][0]["mamba"][k]),
                                   rtol=1e-6)
    assert float(m["conv_w"].float().std()) == pytest.approx(0.1, rel=0.1)
    assert not m["conv_b"].any()


def test_bridge_unstacks_two_periods():
    """A 16-layer jamba (two periods): port layer i holds JAX trunk[i % 8]
    at period i // 8, Mamba, attention, router and MoE leaves alike."""
    jcfg, tcfg, jparams, tparams, _ = _models(JAMBA, 16)
    assert TMD.check_supported(tcfg) is None
    for i in range(16):
        want = jax.tree.map(np.asarray, JMD.layer_params(jparams, jcfg, i))
        got = tparams["layers"][i]
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        assert len(flat_w) == len(_leaves(got))
        for path, leaf in flat_w:
            t = got
            for p in path:
                t = t[p.key]
            assert np.array_equal(_np(t), leaf), (i, path)
        assert ("mamba" in got) == (jcfg.layer_kinds[i] == "mamba")
        assert ("moe" in got) == (i % 2 == 0)


# ---------------------------------------------------------------------------
# The SSD pieces
# ---------------------------------------------------------------------------

def _ssd_inputs(S_, h0, seed=0, Bsz=2, H=4, P=8, Nst=6):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((Bsz, S_, H, P)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((Bsz, S_, H)))).astype(f)
    A = -np.linspace(1.0, 16.0, H).astype(f)
    Bm = rng.standard_normal((Bsz, S_, Nst)).astype(f)
    Cm = rng.standard_normal((Bsz, S_, Nst)).astype(f)
    hh = rng.standard_normal((Bsz, H, P, Nst)).astype(f) if h0 else None
    return x, dt, A, Bm, Cm, hh


@pytest.mark.parametrize("S_,h0", [(64, False), (45, False), (10, False),
                                   (1, False), (45, True)],
                         ids=["multiple", "ragged", "short", "one", "h0"])
def test_ssd_chunked_matches_jax(S_, h0):
    x, dt, A, Bm, Cm, hh = _ssd_inputs(S_, h0)
    jy, jh = JS.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), 16,
                            None if hh is None else jnp.asarray(hh))
    ty, th = TS.ssd_chunked(*map(torch.tensor, (x, dt, A, Bm, Cm)), 16,
                            None if hh is None else torch.tensor(hh))
    assert ty.shape == x.shape and th.dtype == torch.float32
    _close(ty, jy)
    _close(th, jh)


# the exponent before its mask, as ``ssd_chunked`` computed it until the
# mask moved ahead of the exp (its backward was NaN where exp overflowed)
_MASKED_DECAY = """torch.exp((cum[..., :, None] - cum[..., None, :])
                      .masked_fill(~causal, float("-inf")))"""
_OLD_DECAY = "torch.exp(cum[..., :, None] - cum[..., None, :])"


def _old_ssd_chunked():
    src = inspect.getsource(TS.ssd_chunked)
    assert src.count(_MASKED_DECAY) == 1
    scope = dict(vars(TS))
    exec(src.replace(_MASKED_DECAY, _OLD_DECAY), scope)
    return scope["ssd_chunked"]


# the smoke variants' SSD: mamba2's 16 heads of 32 over a 16-wide state,
# chunk 16, S = 45 (two whole chunks and a ragged one)
SMOKE_SSD = dict(H=16, P=32, Nst=16)


def _grad_inputs(S_, seed, smoke):
    """(inputs, cotangents) of an SSD gradient check at the smoke shape:
    ``smoke`` with A down to -16, where exp(cum_i - cum_j) above the
    diagonal overflows float32; else A / 32 (-1/32 to -1/2), which keeps
    every exponent finite."""
    x, dt, A, Bm, Cm, hh = _ssd_inputs(S_, True, seed=seed, **SMOKE_SSD)
    if not smoke:
        A = (A / 32).astype(np.float32)
    rng = np.random.default_rng(seed + 100)
    wy = rng.standard_normal(x.shape).astype(np.float32)
    wh = rng.standard_normal(hh.shape).astype(np.float32)
    return (x, dt, A, Bm, Cm, hh), (wy, wh)


def _port_vjp(inputs, cots):
    ts = [torch.tensor(a, requires_grad=True) for a in inputs]
    y, h = TS.ssd_chunked(*ts[:5], 16, ts[5])
    ((y * torch.tensor(cots[0])).sum()
     + (h * torch.tensor(cots[1])).sum()).backward()
    return [t.grad.numpy() for t in ts]


def _jax_vjp(inputs, cots):
    (y, h), pull = jax.vjp(lambda *a: JS.ssd_chunked(*a[:5], 16, a[5]),
                           *map(jnp.asarray, inputs))
    return [np.asarray(g) for g in pull((jnp.asarray(cots[0]),
                                         jnp.asarray(cots[1])))]


def _scan64(x, dt, A, Bm, Cm, h0):
    """The SSD's recurrence step by step in float64 (no exponent is ever
    positive): h_t = exp(dt_t A) h_{t-1} + dt_t x_t ⊗ B_t, y_t = h_t C_t."""
    h = h0.astype(np.float64)
    ys = []
    for t in range(x.shape[1]):
        da = np.exp(dt[:, t] * A)                             # (B, H)
        h = (h * da[..., None, None] + (dt[:, t, :, None] * x[:, t])
             [..., None] * Bm[:, t, None, None, :])
        ys.append(np.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    return np.stack(ys, axis=1), h


def test_ssd_forward_is_bitwise_the_unmasked_formula():
    """The mask ahead of the exp changes no output bit, at the smoke
    shape where the unmasked exponent overflows."""
    old = _old_ssd_chunked()
    for S_ in (45, 64, 10):
        inputs, _ = _grad_inputs(S_, 3, smoke=True)
        args = list(map(torch.tensor, inputs))
        y, h = TS.ssd_chunked(*args[:5], 16, args[5])
        y0, h0 = old(*args[:5], 16, args[5])
        assert torch.equal(y, y0) and torch.equal(h, h0)


def test_ssd_gradient_matches_jax_where_finite():
    inputs, cots = _grad_inputs(45, 4, smoke=False)
    got, want = _port_vjp(inputs, cots), _jax_vjp(inputs, cots)
    for name, g, w in zip("x dt A B C h0".split(), got, want):
        assert np.isfinite(w).all(), name
        err = float(np.abs(g - w).max() / np.abs(w).max())
        assert err < SSD_TOL, (name, err)


def test_ssd_gradient_is_finite_where_exp_overflows():
    """At the smoke shape the unmasked exponent overflows (JAX's
    gradient is NaN there); the port's is finite and, along a random
    direction of each input, within 1e-4 of the float64 recurrence's
    central difference."""
    inputs, cots = _grad_inputs(45, 5, smoke=True)
    assert not all(np.isfinite(g).all() for g in _jax_vjp(inputs, cots))
    got = _port_vjp(inputs, cots)
    f64 = [a.astype(np.float64) for a in inputs]

    def loss(args):
        y, h = _scan64(*args)
        return float((y * cots[0]).sum() + (h * cots[1]).sum())

    rng = np.random.default_rng(6)
    eps = 1e-4
    for i, name in enumerate("x dt A B C h0".split()):
        assert np.isfinite(got[i]).all(), name
        u = rng.standard_normal(f64[i].shape)
        lo, hi = list(f64), list(f64)
        lo[i], hi[i] = f64[i] - eps * u, f64[i] + eps * u
        fd = (loss(hi) - loss(lo)) / (2 * eps)
        ad = float((got[i].astype(np.float64) * u).sum())
        assert abs(ad - fd) <= 1e-4 * abs(fd), (name, ad, fd)


@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
def test_training_gradients_through_mamba_blocks_are_finite(arch):
    """Every parameter's gradient of a soft-routed training loss is
    finite (each Mamba block's was NaN before the mask moved ahead of
    the exp)."""
    _, tcfg, _, tparams, toks = _models(arch)
    leaves = []

    def grad_leaf(t):
        t = t.detach().clone().requires_grad_(True)
        leaves.append(t)
        return t

    def walk(tree):
        if isinstance(tree, torch.Tensor):
            return grad_leaf(tree)
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return [walk(v) for v in tree]

    params = walk(tparams)
    tokens = torch.tensor(toks, dtype=torch.long)
    out = TMD.forward_train(params, tcfg, tokens, remat=False,
                            generator=torch.Generator().manual_seed(0))
    logp = torch.log_softmax(out.logits[:, :-1].float(), dim=-1)
    loss = -logp.gather(-1, tokens[:, 1:, None]).mean()
    loss.backward()
    bad = [i for i, t in enumerate(leaves)
           if t.grad is not None and not torch.isfinite(t.grad).all()]
    assert not bad, f"{len(bad)} of {len(leaves)} leaves non-finite"
    assert sum(t.grad is not None for t in leaves) > len(leaves) // 2


def test_softplus_and_conv_follow_jax():
    """softplus is logaddexp(x, 0) past torch's threshold of 20, and the
    causal conv sums its taps in order."""
    x = np.array([-30.0, -1.0, 0.0, 1.0, 19.0, 21.0, 40.0], np.float32)
    np.testing.assert_allclose(_np(TS.softplus(torch.tensor(x))),
                               np.asarray(jax.nn.softplus(x)), rtol=1e-6)
    rng = np.random.default_rng(4)
    xs = rng.standard_normal((2, 9, 5)).astype(np.float32)
    w = rng.standard_normal((4, 5)).astype(np.float32)
    b = rng.standard_normal((5,)).astype(np.float32)
    _close(TS._causal_conv(*map(torch.tensor, (xs, w, b))),
           JS._causal_conv(*map(jnp.asarray, (xs, w, b))))


def _mamba_params(arch=MAMBA):
    jcfg, tcfg, jparams, tparams, _ = _models(arch)
    jp = JMD.layer_params(jparams, jcfg, 0)["mamba"]
    return jcfg, tcfg, jp, tparams["layers"][0]["mamba"]


def _hidden(cfg, S_, seed=5, Bsz=B):
    return np.random.default_rng(seed).standard_normal(
        (Bsz, S_, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("split", [1, 2, 7, None],
                         ids=["c1", "c2", "c7", "whole"])
def test_mamba_apply_with_carried_state_matches_jax(split):
    """The whole sequence in JAX against the port whole or in chunks of
    ``split`` tokens with (h, conv_tail) carried: the same outputs, final
    state and tail; chunks shorter than the conv window still emit a
    (B, W-1, C) tail."""
    jcfg, tcfg, jp, tp = _mamba_params()
    x = _hidden(tcfg, 23)
    jy, (jh, jtail) = JS.mamba_apply(jp, jcfg, jnp.asarray(x))
    if split is None:
        ty, (th, ttail) = TS.mamba_apply(tp, tcfg, torch.tensor(x))
    else:
        state, ys = None, []
        for s0 in range(0, x.shape[1], split):
            y, state = TS.mamba_apply(tp, tcfg,
                                      torch.tensor(x[:, s0:s0 + split]),
                                      state)
            assert state[1].shape == (B, tcfg.ssm_conv_width - 1,
                                      tcfg.ssm_inner
                                      + 2 * tcfg.ssm_state_dim)
            ys.append(y)
        ty, (th, ttail) = torch.cat(ys, dim=1), state
    _close(ty, jy)
    _close(th, jh)
    _close(ttail, jtail)


def test_decode_steps_match_jax():
    """A 13-token prefill, then 8 ``mamba_decode_step``s: every output,
    the SSD state and the conv tail as JAX's."""
    jcfg, tcfg, jp, tp = _mamba_params()
    x = _hidden(tcfg, 13 + 8, seed=6)
    _, (jh, jt) = JS.mamba_apply(jp, jcfg, jnp.asarray(x[:, :13]))
    _, (th, tt) = TS.mamba_apply(tp, tcfg, torch.tensor(x[:, :13]))
    for i in range(13, 21):
        jy, jh, jt = JS.mamba_decode_step(jp, jcfg,
                                          jnp.asarray(x[:, i:i + 1]), jh, jt)
        ty, th, tt = TS.mamba_decode_step(tp, tcfg,
                                          torch.tensor(x[:, i:i + 1]), th,
                                          tt)
        _close(ty, jy)
        _close(th, jh)
        _close(tt, jt)


def test_mamba_cache_layout_matches_jax():
    """``MambaCache`` fields, dtypes and geometry spelled as JAX's, its
    bytes all payload, no ring and no capacity."""
    for arch in (MAMBA, JAMBA):
        jcfg, tcfg, *_ = _models(arch)
        pattern = tuple("sa" if k == "attn" else None
                        for k in tcfg.layer_kinds)
        tc = TKC.init_decode_caches(tcfg, pattern, 3, 40, "cpu")
        jc = JKC.init_decode_caches(jcfg, pattern, 3, 40)
        assert TKC.cache_geometry(tc) == JKC.cache_geometry(jc)
        assert TKC.kv_cache_bytes(tc) == sum(
            leaf.nbytes for c in jc for f, leaf in vars(c).items()
            if f not in JKC.OVERHEAD_FIELDS)
    m = tc[0]
    assert isinstance(m, TKC.MambaCache) and not TKC.is_ring(m)
    with pytest.raises(TypeError, match="MambaCache"):
        TKC.capacity(m)


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------

def _jax_runs_of(arch):
    """``arch``'s JAX generate results (host values only: mamba2's are
    made in a worker process), first-step logits and decode geometries
    per (routing, batch) of ``RUNS``, one engine."""
    jax.config.update("jax_default_matmul_precision", "highest")
    jcfg, _, jparams, _, toks = _models(arch)
    eng = JaxEngine(jparams, jcfg, max_len=MAX_LEN, prefill_chunk=CH)
    out = {}
    for a, routing, b in RUNS:
        if a != arch:
            continue
        ov = ROUTINGS[routing] if arch == JAMBA else None
        p = toks[:b]
        gen = eng.generate(p, N, routing_override=ov)
        job = eng.prefill_chunked(jnp.asarray(p), ov, reuse=False)
        host = SimpleNamespace(
            tokens=np.asarray(gen.tokens), routing=gen.routing,
            p_fa=None if gen.p_fa is None else np.asarray(gen.p_fa),
            kv_bytes=gen.kv_bytes, dispatches=gen.dispatches)
        out[arch, routing, b] = (host, np.asarray(job.logits),
                                 JKC.cache_geometry(job.caches))
    return out


@pytest.fixture(scope="module")
def jax_runs():
    """JAX generate results, first-step logits and decode geometries per
    (arch, routing, batch) of ``RUNS``: mamba2's in a spawned worker
    while this process makes jamba's."""
    with ProcessPoolExecutor(
            1, mp_context=mp.get_context("spawn")) as pool:
        mamba = pool.submit(_jax_runs_of, MAMBA)
        out = _jax_runs_of(JAMBA)
        out.update(mamba.result())
    return out


@pytest.mark.parametrize("arch,routing,b", RUNS,
                         ids=[f"{a.split('-')[0]}-{r}-B{b}"
                              for a, r, b in RUNS])
def test_generate_matches_jax(jax_runs, arch, routing, b):
    _, tcfg, _, tparams, toks = _models(arch)
    jgen, jlogits, jgeom = jax_runs[arch, routing, b]
    ov = ROUTINGS[routing] if arch == JAMBA else None
    eng = ServeEngine(tparams, tcfg, max_len=MAX_LEN, prefill_chunk=CH,
                      device="cpu")
    gen = eng.generate(toks[:b], N, routing_override=ov)
    if arch == JAMBA and ov is None:
        assert np.all(np.abs(jgen.p_fa - 0.5) > MARGIN), jgen.p_fa
        np.testing.assert_allclose(gen.p_fa, jgen.p_fa, atol=1e-5)
    assert gen.routing == jgen.routing
    assert gen.kv_bytes == jgen.kv_bytes
    assert gen.dispatches == jgen.dispatches
    assert np.array_equal(gen.tokens, np.asarray(jgen.tokens))
    assert float(np.abs(_np(gen.logits) - jlogits).max()) < TOL
    job = eng.prefill_chunked(torch.tensor(toks[:b]), ov, reuse=False)
    assert TKC.cache_geometry(job.caches) == jgeom


@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
@pytest.mark.parametrize("chunk", [7, 64, None], ids=["c7", "over_S",
                                                      "monolithic"])
def test_generate_is_chunk_size_invariant(jax_runs, arch, chunk):
    """Chunks of 7 (a ladder of 7s then 2 and 1: chunks shorter than the
    conv window), one chunk longer than S, and the monolithic repack give
    the JAX chunk-16 run's tokens and first logits."""
    _, tcfg, _, tparams, toks = _models(arch)
    jgen, jlogits, _ = jax_runs[arch, "router", 2]
    eng = ServeEngine(tparams, tcfg, max_len=MAX_LEN, prefill_chunk=chunk,
                      device="cpu")
    gen = eng.generate(toks, N)
    assert gen.routing == jgen.routing
    assert np.array_equal(gen.tokens, np.asarray(jgen.tokens))
    assert float(np.abs(_np(gen.logits) - jlogits).max()) < TOL


def test_mamba2_launches_no_attention():
    """mamba2's prefill, chunks and decode call none of the attention
    kernels' plain versions: no layer of it attends."""
    from repro_torch.core import modes as M
    _, tcfg, _, tparams, toks = _models(MAMBA)
    calls = []
    orig = M.attention
    M.attention = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        eng = ServeEngine(tparams, tcfg, max_len=MAX_LEN, prefill_chunk=CH,
                          device="cpu")
        gen = eng.generate(toks, N)
    finally:
        M.attention = orig
    assert calls == [] and gen.routing == (None, None)
    assert gen.kv_bytes == B * tcfg.num_layers * (
        tcfg.ssm_num_heads * tcfg.ssm_head_dim * tcfg.ssm_state_dim * 4
        + (tcfg.ssm_conv_width - 1) * (tcfg.ssm_inner
                                       + 2 * tcfg.ssm_state_dim) * 4)


# ---------------------------------------------------------------------------
# The slot pool
# ---------------------------------------------------------------------------

DRAIN_LENS = (20, 28, 13, 24)


def _drain(engine, req_cls):
    """Four requests into 2-slot pools in decode chunks of 4; once both
    slots hold a request, a fifth at priority 9 preempts one."""
    _, tcfg, *_ = _models(MAMBA)
    rng = np.random.default_rng(2)
    sched = engine.scheduler(slots_per_bucket=2, chunk=4,
                             prefill_chunks_per_tick=8)
    for rid, n in enumerate(DRAIN_LENS):
        engine.submit(req_cls(rid=rid, tokens=rng.integers(
            0, tcfg.vocab_size, n), n_steps=12))
    for _ in range(4):
        if sched.n_active() == 2:
            break
        engine.step()
    assert sched.n_active() == 2
    engine.submit(req_cls(rid=9, tokens=rng.integers(0, tcfg.vocab_size, 17),
                          n_steps=5, priority=9))
    return engine.drain(), sched


def test_drain_with_preemption_matches_jax():
    jcfg, tcfg, jparams, tparams, _ = _models(MAMBA)
    jeng = JaxEngine(jparams, jcfg, max_len=MAX_LEN, prefill_chunk=CH,
                     memory_ledger=True)
    teng = ServeEngine(tparams, tcfg, max_len=MAX_LEN, prefill_chunk=CH,
                       memory_ledger=True, device="cpu")
    jout, jsched = _drain(jeng, JaxRequest)
    tout, tsched = _drain(teng, Request)
    assert sorted(tout) == sorted(jout)
    for rid in jout:
        assert tout[rid].status == jout[rid].status == STATUS_OK
        assert np.array_equal(tout[rid].tokens, jout[rid].tokens), rid
        assert (tout[rid].metrics.preemptions
                == jout[rid].metrics.preemptions)
    assert sum(f.metrics.preemptions for f in tout.values()) >= 1
    # the ledger's pool bytes hold the SSD state; attention specs: none
    (tpool,), (jpool,) = tsched.pools.values(), jsched.pools.values()
    assert tpool.geometry() == jpool.geometry()
    assert teng._pool_layer_specs(tpool) == jeng._pool_layer_specs(jpool)
    assert teng._pool_layer_specs(tpool) == []
    rep, jrep = teng.ledger_report(), jeng.ledger_report()
    snap, jsnap = rep["snapshot"], jrep["snapshot"]
    snap.pop("t"), jsnap.pop("t")  # each engine's own clock
    assert snap == jsnap
    for key, v in rep["kv_cache_stats"].items():  # JAX adds mesh shards
        assert v == jrep["kv_cache_stats"][key], key
    assert rep["reconciliation"]["payload_delta"] == 0
    assert rep["kv_cache_stats"]["payload_bytes"] == TKC.kv_cache_bytes(
        tpool.caches) > 0


def _fault_drain(tparams, tcfg, fault: bool):
    eng = ServeEngine(tparams, tcfg, max_len=MAX_LEN, prefill_chunk=CH,
                      device="cpu")
    sched = eng.scheduler(slots_per_bucket=3, chunk=2,
                          prefill_chunks_per_tick=8)
    rng = np.random.default_rng(3)
    for rid in range(3):
        eng.submit(Request(rid=rid, tokens=rng.integers(0, tcfg.vocab_size,
                                                        20), n_steps=8))
    for _ in range(4):
        if sched.n_active() == 3:
            break
        eng.step()
    assert sched.n_active() == 3
    eng.step()
    if fault:
        eng.inject_fault(1)
    out = eng.drain()
    (pool,) = sched.pools.values()
    return out, pool


def test_poisoned_slot_leaves_siblings_bitwise():
    """NaN in row 1's SSD state and conv tail: request 1 retires failed,
    rows 0 and 2 decode as without the fault, state and logits bit for
    bit."""
    _, tcfg, _, tparams, _ = _models(MAMBA)
    clean, cpool = _fault_drain(tparams, tcfg, False)
    out, pool = _fault_drain(tparams, tcfg, True)
    assert out[1].status == STATUS_FAILED and len(out[1].tokens) < 8
    for rid in (0, 2):
        assert out[rid].status == STATUS_OK
        assert np.array_equal(out[rid].tokens, clean[rid].tokens)
        assert torch.equal(pool.logits[rid], cpool.logits[rid])
        for c, cc in zip(pool.caches, cpool.caches):
            assert torch.equal(c.h[rid], cc.h[rid])
            assert torch.equal(c.conv_tail[rid], cc.conv_tail[rid])


# ---------------------------------------------------------------------------
# The prefix store
# ---------------------------------------------------------------------------

def test_prefix_store_host_round_trip_matches_jax():
    """A 48-token prompt served cold (publishing its 16-, 32- and
    48-token boundaries), every snapshot offloaded to the host tier, then
    served again: warm tokens, first logits and the restored states equal
    the cold ones bit for bit; the store's stats after each step and the
    snapshot size equal the JAX engine's."""
    jcfg, tcfg, jparams, tparams, _ = _models(MAMBA)
    p = np.random.default_rng(7).integers(0, tcfg.vocab_size,
                                          (1, 48)).astype(np.int32)
    pattern = (None,) * tcfg.num_layers
    need = TPXC.snapshot_spec_bytes(tcfg, pattern, MAX_LEN)
    assert need == JPXC.snapshot_spec_bytes(jcfg, pattern, MAX_LEN)
    store = dict(prefix_cache_mb=need * 3.5 / 2 ** 20,
                 prefix_cache_host_mb=need * 3.5 / 2 ** 20)
    stats = {}
    for side, eng in (
            ("jax", JaxEngine(jparams, jcfg, max_len=MAX_LEN,
                              prefill_chunk=CH, **store)),
            ("port", ServeEngine(tparams, tcfg, max_len=MAX_LEN,
                                 prefill_chunk=CH, device="cpu", **store))):
        cold = eng.generate(p, N)
        s = [eng.prefix_store.stats().as_dict()]
        eng.prefix_store.offload_all()
        s.append(eng.prefix_store.stats().as_dict())
        warm = eng.generate(p, N)
        s.append(eng.prefix_store.stats().as_dict())
        stats[side] = (cold, warm, s, eng)
    (jc, jw, js, _), (tc, tw, ts, teng) = stats["jax"], stats["port"]
    assert ts == js
    assert ts[1]["host_bytes"] > 0 and ts[2]["hits"] == 1
    assert tw.prefix_hit_tokens == jw.prefix_hit_tokens == 48
    assert np.array_equal(tw.tokens, tc.tokens)
    assert np.array_equal(tw.tokens, np.asarray(jw.tokens))
    assert torch.equal(tw.logits, tc.logits)
    cold_eng = ServeEngine(tparams, tcfg, max_len=MAX_LEN, prefill_chunk=CH,
                           device="cpu")
    for boundary in (16, 32):
        ref = cold_eng.prefill_chunked(p[:, :boundary], reuse=False)
        job = teng.start_chunked_prefill(p[:, :boundary])
        assert job.done and job.prefix_hit_tokens == boundary
        for a, b in zip(job.caches, ref.caches):
            assert torch.equal(a.h, b.h)
            assert torch.equal(a.conv_tail, b.conv_tail)
        assert torch.equal(job.logits, ref.logits)


# ---------------------------------------------------------------------------
# Diagnostics
# ---------------------------------------------------------------------------

def test_capture_hidden_and_coverage_match_jax():
    """``capture_hidden`` of mamba2 (every layer a Mamba block) and
    jamba's ``attention_mass_coverage`` (its one routed layer, past
    sink + local) as JAX's."""
    jcfg, tcfg, jparams, tparams, toks = _models(MAMBA)
    want = JMD.capture_hidden(jparams, jcfg, jnp.asarray(toks))
    _close(TMD.capture_hidden(tparams, tcfg, torch.tensor(toks)), want,
           tol=TOL)
    jcfg, tcfg, jparams, tparams, _ = _models(JAMBA)
    L = tcfg.flux.sink + tcfg.flux.local + 9
    prompt = np.random.default_rng(6).integers(0, jcfg.vocab_size,
                                               (1, L)).astype(np.int32)
    want = np.asarray(JMD.attention_mass_coverage(jparams, jcfg,
                                                  jnp.asarray(prompt)))
    got = TMD.attention_mass_coverage(tparams, tcfg, torch.tensor(prompt))
    assert got.shape == (1,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
