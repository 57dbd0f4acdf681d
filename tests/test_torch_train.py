"""The port's training forward and trainers against the JAX package's, in
float32 on the smoke variants, with the same weights (``params_from_jax``
/ ``train_state_from_jax``), the same batches and JAX's own Gumbel draws
(each routed layer's ``jax.random.gumbel(fold_in(fold_in(rng, pos),
per_idx), (B, 2))``, handed to the port as its (n_routed, B, 2)
``gumbel``).

Held:

- ``forward_train`` for every registered arch (side inputs for
  phi-3-vision and whisper): logits, r_soft and the MoE aux within 1e-5
  of max(1, max |JAX|); the hidden-state output and remat off equal to
  remat on;
- RouterTrainer's router and λ gradients (``jax.value_and_grad`` of the
  JAX step's loss) per leaf within 1e-4 of max |JAX grad| on phi3-mini,
  stablelm-12b, gemma3-12b, granite-moe, deepseek-v2 (MLA: the route
  chunk at Dk != Dv) and phi3-mini under xa at block 64 over 320 tokens
  (the block-sparse entry and its gradient) (Adam's first step is
  ±lr whatever the gradient, so the gradients are held before any
  state); three steps' metrics and the state after them within 1e-5;
  mamba2's unrouted branch (soft_msr NaN, nothing to route);
- one PretrainTrainer step's gradients on granite (the MoE balance term
  included) and one ContinuedTrainer step's on phi3-mini, per leaf
  within 1e-4 of max |JAX grad|, the router bitwise unchanged.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread: as fast at these small shapes, and it leaves the other
# cores to the test processes running beside this one
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ALL_ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_variant as jax_smoke  # noqa: E402
from repro.core import router as JR  # noqa: E402
from repro.core import sparsity as JSP  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro.train import optimizer as JOPT  # noqa: E402
from repro.train import train_loop as JTL  # noqa: E402
from repro_torch.bridge import (params_from_jax,  # noqa: E402
                                train_state_from_jax)
from repro_torch.configs import ALL_ARCHS  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.train import checkpoint  # noqa: E402
from repro_torch.train import train_loop as TTL  # noqa: E402

B, S = 2, 80  # 80 tokens > sink + local (8 + 32): SA differs from FA
FWD_TOL = 1e-5   # relative to max(1, max |JAX|): f32, summation order
GRAD_TOL = 1e-4  # relative to each leaf's max |JAX grad|
STATE_TOL = 1e-5
GRAD_ARCHS = ("phi3-mini-3.8b", "stablelm-12b", "gemma3-12b",
              "granite-moe-3b-a800m", "deepseek-v2-236b",
              "phi3-mini-3.8b xa64")
# a GRAD_ARCHS case past its arch: its SA mode's flux fields and its
# sequence length (xa at the kernel's 64-token tile over 5 blocks, of
# which it keeps 3, so the block-sparse entry and its gradient run)
VARIANTS = {"xa64": (dict(sa_mode="xa", block=64, stride=16,
                          threshold=0.5), 320)}


def _configs(arch):
    name, *variant = arch.split()
    jc, tc = jax_smoke(jax_get_config(name)), smoke_variant(get_config(name))
    if variant:
        kw = VARIANTS[variant[0]][0]
        jc = jc.replace(flux=jc.flux.replace(**kw))
        tc = tc.replace(flux=tc.flux.replace(**kw))
    return jc, tc


def _seq(arch):
    """The case's sequence length: S, or its variant's."""
    variant = arch.split()[1:]
    return VARIANTS[variant[0]][1] if variant else S


def _gumbel(jc, tc, key, batch=B):
    """JAX's per-layer Gumbel draws of ``forward_train`` under ``key``, as
    the port's (n_routed, B, 2) tensor (None when nothing routes)."""
    P = len(jc.layer_pattern)
    routed = TMD.soft_layers(tc)
    if not routed:
        return None
    return torch.from_numpy(np.stack([np.asarray(jax.random.gumbel(
        jax.random.fold_in(jax.random.fold_in(key, i % P), i // P),
        (batch, 2), jnp.float32)) for i in routed]))


def _batch(seed, cfg, seq=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, seq)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, seq)).astype(np.int32)
    mask = (rng.random((B, seq)) < 0.8).astype(np.float32)
    task = np.array([0, 1], np.int32)
    return toks, labels, mask, task


def _side(jc, seed):
    """Side inputs of a VLM / an encoder-decoder: (jax kwargs, port
    kwargs)."""
    rng = np.random.default_rng(seed)
    jkw, tkw = {}, {}
    if jc.num_prefix_tokens:
        pe = rng.normal(size=(B, jc.num_prefix_tokens, jc.d_model))
        jkw["prefix_embeddings"] = pe.astype(np.float32)
    if jc.num_encoder_layers:
        fr = rng.normal(size=(B, jc.encoder_ctx, jc.d_model))
        jkw["encoder_frames"] = fr.astype(np.float32)
    for k_, v_ in list(jkw.items()):
        tkw[k_] = torch.from_numpy(v_)
        jkw[k_] = jnp.asarray(v_)
    return jkw, tkw


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _grad_close(port_tree, jax_tree, cfg):
    """Per leaf within GRAD_TOL of the leaf's max |JAX grad|, the JAX tree
    (stacked by period) carried into the port's layout first."""
    want = checkpoint.flatten(params_from_jax(
        jax.tree.map(np.asarray, jax_tree), cfg, "cpu"))
    got = checkpoint.flatten(port_tree)
    assert got.keys() == want.keys()
    for k in got:
        assert _rel(got[k], want[k].numpy()) <= GRAD_TOL, (k, _rel(
            got[k], want[k].numpy()))
    return len(got)


# ---------------------------------------------------------------------------
# forward_train, every arch
# ---------------------------------------------------------------------------

def test_every_jax_arch_is_registered():
    assert sorted(ALL_ARCHS) == sorted(JAX_ARCHS)


@pytest.fixture(scope="module")
def forward_runs():
    runs = {}
    for arch in ALL_ARCHS:
        jc, tc = _configs(arch)
        jp = JMD.init_params(jax.random.key(0), jc)
        toks = _batch(1, tc)[0]
        key = jax.random.key(7)
        jkw, tkw = _side(jc, 2)
        out = JMD.forward_train(jp, jc, jnp.asarray(toks), rng=key, tau=0.7,
                                **jkw)
        runs[arch] = (tc, params_from_jax(jax.tree.map(np.asarray, jp), tc,
                                          "cpu"),
                      torch.from_numpy(toks), _gumbel(jc, tc, key), tkw,
                      jax.tree.map(np.asarray, out))
    return runs


@pytest.mark.parametrize("arch", sorted(ALL_ARCHS))
def test_forward_train_matches_jax(forward_runs, arch):
    tc, params, toks, gumbel, tkw, want = forward_runs[arch]
    out = TMD.forward_train(params, tc, toks, gumbel=gumbel, tau=0.7, **tkw)
    _close(out.logits, want.logits, FWD_TOL)
    if want.r_soft is None:
        assert out.r_soft is None and not TMD.soft_layers(tc)
    else:
        assert out.r_soft.shape == (B, len(TMD.soft_layers(tc)))
        _close(out.r_soft, want.r_soft, FWD_TOL)
    assert sorted(out.aux) == sorted(want.aux)
    for k, v in want.aux.items():
        _close(out.aux[k], v, FWD_TOL)


def test_forward_train_hidden_and_remat(forward_runs):
    """``output_hidden`` gives the final-normed hidden states the logits
    come from; remat changes no value."""
    tc, params, toks, gumbel, tkw, want = forward_runs["phi3-mini-3.8b"]
    hid = TMD.forward_train(params, tc, toks, gumbel=gumbel, tau=0.7,
                            output_hidden=True)
    _close(hid.logits @ TMD.unembed_matrix(params, tc), want.logits,
           FWD_TOL)
    flat = TMD.forward_train(params, tc, toks, gumbel=gumbel, tau=0.7,
                             output_hidden=True, remat=False)
    assert torch.equal(flat.logits, hid.logits)
    assert torch.equal(flat.r_soft, hid.r_soft)
    fa = TMD.forward_train(params, tc, toks, tau=0.7)  # no noise: all FA
    assert fa.r_soft is None
    with pytest.raises(ValueError, match="one \\(B, 2\\) sample"):
        TMD.forward_train(params, tc, toks, gumbel=gumbel[:1], tau=0.7)


# ---------------------------------------------------------------------------
# RouterTrainer
# ---------------------------------------------------------------------------

def _jax_router_loss(rt, state, toks, labels, mask, task, key):
    """``RouterTrainer.step_impl``'s loss_fn and ``jax.value_and_grad``
    over (trainable, lagrange)."""
    cfg = rt.cfg
    routed = bool(cfg.routable_layers()) and cfg.flux.enabled
    tau = JR.anneal_tau(cfg.flux, state["step"], rt.total_steps)

    def loss_fn(trainable, lagrange):
        params = JOPT.combine(trainable, state["frozen"])
        out = JMD.forward_train(params, cfg, toks, rng=key, tau=tau,
                                output_hidden=True)
        ce = JTL.chunked_cross_entropy(
            out.logits, JMD.unembed_matrix(params, cfg), labels, mask)
        sp = (JSP.sparsity_loss(out.r_soft, task, lagrange, cfg.flux)[0]
              if routed else 0.0)
        return ce + sp
    return jax.value_and_grad(loss_fn, argnums=(0, 1))(
        state["trainable"], state["lagrange"])


@pytest.fixture(scope="module")
def router_runs():
    """Per arch of GRAD_ARCHS: both trainers, both states from one JAX
    init, and JAX's loss and gradients of one batch."""
    runs = {}
    for arch in GRAD_ARCHS:
        jc, tc = _configs(arch)
        jrt = JTL.RouterTrainer(jc, total_steps=3)
        js = jrt.init(JMD.init_params(jax.random.key(0), jc),
                      jax.random.key(1))
        key = jax.random.key(10)
        batch = _batch(3, tc, _seq(arch))
        loss, grads = _jax_router_loss(jrt, js, *map(jnp.asarray, batch),
                                       key)
        runs[arch] = (jrt, js, TTL.RouterTrainer(tc, total_steps=3),
                      train_state_from_jax(jax.tree.map(np.asarray, js), tc,
                                           "cpu"),
                      batch, key, float(loss), grads)
    return runs


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_router_gradients_match_jax(router_runs, arch):
    jrt, js, trt, ts, batch, key, jloss, (jg, jgl) = router_runs[arch]
    loss, metrics, g_router, g_lagrange = trt.loss_and_grads(
        ts, *map(torch.from_numpy, batch),
        gumbel=_gumbel(jrt.cfg, trt.cfg, key))
    assert abs(float(loss) - jloss) <= FWD_TOL * max(1.0, abs(jloss))
    n = _grad_close(g_router, jg, trt.cfg)
    assert n == 6 * len(TMD.soft_layers(trt.cfg))  # every router leaf
    for k in ("lambda1", "lambda2"):
        assert _rel(g_lagrange[k], jgl[k]) <= GRAD_TOL
        assert float(g_lagrange[k].abs().max()) > 0


def _metrics_close(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        g, w = got[k].detach().cpu().numpy(), np.asarray(v)
        assert np.array_equal(np.isnan(g), np.isnan(w)), k
        assert np.abs(np.where(np.isnan(w), 0.0, g - w)).max() \
            <= STATE_TOL, k


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "mamba2-780m"])
def test_router_steps_match_jax(router_runs, arch):
    """Three steps: the metrics after each and the whole state after
    them. mamba2 has no routed layer: JAX's unrouted branch (no
    sparsity term, soft_msr NaN, λ unchanged by zero gradients)."""
    if arch in router_runs:
        jrt, js, trt, ts = router_runs[arch][:4]
    else:
        jc, tc = _configs(arch)
        jrt = JTL.RouterTrainer(jc, total_steps=3)
        js = jrt.init(JMD.init_params(jax.random.key(0), jc),
                      jax.random.key(1))
        trt = TTL.RouterTrainer(tc, total_steps=3)
        ts = train_state_from_jax(jax.tree.map(np.asarray, js), tc, "cpu")
    for i in range(3):
        batch = _batch(20 + i, trt.cfg)
        key = jax.random.key(30 + i)
        js, jm = jrt.step(js, *map(jnp.asarray, batch), key)
        ts, tm = trt.step(ts, *map(torch.from_numpy, batch),
                          gumbel=_gumbel(jrt.cfg, trt.cfg, key))
        _metrics_close(tm, jm)
        assert np.isnan(float(tm["soft_msr"])) == (arch == "mamba2-780m")
    want = checkpoint.flatten(train_state_from_jax(
        jax.tree.map(np.asarray, js), trt.cfg, "cpu"))
    got = checkpoint.flatten(ts)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        assert float((got[k].double() - want[k].double()).abs().max()) \
            <= STATE_TOL, k
    assert int(ts["step"]) == 3 and int(ts["opt_router"].count) == 3


# ---------------------------------------------------------------------------
# PretrainTrainer and ContinuedTrainer
# ---------------------------------------------------------------------------

def test_pretrain_gradients_match_jax():
    """granite (MoE): the loss ce + 0.01 · Σ balance over the periods, the
    gradient of every leaf (the unused routers' zeros included: flux_soft
    off), then one update."""
    jc, tc = _configs("granite-moe-3b-a800m")
    jp = JMD.init_params(jax.random.key(0), jc)
    toks, labels, mask, _ = _batch(4, tc)
    key = jax.random.key(11)

    def loss_fn(params):
        out = JMD.forward_train(params, jc, jnp.asarray(toks), rng=key,
                                flux_soft=False, tau=1.0)
        ce = JTL.cross_entropy(out.logits, jnp.asarray(labels),
                               jnp.asarray(mask))
        return ce + 0.01 * JTL._sum_aux(out.aux, "moe_balance")
    jloss, jg = jax.value_and_grad(loss_fn)(jp)
    pt = TTL.PretrainTrainer(tc, total_steps=3)
    st = pt.init(params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu"))
    loss, metrics, grads = pt.loss_and_grads(
        st, *map(torch.from_numpy, (toks, labels, mask)),
        gumbel=_gumbel(jc, tc, key))
    assert abs(float(loss) - float(jloss)) <= FWD_TOL * abs(float(jloss))
    assert float(metrics["bal"]) > 0
    _grad_close(grads, jg, tc)
    new, m = pt.update(st, loss, metrics, grads)
    assert int(new["step"]) == 1 and float(m["loss"]) == float(loss)


def test_continued_gradients_match_jax():
    """phi3-mini: the backbone's gradients under soft routing at tau_end
    with the router frozen, then one update leaving the router bitwise
    as it was."""
    jc, tc = _configs("phi3-mini-3.8b")
    jp = JMD.init_params(jax.random.key(0), jc)
    jct = JTL.ContinuedTrainer(jc, total_steps=3)
    jstate = jct.init(jp)
    toks, labels, mask, _ = _batch(5, tc)
    key = jax.random.key(12)

    def loss_fn(backbone):
        params = JOPT.combine(jstate["router"], backbone)
        out = JMD.forward_train(params, jc, jnp.asarray(toks), rng=key,
                                tau=jc.flux.tau_end)
        return JTL.cross_entropy(out.logits, jnp.asarray(labels),
                                 jnp.asarray(mask))
    jloss, jg = jax.value_and_grad(loss_fn)(jstate["backbone"])
    ct = TTL.ContinuedTrainer(tc, total_steps=3)
    st = ct.init(params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu"))
    loss, metrics, grads = ct.loss_and_grads(
        st, *map(torch.from_numpy, (toks, labels, mask)),
        gumbel=_gumbel(jc, tc, key))
    assert abs(float(loss) - float(jloss)) <= FWD_TOL * abs(float(jloss))
    _grad_close(grads, jg, tc)
    new, _ = ct.update(ct.update(st, metrics, grads)[0], metrics, grads)
    router = checkpoint.flatten(st["router"])
    assert router and all(torch.equal(a, router[k]) for k, a in
                          checkpoint.flatten(new["router"]).items())
    # step 0 runs at the warmup's lr 0; step 1 moves the backbone
    assert not torch.equal(new["backbone"]["embed"], st["backbone"]["embed"])
