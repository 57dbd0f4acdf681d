"""The port's attribution layer: the routing-fidelity probe
(``models.model.attention_mass_coverage`` and the engine's
``_maybe_fidelity_probe``) against the JAX package's, and what the
guardrail and telemetry knobs may not change.

Tolerances: coverage is a float32 softmax sum, so port and JAX agree to
1e-5 (summation order only); everything else is exact. On the CPU the
kernels' plain versions run, so kernel "launches" are counted by
wrapping each module's plain version: with every knob on, the port must
call each kernel exactly as often as with every knob off (the probes
add exactly one flash call per attention layer per probe), and give
bitwise the same tokens.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_variant as jax_smoke  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro_torch import kernels as KN  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.launch.serve import routing_pattern  # noqa: E402
from repro_torch.models import model as MD  # noqa: E402
from repro_torch.serve import telemetry as TTM  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.scheduler import ContinuousScheduler  # noqa: E402
from repro_torch.serve.slo import STATUS_OK, SLOConfig  # noqa: E402

COVERAGE_TOL = 1e-5


def _models(arch):
    jcfg = jax_smoke(jax_get_config(arch))
    tcfg = smoke_variant(get_config(arch))
    jparams = JMD.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              "cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def phi3():
    return _models("phi3-mini-3.8b")


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, 512, n).astype(np.int32)


# ---------------------------------------------------------------------------
# attention_mass_coverage against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,S", [("phi3-mini-3.8b", 27),
                                    ("phi3-mini-3.8b", 61),
                                    ("stablelm-12b", 53)])
def test_coverage_matches_jax_padded_and_unpadded(phi3, arch, S):
    jcfg, tcfg, jparams, tparams = (phi3 if arch == "phi3-mini-3.8b"
                                    else _models(arch))
    toks = _prompt(S, seed=3)
    direct = np.asarray(JMD.attention_mass_coverage(
        jparams, jcfg, jnp.asarray(toks)[None]))
    bucket = 1 << (S - 1).bit_length()
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :S] = toks
    via_pad = np.asarray(JMD.attention_mass_coverage(
        jparams, jcfg, jnp.asarray(padded), length=jnp.int32(S)))
    port = MD.attention_mass_coverage(tparams, tcfg,
                                      torch.as_tensor(toks[None])).numpy()
    assert port.dtype == np.float32
    assert port.shape == (len(tcfg.routable_layers()),)
    np.testing.assert_allclose(port, direct, rtol=0, atol=COVERAGE_TOL)
    np.testing.assert_allclose(port, via_pad, rtol=0, atol=COVERAGE_TOL)
    if S > tcfg.flux.sink + tcfg.flux.local:
        assert (port < 1.0).all()  # the window drops some mass


def test_coverage_is_one_inside_the_sa_window(phi3):
    _, tcfg, _, tparams = phi3
    S = tcfg.flux.sink + tcfg.flux.local  # every key inside the window
    cov = MD.attention_mass_coverage(tparams, tcfg,
                                     torch.as_tensor(_prompt(S)[None]))
    np.testing.assert_allclose(cov.numpy(), 1.0, rtol=0, atol=1e-6)


def test_coverage_under_ta_matches_jax(phi3):
    """Under TriangleMix the last query sits in the dense tail chunk, so
    the JAX probe counts every live key as kept: coverage 1."""
    jcfg, tcfg, jparams, tparams = phi3
    jcfg = jcfg.replace(flux=jcfg.flux.replace(sa_mode="ta"))
    tcfg = tcfg.replace(flux=tcfg.flux.replace(sa_mode="ta"))
    toks = _prompt(tcfg.flux.sink + tcfg.flux.local + 9)[None]
    want = np.asarray(JMD.attention_mass_coverage(jparams, jcfg,
                                                  jnp.asarray(toks)))
    port = MD.attention_mass_coverage(tparams, tcfg,
                                      torch.as_tensor(toks)).numpy()
    np.testing.assert_allclose(port, want, rtol=0, atol=COVERAGE_TOL)
    np.testing.assert_allclose(port, 1.0, rtol=0, atol=1e-6)


def test_coverage_of_mla_matches_jax():
    """deepseek-v2's smoke variant: the probe reads the per-head K of the
    decompressed latent, scaled by (nope + rope) ** -0.5, as JAX's does."""
    jcfg, tcfg, jparams, tparams = _models("deepseek-v2-236b")
    toks = _prompt(tcfg.flux.sink + tcfg.flux.local + 7)[None]
    want = np.asarray(JMD.attention_mass_coverage(jparams, jcfg,
                                                  jnp.asarray(toks)))
    port = MD.attention_mass_coverage(tparams, tcfg,
                                      torch.as_tensor(toks)).numpy()
    assert port.shape == (len(tcfg.routable_layers()),)
    np.testing.assert_allclose(port, want, rtol=0, atol=COVERAGE_TOL)
    assert (port < 1.0).all()


# ---------------------------------------------------------------------------
# Knobs on against off: tokens, kernel calls, probes
# ---------------------------------------------------------------------------

def _counting_plains(monkeypatch):
    """Count each kernel's plain-version calls, by kernel name."""
    calls = {name: 0 for name in KN.KERNELS}
    for name in KN.KERNELS:
        mod = getattr(KN, name)
        plain = getattr(mod, f"{name}_plain")

        def counted(*a, _plain=plain, _name=name, **kw):
            calls[_name] += 1
            return _plain(*a, **kw)
        monkeypatch.setattr(mod, f"{name}_plain", counted)
    return calls


def _drain(tcfg, tparams, **eng_kw):
    """Nine requests, router-driven and the mixed override in turn,
    through 2-slot pools; the last, at priority 9, arrives once the mixed
    pool is full and preempts."""
    eng = ServeEngine(tparams, tcfg, max_len=80, prefill_chunk=16,
                      device="cpu", **eng_kw)
    sched = ContinuousScheduler(eng, slots_per_bucket=2, chunk=3,
                                prefill_chunks_per_tick=3)
    mixed = routing_pattern(tcfg, "mixed")
    for rid in range(8):
        sched.submit(Request(rid=rid, tokens=_prompt(20 + 5 * rid, rid),
                             n_steps=16,
                             routing_override=(None, mixed)[rid % 2]))
    for _ in range(30):  # until the mixed pool is full
        sched.tick()
        if any(p.pattern == mixed and not p.free
               for p in sched.pools.values()):
            break
    sched.submit(Request(rid=8, tokens=_prompt(16, 8), n_steps=7,
                         priority=9, routing_override=mixed))
    out = sched.drain()
    return eng, sched, out


def _prefill_calls(cfg, admissions, chunk):
    """Each prefill kernel's calls for these admissions (no prefix store):
    flash / streaming once per FA / SA layer on the routing chunk,
    block-sparse once per FA layer on every later chunk."""
    from repro_torch.serve.engine import chunk_plan
    want = dict.fromkeys(("flash_attention", "streaming_attention",
                          "block_sparse_attention"), 0)
    for pattern, n, _ in admissions:
        n_fa = sum(p == "fa" for p in pattern)
        want["flash_attention"] += n_fa
        want["streaming_attention"] += cfg.num_layers - n_fa
        want["block_sparse_attention"] += n_fa * (len(chunk_plan(n, chunk))
                                                  - 1)
    return want


@pytest.fixture(scope="module")
def on_off(phi3):
    _, tcfg, _, tparams = phi3
    mp = pytest.MonkeyPatch()
    try:
        runs = {}
        for name, kw in (
                ("off", {}),
                ("on", dict(telemetry=True, memory_ledger=True,
                            profile_every=2, slo=SLOConfig())),
                ("probed", dict(telemetry=True, fidelity_probe_every=1))):
            calls = _counting_plains(mp)
            eng, sched, out = _drain(tcfg, tparams, **kw)
            runs[name] = (eng, sched, out, dict(calls))
            mp.undo()
    finally:
        mp.undo()
    return tcfg, runs


def test_knobs_off_calls_each_kernel_as_the_path_needs(on_off):
    cfg, runs = on_off
    _, sched, out, calls = runs["off"]
    assert all(f.status == STATUS_OK for f in out.values())
    assert sum(f.metrics.preemptions for f in out.values()) >= 1
    want = _prefill_calls(cfg, sched.admissions, 16)
    want.update(decode_attention=0, decode_attention_mla=0,
                decode_attention_pooled=sum(
        p.steps for p in sched.pools.values()) * cfg.num_layers,
                attention_backward=0,  # serving runs no backward
                block_sparse_backward=0,
                # nor, on one device, the sequence-sharded decode
                decode_attention_partial=0, decode_merge_ranks=0)
    assert calls == want


def test_telemetry_on_changes_no_token_and_no_kernel_call(on_off):
    _, runs = on_off
    off, on = runs["off"], runs["on"]
    for rid, f in off[2].items():
        g = on[2][rid]
        assert np.array_equal(f.tokens, g.tokens), rid
        assert (f.routing, f.status, f.metrics.preemptions) == \
            (g.routing, g.status, g.metrics.preemptions)
    assert on[3] == off[3]
    assert on[0].profiler_report()["sampled_ticks"] > 0


def test_probes_change_no_token_and_add_one_flash_per_layer(on_off):
    cfg, runs = on_off
    off, probed = runs["off"], runs["probed"]
    eng = probed[0]
    for rid, f in off[2].items():
        assert np.array_equal(f.tokens, probed[2][rid].tokens), rid
        fid = probed[2][rid].metrics.fidelity
        assert fid is not None and 0.0 <= fid <= 1.0 + COVERAGE_TOL
    n_probes = eng._probe_admissions
    assert n_probes == len(probed[1].admissions)  # every admission
    want = dict(off[3])
    want["flash_attention"] += n_probes * cfg.num_layers
    assert probed[3] == want
    # one engine call per probe on top of the unprobed run's
    assert eng.dispatch_count - off[0].dispatch_count == n_probes


def test_probe_histograms_summary_and_cadence(phi3, on_off):
    _, tcfg, _, tparams = phi3
    _, runs = on_off
    eng, sched, out, _ = runs["probed"]
    samples = TTM.parse_prometheus_text(eng.metrics_text())
    assert "flux_fidelity_coverage" in samples
    summ = eng._drain_summary(out)
    assert summ["fidelity_probed"] == len(out)
    assert 0.0 <= summ["fidelity_min"] <= summ["fidelity_p50"] <= 1.0
    sa = [f for f in out.values()
          if any(p == "sa" for p in f.routing)]
    assert sa and all(f.metrics.fidelity_sa_min is not None for f in sa)
    eng3, _, out3 = _drain(tcfg, tparams, fidelity_probe_every=3)
    probed = [f for f in out3.values() if f.metrics.fidelity is not None]
    assert 0 < len(probed) < len(out3)
    with pytest.raises(ValueError, match=">= 0"):
        ServeEngine(tparams, tcfg, max_len=80, device="cpu",
                    fidelity_probe_every=-1)
