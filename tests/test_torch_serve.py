"""The port's ``ServeEngine.generate`` against the JAX engine's, on the
phi3-mini smoke config with the same weights (``params_from_jax``):
B = 2 prompts of S = 48 tokens, 6 greedy tokens, for router-driven,
all-FA, all-SA and mixed FA/SA routing, through the chunked admission
(chunks of 16, 7 and 64 > S) and the monolithic repack fallback
(``prefill_chunk=None``).

Routing decisions and greedy tokens must be identical; first-step logits
agree to 1e-4 (float32, summation order only). The hard decision is
mean(p_fa) > 0.5 with a strict >, so each router-driven case first
checks that every layer's mean p_fa is more than 1e-3 from 0.5: a tie
broken by rounding would make the comparison meaningless.
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
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.serve.engine import (Request, ServeEngine,  # noqa: E402
                                      serve_batch)

ARCH = "phi3-mini-3.8b"
B, S, N, MAX_LEN = 2, 48, 6, 64
TOL = 1e-4
MARGIN = 1e-3
CHUNKS = [16, 7, 64, None]
PATTERNS = {"router": None, "all_fa": ("fa", "fa"), "all_sa": ("sa", "sa"),
            "mixed": ("fa", "sa")}


def _mixed_pattern(layer_kinds):
    flip, out = True, []
    for k in layer_kinds:
        out.append(("fa" if flip else "sa") if k == "attn" else None)
        flip = not flip if k == "attn" else flip
    return tuple(out)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke(jax_get_config(ARCH))
    tcfg = smoke_variant(get_config(ARCH))
    jparams = JMD.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              "cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                             size=(B, S)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, toks


@pytest.fixture(scope="module")
def jax_runs(models):
    """JAX generate results, one engine per chunk size (its jit caches
    are shared by the four routing patterns)."""
    jcfg, _, jparams, _, toks = models
    out = {}
    for chunk in CHUNKS:
        eng = JaxEngine(jparams, jcfg, max_len=MAX_LEN, prefill_chunk=chunk)
        for name, ov in PATTERNS.items():
            gen = eng.generate(toks, N, routing_override=ov)
            if eng.chunked_eligible(S, ov):
                logits = eng.prefill_chunked(jnp.asarray(toks), ov,
                                             reuse=False).logits
            else:
                logits = eng.prefill_route_repack(jnp.asarray(toks),
                                                  ov)[0].logits
            out[chunk, name] = (gen, np.asarray(logits))
    return out


def test_mixed_pattern_matches_the_chunked_prefill_tests(models):
    assert _mixed_pattern(models[1].layer_kinds) == PATTERNS["mixed"]


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("name", list(PATTERNS))
def test_generate_matches_jax(models, jax_runs, chunk, name):
    _, tcfg, _, tparams, toks = models
    jgen, jlogits = jax_runs[chunk, name]
    eng = ServeEngine(tparams, tcfg, max_len=MAX_LEN, prefill_chunk=chunk,
                      device="cpu")
    gen = eng.generate(toks, N, routing_override=PATTERNS[name])
    if name == "router":
        assert np.all(np.abs(jgen.p_fa - 0.5) > MARGIN), jgen.p_fa
        np.testing.assert_allclose(gen.p_fa, jgen.p_fa, atol=1e-5)
    assert gen.routing == jgen.routing
    assert gen.msr == jgen.msr and gen.kv_bytes == jgen.kv_bytes
    assert np.array_equal(gen.tokens, np.asarray(jgen.tokens))
    assert float(np.abs(gen.logits.numpy() - jlogits).max()) < TOL


def test_router_drives_a_mixed_pattern(jax_runs):
    """The seed's router-driven routing exercises both FA and SA layers,
    so the router cases cover both prefill kernels' paths."""
    assert set(jax_runs[16, "router"][0].routing) == {"fa", "sa"}


def test_serve_batch_buckets_and_trims(models):
    _, tcfg, _, tparams, toks = models
    eng = ServeEngine(tparams, tcfg, max_len=MAX_LEN, prefill_chunk=16,
                      device="cpu")
    whole = eng.generate(toks, N).tokens
    reqs = [Request(rid=i, tokens=toks[i], n_steps=N) for i in range(B)]
    reqs.append(Request(rid=9, tokens=toks[0], n_steps=N,
                        eos_id=int(whole[0, 2])))
    out = serve_batch(eng, reqs)
    # rows 0, 1 and 9 share one bucket (length, n_steps, override), so
    # they are routed by one consensus decision, as one generate call
    assert np.array_equal(out[0], whole[0])
    assert np.array_equal(out[1], whole[1])
    stop = int(np.flatnonzero(whole[0] == whole[0, 2])[0])
    assert np.array_equal(out[9], whole[0, :stop + 1])


def test_bridged_and_native_engines_are_deterministic(models):
    """Serving twice gives the same tokens, from bridged JAX weights and
    from native weights drawn twice from one torch.Generator seed."""
    from repro_torch.models.model import init_params
    _, tcfg, _, tparams, toks = models
    native = [init_params(tcfg, torch.Generator().manual_seed(7), "cpu")
              for _ in range(2)]
    for a, b in ((tparams, tparams), tuple(native)):
        runs = [ServeEngine(p, tcfg, max_len=MAX_LEN, prefill_chunk=16,
                            device="cpu").generate(toks, N)
                for p in (a, b)]
        assert runs[0].routing == runs[1].routing
        assert np.array_equal(runs[0].tokens, runs[1].tokens)
        # not bitwise: the CPU BLAS may split a product over a different
        # number of threads from one call to the next
        assert torch.allclose(runs[0].logits, runs[1].logits, rtol=0,
                              atol=1e-6)


def test_unported_options_raise(models):
    _, tcfg, _, tparams, toks = models
    eng = ServeEngine(tparams, tcfg, max_len=MAX_LEN, device="cpu")
    # sampling is ported: greedy=False without an rng decodes greedily,
    # as the JAX engine does (tests/test_torch_sampling.py samples)
    assert np.array_equal(eng.generate(toks, N, greedy=False).tokens,
                          eng.generate(toks, N).tokens)
    with pytest.raises(ValueError):  # a duo split past the KV heads
        eng.generate(toks, N, routing_override=(
            ("duo", tcfg.num_kv_heads + 1), "fa"))
    with pytest.raises(ValueError):  # prompt longer than the capacity
        eng.generate(np.zeros((1, MAX_LEN + 1), np.int64), 1)
    with pytest.raises(ValueError):  # prompt + new tokens past FullKV
        eng.generate(toks, MAX_LEN - S + 1, routing_override=("fa", "fa"))
