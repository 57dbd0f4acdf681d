"""The port's serving of stablelm-12b and command-r-plus-104b against the
JAX engine's, on narrow variants of both with the same weights
(``params_from_jax``):

- each arch's ``smoke_variant`` (head dim 32, 4 heads over 2 KV heads);
- stablelm at head dim 160 with G = 4 (8 heads over 2 KV heads), the
  head dim and grouping of the full model, which ``smoke_variant``
  forces to 32;
- command-r at G = 12 (12 heads over 1 KV head) with its tied
  embeddings (no ``out_w``).

Each variant is made the same way in both packages: ``smoke_variant`` of
the registered config, then the same ``replace``. Through ``generate``
(chunks of 16, and the monolithic repack) and through a small slot-pool
drain: routing identical, greedy tokens identical, first-step logits
within 1e-4 (float32 on both sides, summation order only). The router's
hard decision is mean(p_fa) > 0.5 with a strict >, so every
router-driven case first checks that each layer's mean p_fa is more than
1e-3 from 0.5. The CUDA entries take head dims 160 and 256 and refuse
an unbuilt one before any launch.
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
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.models import model as MD  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.scheduler import STATUS_OK  # noqa: E402

B, S, N, MAX_LEN = 2, 48, 6, 64
TOL = 1e-4
MARGIN = 1e-3
CHUNKS = [16, None]
MIXED = ("fa", "sa")
VARIANTS = {  # name: (arch, what replaces the smoke variant's widths)
    "stablelm_smoke": ("stablelm-12b", {}),
    "stablelm_d160_g4": ("stablelm-12b",
                         dict(num_heads=8, num_kv_heads=2, head_dim=160)),
    "command_r_smoke": ("command-r-plus-104b", {}),
    "command_r_g12_tied": ("command-r-plus-104b",
                           dict(num_heads=12, num_kv_heads=1)),
}
DRAIN_LENS = (20, 28, 36, 24)


def _configs(name):
    arch, kw = VARIANTS[name]
    return (jax_smoke(jax_get_config(arch)).replace(**kw),
            smoke_variant(get_config(arch)).replace(**kw))


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant(request):
    """(name, JAX config, port config, JAX params, port params, prompts)
    for one variant."""
    jcfg, tcfg = _configs(request.param)
    jparams = JMD.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              "cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                             size=(B, S)).astype(np.int32)
    return request.param, jcfg, tcfg, jparams, tparams, toks


def test_variants_keep_the_arch_geometry():
    """The narrow variants keep what the full configs bring to the
    kernels: stablelm's head dim 160 at G = 4, command-r's tied embeddings
    at G = 12, and the same shapes in both packages."""
    for name in VARIANTS:
        jcfg, tcfg = _configs(name)
        for key in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                    "head_dim", "d_ff", "vocab_size", "rope_theta",
                    "tie_embeddings"):
            assert getattr(jcfg, key) == getattr(tcfg, key), (name, key)
    full = get_config("stablelm-12b")
    assert (full.head_dim, full.num_heads // full.num_kv_heads) == (160, 4)
    d160 = _configs("stablelm_d160_g4")[1]
    assert (d160.head_dim, d160.num_heads // d160.num_kv_heads) == (160, 4)
    g12 = _configs("command_r_g12_tied")[1]
    assert g12.num_heads // g12.num_kv_heads == 12 and g12.tie_embeddings
    full = get_config("command-r-plus-104b")
    assert full.tie_embeddings and full.rope_theta == 75e6


def test_bridge_with_and_without_out_w(variant):
    """Every leaf bridged bit for bit; stablelm keeps its own unembedding
    ``out_w``, command-r ties it to the embedding and has none."""
    name, jcfg, tcfg, jparams, tparams, _ = variant
    assert ("out_w" in tparams) == (not tcfg.tie_embeddings)
    assert tcfg.tie_embeddings == name.startswith("command_r")
    np.testing.assert_array_equal(tparams["embed"].numpy(),
                                  np.asarray(jparams["embed"]))
    unembed = MD.unembed_matrix(tparams, tcfg)
    want = (np.asarray(jparams["embed"]).T if tcfg.tie_embeddings
            else np.asarray(jparams["out_w"]))
    np.testing.assert_array_equal(unembed.numpy(), want)
    for i, layer in enumerate(tparams["layers"]):
        for key in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(
                layer["attn"][key].numpy(),
                np.asarray(jparams["trunk"][0]["attn"][key])[i])
    assert tparams["layers"][0]["attn"]["wk"].shape == (
        tcfg.d_model, tcfg.num_kv_heads * tcfg.head_dim)


@pytest.fixture(scope="module")
def jax_runs(variant):
    """JAX generate results and first-step logits, one engine per chunk
    size, router-driven and mixed."""
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
def test_generate_matches_jax(variant, jax_runs, chunk, override):
    _, _, tcfg, _, tparams, toks = variant
    jgen, jlogits = jax_runs[chunk, override]
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


def _drain(engine, specs, req_cls):
    engine.scheduler(slots_per_bucket=2, chunk=4)
    for rid, toks, ov in specs:
        engine.submit(req_cls(rid=rid, tokens=toks, n_steps=5,
                              routing_override=ov))
    return engine.drain()


def test_drain_matches_jax(variant):
    """Four requests of 20-36 tokens, router-driven and mixed in turn,
    through 2-slot pools in decode chunks of 4 (the pooled decode)."""
    _, jcfg, tcfg, jparams, tparams, _ = variant
    rng = np.random.default_rng(2)
    specs = [(i, rng.integers(0, jcfg.vocab_size, n),
              (None, MIXED)[i % 2]) for i, n in enumerate(DRAIN_LENS)]
    jout = _drain(JaxEngine(jparams, jcfg, max_len=MAX_LEN), specs,
                  JaxRequest)
    tout = _drain(ServeEngine(tparams, tcfg, max_len=MAX_LEN, device="cpu"),
                  specs, Request)
    for rid, *_ in specs:
        assert tout[rid].status == jout[rid].status == STATUS_OK
        assert tout[rid].routing == jout[rid].routing, rid
        assert np.array_equal(tout[rid].tokens, jout[rid].tokens), rid


@pytest.mark.parametrize("D,ok", [(160, True), (256, True), (48, False)])
def test_cuda_entries_take_head_dim_160_and_refuse_256(monkeypatch, D, ok):
    """With the device test answering "cuda", each of the five entries
    launches its kernel at the built head dims 160 (stablelm) and 256
    (gemma3's), G = 4, and raises at an unbuilt one (48), naming the
    widths it is built for, before any launch."""
    from repro_torch.kernels import (_build, block_sparse_attention,
                                     decode_attention,
                                     decode_attention_pooled,
                                     flash_attention, streaming_attention)
    mods = (flash_attention, streaming_attention, block_sparse_attention,
            decode_attention, decode_attention_pooled)
    launched = []
    monkeypatch.setattr(_build, "on_cpu", lambda name, t: False)
    monkeypatch.setattr(decode_attention, "sm_count", lambda index: 132)
    for m in mods:
        monkeypatch.setattr(m.KERNEL, "launch",
                            lambda dev, *a, _m=m: launched.append(_m))
    q, kv = torch.zeros((8, 64, D)), torch.zeros((2, 64, D))
    qd = torch.zeros((8, 1, D))
    calls = [
        lambda: flash_attention.flash_attention_bh(q, kv, kv),
        lambda: streaming_attention.streaming_attention_bh(
            q, kv, kv, sink=4, local=8),
        lambda: block_sparse_attention.block_sparse_attention_bh(
            q, kv, kv, torch.zeros((8, 1, 1), dtype=torch.int32)),
        lambda: decode_attention.decode_attention_bh(
            qd, kv, kv, torch.arange(64, dtype=torch.int32), 9),
        lambda: decode_attention_pooled.decode_attention_pooled_bh(
            qd, kv, kv, None, torch.tensor([64], dtype=torch.int32),
            n_heads=8),
    ]
    for call in calls:
        if ok:
            call()
        else:
            with pytest.raises((ValueError, NotImplementedError),
                               match=r"built for .*160, 256\)"):
                call()
    assert launched == (list(mods) if ok else [])
