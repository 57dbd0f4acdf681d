"""Sampled decoding in the port (``models.model.sample_categorical``,
``decode_many(greedy=False, generator=...)`` and ``ServeEngine.generate
(greedy=False, rng=...)``) against the JAX package's rules.

``jax.random`` and ``torch.Generator`` give different bits from one seed,
so the draws cannot match bit for bit. What must hold, and is tested:
``rng=None`` decodes greedily, as the JAX engine does; one seed gives the
same tokens twice and two seeds differ; and the sampler's frequencies
over 20,000 draws from fixed logits lie within 4 standard deviations of
softmax(logits) (a binomial count's, sqrt(n p (1 - p)), per token), as
``jax.random.categorical``'s do on the same logits.
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
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.models import model as MD  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

ARCH = "granite-moe-3b-a800m"
B, S, N, MAX_LEN = 2, 40, 8, 64
DRAWS = 20_000
LOGITS = np.array([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, 1.5, -3.0], np.float32)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke(jax_get_config(ARCH))
    tcfg = smoke_variant(get_config(ARCH))
    jparams = JMD.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              "cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                             size=(B, S)).astype(np.int32)
    eng = ServeEngine(tparams, tcfg, max_len=MAX_LEN, prefill_chunk=16,
                      device="cpu")
    return jcfg, jparams, eng, toks


def test_no_rng_decodes_greedily(models):
    """``greedy=False`` without an rng is greedy, in the port and in the
    JAX engine alike, and the port's greedy tokens are JAX's."""
    jcfg, jparams, eng, toks = models
    greedy = eng.generate(toks, N).tokens
    assert np.array_equal(eng.generate(toks, N, greedy=False).tokens,
                          greedy)
    assert np.array_equal(
        eng.generate(toks, N, greedy=False, rng=None).tokens, greedy)
    jeng = JaxEngine(jparams, jcfg, max_len=MAX_LEN, prefill_chunk=16)
    jgreedy = np.asarray(jeng.generate(toks, N).tokens)
    assert np.array_equal(
        np.asarray(jeng.generate(toks, N, greedy=False).tokens), jgreedy)
    assert np.array_equal(greedy, jgreedy)


def test_one_seed_gives_the_same_tokens(models):
    """An int seed and a generator seeded alike give the same tokens,
    twice; another seed gives others."""
    _, _, eng, toks = models
    runs = [eng.generate(toks, N, greedy=False, rng=seed).tokens
            for seed in (7, 7, 8)]
    by_gen = eng.generate(toks, N, greedy=False,
                          rng=torch.Generator().manual_seed(7)).tokens
    assert np.array_equal(runs[0], runs[1])
    assert np.array_equal(runs[0], by_gen)
    assert not np.array_equal(runs[0], runs[2])
    # with random weights the logits are nearly flat: sampling departs
    # from greedy
    assert not np.array_equal(runs[0], eng.generate(toks, N).tokens)


def test_two_seeds_differ_at_flat_logits():
    flat = torch.zeros((64, 512))
    a = MD.sample_categorical(flat, torch.Generator().manual_seed(0))
    b = MD.sample_categorical(flat, torch.Generator().manual_seed(1))
    again = MD.sample_categorical(flat, torch.Generator().manual_seed(0))
    assert a.dtype == torch.int64 and a.shape == (64,)
    assert torch.equal(a, again) and not torch.equal(a, b)
    assert int((a != b).sum()) > 48  # 1/512 to agree per row
    assert 0 <= int(a.min()) and int(a.max()) < 512


def _within_4_sigma(draws):
    p = np.exp(LOGITS - LOGITS.max())
    p /= p.sum()
    counts = np.bincount(np.asarray(draws).reshape(-1), minlength=p.size)
    sigma = np.sqrt(DRAWS * p * (1 - p))
    return np.abs(counts - DRAWS * p) / sigma


def test_sampler_frequencies_follow_softmax():
    """20,000 draws from fixed logits (V = 8), one a row: each token's
    count within 4 sigma of softmax's, as jax.random.categorical's."""
    rows = torch.from_numpy(LOGITS)[None].expand(DRAWS, -1)
    port = MD.sample_categorical(rows, torch.Generator().manual_seed(0))
    z = _within_4_sigma(port.numpy())
    assert z.max() < 4, z
    jdraws = jax.random.categorical(jax.random.key(0),
                                    jnp.asarray(LOGITS), shape=(DRAWS,))
    zj = _within_4_sigma(jdraws)
    assert zj.max() < 4, zj
    # not a sampler that only reproduces the argmax
    assert len(np.unique(port.numpy())) == LOGITS.size


def test_decode_many_samples_per_row_per_step(models):
    """decode_many(greedy=False) draws from the logits before each step:
    its first token is sample_categorical's draw from the prefill logits
    with the same seed; without a generator it raises."""
    _, _, eng, toks = models
    job = eng.prefill_chunked(toks)
    logits = job.logits.clone()
    first = MD.sample_categorical(logits, torch.Generator().manual_seed(3))
    out, _, _ = MD.decode_many(eng.params, eng.cfg, job.logits, job.caches,
                               S, n_steps=3, greedy=False,
                               generator=torch.Generator().manual_seed(3))
    assert out.shape == (B, 3)
    assert torch.equal(out[:, 0], first)
    job = eng.prefill_chunked(toks)
    with pytest.raises(ValueError, match="generator"):
        MD.decode_many(eng.params, eng.cfg, job.logits, job.caches, S,
                       n_steps=1, greedy=False)
