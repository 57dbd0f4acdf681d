"""The port's slot-pool decode path against the JAX package's, on the same
numpy inputs and weights (``repro_torch.bridge.params_from_jax``) at the
phi3-mini smoke size (2 layers, d_model 256, 4 heads, head_dim 32,
float32, sink 8, local 32):

- the pooled decode entry (CPU: its plain version) against the Pallas
  ``decode_attention_pooled_bh`` in interpret mode, at 2e-5 (the same
  masked softmax in float32, summed in another order);
- the per-row cache inserts, ``slot_geometry`` and RoPE at (B, S)
  positions, exactly;
- ``decode_core`` / ``decode_many`` with one position per row, logits
  within 1e-4 and tokens identical;
- the CUDA wrapper's operand checks.
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
from repro.kernels.decode_attention import \
    decode_attention_pooled_bh as jax_pooled  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro.serve import kv_cache as JKC  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.kernels import _build, launch_counts  # noqa: E402
from repro_torch.kernels import decode_attention_pooled as TP  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.serve import kv_cache as TKC  # noqa: E402

ARCH = "phi3-mini-3.8b"
KTOL = 2e-5
TOL = 1e-4
MAX_LEN = 64


def t(x):
    return torch.from_numpy(np.array(x))


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# The pooled decode entry against the Pallas kernel
# ---------------------------------------------------------------------------

def _ring_positions(rng, lengths, L, hole):
    """Per-slot ring positions: the first n entries hold distinct
    absolute positions in shuffled order, a ``hole`` share of them
    re-marked -1 (never all of a live row), the rest -1."""
    pos = np.full((len(lengths), L), -1, np.int32)
    for b, n in enumerate(lengths):
        n = min(n, L)
        pos[b, :n] = rng.permutation(3 * L)[:n]
        if n > 1:
            cut = rng.random(n) < hole
            cut[rng.integers(n)] = False
            pos[b, :n][cut] = -1
    return pos


# (B, Hq, Hkv, L, Dk, Dv, lengths, ring, scale, block_k)
POOLED_CASES = {
    "ragged_full_unaligned": (4, 4, 4, 100, 32, 32, (1, 33, 99, 100),
                              False, None, 32),
    "gqa_g4": (3, 8, 2, 130, 16, 16, (64, 65, 130), False, None, 64),
    "ring_with_holes": (4, 4, 4, 72, 32, 32, (5, 40, 72, 90), True, None,
                        16),
    "length_zero_row": (3, 4, 2, 48, 32, 32, (0, 17, 48), True, None, 16),
    "dk_ne_dv_scale": (3, 4, 1, 40, 48, 32, (2, 17, 40), False, 64 ** -0.5,
                       16),
}


@pytest.mark.parametrize("name", list(POOLED_CASES))
def test_pooled_entry_matches_pallas(name):
    B, Hq, Hkv, L, Dk, Dv, lengths, ring, scale, bk = POOLED_CASES[name]
    rng = np.random.default_rng(len(name))
    q = rng.normal(size=(B * Hq, 1, Dk)).astype(np.float32)
    k = rng.normal(size=(B * Hkv, L, Dk)).astype(np.float32)
    v = rng.normal(size=(B * Hkv, L, Dv)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    if ring:
        pos = _ring_positions(rng, lengths, L, hole=0.3)
    else:
        pos = np.broadcast_to(np.arange(L, dtype=np.int32), (B, L)).copy()
    want = np.asarray(jax_pooled(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(pos),
                                 jnp.asarray(lens), n_heads=Hq, scale=scale,
                                 block_k=bk, interpret=True))
    got = TP.decode_attention_pooled_bh(t(q), t(k), t(v),
                                        None if not ring else t(pos),
                                        t(lens), n_heads=Hq, scale=scale)
    assert got.shape == (B * Hq, 1, Dv)
    assert float(np.abs(got.numpy() - want).max()) < KTOL
    empty = np.repeat(lens == 0, Hq)
    assert not got.numpy()[empty].any()  # a length-0 slot gives zeros


def test_lengths_past_capacity_are_clamped():
    """A FullKV row whose last decode chunk ran past the capacity has
    length > L: it sees the whole buffer, as JAX's clamp gives."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((8, 1, 32), (8, 24, 32), (8, 24, 32)))
    lens = np.asarray([24, 30], np.int32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24)).copy()
    want = np.asarray(jax_pooled(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(pos),
                                 jnp.asarray(lens), n_heads=4, block_k=16,
                                 interpret=True))
    got = TP.decode_attention_pooled_bh(t(q), t(k), t(v), None, t(lens),
                                        n_heads=4)
    assert float(np.abs(got.numpy() - want).max()) < KTOL
    at_cap = TP.decode_attention_pooled_bh(
        t(q), t(k), t(v), None, torch.full((2,), 24, dtype=torch.int32),
        n_heads=4)
    assert torch.equal(got, at_cap)


# ---------------------------------------------------------------------------
# Per-row inserts, slot geometry, RoPE
# ---------------------------------------------------------------------------

def _pair(kind, B, Hkv, L, D):
    z = np.zeros((B, Hkv, L, D), np.float32)
    if kind == "ring":
        pos = np.full((B, L), -1, np.int32)
        return (JKC.RingKV(k=jnp.asarray(z), v=jnp.asarray(z),
                           positions=jnp.asarray(pos),
                           length=jnp.zeros((B,), jnp.int32)),
                TKC.RingKV(k=t(z), v=t(z), positions=t(pos),
                           length=torch.zeros((B,), dtype=torch.int32)))
    return (JKC.FullKV(k=jnp.asarray(z), v=jnp.asarray(z),
                       length=jnp.zeros((B,), jnp.int32)),
            TKC.FullKV(k=t(z), v=t(z),
                       length=torch.zeros((B,), dtype=torch.int32)))


@pytest.mark.parametrize("kind", ["full", "ring"])
def test_per_row_inserts_match_jax(kind):
    """Three rows at their own positions, several steps; the FullKV's
    last row runs past its capacity of 16, where JAX's scatter drops the
    write and the port must drop it too (and raise nothing)."""
    B, Hkv, L, D, sink, local = 3, 2, 16, 4, 3, 13
    j, tc = _pair(kind, B, Hkv, L, D)
    pos = np.asarray([0, 7, 14], np.int32)
    for step in range(5):
        kn, vn = _rand(20 + step, B, Hkv, 1, D), _rand(40 + step, B, Hkv, 1,
                                                       D)
        p = pos + step
        if kind == "ring":
            j = JKC.ring_insert(j, kn, vn, jnp.asarray(p), sink, local)
            TKC.ring_insert(tc, t(kn), t(vn), t(p), sink, local)
        else:
            j = JKC.full_insert(j, kn, vn, jnp.asarray(p))
            TKC.full_insert(tc, t(kn), t(vn), t(p))
        for a, b in zip(TKC.cache_fields(tc), jax.tree.leaves(j)):
            assert np.array_equal(a.numpy(), np.asarray(b))
    assert int(tc.length[2]) == 19  # pos + 1 past the capacity, as JAX
    slots = TKC.ring_slot(t(np.arange(40, dtype=np.int32)), sink, local)
    assert np.array_equal(slots.numpy(), np.asarray(JKC.ring_slot(
        jnp.arange(40, dtype=jnp.int32), sink, local)))


def test_slot_geometry_spelled_as_jax():
    jcfg, tcfg = jax_smoke(jax_get_config(ARCH)), smoke_variant(
        get_config(ARCH))
    for pattern in (("fa", "sa"), ("sa", "sa")):
        for batch in (1, 3):
            jc = JKC.init_decode_caches(jcfg, pattern, batch, MAX_LEN)
            tc = TKC.init_decode_caches(tcfg, pattern, batch, MAX_LEN,
                                        "cpu")
            assert TKC.slot_geometry(tc) == JKC.slot_geometry(jc)
            assert TKC.cache_geometry(tc) == JKC.cache_geometry(jc)
        assert TKC.slot_geometry(TKC.init_decode_caches(
            tcfg, pattern, 1, MAX_LEN, "cpu")) == TKC.slot_geometry(tc)


def test_apply_rope_per_row_positions():
    x = _rand(5, 3, 4, 2, 32)
    pos = np.asarray([[0, 1], [17, 18], [40, 3]], np.int32)
    want = np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    got = TL.apply_rope(t(x), t(pos), 1e4).numpy()
    assert float(np.abs(got - want).max()) < 1e-5
    # each row rotated by its own angles, not a neighbour's
    for b in range(3):
        row = TL.apply_rope(t(x[b:b + 1]), t(pos[b]), 1e4).numpy()
        assert np.array_equal(got[b:b + 1], row)


# ---------------------------------------------------------------------------
# decode_core / decode_many with one position per row
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    jcfg = jax_smoke(jax_get_config(ARCH))
    tcfg = smoke_variant(get_config(ARCH))
    jparams = JMD.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              "cpu")
    return jcfg, tcfg, jparams, tparams


# prompt lengths of the pool's rows: ragged, one past the ring's wrap
# (sink + local = 40), and one row parked at position 0 like a free slot
LENS = (20, 44, 33)


def _pool(setup, pattern):
    """Both packages' (B = 3) pool caches: each row seeded from its own
    B = 1 fixed-routing prefill (JAX), the port's a copy of JAX's."""
    jcfg, _, jparams, _ = setup
    fixed = jnp.asarray([1 if p == "fa" else 0 for p in pattern])
    rows = []
    for i, n in enumerate(LENS):
        toks = np.random.default_rng(30 + i).integers(0, 512, (1, n))
        pf = JMD.prefill(jparams, jcfg, jnp.asarray(toks),
                         routing_ctx="fixed", fixed_pattern=fixed)
        rows.append(JE.seed_caches(jcfg, pf.caches, pattern, 1, MAX_LEN))
    jc = [jax.tree.map(lambda *a: jnp.concatenate(a), *layer)
          for layer in zip(*rows)]
    tc = [TKC.RingKV(k=t(c.k), v=t(c.v), positions=t(c.positions),
                     length=t(c.length)) if isinstance(c, JKC.RingKV)
          else TKC.FullKV(k=t(c.k), v=t(c.v), length=t(c.length))
          for c in jc]
    return jc, tc


def _same(tc, jc):
    for a, b in zip(tc, jc):
        assert float(np.abs(a.k.numpy() - np.asarray(b.k)).max()) < TOL
        assert np.array_equal(a.length.numpy(), np.asarray(b.length))
        if isinstance(a, TKC.RingKV):
            assert np.array_equal(a.positions.numpy(),
                                  np.asarray(b.positions))


@pytest.mark.parametrize("pattern", [("fa", "sa"), ("sa", "fa")])
def test_decode_core_per_row(setup, pattern):
    jcfg, tcfg, jparams, tparams = setup
    jc, tc = _pool(setup, pattern)
    pos = np.asarray([LENS[0], LENS[1], 0], np.int32)  # row 2 parked
    tok = np.array([[3], [7], [11]])
    for step in range(3):
        jl, jc = JMD.decode_core(jparams, jcfg, jnp.asarray(tok), jc,
                                 jnp.asarray(pos + step))
        tl, tc = TMD.decode_core(tparams, tcfg, t(tok), tc, t(pos + step))
        assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) < TOL
        assert np.isfinite(tl.numpy()).all()
        _same(tc, jc)
        tok = np.asarray(jnp.argmax(jl, -1))[:, None]


@pytest.mark.parametrize("pattern", [("fa", "fa"), ("sa", "sa")])
def test_decode_many_per_row(setup, pattern):
    """Four greedy steps from three depths; row 0's FullKV runs past
    MAX_LEN = 64 on its last steps (JAX drops those writes)."""
    jcfg, tcfg, jparams, tparams = setup
    jc, tc = _pool(setup, pattern)
    pos = np.asarray([62, LENS[1], LENS[2]], np.int32)
    logits = _rand(9, 3, jcfg.vocab_size)
    jt, jl, jc = JMD.decode_many(jparams, jcfg, jnp.asarray(logits), jc,
                                 jnp.asarray(pos), jax.random.key(0),
                                 n_steps=4)
    tt, tl, tc = TMD.decode_many(tparams, tcfg, t(logits), tc, t(pos),
                                 n_steps=4)
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) < TOL
    _same(tc, jc)


# ---------------------------------------------------------------------------
# The CUDA wrapper's checks
# ---------------------------------------------------------------------------

def _ops(B=2, H=4, Hkv=2, L=70, D=32, Dv=32):
    return (torch.zeros((B * H, 1, D)), torch.zeros((B * Hkv, L, D)),
            torch.zeros((B * Hkv, L, Dv)),
            torch.full((B, L), -1, dtype=torch.int32),
            torch.zeros((B,), dtype=torch.int32))


def test_pooled_entry_rejects_bad_operands():
    q, k, v, pos, lens = _ops()
    f = TP.decode_attention_pooled_bh
    bad = [
        dict(positions=pos.long()),                    # int64 positions
        dict(positions=pos[:, :10]),                   # wrong length
        dict(lengths=lens[:1]),                        # one slot short
        dict(lengths=lens.float()),
        dict(q=torch.zeros((8, 2, 32))),               # two query tokens
        dict(k=torch.zeros((4, 70, 16))),              # Dk mismatch
        dict(v=torch.zeros((4, 69, 32))),              # L mismatch
        dict(k=torch.zeros((3, 70, 32)), v=torch.zeros((3, 70, 32))),
        dict(q=q.double()),
        dict(n_heads=3),                               # 8 rows ∤ 3
    ]
    for kw in bad:
        args = dict(q=q, k=k, v=v, positions=pos, lengths=lens, n_heads=4)
        args.update(kw)
        with pytest.raises(ValueError):
            f(args.pop("q"), args.pop("k"), args.pop("v"),
              args.pop("positions"), args.pop("lengths"), **args)
    before = launch_counts()
    out = f(q, k, v, None, lens, n_heads=4)  # CPU: the plain version
    assert launch_counts() == before and not out.any()


def test_pooled_cuda_operands_go_to_the_kernel(monkeypatch):
    """A CUDA operand launches the kernel with the operands' pointers (a
    null positions pointer for the FullKV layout), the plan's tiles a range
    and, when a KV row holds more than one range, fp32 scratch for the
    ranges' (acc, m, l), and never the plain version; a (Dk, Dv) the kernel
    is not built for, an unsupported dtype, a non-contiguous operand and a
    k / v base off 16 bytes raise before any launch."""
    launched = []
    monkeypatch.setattr(_build, "on_cpu", lambda name, t: False)
    monkeypatch.setattr(TP.KERNEL, "launch",
                        lambda dev, *a: launched.append(a))
    monkeypatch.setattr(TP, "decode_attention_pooled_plain", None)
    q, k, v, pos, lens = _ops()
    out = TP.decode_attention_pooled_bh(q, k, v, None, lens, n_heads=4)
    TP.decode_attention_pooled_bh(q, k, v, pos, lens, n_heads=4, tiles=1)
    assert out.shape == (8, 1, 32) and len(launched) == 2
    assert launched[0][:5] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               None, lens.data_ptr())
    assert launched[1][3] == pos.data_ptr()
    # L = 70 is 2 tiles: the plan's range holds both (no scratch), a
    # forced 1-tile range gives 2 ranges a row and scratch for them
    assert launched[0][6:9] == (0, 0, 0)
    assert all(launched[1][6:9])
    assert launched[0][9:17] == (8, 4, 70, 32, 32, 4, 0, 2)
    assert launched[1][16] == 1
    with pytest.raises(NotImplementedError, match="item 11"):
        TP.decode_attention_pooled_bh(*_ops(Dv=16)[:3], pos, lens,
                                      n_heads=4)
    with pytest.raises(NotImplementedError, match="item 11"):
        TP.decode_attention_pooled_bh(*_ops(D=48, Dv=48)[:3], pos, lens,
                                      n_heads=4)
    with pytest.raises(ValueError, match="contiguous"):
        TP.decode_attention_pooled_bh(q, k.transpose(0, 1).contiguous()
                                      .transpose(0, 1), v, pos, lens,
                                      n_heads=4)
    with pytest.raises(ValueError, match="dtype"):
        TP.decode_attention_pooled_bh(q.half(), k.half(), v.half(), pos,
                                      lens, n_heads=4)
    off = torch.zeros(k.numel() + 1)[1:].view(k.shape)  # 4 bytes past
    with pytest.raises(ValueError, match="16-byte"):
        TP.decode_attention_pooled_bh(q, off, v, pos, lens, n_heads=4)
    assert len(launched) == 2
