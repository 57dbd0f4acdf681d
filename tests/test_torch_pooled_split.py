"""The split pooled decode kernel's plan and arithmetic, checked on the CPU:

- ``pooled_ranges`` (the ranges of ``tiles`` whole 64-key tiles that run
  for a slot of live length n, as ``csrc/decode_attention_pooled.cu`` cuts
  the buffer's capacity) covers [0, n) exactly once, and the ranges the
  capacity's grid holds past n are the ones skipped;
- ``ref.decode_attention_pooled_split_ref`` (the kernel's per-range
  softmax and log-sum-exp merge, in plain torch) against the JAX
  ``decode_attention_pooled_bh`` in Pallas interpret mode, at the float32
  2e-5 of ``test_torch_pooled.py`` (the same masked softmax, summed in
  another order): FullKV with lengths 0, 1, 63, 64, 65 and L, and a ring
  with holes where one range is wholly masked, at G 1 and 4 and every
  head dim the kernel is built for;
- a row with no live key gives zeros, in the emulation and in the plain
  version the CPU entry runs.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread: as fast at these small shapes, and it leaves the other
# cores to the test processes running beside this one
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import \
    decode_attention_pooled_bh as jax_pooled  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels._build import HEAD_DIMS  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    MAX_G, MAX_SPLIT_TILES, TILE, normalize_tiles, pooled_ranges,
    pooled_split_plan)
from repro_torch.kernels.decode_attention_pooled import \
    decode_attention_pooled_bh  # noqa: E402

TOL = 2e-5


# ---------------------------------------------------------------------------
# The range plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tiles", [1, 2, 3, 8, 16, 65])
@pytest.mark.parametrize("L", [1, 63, 64, 65, 2176, 4128])
def test_pooled_ranges_cover_live_keys_once(L, tiles):
    """For every live length n in 0..L: the ranges that run are whole
    tiles from key 0, contiguous, at most ``tiles`` tiles each, and end at
    n, so each live key is read once and no key past n; the capacity's
    grid holds ceil(ceil(L / 64) / t) ranges a row, and the ones it holds
    past them start at or past n (they return at once)."""
    t = normalize_tiles(L, tiles)
    assert 1 <= t <= min(tiles, -(-L // TILE))
    capacity = -(-L // (t * TILE))
    for n in range(L + 1):
        ranges = pooled_ranges(n, L, t)
        assert len(ranges) == -(-n // (t * TILE)) <= capacity
        assert [s for s, _ in ranges] == [i * t * TILE
                                          for i in range(len(ranges))]
        ends = [e for _, e in ranges]
        assert ends == [s for s, _ in ranges[1:]] + ([n] if n else [])
        for s, e in ranges:
            assert s < e <= s + t * TILE
            assert e % TILE == 0 or e == n
        skipped = range(len(ranges), capacity)
        assert all(i * t * TILE >= n for i in skipped)


@pytest.mark.parametrize("G", [1, MAX_G])
@pytest.mark.parametrize("L", [1, 63, 64, 65, 2176, 4128])
def test_pooled_plan_fits_the_kernel(L, G):
    """The plan's tiles lie in [1, ceil(L / 64)] and within what a range's
    scores may hold in shared memory; a forced count is clamped alike, and
    lengths past L are clamped to it."""
    t = pooled_split_plan(L, G)
    assert 1 <= t <= min(-(-L // TILE), MAX_SPLIT_TILES[G])
    for asked in (0, 1, 7, 10 ** 6):
        assert 1 <= normalize_tiles(L, asked, G) <= MAX_SPLIT_TILES[G]
    assert pooled_ranges(L + 100, L, t) == pooled_ranges(L, L, t)
    assert pooled_ranges(-3, L, t) == []


# ---------------------------------------------------------------------------
# The per-range softmax and merge against the Pallas kernel
# ---------------------------------------------------------------------------

L_POOL, HQ = 200, 4  # 4 tiles, the last of 8 keys
LENS = (0, 1, 63, 64, 65, L_POOL)
MASKED = slice(64, 128)  # tile 1 of the full-length slot: all holes


def _ring_positions(rng):
    """(B, L) ring positions: slot b's first min(n, L) entries hold
    distinct positions in shuffled order, a fifth re-marked -1 (never all
    of a live row), the rest -1; in the last slot (n = L) every entry of
    keys 64-127 is -1, so a range of one tile there sees nothing."""
    pos = np.full((len(LENS), L_POOL), -1, np.int32)
    for b, n in enumerate(LENS):
        if n == 0:
            continue
        pos[b, :n] = rng.permutation(3 * L_POOL)[:n]
        cut = rng.random(n) < 0.2
        cut[rng.integers(min(n, 64))] = False
        pos[b, :n][cut] = -1
    pos[-1, MASKED] = -1
    return pos


@functools.lru_cache(maxsize=None)
def _case(layout, G, D):
    """numpy (q, k, v, positions, lengths) and the Pallas output."""
    rng = np.random.default_rng(D + G)
    B, Hkv = len(LENS), HQ // G
    q = rng.normal(size=(B * HQ, 1, D)).astype(np.float32)
    k = rng.normal(size=(B * Hkv, L_POOL, D)).astype(np.float32)
    v = rng.normal(size=(B * Hkv, L_POOL, D)).astype(np.float32)
    lens = np.asarray(LENS, np.int32)
    if layout == "ring":
        pos = _ring_positions(rng)
    else:
        pos = np.broadcast_to(np.arange(L_POOL, dtype=np.int32),
                              (B, L_POOL)).copy()
    want = np.asarray(jax_pooled(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(pos),
                                 jnp.asarray(lens), n_heads=HQ,
                                 interpret=True))
    return q, k, v, pos, lens, want


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("tiles", [1, 2, 4])
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("layout", ["full", "ring"])
def test_split_merge_matches_pallas(layout, G, D, tiles):
    q, k, v, pos, lens, want = _case(layout, G, D)
    if layout == "ring" and tiles == 1:
        assert not (pos[-1, MASKED] >= 0).any()  # a wholly masked range
    got = ref.decode_attention_pooled_split_ref(
        _t(q), _t(k), _t(v), None if layout == "full" else _t(pos),
        _t(lens), n_heads=HQ, tiles=tiles)
    assert got.shape == want.shape
    assert float(np.abs(got.numpy() - want).max()) < TOL
    assert not got[:HQ].any()  # the length-0 slot's rows are zeros


def test_no_live_key_gives_zeros():
    """A slot of length 0, and a slot whose live entries are all -1 (the
    Pallas kernel averages its padded block there; no serving ring holds
    such a row), give zeros in the emulation, at one range and at several,
    and in the plain version the CPU entry runs."""
    q, k, v, pos, lens, _ = _case("ring", 1, 32)
    pos = pos.copy()
    pos[2] = -1  # slot 2 (63 live entries) sees nothing
    args = (_t(q), _t(k), _t(v), _t(pos), _t(lens))
    dead = np.repeat([True, False, True, False, False, False], HQ)
    for tiles in (1, 4):
        got = ref.decode_attention_pooled_split_ref(*args, n_heads=HQ,
                                                    tiles=tiles)
        assert not got[dead].any() and got[~dead].abs().sum(-1).all()
    plain = decode_attention_pooled_bh(*args, n_heads=HQ)
    assert not plain[dead].any() and plain[~dead].abs().sum(-1).all()
