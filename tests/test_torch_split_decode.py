"""The split-KV decode kernel's plan and arithmetic, and the streaming
kernel's walk on the wgmma engine, checked on the CPU:

- ``decode_split_plan`` / ``split_ranges`` cut [0, L) into non-empty,
  contiguous, 64-key-aligned ranges that cover every key once;
- ``ref.decode_attention_split_ref`` (the kernel's per-split online
  softmax and log-sum-exp merge, in plain torch) against the JAX
  ``decode_attention_bh`` in Pallas interpret mode, at the float32 2e-5
  of ``test_torch_kernels.py`` (the same masked softmax, summed in another
  order), and on a row with no live key against the plain version and,
  at an L that is a multiple of the Pallas block, against Pallas;
- a plain Python model of ``csrc/streaming_attention.cu``'s walk and of
  the engine's ``StreamingMask`` (``csrc/prefill_wgmma.cuh``) covers every
  visible (query, key) pair exactly once and never skips the mask on a
  tile that holds a hidden key.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread: as fast at these small shapes, and it leaves the other
# cores to the test processes running beside this one
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    TILE, decode_split_plan, normalize_split, split_ranges)

TOL = 2e-5
H100_SMS = 132  # multiprocessors of an H100 SXM


# ---------------------------------------------------------------------------
# The split plan
# ---------------------------------------------------------------------------

def _check_partition(L, n):
    ranges = split_ranges(L, n)
    assert len(ranges) == n
    assert ranges[0][0] == 0 and ranges[-1][1] == L
    for (s0, e0), (s1, _) in zip(ranges, ranges[1:]):
        assert e0 == s1  # contiguous, so every key once
    for s, e in ranges:
        assert e > s  # none empty
        assert s % TILE == 0  # whole tiles
        assert e % TILE == 0 or e == L


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("BH", [8, 128])
@pytest.mark.parametrize("L", [1, 63, 64, 65, 2176, 4128])
def test_split_plan_partitions_keys(L, BH, G):
    n = decode_split_plan(BH // G, G, L, H100_SMS)
    assert 1 <= n <= -(-L // TILE)
    if L <= 2 * TILE:
        assert n == 1  # a small cache is not cut
    _check_partition(L, n)
    for asked in range(1, -(-L // TILE) + 3):  # forced counts, normalized
        _check_partition(L, normalize_split(L, asked, G))


@pytest.mark.parametrize("BHkv", [8, 32, 64, 128, 256])
def test_split_plan_fills_at_most_one_wave(BHkv):
    """phi3-mini's batch decode over 4128 slots at 8 to 256 rows (32 heads
    a request): ranges only while one CTA per multiprocessor still holds
    them all, so 128 rows and more run uncut; ranges of near-equal
    length."""
    n = decode_split_plan(BHkv, 1, 4128, H100_SMS)
    sizes = [e - s for s, e in split_ranges(4128, n)]
    if 2 * BHkv > H100_SMS:
        assert n == 1
    else:
        assert BHkv * n <= H100_SMS < BHkv * (n + 1)
    assert max(sizes) - min(sizes) <= TILE


# ---------------------------------------------------------------------------
# The split-and-merge arithmetic against the Pallas kernel
# ---------------------------------------------------------------------------

L_DEC, CUR, B, HQ, HKV, D = 600, 350, 2, 4, 2, 32  # 10 tiles, G = 2


def _positions(layout):
    """(L,) int32: FullKV (arange), a ring permutation (live positions
    shuffled among -1 empties), or a ring whose empty slots fill keys
    [192, 384): the whole middle split when n_split = 3."""
    rng = np.random.default_rng(21)
    if layout == "full":
        return np.arange(L_DEC, dtype=np.int32)
    live = rng.permutation(CUR + 1)
    if layout == "ring":
        pos = np.concatenate([live, -np.ones(L_DEC - CUR - 1)])
        return rng.permutation(pos).astype(np.int32)
    pos = -np.ones(L_DEC, np.int32)
    rest = np.r_[0:192, 384:L_DEC]
    pos[rest[:CUR + 1]] = live
    return pos


def _inputs():
    rng = np.random.default_rng(20)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, HQ, 1, D), (B, HKV, L_DEC, D), (B, HKV, L_DEC, D))]


@functools.lru_cache(maxsize=None)
def _pallas(layout):
    q, k, v = _inputs()
    return np.asarray(ops.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(_positions(layout)), jnp.int32(CUR), block_k=64,
        interpret=True))


@pytest.mark.parametrize("layout", ["full", "ring", "ring_empty_split"])
@pytest.mark.parametrize("n_split", [1, 2, 3, 8])
def test_split_merge_matches_pallas(n_split, layout):
    q, k, v = (torch.from_numpy(x.reshape(-1, *x.shape[2:]))
               for x in _inputs())
    pos = torch.from_numpy(_positions(layout))
    if layout == "ring_empty_split" and n_split == 3:
        s, e = split_ranges(L_DEC, 3)[1]
        assert bool((pos[s:e] < 0).all())  # the middle split sees nothing
    got = ref.decode_attention_split_ref(q, k, v, pos, CUR, n_split)
    want = _pallas(layout)
    assert float(np.abs(got.numpy().reshape(want.shape) - want).max()) < TOL


@pytest.mark.parametrize("n_split", [1, 3, 10])
def test_split_merge_no_live_key_matches_plain(n_split):
    """A row with no live key: every split keeps m = -1e30 and weighs its
    keys 1, so the merge gives the plain version's mean of V (the Pallas
    kernel, which pads L to its block with weight-1 zero keys, differs
    here unless L is a multiple of its block)."""
    q, k, v = (torch.from_numpy(x.reshape(-1, *x.shape[2:]))
               for x in _inputs())
    pos = torch.from_numpy(_positions("ring"))
    got = ref.decode_attention_split_ref(q, k, v, pos, -1, n_split)
    want = ref.decode_attention_ref(q, k, v, pos, -1)
    assert float((got - want).abs().max()) < TOL


@pytest.mark.parametrize("n_split", [1, 3, 10])
def test_split_merge_no_live_key_matches_pallas(n_split):
    """A row with no live key at L = 640, a multiple of the Pallas block,
    where the Pallas kernel pads no key: it too weighs every key 1, and
    split-and-merge gives the same mean of V."""
    rng = np.random.default_rng(22)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((B, HQ, 1, D), (B, HKV, 640, D), (B, HKV, 640, D)))
    pos = np.where(rng.random(640) < 0.2, -1, rng.permutation(640))
    pos = pos.astype(np.int32)
    want = np.asarray(ops.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.int32(-1), block_k=64, interpret=True))
    got = ref.decode_attention_split_ref(
        *(torch.from_numpy(x.reshape(-1, *x.shape[2:])) for x in (q, k, v)),
        torch.from_numpy(pos), -1, n_split)
    assert float(np.abs(got.numpy().reshape(want.shape) - want).max()) < TOL


# ---------------------------------------------------------------------------
# The streaming walk on the wgmma engine
# ---------------------------------------------------------------------------

BQ = BK = 64


def _walk(row0, Sq, Skv, sink, local, q_offset):
    """csrc/streaming_attention.cu's walk for the query block at row0:
    [(step j, key tile)], and n_sink (steps below it are the sink pass)."""
    first_q = q_offset + row0
    last_q = q_offset + min(row0 + BQ, Sq) - 1
    last_tile = min(-(-Skv // BK) - 1, last_q // BK)
    n_sink = min(-(-sink // BK), last_tile + 1)
    w0 = max((first_q - (local - 1)) // BK, sink // BK, 0)
    tiles = list(range(n_sink)) + list(range(w0, last_tile + 1))
    return list(enumerate(tiles)), n_sink, last_q


def _hidden(j, key, pos, Skv, sink, local, n_sink):
    """The engine's Skv and causal tests and StreamingMask::hidden, over
    numpy arrays of keys and positions."""
    out = (key >= Skv) | (key > pos)
    if j < n_sink:
        return out | (key >= sink)
    return out | (key < sink) | (pos - key >= local)


def _needs_mask(j, kv0, row0, Skv, sink, local, n_sink, last_q, q_offset):
    """The engine's edge test with StreamingMask::needs_mask."""
    if kv0 + BK > Skv or kv0 + BK - 1 > q_offset + row0:
        return True
    if j < n_sink:
        return kv0 + BK > sink
    return kv0 < sink or kv0 < last_q - (local - 1)


@pytest.mark.parametrize("q_offset,Sq,Skv", [(0, 200, 200),
                                             (100, 200, 300)])
@pytest.mark.parametrize("local", [1, 48, 130, 2048])
@pytest.mark.parametrize("sink", [0, 16, 100, 128])
def test_streaming_walk_covers_each_visible_pair_once(sink, local,
                                                      q_offset, Sq, Skv):
    count = np.zeros((Sq, Skv), np.int64)
    for row0 in range(0, Sq, BQ):
        walk, n_sink, last_q = _walk(row0, Sq, Skv, sink, local, q_offset)
        rows = np.arange(row0, min(row0 + BQ, Sq))  # the stored rows
        pos = (q_offset + rows)[:, None]
        for j, tile in walk:
            keys = tile * BK + np.arange(BK)[None, :]
            seen = ~_hidden(j, keys, pos, Skv, sink, local, n_sink)
            if not _needs_mask(j, tile * BK, row0, Skv, sink, local, n_sink,
                               last_q, q_offset):
                assert seen.all(), (row0, j, tile)  # unmasked softmax
            for r, c in zip(*np.nonzero(seen)):
                count[rows[r], keys[0, c]] += 1
    qp = q_offset + np.arange(Sq)[:, None]
    kp = np.arange(Skv)[None, :]
    visible = (kp <= qp) & ((kp < sink) | (qp - kp < local))
    assert np.array_equal(count, visible.astype(np.int64))
