"""The port's ``xa`` (XAttention, ``block_topk``) and ``ta`` (TriangleMix,
``triangle``) attention modes against ``repro.core.modes``, in float32 on
seeded numpy inputs.

Held: ``attention`` under ``triangle`` (boundary 0, an aligned boundary,
an unaligned one, a query offset) and under ``block_topk`` at block 16
(below the block-sparse kernel's 64-token tile: the plain version at that
block) and at blocks 64 and 128 (the selection expanded to the kernel's
tiles through the block-sparse entry), at sizes where the top-k keeps
more than the two forced blocks, within 1e-5 of max |JAX| (summation
order only); ``antidiagonal_scores`` within 1e-5 and ``xa_keep_blocks``
exactly; the selection itself equal to ``lax.top_k``'s, ties included
(the lower index first); ``mode_flops`` equal for every kind; the
expanded selection's tiles; and, with the device test answering "cuda",
the block-sparse launch at block 128 and the raise at block 16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread: as fast at these small shapes, and it leaves the other
# cores to the test processes running beside this one
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro.core import modes as JM  # noqa: E402
from repro_torch.core import modes as TM  # noqa: E402

TOL = 1e-5  # relative to max |JAX output|: f32, summation order only


def _qkv(seed, B, Hq, Hkv, Sq, Skv, D=32, scale=1.0):
    rng = np.random.default_rng(seed)
    return tuple((scale * rng.normal(size=s)).astype(np.float32)
                 for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D),
                           (B, Hkv, Skv, D)))


def _pair(kind, **kw):
    return JM.AttnMode(kind, **kw), TM.AttnMode(kind, **kw)


def _both(q, k, v, modes, q_offset=0):
    jm, tm = modes
    want = np.asarray(JM.attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jm, q_offset=q_offset))
    got = TM.attention(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), tm, q_offset=q_offset).numpy()
    return got, want


def _jax_selection(q, k, mode, q_offset=0):
    """``_block_topk``'s selection as the JAX package computes it
    (``repro/core/modes.py:477-495``), flattened head-major."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    blk = mode.block
    Sq_pad, Skv_pad = -(-Sq // blk) * blk, -(-Skv // blk) * blk
    q5 = JM._pad_axis(JM._gqa_view(jnp.asarray(q), Hkv), 3, Sq_pad)
    k_p = JM._pad_axis(jnp.asarray(k), 2, Skv_pad)
    nqb, nkb = Sq_pad // blk, Skv_pad // blk
    keep = JM.xa_keep_blocks(nkb, mode.threshold)
    scores = JM.antidiagonal_scores(q5, k_p, blk, mode.stride, D ** -0.5)
    qb = q_offset // blk + jnp.arange(nqb)
    kb = jnp.arange(nkb)
    scores = jnp.where(kb[None, :] <= qb[:, None], scores, JM.NEG_INF)
    forced = (kb[None, :] == 0) | (kb[None, :] == qb[:, None])
    scores = jnp.where(forced, jnp.inf, scores)
    _, sel = lax.top_k(scores, keep)
    return np.asarray(sel).reshape(B * Hq, nqb, keep), keep


# (block, stride, threshold, Sq, Skv, q_offset): nkb blocks, keep > 2
XA_CASES = [
    (16, 4, 0.5, 96, 96, 0),        # plain version at block 16, keep 3
    (16, 4, 0.5, 83, 83, 0),        # padded to the block
    (64, 16, 0.6, 640, 640, 0),     # kernel tiles, keep 4 of 10
    (64, 16, 0.6, 603, 603, 0),
    (128, 16, 0.6, 1024, 1024, 0),  # 2 tiles a block, keep 4 of 8
    (128, 16, 0.6, 987, 987, 0),
    (128, 16, 0.5, 512, 640, 128),  # a query offset of one block, keep 3
]


@pytest.mark.parametrize("case", XA_CASES, ids=lambda c: "-".join(map(
    str, c)))
def test_block_topk_matches_jax(case):
    blk, stride, thr, Sq, Skv, off = case
    q, k, v = _qkv(blk + Sq, 2, 4, 2, Sq, Skv)
    modes = _pair("block_topk", block=blk, stride=stride, threshold=thr)
    want_sel, keep = _jax_selection(q, k, modes[0], off)
    assert keep > 2, "the top-k must choose beyond the forced blocks"
    sel = TM.xa_selection(torch.from_numpy(q), torch.from_numpy(k),
                          modes[1], q_offset=off, scale=32 ** -0.5)
    assert np.array_equal(sel.numpy(), want_sel)
    # a per-head choice, not one causal prefix shared by every head
    assert len({tuple(r.ravel()) for r in want_sel}) > 1
    got, want = _both(q, k, v, modes, off)
    assert float(np.abs(got - want).max()) <= TOL * float(
        np.abs(want).max())


def test_antidiagonal_scores_and_keep_blocks_match_jax():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 2, 3, 256, 32)).astype(np.float32)
    k = rng.normal(size=(2, 2, 384, 32)).astype(np.float32)
    for blk, stride in ((64, 16), (128, 16), (128, 8), (16, 4)):
        want = np.asarray(JM.antidiagonal_scores(
            jnp.asarray(q), jnp.asarray(k), blk, stride, 0.2))
        got = TM.antidiagonal_scores(torch.from_numpy(q),
                                     torch.from_numpy(k), blk, stride,
                                     0.2).numpy()
        assert got.shape == want.shape == (2, 2, 3, 256 // blk, 384 // blk)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for n in range(1, 70):
        for thr in (0.0, 0.3, 0.5, 0.9, 0.95, 1.0):
            assert TM.xa_keep_blocks(n, thr) == JM.xa_keep_blocks(n, thr)


def test_equal_block_scores_pick_the_lowest_blocks_as_lax_top_k():
    """Zero queries give every block the same antidiagonal score, so the
    top-k is all ties: the stable sort keeps lax.top_k's order (forced
    blocks, then the lowest causal indices, then the lowest masked
    ones)."""
    q = np.zeros((1, 2, 1024, 32), np.float32)
    _, k, _ = _qkv(5, 1, 2, 2, 1024, 1024)
    for thr in (0.6, 0.3):
        modes = _pair("block_topk", block=128, stride=16, threshold=thr)
        want, keep = _jax_selection(q, k, modes[0])
        got = TM.xa_selection(torch.from_numpy(q), torch.from_numpy(k),
                              modes[1], q_offset=0, scale=32 ** -0.5)
        assert np.array_equal(got.numpy(), want)
        # query block 5 (thr 0.6, keep 4): sink 0 and diagonal 5 forced,
        # then blocks 1 and 2
        if keep == 4:
            assert got[0, 5].tolist() == [0, 5, 1, 2]


TRIANGLE_CASES = [
    (64, 48, 48, 0),     # Sq <= chunk: boundary 0, flash alone
    (64, 192, 192, 0),   # boundary 128, a multiple of 64
    (50, 150, 150, 0),   # boundary 100, unaligned
    (40, 90, 110, 20),   # a query offset: boundary 50 at offset 20
]


@pytest.mark.parametrize("case", TRIANGLE_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_triangle_matches_jax(case):
    chunk, Sq, Skv, off = case
    q, k, v = _qkv(chunk + Sq, 2, 4, 2, Sq, Skv)
    got, want = _both(q, k, v, _pair("triangle", sink=4, local=16,
                                     chunk=chunk), off)
    assert float(np.abs(got - want).max()) <= TOL * float(
        np.abs(want).max())


def test_triangle_splits_rows_at_the_boundary(monkeypatch):
    """Rows before the boundary go to the streaming entry at the call's
    offset, the rest to flash at offset + boundary, as contiguous
    copies."""
    calls = []
    for name in ("streaming_attention_bh", "flash_attention_bh"):
        real = getattr(TM, name)

        def spy(q, k, v, _name=name, _real=real, **kw):
            calls.append((_name, q.shape[1], kw["q_offset"],
                          q.is_contiguous()))
            return _real(q, k, v, **kw)
        monkeypatch.setattr(TM, name, spy)
    q, k, v = (torch.from_numpy(x) for x in _qkv(0, 2, 4, 2, 150, 170))
    TM.attention(q, k, v, TM.AttnMode("triangle", sink=4, local=16,
                                      chunk=50), q_offset=20)
    assert calls == [("streaming_attention_bh", 100, 20, True),
                     ("flash_attention_bh", 50, 120, True)]


def test_mode_flops_match_jax():
    for kind, kw in (("full", {}), ("window", dict(local=1024)),
                     ("streaming", dict(sink=128, local=2048)),
                     ("triangle", dict(sink=128, local=2048, chunk=16384)),
                     ("block_topk", dict(block=128, stride=16,
                                         threshold=0.9))):
        jm, tm = _pair(kind, **kw)
        for Sq, Skv in ((4096, 4096), (18432, 18432), (512, 4608)):
            assert TM.mode_flops(tm, Sq, Skv, 32, 96, 4) == \
                JM.mode_flops(jm, Sq, Skv, 32, 96, 4)


def test_expand_selection_tiles():
    """Block j of 128 becomes tiles 2j and 2j + 1; query tile t reads
    block t // 2's row; tiles past Skv or wholly past the tile's last row
    are -1; live tiles ascend."""
    sel = torch.tensor([[[0, 1], [1, 0], [2, 0]]])  # (1, 3, 2) at block 128
    out = TM.expand_selection(sel, 128, Sq=300, Skv=300, q_offset=0)
    assert out.dtype == torch.int32 and out.shape == (1, 5, 4)
    assert out[0].tolist() == [
        [0, -1, -1, -1],  # rows 0-63: tiles 1-3 start past row 63
        [0, 1, -1, -1],   # rows 64-127: tiles 2, 3 start past row 127
        [0, 1, 2, -1],    # rows 128-191: tile 3 starts at key 192
        [0, 1, 2, 3],
        [0, 1, 4, -1],    # rows 256-299: tile 5 starts past Skv = 300
    ]
    # with an offset every tile up to the offset's is live
    out = TM.expand_selection(sel[:, :2], 128, Sq=128, Skv=512, q_offset=256)
    assert out[0].tolist() == [[0, 1, 2, 3], [0, 1, 2, 3]]


def test_block_topk_cuda_branch_launches_or_raises(monkeypatch):
    """With the device test answering "cuda": block 128 launches the
    block-sparse kernel once on the expanded int32 selection (one row a
    query head); block 16 raises before any launch, naming the tile."""
    from repro_torch.kernels import _build, block_sparse_attention as BS
    launched = []
    monkeypatch.setattr(_build, "on_cpu", lambda name, t: False)
    monkeypatch.setattr(BS.KERNEL, "launch",
                        lambda dev, *a: launched.append(a))
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 1, 4, 2, 1024, 1024))
    TM.attention(q, k, v, TM.AttnMode("block_topk", block=128, stride=16,
                                      threshold=0.6))
    assert len(launched) == 1
    # (q, k, v, sel, o, BH, BHkv, Sq, Skv, D, dtype, n_sel, q_offset, ...)
    assert launched[0][5:13] == (4, 2, 1024, 1024, 32, 0, 8, 0)
    with pytest.raises(ValueError, match="64-token tile"):
        TM.attention(q[:, :, :96].contiguous(), k[:, :, :96].contiguous(),
                     v[:, :, :96].contiguous(),
                     TM.AttnMode("block_topk", block=16, stride=4,
                                 threshold=0.5))
    assert len(launched) == 1
