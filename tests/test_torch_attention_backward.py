"""The gradient of the port's attention against JAX's autodiff, and the
backward kernel's plumbing, on seeded numpy inputs in float32.

Held:

- ``repro_torch.core.modes.attention`` under autograd (the CPU path: the
  plain versions' autograd) against ``jax.vjp`` of
  ``repro.core.modes.attention`` for ``full`` (causal and bidirectional),
  ``streaming``, ``window``, ``triangle`` and ``block_topk`` (at block
  16, and at block 64, the block-sparse entry, where it drops blocks), at
  G = 1 and 2, with a query offset and at (Dk, Dv) = (48, 32): dq, dk and
  dv within 1e-5 · max(1, max |JAX|) (float32, summation order only);
- the block-sparse backward's plain version against ``jax.vjp`` of the
  JAX package's ``kernels/ref.py`` ``block_sparse_attention_ref``, and a
  model of ``walk_lists`` (every selected tile walked once from each
  side);
- ``attention_backward_plain`` against the same vjp, and the autograd
  function ``differentiable`` (the card's route, here with the plain
  forward) against the plain version's autograd bitwise,
  ``needs_input_grad`` honoured; in bf16 the plain version's gradient
  is the straight-through one with the row max a constant (the
  kernel's), at the same values as the forward;
- the tile walks of ``csrc/attention_backward.cu`` (``key_tiles`` /
  ``query_tiles`` of its flash and streaming policies, transcribed
  below) cover every visible (query, key) pair from both sides, at
  steps 64 and 32, unaligned sizes, offsets, sinks straddling a tile
  and windows narrower and wider than a tile;
- with the device test answering "cuda": the flash, streaming and
  block-sparse entries (and xa) record their launch for autograd only
  when an operand requires grad, launch exactly as before otherwise, and
  launch their backward kernels, at (Dk, Dv) = (192, 128) too; the
  decode kernels raise ``NotImplementedError`` under grad; the backward
  entry launches once with the operands' pointers,
  bf16 with the dtype code of its tensor-core engine (and its TMA
  alignment checked), fp32 with the CUDA cores' code;
- the bf16 engine's arithmetic (``ref.attention_backward_tiled_ref``:
  three dq passes, the transposed dk / dv walk, the two-part bf16 A
  operands) against ``jax.vjp`` in float32 and against
  ``attention_backward_plain`` in bf16 under chip_smoke phase 3's limit,
  the first rows of a causal mask included; the tiles its walks run
  unmasked (``full``, transcribed below) against the mask.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread: as fast at these small shapes, and it leaves the other
# cores to the test processes running beside this one
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import modes as JM  # noqa: E402
from repro_torch.core import modes as TM  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import attention_backward as AB  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

TOL = 1e-5  # relative to max(1, max |JAX grad|): f32, summation order
SINK, LOCAL = 8, 32  # the smoke configs' flux geometry

MODES = {
    "full causal": dict(kind="full"),
    "full bidirectional": dict(kind="full", causal=False),
    "streaming": dict(kind="streaming", sink=SINK, local=LOCAL),
    "window": dict(kind="window", local=LOCAL),
    "triangle": dict(kind="triangle", sink=SINK, local=LOCAL, chunk=16),
    "block_topk": dict(kind="block_topk", sink=SINK, local=LOCAL, block=16,
                       stride=4, threshold=0.5),
    # a multiple of the kernel's 64-token tile: the block-sparse entry
    "block_topk64": dict(kind="block_topk", sink=SINK, local=LOCAL,
                         block=64, stride=16, threshold=0.5),
}
# (B, Hq, Hkv, Sq, Skv, q_offset[, Dk, Dv]): G = 1 and 2, 80 > sink +
# local so SA differs from FA, a chunk of 48 queries at offset 32 over 80
# keys, 5 blocks of 64 where xa at block 64 keeps 3 (a chunk of 256 at
# offset 64), and values narrower than queries and keys (MLA's route
# chunk at the smoke widths)
SHAPES = {"G1": (2, 4, 4, 80, 80, 0), "G2": (1, 4, 2, 80, 80, 0),
          "offset": (1, 4, 2, 48, 80, 32), "long": (1, 4, 2, 256, 320, 64),
          "split": (1, 4, 2, 80, 80, 0, 48, 32)}


def _inputs(seed, B, Hq, Hkv, Sq, Skv, D=32, Dv=None):
    rng = np.random.default_rng(seed)
    Dv = D if Dv is None else Dv
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D),
                           (B, Hkv, Skv, Dv), (B, Hq, Sq, Dv)))


def _jax_grads(q, k, v, do, mode, q_offset):
    jm = JM.AttnMode(**mode)
    _, vjp = jax.vjp(lambda a, b, c: JM.attention(a, b, c, jm,
                                                  q_offset=q_offset),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _close(got, want):
    for g, w in zip(got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        assert np.abs(g - w).max() <= TOL * max(1.0, np.abs(w).max()), \
            np.abs(g - w).max()


# every mode at G1, G2 and offset but xa at block 64, which the long
# shape holds; every mode at the split widths
GRAD_CASES = ([(m, s) for s in ("G1", "G2", "offset") for m in sorted(MODES)
               if m != "block_topk64"]
              + [("block_topk64", "long")]
              + [(m, "split") for m in sorted(MODES)])


@pytest.mark.parametrize("mode,shape", GRAD_CASES,
                         ids=[f"{m}-{s}" for m, s in GRAD_CASES])
def test_attention_grads_match_jax(mode, shape):
    B, Hq, Hkv, Sq, Skv, off, *dims = SHAPES[shape]
    q, k, v, do = _inputs(len(mode) + Sq, B, Hq, Hkv, Sq, Skv, *dims)
    if (mode, shape) == ("block_topk64", "long"):  # xa drops blocks
        assert TM.xa_keep_blocks(Skv // 64, 0.5) < Skv // 64
    want = _jax_grads(q, k, v, do, MODES[mode], off)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = TM.attention(tq, tk, tv, TM.AttnMode(**MODES[mode]), q_offset=off)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    assert all(np.abs(g.numpy()).max() > 0 for g in got)
    _close(got, want)


def _flat(x):
    return torch.from_numpy(x.reshape(-1, *x.shape[2:]))


@pytest.mark.parametrize("kind", ["flash", "flash_bidirectional",
                                  "streaming", "window"])
def test_backward_plain_matches_jax(kind):
    """The backward entry's plain version (what a CPU tensor runs) in the
    kernels' flattened (B·H, S, D) layout, at G = 2 and an offset."""
    B, Hq, Hkv, Sq, Skv, off = SHAPES["offset"]
    q, k, v, do = _inputs(3, B, Hq, Hkv, Sq, Skv)
    mode, kw = {
        "flash": (dict(kind="full"), dict(causal=True)),
        "flash_bidirectional": (dict(kind="full", causal=False),
                                dict(causal=False)),
        "streaming": (dict(kind="streaming", sink=SINK, local=LOCAL),
                      dict(sink=SINK, local=LOCAL)),
        "window": (dict(kind="window", local=LOCAL),
                   dict(sink=0, local=LOCAL)),
    }[kind]
    if kind == "flash_bidirectional":
        off = 0
    want = _jax_grads(q, k, v, do, mode, off)
    got = AB.attention_backward_bh(_flat(q), _flat(k), _flat(v), _flat(do),
                                   q_offset=off, **kw)
    _close([g.reshape(w.shape) for g, w in zip(got, want)], want)


@pytest.mark.parametrize("need", [(True, True, True), (False, False, True),
                                  (True, False, False)])
def test_autograd_function_matches_plain_autograd(need):
    """``differentiable`` with the plain forward in place of a launch: the
    same output and, bitwise, the same gradients as autograd through the
    plain version; inputs that need no grad get None."""
    q, k, v, do = (_flat(x) for x in _inputs(5, 1, 4, 2, 48, 80))
    kw = dict(sink=SINK, local=LOCAL, q_offset=32)
    ins = [t.clone().requires_grad_(n) for t, n in zip((q, k, v), need)]
    out = AB.differentiable(
        *ins, lambda a, b, c: ref.streaming_attention_ref(a, b, c, **kw),
        **kw)
    assert out.grad_fn is not None
    out.backward(do)
    ref_ins = [t.clone().requires_grad_() for t in (q, k, v)]
    ref.streaming_attention_ref(*ref_ins, **kw).backward(do)
    for t, r, n in zip(ins, ref_ins, need):
        assert (t.grad is not None) == n
        if n:
            assert torch.equal(t.grad, r.grad)


# ---------------------------------------------------------------------------
# The block-sparse gradient (kernels/block_sparse_backward.py)
# ---------------------------------------------------------------------------

def _selection(seed, BH, nqt, K, nkt):
    """A selection of 64-key tiles per 64-row block that differs per query
    head: repeats, -1 entries, tiles past the diagonal and past Skv."""
    rng = np.random.default_rng(seed)
    sel = rng.integers(-1, nkt + 1, size=(BH, nqt, K)).astype(np.int32)
    sel[:, :, 0] = sel[:, :, 1]  # a repeat in every row
    return sel


@pytest.mark.parametrize("G", [1, 2])
def test_block_sparse_backward_plain_matches_jax(G):
    """The block-sparse entry's plain gradient (what a CPU tensor runs),
    in the kernels' flat layout, against ``jax.vjp`` of the JAX package's
    ``kernels/ref.py`` ``block_sparse_attention_ref`` at block 64 (which
    takes no query offset): 200 queries over 200 keys, a selection with
    repeats and holes that differs per head."""
    from repro.kernels import ref as jref
    from repro_torch.kernels import block_sparse_backward as BSB
    BH, S, D = 4, 200, 32
    q, k, v, do = (x.reshape(-1, S, D) for x in _inputs(9 + G, 1, BH,
                                                        BH // G, S, S))
    sel = _selection(G, BH, 4, 3, 4)
    _, vjp = jax.vjp(lambda a, b, c: jref.block_sparse_attention_ref(
        a, b, c, jnp.asarray(sel), block=64), *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    got = BSB.block_sparse_backward_bh(*map(torch.from_numpy, (q, k, v, do)),
                                       torch.from_numpy(sel))
    assert all(np.abs(w).max() > 0 for w in want)
    _close(got, want)


# (BH, G, Sq, Skv, K): G = 1, 2 and 4, ragged Sq and Skv, selections wider
# than the key tiles
LIST_CASES = [(4, 1, 200, 300, 3), (8, 2, 130, 130, 4), (8, 4, 64, 400, 7),
              (16, 4, 1000, 700, 5)]


@pytest.mark.parametrize("case", range(len(LIST_CASES)))
def test_walk_lists_cover_every_selected_tile_once(case):
    """``walk_lists`` (the kernel's two walks of a selection), modelled as
    the CTAs read them: each dq CTA (query head, row block) walks its
    ``counts`` first ``rows`` entries, each dk / dv CTA (KV head, key
    tile) its ``items`` between two ``offs``, at steps of 64 and, as the
    fp32 kernels walk at Dk + Dv > 320, of 32 (kSub = 2). Both visit every
    (query head, query tile, key tile) of the deduplicated selection
    (entries in [0, nkt)) exactly once, dq's in ascending key tiles and dk
    / dv's by head then query tile."""
    from repro_torch.kernels import block_sparse_backward as BSB
    BH, G, Sq, Skv, K = LIST_CASES[case]
    nqt, nkt = -(-Sq // 64), -(-Skv // 64)
    sel = _selection(case, BH, nqt, K, nkt)
    want = {(b, t, int(x)) for b in range(BH) for t in range(nqt)
            for x in sel[b, t] if 0 <= x < nkt}
    rows, counts, offs, items = (x.numpy() for x in BSB.walk_lists(
        torch.from_numpy(sel), BH // G, Skv))
    assert rows.dtype == counts.dtype == offs.dtype == items.dtype == np.int32
    for sub in (1, 2):
        by_dq = []
        for b in range(BH):
            for t in range(nqt):
                tiles = [rows[b, t, w // sub] * sub + w % sub
                         for w in range(counts[b, t] * sub)]
                assert tiles == sorted(tiles)
                by_dq += [(b, t, x // sub) for x in tiles[::sub]]
                assert all(x // sub < nkt for x in tiles)
        by_kv = []
        for bkv in range(BH // G):
            for kt in range(nkt):
                o0, o1 = offs[bkv * nkt + kt], offs[bkv * nkt + kt + 1]
                steps = [(bkv * G + items[o0 + j // sub] // nqt,
                          items[o0 + j // sub] % nqt * sub + j % sub)
                         for j in range((o1 - o0) * sub)]
                assert steps == sorted(steps)
                by_kv += [(h, r // sub, kt) for h, r in steps[::sub]]
        assert len(by_dq) == len(set(by_dq)) and set(by_dq) == want
        assert len(by_kv) == len(set(by_kv)) and set(by_kv) == want
    assert offs[0] == 0 and offs[-1] == len(want)


# ---------------------------------------------------------------------------
# The kernel's tile walks (csrc/attention_backward.cu, FlashPolicy and
# StreamingPolicy), transcribed
# ---------------------------------------------------------------------------

ROWS = 64  # bwd::kRows


def _floor_div(a, b):
    return a // b


def _visible(kind, r, key, q_offset, causal, sink, local):
    p = q_offset + r
    if kind == "flash":
        return not causal or key <= p
    return key <= p and (key < sink or p - key < local)


def _key_tiles(kind, r0, r1, Skv, step, q_offset, causal, sink, local):
    n = -(-Skv // step)
    if kind == "flash":
        if causal:
            n = min(n, (q_offset + r1) // step + 1)
        return list(range(n))
    last = min(n - 1, (q_offset + r1) // step)
    a1 = min(-(-sink // step), last + 1)
    w0 = max(_floor_div(q_offset + r0 - (local - 1), step), 0)
    return list(range(a1)) + list(range(max(w0, a1), last + 1))


def _query_tiles(kind, c0, c1, Sq, step, q_offset, causal, sink, local):
    t1 = -(-Sq // step)
    if kind == "flash":
        t0 = max(c0 - q_offset, 0) // step if causal else 0
        return list(range(t0, t1))
    t0 = max(c0 - q_offset, 0) // step
    if c0 >= sink:
        hi = c1 + local - 1 - q_offset
        t1 = 0 if hi < 0 else min(t1, hi // step + 1)
    return list(range(t0, t1))


WALKS = [  # (kind, Sq, Skv, q_offset, causal, sink, local)
    ("flash", 200, 300, 100, True, 0, 1),
    ("flash", 200, 300, 0, False, 0, 1),
    ("flash", 4096 // 16, 4096 // 16, 0, True, 0, 1),
    ("flash", 130, 130, 0, True, 0, 1),
    ("streaming", 200, 300, 100, True, 16, 48),
    ("streaming", 200, 300, 100, True, 100, 130),
    ("streaming", 200, 300, 100, True, 0, 48),
    ("streaming", 300, 300, 0, True, 8, 32),
    ("streaming", 300, 300, 0, True, 70, 200),
    ("streaming", 257, 257, 0, True, 128, 64),
    ("streaming", 96, 400, 300, True, 0, 1),
]


@pytest.mark.parametrize("step", [64, 32])
@pytest.mark.parametrize("walk", range(len(WALKS)))
def test_tile_walks_cover_every_visible_pair(walk, step):
    kind, Sq, Skv, off, causal, sink, local = WALKS[walk]
    pol = (off, causal, sink, local)
    vis = np.array([[_visible(kind, r, c, *pol) for c in range(Skv)]
                    for r in range(Sq)])
    by_rows = np.zeros_like(vis)  # dq_kernel: a CTA of 64 rows, tiles of step
    for r0 in range(0, Sq, ROWS):
        r1 = min(r0 + ROWS, Sq) - 1
        tiles = _key_tiles(kind, r0, r1, Skv, step, *pol)
        assert len(tiles) == len(set(tiles)), "a tile walked twice"
        for t in tiles:
            by_rows[r0:r1 + 1, t * step:(t + 1) * step] = True
    by_keys = np.zeros_like(vis)  # dkdv_kernel: 64 keys, query tiles of step
    for c0 in range(0, Skv, ROWS):
        c1 = min(c0 + ROWS, Skv) - 1
        for t in _query_tiles(kind, c0, c1, Sq, step, *pol):
            by_keys[t * step:(t + 1) * step, c0:c1 + 1] = True
    assert vis.any()
    assert not (vis & ~by_rows).any(), "dq misses a visible pair"
    assert not (vis & ~by_keys).any(), "dk / dv miss a visible pair"


# ---------------------------------------------------------------------------
# The CUDA route, with the device test answering "cuda"
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_card(monkeypatch):
    """``_build.on_cpu`` answers False and every kernel binding records
    its launches instead of launching."""
    import repro_torch.kernels as KN
    from repro_torch.kernels import decode_attention
    launched = []
    monkeypatch.setattr(_build, "on_cpu", lambda name, t: False)
    monkeypatch.setattr(decode_attention, "sm_count", lambda index: 132)
    for name, k in KN.KERNELS.items():
        monkeypatch.setattr(k, "launch", lambda dev, *a, _n=name:
                            launched.append((_n, a)))
    return launched


def test_entries_record_for_autograd_only_under_grad(fake_card):
    from repro_torch.kernels.flash_attention import flash_attention_bh
    from repro_torch.kernels.streaming_attention import \
        streaming_attention_bh
    q = torch.zeros((4, 64, 32))
    out = flash_attention_bh(q, q, q)
    assert out.grad_fn is None and fake_card[-1][0] == "flash_attention"
    qg = q.clone().requires_grad_()
    out = flash_attention_bh(qg, q, q, q_offset=3)
    assert type(out.grad_fn).__name__ == "_AttentionBackward"
    assert [n for n, _ in fake_card] == ["flash_attention"] * 2
    out = streaming_attention_bh(q, qg, q, sink=4, local=8)
    assert out.grad_fn is not None
    with torch.no_grad():
        assert streaming_attention_bh(qg, q, q, sink=4, local=8).grad_fn \
            is None
    assert [n for n, _ in fake_card][2:] == ["streaming_attention"] * 2
    out.sum().backward()  # the backward entry launches (recorded)
    name, args = fake_card[-1]
    assert name == "attention_backward" and len(args) == 21
    # q, k, v, dout, dq, dk, dv, stats, BH, BHkv, Sq, Skv, D, dtype, kind,
    # causal, sink, local, q_offset, scale, Dv
    assert args[0] == q.data_ptr() and args[8:14] == (4, 4, 64, 64, 32, 0)
    assert args[14] == AB.STREAMING and args[16:19] == (4, 8, 0)
    assert args[20] == 32
    # MLA's (192, 128) records too, and its backward launches at (192, 128)
    qm = torch.zeros((4, 64, 192)).requires_grad_()
    out = flash_attention_bh(qm, torch.zeros((4, 64, 192)),
                             torch.zeros((4, 64, 128)))
    assert out.grad_fn is not None and out.shape == (4, 64, 128)
    assert fake_card[-1][0] == "flash_attention"
    out.sum().backward()
    name, args = fake_card[-1]
    assert name == "attention_backward" and (args[12], args[20]) == (192, 128)
    with pytest.raises(ValueError, match="out="):
        flash_attention_bh(qg, q, q, out=torch.empty_like(q))


def test_kernels_without_backward_refuse_grad(fake_card):
    """The decode kernels (no training path runs them) refuse an operand
    that requires grad before any launch, and launch as before without
    grad; block-sparse and xa (``block_topk``), which have a backward
    kernel, launch as before without grad and under grad record their
    launch for autograd and launch the block-sparse backward."""
    from repro_torch.kernels.block_sparse_attention import \
        block_sparse_attention_bh
    from repro_torch.kernels.decode_attention import decode_attention_bh
    from repro_torch.kernels.decode_attention_pooled import \
        decode_attention_pooled_bh
    q = torch.zeros((4, 64, 32))
    qg = q.clone().requires_grad_()
    sel = torch.zeros((4, 1, 1), dtype=torch.int32)
    pos = torch.arange(64, dtype=torch.int32)
    lengths = torch.full((4,), 64, dtype=torch.int32)
    q4 = torch.zeros((1, 4, 128, 32))  # two 64-key blocks for xa's top-2
    refusing = [
        lambda a: decode_attention_bh(a[:, :1].contiguous(), q, q, pos, 9),
        lambda a: decode_attention_pooled_bh(a[:, :1].contiguous(), q, q,
                                             None, lengths, n_heads=1),
    ]
    for call in refusing:
        n = len(fake_card)
        with pytest.raises(NotImplementedError, match="decode kernel"):
            call(qg)
        assert len(fake_card) == n, "launched before refusing"
        call(q)  # without grad: launched as before
        assert len(fake_card) > n
    # (call, its BH, BHkv, Sq, Skv)
    training = [
        (lambda a: block_sparse_attention_bh(a, q, q, sel), (4, 4, 64, 64)),
        (lambda a: TM.attention(torch.cat([a, a], 1).reshape(1, 4, 128, 32),
                                q4, q4, TM.AttnMode("block_topk", block=64,
                                                    stride=4,
                                                    threshold=0.5)),
         (4, 4, 128, 128)),
    ]
    for call, dims in training:
        n = len(fake_card)
        assert call(q).grad_fn is None  # without grad: launched as before
        assert [k for k, _ in fake_card[n:]] == ["block_sparse_attention"]
        out = call(qg)
        assert out.grad_fn is not None
        assert fake_card[-1][0] == "block_sparse_attention"
        out.sum().backward()
        name, args = fake_card[-1]
        assert name == "block_sparse_backward" and len(args) == 22
        # q .. items (12 pointers), BH, BHkv, Sq, Skv, Dk, Dv, dtype
        assert args[12:16] == dims and args[16:19] == (32, 32, 0)


def test_plain_bf16_gradient_is_straight_through():
    """In bf16 the plain version's gradient is that of its arithmetic
    with the rounding of p as the identity and the row max a constant,
    the backward kernel's: here against that formula in float64, each
    gradient within half a bf16 ulp (a correct rounding) plus 5 % of the
    tensor's rms, i.e. under 0.5 of phase 3's bf16 limit. Autograd
    through the cast and the max reads 0.6-0.8 of the limit at this
    shape."""
    g = torch.Generator().manual_seed(0)
    BH, S, D = 4, 256, 64
    q, k, v, do = (torch.randn(BH, S, D, generator=g).to(torch.bfloat16)
                   for _ in range(4))
    got = AB.attention_backward_plain(q, k, v, do, causal=True)
    qf, kf, vf, dof = (t.double() for t in (q, k, v, do))
    s = torch.einsum("hqd,hkd->hqk", qf, kf) * D ** -0.5
    mask = torch.ones(S, S, dtype=torch.bool).tril()
    e = torch.exp(s - s.masked_fill(~mask, -1e30).amax(-1, keepdim=True))
    e = e * mask
    l = e.sum(-1, keepdim=True)
    P, Pr = e / l, e.float().to(torch.bfloat16).double() / l
    dP = torch.einsum("hqd,hkd->hqk", dof, vf)
    dS = P * (dP - (Pr * dP).sum(-1, keepdim=True))
    want = (torch.einsum("hqk,hkd->hqd", dS, kf) * D ** -0.5,
            torch.einsum("hqk,hqd->hkd", dS, qf) * D ** -0.5,
            torch.einsum("hqk,hqd->hkd", Pr, dof))
    for a, w in zip(got, want):
        limit = 0.05 * w.square().mean().sqrt() + 2.0 ** -7 * w.abs()
        assert float(((a.double() - w).abs() / limit).max()) < 0.5


# ---------------------------------------------------------------------------
# The bf16 engine's arithmetic (ref.attention_backward_tiled_ref) and its
# walks and masks (csrc/backward_wgmma.cuh)
# ---------------------------------------------------------------------------

# kind → (JAX mode, the backward entry's keywords); sinks straddle a
# 64-key tile (16, 100) or sit on its edge (64), windows narrower and
# wider than a tile
TILED = {
    "flash causal": (dict(kind="full"), dict(causal=True)),
    "flash bidirectional": (dict(kind="full", causal=False),
                            dict(causal=False)),
    "streaming 16/48": (dict(kind="streaming", sink=16, local=48),
                        dict(sink=16, local=48)),
    "streaming 100/130": (dict(kind="streaming", sink=100, local=130),
                          dict(sink=100, local=130)),
    "streaming 64/80": (dict(kind="streaming", sink=64, local=80),
                        dict(sink=64, local=80)),
    "window 70": (dict(kind="window", local=70), dict(sink=0, local=70)),
}
# (B, Hq, Hkv, Sq, Skv, q_offset): unaligned rows and keys at an offset
# (G = 2), and a causal square from position 0 (G = 1), whose first rows
# see one to a few keys: the gradient cancels there
TILED_SHAPES = {"unaligned": (1, 4, 2, 200, 300, 100),
                "square": (1, 2, 2, 150, 150, 0)}


@pytest.mark.parametrize("shape", sorted(TILED_SHAPES))
@pytest.mark.parametrize("kind", sorted(TILED))
def test_tiled_ref_matches_jax(kind, shape):
    """The bf16 engine's step-by-step arithmetic in float32 (its packings
    are then no-ops) against ``jax.vjp`` of ``repro.core.modes.attention``
    at TOL: the three dq passes with their online max, D_i from round(p),
    and the transposed dk / dv walk over the G heads' query tiles."""
    B, Hq, Hkv, Sq, Skv, off = TILED_SHAPES[shape]
    mode, kw = TILED[kind]
    if not mode.get("causal", True):
        off = 0
    q, k, v, do = _inputs(len(kind) + Sq, B, Hq, Hkv, Sq, Skv)
    want = _jax_grads(q, k, v, do, mode, off)
    got = ref.attention_backward_tiled_ref(_flat(q), _flat(k), _flat(v),
                                           _flat(do), q_offset=off, **kw)
    assert all(float(g.abs().max()) > 0 for g in got)
    _close([g.reshape(w.shape) for g, w in zip(got, want)], want)


def _bf16_limit_ratio(got, want):
    """phase 3's bf16 limit: max |got - want| / (0.05 rms(want) + 2^-7
    |want|), below 1 passes."""
    w = want.double()
    limit = 0.05 * w.square().mean().sqrt() + 2.0 ** -7 * w.abs()
    return float(((got.double() - w).abs() / limit).max())


@pytest.mark.parametrize("kind", sorted(TILED))
def test_tiled_ref_bf16_within_limit_of_plain(kind):
    """In bf16 the engine's arithmetic, with round(p) / l and dS in two
    bf16 parts where the kernel splits them, holds
    ``attention_backward_plain`` within phase 3's limit (each of dq, dk, dv
    at under 0.75 of it), the
    first rows of a causal square included: row 0 sees key 0 alone, so
    dP - D_i is 0 there and its dq is exactly 0."""
    _, kw = TILED[kind]
    g = torch.Generator().manual_seed(len(kind))
    BH, BHkv, S, D = 4, 2, 192, 64
    q, do = (torch.randn(BH, S, D, generator=g).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(BHkv, S, D, generator=g).to(torch.bfloat16)
            for _ in range(2))
    got = ref.attention_backward_tiled_ref(q, k, v, do, **kw)
    want = AB.attention_backward_plain(q, k, v, do, **kw)
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert _bf16_limit_ratio(a, w) < 0.75
    if kw.get("causal", True):  # every kind but bidirectional flash
        assert not got[0][:, 0].any()
        assert _bf16_limit_ratio(got[0][:, :8], want[0][:, :8]) < 0.75


def _full(kind, r0, r1, k0, k1, q_offset, causal, sink, local):
    """``Policy::full`` (csrc/backward_wgmma.cuh), transcribed."""
    if kind == "flash":
        return not causal or k1 <= q_offset + r0
    return k1 <= q_offset + r0 and (k1 < sink or q_offset + r1 - k0 < local)


@pytest.mark.parametrize("walk", range(len(WALKS)))
def test_engine_walks_and_unmasked_tiles(walk):
    """The engine walks the policies' tiles above at 64 (dq's three
    passes repeat one row block's walk, dk / dv's repeats its query tiles
    for each of the G heads). A tile that runs with no mask (``full``,
    inside Sq and Skv) holds visible pairs only, in dq's walk and in dk /
    dv's, and the masked tiles are few: at most two a row block along a
    causal diagonal or a window's two edges, plus the ragged edges."""
    kind, Sq, Skv, off, causal, sink, local = WALKS[walk]
    pol = (off, causal, sink, local)
    vis = np.array([[_visible(kind, r, c, *pol) for c in range(Skv)]
                    for r in range(Sq)])
    for r0 in range(0, Sq, ROWS):
        r1 = min(r0 + ROWS, Sq) - 1
        masked = 0
        for t in _key_tiles(kind, r0, r1, Skv, ROWS, *pol):
            k0, k1 = t * ROWS, t * ROWS + ROWS - 1
            if k1 < Skv and _full(kind, r0, r0 + ROWS - 1, k0, k1, *pol):
                assert vis[r0:r1 + 1, k0:k1 + 1].all(), (r0, t)
            else:
                masked += 1
        assert masked <= (2 if kind == "flash" else 4) + 1 + (sink % ROWS > 0)
    for c0 in range(0, Skv, ROWS):
        c1 = min(c0 + ROWS, Skv) - 1
        for t in _query_tiles(kind, c0, c1, Sq, ROWS, *pol):
            r0, r1 = t * ROWS, t * ROWS + ROWS - 1
            if (r1 < Sq and c0 + ROWS <= Skv
                    and _full(kind, r0, r1, c0, c0 + ROWS - 1, *pol)):
                assert vis[r0:r1 + 1, c0:c0 + ROWS].all(), (c0, t)


def _misaligned(shape, dtype):
    """A contiguous tensor of ``shape`` whose base is one element past a
    16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


def test_backward_entry_launches_by_dtype(fake_card):
    """bf16 operands launch the C entry with dtype code 1 (its TMA + wgmma
    engine, so their bases must be 16-byte aligned: an unaligned dout
    raises before any launch); fp32 operands launch code 0 (the CUDA-core
    kernels, no alignment needed); ``out=`` hands the kernel its tensors;
    (Dk, Dv) = (192, 128) launches with both widths."""
    q = torch.zeros((4, 100, 64), dtype=torch.bfloat16)
    k = torch.zeros((2, 130, 64), dtype=torch.bfloat16)
    outs = tuple(torch.empty_like(t) for t in (q, k, k))
    got = AB.attention_backward_bh(q, k, k, q, sink=16, local=48,
                                   q_offset=30, out=outs)
    assert all(a is b for a, b in zip(got, outs))
    name, args = fake_card[-1]
    assert name == "attention_backward"
    assert args[4:7] == tuple(t.data_ptr() for t in outs)
    # BH, BHkv, Sq, Skv, D, dtype, kind, causal, sink, local, q_offset
    assert args[8:19] == (4, 2, 100, 130, 64, 1, AB.STREAMING, 1, 16, 48,
                          30)
    n = len(fake_card)
    with pytest.raises(ValueError, match="16-byte aligned"):
        AB.attention_backward_bh(q, k, k, _misaligned(q.shape, q.dtype))
    assert len(fake_card) == n, "launched before refusing"
    qf, kf = q.float(), k.float()
    AB.attention_backward_bh(qf, kf, kf, _misaligned(qf.shape, qf.dtype),
                             causal=False)
    name, args = fake_card[-1]
    assert len(fake_card) == n + 1 and args[13:16] == (0, AB.FLASH, 0)
    AB.attention_backward_bh(torch.zeros((4, 64, 192)),
                             torch.zeros((4, 64, 192)),
                             torch.zeros((4, 64, 128)),
                             torch.zeros((4, 64, 128)))
    name, args = fake_card[-1]
    assert len(fake_card) == n + 2 and (args[12], args[20]) == (192, 128)


def test_backward_entry_takes_padded_stats(fake_card):
    """The kernels' scratch is (3, BH, Sq rounded up to 64) float32: a
    fresh one by default, or the test's ``stats=`` handed through as it
    is (phase 2b's NaN-filled scratch); any other raises before a
    launch."""
    q = torch.zeros((4, 100, 64), dtype=torch.bfloat16)
    k = torch.zeros((2, 130, 64), dtype=torch.bfloat16)
    stats = torch.full((3, 4, 128), float("nan"))
    AB.attention_backward_bh(q, k, k, q, stats=stats)
    assert fake_card[-1][1][7] == stats.data_ptr()
    n = len(fake_card)
    for bad in (torch.zeros((3, 4, 100)), torch.zeros((3, 4, 128),
                                                      dtype=torch.float64),
                torch.zeros((3, 128, 4)).transpose(1, 2)):
        with pytest.raises(ValueError, match="stats must be"):
            AB.attention_backward_bh(q, k, k, q, stats=bad)
    assert len(fake_card) == n, "launched before refusing"


def test_kernel_of_another_build_binds_that_library(monkeypatch, tmp_path):
    """``CudaKernel.of`` names the same entry point in another library
    (an earlier tree's build, as chip_smoke's ``--parent`` times it):
    same argument types, a count of its own, and a missing library is an
    error, never a build of this tree's source."""
    other = AB.KERNEL.of(tmp_path / "libattention_backward-parent.so")
    assert (other.source, other.symbol) == (AB.KERNEL.source,
                                            AB.KERNEL.symbol)
    assert other.argtypes == AB.KERNEL.argtypes
    assert other.launches == 0 and other is not AB.KERNEL

    def no_build(names):
        raise AssertionError(f"built {names}")
    monkeypatch.setattr(_build, "build", no_build)
    with pytest.raises(OSError):
        other._bind()


def test_backward_out_on_cpu_is_the_plain_gradient():
    """On CPU tensors ``out=`` receives the plain version's gradients."""
    q, k, v, do = (_flat(x) for x in _inputs(7, 1, 4, 2, 48, 80))
    kw = dict(sink=SINK, local=LOCAL, q_offset=32)
    outs = tuple(torch.full_like(t, float("nan")) for t in (q, k, v))
    got = AB.attention_backward_bh(q, k, v, do, out=outs, **kw)
    want = AB.attention_backward_plain(q, k, v, do, **kw)
    assert all(a is b for a, b in zip(got, outs))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="out must be"):
        AB.attention_backward_bh(q, k, v, do, out=(q, k, q), **kw)
