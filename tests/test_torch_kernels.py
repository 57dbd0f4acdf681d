"""The port's kernel entries (CPU: their plain versions) against the JAX
package's Pallas kernels in interpret mode, on the same numpy inputs.

Tolerance 2e-5 in float32: both sides compute the same masked softmax in
float32 and differ only in summation order (the Pallas kernels sum
online over key blocks, the plain versions in one dense pass).
"""
import re
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread: as fast at these small shapes, and it leaves the other
# cores to the test processes running beside this one
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import modes as JM  # noqa: E402
from repro.kernels import ops  # noqa: E402
from repro.kernels.block_sparse_attention import \
    dedupe_selection as jax_dedupe  # noqa: E402
from repro_torch.core import modes as TM  # noqa: E402
from repro_torch.kernels import KERNELS, _build, launch_counts  # noqa: E402
from repro_torch.kernels.block_sparse_attention import (  # noqa: E402
    KERNEL_BLOCK, block_sparse_attention_bh, dedupe_selection)
from repro_torch.kernels.decode_attention import \
    decode_attention_bh  # noqa: E402
from repro_torch.kernels.ref import \
    block_sparse_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention_bh  # noqa: E402
from repro_torch.kernels.streaming_attention import \
    streaming_attention_bh  # noqa: E402

TOL = 2e-5


def mk(seed, B, Hq, Hkv, Sq, Skv, D):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hq, Sq, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, Skv, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, Skv, D)).astype(np.float32)
    return q, k, v


def fl(x):
    """(B, H, S, D) numpy → the kernels' flattened (B·H, S, D) tensor."""
    return torch.from_numpy(x.reshape(-1, *x.shape[2:]))


def err(port, jax_out):
    return float(np.abs(port.numpy().reshape(np.shape(jax_out))
                        - np.asarray(jax_out)).max())


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,bq,bk,q_offset", [
    (1, 2, 1, 128, 128, 32, 32, 32, 0),
    (2, 4, 2, 100, 100, 16, 32, 32, 0),   # unaligned seq
    (1, 2, 2, 256, 256, 64, 64, 128, 0),  # bk > bq
    (1, 8, 2, 64, 64, 8, 16, 16, 0),      # G = 4
    (1, 2, 1, 100, 100, 96, 32, 32, 0),   # D = 96 (phi3's head dim)
    (1, 4, 2, 40, 104, 32, 16, 32, 64),   # query chunk at an offset
])
def test_flash_attention(B, Hq, Hkv, Sq, Skv, D, bq, bk, q_offset):
    q, k, v = mk(0, B, Hq, Hkv, Sq, Skv, D)
    want = ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), block_q=bq, block_k=bk,
                               q_offset=q_offset, interpret=True)
    got = flash_attention_bh(fl(q), fl(k), fl(v), q_offset=q_offset)
    assert err(got, want) < TOL


def test_flash_attention_bidirectional():
    q, k, v = mk(1, 1, 2, 2, 96, 96, 32)
    want = ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=False, block_q=32,
                               block_k=32, interpret=True)
    got = flash_attention_bh(fl(q), fl(k), fl(v), causal=False)
    assert err(got, want) < TOL


@pytest.mark.parametrize("S,sink,local,bq,bk,D", [
    (256, 32, 64, 32, 32, 32),
    (200, 16, 48, 32, 32, 32),   # unaligned seq
    (128, 0, 32, 32, 32, 32),    # pure window
    (256, 32, 32, 64, 32, 32),   # window smaller than q block
    (200, 8, 40, 32, 32, 96),    # D = 96
])
def test_streaming_attention(S, sink, local, bq, bk, D):
    q, k, v = mk(2, 1, 2, 1, S, S, D)
    want = ops.streaming_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), sink=sink, local=local,
                                   block_q=bq, block_k=bk, interpret=True)
    got = streaming_attention_bh(fl(q), fl(k), fl(v), sink=sink,
                                 local=local)
    assert err(got, want) < TOL


@pytest.mark.parametrize("L,cur,ring,D", [(96, 63, False, 32),
                                          (96, 39, True, 32),
                                          (130, 100, False, 32),
                                          (130, 77, True, 96)])
def test_decode_attention(L, cur, ring, D):
    B, Hq, Hkv = 2, 4, 2
    q, k, v = mk(3, B, Hq, Hkv, 1, L, D)
    if ring:  # a ring permutation: live positions in shuffled slots
        perm = np.concatenate([np.arange(cur + 1), -np.ones(L - cur - 1)])
        pos = np.random.default_rng(4).permutation(perm).astype(np.int32)
    else:
        pos = np.arange(L, dtype=np.int32)
    want = ops.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(pos),
                                jnp.int32(cur), block_k=32, interpret=True)
    got = decode_attention_bh(fl(q), fl(k), fl(v), torch.from_numpy(pos),
                              cur)
    assert err(got, want) < TOL


def _random_selection(rng, BH, nqb, K):
    sel = np.full((BH, nqb, K), -1, np.int32)
    for h in range(BH):
        for i in range(nqb):
            cand = rng.choice(i + 1, size=min(K, i + 1), replace=False)
            sel[h, i, :len(cand)] = cand
            if i not in cand:
                sel[h, i, 0] = i
    return sel


@pytest.mark.parametrize("S,D,blk,q_offset", [(256, 32, 32, 0),
                                              (200, 96, 32, 0),
                                              (128, 32, 32, 64),
                                              (200, 96, 64, 128)])
def test_block_sparse_attention(S, D, blk, q_offset):
    """At the kernel's block through the entry; at other blocks through
    the plain version the entry runs on the CPU."""
    Hq, Hkv = 4, 1  # G = 4
    q, k, v = mk(5, 1, Hq, Hkv, S, S + q_offset, D)
    nqb = -(-S // blk)
    sel = _random_selection(np.random.default_rng(6), Hq, nqb, 3)
    sel = (sel + q_offset // blk * (sel >= 0)).astype(np.int32)
    want = ops.block_sparse_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(sel.reshape(1, Hq, nqb, 3)), q_offset=q_offset,
        block=blk, interpret=True)
    if blk == KERNEL_BLOCK:
        got = block_sparse_attention_bh(fl(q), fl(k), fl(v),
                                        torch.from_numpy(sel),
                                        q_offset=q_offset)
    else:
        got = block_sparse_attention_ref(fl(q), fl(k), fl(v),
                                         torch.from_numpy(sel), block=blk,
                                         q_offset=q_offset)
    assert err(got, want) < TOL


def test_dedupe_selection_matches_jax():
    sel = np.random.default_rng(7).integers(-1, 5, size=(3, 4, 6),
                                            dtype=np.int32)
    want = np.asarray(jax_dedupe(jnp.asarray(sel)))
    got = dedupe_selection(torch.from_numpy(sel)).numpy()
    assert np.array_equal(got, want)


def test_block_sparse_duplicate_selection_deduped():
    q, k, v = mk(8, 1, 1, 1, 128, 128, 16)
    sel = torch.tensor([[[0, 0, 0], [0, 1, 1]]], dtype=torch.int32)
    clean = torch.tensor([[[0, -1, -1], [0, 1, -1]]], dtype=torch.int32)
    a = block_sparse_attention_bh(fl(q), fl(k), fl(v),
                                  dedupe_selection(sel))
    b = block_sparse_attention_bh(fl(q), fl(k), fl(v), clean)
    assert float((a - b).abs().max()) < 1e-6  # same selection, same sums


@pytest.mark.parametrize("start,C", [(0, 24), (40, 24), (100, 64),
                                     (64, 64)])
def test_chunk_causal_attention_matches_jax_pallas(start, C):
    """The streamed-chunk FA path: the causal selection over a cache
    buffer at a chunk offset > 0, against the JAX block-sparse Pallas
    kernel (interpret mode) and the JAX dense reference."""
    B, Hq, Hkv, M, D = 2, 4, 2, 192, 32
    q, k, v = mk(9, B, Hq, Hkv, C, M, D)
    k[:, :, start + C:] = 0  # slots past the chunk are unwritten
    v[:, :, start + C:] = 0
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    dense = JM.chunk_causal_attention(jq, jk, jv, jnp.int32(start))
    with JM.chunk_attention_backend("pallas", block=64, interpret=True):
        pallas = JM.chunk_causal_attention(jq, jk, jv, jnp.int32(start))
    got = TM.chunk_causal_attention(*(torch.from_numpy(x)
                                      for x in (q, k, v)), start)
    assert err(got, pallas) < TOL
    assert err(got, dense) < TOL


def test_causal_selection_matches_jax():
    start, C, M, blk = 100, 150, 400, KERNEL_BLOCK
    nqb, K = -(-C // blk), -(-M // blk)
    qb, kb = np.arange(nqb), np.arange(K)
    last_vis = (start + np.minimum((qb + 1) * blk, C) - 1) // blk
    want = np.where(kb[None, :] <= last_vis[:, None], kb[None, :], -1)
    got = TM.causal_selection(start, C, M, 3, "cpu")
    assert got.shape == (3, nqb, K) and got.dtype == torch.int32
    assert all(np.array_equal(g, want) for g in got.numpy())


def test_cpu_entries_never_count_launches():
    before = launch_counts()
    q, k, v = mk(10, 1, 2, 2, 16, 16, 32)
    flash_attention_bh(fl(q), fl(k), fl(v))
    streaming_attention_bh(fl(q), fl(k), fl(v), sink=4, local=8)
    assert launch_counts() == before


def test_entries_reject_bad_operands():
    q, k, v = mk(11, 1, 2, 2, 16, 16, 32)
    with pytest.raises(ValueError):
        flash_attention_bh(fl(q), fl(k)[:, :8], fl(v))
    with pytest.raises(ValueError):
        flash_attention_bh(fl(q), fl(k).double(), fl(v))
    with pytest.raises(ValueError):
        decode_attention_bh(fl(q)[:, :1], fl(k), fl(v),
                            torch.arange(16), 3)  # int64 positions
    with pytest.raises(ValueError):
        block_sparse_attention_bh(fl(q), fl(k), fl(v),
                                  torch.zeros((2, 5, 1), dtype=torch.int32))


@pytest.mark.parametrize("change", ["edit", "add"])
def test_library_name_tracks_every_header(tmp_path, monkeypatch, change):
    """A library's name hashes its .cu and every csrc/*.cuh, so editing a
    byte of any header (here the wgmma engine's, which attention_common.cuh
    does not name) or adding one renames every library and a stale build
    is never loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.library_path(n).name for n in _build.SOURCES}
    assert before == {n: _build.library_path(n).name
                      for n in _build.SOURCES}  # deterministic
    if change == "edit":
        hdr = csrc / "prefill_wgmma.cuh"
        data = bytearray(hdr.read_bytes())
        data[len(data) // 2] ^= 1
        hdr.write_bytes(bytes(data))
    else:
        (csrc / "zz_extra.cuh").write_text("#pragma once\n")
    after = {n: _build.library_path(n).name for n in _build.SOURCES}
    assert all(after[n] != before[n] for n in _build.SOURCES)


_CTYPE = {"void*": "c_void_p", "int": "c_int", "float": "c_float"}


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_entry_argtypes_match_c_signature(name):
    """Each binding's ctypes argtypes (the stream included) match its
    extern "C" entry point's parameters in number and kind, parsed from
    the .cu source: a mismatch would cut or shift arguments silently."""
    kern = KERNELS[name]
    src = (_build.CSRC / f"{kern.source}.cu").read_text()
    m = re.search(r'extern "C" int ' + kern.symbol + r"\(([^)]*)\)", src)
    assert m, f"no extern \"C\" entry {kern.symbol} in {kern.source}.cu"
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    kinds = [_CTYPE["void*" if "*" in p else p.split()[-2]] for p in params]
    assert len(kern.argtypes) == len(params)
    assert [t.__name__ for t in kern.argtypes] == kinds


def test_tma_alignment_is_checked():
    x = torch.zeros(64, dtype=torch.bfloat16)
    _build.check_tma_aligned("t", x)
    with pytest.raises(ValueError, match="16-byte"):
        _build.check_tma_aligned("t", x[1:])  # 2 bytes past an aligned base
