"""One-token decode attention over a KV cache.

Port of ``repro/kernels/decode_attention.py::decode_attention_bh`` (the
batch-synchronous entry: one positions vector shared by every row). On
CUDA tensors the entry launches the hand-written kernel
``csrc/decode_attention.cu`` or raises: split-KV, one CTA per (KV row,
key range), then a merge of the ranges' partial softmax states by their
log-sum-exp. On CPU tensors it runs the plain version, the dense masked
softmax of ``ref.decode_attention_ref``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import \
    decode_attention_ref as decode_attention_plain  # noqa: F401

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, positions, o, part_acc, part_m, part_l, BH, BHkv, L, D, dtype,
# n_split, cur_pos, scale
KERNEL = _build.CudaKernel("decode_attention", "decode_attention_fwd",
                           [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _I, _F])

TILE = 64        # keys of one tile (csrc/decode_attention.cu: kKeys)
MAX_G = 8        # query rows of one CTA when G > 1 (kMaxG)
MAX_SPLIT_TILES = {1: 256, MAX_G: 64}  # tiles a split may hold (max_tiles)
MIN_TILES = 2    # the fewest tiles a split gets when L is cut


def _tiles(L: int) -> int:
    return -(-L // TILE)


def normalize_split(L: int, n_split: int, G: int = 1) -> int:
    """The number of key ranges the kernel launches for ``n_split``
    asked, with G query rows per KV row: at most one a tile, so none is
    empty, and enough that no range holds more than MAX_SPLIT_TILES."""
    cap = MAX_SPLIT_TILES[1 if G == 1 else MAX_G]
    return max(1, -(-_tiles(L) // cap), min(int(n_split), _tiles(L)))


def decode_split_plan(BHkv: int, G: int, L: int, sms: int) -> int:
    """How many key ranges each KV row of an (BHkv, L) cache is cut into,
    for G query rows per KV row on a card of ``sms`` multiprocessors: as
    many as still fit one CTA per multiprocessor (rows * n <= sms), so
    half the card's rows or more run uncut; at least MIN_TILES tiles a
    range, one range when L is small. On an H100 this is the fastest
    count at 128 rows and 4-5 % over the fastest at 64 and 32 (PERF.md,
    decode by n_split)."""
    rows = BHkv * -(-G // MAX_G)
    return normalize_split(L, min(max(1, sms // rows), _tiles(L) // MIN_TILES),
                           G)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_ranges(L: int, n_split: int) -> List[Tuple[int, int]]:
    """The [start, end) key range of each of n_split (normalized) splits,
    as the kernel computes them: split s takes tiles
    [s·n // n_split, (s + 1)·n // n_split) of the n = ceil(L / 64)."""
    n = _tiles(L)
    return [(s * n // n_split * TILE, min((s + 1) * n // n_split * TILE, L))
            for s in range(n_split)]


POOL_TILES = 8   # tiles a range of the pooled decode holds (its plan)


def normalize_tiles(L: int, tiles: int, G: int = 1) -> int:
    """The tiles a range of the pooled decode kernel holds for ``tiles``
    asked over an L-slot buffer, with G query rows per KV row: at least
    one, at most the buffer's and MAX_SPLIT_TILES."""
    cap = MAX_SPLIT_TILES[1 if G == 1 else MAX_G]
    return max(1, min(int(tiles), _tiles(L), cap))


def pooled_split_plan(L: int, G: int = 1) -> int:
    """How many whole 64-key tiles each range of the pooled decode kernel
    holds over an L-slot buffer (csrc/decode_attention_pooled.cu): the
    grid is built from the capacity, ceil(ceil(L / 64) / tiles) ranges a
    KV row, and a range past its slot's live length returns at once.

    POOL_TILES = 8 whatever the pool's size: ranges of a fixed size give
    every working CTA the same bytes (8 K and 8 V tiles), so the number of
    working CTAs follows the pool's live tiles, and four CTAs fit on a
    multiprocessor. On an H100 it is the fastest of 1 to 65 tiles at 4, 8
    and 16 slots of phi3-mini's ragged pool (PERF.md, pooled decode by
    tiles): fewer tiles add CTA set-up and merge traffic, more leave the
    deepest slot's ranges running alone at the end."""
    return normalize_tiles(L, POOL_TILES, G)


def pooled_ranges(n: int, L: int, tiles: int) -> List[Tuple[int, int]]:
    """The [start, end) keys of each range of ``tiles`` tiles that runs
    for a slot of live length n (clamped to [0, L]), as the kernel cuts
    them: ranges start every tiles·64 keys below n, the last cut at n; the
    ranges past it read nothing."""
    n, span = min(max(int(n), 0), L), tiles * TILE
    return [(s, min(s + span, n)) for s in range(0, n, span)]


def decode_attention_bh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        positions: torch.Tensor, cur_pos: int, *,
                        scale: Optional[float] = None,
                        n_split: Optional[int] = None) -> torch.Tensor:
    """q (BH, 1, D); k/v (BHkv, L, D); positions (L,) int32 absolute
    position of each cache slot (-1 = empty); slot j is visible iff
    0 <= positions[j] <= cur_pos. Returns (BH, 1, D). ``n_split`` forces
    the number of key ranges (normalized as the kernel runs it); by
    default ``decode_split_plan`` picks it."""
    name = "decode_attention_bh"
    _build.check_operands(name, q, k, v)
    L = k.shape[1]
    if q.shape[1] != 1:
        raise ValueError(f"{name}: q must hold one token per row; got "
                         f"{tuple(q.shape)}")
    if (positions.shape != (L,) or positions.dtype != torch.int32
            or positions.device != q.device):
        raise ValueError(f"{name}: positions must be ({L},) int32 on "
                         f"{q.device}; got {tuple(positions.shape)} "
                         f"{positions.dtype} on {positions.device}")
    if _build.on_cpu(name, q):
        return decode_attention_plain(q, k, v, positions, cur_pos,
                                      scale=scale)
    code = _build.check_cuda(name, q, k, v, positions)
    _build.check_aligned16(name, "its TMA bulk loads", k, v)
    BH, _, D = q.shape
    BHkv = k.shape[0]
    n = (decode_split_plan(BHkv, BH // BHkv, L, sm_count(q.device.index))
         if n_split is None else normalize_split(L, n_split, BH // BHkv))
    out = torch.empty_like(q)
    ptrs = (0, 0, 0)
    if n > 1:  # the splits' fp32 (acc, m, l), merged by the same entry
        acc = torch.empty((BH, n, D), dtype=torch.float32, device=q.device)
        ml = torch.empty((2, BH, n), dtype=torch.float32, device=q.device)
        ptrs = (acc.data_ptr(), ml[0].data_ptr(), ml[1].data_ptr())
    KERNEL.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  positions.data_ptr(), out.data_ptr(), *ptrs, BH, BHkv, L,
                  D, code, n, int(cur_pos), _build.default_scale(D, scale))
    return out
