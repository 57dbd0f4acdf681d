"""One-token decode attention for the continuous-batching slot pool.

Port of ``repro/kernels/decode_attention.py::decode_attention_pooled_bh``
(body ``_pooled_kernel``, with the ``live_block`` clamp that skips the key
blocks past each slot's live length; ``PooledValid`` there is the
``positions`` / ``lengths`` pair this entry takes). Every row of the pool
is its own request at its own depth. On CUDA tensors the entry launches
the hand-written kernel ``csrc/decode_attention_pooled.cu`` or raises:
split-KV, one CTA per (KV row, range of whole key tiles) of the buffer's
capacity, where a range past its slot's live length returns at once, then
a merge of the ranges' partial softmax states by their log-sum-exp. On
CPU tensors it runs the plain version ``ref.decode_attention_pooled_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import attention_backward as AB
from repro_torch.kernels.decode_attention import (TILE, normalize_tiles,
                                                  pooled_split_plan)
from repro_torch.kernels.ref import \
    decode_attention_pooled_ref as decode_attention_pooled_plain  # noqa: F401

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, positions (nullable), lengths, o, part_acc, part_m, part_l, BH,
# BHkv, L, Dk, Dv, n_heads, dtype, tiles, scale
KERNEL = _build.CudaKernel("decode_attention_pooled",
                           "decode_attention_pooled_fwd",
                           [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _I, _I, _I, _I, _F])


def decode_attention_pooled_bh(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor,
                               positions: Optional[torch.Tensor],
                               lengths: torch.Tensor, *, n_heads: int,
                               scale: Optional[float] = None,
                               tiles: Optional[int] = None
                               ) -> torch.Tensor:
    """q (B·n_heads, 1, Dk); k (B·Hkv, L, Dk); v (B·Hkv, L, Dv);
    positions (B, L) int32 with -1 for an empty entry, or None when
    column j holds position j (FullKV); lengths (B,) int32 live-prefix
    counts, clamped to L. Row b (slot b // n_heads) sees column j iff
    j < lengths[slot] and positions[slot, j] >= 0; a row that sees
    nothing gives zeros. ``scale`` defaults to Dk ** -0.5. Returns
    (B·n_heads, 1, Dv). ``tiles`` forces the 64-key tiles a range of the
    kernel holds (normalized as the kernel runs it); by default
    ``pooled_split_plan`` picks it.

    The plain version takes any (Dk, Dv); the kernel is built for
    Dk = Dv in ``_build.HEAD_DIMS``. MLA's absorbed decode, Dk = R + rope
    over Dv = R, runs on ``decode_attention_mla.decode_attention_mla_bh``,
    which reads the latent cache in place."""
    name = "decode_attention_pooled_bh"
    _build.check_pooled_operands(name, q, k, v, positions, lengths, n_heads)
    if _build.on_cpu(name, q):
        return decode_attention_pooled_plain(q, k, v, positions, lengths,
                                             n_heads=n_heads, scale=scale)
    AB.refuse_grad(name, q, k, v)
    BH, _, Dk = q.shape
    BHkv, L, Dv = v.shape
    if Dk != Dv or Dk not in _build.HEAD_DIMS:
        raise NotImplementedError(
            f"{name}: (Dk, Dv) = ({Dk}, {Dv}): the kernel is built for "
            f"Dk = Dv in {_build.HEAD_DIMS}; MLA's latent decode runs on "
            f"decode_attention_mla_bh")
    code = _build.check_cuda(name, q, k, v, lengths,
                             *(() if positions is None else (positions,)))
    _build.check_aligned16(name, "its TMA bulk loads", k, v)
    G = BH // BHkv
    t = (pooled_split_plan(L, G, q.dtype, Dk) if tiles is None
         else normalize_tiles(L, tiles, G, q.dtype, Dk))
    n_split = -(-L // (t * TILE))  # ranges a KV row, from the capacity
    out = torch.empty((BH, 1, Dv), dtype=q.dtype, device=q.device)
    ptrs = (0, 0, 0)
    if n_split > 1:  # the ranges' fp32 (acc, m, l), merged by the same entry
        acc = torch.empty((BH, n_split, Dv), dtype=torch.float32,
                          device=q.device)
        ml = torch.empty((2, BH, n_split), dtype=torch.float32,
                         device=q.device)
        ptrs = (acc.data_ptr(), ml[0].data_ptr(), ml[1].data_ptr())
    KERNEL.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  None if positions is None else positions.data_ptr(),
                  lengths.data_ptr(), out.data_ptr(), *ptrs, BH, BHkv, L, Dk,
                  Dv, n_heads, code, t, _build.default_scale(Dk, scale))
    return out
