"""One-token decode attention over a KV cache.

Port of ``repro/kernels/decode_attention.py::decode_attention_bh`` (the
batch-synchronous entry: one positions vector shared by every row). On
CUDA tensors the entry launches the hand-written kernel
``csrc/decode_attention.cu`` or raises; on CPU tensors it runs the plain
version, the dense masked softmax of ``ref.decode_attention_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import \
    decode_attention_ref as decode_attention_plain  # noqa: F401

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, positions, o, BH, BHkv, L, D, dtype, cur_pos, scale
KERNEL = _build.CudaKernel("decode_attention", "decode_attention_fwd",
                           [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F])


def decode_attention_bh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        positions: torch.Tensor, cur_pos: int, *,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q (BH, 1, D); k/v (BHkv, L, D); positions (L,) int32 absolute
    position of each cache slot (-1 = empty); slot j is visible iff
    0 <= positions[j] <= cur_pos. Returns (BH, 1, D)."""
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
    BH, _, D = q.shape
    out = torch.empty_like(q)
    KERNEL.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  positions.data_ptr(), out.data_ptr(), BH, k.shape[0], L,
                  D, code, int(cur_pos), _build.default_scale(D, scale))
    return out
