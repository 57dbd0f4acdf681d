"""Streaming (sink + local) attention: the SSA prefill.

Port of ``repro/kernels/streaming_attention.py::streaming_attention_bh``.
On CUDA tensors the entry launches the hand-written kernel
``csrc/streaming_attention.cu`` or raises: bf16 operands run on the
tensor-core engine (``csrc/prefill_wgmma.cuh``, TMA + wgmma; their bases
must be 16-byte aligned), fp32 operands on its CUDA-core loop. On CPU
tensors it runs the plain version, the dense masked softmax of
``ref.streaming_attention_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import \
    streaming_attention_ref as streaming_attention_plain  # noqa: F401

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, o, BH, BHkv, Sq, Skv, D, dtype, sink, local, q_offset, scale
KERNEL = _build.CudaKernel("streaming_attention", "streaming_attention_fwd",
                           [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                            _I, _F])


def streaming_attention_bh(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, sink: int, local: int,
                           scale: Optional[float] = None,
                           q_offset: int = 0) -> torch.Tensor:
    """q (BH,Sq,D), k/v (BHkv,Skv,D). ``sink``/``local`` in tokens: query
    position p sees key c iff c <= p and (c < sink or p - c < local)."""
    name = "streaming_attention_bh"
    _build.check_operands(name, q, k, v)
    if sink < 0 or local < 1 or q_offset < 0:
        raise ValueError(f"{name}: need sink >= 0, local >= 1 and "
                         f"q_offset >= 0; got sink={sink} local={local} "
                         f"q_offset={q_offset}")
    if _build.on_cpu(name, q):
        return streaming_attention_plain(q, k, v, sink=sink, local=local,
                                         q_offset=q_offset, scale=scale)
    code = _build.check_cuda(name, q, k, v)
    if q.dtype == torch.bfloat16:
        _build.check_tma_aligned(name, q, k, v)
    BH, Sq, D = q.shape
    BHkv, Skv = k.shape[0], k.shape[1]
    out = torch.empty_like(q)
    KERNEL.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), BH, BHkv, Sq, Skv, D, code, int(sink),
                  int(local), int(q_offset), _build.default_scale(D, scale))
    return out
