"""Streaming (sink + local) attention: the SSA prefill.

Port of ``repro/kernels/streaming_attention.py::streaming_attention_bh``.
On CUDA tensors the entry launches the hand-written kernel
``csrc/streaming_attention.cu`` or raises: bf16 operands run on the
tensor-core engine (``csrc/prefill_wgmma.cuh``, TMA + wgmma; their bases
must be 16-byte aligned), fp32 operands on its CUDA-core loop. On CPU
tensors it runs the plain version, the dense masked softmax of
``ref.streaming_attention_ref``, which autograd differentiates. On CUDA
tensors that autograd records (grad enabled, q, k or v requiring grad)
the launch goes through ``attention_backward.differentiable``, whose
backward is the hand-written kernel ``csrc/attention_backward.cu``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import attention_backward as AB
from repro_torch.kernels.ref import \
    streaming_attention_ref as streaming_attention_plain  # noqa: F401

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, o, BH, BHkv, Sq, Skv, Dk, Dv, dtype, sink, local, q_offset, scale
KERNEL = _build.CudaKernel("streaming_attention", "streaming_attention_fwd",
                           [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                            _I, _I, _F])


def streaming_attention_bh(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, sink: int, local: int,
                           scale: Optional[float] = None,
                           q_offset: int = 0,
                           out: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """q (BH,Sq,D), k (BHkv,Skv,D), v (BHkv,Skv,Dv) → (BH,Sq,Dv), with
    (D, Dv) and ``out`` as ``flash_attention_bh`` takes them.
    ``sink``/``local`` in tokens: query position p sees key c iff c <= p
    and (c < sink or p - c < local)."""
    name = "streaming_attention_bh"
    _build.check_operands(name, q, k, v, dv_free=True)
    if sink < 0 or local < 1 or q_offset < 0:
        raise ValueError(f"{name}: need sink >= 0, local >= 1 and "
                         f"q_offset >= 0; got sink={sink} local={local} "
                         f"q_offset={q_offset}")
    BH, Sq, D = q.shape
    BHkv, Skv, Dv = v.shape
    out = _build.check_out(name, out, (BH, Sq, Dv), q)
    if _build.on_cpu(name, q):
        return _build.into(out, streaming_attention_plain(
            q, k, v, sink=sink, local=local, q_offset=q_offset, scale=scale))
    code = _build.check_cuda(name, q, k, v, dims=(D, Dv))
    if q.dtype == torch.bfloat16:
        _build.check_tma_aligned(name, q, k, v)

    def launch(q, k, v, out=out):
        if out is None:
            out = torch.empty((BH, Sq, Dv), dtype=q.dtype, device=q.device)
        KERNEL.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), BH, BHkv, Sq, Skv, D, Dv, code,
                      int(sink), int(local), int(q_offset),
                      _build.default_scale(D, scale))
        return out

    if AB.needs_grad(q, k, v):
        _build.check_no_out_with_grad(name, out)
        return AB.differentiable(q, k, v, launch, sink=sink,
                                 local=local, q_offset=q_offset, scale=scale)
    return launch(q, k, v)
