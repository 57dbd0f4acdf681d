"""Flash-attention forward (causal or bidirectional).

Port of ``repro/kernels/flash_attention.py::flash_attention_bh``. On CUDA
tensors the entry launches the hand-written kernel
``csrc/flash_attention.cu`` or raises: bf16 operands run on its tensor-core
engine (``csrc/prefill_wgmma.cuh``, TMA + wgmma; their bases must be
16-byte aligned), fp32 operands on its CUDA-core loop. On CPU tensors it
runs the plain version, the dense masked softmax of
``ref.flash_attention_ref``, which autograd differentiates. On CUDA
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
    flash_attention_ref as flash_attention_plain  # noqa: F401

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, o, BH, BHkv, Sq, Skv, Dk, Dv, dtype, causal, q_offset, scale
KERNEL = _build.CudaKernel("flash_attention", "flash_attention_fwd",
                           [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                            _I, _F])


def flash_attention_bh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, scale: Optional[float] = None,
                       q_offset: int = 0,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (BH, Sq, D); k (BHkv, Skv, D), v (BHkv, Skv, Dv) with BH =
    BHkv·G; query row r sits at position ``q_offset + r``. Returns
    (BH, Sq, Dv) in q's dtype. On the card Dv = D, or (D, Dv) one of
    ``_build.SPLIT_HEAD_DIMS`` (MLA's route chunk). ``out`` (a test's
    hook, ``_build.check_out``) is written in place and returned."""
    name = "flash_attention_bh"
    _build.check_operands(name, q, k, v, dv_free=True)
    if q_offset < 0:
        raise ValueError(f"{name}: q_offset={q_offset} must be >= 0")
    BH, Sq, D = q.shape
    BHkv, Skv, Dv = v.shape
    out = _build.check_out(name, out, (BH, Sq, Dv), q)
    if _build.on_cpu(name, q):
        return _build.into(out, flash_attention_plain(
            q, k, v, causal=causal, q_offset=q_offset, scale=scale))
    code = _build.check_cuda(name, q, k, v, dims=(D, Dv))
    if q.dtype == torch.bfloat16:
        _build.check_tma_aligned(name, q, k, v)

    def launch(q, k, v, out=out):
        if out is None:
            out = torch.empty((BH, Sq, Dv), dtype=q.dtype, device=q.device)
        KERNEL.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), BH, BHkv, Sq, Skv, D, Dv, code,
                      int(causal), int(q_offset),
                      _build.default_scale(D, scale))
        return out

    if AB.needs_grad(q, k, v):
        _build.check_no_out_with_grad(name, out)
        return AB.differentiable(q, k, v, launch, causal=causal,
                                 q_offset=q_offset, scale=scale)
    return launch(q, k, v)
