"""The merge of sequence shards' partial decode states across ranks
(``distributed/decode.py``).

The port's counterpart of the cross-device half of
``repro/distributed/decode.py::lse_combine_decode`` (its ``pmax`` and two
``psum``: there every device rescales its sums by the global max before
they are added; here the ranks' normalized outputs and base-2
log-sum-exps are gathered once and merged by their weights). On CUDA
tensors the entry launches the hand-written kernel of
``csrc/decode_attention.cu`` (its C entry ``decode_merge_ranks_fwd``) or
raises; on CPU tensors it runs the plain version
``ref.decode_merge_ranks_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import \
    decode_merge_ranks_ref as decode_merge_ranks_plain  # noqa: F401

_P, _I = ctypes.c_void_p, ctypes.c_int
# o_parts, lse_parts, o, BH, D, dtype, n_ranks, o_stride, lse_stride
KERNEL = _build.CudaKernel("decode_attention", "decode_merge_ranks_fwd",
                           [_P, _P, _P, _I, _I, _I, _I, _I, _I])


def decode_merge_ranks_bh(o_parts: torch.Tensor, lse_parts: torch.Tensor,
                          dtype: torch.dtype) -> torch.Tensor:
    """o_parts (N, BH, D) and lse_parts (N, BH) fp32, the N ranks'
    ``decode_attention_partial_bh`` outputs (base-2 log-sum-exps). Returns
    (BH, D) in ``dtype``: Σ_r w_r o_r / max(Σ_r w_r, 1e-20), w_r =
    exp2(lse_r - max_r lse_r). A rank with no visible key (lse = -1e30)
    weighs 0 beside any rank with one. Each rank's rows must be
    contiguous; the ranks may lie at any stride (two views of one
    gathered buffer)."""
    name = "decode_merge_ranks_bh"
    if (o_parts.dim() != 3 or lse_parts.shape != o_parts.shape[:2]
            or 0 in o_parts.shape):
        raise ValueError(f"{name}: want o_parts (N, BH, D) and lse_parts "
                         f"(N, BH); got {tuple(o_parts.shape)}, "
                         f"{tuple(lse_parts.shape)}")
    if (o_parts.dtype != torch.float32 or lse_parts.dtype != torch.float32
            or lse_parts.device != o_parts.device):
        raise ValueError(f"{name}: o_parts and lse_parts must be float32 on "
                         f"one device; got {o_parts.dtype} on "
                         f"{o_parts.device}, {lse_parts.dtype} on "
                         f"{lse_parts.device}")
    if _build.on_cpu(name, o_parts):
        return decode_merge_ranks_plain(o_parts, lse_parts, dtype)
    N, BH, D = o_parts.shape
    if (o_parts.stride()[1:] != (D, 1) or lse_parts.stride(1) != 1
            or (N > 1 and (o_parts.stride(0) < BH * D
                           or lse_parts.stride(0) < BH))):
        raise ValueError(f"{name}: each rank's rows must be contiguous; got "
                         f"strides {o_parts.stride()}, {lse_parts.stride()}")
    if dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: dtype {dtype} not supported by the "
                         f"kernel (float32, bfloat16)")
    if D not in _build.HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not supported by the "
                         f"kernel: it is built for {_build.HEAD_DIMS}")
    out = torch.empty((BH, D), dtype=dtype, device=o_parts.device)
    o_stride = o_parts.stride(0) if N > 1 else BH * D
    lse_stride = lse_parts.stride(0) if N > 1 else BH
    KERNEL.launch(o_parts.device, o_parts.data_ptr(), lse_parts.data_ptr(),
                  out.data_ptr(), BH, D, _build.DTYPE_CODES[dtype], N,
                  o_stride, lse_stride)
    return out
