"""Block-sparse attention over a per-query-block selection of key blocks.

Port of ``repro/kernels/block_sparse_attention.py``
(``block_sparse_attention_bh`` and ``dedupe_selection``). On CUDA tensors
the entry launches the hand-written kernel
``csrc/block_sparse_attention.cu`` or raises: bf16 operands run on its
tensor-core engine (``csrc/prefill_wgmma.cuh``, TMA + wgmma over the
selection's live tiles; their bases must be 16-byte aligned), fp32
operands on its CUDA-core loop. On CPU tensors it runs the plain version,
the dense masked softmax of ``ref.block_sparse_attention_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import \
    block_sparse_attention_ref as block_sparse_attention_plain  # noqa: F401

# the kernel's query and key tile (csrc/attention_common.cuh: kBQ, kBK)
KERNEL_BLOCK = 64

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, sel, o, BH, BHkv, Sq, Skv, D, dtype, n_sel, q_offset, scale
KERNEL = _build.CudaKernel("block_sparse_attention",
                           "block_sparse_attention_fwd",
                           [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _I, _F])


def dedupe_selection(sel: torch.Tensor) -> torch.Tensor:
    """Mark repeated block indices (per row) as -1, so the kernel skips
    them instead of counting a block twice. sel (..., K) int32."""
    K = sel.shape[-1]
    eq = sel[..., :, None] == sel[..., None, :]
    earlier = torch.tril(torch.ones((K, K), dtype=torch.bool,
                                    device=sel.device), diagonal=-1)
    dup = (eq & earlier).any(-1)
    return torch.where(dup, torch.full_like(sel, -1), sel)


def block_sparse_attention_bh(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, sel: torch.Tensor, *,
                              q_offset: int = 0,
                              scale: Optional[float] = None) -> torch.Tensor:
    """q (BH,Sq,D), k/v (BHkv,Skv,D), sel (BH, ceil(Sq/KERNEL_BLOCK), K)
    int32 key-block indices per query block, -1 = skip
    (``dedupe_selection`` first). Query and key blocks are KERNEL_BLOCK
    tokens, the CUDA kernel's tile. Query row r attends keys
    <= ``q_offset + r`` among the selected blocks."""
    name = "block_sparse_attention_bh"
    _build.check_operands(name, q, k, v)
    BH, Sq, D = q.shape
    nqb = -(-Sq // KERNEL_BLOCK)
    if sel.dim() != 3 or sel.shape[:2] != (BH, nqb):
        raise ValueError(f"{name}: sel must be (BH, ceil(Sq/64), K) = "
                         f"({BH}, {nqb}, K); got {tuple(sel.shape)}")
    if sel.dtype != torch.int32 or sel.device != q.device:
        raise ValueError(f"{name}: sel must be int32 on {q.device}; got "
                         f"{sel.dtype} on {sel.device}")
    if q_offset < 0:
        raise ValueError(f"{name}: q_offset={q_offset} must be >= 0")
    if _build.on_cpu(name, q):
        return block_sparse_attention_plain(q, k, v, sel,
                                            block=KERNEL_BLOCK,
                                            q_offset=q_offset, scale=scale)
    code = _build.check_cuda(name, q, k, v, sel)
    if q.dtype == torch.bfloat16:
        _build.check_tma_aligned(name, q, k, v)
    BHkv, Skv = k.shape[0], k.shape[1]
    out = torch.empty_like(q)
    KERNEL.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  sel.data_ptr(), out.data_ptr(), BH, BHkv, Sq, Skv, D,
                  code, sel.shape[2], int(q_offset),
                  _build.default_scale(D, scale))
    return out
