"""The partial state of one-token decode attention over one rank's shard
of a sequence-sharded cache (``distributed/decode.py``).

The port's counterpart of the per-device half of
``repro/distributed/decode.py::lse_combine_decode``, which runs the
masked softmax of ``repro/kernels/decode_attention.py`` (``_kernel``) over
each device's keys. On CUDA tensors the entry launches the hand-written
kernel of ``csrc/decode_attention.cu`` (its C entry
``decode_attention_partial_fwd``: the split-KV decode kernel with every
split's (acc, m, l) kept, then a merge of the splits into the rank's
normalized output and log-sum-exp) or raises. On CPU tensors it runs the
plain version ``ref.decode_attention_partial_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import attention_backward as AB
from repro_torch.kernels.decode_attention import decode_split_plan, sm_count
from repro_torch.kernels.ref import \
    decode_attention_partial_ref as decode_attention_partial_plain  # noqa: F401

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, positions, o, lse, part_acc, part_m, part_l, BH, BHkv, L, D,
# dtype, n_split, cur_pos, scale
KERNEL = _build.CudaKernel("decode_attention", "decode_attention_partial_fwd",
                           [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _I, _I, _I, _F])


def decode_attention_partial_bh(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        positions: torch.Tensor, cur_pos: int, *,
        scale: Optional[float] = None,
        out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (BH, 1, D); k/v (BHkv, L, D), this rank's keys; positions (L,)
    int32, each slot's absolute position (slot j visible iff 0 <=
    positions[j] <= cur_pos). Returns (o (BH, D) fp32, the softmax output
    over the visible keys of this shard; lse (BH,) fp32, their
    log-sum-exp in base 2: log2 Σ_j 2^(s_j), s_j = scale·q·k_j·log2(e),
    so that ``decode_merge_ranks_bh`` merges shards with exp2). A row
    with no visible key has lse = -1e30. The key ranges are
    ``decode_split_plan``'s, as ``decode_attention_bh`` runs them.
    ``out``: an (o, lse) pair of fp32 tensors to write in place
    (contiguous, on q's device), such as two views of one buffer that a
    gather sends whole."""
    name = "decode_attention_partial_bh"
    _build.check_operands(name, q, k, v)
    BH, _, D = q.shape
    L = k.shape[1]
    if q.shape[1] != 1:
        raise ValueError(f"{name}: q must hold one token per row; got "
                         f"{tuple(q.shape)}")
    if (positions.shape != (L,) or positions.dtype != torch.int32
            or positions.device != q.device):
        raise ValueError(f"{name}: positions must be ({L},) int32 on "
                         f"{q.device}; got {tuple(positions.shape)} "
                         f"{positions.dtype} on {positions.device}")
    o, lse = (None, None) if out is None else out
    fp32 = torch.empty(0, dtype=torch.float32, device=q.device)
    o = _build.check_out(name, o, (BH, D), fp32)
    lse = _build.check_out(name, lse, (BH,), fp32)
    if _build.on_cpu(name, q):
        po, plse = decode_attention_partial_plain(q, k, v, positions,
                                                  cur_pos, scale=scale)
        return _build.into(o, po), _build.into(lse, plse)
    AB.refuse_grad(name, q, k, v)
    code = _build.check_cuda(name, q, k, v, positions)
    _build.check_aligned16(name, "its TMA bulk loads", k, v)
    BHkv = k.shape[0]
    n = decode_split_plan(BHkv, BH // BHkv, L, sm_count(q.device.index),
                          q.dtype, D)
    if o is None:
        o = torch.empty((BH, D), dtype=torch.float32, device=q.device)
    if lse is None:
        lse = torch.empty((BH,), dtype=torch.float32, device=q.device)
    acc = torch.empty((BH, n, D), dtype=torch.float32, device=q.device)
    ml = torch.empty((2, BH, n), dtype=torch.float32, device=q.device)
    KERNEL.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  positions.data_ptr(), o.data_ptr(), lse.data_ptr(),
                  acc.data_ptr(), ml[0].data_ptr(), ml[1].data_ptr(), BH,
                  BHkv, L, D, code, n, int(cur_pos),
                  _build.default_scale(D, scale))
    return o, lse
