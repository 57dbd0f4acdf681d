"""The gradient of the block-sparse kernel: the backward of xa training.

No TPU kernel is replaced: the JAX package trains its XAttention mode
through XLA's autodiff of ``_block_topk`` (``repro/core/modes.py:473``).
The port's xa forward runs the hand-written block-sparse kernel, whose
output PyTorch cannot differentiate, so on CUDA tensors
``block_sparse_backward_bh`` launches the hand-written kernel
``csrc/block_sparse_backward.cu`` or raises: bf16 operands run on the
backward's tensor-core engine (``csrc/backward_wgmma.cuh``, TMA + wgmma;
their bases must be 16-byte aligned), fp32 operands on its CUDA-core
kernels (``csrc/backward_fp32.cuh``). On CPU tensors it runs the plain
version, ``torch.autograd.grad`` through
``ref.block_sparse_attention_ref`` (the rounding of p passes the gradient
straight through, the row max is a constant).

The kernel walks the selection from both sides through ``walk_lists``,
built on the device by sorts (no atomics, nothing read back): each query
row block's live key tiles, and each key tile's (query head, query tile)
pairs, the inverse selection that the dk / dv CTAs walk.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import attention_backward as AB
from repro_torch.kernels import ref

TILE = 64  # the kernels' query and key tile (block_sparse_attention)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, dout, dq, dk, dv, stats, rows, counts, offs, items, BH, BHkv,
# Sq, Skv, Dk, Dv, dtype, K, q_offset, scale
KERNEL = _build.CudaKernel("block_sparse_backward", "block_sparse_backward",
                           [_P] * 12 + [_I] * 9 + [_F])


def walk_lists(sel: torch.Tensor, BHkv: int, Skv: int):
    """The kernel's walks of a selection ``sel`` (BH, nqt, K) int32 of
    64-key tiles per 64-row query block (-1, repeats and tiles past Skv
    ignored), with G = BH // BHkv query heads a KV head:

    - rows (BH, nqt, K) int32: each row block's distinct live tiles
      ascending, then ``nkt`` = ceil(Skv / 64) in the dead places;
    - counts (BH, nqt) int32: how many are live;
    - offs (BHkv·nkt + 1,) int32 and items (BH·nqt·K,) int32: key tile kt
      of KV head bkv is named by items[offs[bkv·nkt + kt] :
      offs[bkv·nkt + kt + 1]], g·nqt + t each (query head bkv·G + g, query
      tile t), by g then t.

    Sorts only (a stable one for the inverse), so the lists are the same
    on every run and need no read back to the host."""
    BH, nqt, K = sel.shape
    G, nkt = BH // BHkv, -(-Skv // TILE)
    dev = sel.device
    live = (sel >= 0) & (sel < nkt)
    srt = torch.sort(torch.where(live, sel, nkt), dim=-1).values
    dup = torch.zeros_like(live)
    dup[..., 1:] = srt[..., 1:] == srt[..., :-1]
    live = (srt < nkt) & ~dup
    rows = torch.sort(torch.where(live, srt, nkt), dim=-1).values
    counts = live.sum(-1, dtype=torch.int32)
    bh = torch.arange(BH, device=dev)[:, None, None]
    t = torch.arange(nqt, device=dev)[None, :, None]
    key = torch.where(live, bh // G * nkt + srt, BHkv * nkt).flatten()
    val = ((bh % G) * nqt + t).expand(BH, nqt, K).flatten()
    key, order = torch.sort(key, stable=True)
    offs = torch.searchsorted(key, torch.arange(BHkv * nkt + 1, device=dev,
                                                dtype=key.dtype))
    return (rows.to(torch.int32).contiguous(), counts.contiguous(),
            offs.to(torch.int32), val[order].to(torch.int32))


def block_sparse_backward_plain(q, k, v, dout, sel, *, q_offset: int = 0,
                                scale: Optional[float] = None):
    """(dq, dk, dv) of ``ref.block_sparse_attention_ref`` at the kernel's
    64-token tiles, by ``torch.autograd.grad``."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        o = ref.block_sparse_attention_ref(qq, kk, vv, sel, block=TILE,
                                           q_offset=q_offset, scale=scale)
        return torch.autograd.grad(o, (qq, kk, vv), dout)


def block_sparse_backward_bh(q, k, v, dout, sel, *, q_offset: int = 0,
                             scale: Optional[float] = None, out=None,
                             stats=None):
    """dq, dk, dv of ``block_sparse_attention_bh(q, k, v, sel, q_offset=,
    scale=)`` given ``dout``: q, dout (BH, Sq, Dk / Dv), k (BHkv, Skv, Dk),
    v (BHkv, Skv, Dv), sel (BH, ceil(Sq / 64), K) int32 as the forward
    takes it (repeats are counted once, as the plain version counts
    them). The card takes Dk = Dv in ``_build.HEAD_DIMS`` and (Dk, Dv) in
    ``_build.SPLIT_HEAD_DIMS``. A key no query selects gets zero dk and
    dv; a row that sees no key, zero dq. ``out`` (a test's hook): None or
    (dq, dk, dv), each checked as ``_build.check_out`` checks one, written
    in place and returned. ``stats`` (a test's hook, CUDA only): the
    kernels' scratch, as ``attention_backward.check_stats`` takes it."""
    name = "block_sparse_backward_bh"
    _build.check_operands(name, q, k, v, dv_free=True)
    _build.check_common(name, q, k, v, dout, sel)
    BH, Sq, D = q.shape
    BHkv, Skv, Dv = v.shape
    if tuple(dout.shape) != (BH, Sq, Dv):
        raise ValueError(f"{name}: dout must be {(BH, Sq, Dv)}; got "
                         f"{tuple(dout.shape)}")
    nqt = -(-Sq // TILE)
    if sel.dim() != 3 or sel.shape[:2] != (BH, nqt) \
            or sel.dtype != torch.int32:
        raise ValueError(f"{name}: sel must be ({BH}, {nqt}, K) int32; got "
                         f"{tuple(sel.shape)} {sel.dtype}")
    if q_offset < 0:
        raise ValueError(f"{name}: q_offset={q_offset} must be >= 0")
    if out is not None:
        if len(out) != 3:
            raise ValueError(f"{name}: out must be (dq, dk, dv); got "
                             f"{len(out)} tensors")
        out = tuple(_build.check_out(name, o, t.shape, t)
                    for o, t in zip(out, (q, k, v)))
    if _build.on_cpu(name, q):
        grads = block_sparse_backward_plain(q, k, v, dout, sel,
                                            q_offset=q_offset, scale=scale)
        return grads if out is None else tuple(
            _build.into(o, g) for o, g in zip(out, grads))
    code = _build.check_cuda(name, q, k, v, dout, sel, dims=(D, Dv))
    if q.dtype == torch.bfloat16:
        _build.check_tma_aligned(name, q, k, v, dout)
    stats = AB.check_stats(name, stats, q)
    out = out or tuple(torch.empty_like(t) for t in (q, k, v))
    rows, counts, offs, items = walk_lists(sel, BHkv, Skv)
    dq, dk, dv = out
    KERNEL.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), stats.data_ptr(), rows.data_ptr(),
                  counts.data_ptr(), offs.data_ptr(), items.data_ptr(), BH,
                  BHkv, Sq, Skv, D, Dv, code, sel.shape[2], int(q_offset),
                  _build.default_scale(D, scale))
    return out
