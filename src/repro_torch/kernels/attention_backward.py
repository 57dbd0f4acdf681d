"""The gradient of the flash and streaming kernels, and the autograd
function that trains through them.

No TPU kernel is replaced: the JAX package trains through XLA's autodiff
of its blocked ``modes.attention`` (``repro/core/modes.py:120``). The
port's forward runs the hand-written flash and streaming kernels, whose
outputs PyTorch cannot differentiate, so on CUDA tensors
``attention_backward_bh`` launches the hand-written kernel
``csrc/attention_backward.cu`` or raises: bf16 operands run on its
tensor-core engine (``csrc/backward_wgmma.cuh``, TMA + wgmma; their bases
must be 16-byte aligned), fp32 operands on its CUDA-core kernels. On CPU
tensors it runs the plain version:
``torch.autograd.grad`` through ``ref.flash_attention_ref`` /
``ref.streaming_attention_ref``, whose rounding of p to V's dtype
passes the gradient straight through, with the row max a constant
(``ref._masked_attention``).

``differentiable`` wraps one forward launch in a ``torch.autograd.Function``
whose backward is that kernel (or, for the block-sparse entry,
``block_sparse_backward.block_sparse_backward_bh``). The flash,
streaming and block-sparse entries take it only on CUDA tensors when grad
is enabled and q, k or v requires grad; otherwise they launch exactly as
before. ``ctx.needs_input_grad`` decides whether the backward launches at
all.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, dout, dq, dk, dv, stats, BH, BHkv, Sq, Skv, D, dtype, kind,
# causal, sink, local, q_offset, scale, Dv
KERNEL = _build.CudaKernel("attention_backward", "attention_backward",
                           [_P] * 8 + [_I] * 11 + [_F, _I])
FLASH, STREAMING = 0, 1  # the C entry's kinds


def needs_grad(*tensors: torch.Tensor) -> bool:
    """True when autograd will record a call on these operands."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise when a CUDA call of a kernel with no backward (the decode
    kernels: no training path runs them) would be recorded by autograd:
    its output would have no ``grad_fn``, so a loss through it would be
    silently wrong."""
    if needs_grad(*tensors) and not _build.on_cpu(name, tensors[0]):
        raise NotImplementedError(
            f"{name}: an operand requires grad, and this decode kernel has "
            f"no backward kernel; training runs the flash, streaming and "
            f"block-sparse kernels")


def attention_backward_plain(q, k, v, dout, *, causal: bool = True,
                             sink: Optional[int] = None,
                             local: Optional[int] = None, q_offset: int = 0,
                             scale: Optional[float] = None):
    """(dq, dk, dv) of the plain version (flash when ``local`` is None,
    else streaming at ``sink`` / ``local``) by ``torch.autograd.grad``."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        if local is None:
            o = ref.flash_attention_ref(qq, kk, vv, causal=causal,
                                        q_offset=q_offset, scale=scale)
        else:
            o = ref.streaming_attention_ref(qq, kk, vv, sink=sink,
                                            local=local, q_offset=q_offset,
                                            scale=scale)
        return torch.autograd.grad(o, (qq, kk, vv), dout)


def attention_backward_bh(q, k, v, dout, *, causal: bool = True,
                          sink: Optional[int] = None,
                          local: Optional[int] = None, q_offset: int = 0,
                          scale: Optional[float] = None, out=None,
                          stats=None):
    """dq, dk, dv of o = softmax(q kᵀ · scale, masked) v, given ``dout``.

    q, dout (BH, Sq, D); k, v (BHkv, Skv, D), BH = BHkv·G; the mask of
    ``flash_attention_bh`` (``local`` None: ``causal``, ``q_offset``) or of
    ``streaming_attention_bh`` (``sink`` / ``local``, ``q_offset``). The
    kernel recomputes each row's softmax statistics and D_i = dO_i · O_i
    itself, so it needs no forward output. Returns (dq, dk, dv) in the
    operands' dtype. The card takes Dk = Dv in ``_build.HEAD_DIMS`` and
    (Dk, Dv) in ``_build.SPLIT_HEAD_DIMS`` (v, dout (.., Dv)). ``out``
    (a test's hook): None or (dq, dk, dv), each checked as
    ``_build.check_out`` checks one, written in place and returned.
    ``stats`` (a test's hook, CUDA only): the kernels' scratch, as
    ``launch`` takes it."""
    name = "attention_backward_bh"
    _build.check_operands(name, q, k, v, dv_free=True)
    _build.check_common(name, q, k, v, dout)
    want = (*q.shape[:2], v.shape[2])
    if tuple(dout.shape) != want:
        raise ValueError(f"{name}: dout must be {want}; got "
                         f"{tuple(dout.shape)}")
    if q_offset < 0 or (local is not None and (sink < 0 or local < 1)):
        raise ValueError(f"{name}: need q_offset >= 0, sink >= 0 and "
                         f"local >= 1; got q_offset={q_offset} sink={sink} "
                         f"local={local}")
    kw = dict(causal=causal, sink=sink, local=local, q_offset=q_offset,
              scale=scale)
    if out is not None:
        if len(out) != 3:
            raise ValueError(f"{name}: out must be (dq, dk, dv); got "
                             f"{len(out)} tensors")
        out = tuple(_build.check_out(name, o, t.shape, t)
                    for o, t in zip(out, (q, k, v)))
    if _build.on_cpu(name, q):
        grads = attention_backward_plain(q, k, v, dout, **kw)
        return grads if out is None else tuple(
            _build.into(o, g) for o, g in zip(out, grads))
    _build.check_cuda(name, q, k, v, dout, dims=(q.shape[2], v.shape[2]))
    if q.dtype == torch.bfloat16:
        _build.check_tma_aligned(name, q, k, v, dout)
    out = out or tuple(torch.empty_like(t) for t in (q, k, v))
    launch(KERNEL, q, k, v, dout, out, stats=stats, **kw)
    return out


def launch(kernel: _build.CudaKernel, q, k, v, dout, out, *,
           causal: bool = True, sink: Optional[int] = None,
           local: Optional[int] = None, q_offset: int = 0,
           scale: Optional[float] = None, stats=None) -> None:
    """One launch of ``kernel`` (``KERNEL``, or its entry in another
    build, ``KERNEL.of``) on operands ``attention_backward_bh`` checked,
    into ``out`` = (dq, dk, dv). ``stats`` as ``check_stats`` takes it."""
    BH, Sq, D = q.shape
    BHkv, Skv, Dv = v.shape
    stats = check_stats("attention_backward", stats, q)
    dq, dk, dv = out
    kernel.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), stats.data_ptr(), BH, BHkv, Sq, Skv, D,
                  _build.DTYPE_CODES[q.dtype],
                  FLASH if local is None else STREAMING, int(causal),
                  int(sink or 0), int(local or 1), int(q_offset),
                  _build.default_scale(D, scale), Dv)


def check_stats(name: str, stats, q: torch.Tensor) -> torch.Tensor:
    """The backward kernels' scratch: the rows' m, l (or 1 / l) and D, a
    (3, BH, Sq rounded up to 64) float32 tensor, so that each row block's
    64 rows are one 256-byte bulk copy of the bf16 engine. None makes a
    fresh one; another tensor must be exactly that (a test's NaN-filled
    scratch), or this raises."""
    want = (3, q.shape[0], -(-q.shape[1] // 64) * 64)
    if stats is None:
        return torch.empty(want, dtype=torch.float32, device=q.device)
    if (tuple(stats.shape) != want or stats.dtype != torch.float32
            or stats.device != q.device or not stats.is_contiguous()
            or stats.data_ptr() % 16):
        raise ValueError(f"{name}: stats must be a contiguous float32 "
                         f"{want} on {q.device}, 16-byte aligned; got "
                         f"{stats.dtype} {tuple(stats.shape)} on "
                         f"{stats.device}")
    return stats


class _Attention(torch.autograd.Function):
    """One forward kernel launch (``forward``, a closure over its mask)
    with ``backward(q, k, v, dout, **mask)`` as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, forward: Callable, backward: Callable,
                mask: dict):
        ctx.save_for_backward(q, k, v)
        ctx.backward_fn, ctx.mask = backward, mask
        return forward(q, k, v)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        want = ctx.needs_input_grad[:3]
        if not any(want):
            return None, None, None, None, None, None
        grads = ctx.backward_fn(q, k, v, dout.contiguous(), **ctx.mask)
        return (*(g if w else None for g, w in zip(grads, want)), None,
                None, None)


def differentiable(q, k, v, forward: Callable,
                   backward: Optional[Callable] = None, **mask):
    """``forward(q, k, v)`` (a CUDA launch of the flash, streaming or
    block-sparse kernel under ``mask``) recorded for autograd, its
    backward ``backward(q, k, v, dout, **mask)`` on a backward kernel:
    ``attention_backward_bh`` (flash and streaming, ``mask`` its
    keywords) unless another is given."""
    return _Attention.apply(q, k, v, forward,
                            backward or attention_backward_bh, mask)
