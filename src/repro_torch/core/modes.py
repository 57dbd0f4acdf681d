"""Attention modes of the serving path (port of ``repro/core/modes.py``).

Layout convention: q is (B, Hq, Sq, D); k/v are (B, Hkv, Skv, D) with
Hq = G·Hkv (GQA). ``attention`` and ``chunk_causal_attention`` flatten to
the kernels' (B·H, S, D) and call the kernel entries, which launch the
hand-written CUDA kernels on CUDA tensors and run their plain versions
on CPU tensors. ``masked_attention`` stays plain PyTorch: the JAX package
computes it outside any Pallas kernel too.

Kinds: ``full`` (flash), ``window`` (a local layer's sliding window:
the streaming kernel with no sink, where the JAX package runs its
blocked engine in XLA), ``streaming`` (the SSA sparse mode, the
sink+local kernel), ``triangle`` (TriangleMix, the ``ta`` mode: the
streaming kernel over the rows before the last ``chunk`` rows, flash over
those) and ``block_topk`` (XAttention, the ``xa`` mode: antidiagonal
block scores in plain torch, as the JAX package scores them in XLA, and
the block-sparse kernel over the per-query-head top-k selection).

Training differentiates ``attention`` through every kind: on CUDA the
flash and streaming entries record their launches for autograd with the
backward kernel (``kernels/attention_backward.py``), the block-sparse
entry with its own (``kernels/block_sparse_backward.py``), at every built
head dim and at MLA's (Dk, Dv) = (192, 128); on CPU every kind runs
through its plain version's autograd.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.block_sparse_attention import (
    KERNEL_BLOCK, block_sparse_attention_bh)
from repro_torch.kernels.flash_attention import flash_attention_bh
from repro_torch.kernels.ref import NEG_INF, block_sparse_attention_ref
from repro_torch.kernels.streaming_attention import streaming_attention_bh


@dataclass(frozen=True)
class AttnMode:
    kind: str  # full | window | streaming | triangle | block_topk
    causal: bool = True
    sink: int = 0
    local: int = 0
    chunk: int = 0
    block: int = 128
    stride: int = 16
    threshold: float = 0.9

    def replace(self, **kw) -> "AttnMode":
        return dataclasses.replace(self, **kw)


FULL = AttnMode("full")
BIDIRECTIONAL = AttnMode("full", causal=False)


def window_mode(window: int) -> AttnMode:
    return AttnMode("window", local=window)


def ssa_mode(flux) -> AttnMode:
    return AttnMode("streaming", sink=flux.sink, local=flux.local)


def xa_mode(flux) -> AttnMode:
    return AttnMode("block_topk", sink=flux.sink, local=flux.local,
                    block=flux.block, stride=flux.stride,
                    threshold=flux.threshold)


def ta_mode(flux) -> AttnMode:
    return AttnMode("triangle", sink=flux.sink, local=flux.local,
                    chunk=flux.chunk)


def sa_mode_for(flux) -> AttnMode:
    return {"ssa": ssa_mode, "xa": xa_mode, "ta": ta_mode}[flux.sa_mode](flux)


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, *x.shape[2:])


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mode: AttnMode, *, q_offset: int = 0,
              scale: Optional[float] = None) -> torch.Tensor:
    """Attention under ``mode`` over the whole of k/v.

    q (B,Hq,Sq,D); k, v (B,Hkv,Skv,D); query row r sits at position
    ``q_offset + r``. ``full`` runs the flash kernel, ``window`` and
    ``streaming`` the sink+local kernel (``window`` at sink 0: position
    p sees key c iff p - local < c <= p), ``triangle`` both
    (``_triangle``), ``block_topk`` the block-sparse kernel
    (``_block_topk``). Returns (B,Hq,Sq,Dv) in q's dtype."""
    B, Hq, Sq, D = q.shape
    if mode.kind == "triangle":
        return _triangle(q, k, v, mode, q_offset=q_offset, scale=scale)
    if mode.kind == "block_topk":
        return _block_topk(q, k, v, mode, q_offset=q_offset,
                           scale=D ** -0.5 if scale is None else scale)
    qf, kf, vf = _flat(q), _flat(k), _flat(v)
    if mode.kind == "full":
        out = flash_attention_bh(qf, kf, vf, causal=mode.causal,
                                 scale=scale, q_offset=q_offset)
    elif mode.kind in ("window", "streaming"):
        sink = mode.sink if mode.kind == "streaming" else 0
        out = streaming_attention_bh(qf, kf, vf, sink=sink,
                                     local=max(mode.local, 1), scale=scale,
                                     q_offset=q_offset)
    else:
        raise ValueError(f"unknown attention mode kind {mode.kind!r}")
    return out.reshape(B, Hq, Sq, out.shape[-1])


def streaming_valid(q_positions: torch.Tensor, kv_positions: torch.Tensor,
                    sink: int, local: int) -> torch.Tensor:
    """Sink+local visibility by absolute position.

    q_positions (Sq,) or (B, Sq); kv_positions (B, L) with -1 = empty
    slot. Returns (B, Sq, L) bool."""
    q = (q_positions[None, :, None] if q_positions.dim() == 1
         else q_positions[:, :, None])
    kv = kv_positions[:, None, :]
    vis = (kv >= 0) & (kv <= q)
    return vis & ((kv < sink) | (q - kv < local))


def causal_selection(start: int, C: int, M: int, rows: int,
                     device) -> torch.Tensor:
    """The block-sparse selection of a causal chunk, as
    ``_chunk_causal_block_sparse`` builds it, in the kernel's blocks of
    KERNEL_BLOCK tokens: query block i (absolute rows
    [start + i·block, ...)) selects key blocks [0, last_vis(i)] and marks
    the rest -1. Returns (rows, ceil(C/block), ceil(M/block)) int32."""
    block = KERNEL_BLOCK
    nqb = -(-C // block)
    K = -(-M // block)
    qb = torch.arange(nqb, device=device)
    kb = torch.arange(K, device=device)
    # last kv block any live row of query block i can see; rows past C
    # are padding (masked in-kernel), so bound by the last live row
    last_vis = (start + torch.clamp((qb + 1) * block, max=C) - 1) // block
    sel = torch.where(kb[None, :] <= last_vis[:, None], kb[None, :], -1)
    return sel.to(torch.int32)[None].expand(rows, nqb, K).contiguous()


def chunk_causal_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, start: int, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Causal attention of a chunk of queries over a cache buffer.

    q (B,Hq,C,D) at absolute positions [start, start+C); k/v (B,Hkv,M,D)
    hold valid keys at positions [0, start+C) of an M-capacity buffer.
    Runs on the block-sparse kernel with the causal selection, so key
    blocks past the live prefix cost nothing and ``start`` is a runtime
    argument."""
    B, Hq, C, D = q.shape
    M = k.shape[2]
    sel = causal_selection(int(start), C, M, B * Hq, q.device)
    out = block_sparse_attention_bh(_flat(q), _flat(k), _flat(v), sel,
                                    q_offset=int(start), scale=scale)
    return out.reshape(B, Hq, C, out.shape[-1])


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q (B,Hq,Sq,D), k/v (B,Hkv,L,D), valid (B, 1|Hkv, Sq, L) bool.

    Dense masked softmax with caller-supplied validity and no positional
    assumption about the key layout: f32 scores, the -1e30 mask, p cast
    to v's dtype before the PV product. Returns (B,Hq,Sq,Dv) in q's
    dtype."""
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    Dv = v.shape[-1]
    scale = scale if scale is not None else D ** -0.5
    q5 = q.reshape(B, Hkv, Hq // Hkv, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", q5.float(), k.float()) * scale
    s = torch.where(valid[:, :, None], s, NEG_INF)
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF / 2)
    p = torch.exp(s - m)
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-20)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, Hq, Sq, Dv).to(q.dtype)


# ---------------------------------------------------------------------------
# Triangle (TriangleMix, the ``ta`` mode): streaming body + dense last chunk
# ---------------------------------------------------------------------------

def _triangle(q, k, v, mode: AttnMode, *, q_offset: int, scale):
    """Rows before ``boundary = max(0, Sq - chunk)`` run the streaming
    kernel, the last ``chunk`` rows flash at ``q_offset + boundary``; both
    over all of k/v. The row slices are copied contiguous (the entries
    need contiguous, 16-byte aligned operands on the card)."""
    Sq = q.shape[2]
    boundary = max(0, Sq - mode.chunk)
    if boundary == 0:
        return attention(q, k, v, FULL, q_offset=q_offset, scale=scale)
    stream = mode.replace(kind="streaming")
    out_pre = attention(q[:, :, :boundary].contiguous(), k, v, stream,
                        q_offset=q_offset, scale=scale)
    out_last = attention(q[:, :, boundary:].contiguous(), k, v, FULL,
                         q_offset=q_offset + boundary, scale=scale)
    return torch.cat([out_pre, out_last], dim=2)


# ---------------------------------------------------------------------------
# XAttention (the ``xa`` mode): antidiagonal block scoring + static top-K
# ---------------------------------------------------------------------------

def xa_keep_blocks(num_kv_blocks: int, threshold: float) -> int:
    """Static per-query-block budget of key blocks: the JAX package's
    stand-in for the paper's cumulative-softmax-mass threshold."""
    return max(2, min(num_kv_blocks,
                      int(-(-(1.0 - threshold) * num_kv_blocks // 1))))


def _pad_to(x: torch.Tensor, axis: int, target: int) -> torch.Tensor:
    pad = target - x.shape[axis]
    if pad <= 0:
        return x
    widths = [0, 0] * (x.dim() - 1 - axis) + [0, pad]
    return torch.nn.functional.pad(x, widths)


def antidiagonal_scores(q: torch.Tensor, k: torch.Tensor, block: int,
                        stride: int, scale: float) -> torch.Tensor:
    """XAttention's block importance estimate, in float32 plain torch.

    q (B,K,G,Sq,D), k (B,K,Skv,D), both padded to ``block``. For each
    (query block, key block) pair: the logsumexp over the products of
    every ``stride``-th query row with every ``stride``-th key row of the
    reversed key block (the sampled antidiagonals). Returns
    (B,K,G,nqb,nkb) float32."""
    B, K, G, Sq, D = q.shape
    Skv = k.shape[2]
    nqb, nkb = Sq // block, Skv // block
    qs = q.reshape(B, K, G, nqb, block, D)[:, :, :, :, ::stride]
    ks = k.reshape(B, K, nkb, block, D).flip(3)[:, :, :, ::stride]
    s = torch.einsum("bkgqrd,bkncd->bkgqnrc", qs.float(),
                     ks.float()) * scale
    return torch.logsumexp(s, dim=(-2, -1))


def xa_scores(q: torch.Tensor, k: torch.Tensor, mode: AttnMode, *,
              q_offset: int, scale: float):
    """XAttention's block scores as its top-k ranks them, and the budget:
    the antidiagonal estimate of each (query block, key block) pair of
    each query head, -1e30 past the causal diagonal (at block
    granularity), +inf for block 0 (the sink) and the diagonal block.
    q (B,Hq,Sq,D), k (B,Hkv,Skv,D) → ((B,Hkv,G,nqb,nkb) float32, keep)."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    blk = mode.block
    Sq_pad, Skv_pad = -(-Sq // blk) * blk, -(-Skv // blk) * blk
    q5 = _pad_to(q.reshape(B, Hkv, Hq // Hkv, Sq, D), 3, Sq_pad)
    nqb, nkb = Sq_pad // blk, Skv_pad // blk
    scores = antidiagonal_scores(q5, _pad_to(k, 2, Skv_pad), blk,
                                 mode.stride, scale)
    qb = q_offset // blk + torch.arange(nqb, device=q.device)
    kb = torch.arange(nkb, device=q.device)
    scores = torch.where(kb[None, :] <= qb[:, None], scores, NEG_INF)
    forced = (kb[None, :] == 0) | (kb[None, :] == qb[:, None])
    return (torch.where(forced, torch.inf, scores),
            xa_keep_blocks(nkb, mode.threshold))


def xa_selection(q: torch.Tensor, k: torch.Tensor, mode: AttnMode, *,
                 q_offset: int, scale: float) -> torch.Tensor:
    """The key blocks each query block of each query head attends under
    XAttention, at ``mode.block`` granularity: the first ``keep`` of
    ``xa_scores`` by a stable descending sort, which puts the lower index
    first among equal scores as ``lax.top_k`` does. Returns (B·Hq,
    ceil(Sq/block), keep) int64, head-major as the kernels flatten q."""
    scores, keep = xa_scores(q, k, mode, q_offset=q_offset, scale=scale)
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return order[..., :keep].reshape(q.shape[0] * q.shape[1], -1, keep)


def expand_selection(sel: torch.Tensor, block: int, Sq: int, Skv: int,
                     q_offset: int) -> torch.Tensor:
    """A ``block``-granular selection (BH, ceil(Sq/block), keep) in the
    block-sparse kernel's 64-token tiles, ``block`` a multiple of
    KERNEL_BLOCK: query tile t takes the selection of block
    t·64 // block, and block j becomes tiles j·r … j·r + r - 1 (r =
    block // 64), sorted ascending. Tiles past Skv and tiles wholly past
    the query tile's last row (their keys are all masked: they add exact
    zeros) are -1. Returns (BH, ceil(Sq/64), keep·r) int32."""
    r = block // KERNEL_BLOCK
    nqt = -(-Sq // KERNEL_BLOCK)
    t = torch.arange(nqt, device=sel.device)
    rows = sel[:, t * KERNEL_BLOCK // block]          # (BH, nqt, keep)
    tiles = (rows[..., None] * r
             + torch.arange(r, device=sel.device)).flatten(-2)
    tiles = torch.sort(tiles, dim=-1).values
    last = q_offset + torch.clamp((t + 1) * KERNEL_BLOCK, max=Sq) - 1
    dead = ((tiles >= -(-Skv // KERNEL_BLOCK))
            | (tiles * KERNEL_BLOCK > last[None, :, None]))
    return torch.where(dead, -1, tiles).to(torch.int32)


def _block_topk(q, k, v, mode: AttnMode, *, q_offset: int, scale: float):
    """XAttention: ``xa_selection``, then the block-sparse kernel over it
    (query row r sees the selected keys <= ``q_offset + r``, as the JAX
    package masks ``pos <= q_pos``). A ``mode.block`` that is not a
    multiple of the kernel's 64-token tile runs the plain version at
    that block on CPU tensors and raises on CUDA tensors. Under autograd
    the selection is a constant (its indices carry no gradient, as
    ``lax.top_k``'s do not), so it is made without a graph; the gradient
    flows through the block-sparse call (on the card its backward
    kernel)."""
    B, Hq, Sq, D = q.shape
    Skv = k.shape[2]
    with torch.no_grad():
        sel = xa_selection(q, k, mode, q_offset=q_offset, scale=scale)
    if mode.block % KERNEL_BLOCK == 0:
        out = block_sparse_attention_bh(
            _flat(q), _flat(k), _flat(v),
            expand_selection(sel, mode.block, Sq, Skv, q_offset),
            q_offset=q_offset, scale=scale)
    elif _build.on_cpu("attention(block_topk)", q):
        out = block_sparse_attention_ref(_flat(q), _flat(k), _flat(v), sel,
                                         block=mode.block,
                                         q_offset=q_offset, scale=scale)
    else:
        raise ValueError(
            f"attention(block_topk): block={mode.block} is not a multiple "
            f"of the block-sparse kernel's {KERNEL_BLOCK}-token tile; the "
            f"kernel cannot run this selection on the card")
    return out.reshape(B, Hq, Sq, out.shape[-1])


# ---------------------------------------------------------------------------
# Head-level split (DuoAttention / PruLong baselines)
# ---------------------------------------------------------------------------

def head_split_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         n_fa_kv: int, sa: AttnMode, *,
                         q_offset: int = 0, kv_first: int = 0
                         ) -> torch.Tensor:
    """Static head-level hybrid: the first ``n_fa_kv`` KV heads of the
    model and their query groups run full attention, the rest run
    ``sa``. ``k`` / ``v`` hold the KV heads from global index
    ``kv_first`` on (a tensor-parallel rank's share), so FA runs on
    their first clamp(n_fa_kv - kv_first, 0, Hkv) heads; either part may
    be empty. The head slices are copied contiguous (they are strided
    when B > 1)."""
    Hkv = k.shape[1]
    n_fa = min(max(n_fa_kv - kv_first, 0), Hkv)
    n_fa_q = n_fa * (q.shape[1] // Hkv)

    def heads(x, a, b):
        return x[:, a:b].contiguous()

    parts = []
    if n_fa:
        parts.append(attention(heads(q, 0, n_fa_q), heads(k, 0, n_fa),
                               heads(v, 0, n_fa), FULL, q_offset=q_offset))
    if n_fa < Hkv:
        parts.append(attention(heads(q, n_fa_q, None), heads(k, n_fa, None),
                               heads(v, n_fa, None), sa,
                               q_offset=q_offset))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


# ---------------------------------------------------------------------------
# FLOP model (the napkin math of the JAX package's prefill benchmark)
# ---------------------------------------------------------------------------

def mode_flops(mode: AttnMode, Sq: int, Skv: int, num_heads: int,
               head_dim: int, batch: int = 1) -> float:
    """Matmul FLOPs of one attention call (2 per MAC), per the mode's
    expressed computation in the JAX package's blocked engine."""
    per_pair = 4.0 * head_dim  # QK^T + PV, 2 FLOPs per MAC each
    if mode.kind == "full":
        pairs = Sq * Skv
    elif mode.kind == "window":
        pairs = Sq * min(mode.local + 512, Skv)
    elif mode.kind == "streaming":
        pairs = Sq * min(mode.sink + mode.local + 512, Skv)
    elif mode.kind == "triangle":
        last = min(mode.chunk, Sq)
        pre = Sq - last
        pairs = pre * min(mode.sink + mode.local + 512, Skv) + last * Skv
    elif mode.kind == "block_topk":
        nkb = -(-Skv // mode.block)
        keep = xa_keep_blocks(nkb, mode.threshold)
        pairs = Sq * keep * mode.block
        pairs += (Sq // mode.stride) * (Skv // mode.stride)  # scoring
    else:
        raise ValueError(mode.kind)
    return batch * num_heads * pairs * per_pair
