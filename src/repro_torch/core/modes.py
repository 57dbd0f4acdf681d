"""Attention modes of the serving path (port of ``repro/core/modes.py``).

Layout convention: q is (B, Hq, Sq, D); k/v are (B, Hkv, Skv, D) with
Hq = G·Hkv (GQA). ``attention`` and ``chunk_causal_attention`` flatten to
the kernels' (B·H, S, D) and call the kernel entries, which launch the
hand-written CUDA kernels on CUDA tensors and run their plain versions
on CPU tensors. ``masked_attention`` stays plain PyTorch: the JAX package
computes it outside any Pallas kernel too.

This slice ports the ``full`` and ``streaming`` kinds (FA and the SSA
sparse mode); ``window``, ``triangle`` and ``block_topk`` wait for the
slices that serve gemma3-style local layers and the xa/ta modes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels.block_sparse_attention import (
    KERNEL_BLOCK, block_sparse_attention_bh)
from repro_torch.kernels.flash_attention import flash_attention_bh
from repro_torch.kernels.ref import NEG_INF
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


def ssa_mode(flux) -> AttnMode:
    return AttnMode("streaming", sink=flux.sink, local=flux.local)


def sa_mode_for(flux) -> AttnMode:
    if flux.sa_mode != "ssa":
        raise NotImplementedError(
            f"sa_mode={flux.sa_mode!r}: the port serves the ssa sparse "
            f"mode only; xa/ta wait for ROADMAP Queue 1 item 14")
    return ssa_mode(flux)


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, *x.shape[2:])


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mode: AttnMode, *, q_offset: int = 0,
              scale: Optional[float] = None) -> torch.Tensor:
    """Attention under ``mode`` over the whole of k/v.

    q (B,Hq,Sq,D); k, v (B,Hkv,Skv,D); query row r sits at position
    ``q_offset + r``. ``full`` runs the flash kernel, ``streaming`` the
    sink+local kernel. Returns (B,Hq,Sq,D) in q's dtype."""
    B, Hq, Sq, D = q.shape
    qf, kf, vf = _flat(q), _flat(k), _flat(v)
    if mode.kind == "full":
        out = flash_attention_bh(qf, kf, vf, causal=mode.causal,
                                 scale=scale, q_offset=q_offset)
    elif mode.kind == "streaming":
        out = streaming_attention_bh(qf, kf, vf, sink=mode.sink,
                                     local=max(mode.local, 1), scale=scale,
                                     q_offset=q_offset)
    else:
        raise NotImplementedError(
            f"attention mode {mode.kind!r}: this slice ports 'full' and "
            f"'streaming'; the others wait for ROADMAP Queue 1 item 14")
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
