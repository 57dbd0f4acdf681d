"""Shared building blocks: RMSNorm, RoPE, SwiGLU, linear init
(port of ``repro/models/layers.py``)."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import tp_reduce


# ---------------------------------------------------------------------------
# Init helpers (the JAX package's scales; a torch.Generator draws them)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype) -> torch.Tensor:
    w = torch.randn((in_dim, out_dim), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.mul_(in_dim ** -0.5).to(dtype)  # in place: one fp32 copy


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype) -> torch.Tensor:
    w = torch.randn((vocab, dim), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rms_norm_init(dim: int, dtype, device) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rms_norm(params: Dict[str, torch.Tensor], x: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (half-rotation / llama style)
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate ``x`` (B, H, S, D) by position-dependent angles.

    ``positions``: the absolute position of each sequence entry, (S,)
    shared by every batch row or (B, S) one row per batch row (the slot
    pool's decode, where each row is its own request)."""
    d = x.shape[-1]
    inv_freq = rope_frequencies(d, theta, x.device)
    angles = positions.float()[..., None] * inv_freq  # (S | B,S, d/2)
    if angles.dim() == 3:
        angles = angles[:, None]  # (B, 1, S, d/2): the same for every head
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU FFN
# ---------------------------------------------------------------------------

def ffn_init(gen: torch.Generator, d_model: int, d_ff: int,
             dtype) -> Dict[str, torch.Tensor]:
    return {
        "gate": dense_init(gen, d_model, d_ff, dtype),
        "up": dense_init(gen, d_model, d_ff, dtype),
        "down": dense_init(gen, d_ff, d_model, dtype),
    }


def ffn_partial(params: Dict[str, torch.Tensor],
                x: torch.Tensor) -> torch.Tensor:
    """SwiGLU without its reduce: under tensor parallelism the rank holds
    a slice of the FFN width, and this is its partial product, which
    ``ffn_apply`` (or an MoE layer's ``moe_ffn``, once with its routed
    experts) sums over the ranks."""
    h = F.silu(x @ params["gate"]) * (x @ params["up"])
    return h @ params["down"]


def ffn_apply(params: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
    """SwiGLU, its partial products summed over the ranks here (a reduce
    point, ``distributed/sharding.py``)."""
    return tp_reduce(ffn_partial(params, x))
