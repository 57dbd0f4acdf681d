"""GQA attention layer: projections in and out (port of the GQA half of
``repro/models/attention.py``). The attention itself runs through
``repro_torch.core.modes``; MLA waits for ROADMAP Queue 1 item 11."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init


def gqa_init(gen: torch.Generator,
             cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    d, dt = cfg.d_model, cfg.param_dtype
    return {
        "wq": dense_init(gen, d, cfg.q_dim, dt),
        "wk": dense_init(gen, d, cfg.kv_dim, dt),
        "wv": dense_init(gen, d, cfg.kv_dim, dt),
        "wo": dense_init(gen, cfg.q_dim, d, dt),
    }


def gqa_qkv(params, cfg: ModelConfig, x: torch.Tensor,
            positions: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B,S,d) → q (B,H,S,hd), k/v (B,Hkv,S,hd), x_Q (B,S,q_dim).

    q and k carry RoPE at ``positions`` ((S,) or per row (B, S)); x_Q is
    the pre-RoPE query projection the Layer Router reads. q, k, v are
    contiguous."""
    B, S, _ = x.shape
    x_q = x @ params["wq"]
    q = x_q.reshape(B, S, cfg.num_heads, cfg.head_dim).transpose(1, 2)
    k = (x @ params["wk"]).reshape(B, S, cfg.num_kv_heads,
                                   cfg.head_dim).transpose(1, 2)
    v = (x @ params["wv"]).reshape(B, S, cfg.num_kv_heads,
                                   cfg.head_dim).transpose(1, 2)
    q = apply_rope(q, positions, cfg.rope_theta).contiguous()
    k = apply_rope(k, positions, cfg.rope_theta).contiguous()
    return q, k, v.contiguous(), x_q


def gqa_out(params, cfg: ModelConfig, attn: torch.Tensor) -> torch.Tensor:
    """attn (B,H,S,hd) → (B,S,d)."""
    B, H, S, hd = attn.shape
    y = attn.transpose(1, 2).reshape(B, S, H * hd)
    return y @ params["wo"]
