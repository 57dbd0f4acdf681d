"""Attention layers: projections in and out (port of
``repro/models/attention.py``): GQA for the dense archs and Multi-head
Latent Attention (MLA) for DeepSeek-V2. The attention itself runs
through ``repro_torch.core.modes`` and the decode kernels.

MLA caches the compressed KV latent ``ckv`` (B, S, R) and one shared
roped key ``kr`` (B, 1, S, rope) a token, not per-head K / V. The route
chunk decompresses them (``mla_expand_kv``) and runs the prefill kernels
at (Dk, Dv) = (nope + rope, v_head_dim); decode and the full-cache
streamed chunks attend in latent space with W_uk absorbed into the query
and W_uv into the output (``mla_absorbed_*``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import tp_reduce
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import (apply_rope, dense_init, rms_norm,
                                       rms_norm_init)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

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
    """attn (B,H,S,hd) → (B,S,d). Under tensor parallelism ``wo`` holds
    the rows of the rank's heads, and the partial products sum over the
    ranks here (a reduce point, ``distributed/sharding.py``)."""
    B, H, S, hd = attn.shape
    y = attn.transpose(1, 2).reshape(B, S, H * hd)
    return tp_reduce(y @ params["wo"])


# ---------------------------------------------------------------------------
# MLA (Multi-head Latent Attention, DeepSeek-V2)
# ---------------------------------------------------------------------------

def mla_init(gen: torch.Generator,
             cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    d, dt, dev = cfg.d_model, cfg.param_dtype, gen.device
    qk_hd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    return {
        "w_dq": dense_init(gen, d, cfg.q_lora_rank, dt),
        "q_norm": rms_norm_init(cfg.q_lora_rank, dt, dev),
        "w_uq": dense_init(gen, cfg.q_lora_rank, cfg.num_heads * qk_hd, dt),
        "w_dkv": dense_init(gen, d, cfg.kv_lora_rank, dt),
        "kv_norm": rms_norm_init(cfg.kv_lora_rank, dt, dev),
        "w_kr": dense_init(gen, d, cfg.qk_rope_head_dim, dt),
        "w_ukv": dense_init(
            gen, cfg.kv_lora_rank,
            cfg.num_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim), dt),
        "wo": dense_init(gen, cfg.num_heads * cfg.v_head_dim, d, dt),
    }


def mla_latent(params, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compressed KV: the normed latent ckv (B,S,R) and the shared roped
    key kr (B,1,S,rope). This pair is what the caches hold."""
    ckv = rms_norm(params["kv_norm"], x @ params["w_dkv"], cfg.norm_eps)
    k_rope = (x @ params["w_kr"])[:, None]  # one head shared by all
    return ckv, apply_rope(k_rope, positions, cfg.rope_theta)


def mla_q(params, cfg: ModelConfig, x: torch.Tensor,
          positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B,H,S,nope+rope), RoPE on its last ``rope`` columns, and the
    router input x_Q (B,S,H·(nope+rope))."""
    B, S, _ = x.shape
    nope = cfg.qk_nope_head_dim
    q_lat = rms_norm(params["q_norm"], x @ params["w_dq"], cfg.norm_eps)
    x_q = q_lat @ params["w_uq"]
    q = x_q.reshape(B, S, cfg.num_heads, -1).transpose(1, 2)
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    return torch.cat([q[..., :nope], q_rope], dim=-1), x_q


def mla_expand_kv(params, cfg: ModelConfig, ckv: torch.Tensor,
                  k_rope: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decompress the latent → per-head K (B,H,S,nope+rope) and V
    (B,H,S,v), both contiguous."""
    B, S, _ = ckv.shape
    H, nope = cfg.num_heads, cfg.qk_nope_head_dim
    kv = (ckv @ params["w_ukv"]).reshape(B, S, H, -1).transpose(1, 2)
    k = torch.cat([kv[..., :nope],
                   k_rope.expand(B, H, S, cfg.qk_rope_head_dim)], dim=-1)
    return k, kv[..., nope:].contiguous()


def mla_out(params, cfg: ModelConfig, attn: torch.Tensor) -> torch.Tensor:
    """attn (B,H,S,v) → (B,S,d). Under tensor parallelism ``wo`` holds
    the rows of the rank's heads, and the partial products sum over the
    ranks here (a reduce point, ``distributed/sharding.py``): the route
    chunk, a streamed chunk's absorbed attention and the latent decode
    all end in it."""
    B, H, S, dv = attn.shape
    return tp_reduce(attn.transpose(1, 2).reshape(B, S, H * dv)
                     @ params["wo"])


def _w_uk_uv(params, cfg: ModelConfig):
    """The absorbed halves of w_ukv: W_uk (R,H,nope), W_uv (R,H,v)."""
    R, H, nope = cfg.kv_lora_rank, cfg.num_heads, cfg.qk_nope_head_dim
    w = params["w_ukv"].reshape(R, H, -1)
    return w[:, :, :nope], w[:, :, nope:]


def mla_scale(cfg: ModelConfig) -> float:
    """The softmax scale of the absorbed attention, (nope + rope) ** -0.5:
    that of the per-head scores it re-expresses, not Dk ** -0.5 of the
    (R + rope)-wide latent query."""
    return (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5


# the fp32 scores of one absorbed-attention pass over a latent cache
# are (rows, H, Sq, S): past this many elements the rows go one at a time
# (a 512-token chunk of 4 rows over 4096 keys at 128 heads is 4.3 GB)
_SCORES_PER_PASS = 1 << 28


def mla_absorbed_attend(params, cfg: ModelConfig, x: torch.Tensor,
                        positions: torch.Tensor, ckv_cache: torch.Tensor,
                        kr_cache: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """Weight-absorbed MLA attention over a latent cache: scores in
    latent space (W_uk absorbed into the query, W_uv into the output),
    so nothing is decompressed per head. x (B,Sq,d); ckv_cache (B,S,R);
    kr_cache (B,1,S,rope); valid (B,Sq,S) bool. Returns (B,Sq,d).

    As the JAX package computes it: fp32 scores (never rounded to the
    operands' dtype), the -1e30 mask, p cast to the latent's dtype before
    the PV product. Rows are independent, so a large pass runs them one
    at a time."""
    nope = cfg.qk_nope_head_dim
    q, _ = mla_q(params, cfg, x, positions)  # (B,H,Sq,nope+rope)
    w_uk, w_uv = _w_uk_uv(params, cfg)
    q_lat = torch.einsum("bhqn,rhn->bhqr", q[..., :nope], w_uk)
    q_rope = q[..., nope:]
    B, H, Sq = q.shape[:3]
    step = max(1, _SCORES_PER_PASS // (H * Sq * ckv_cache.shape[1]))
    ctx = []
    for b in range(0, B, step):
        rows = slice(b, b + step)
        scores = torch.einsum("bhqr,bsr->bhqs", q_lat[rows].float(),
                              ckv_cache[rows].float())
        scores = scores + torch.einsum("bhqe,bzse->bhqs",
                                       q_rope[rows].float(),
                                       kr_cache[rows].float())
        scores = scores * mla_scale(cfg)
        scores = torch.where(valid[rows, None], scores, NEG_INF)
        p = torch.softmax(scores, dim=-1).to(ckv_cache.dtype)
        del scores
        ctx.append(torch.einsum("bhqs,bsr->bhqr", p, ckv_cache[rows]))
    attn = torch.einsum("bhqr,rhv->bhqv", torch.cat(ctx), w_uv)
    return mla_out(params, cfg, attn)


def mla_absorbed_decode(params, cfg: ModelConfig, x: torch.Tensor,
                        position: torch.Tensor, ckv_cache: torch.Tensor,
                        kr_cache: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """Single-token absorbed decode: x (B,1,d), valid (B,S) → (B,1,d)."""
    return mla_absorbed_attend(params, cfg, x, position, ckv_cache,
                               kr_cache, valid[:, None, :])


def mla_absorbed_q(params, cfg: ModelConfig, x: torch.Tensor,
                   position: torch.Tensor) -> torch.Tensor:
    """The latent query of the absorbed decode, q_eff = [q_nope·W_ukᵀ ‖
    q_rope] (B,H,1,R+rope): its product with k_eff = [ckv ‖ kr] is the
    absorbed score."""
    nope = cfg.qk_nope_head_dim
    q, _ = mla_q(params, cfg, x, position)  # (B,H,1,nope+rope)
    w_uk, _ = _w_uk_uv(params, cfg)
    q_lat = torch.einsum("bhqn,rhn->bhqr", q[..., :nope], w_uk)
    return torch.cat([q_lat, q[..., nope:]], dim=-1)


def mla_absorbed_qkv(params, cfg: ModelConfig, x: torch.Tensor,
                     position: torch.Tensor, ckv_cache: torch.Tensor,
                     kr_cache: torch.Tensor):
    """The absorbed decode as GQA-shaped (q, k, v, scale) with one KV
    head: q_eff (B,H,1,R+rope), k_eff = [ckv ‖ kr] (B,1,S,R+rope),
    v_eff = ckv (B,1,S,R), scale (nope + rope) ** -0.5. Softmax(q·kᵀ)·v
    is the latent context (B,H,1,R) that ``mla_absorbed_finish`` takes.
    The serving decode never builds k_eff: the latent decode kernel
    (``kernels/decode_attention_mla.py``) reads ckv and kr in place."""
    B, S = ckv_cache.shape[:2]
    k_eff = torch.cat(
        [ckv_cache[:, None],
         kr_cache.expand(B, 1, S, cfg.qk_rope_head_dim)], dim=-1)
    return (mla_absorbed_q(params, cfg, x, position), k_eff,
            ckv_cache[:, None], mla_scale(cfg))


def mla_absorbed_finish(params, cfg: ModelConfig,
                        ctx: torch.Tensor) -> torch.Tensor:
    """Latent context ctx (B,H,1,R) → output projection (B,1,d)."""
    _, w_uv = _w_uk_uv(params, cfg)
    attn = torch.einsum("bhqr,rhv->bhqv", ctx, w_uv)  # (B,H,1,v)
    return mla_out(params, cfg, attn)
