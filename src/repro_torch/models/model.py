"""Model assembly for the serving path (port of ``repro/models/model.py``).

Parameters are a plain dictionary of tensors. The JAX package stacks its
trunk by period position for ``lax.scan``; the port keeps one dictionary
per layer in ``params["layers"]`` and walks them in a Python loop
(``repro_torch.bridge.params_from_jax`` un-stacks a JAX pytree into this
layout).

Flux routing contexts of ``prefill`` (as in the JAX package):
  ("hard", [thr])         — router decision per layer over prefix+suffix
                            pooling, batch consensus mean(p_fa) > thr;
  ("hard_prefix", [thr])  — the same with prefix-only pooling (the
                            chunk-invariant serving variant);
  ("fixed", decision)     — externally forced decision (1 = FA, 0 = SA);
  ("fa_only",)            — backbone as-is.
The Gumbel soft routing of training waits for the training slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import modes as M
from repro_torch.core import router as R
from repro_torch.kernels.decode_attention import decode_attention_bh
from repro_torch.kernels.decode_attention_pooled import \
    decode_attention_pooled_bh
from repro_torch.models import attention as A
from repro_torch.models.layers import (dense_init, embed_init, ffn_apply,
                                       ffn_init, rms_norm, rms_norm_init)
from repro_torch.serve import kv_cache as KC

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Structure helpers
# ---------------------------------------------------------------------------

def check_supported(cfg: ModelConfig) -> None:
    """The layer kinds this slice runs: dense GQA global attention + FFN."""
    if (cfg.use_mla or cfg.num_experts or cfg.num_encoder_layers
            or cfg.num_prefix_tokens
            or any(k != "attn" for k in cfg.layer_kinds)):
        raise NotImplementedError(
            f"{cfg.name}: this slice serves dense GQA models (all layers "
            f"'attn', no MoE/MLA/SSM/encoder/modality prefix); the other "
            f"layer kinds wait for ROADMAP Queue 1 items 11-14")


def is_routed(cfg: ModelConfig, layer_idx: int) -> bool:
    return cfg.flux.enabled and cfg.layer_kinds[layer_idx] == "attn"


def sa_mode(cfg: ModelConfig) -> M.AttnMode:
    return M.sa_mode_for(cfg.flux)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _block_init(gen: torch.Generator, cfg: ModelConfig,
                layer_idx: int) -> Params:
    dt, dev = cfg.param_dtype, gen.device
    p: Params = {"norm1": rms_norm_init(cfg.d_model, dt, dev),
                 "attn": A.gqa_init(gen, cfg)}
    if is_routed(cfg, layer_idx):
        p["router"] = R.router_init(gen, cfg.q_dim, cfg.flux)
    p["norm2"] = rms_norm_init(cfg.d_model, dt, dev)
    p["ffn"] = ffn_init(gen, cfg.d_model, cfg.d_ff, dt)
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device=None) -> Params:
    """Random weights at the JAX package's init scales, drawn from
    ``gen`` on the generator's device and placed on ``device`` (default
    cuda). The same generator seed gives the same weights."""
    device = resolve_device(device)
    check_supported(cfg)
    params: Params = {
        "layers": [_block_init(gen, cfg, i) for i in range(cfg.num_layers)],
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model,
                            cfg.param_dtype),
        "final_norm": rms_norm_init(cfg.d_model, cfg.param_dtype,
                                    gen.device),
    }
    if not cfg.tie_embeddings:
        params["out_w"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                     cfg.param_dtype)
    return params_to(params, device)


def params_to(params, device):
    """Move a (nested) parameter dictionary to ``device``."""
    if isinstance(params, torch.Tensor):
        return params.to(device)
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    return [params_to(v, device) for v in params]


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _route_and_attend(bp, cfg: ModelConfig, q, k, v, x_q, ctx,
                      q_offset: int = 0):
    """Run FA or SA per the routing context. Returns (attn_out, r) with
    r = (decision 0/1, p_fa mean) for the hard and fixed contexts."""
    kind = ctx[0]
    if kind == "fa_only":
        return M.attention(q, k, v, M.FULL, q_offset=q_offset), None
    if kind in ("hard", "hard_prefix"):
        pooling = "prefix" if kind == "hard_prefix" else "prefix_suffix"
        _, p_fa = R.hard_route(bp["router"], x_q, cfg.flux, pooling)
        thr = ctx[1] if len(ctx) > 1 else 0.5
        p_mean = p_fa.mean()
        # batch-consensus decision, strict > as in the JAX package
        decision = int(bool(p_mean > torch.tensor(thr, dtype=torch.float32,
                                                  device=p_mean.device)))
        p_mean = float(p_mean)
    elif kind == "fixed":
        decision = int(ctx[1])
        p_mean = float(decision)
    else:
        raise NotImplementedError(
            f"routing context {kind!r}: the soft (training) and "
            f"head_split contexts wait for ROADMAP Queue 1 items 15 and 14")
    mode = M.FULL if decision > 0 else sa_mode(cfg)
    return M.attention(q, k, v, mode, q_offset=q_offset), (decision, p_mean)


def block_apply(bp, cfg: ModelConfig, layer_idx: int, h: torch.Tensor,
                positions: torch.Tensor, ctx, want_cache: bool = False):
    """One transformer block over a full sequence. Returns (h, r, cache):
    r is the routing record of a routed layer else None; cache is the
    layer's (k, v) when ``want_cache``."""
    x = rms_norm(bp["norm1"], h, cfg.norm_eps)
    q, k, v, x_q = A.gqa_qkv(bp["attn"], cfg, x, positions)
    cache = (k, v) if want_cache else None
    r = None
    if is_routed(cfg, layer_idx) and ctx[0] != "fa_only":
        o, r = _route_and_attend(bp, cfg, q, k, v, x_q, ctx)
    else:
        o = M.attention(q, k, v, M.FULL)
    h = h + A.gqa_out(bp["attn"], cfg, o)
    x2 = rms_norm(bp["norm2"], h, cfg.norm_eps)
    h = h + ffn_apply(bp["ffn"], x2)
    return h, r, cache


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------

def embed_tokens(params, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, params["embed"]).to(cfg.dtype)


def unembed_matrix(params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["out_w"]


def logits_from_hidden(params, cfg: ModelConfig,
                       h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(params["final_norm"], h, cfg.norm_eps)
    return h @ unembed_matrix(params, cfg).to(h.dtype)


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

@dataclass
class ForwardOut:
    logits: torch.Tensor                 # (B, V) last-token logits
    routing: Optional[torch.Tensor]      # (n_routed,) int32 decisions
    p_fa: Optional[torch.Tensor]         # (n_routed,) f32 mean FA prob
    caches: Optional[List] = None        # per layer (k, v)


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            routing_ctx: str = "hard",
            fixed_pattern: Optional[Sequence[int]] = None,
            want_cache: bool = True,
            fa_threshold: Optional[float] = None) -> ForwardOut:
    """Serving prefill over the whole of ``tokens`` (B, S): hard routing
    (or a fixed pattern), full per-layer KV out.

    ``fixed_pattern``: (num_layers,) ints (1 = FA, 0 = SA) for
    ``routing_ctx="fixed"``. ``fa_threshold``: the FA-decision threshold
    of the hard contexts (None = the paper's 0.5 argmax)."""
    if routing_ctx not in ("hard", "hard_prefix", "fixed", "fa_only"):
        raise NotImplementedError(
            f"routing_ctx={routing_ctx!r}: the head_split baseline waits "
            f"for ROADMAP Queue 1 item 14")
    h = embed_tokens(params, cfg, tokens)
    positions = torch.arange(h.shape[1], device=h.device)
    rs, caches = [], []
    for i, bp in enumerate(params["layers"]):
        if not cfg.flux.enabled or routing_ctx == "fa_only":
            ctx = ("fa_only",)
        elif routing_ctx == "fixed":
            ctx = ("fixed", int(fixed_pattern[i]))
        else:
            ctx = ((routing_ctx,) if fa_threshold is None
                   else (routing_ctx, float(fa_threshold)))
        h, r, cache = block_apply(bp, cfg, i, h, positions, ctx,
                                  want_cache=want_cache)
        if r is not None:
            rs.append(r)
        caches.append(cache)
    logits = logits_from_hidden(params, cfg, h[:, -1])
    routing = p_fa = None
    if rs:
        routing = torch.tensor([r[0] for r in rs], dtype=torch.int32)
        p_fa = torch.tensor([r[1] for r in rs], dtype=torch.float32)
    return ForwardOut(logits=logits, routing=routing, p_fa=p_fa,
                      caches=caches if want_cache else None)


# ---------------------------------------------------------------------------
# Decode (dispatched on cache type: ring ⇒ sink+local, full ⇒ causal)
#
# ``pos`` is a Python int — every row at one position, single-request
# serving, on the decode kernel — or a (B,) int32 device tensor — one
# position per row, the continuous-batching slot pool, where every row is
# its own request with its own RoPE angles, cache slot and live length, on
# the pooled decode kernel.
# ---------------------------------------------------------------------------

def _dot_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                positions: torch.Tensor, cur_pos: int) -> torch.Tensor:
    """q (B,H,1,D), k/v (B,Hkv,L,D), positions (L,) int32 shared by all
    rows → (B,H,1,D). Slot j is visible iff 0 <= positions[j] <= cur_pos.
    Runs the decode kernel on CUDA tensors (its plain version on CPU)."""
    B, Hq, _, D = q.shape
    Hkv, L = k.shape[1], k.shape[2]
    out = decode_attention_bh(q.reshape(B * Hq, 1, D),
                              k.reshape(B * Hkv, L, D),
                              v.reshape(B * Hkv, L, v.shape[-1]),
                              positions, cur_pos)
    return out.reshape(B, Hq, 1, out.shape[-1])


def _dot_decode_pooled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       positions: Optional[torch.Tensor],
                       lengths: torch.Tensor) -> torch.Tensor:
    """q (B,H,1,D), k/v (B,Hkv,L,D), positions (B,L) int32 (-1 = not
    visible) or None (slot j holds position j), lengths (B,) live slots
    per row → (B,H,1,D). Runs the pooled decode kernel on CUDA tensors
    (its plain version on CPU)."""
    B, Hq, _, D = q.shape
    Hkv, L = k.shape[1], k.shape[2]
    out = decode_attention_pooled_bh(q.reshape(B * Hq, 1, D),
                                     k.reshape(B * Hkv, L, D),
                                     v.reshape(B * Hkv, L, v.shape[-1]),
                                     positions, lengths, n_heads=Hq)
    return out.reshape(B, Hq, 1, out.shape[-1])


def _decode_attn_full(bp, cfg, x, pos, rope_pos, cache: KC.FullKV,
                      slot_positions):
    q, k, v, _ = A.gqa_qkv(bp["attn"], cfg, x, rope_pos)
    cache = KC.full_insert(cache, k, v, pos)
    if isinstance(pos, torch.Tensor):
        # per row: slots [0, length) are live and slot j holds position j
        o = _dot_decode_pooled(q, cache.k, cache.v, None, cache.length)
    else:
        o = _dot_decode(q, cache.k, cache.v, slot_positions, pos)
    return A.gqa_out(bp["attn"], cfg, o), cache


def _decode_attn_ring(bp, cfg, x, pos, rope_pos, cache: KC.RingKV,
                      sink: int, local: int):
    q, k, v, _ = A.gqa_qkv(bp["attn"], cfg, x, rope_pos)
    cache = KC.ring_insert(cache, k, v, pos, sink, local)
    if isinstance(pos, torch.Tensor):
        # per row: the ring's occupied slots are a prefix of
        # min(length, ring) entries; entries the row must not see (past
        # its position: a free row parked at 0 over a stale ring) are
        # re-marked -1, so the kernel's test equals the causal mask
        ring = cache.positions.shape[1]
        vis = (cache.positions >= 0) & (cache.positions <= pos[:, None])
        o = _dot_decode_pooled(q, cache.k, cache.v,
                               torch.where(vis, cache.positions, -1),
                               torch.clamp(cache.length, max=ring))
    else:
        # uniform positions keep every row of cache.positions identical,
        # so row 0 is the shared (L,) slot-position vector the kernel
        # takes
        o = _dot_decode(q, cache.k, cache.v, cache.positions[0], pos)
    return A.gqa_out(bp["attn"], cfg, o), cache


def decode_core(params, cfg: ModelConfig, token: torch.Tensor,
                caches: List, pos):
    """One autoregressive step at position ``pos``: an int shared by all
    rows, or a (B,) int32 device tensor, one per row. token (B,1).
    Updates ``caches`` in place. Returns (logits (B,V), caches)."""
    h = embed_tokens(params, cfg, token)
    pooled = isinstance(pos, torch.Tensor)
    rope_pos = (pos[:, None] if pooled
                else torch.full((1,), pos, device=h.device))
    slot_positions: Dict[int, torch.Tensor] = {}  # FullKV capacity → arange
    flux = cfg.flux
    for i, bp in enumerate(params["layers"]):
        cache = caches[i]
        x = rms_norm(bp["norm1"], h, cfg.norm_eps)
        if isinstance(cache, KC.RingKV):
            ring = cache.k.shape[2]
            y, cache = _decode_attn_ring(bp, cfg, x, pos, rope_pos, cache,
                                         flux.sink, ring - flux.sink)
        else:
            L = cache.k.shape[2]
            if not pooled and L not in slot_positions:
                slot_positions[L] = torch.arange(L, dtype=torch.int32,
                                                 device=h.device)
            y, cache = _decode_attn_full(bp, cfg, x, pos, rope_pos, cache,
                                         slot_positions.get(L))
        h = h + y
        x2 = rms_norm(bp["norm2"], h, cfg.norm_eps)
        h = h + ffn_apply(bp["ffn"], x2)
        caches[i] = cache
    return logits_from_hidden(params, cfg, h[:, -1]), caches


def decode_many(params, cfg: ModelConfig, logits: torch.Tensor,
                caches: List, pos, *, n_steps: int,
                greedy: bool = True):
    """Greedy generation for ``n_steps``: token i is the argmax of the
    logits before decode step i. ``pos`` is the absolute position of the
    first generated token: an int, or a (B,) int32 device tensor, one per
    row, advanced on the device (no step reads it back). Returns (tokens
    (B, n_steps) int64, last logits (B, V), caches)."""
    if not greedy:
        raise NotImplementedError(
            "sampled decoding (greedy=False) waits for ROADMAP Queue 1 "
            "item 17")
    toks = []
    for step in range(n_steps):
        nxt = torch.argmax(logits, dim=-1)
        toks.append(nxt)
        logits, caches = decode_core(params, cfg, nxt[:, None], caches,
                                     pos + step)
    out = (torch.stack(toks, dim=1) if toks
           else torch.zeros((logits.shape[0], 0), dtype=torch.int64,
                            device=logits.device))
    return out, logits, caches


# ---------------------------------------------------------------------------
# Chunked cache-resident prefill
# ---------------------------------------------------------------------------

def _chunk_attn_ring(bp, cfg: ModelConfig, x, positions, start: int,
                     cache: KC.RingKV, sink: int, local: int):
    """Chunk attention at a ring-cache layer: queries see the pre-insert
    ring (explicit per-slot positions) plus the chunk's own keys under
    the sink+local mask, then the chunk is ring-inserted. Attending
    before the insert keeps chunks longer than the ring exact."""
    B, C, _ = x.shape
    q, k_new, v_new, _ = A.gqa_qkv(bp["attn"], cfg, x, positions)
    kv_pos = torch.cat([cache.positions,
                        positions.to(torch.int32)[None].expand(B, C)], dim=1)
    k_all = torch.cat([cache.k, k_new], dim=2)
    v_all = torch.cat([cache.v, v_new], dim=2)
    valid = M.streaming_valid(positions, kv_pos, sink, local)  # (B,C,L)
    o = M.masked_attention(q, k_all, v_all, valid[:, None])
    cache = KC.ring_insert_chunk(cache, k_new, v_new, start, sink, local)
    return A.gqa_out(bp["attn"], cfg, o), cache


def _chunk_attn_full(bp, cfg: ModelConfig, x, positions, start: int,
                     cache: KC.FullKV):
    """Chunk attention at a full-cache layer: insert the chunk at
    [start, start+C), then causal attention over the cache buffer on the
    block-sparse kernel (key blocks past the live prefix are skipped)."""
    q, k_new, v_new, _ = A.gqa_qkv(bp["attn"], cfg, x, positions)
    cache = KC.full_insert_chunk(cache, k_new, v_new, start)
    o = M.chunk_causal_attention(q, cache.k, cache.v, start)
    return A.gqa_out(bp["attn"], cfg, o), cache


def prefill_chunk(params, cfg: ModelConfig, tokens: torch.Tensor,
                  caches: List, start: int):
    """Stream one chunk (B, C) at absolute offset ``start`` into the
    decode-geometry caches (routing already frozen on the first chunk).
    Updates ``caches`` in place. Returns (last-token logits (B, V),
    caches)."""
    B, C = tokens.shape
    flux = cfg.flux
    h = embed_tokens(params, cfg, tokens)
    positions = start + torch.arange(C, device=h.device)
    for i, bp in enumerate(params["layers"]):
        cache = caches[i]
        x = rms_norm(bp["norm1"], h, cfg.norm_eps)
        if isinstance(cache, KC.RingKV):
            ring = cache.k.shape[2]
            y, cache = _chunk_attn_ring(bp, cfg, x, positions, start, cache,
                                        flux.sink, ring - flux.sink)
        else:
            y, cache = _chunk_attn_full(bp, cfg, x, positions, start, cache)
        h = h + y
        x2 = rms_norm(bp["norm2"], h, cfg.norm_eps)
        h = h + ffn_apply(bp["ffn"], x2)
        caches[i] = cache
    return logits_from_hidden(params, cfg, h[:, -1]), caches
