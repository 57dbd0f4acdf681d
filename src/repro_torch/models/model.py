"""Model assembly: init, the training forward, prefill and decode (port of
``repro/models/model.py``).

Parameters are a plain dictionary of tensors. The JAX package stacks its
trunk by period position for ``lax.scan``; the port keeps one dictionary
per layer in ``params["layers"]`` and walks them in a Python loop
(``repro_torch.bridge.params_from_jax`` un-stacks a JAX pytree into this
layout).

Flux routing contexts (as in the JAX package):
  ("soft", tau, gumbel)   — training: the Gumbel-Softmax blend
                            r·FA + (1 - r)·SA of every routed layer
                            (Eq. 4-5), ``gumbel`` the layer's (B, 2)
                            sample (``forward_train``);
  ("hard", [thr])         — router decision per layer over prefix+suffix
                            pooling, batch consensus mean(p_fa) > thr;
  ("hard_prefix", [thr])  — the same with prefix-only pooling (the
                            chunk-invariant serving variant);
  ("fixed", decision)     — externally forced decision (1 = FA, 0 = SA);
  ("head_split", n_fa_kv) — the DuoAttention / PruLong baseline: the
                            first n_fa_kv KV heads of every routed layer
                            run FA, the rest the SA mode;
  ("fa_only",)            — backbone as-is.
``prefill`` takes every context but the soft one, which is
``forward_train``'s.

A layer's SA mode is ``flux.sa_mode``: ``ssa`` (the streaming kernel),
``xa`` (XAttention's top-k blocks on the block-sparse kernel) or ``ta``
(TriangleMix: streaming, then flash over the last ``flux.chunk`` rows).
Decode dispatches on the cache type; a duo layer (``duo_layers``) keeps a
full cache and masks its streaming heads per KV head in plain torch, as
the JAX package computes it in XLA.

A layer's attention is GQA or, for an MLA model (``cfg.use_mla``),
Multi-head Latent Attention: the route chunk decompresses the latent
into per-head K / V and runs the prefill kernels at (Dk, Dv) = (nope +
rope, v); the caches hold the latent (``LatentKV`` / ``RingLatentKV``);
decode runs the absorbed attention on the latent decode kernel, and a
streamed chunk at a full-cache layer the absorbed attention in plain
torch, as the JAX package runs it in XLA.

A layer is global attention, a sliding-window ("local") layer or a
Mamba2 SSD block (``models/ssm.py``), as ``cfg.layer_kinds`` says. A
local layer is never routed: its prefill runs ``window_mode`` (the
streaming kernel with no sink), and its cache is a ring of
min(sliding_window, max_len) slots with no sink, which a streamed chunk
and a decode step read with sink 0 and a window of the ring's size (the
sink is chosen by the layer's kind, not by the cache's type). A Mamba
layer is never routed; its cache is a ``MambaCache`` (the SSD state and
the conv tail), which a prefill returns as (h, conv_tail), a streamed
chunk carries through ``mamba_apply`` and a decode step advances in
place.

A layer's FFN is a dense SwiGLU or, where ``cfg.moe_layer_mask()`` says
so, the Mixture-of-Experts of ``models/moe.py``, called with the length
of the call it is in (the route chunk, a streamed chunk, the monolithic
prompt, one decode token), as the JAX package's prefill and decode
functions call it: its capacity depends on that length.

Modality side inputs, as in the JAX package: a VLM (phi-3-vision)
takes ``prefix_embeddings`` (B, P, d), concatenated before the token
embeddings, so positions, routing and the caches run over P + S; an
encoder-decoder (whisper) takes ``encoder_frames`` (B, E, d), which
``encode`` turns into ``enc_out`` (bidirectional self attention, no
RoPE, on the flash kernel with ``causal=False``), and every decoder
layer adds cross attention over ``enc_out`` after its self attention:
flash with ``causal=False`` over the S prompt rows at prefill, the batch
decode kernel with every one of the E keys visible at a decode step.

A FA layer's cache may be one rank's shard of a sequence-sharded cache
(``KC.SeqShardKV``, ``distributed/decode.py``): a decode step attends
it with the decode kernel's partial state and merges the ranks' states
(``lse_combine_decode``); a prefill chunk inserts into the shards and
runs the block-sparse kernel over the gathered live prefix.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import modes as M
from repro_torch.core import router as R
from repro_torch.distributed import decode as DD
from repro_torch.distributed.sharding import (kv_head_range, tp_reduce,
                                              tp_world)
from repro_torch.kernels.decode_attention import decode_attention_bh
from repro_torch.kernels.decode_attention_mla import decode_attention_mla_bh
from repro_torch.kernels.decode_attention_pooled import \
    decode_attention_pooled_bh
from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import (dense_init, embed_init, ffn_apply,
                                       ffn_init, rms_norm, rms_norm_init)
from repro_torch.serve import kv_cache as KC

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Structure helpers
# ---------------------------------------------------------------------------

def check_supported(cfg: ModelConfig) -> None:
    """The layer kinds the port runs: GQA or MLA global attention,
    sliding-window local attention and Mamba2 SSD blocks, with a dense
    SwiGLU, an MoE FFN or none, with or without an encoder and prefix
    embeddings."""
    kinds = set(cfg.layer_kinds) - {"attn", "local", "mamba"}
    if kinds:
        raise ValueError(
            f"{cfg.name}: unknown layer kinds {sorted(kinds)}; the port "
            f"serves 'attn', 'local' and 'mamba' layers")


def has_ffn(cfg: ModelConfig, layer_idx: int) -> bool:
    return cfg.d_ff > 0 or cfg.moe_layer_mask()[layer_idx]


def is_routed(cfg: ModelConfig, layer_idx: int) -> bool:
    return cfg.flux.enabled and cfg.layer_kinds[layer_idx] == "attn"


def ring_sink(cfg: ModelConfig, layer_idx: int) -> int:
    """The sink of a ring cache at ``layer_idx``, by the layer's kind: 0
    for a local layer's window ring, ``flux.sink`` for a routed SA
    layer's."""
    return 0 if cfg.layer_kinds[layer_idx] == "local" else cfg.flux.sink


def router_in_dim(cfg: ModelConfig) -> int:
    """Width of the Layer Router's input x_Q: the query projection, which
    for MLA is H·(nope + rope), not ``cfg.q_dim``."""
    if cfg.use_mla:
        return cfg.num_heads * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    return cfg.q_dim


def sa_mode(cfg: ModelConfig) -> M.AttnMode:
    return M.sa_mode_for(cfg.flux)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _block_init(gen: torch.Generator, cfg: ModelConfig,
                layer_idx: int) -> Params:
    dt, dev = cfg.param_dtype, gen.device
    p: Params = {"norm1": rms_norm_init(cfg.d_model, dt, dev)}
    if cfg.layer_kinds[layer_idx] == "mamba":
        p["mamba"] = SSM.mamba_init(gen, cfg)
    else:
        p["attn"] = (A.mla_init(gen, cfg) if cfg.use_mla
                     else A.gqa_init(gen, cfg))
        if is_routed(cfg, layer_idx):
            p["router"] = R.router_init(gen, router_in_dim(cfg), cfg.flux)
        if cfg.num_encoder_layers:  # whisper's decoder: cross attention
            p["norm_x"] = rms_norm_init(cfg.d_model, dt, dev)
            p["xattn"] = _xattn_init(gen, cfg)
    if has_ffn(cfg, layer_idx):
        p["norm2"] = rms_norm_init(cfg.d_model, dt, dev)
        if cfg.moe_layer_mask()[layer_idx]:
            p["moe"] = MOE.moe_init(gen, cfg)
        else:
            p["ffn"] = ffn_init(gen, cfg.d_model, cfg.d_ff, dt)
    return p


def _xattn_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """wq / wk / wv / wo of an attention without RoPE over all heads (an
    encoder layer's self attention and a decoder layer's cross
    attention)."""
    d, dt = cfg.d_model, cfg.param_dtype
    return {"wq": dense_init(gen, d, cfg.q_dim, dt),
            "wk": dense_init(gen, d, cfg.q_dim, dt),
            "wv": dense_init(gen, d, cfg.q_dim, dt),
            "wo": dense_init(gen, cfg.q_dim, d, dt)}


def _enc_block_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dt, dev = cfg.param_dtype, gen.device
    return {"norm1": rms_norm_init(cfg.d_model, dt, dev),
            "attn": _xattn_init(gen, cfg),
            "norm2": rms_norm_init(cfg.d_model, dt, dev),
            "ffn": ffn_init(gen, cfg.d_model, cfg.d_ff, dt)}


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device=None, *, block_map=None) -> Params:
    """Random weights at the JAX package's init scales, drawn from
    ``gen`` on the generator's device and placed on ``device`` (default
    cuda). The same generator seed gives the same weights. ``block_map``
    maps each decoder and encoder layer's dictionary as soon as it is
    drawn, before the next one is (a tensor-parallel rank keeps its
    share only: ``distributed.sharding.init_params_tp``)."""
    device = resolve_device(device)
    check_supported(cfg)
    keep = block_map or (lambda bp: bp)
    params: Params = {
        "layers": [params_to(keep(_block_init(gen, cfg, i)), device)
                   for i in range(cfg.num_layers)],
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model,
                            cfg.param_dtype),
        "final_norm": rms_norm_init(cfg.d_model, cfg.param_dtype,
                                    gen.device),
    }
    if not cfg.tie_embeddings:
        params["out_w"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                     cfg.param_dtype)
    if cfg.num_encoder_layers:
        params["encoder"] = {
            "layers": [keep(_enc_block_init(gen, cfg))
                       for _ in range(cfg.num_encoder_layers)],
            "final_norm": rms_norm_init(cfg.d_model, cfg.param_dtype,
                                        gen.device),
        }
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

def _heads(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B, S, H·hd) → (B, H, S, hd), contiguous (the kernels' operands)."""
    B, S, _ = x.shape
    return x.reshape(B, S, cfg.num_heads, cfg.head_dim).transpose(
        1, 2).contiguous()


def _merge_heads(o: torch.Tensor) -> torch.Tensor:
    """(B, H, S, hd) → (B, S, H·hd)."""
    B, H, S, hd = o.shape
    return o.transpose(1, 2).reshape(B, S, H * hd)


def _cross_kv(p, cfg: ModelConfig, enc_out: torch.Tensor):
    """A decoder layer's cross-attention keys and values over ``enc_out``
    (B, E, d): (B, H, E, hd) each, no RoPE."""
    return (_heads(enc_out @ p["wk"], cfg), _heads(enc_out @ p["wv"], cfg))


def _cross_attention(p, cfg: ModelConfig, h: torch.Tensor,
                     enc_out: torch.Tensor,
                     enc_positions: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Whisper's decoder cross attention: queries from ``h`` (B, S, d),
    keys and values from ``enc_out`` (B, E, d), every key visible, no
    RoPE. Returns (B, S, d). Over S rows it runs the flash kernel with
    ``causal=False``; at one token a row, given ``enc_positions`` =
    arange(E) int32, the batch decode kernel with cur_pos = E - 1, so
    every key is visible (the softmax of ``M.attention(..,
    BIDIRECTIONAL)`` at Sq = 1; a flash call would fill 1 row of a 64-row
    tile). The keys and values are recomputed from ``enc_out`` at every
    call, as the JAX package recomputes them. Under tensor parallelism a
    rank attends with its heads and the ``wo`` partials sum over the
    ranks here (a reduce point, ``distributed/sharding.py``)."""
    k, v = _cross_kv(p, cfg, enc_out)
    q = _heads(h @ p["wq"], cfg)
    if enc_positions is None:
        o = M.attention(q, k, v, M.BIDIRECTIONAL)
    else:
        o = _dot_decode(q, k, v, enc_positions, enc_out.shape[1] - 1)
    return tp_reduce(_merge_heads(o) @ p["wo"])


def _cross_residual(bp, cfg: ModelConfig, h: torch.Tensor, enc_out,
                    enc_positions=None) -> torch.Tensor:
    """h + cross attention over ``enc_out`` of norm_x(h) at a decoder
    layer that has it and when ``enc_out`` is given, else h; one token a
    row on the decode kernel with ``enc_positions``."""
    if "xattn" not in bp or enc_out is None:
        return h
    hx = rms_norm(bp["norm_x"], h, cfg.norm_eps)
    return h + _cross_attention(bp["xattn"], cfg, hx, enc_out,
                                enc_positions)


def _route_and_attend(bp, cfg: ModelConfig, q, k, v, x_q, ctx,
                      q_offset: int = 0):
    """Run FA, SA, their soft blend or a head split per the routing
    context. Returns (attn_out, r) with r the (B,) float32 r_soft of the
    soft context, (decision 0/1, p_fa mean) for the hard and fixed
    contexts, None for the others."""
    kind = ctx[0]
    if kind == "soft":
        _, tau, gumbel = ctx
        r = R.soft_route(bp["router"], x_q, cfg.flux, tau, gumbel)  # (B,)
        o_fa = M.attention(q, k, v, M.FULL, q_offset=q_offset)
        o_sa = M.attention(q, k, v, sa_mode(cfg), q_offset=q_offset)
        rb = r[:, None, None, None].to(o_fa.dtype)  # JAX's rounding point
        return rb * o_fa + (1 - rb) * o_sa, r
    if kind == "fa_only":
        return M.attention(q, k, v, M.FULL, q_offset=q_offset), None
    if kind == "head_split":  # ctx[1] counts the whole model's KV heads
        return M.head_split_attention(q, k, v, ctx[1], sa_mode(cfg),
                                      q_offset=q_offset,
                                      kv_first=kv_head_range(cfg)[0]), None
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
        raise ValueError(f"unknown routing context {kind!r}")
    mode = M.FULL if decision > 0 else sa_mode(cfg)
    return M.attention(q, k, v, mode, q_offset=q_offset), (decision, p_mean)


def ffn_block(bp, cfg: ModelConfig, layer_idx: int, h: torch.Tensor,
              capacity_len: Optional[int] = None,
              aux: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """The residual FFN of a layer: h + FFN(norm2(h)), dense or MoE
    (``capacity_len``: see ``moe.moe_apply``); h itself at a layer with
    no FFN. Given ``aux``, an MoE layer writes its ``balance_loss`` and
    ``drop_fraction`` there as ``moe_balance`` / ``moe_drop`` (training;
    serving skips the diagnostics)."""
    if not has_ffn(cfg, layer_idx):
        return h
    x2 = rms_norm(bp["norm2"], h, cfg.norm_eps)
    if "moe" in bp:
        y2, d = MOE.moe_ffn(bp["moe"], cfg, x2, capacity_len=capacity_len)
        if aux is not None:
            diag = MOE.moe_aux(cfg, d)
            aux["moe_balance"] = diag["balance_loss"]
            aux["moe_drop"] = diag["drop_fraction"]
    else:
        y2 = ffn_apply(bp["ffn"], x2)
    return h + y2


def block_apply(bp, cfg: ModelConfig, layer_idx: int, h: torch.Tensor,
                positions: torch.Tensor, ctx, want_cache: bool = False,
                capacity_len: Optional[int] = None, enc_out=None,
                aux: Optional[Dict[str, torch.Tensor]] = None):
    """One transformer block over a full sequence. Returns (h, r, cache):
    r is the routing record of a routed layer else None; cache is the
    layer's (k, v), an MLA layer's latent (ckv, kr) or a Mamba layer's
    (SSD state, conv tail), when ``want_cache``. ``capacity_len`` sets an
    MoE layer's capacity from another length than the sequence's (the
    fidelity probe's bucket).
    ``enc_out`` (B, E, d): the encoder's output, which a decoder layer
    with cross attention attends after its self attention. ``aux``: see
    ``ffn_block``."""
    x = rms_norm(bp["norm1"], h, cfg.norm_eps)
    if "mamba" in bp:
        y, state = SSM.mamba_apply(bp["mamba"], cfg, x)
        return (ffn_block(bp, cfg, layer_idx, h + y, capacity_len, aux),
                None, state if want_cache else None)
    if cfg.use_mla:
        ckv, kr = A.mla_latent(bp["attn"], cfg, x, positions)
        q, x_q = A.mla_q(bp["attn"], cfg, x, positions)
        k, v = A.mla_expand_kv(bp["attn"], cfg, ckv, kr)
        cache = (ckv, kr) if want_cache else None
    else:
        q, k, v, x_q = A.gqa_qkv(bp["attn"], cfg, x, positions)
        cache = (k, v) if want_cache else None
    r = None
    if cfg.layer_kinds[layer_idx] == "local":  # never routed
        o = M.attention(q, k, v, M.window_mode(cfg.sliding_window))
    elif is_routed(cfg, layer_idx) and ctx[0] != "fa_only":
        o, r = _route_and_attend(bp, cfg, q, k, v, x_q, ctx)
    else:
        o = M.attention(q, k, v, M.FULL)
    h = h + (A.mla_out if cfg.use_mla else A.gqa_out)(bp["attn"], cfg, o)
    h = _cross_residual(bp, cfg, h, enc_out)
    return ffn_block(bp, cfg, layer_idx, h, capacity_len, aux), r, cache


# ---------------------------------------------------------------------------
# Encoder (whisper backbone)
# ---------------------------------------------------------------------------

def encode(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """The bidirectional encoder over precomputed frame embeddings (B, E,
    d), cast to ``cfg.dtype``: per layer RMSNorm, q / k / v without RoPE,
    attention over every frame (the flash kernel with ``causal=False``),
    the output projection, RMSNorm and SwiGLU; then the encoder's final
    norm. Returns enc_out (B, E, d). Under tensor parallelism a rank
    encodes with its heads and its slice of the FFN width, and each
    layer reduces after ``wo`` and after its FFN, so every rank holds the
    whole enc_out."""
    enc = params["encoder"]
    h = frames.to(cfg.dtype)
    for bp in enc["layers"]:
        x = rms_norm(bp["norm1"], h, cfg.norm_eps)
        p = bp["attn"]
        o = M.attention(_heads(x @ p["wq"], cfg), _heads(x @ p["wk"], cfg),
                        _heads(x @ p["wv"], cfg), M.BIDIRECTIONAL)
        h = h + tp_reduce(_merge_heads(o) @ p["wo"])
        x2 = rms_norm(bp["norm2"], h, cfg.norm_eps)
        h = h + ffn_apply(bp["ffn"], x2)
    return rms_norm(enc["final_norm"], h, cfg.norm_eps)


def encode_side_input(params, cfg: ModelConfig, encoder_frames):
    """enc_out for a model with an encoder (``encode``; ValueError when
    ``encoder_frames`` is None), None for one without."""
    if not cfg.num_encoder_layers:
        return None
    if encoder_frames is None:
        raise ValueError(
            f"{cfg.name} has an encoder ({cfg.num_encoder_layers} layers): "
            f"pass its frame embeddings as encoder_frames (B, "
            f"{cfg.encoder_ctx}, {cfg.d_model})")
    return encode(params, cfg, encoder_frames)


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------

def embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor,
                 prefix_embeddings: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Token embeddings (B, S, d) in ``cfg.dtype``, after the modality
    prefix (B, P, d) when one is given: (B, P + S, d)."""
    h = F.embedding(tokens, params["embed"]).to(cfg.dtype)
    if prefix_embeddings is not None:
        h = torch.cat([prefix_embeddings.to(cfg.dtype), h], dim=1)
    return h


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
    logits: torch.Tensor                 # (B, V) prefill-last / (B, S, V)
                                         # or (B, S, d) hidden, training
    routing: Optional[torch.Tensor]      # (n_routed,) int32 decisions
    p_fa: Optional[torch.Tensor]         # (n_routed,) f32 mean FA prob
    # per layer (k, v), an MLA layer's (ckv, kr), a Mamba layer's (h, tail)
    caches: Optional[List] = None
    r_soft: Optional[torch.Tensor] = None  # (B, n_routed) FA probs, train
    # training diagnostics by period: moe_balance / moe_drop (n_periods,)
    aux: Dict[str, torch.Tensor] = field(default_factory=dict)


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            routing_ctx: str = "hard",
            fixed_pattern: Optional[Sequence[int]] = None,
            head_split_n: int = 0,
            prefix_embeddings: Optional[torch.Tensor] = None,
            encoder_frames: Optional[torch.Tensor] = None,
            want_cache: bool = True,
            fa_threshold: Optional[float] = None,
            enc_out: Optional[torch.Tensor] = None) -> ForwardOut:
    """Serving prefill over the whole of ``tokens`` (B, S): hard routing
    (or a fixed pattern), full per-layer KV out.

    ``fixed_pattern``: (num_layers,) ints (1 = FA, 0 = SA) for
    ``routing_ctx="fixed"``. ``routing_ctx="head_split"`` runs the
    DuoAttention-style baseline with ``head_split_n`` full-attention KV
    heads per routed layer (no routing record). ``fa_threshold``: the
    FA-decision threshold of the hard contexts (None = the paper's 0.5
    argmax). ``prefix_embeddings`` (B, P, d) run before the tokens, so
    routing, positions and the caches cover P + S; a model with an
    encoder needs ``encoder_frames`` (B, E, d), which ``encode`` runs
    first, or their ``enc_out`` already encoded (the engine encodes once
    for the prefill and the decode)."""
    if routing_ctx not in ("hard", "hard_prefix", "fixed", "fa_only",
                           "head_split"):
        raise NotImplementedError(
            f"routing_ctx={routing_ctx!r}: prefill routes hard, by a fixed "
            f"pattern, by head split or not at all; the soft context is "
            f"training's, forward_train")
    if enc_out is None:
        enc_out = encode_side_input(params, cfg, encoder_frames)
    h = embed_tokens(params, cfg, tokens, prefix_embeddings)
    positions = torch.arange(h.shape[1], device=h.device)
    rs, caches = [], []
    for i, bp in enumerate(params["layers"]):
        if routing_ctx == "head_split":
            ctx = ("head_split", int(head_split_n))
        elif not cfg.flux.enabled or routing_ctx == "fa_only":
            ctx = ("fa_only",)
        elif routing_ctx == "fixed":
            ctx = ("fixed", int(fixed_pattern[i]))
        else:
            ctx = ((routing_ctx,) if fa_threshold is None
                   else (routing_ctx, float(fa_threshold)))
        h, r, cache = block_apply(bp, cfg, i, h, positions, ctx,
                                  want_cache=want_cache, enc_out=enc_out)
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
# Training forward (Gumbel soft routing)
# ---------------------------------------------------------------------------

def router_param_filter(params) -> Any:
    """A tree of ``params``' shape with True on the Layer-Router leaves
    (every leaf under a ``"router"`` key), False elsewhere: the only
    trainable part of the paper's parameter-efficient recipe."""
    def mark(tree, inside: bool):
        if isinstance(tree, dict):
            return {k: mark(v, inside or k == "router")
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(mark(v, inside) for v in tree)
        return inside
    return mark(params, False)


def soft_layers(cfg: ModelConfig) -> List[int]:
    """The layers ``forward_train`` routes softly, in layer order: every
    global attention layer ("attn") when flux is enabled."""
    if not cfg.flux.enabled:
        return []
    return [i for i, k in enumerate(cfg.layer_kinds) if k == "attn"]


def _train_layer(bp, cfg: ModelConfig, i: int, h: torch.Tensor,
                 positions: torch.Tensor, ctx, enc_out):
    aux: Dict[str, torch.Tensor] = {}
    h, r, _ = block_apply(bp, cfg, i, h, positions, ctx, enc_out=enc_out,
                          aux=aux)
    return h, r, aux


def forward_train(params, cfg: ModelConfig, tokens: torch.Tensor, *,
                  gumbel: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  tau=1.0, prefix_embeddings: Optional[torch.Tensor] = None,
                  encoder_frames: Optional[torch.Tensor] = None,
                  remat: bool = True, flux_soft: bool = True,
                  output_hidden: bool = False) -> ForwardOut:
    """Training forward with Gumbel-Softmax soft routing (Eq. 4-5) over
    ``tokens`` (B, S), after ``prefix_embeddings`` (B, P, d) when given;
    a model with an encoder takes ``encoder_frames`` (B, E, d).

    Each routed layer (``soft_layers``) blends FA and SA by its r_soft
    at temperature ``tau``. Its Gumbel sample is ``gumbel[j]`` of
    ``gumbel`` (n_routed, B, 2) float32, or drawn from ``generator`` for
    all routed layers at once before the trunk (``router.gumbel_noise``),
    so a recomputed layer sees the same noise; with neither, or with
    ``flux_soft`` False or flux disabled, every layer runs FA. ``remat``
    recomputes each layer in the backward pass
    (``torch.utils.checkpoint``, non-reentrant), as the JAX package
    checkpoints each period. ``output_hidden`` returns the final-normed
    hidden states (B, S, d) in ``.logits`` instead of the vocabulary
    logits (B, S, V), for ``chunked_cross_entropy``. Returns a
    ``ForwardOut`` with ``r_soft`` (B, n_routed) in layer order (None
    when nothing routed softly) and ``aux`` the MoE layers'
    ``moe_balance`` / ``moe_drop`` summed over each period, (n_periods,)
    as the JAX scan stacks them."""
    B, Stok = tokens.shape
    enc_out = encode_side_input(params, cfg, encoder_frames)
    h = embed_tokens(params, cfg, tokens, prefix_embeddings)
    positions = torch.arange(h.shape[1], device=h.device)
    routed = soft_layers(cfg)
    use_soft = flux_soft and bool(routed) and (gumbel is not None
                                               or generator is not None)
    if use_soft and gumbel is None:
        gumbel = R.gumbel_noise((len(routed), B, 2), generator)
    if use_soft and tuple(gumbel.shape) != (len(routed), B, 2):
        raise ValueError(f"gumbel must be ({len(routed)}, {B}, 2): one "
                         f"(B, 2) sample per routed layer; got "
                         f"{tuple(gumbel.shape)}")
    slot = {i: j for j, i in enumerate(routed)}
    P = len(cfg.layer_pattern)
    rs, auxes = [], {}
    for i, bp in enumerate(params["layers"]):
        ctx = (("soft", tau, gumbel[slot[i]]) if use_soft and i in slot
               else ("fa_only",))
        args = (bp, cfg, i, h, positions, ctx, enc_out)
        if remat:
            h, r, aux = torch.utils.checkpoint.checkpoint(
                _train_layer, *args, use_reentrant=False,
                preserve_rng_state=False)
        else:
            h, r, aux = _train_layer(*args)
        if r is not None:
            rs.append(r)
        for k_, v_ in aux.items():  # summed within a period, by position
            per = auxes.setdefault(k_, [None] * (cfg.num_layers // P))
            j = i // P
            per[j] = v_ if per[j] is None else per[j] + v_
    prefix = h.shape[1] - Stok
    h = h[:, prefix:] if prefix else h
    if output_hidden:
        logits = rms_norm(params["final_norm"], h, cfg.norm_eps)
    else:
        logits = logits_from_hidden(params, cfg, h)
    return ForwardOut(logits=logits, routing=None, p_fa=None,
                      r_soft=torch.stack(rs, dim=1) if rs else None,
                      aux={k_: torch.stack(v_) for k_, v_ in auxes.items()})


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


def _mla_decode(bp, cfg, x, rope_pos, cache, positions, lengths):
    """The absorbed MLA decode step over a latent cache on the latent
    decode kernel, for an int ``pos`` (every row's ``lengths`` pos + 1)
    and a per-row one alike: the latent query against [ckv ‖ kr], the
    latent context through W_uv and the output projection. positions
    (B, L) int32 or None as ``decode_attention_mla_bh`` takes them."""
    q = A.mla_absorbed_q(bp["attn"], cfg, x, rope_pos)  # (B,H,1,R+rope)
    B, H = q.shape[:2]
    ctx = decode_attention_mla_bh(q.reshape(B * H, 1, q.shape[-1]),
                                  cache.ckv, cache.kr[:, 0], positions,
                                  lengths, n_heads=H, scale=A.mla_scale(cfg))
    return A.mla_absorbed_finish(bp["attn"], cfg, ctx.reshape(B, H, 1, -1))


def _decode_attn_full(bp, cfg, x, pos, rope_pos, cache, slot_positions):
    if isinstance(cache, KC.LatentKV):
        # slots [0, length) are live and slot j holds position j
        ckv, kr = A.mla_latent(bp["attn"], cfg, x, rope_pos)
        cache = KC.latent_insert(cache, ckv, kr, pos)
        return (_mla_decode(bp, cfg, x, rope_pos, cache, None,
                            cache.length), cache)
    q, k, v, _ = A.gqa_qkv(bp["attn"], cfg, x, rope_pos)
    if isinstance(cache, KC.SeqShardKV):  # this rank's shard of the cache
        cache = DD.sharded_seq_insert(cache, k, v, pos)
        return (A.gqa_out(bp["attn"], cfg,
                          DD.lse_combine_decode(q, cache, pos)), cache)
    cache = KC.full_insert(cache, k, v, pos)
    if isinstance(pos, torch.Tensor):
        # per row: slots [0, length) are live and slot j holds position j
        o = _dot_decode_pooled(q, cache.k, cache.v, None, cache.length)
    else:
        o = _dot_decode(q, cache.k, cache.v, slot_positions, pos)
    return A.gqa_out(bp["attn"], cfg, o), cache


def _decode_attn_ring(bp, cfg, x, pos, rope_pos, cache, sink: int,
                      local: int):
    if isinstance(cache, KC.RingLatentKV):
        # the pooled path's ring masks below, for an int pos too
        ckv, kr = A.mla_latent(bp["attn"], cfg, x, rope_pos)
        cache = KC.ring_latent_insert(cache, ckv, kr, pos, sink, local)
        pos_col = pos[:, None] if isinstance(pos, torch.Tensor) else pos
        vis = (cache.positions >= 0) & (cache.positions <= pos_col)
        return (_mla_decode(bp, cfg, x, rope_pos, cache,
                            torch.where(vis, cache.positions, -1),
                            torch.clamp(cache.length,
                                        max=KC.capacity(cache))), cache)
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


def _decode_attn_headsplit(bp, cfg, x, pos, rope_pos, cache, n_fa_kv: int):
    """DuoAttention-style decode over a full-shape cache (ragged per-head
    histories are unrepresentable: the paper's §2.3 point). The first
    ``n_fa_kv`` KV heads of the whole model see every slot <= pos, the
    rest sink + local (a tensor-parallel rank's heads start at its first
    global KV head, ``kv_head_range``); a per-KV-head validity mask in
    plain torch, as the JAX package computes it in XLA, outside the
    decode kernels."""
    q, k, v, _ = A.gqa_qkv(bp["attn"], cfg, x, rope_pos)
    cache = KC.full_insert(cache, k, v, pos)
    L = cache.k.shape[2]
    idx = torch.arange(L, device=x.device)
    first, _ = kv_head_range(cfg)
    head_is_full = (torch.arange(cfg.num_kv_heads, device=x.device)
                    + first) < n_fa_kv
    sink, local = cfg.flux.sink, cfg.flux.local
    if isinstance(pos, torch.Tensor):  # per row → (B, Hkv, L)
        full_valid = idx[None, :] <= pos[:, None]
        stream_valid = full_valid & ((idx[None, :] < sink)
                                     | (pos[:, None] - idx[None, :] < local))
        valid = torch.where(head_is_full[None, :, None],
                            full_valid[:, None], stream_valid[:, None])
    else:  # one position → (1, Hkv, L)
        full_valid = idx <= pos
        stream_valid = full_valid & ((idx < sink) | (pos - idx < local))
        valid = torch.where(head_is_full[:, None], full_valid[None],
                            stream_valid[None])[None]
    o = M.masked_attention(q, cache.k, cache.v, valid[:, :, None])
    return A.gqa_out(bp["attn"], cfg, o), cache


def decode_core(params, cfg: ModelConfig, token: torch.Tensor,
                caches: List, pos, fa_heads: Optional[Sequence[int]] = None,
                duo_layers: Optional[Tuple[int, ...]] = None,
                enc_out: Optional[torch.Tensor] = None,
                enc_positions: Optional[torch.Tensor] = None):
    """One autoregressive step at position ``pos``: an int shared by all
    rows, or a (B,) int32 device tensor, one per row. token (B,1).
    ``duo_layers`` marks full-cache GQA layers that run a DuoAttention
    head split, ``fa_heads`` (num_layers,) their full-attention KV-head
    counts (``routing_head_split``). ``enc_out`` (B, E, d): the encoder's
    output, which every decoder layer with cross attention attends after
    its self attention, on the batch decode kernel over
    ``enc_positions`` (arange(E) int32 on enc_out's device; made here
    when None, ``decode_many`` makes it once). Updates ``caches`` in
    place. Returns (logits (B,V), caches)."""
    if enc_out is not None and enc_positions is None:
        enc_positions = _enc_positions(enc_out)
    h = embed_tokens(params, cfg, token)
    pooled = isinstance(pos, torch.Tensor)
    rope_pos = (pos[:, None] if pooled
                else torch.full((1,), pos, device=h.device))
    slot_positions: Dict[int, torch.Tensor] = {}  # FullKV capacity → arange
    for i, bp in enumerate(params["layers"]):
        cache = caches[i]
        x = rms_norm(bp["norm1"], h, cfg.norm_eps)
        if isinstance(cache, KC.MambaCache):
            y, hs, tail = SSM.mamba_decode_step(bp["mamba"], cfg, x,
                                                cache.h, cache.conv_tail)
            KC.mamba_update(cache, hs, tail)
            h = ffn_block(bp, cfg, i, h + y)
            continue
        L = KC.capacity(cache)
        if KC.is_ring(cache):
            sink = ring_sink(cfg, i)
            y, cache = _decode_attn_ring(bp, cfg, x, pos, rope_pos, cache,
                                         sink, L - sink)
        elif (duo_layers is not None and i in duo_layers
              and fa_heads is not None and not cfg.use_mla):
            y, cache = _decode_attn_headsplit(bp, cfg, x, pos, rope_pos,
                                              cache, int(fa_heads[i]))
        else:
            if isinstance(cache, KC.FullKV) and not pooled \
                    and L not in slot_positions:
                slot_positions[L] = torch.arange(L, dtype=torch.int32,
                                                 device=h.device)
            y, cache = _decode_attn_full(bp, cfg, x, pos, rope_pos, cache,
                                         slot_positions.get(L))
        h = _cross_residual(bp, cfg, h + y, enc_out, enc_positions)
        h = ffn_block(bp, cfg, i, h)
        caches[i] = cache
    return logits_from_hidden(params, cfg, h[:, -1]), caches


def _enc_positions(enc_out: torch.Tensor) -> torch.Tensor:
    """The cross-attention keys' positions, arange(E) int32: with cur_pos
    E - 1 the decode kernel sees every encoder frame."""
    return torch.arange(enc_out.shape[1], dtype=torch.int32,
                        device=enc_out.device)


def routing_head_split(cfg: ModelConfig, routing):
    """A routing pattern ("fa" | "sa" | ("duo", n) | None per layer) as
    (fa_heads, duo_layers): the per-layer full-attention KV-head counts
    (a tuple of ints) and the tuple of duo layer indices, or (None,
    None) when no entry is a head split. The counts are the whole
    model's: ``cfg`` is the whole config (the engine's ``cfg``, not a
    rank's ``model_cfg``), and a rank's decode offsets them by its first
    global KV head. Raises ValueError for an MLA model, whose heads
    share one latent."""
    duo = tuple(i for i, r in enumerate(routing)
                if isinstance(r, tuple) and r[0] == "duo")
    if not duo:
        return None, None
    if cfg.use_mla:
        raise ValueError(
            "duo head-split routing requires per-KV-head GQA caches; "
            "MLA shares one latent across heads (cfg.use_mla=True) so "
            f"a split is meaningless — got duo at layers {duo}")
    fa_heads = tuple(int(r[1]) if isinstance(r, tuple) and r[0] == "duo"
                     else cfg.num_kv_heads for r in routing)
    return fa_heads, duo


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, caches: List,
                routing, pos, enc_out: Optional[torch.Tensor] = None):
    """One autoregressive step under a routing pattern cached from
    prefill. The fa/sa entries are informational (the caches' types
    carry them); only duo head splits change what runs. Returns
    (logits (B,V), caches)."""
    fa_heads, duo_layers = routing_head_split(cfg, routing)
    return decode_core(params, cfg, token, caches, pos, fa_heads=fa_heads,
                       duo_layers=duo_layers, enc_out=enc_out)


def sample_categorical(logits: torch.Tensor,
                       generator: torch.Generator) -> torch.Tensor:
    """One draw a row from softmax(logits) (B, V), by Gumbel-max over
    float32 uniforms from ``generator``, as ``jax.random.categorical``
    draws: argmax(logits - log(-log(u))). The generator must be on the
    logits' device (``torch.rand`` raises otherwise). Returns (B,)
    int64."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits.float() - torch.log(-torch.log(u)), dim=-1)


def decode_many(params, cfg: ModelConfig, logits: torch.Tensor,
                caches: List, pos, *, n_steps: int,
                greedy: bool = True,
                generator: Optional[torch.Generator] = None,
                fa_heads: Optional[Sequence[int]] = None,
                duo_layers: Optional[Tuple[int, ...]] = None,
                enc_out: Optional[torch.Tensor] = None):
    """Generation for ``n_steps``: token i is drawn from the logits
    before decode step i, their argmax when ``greedy``, else one
    categorical sample a row from ``generator`` (``sample_categorical``).
    ``pos`` is the absolute position of the first generated token: an
    int, or a (B,) int32 device tensor, one per row, advanced on the
    device (no step reads it back). ``fa_heads`` / ``duo_layers`` /
    ``enc_out`` as ``decode_core`` takes them (the cross-attention
    positions are made once, here). Returns (tokens (B, n_steps) int64,
    last logits (B, V), caches)."""
    if not greedy and generator is None:
        raise ValueError(
            "decode_many(greedy=False) needs a torch.Generator on the "
            "logits' device (generator=...)")
    enc_positions = None if enc_out is None else _enc_positions(enc_out)
    toks = []
    for step in range(n_steps):
        nxt = (torch.argmax(logits, dim=-1) if greedy
               else sample_categorical(logits, generator))
        toks.append(nxt)
        logits, caches = decode_core(params, cfg, nxt[:, None], caches,
                                     pos + step, fa_heads=fa_heads,
                                     duo_layers=duo_layers, enc_out=enc_out,
                                     enc_positions=enc_positions)
    out = (torch.stack(toks, dim=1) if toks
           else torch.zeros((logits.shape[0], 0), dtype=torch.int64,
                            device=logits.device))
    return out, logits, caches


# ---------------------------------------------------------------------------
# Chunked cache-resident prefill
# ---------------------------------------------------------------------------

def _chunk_attn_ring(bp, cfg: ModelConfig, x, positions, start: int,
                     cache, sink: int, local: int):
    """Chunk attention at a ring-cache layer: queries see the pre-insert
    ring (explicit per-slot positions) plus the chunk's own keys under
    the sink+local mask, then the chunk is ring-inserted. Attending
    before the insert keeps chunks longer than the ring exact. A latent
    ring is decompressed to per-head K / V first."""
    B, C, _ = x.shape
    latent = isinstance(cache, KC.RingLatentKV)
    if latent:
        ckv, kr = A.mla_latent(bp["attn"], cfg, x, positions)
        q, _ = A.mla_q(bp["attn"], cfg, x, positions)
        k_ctx, v_ctx = A.mla_expand_kv(bp["attn"], cfg, cache.ckv, cache.kr)
        k_new, v_new = A.mla_expand_kv(bp["attn"], cfg, ckv, kr)
    else:
        q, k_new, v_new, _ = A.gqa_qkv(bp["attn"], cfg, x, positions)
        k_ctx, v_ctx = cache.k, cache.v
    kv_pos = torch.cat([cache.positions,
                        positions.to(torch.int32)[None].expand(B, C)], dim=1)
    k_all = torch.cat([k_ctx, k_new], dim=2)
    v_all = torch.cat([v_ctx, v_new], dim=2)
    valid = M.streaming_valid(positions, kv_pos, sink, local)  # (B,C,L)
    o = M.masked_attention(q, k_all, v_all, valid[:, None])
    if latent:
        cache = KC.ring_latent_insert_chunk(cache, ckv, kr, start, sink,
                                            local)
        return A.mla_out(bp["attn"], cfg, o), cache
    cache = KC.ring_insert_chunk(cache, k_new, v_new, start, sink, local)
    return A.gqa_out(bp["attn"], cfg, o), cache


def _chunk_attn_full(bp, cfg: ModelConfig, x, positions, start: int,
                     cache):
    """Chunk attention at a full-cache layer: insert the chunk at
    [start, start+C), then causal attention over the cache buffer on the
    block-sparse kernel (key blocks past the live prefix are skipped).
    A latent cache runs the absorbed attention over its live prefix
    [0, start+C) in plain torch, as the JAX package runs it in XLA over
    the whole buffer (the masked slots past the prefix add exact
    zeros)."""
    if isinstance(cache, KC.LatentKV):
        B, C, _ = x.shape
        ckv, kr = A.mla_latent(bp["attn"], cfg, x, positions)
        cache = KC.latent_insert_chunk(cache, ckv, kr, start)
        live = start + C
        valid = (torch.arange(live, device=x.device)[None, None, :]
                 <= positions[None, :, None]).expand(B, C, live)
        y = A.mla_absorbed_attend(bp["attn"], cfg, x, positions,
                                  cache.ckv[:, :live], cache.kr[:, :, :live],
                                  valid)
        return y, cache
    q, k_new, v_new, _ = A.gqa_qkv(bp["attn"], cfg, x, positions)
    if isinstance(cache, KC.SeqShardKV):  # over the gathered live prefix
        cache = DD.sharded_seq_insert_chunk(cache, k_new, v_new, start)
        k, v = DD.gather_prefix(cache, start, k_new, v_new)
        o = M.chunk_causal_attention(q, k, v, start)
        return A.gqa_out(bp["attn"], cfg, o), cache
    cache = KC.full_insert_chunk(cache, k_new, v_new, start)
    o = M.chunk_causal_attention(q, cache.k, cache.v, start)
    return A.gqa_out(bp["attn"], cfg, o), cache


def prefill_chunk(params, cfg: ModelConfig, tokens: torch.Tensor,
                  caches: List, start: int,
                  enc_out: Optional[torch.Tensor] = None):
    """Stream one chunk (B, C) at absolute offset ``start`` into the
    decode-geometry caches (routing already frozen on the first chunk);
    with ``enc_out``, each decoder layer's cross attention over it.
    Updates ``caches`` in place. Returns (last-token logits (B, V),
    caches)."""
    B, C = tokens.shape
    h = embed_tokens(params, cfg, tokens)
    positions = start + torch.arange(C, device=h.device)
    for i, bp in enumerate(params["layers"]):
        cache = caches[i]
        x = rms_norm(bp["norm1"], h, cfg.norm_eps)
        if isinstance(cache, KC.MambaCache):
            y, (hs, tail) = SSM.mamba_apply(bp["mamba"], cfg, x,
                                            (cache.h, cache.conv_tail))
            KC.mamba_update(cache, hs, tail)
            h = ffn_block(bp, cfg, i, h + y)
            continue
        if KC.is_ring(cache):
            sink = ring_sink(cfg, i)
            y, cache = _chunk_attn_ring(bp, cfg, x, positions, start, cache,
                                        sink, KC.capacity(cache) - sink)
        else:
            y, cache = _chunk_attn_full(bp, cfg, x, positions, start, cache)
        h = ffn_block(bp, cfg, i, _cross_residual(bp, cfg, h + y, enc_out))
        caches[i] = cache
    return logits_from_hidden(params, cfg, h[:, -1]), caches


def capture_hidden(params, cfg: ModelConfig, tokens: torch.Tensor,
                   prefix_embeddings: Optional[torch.Tensor] = None,
                   encoder_frames: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Hidden states after every layer of an FA-only forward, (L, B,
    P + S, d), side inputs as ``prefill`` takes them: the input of the
    UnComp entropy ranking (``core/policies.py``)."""
    enc_out = encode_side_input(params, cfg, encoder_frames)
    h = embed_tokens(params, cfg, tokens, prefix_embeddings)
    positions = torch.arange(h.shape[1], device=h.device)
    snaps = []
    for i, bp in enumerate(params["layers"]):
        h, _, _ = block_apply(bp, cfg, i, h, positions, ("fa_only",),
                              enc_out=enc_out)
        snaps.append(h)
    return torch.stack(snaps)


def snapshot_state(caches: List, logits: torch.Tensor):
    """Bitwise copy of a chunk-boundary admission state: every buffer of
    every decode cache (``KC.cache_fields``) and the boundary's last-token
    logits, into fresh tensors on the same device. This is what the
    prefix cache (``serve/prefix_cache.py``) stores and restores. Every
    insert, chunk and decode step writes its caches in place, so a
    published snapshot must not alias the live admission's buffers, and
    a restored job must not alias the store's. ``clone`` rather than an
    arithmetic identity: ``x + 0`` would flip ``-0.0``."""
    return KC.map_buffers(caches, torch.Tensor.clone), logits.clone()


# ---------------------------------------------------------------------------
# Routing-fidelity probe
# ---------------------------------------------------------------------------

def attention_mass_coverage(params, cfg: ModelConfig, tokens: torch.Tensor,
                            capacity_len: Optional[int] = None, *,
                            prefix_embeddings: Optional[torch.Tensor] = None,
                            encoder_frames: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Per-routed-layer FA attention mass retained by the SA window: the
    serving stack's routing-fidelity probe.

    Runs an FA-only forward (every attention layer on the flash kernel
    on the card) and, at every routed layer, asks: of the full-attention
    softmax mass the last query spreads over the prompt, what fraction
    lands on keys the sink+local window keeps? 1.0 means routing the
    layer to SA loses nothing for the next decoded token. Under ``ta``
    the last query sits in the dense tail chunk, so coverage is exactly
    1, as in the JAX package. Scores are float32 whatever the model's
    dtype.

    The JAX package pads the prompt to a power-of-two bucket with a
    traced length to bound its jit cache; the port compiles nothing, so
    ``tokens`` (B, S) is the prompt itself. Causal attention makes the
    padding invisible to the real tokens, but an MoE layer's capacity
    comes from the padded length: ``capacity_len`` (the bucket) gives
    the MoE layers that capacity, so the port's coverage is the JAX
    engine's. Side inputs as ``prefill`` takes them: the last query is
    the prompt's last token, and the prefix counts among its keys.
    Under tensor parallelism (``cfg`` a rank's share, inside
    ``tensor_parallel``) each rank sums its heads' coverage and one
    reduce a routed layer gives every rank the mean over the whole
    model's heads. Returns (n_routed,) float32 on the CPU, in
    ``cfg.routable_layers()`` order."""
    enc_out = encode_side_input(params, cfg, encoder_frames)
    h = embed_tokens(params, cfg, tokens, prefix_embeddings)
    S = h.shape[1]
    positions = torch.arange(S, device=h.device)
    sa = sa_mode(cfg)
    q_idx = S - 1
    kv_pos = torch.arange(S, device=h.device)
    if sa.kind == "triangle":  # the last query sits in the dense tail
        vis = torch.ones(S, dtype=torch.bool, device=h.device)
    else:
        vis = (kv_pos < sa.sink) | (q_idx - kv_pos < sa.local)
    covs = []
    for i, bp in enumerate(params["layers"]):
        if is_routed(cfg, i):
            # the (cheap) projections again, rather than threading probe
            # plumbing through block_apply's cache contract
            x = rms_norm(bp["norm1"], h, cfg.norm_eps)
            if cfg.use_mla:  # the route chunk's per-head K of the latent
                ckv, kr = A.mla_latent(bp["attn"], cfg, x, positions)
                q, _ = A.mla_q(bp["attn"], cfg, x, positions)
                k, _ = A.mla_expand_kv(bp["attn"], cfg, ckv, kr)
            else:
                q, k, _, _ = A.gqa_qkv(bp["attn"], cfg, x, positions)
            G = q.shape[1] // k.shape[1]  # the rank's G under TP
            if G > 1:  # kv-major head order: head j reads kv head j // G
                k = k.repeat_interleave(G, dim=1)
            s = torch.einsum("bhd,bhsd->bhs", q[:, :, q_idx].float(),
                             k.float()) * (q.shape[-1] ** -0.5)
            p = torch.softmax(s, dim=-1)
            # the mean over (B, every head of the model): each rank sums
            # its heads and the ranks sum their sums
            kept = tp_reduce((p * vis).sum(dim=-1).sum().reshape(1))
            covs.append(kept[0] / (p.shape[0] * p.shape[1] * tp_world()))
        h, _, _ = block_apply(bp, cfg, i, h, positions, ("fa_only",),
                              capacity_len=capacity_len, enc_out=enc_out)
    if not covs:
        return torch.zeros((0,), dtype=torch.float32)
    return torch.stack(covs).cpu()
