"""Mamba2 block via SSD (state-space duality) (port of
``repro/models/ssm.py``).

The SSD algorithm [arXiv:2405.21060] splits the selective scan into
intra-chunk matmul blocks (a quadratic, attention-like contraction over
chunks of Q tokens) and an inter-chunk recurrence over per-chunk states.
The JAX package computes both in XLA einsums and a ``lax.scan``, outside
any Pallas kernel; the port computes them in plain torch: batched
matmuls and a Python loop over the S / Q chunks.

Precision follows the JAX package's rounding points. Its einsums take
bf16 operands with ``preferred_element_type=float32``: a product
accumulated and returned in f32. A torch einsum of bf16 tensors rounds
its output to bf16, so the port upcasts the operands to f32 instead
(exact: the product of two bf16 values fits an f32 significand) and
contracts in f32, as ``core/modes.py`` does. The casts JAX makes before
a product (the scores, ``dt`` inside ``xbar``, the carried states and
``exp(cum)`` in the inter-chunk term) are made at the same points, and
each three-operand einsum is split into explicit f32 steps.

Decode is the O(1) recurrent step: h ← exp(dt·A)·h + dt·(B ⊗ x);
y = C·h + D·x, behind a (W-1)-deep causal-conv tail buffer.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, rms_norm, rms_norm_init


def mamba_init(gen: torch.Generator, cfg: ModelConfig
               ) -> Dict[str, torch.Tensor]:
    """One Mamba2 block's weights at the JAX package's scales: in_proj
    and out_proj as dense layers, conv taps N(0, 1)·0.1, conv bias 0,
    ``A_log`` = log(linspace(1, 16, H)), ``dt_bias`` 0 and ``D`` 1 (the
    last three f32 whatever ``param_dtype`` is)."""
    d, dt, dev = cfg.d_model, cfg.param_dtype, gen.device
    inner, N, nh = cfg.ssm_inner, cfg.ssm_state_dim, cfg.ssm_num_heads
    conv_ch = inner + 2 * N
    in_proj = dense_init(gen, d, 2 * inner + 2 * N + nh, dt)
    conv_w = (torch.randn((cfg.ssm_conv_width, conv_ch), generator=gen,
                          device=dev, dtype=torch.float32) * 0.1).to(dt)
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        # in_proj → [z (inner), xBC (inner + 2N), dt (nh)]
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_ch,), dtype=dt, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "dt_bias": torch.zeros((nh,), **f32),
        "D": torch.ones((nh,), **f32),
        "norm": rms_norm_init(inner, dt, dev),
        "out_proj": dense_init(gen, inner, d, dt),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) at every x (torch's
    ``F.softplus`` returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) with taps (W, C): the W taps
    summed in order from zero in x's dtype, then the bias."""
    W, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    out = torch.zeros_like(xBC)
    for i in range(W):
        out = out + pad[:, i:i + S] * w[i]
    return out + b


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD over a sequence.

    x (B, S, H, P); dt (B, S, H) (after the softplus); A (H,) (< 0);
    Bm / Cm (B, S, N) (shared by the heads, one group); h0 (B, H, P, N)
    f32 or None. Returns (y (B, S, H, P) in x's dtype, final state
    (B, H, P, N) f32). The sequence is padded to a multiple of Q =
    min(chunk, S) with zeros, as in the JAX package."""
    Bsz, S, H, Pd = x.shape
    N = Bm.shape[-1]
    dtype = x.dtype
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = (S + pad) // Q
    # heads ahead of the chunk's rows: (B, nc, H, Q, ·), so every product
    # below is a batched matmul over (B, nc, H)
    xc = x.reshape(Bsz, nc, Q, H, Pd).permute(0, 1, 3, 2, 4)
    dtc = dt.reshape(Bsz, nc, Q, H).float().permute(0, 1, 3, 2)
    Bc = Bm.reshape(Bsz, nc, Q, N).float()
    Cc = Cm.reshape(Bsz, nc, Q, N).float()

    dA = dtc * A[:, None]               # (B, nc, H, Q), <= 0
    cum = torch.cumsum(dA, dim=-1)      # inclusive within the chunk

    # --- intra-chunk (quadratic) ---
    CB = Cc @ Bc.transpose(-1, -2)      # (B, nc, Q, Q) f32
    # above the diagonal cum_i - cum_j > 0 and its exp may overflow: the
    # exponent is set to -inf there before the exp, so the backward meets
    # exp's derivative 0 rather than inf (the select's zero cotangent
    # times inf was NaN, as it still is in the JAX package); the select
    # below keeps the forward bitwise as it was
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp((cum[..., :, None] - cum[..., None, :])
                      .masked_fill(~causal, float("-inf")))  # (B,nc,H,Q,Q)
    scores = torch.where(causal, CB[:, :, None] * decay,
                         torch.zeros((), device=x.device))
    xbar = xc * dtc[..., None].to(dtype)  # dt enters as an input scale
    y_intra = scores.to(dtype).float() @ xbar.float()  # (B, nc, H, Q, P)

    # --- per-chunk states ---
    decay_end = torch.exp(cum[..., -1:] - cum)          # (B, nc, H, Q)
    w = (decay_end * dtc).to(dtype).float()
    # Σ_j x[j] ⊗ B[j] weighted by w[j]: (B, nc, H, P, N)
    S_c = (xc.float() * w[..., None]).transpose(-1, -2) @ Bc[:, :, None]
    chunk_decay = torch.exp(cum[..., -1])               # (B, nc, H)

    # --- inter-chunk recurrence ---
    h = (torch.zeros((Bsz, H, Pd, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + S_c[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                # (B, nc, H, P, N)

    # y_inter[i] = (C[i] · h_prev) · exp(cum[i]), operands in x's dtype
    y_inter = (Cc[:, :, None] @ h_prev.to(dtype).float().transpose(-1, -2))
    y_inter = y_inter * torch.exp(cum).to(dtype).float()[..., None]
    y = (y_intra + y_inter).permute(0, 1, 3, 2, 4).reshape(
        Bsz, nc * Q, H, Pd)[:, :S]
    return y.to(dtype), h


def _split_proj(params, cfg: ModelConfig, x: torch.Tensor):
    inner, N = cfg.ssm_inner, cfg.ssm_state_dim
    zxbcdt = x @ params["in_proj"]
    z = zxbcdt[..., :inner]
    xBC = zxbcdt[..., inner:2 * inner + 2 * N]
    dt_raw = zxbcdt[..., 2 * inner + 2 * N:]
    return z, xBC, dt_raw


def ssd_operands(params, cfg: ModelConfig, x: torch.Tensor,
                 conv_tail: Optional[torch.Tensor] = None):
    """The projections and the causal conv of a Mamba2 block over x
    (B, S, d), after ``conv_tail`` (B, W-1, C) or a zero history. Returns
    (z, the conv's input with its history (B, W-1 + S, C), (xs (B, S, H,
    P), dt (B, S, H) f32, A (H,), Bm, Cm (B, S, N))): ``ssd_chunked``'s
    operands."""
    B, S, _ = x.shape
    inner, N, nh = cfg.ssm_inner, cfg.ssm_state_dim, cfg.ssm_num_heads
    z, xBC, dt_raw = _split_proj(params, cfg, x)
    if conv_tail is not None:
        xBC_in = torch.cat([conv_tail, xBC], dim=1)
        conv = _causal_conv(xBC_in, params["conv_w"],
                            params["conv_b"])[:, conv_tail.shape[1]:]
    else:
        xBC_in = F.pad(xBC, (0, 0, cfg.ssm_conv_width - 1, 0))
        conv = _causal_conv(xBC, params["conv_w"], params["conv_b"])
    conv = F.silu(conv)
    xs = conv[..., :inner].reshape(B, S, nh, cfg.ssm_head_dim)
    dt = softplus(dt_raw.float() + params["dt_bias"])
    return z, xBC_in, (xs, dt, -torch.exp(params["A_log"]),
                       conv[..., inner:inner + N], conv[..., inner + N:])


def mamba_apply(params, cfg: ModelConfig, x: torch.Tensor,
                state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence (prefill) Mamba2 block.

    x (B, S, d) → (y (B, S, d), (SSD state (B, H, P, N) f32, conv tail
    (B, W-1, C))). ``state`` carries (h0, conv_tail) of the tokens before
    ``x`` (a chunked prefill). With no state the conv's history is zeros,
    so the tail is (B, W-1, C) even for a sequence shorter than W-1. The
    returned tail is a tensor of its own (decode writes it in place)."""
    B, S, _ = x.shape
    W1 = cfg.ssm_conv_width - 1
    z, xBC_in, ops = ssd_operands(params, cfg, x,
                                  None if state is None else state[1])
    h0 = state[0] if state is not None else None
    y, h_final = ssd_chunked(*ops, cfg.ssm_chunk, h0)
    xs = ops[0]
    y = y + params["D"].to(y.dtype)[:, None] * xs
    y = y.reshape(B, S, cfg.ssm_inner)
    y = rms_norm(params["norm"], y * F.silu(z), cfg.norm_eps)
    conv_tail = xBC_in[:, xBC_in.shape[1] - W1:].clone()
    return y @ params["out_proj"], (h_final, conv_tail)


def mamba_decode_step(params, cfg: ModelConfig, x: torch.Tensor,
                      ssd_state: torch.Tensor, conv_tail: torch.Tensor):
    """Single-token recurrent step.

    x (B, 1, d); ssd_state (B, H, P, N) f32; conv_tail (B, W-1, C).
    Returns (y (B, 1, d), new SSD state, new conv tail), new tensors
    (the caller writes them into its cache)."""
    B = x.shape[0]
    inner, N, nh = cfg.ssm_inner, cfg.ssm_state_dim, cfg.ssm_num_heads
    z, xBC, dt_raw = _split_proj(params, cfg, x)
    window = torch.cat([conv_tail, xBC], dim=1)  # (B, W, C)
    # the taps' products exact in f32, summed in f32, rounded once
    conv = (window.float() * params["conv_w"].float()).sum(dim=1).to(
        x.dtype) + params["conv_b"]
    conv = F.silu(conv)
    xs = conv[:, :inner].reshape(B, nh, cfg.ssm_head_dim).float()
    Bm = conv[:, inner:inner + N].float()
    Cm = conv[:, inner + N:].float()
    dt = softplus(dt_raw[:, 0].float() + params["dt_bias"])  # (B, H)
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt * A)
    upd = (dt[:, :, None] * xs)[..., None] * Bm[:, None, None, :]
    h = ssd_state * dA[:, :, None, None] + upd
    y = (h @ Cm[:, None, :, None])[..., 0]               # (B, H, P)
    y = y + params["D"][:, None] * xs
    y = y.reshape(B, 1, inner).to(x.dtype)
    y = rms_norm(params["norm"], y * F.silu(z), cfg.norm_eps)
    new_tail = torch.cat([conv_tail[:, 1:], xBC], dim=1)
    return y @ params["out_proj"], h, new_tail
