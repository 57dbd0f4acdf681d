"""Analytic expressed cost of a pooled decode tick (port of the analytic
half of ``repro/launch/hlo_costs.py``, lines 278-366).

The JAX module's other half walks post-optimization XLA HLO text; the
port compiles no HLO, so only the host arithmetic the serving profiler
joins against comes over: the FLOPs and HBM bytes a pooled decode tick
*expresses*, dense (a full sweep of every cache buffer) against the
kernel (each slot's live keys in ``block_k`` tiles).

Counting conventions, as in the JAX module:
  * dense KV bytes    = B · Hkv · L_buf · (Dk + Dv) · dtype_bytes
    (each batch row streams the whole buffer once; heads broadcast)
  * kernel KV bytes   = Hq · Σ_b ceil(min(len_b, L_buf)/bk) · bk
                        · (Dk + Dv) · dtype_bytes
    (the Pallas grid iterates B·Hq rows and refetches a kv block for
    every q-head of its group; the port's split kernel reads a tile
    once for its G heads, so for G > 1 this column counts G times the
    bytes the card moves; at G = 1 the two agree)
  * FLOPs             = 2 · (same block counts) · Hq per q-row
An MLA layer's absorbed decode is one latent "kv head" (Hkv = 1) with
Dk = R + rope and Dv = R: the engine's layer spec says so, and its key
and value columns are counted apart as above, though the latent decode
kernel reads ckv once for both.
Tiny q/output traffic (B·Hq·(Dk+Dv)) is omitted from both columns. The
engine passes ``block_k`` = 64, the port's pooled kernel's key tile,
when its pools lie on the card, and no kernel column (all dense) on the
CPU, where the plain version sweeps the whole buffer.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def ragged_lengths(batch: int, live_max: int) -> List[int]:
    """Deterministic mixed-length pool: evenly spaced 1..live_max."""
    live_max = max(1, live_max)
    return [max(1, round(live_max * (i + 1) / batch))
            for i in range(batch)]


def pooled_decode_attn_cost(lengths: List[int], buffer_len: int, *,
                            n_q_heads: int, n_kv_heads: int,
                            d_k: int, d_v: int, block_k: int = 128,
                            dtype_bytes: int = 4) -> Dict[str, float]:
    """Expressed HBM bytes and MXU FLOPs for ONE pooled attention
    consult (one layer, one decode step), dense vs kernel."""
    B = len(lengths)
    row_bytes = (d_k + d_v) * dtype_bytes
    dense_bytes = B * n_kv_heads * buffer_len * row_bytes
    dense_flops = 2.0 * B * n_q_heads * buffer_len * (d_k + d_v)
    kv_cols = sum(_ceil_div(min(n, buffer_len), block_k) * block_k
                  for n in lengths)
    kernel_bytes = n_q_heads * kv_cols * row_bytes
    kernel_flops = 2.0 * n_q_heads * kv_cols * (d_k + d_v)
    return {
        "dense_hbm_bytes": float(dense_bytes),
        "kernel_hbm_bytes": float(kernel_bytes),
        "dense_flops": dense_flops,
        "kernel_flops": kernel_flops,
        "bytes_ratio": kernel_bytes / max(dense_bytes, 1),
    }


def decode_linear_cost(n_params: int, params_bytes: int, *,
                       batch: int, n_steps: int = 1) -> Dict[str, float]:
    """Expressed non-attention cost of pooled decode: every step runs
    the full parameter set once per batch row (2·N FLOPs per token)
    and streams the params from HBM once per step (the batch shares
    one read — decode is famously parameter-bandwidth-bound)."""
    return {
        "flops": 2.0 * float(n_params) * batch * n_steps,
        "hbm_bytes": float(params_bytes) * n_steps,
    }


def pooled_decode_tick_cost(lengths: List[int],
                            layer_specs: List[Tuple],
                            *, n_steps: int = 1,
                            kernel_hits: Optional[List[bool]] = None,
                            block_k: int = 128) -> Dict:
    """Expressed attention cost of one pooled decode tick across all
    attention layers — the join the serving profiler uses.

    ``layer_specs`` holds one (buffer_len, n_q_heads, n_kv_heads, d_k,
    d_v, dtype_bytes) tuple per attention layer (the engine derives
    them from static cache shapes); ``kernel_hits[i]`` selects the
    kernel column (live-length block trips) for layers the decode
    kernel served and the dense column (full buffer sweep) for
    declined/dense layers — None means all-dense.  Returns totals plus
    the kernel-hit / kernel-decline split, each scaled by ``n_steps``.
    """
    if kernel_hits is None:
        kernel_hits = [False] * len(layer_specs)
    if len(kernel_hits) != len(layer_specs):
        raise ValueError(
            f"pooled_decode_tick_cost: {len(kernel_hits)} kernel_hits "
            f"for {len(layer_specs)} layer specs — the kernel trace and "
            f"the geometry specs must describe the same layers")
    out: Dict = {
        "flops": 0.0, "hbm_bytes": 0.0,
        "kernel_hit": {"layers": 0, "flops": 0.0, "hbm_bytes": 0.0},
        "kernel_decline": {"layers": 0, "flops": 0.0, "hbm_bytes": 0.0},
    }
    for (buf, hq, hkv, dk, dv, db), hit in zip(layer_specs, kernel_hits):
        c = pooled_decode_attn_cost(lengths, buf, n_q_heads=hq,
                                    n_kv_heads=hkv, d_k=dk, d_v=dv,
                                    block_k=block_k, dtype_bytes=db)
        fl = (c["kernel_flops"] if hit else c["dense_flops"]) * n_steps
        hb = (c["kernel_hbm_bytes"] if hit
              else c["dense_hbm_bytes"]) * n_steps
        out["flops"] += fl
        out["hbm_bytes"] += hb
        side = out["kernel_hit" if hit else "kernel_decline"]
        side["layers"] += n_steps  # layer-consults: layers × steps
        side["flops"] += fl
        side["hbm_bytes"] += hb
    return out
