"""The paper's Layer Router (§3.1), inference half
(port of ``repro/core/router.py``).

Prefix(-suffix) pooling over the boundary ``pool_size`` tokens of the
layer's incoming query tensor → Context-Encoder MLP → Router-Head MLP →
2 routing logits (π_FA, π_SA); inference takes the argmax (§3.3). Router
params are float32. Gumbel soft routing waits for the training slice
(ROADMAP Queue 1 item 15).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import FluxConfig
from repro_torch.models.layers import dense_init


def router_init(gen: torch.Generator, in_dim: int,
                flux: FluxConfig) -> Dict[str, torch.Tensor]:
    h = flux.router_hidden
    f32 = torch.float32
    return {
        "enc_w": dense_init(gen, 2 * in_dim, h, f32),
        "enc_b": torch.zeros((h,), dtype=f32, device=gen.device),
        "head_w1": dense_init(gen, h, h, f32),
        "head_b1": torch.zeros((h,), dtype=f32, device=gen.device),
        "head_w2": dense_init(gen, h, 2, f32),
        "head_b2": torch.zeros((2,), dtype=f32, device=gen.device),
    }


def pool_prefix_suffix(x_q: torch.Tensor, pool_size: int) -> torch.Tensor:
    """(B, S, F) → (B, 2F): mean over the first / last ``pool_size``
    tokens."""
    p = min(pool_size, x_q.shape[1])
    prefix = x_q[:, :p].float().mean(dim=1)
    suffix = x_q[:, -p:].float().mean(dim=1)
    return torch.cat([prefix, suffix], dim=-1)


def pool_prefix(x_q: torch.Tensor, pool_size: int) -> torch.Tensor:
    """Prefix-only pooling, the prefix mean fed to both encoder halves:
    the chunk-invariant serving variant (any chunk covering the first
    ``pool_size`` tokens yields the same decision)."""
    p = min(pool_size, x_q.shape[1])
    prefix = x_q[:, :p].float().mean(dim=1)
    return torch.cat([prefix, prefix], dim=-1)


def router_logits(params: Dict[str, torch.Tensor], x_q: torch.Tensor,
                  pool_size: int,
                  pooling: str = "prefix_suffix") -> torch.Tensor:
    """x_q (B, S, F) → logits (B, 2) = (π_FA, π_SA).

    ``jax.nn.gelu`` defaults to the tanh approximation, so the port's
    GELU is ``approximate="tanh"``, not torch's exact-erf default."""
    pool = {"prefix_suffix": pool_prefix_suffix,
            "prefix": pool_prefix}[pooling]
    pooled = pool(x_q, pool_size)
    h = F.gelu(pooled @ params["enc_w"] + params["enc_b"],
               approximate="tanh")
    h = F.gelu(h @ params["head_w1"] + params["head_b1"],
               approximate="tanh")
    return h @ params["head_w2"] + params["head_b2"]


def hard_route(params: Dict[str, torch.Tensor], x_q: torch.Tensor,
               flux: FluxConfig, pooling: str = "prefix_suffix"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic inference routing (§3.3).

    Returns (r_hard (B,) ∈ {0,1} with 1 = FA, p_fa (B,) the underlying
    probability)."""
    logits = router_logits(params, x_q, flux.pool_size, pooling)
    p_fa = torch.softmax(logits, dim=-1)[:, 0]
    return (logits[:, 0] > logits[:, 1]).to(torch.int32), p_fa


def sa_biased_threshold(level: int, *, step: float = 0.15,
                        max_level: int = 3) -> float:
    """FA-decision threshold for one rung of the load-adaptive sparsity
    ladder: 0.5 (the paper's argmax) at level 0, raised by ``step`` per
    rung, levels clamped to [0, max_level], never reaching 1.0."""
    lv = max(0, min(int(level), int(max_level)))
    return min(0.5 + lv * float(step), 0.999)
