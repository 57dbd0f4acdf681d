"""Static sparsity baselines the paper compares against (port of
``repro/core/policies.py``):

  * TriangleMix     — static *layer* pattern: deep layers sparse (serve
                      with ``flux.sa_mode="ta"``).
  * DuoAttention    — static *head* split: retrieval heads FA, streaming
                      heads sink+local (the model's ``head_split`` routing
                      context and the engine's ``("duo", n)`` overrides).
  * PruLong         — the same mechanism class, with another head order.
  * UnComp entropy  — the matrix-entropy layer ranking of the paper's
                      §2.3 motivation study: the lowest-entropy layers are
                      made sparse first.

Each returns a per-layer pattern (1 = FA, 0 = SA) as a numpy array, or
the KV-head count of a head split. The patterns are host-side numpy, as
in the JAX package; ``matrix_entropy`` and ``entropy_scores`` run in
float32 torch on the hidden states' device.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


# ---------------------------------------------------------------------------
# Layer-level static patterns
# ---------------------------------------------------------------------------

def static_pattern(cfg: ModelConfig, msr: float,
                   placement: str = "deep") -> np.ndarray:
    """(num_layers,) 1 = FA / 0 = SA with SA fraction ``msr`` over the
    routed layers. placement ∈ {"deep" (TriangleMix), "shallow",
    "interleave"}."""
    routed = list(cfg.routable_layers())
    n_sa = int(round(msr * len(routed)))
    pattern = np.ones((cfg.num_layers,), np.int32)
    if n_sa == 0:
        return pattern
    if placement == "deep":
        sa_layers = routed[-n_sa:]
    elif placement == "shallow":
        sa_layers = routed[:n_sa]
    elif placement == "interleave":
        idx = np.linspace(0, len(routed) - 1, n_sa).round().astype(int)
        sa_layers = [routed[i] for i in idx]
    else:
        raise ValueError(placement)
    pattern[list(sa_layers)] = 0
    return pattern


def trianglemix_pattern(cfg: ModelConfig, msr: float = 0.5) -> np.ndarray:
    """TriangleMix: shallow layers dense, deep layers triangle-sparse."""
    return static_pattern(cfg, msr, "deep")


# ---------------------------------------------------------------------------
# UnComp matrix-entropy layer ranking (paper App. C)
# ---------------------------------------------------------------------------

def matrix_entropy(hidden: torch.Tensor, k_trunc: int = 32) -> torch.Tensor:
    """Truncated von Neumann entropy of the trace-normalised covariance.

    hidden (B, S, d) → scalar float32 tensor. The eigenvalues of X·Xᵀ/tr
    are the squared singular values of the centred X; the k_trunc largest
    are summed (their order does not matter)."""
    B, S, d = hidden.shape
    x = hidden.reshape(B * S, d).float()
    x = x - x.mean(0, keepdim=True)
    lam = torch.linalg.svdvals(x).square()
    lam = lam / torch.clamp(lam.sum(), min=1e-12)
    top = torch.topk(lam, min(k_trunc, lam.shape[0])).values
    return -(top * torch.log(top + 1e-12)).sum()


def entropy_scores(params, cfg: ModelConfig, tokens: torch.Tensor,
                   k_trunc: int = 32) -> np.ndarray:
    """Per-layer entropy E_ℓ over a probe batch (paper Eq. 7)."""
    from repro_torch.models import model as MD

    hs = MD.capture_hidden(params, cfg, tokens)  # (L, B, S, d)
    return np.asarray([float(matrix_entropy(h, k_trunc)) for h in hs],
                      np.float32)


def entropy_pattern(cfg: ModelConfig, scores: Sequence[float],
                    msr: float) -> np.ndarray:
    """Progressive sparsification (paper App. C.2): keep the
    k = ⌊(1 - Ω)·L⌋ highest-entropy routed layers as FA."""
    routed = list(cfg.routable_layers())
    sc = np.asarray([scores[i] for i in routed])
    k_keep = int((1.0 - msr) * len(routed))
    order = np.argsort(-sc)  # descending entropy
    pattern = np.zeros((cfg.num_layers,), np.int32)
    for i, kind in enumerate(cfg.layer_kinds):
        if kind != "attn":
            pattern[i] = 1
    for j in order[:k_keep]:
        pattern[routed[j]] = 1
    return pattern


# ---------------------------------------------------------------------------
# Head-level baselines (DuoAttention / PruLong)
# ---------------------------------------------------------------------------

def duo_n_fa_kv(cfg: ModelConfig, msr: float = 0.5) -> int:
    """Retrieval KV-head count for a target head sparsity."""
    return max(1, int(round((1.0 - msr) * cfg.num_kv_heads)))
