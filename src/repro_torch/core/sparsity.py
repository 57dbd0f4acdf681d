"""Sparsity metrics and the Lagrangian training objective (paper §2.3,
§3.2) (port of ``repro/core/sparsity.py``).

Ω_MSR (Eq. 3) is the fraction of (layer, head) slots running SA; with
layer-level routing every head of a layer shares the decision, so it is
the SA fraction over the routed layers.

Constraint (Eq. 6): per task type, L_diff = E[1 - r_soft] - t, penalised
by λ1·L_diff + λ2·L_diff² with trainable multipliers λ1, λ2 >= 0, which
the optimizer ascends (``train/optimizer.py``, ``ascend=True``) and
``project_lagrange`` clips to 0.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import FluxConfig

# Task-type ids of the Lagrangian (the paper trains per-task multipliers)
TASK_RETRIEVAL = 0
TASK_HOLISTIC = 1


def msr(r_hard: torch.Tensor) -> torch.Tensor:
    """Model Sparsity Ratio over routed layers: r_hard (..., n_routed)
    with 1 = FA, 0 = SA → (...,) float32."""
    return torch.mean(1.0 - r_hard.to(torch.float32), dim=-1)


def lagrangian_init(flux: FluxConfig,
                    generator: Optional[torch.Generator] = None
                    ) -> Dict[str, torch.Tensor]:
    """λ1, λ2 per task type, float32 on the generator's device (CPU
    without one). The paper initialises them at random, then adapts them
    by ascent: λ1 ~ U[0, 0.2), λ2 ~ U[0.2, 0.6) from ``generator``;
    without one the midpoints 0.1 and 0.4. A generator's draws are not
    ``jax.random``'s: a test hands both packages the same values."""
    n = flux.num_task_types
    if generator is None:
        return {"lambda1": torch.full((n,), 0.1, dtype=torch.float32),
                "lambda2": torch.full((n,), 0.4, dtype=torch.float32)}
    dev = generator.device

    def uniform(lo, hi):
        u = torch.rand((n,), generator=generator, device=dev,
                       dtype=torch.float32)
        return lo + (hi - lo) * u

    return {"lambda1": uniform(0.0, 0.2), "lambda2": uniform(0.2, 0.6)}


def target_table(flux: FluxConfig, device=None) -> torch.Tensor:
    """Per-task sparse budget t (paper §4.1: retrieval 0.45, holistic
    1.0), float32."""
    return torch.tensor([flux.target_retrieval, flux.target_holistic],
                        dtype=torch.float32, device=device)


def sparsity_loss(r_soft: torch.Tensor, task_type: torch.Tensor,
                  lagrange: Dict[str, torch.Tensor], flux: FluxConfig
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The sparsity term of Eq. 6.

    r_soft (B, n_routed) FA probabilities; task_type (B,) int. Per task
    type, the masked means of the expected SA fraction and of the
    target over the batch rows of that type; a type absent from the
    batch (``present`` 0) adds nothing. Returns (scalar loss, {l_diff,
    per_task_sparsity, present}), all float32. The λs enter the loss
    directly; the optimizer ascends on them (max_λ min_θ)."""
    dev = r_soft.device
    task_type = task_type.to(device=dev, dtype=torch.long)
    t = target_table(flux, dev)[task_type]  # (B,)
    sparse_prob = torch.mean(1.0 - r_soft, dim=-1)  # (B,)
    onehot = F.one_hot(task_type, flux.num_task_types).to(torch.float32)
    counts = torch.clamp(onehot.sum(0), min=1.0)
    per_task_sparse = (onehot * sparse_prob[:, None]).sum(0) / counts
    per_task_t = (onehot * t[:, None]).sum(0) / counts
    l_diff = per_task_sparse - per_task_t  # (T,)
    present = (onehot.sum(0) > 0).to(torch.float32)
    loss = torch.sum(present * (lagrange["lambda1"] * l_diff
                                + lagrange["lambda2"] * l_diff.square()))
    return loss, {"l_diff": l_diff, "per_task_sparsity": per_task_sparse,
                  "present": present}


def project_lagrange(lagrange: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Enforce λ >= 0 after the ascent step."""
    return {k: torch.clamp(v, min=0.0) for k, v in lagrange.items()}
