"""AdamW with decoupled weight decay, schedules and ascent groups (port of
``repro/train/optimizer.py``).

Parameters are the port's tree: nested dicts and lists of tensors, with
``None`` where a leaf is not part of a group (``partition``). Only the
leaves of a group carry optimizer state and updates. The Lagrange
multipliers of Eq. 6 are maximised: ``ascend=True`` flips the update
and skips the decay (``core.sparsity.project_lagrange`` then clips them
to 0). The arithmetic is the JAX package's, not ``torch.optim.AdamW``'s:
b1 0.9, b2 0.95, eps 1e-8, the moments in float32, bias correction by
the step count, and the float32 update cast back to each leaf's dtype.
Each update returns new tensors; nothing is written in place.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch


# ---------------------------------------------------------------------------
# Trees (dicts and lists of tensors, None = not in this group)
# ---------------------------------------------------------------------------

def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees ``rest`` of
    the same structure. A None in ``tree`` is a leaf too (``fn`` sees
    it), so a partitioned tree keeps its shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensors of ``tree`` in its order (None leaves skipped)."""
    out = []
    tree_map(lambda x: out.append(x) if x is not None else None, tree)
    return out


def partition(tree, mask):
    """Split by a boolean mask tree → (trainable, frozen); None
    elsewhere."""
    train = tree_map(lambda x, m: x if m else None, tree, mask)
    frozen = tree_map(lambda x, m: None if m else x, tree, mask)
    return train, frozen


def combine(a, b):
    """Inverse of ``partition`` (None-aware merge)."""
    return tree_map(lambda x, y: x if x is not None else y, a, b)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def cosine_warmup(base_lr: float, total_steps: int,
                  warmup_frac: float = 0.2,
                  final_frac: float = 0.05) -> Callable:
    """Linear warmup over ``warmup_frac`` of ``total_steps`` (at least
    one step), then cosine decay to ``final_frac`` of ``base_lr``
    (paper App. D: warmup 20 %). The returned lr(step) is a 0-d float32
    tensor, computed in float32 as the JAX package computes it."""
    warmup = max(1, int(total_steps * warmup_frac))

    def lr(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / warmup
        t = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                        0, 1)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, base_lr * cos)

    return lr


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@dataclass
class AdamState:
    mu: Any                # float32 first moments, the group's tree
    nu: Any                # float32 second moments
    count: torch.Tensor    # 0-d int32 on the CPU: updates taken


def adamw_init(params) -> AdamState:
    z = tree_map(lambda x: None if x is None
                 else torch.zeros_like(x, dtype=torch.float32), params)
    return AdamState(mu=z, nu=tree_map(
        lambda x: None if x is None else torch.zeros_like(x), z),
        count=torch.zeros((), dtype=torch.int32))


def adamw_update(grads, state: AdamState, params, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, ascend: bool = False):
    """One AdamW step → (new params, new ``AdamState``). ``ascend=True``
    flips the update (gradient ascent, the Lagrange multipliers) and
    applies no decay. ``lr`` a float or 0-d float32 tensor."""
    c = state.count + 1
    cf = c.to(torch.float32)
    corr1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32), cf)
    corr2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32), cf)
    lr = torch.as_tensor(lr, dtype=torch.float32)

    def new_mu(g, m):
        return None if g is None else b1 * m + (1 - b1) * g.float()

    def new_nu(g, v):
        return None if g is None else b2 * v + (1 - b2) * g.float().square()

    mu = tree_map(new_mu, grads, state.mu)
    nu = tree_map(new_nu, grads, state.nu)

    def upd(p, m, v):
        if m is None or p is None:
            return None
        lr_d = lr.to(p.device)
        step = lr_d * (m / corr1.to(p.device)) / (
            torch.sqrt(v / corr2.to(p.device)) + eps)
        p32 = p.float()
        if ascend:  # gradient ascent; no decay on the multipliers
            new_p = p32 + step
        else:
            new_p = p32 - step - lr_d * weight_decay * p32
        return new_p.to(p.dtype)

    new_params = tree_map(upd, params, mu, nu)
    return new_params, AdamState(mu=mu, nu=nu, count=c)
