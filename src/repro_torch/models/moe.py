"""Mixture-of-Experts FFN with capacity-bounded scatter dispatch (port of
``repro/models/moe.py``).

Tokens pick their top-k experts; each expert of each batch row has a
capacity of C = min(max(1, int(ceil(S·k/E) · capacity_factor)), S)
slots, computed from the length S of the call. Tokens are scattered
into a (B, E, C, D) buffer in token order (a token's slot is its rank
among the earlier (token, choice) pairs of its row that chose the same
expert), the expert SwiGLUs run as batched products over E, and the
slots are gathered back weighted by the renormalised top-k
probabilities. A (token, choice) past its expert's capacity is dropped:
the residual connection carries the token. Shared experts (DeepSeek-V2)
are dense SwiGLUs applied to every token and added.

Every step is per batch row: a row's capacity, slots and buffer depend
on that row alone, and a dropped choice adds ``src * 0`` to slot C - 1
of its own row, so a non-finite row stays in its row (the slot pool's
decode and its non-finite sentinel rely on that). The JAX package's
``constrain`` mesh hints have no counterpart here. No TPU kernel is
involved: the JAX function is XLA, and so is this one PyTorch.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import tp_reduce
from repro_torch.models.layers import dense_init, ffn_init, ffn_partial


def moe_init(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    """The JAX package's shapes and scales: ``gate_w`` (D, E) float32
    whatever ``param_dtype``; experts ``gate`` / ``up`` (E, D, F) and
    ``down`` (E, F, D) in ``param_dtype``; ``shared`` a SwiGLU of width
    F · num_shared_experts when the config has shared experts."""
    d, dt, E, f = cfg.d_model, cfg.param_dtype, cfg.num_experts, cfg.moe_d_ff
    params: Dict = {
        "gate_w": dense_init(gen, d, E, torch.float32),
        "experts": {
            "gate": torch.stack([dense_init(gen, d, f, dt)
                                 for _ in range(E)]),
            "up": torch.stack([dense_init(gen, d, f, dt) for _ in range(E)]),
            "down": torch.stack([dense_init(gen, f, d, dt)
                                 for _ in range(E)]),
        },
    }
    if cfg.num_shared_experts:
        params["shared"] = ffn_init(gen, d, f * cfg.num_shared_experts, dt)
    return params


def moe_capacity(cfg: ModelConfig, seq_len: int,
                 capacity_factor: Optional[float] = None) -> int:
    """Slots per (row, expert) for a call over ``seq_len`` tokens a row,
    truncated by ``int`` as in the JAX package. C == seq_len is
    dropless: a token's top-k experts are distinct."""
    cap = (capacity_factor if capacity_factor is not None
           else cfg.moe_capacity_factor)
    per = -(-seq_len * cfg.top_k // cfg.num_experts)
    return min(max(1, int(per * cap)), seq_len)


def top_k_lower_first(probs: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of the last axis, largest first and, among equal
    values, the lower index first (``jax.lax.top_k``'s order, which
    ``torch.topk`` does not promise): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class Dispatch(NamedTuple):
    """Where each (token, choice) of a call goes: ``probs`` (B, S, E)
    the gate's softmax (float32), ``top_p`` / ``top_i`` (B, S, K) the
    renormalised top-k probabilities and their experts, ``pos`` (B, S·K)
    each pair's slot in its (row, expert), ``keep`` (B, S·K) pos < C,
    and the capacity C."""
    probs: torch.Tensor
    top_p: torch.Tensor
    top_i: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    C: int


def dispatch(params, cfg: ModelConfig, x: torch.Tensor,
             capacity_factor: Optional[float] = None,
             capacity_len: Optional[int] = None) -> Dispatch:
    """The gate and the slot assignment of ``moe_apply`` for x (B, S, D):
    the gate product in float32, top-k in ``lax.top_k``'s order, the
    capacity from ``capacity_len`` (default S), and each pair's slot by a
    one-hot cumsum over the row's flattened (S·K) order, so priority goes
    by token. Nothing here waits for the device. The one-hot is laid out
    (B, E, S·K), so the cumsum runs along its contiguous last axis (along
    a strided middle axis the card's scan took 0.8 ms a chunk)."""
    B, S, _ = x.shape
    E, K = cfg.num_experts, cfg.top_k
    logits = x.float() @ params["gate_w"].float()  # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = top_k_lower_first(probs, K)  # (B, S, K)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    C = moe_capacity(cfg, S if capacity_len is None else capacity_len,
                     capacity_factor)
    C = min(C, S)  # C >= S keeps every choice: no need for more slots
    e_flat = top_i.reshape(B, 1, S * K)
    oh = (e_flat == torch.arange(E, device=x.device)[:, None]
          ).to(torch.int32)  # (B, E, S*K)
    pos_all = torch.cumsum(oh, dim=-1, dtype=torch.int32) - oh
    pos = torch.gather(pos_all, 1, e_flat)[:, 0]  # (B, S*K)
    return Dispatch(probs, top_p, top_i, pos, pos < C, C)


def moe_ffn(params, cfg: ModelConfig, x: torch.Tensor,
            capacity_factor: Optional[float] = None,
            capacity_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dispatch]:
    """x (B, S, D) → (y (B, S, D) in x's dtype, its ``Dispatch``): the
    routed experts' weighted sum plus the shared experts.

    Under tensor parallelism each rank holds a slice of every expert's
    FFN width (and of the shared experts'): the dispatch, computed from
    the replicated x, is the same on every rank, the rank's routed sum
    and shared product are partial, and their sum is reduced over the
    ranks once, here (``distributed/sharding.py``).

    The JAX package's (B, E, C, D) expert buffer is kept here as
    (E, B·C, D), slot (b, e, c) at row b·C + c of expert e, so the
    expert products are ``bmm`` over E with no transposed copy; every
    slot holds the same sum as JAX's."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    d = dispatch(params, cfg, x, capacity_factor, capacity_len)
    keep, C = d.keep, d.C
    e_flat = d.top_i.reshape(B, S * K)
    w_flat = torch.where(keep, d.top_p.reshape(B, S * K), 0.0)
    # a dropped choice adds src * 0 at slot C - 1 of its own row, so the
    # sum is exact whatever the order (the only other terms are zeros)
    # and a non-finite row stays in its row
    rows = (e_flat * B + torch.arange(B, device=x.device)[:, None]) * C
    # slot s*K+j ← token s
    src = x[:, :, None].expand(B, S, K, D).reshape(B, S * K, D)
    expert_in = torch.zeros((E * B * C, D), dtype=x.dtype, device=x.device)
    expert_in.index_add_(0, (rows + torch.where(keep, d.pos, C - 1)
                             ).reshape(-1),
                         (src * keep[..., None].to(x.dtype)).reshape(-1, D))
    expert_in = expert_in.view(E, B * C, D)

    ew = params["experts"]
    h = (F.silu(torch.bmm(expert_in, ew["gate"]))
         * torch.bmm(expert_in, ew["up"]))
    expert_out = torch.bmm(h, ew["down"]).view(E * B * C, D)

    gathered = expert_out[(rows + torch.where(keep, d.pos, 0)).reshape(-1)]
    y = (gathered.view(B, S * K, D) * w_flat[..., None].to(x.dtype)
         ).view(B, S, K, D).sum(dim=2)
    if "shared" in params:
        y = y + ffn_partial(params["shared"], x)
    return tp_reduce(y), d


def moe_aux(cfg: ModelConfig, d: Dispatch) -> Dict[str, torch.Tensor]:
    """The JAX package's diagnostics of one call: ``load`` (E,) pairs
    routed to each expert before the capacity cut, ``drop_fraction`` the
    share of pairs dropped, ``router_entropy`` the mean entropy of the
    gate's softmax and ``balance_loss`` the Switch-style load-balance
    loss."""
    E = cfg.num_experts
    probs = d.probs
    load = (d.top_i.reshape(-1)[:, None]
            == torch.arange(E, device=probs.device)).sum(0)
    frac_tokens = load.float() / torch.clamp(load.sum(), min=1)
    mean_prob = probs.mean(dim=(0, 1))
    # XLA takes a mean as the sum times the float32 reciprocal of the
    # count; so does this, to give JAX's drop fraction to the bit
    return {
        "load": load,
        "drop_fraction": 1.0 - d.keep.float().sum() * (1.0 / d.keep.numel()),
        "router_entropy": -(probs * torch.log(probs + 1e-9)).sum(-1).mean(),
        "balance_loss": E * torch.sum(frac_tokens * mean_prob),
    }


def moe_apply(params, cfg: ModelConfig, x: torch.Tensor,
              capacity_factor: Optional[float] = None,
              capacity_len: Optional[int] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, D) → (y (B, S, D) in x's dtype, aux diagnostics
    (``moe_aux``)), as the JAX package's ``moe_apply``. Serving calls
    ``moe_ffn`` and skips the diagnostics; the training slice will need
    them.

    ``capacity_len``: the sequence length the capacity is computed from
    when it is not S. The JAX engine's fidelity probe runs its forward
    over the prompt padded to a power-of-two bucket; padded tokens come
    after the real ones in slot order and never displace them, so the
    real tokens' result is this call over the unpadded prompt with the
    capacity of the bucket's length."""
    y, d = moe_ffn(params, cfg, x, capacity_factor, capacity_len)
    return y, moe_aux(cfg, d)
