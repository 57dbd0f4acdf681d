"""The paper's Layer Router (§3.1) (port of ``repro/core/router.py``).

Prefix(-suffix) pooling over the boundary ``pool_size`` tokens of the
layer's incoming query tensor → Context-Encoder MLP → Router-Head MLP →
2 routing logits (π_FA, π_SA); inference takes the argmax (§3.3),
training the Gumbel-Softmax relaxation (``soft_route``, Eq. 4) at the
annealed temperature (``anneal_tau``). Router params are float32. The
serving telemetry's decision margins and their drift per sparsity rung
(``decision_margin``, ``MarginDriftTracker``) are pure host arithmetic.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import FluxConfig
from repro_torch.distributed.sharding import tp_reduce
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
    GELU is ``approximate="tanh"``, not torch's exact-erf default.

    Under tensor parallelism x_q holds the rank's heads' columns and
    ``enc_w`` the matching rows of each pooling half; pooling is per
    column, so the partial products sum over the ranks before the bias
    (a reduce point, ``distributed/sharding.py``) and every rank reads
    the same logits."""
    pool = {"prefix_suffix": pool_prefix_suffix,
            "prefix": pool_prefix}[pooling]
    pooled = pool(x_q, pool_size)
    h = F.gelu(tp_reduce(pooled @ params["enc_w"]) + params["enc_b"],
               approximate="tanh")
    h = F.gelu(h @ params["head_w1"] + params["head_b1"],
               approximate="tanh")
    return h @ params["head_w2"] + params["head_b2"]


def gumbel_noise(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel draws -log(-log(u)) of ``shape`` in float32 on the
    generator's device, u uniform in [tiny, 1) (the lower bound keeps
    both logs finite, as ``jax.random.gumbel`` keeps u above 0)."""
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=torch.float32)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def soft_route(params: Dict[str, torch.Tensor], x_q: torch.Tensor,
               flux: FluxConfig, tau, gumbel: torch.Tensor) -> torch.Tensor:
    """Gumbel-Softmax relaxed routing weight r_soft ∈ (0, 1), the
    probability of selecting FA (paper Eq. 4). ``gumbel`` (B, 2) float32
    is the layer's Gumbel sample, drawn by the caller (``gumbel_noise``
    from an explicit generator, or handed over by a test), so a
    recomputed forward sees the same noise. Returns (B,) float32."""
    logits = router_logits(params, x_q, flux.pool_size)  # (B, 2)
    tau = torch.as_tensor(tau, dtype=torch.float32, device=logits.device)
    z = (logits + gumbel.to(logits.device)) / torch.clamp(tau, min=1e-6)
    return torch.softmax(z, dim=-1)[:, 0]


def anneal_tau(flux: FluxConfig, step, total_steps: int) -> torch.Tensor:
    """Linear temperature decay from ``tau_start`` to ``tau_end`` over
    ``total_steps`` (paper §3.1), in float32 as the JAX package computes
    it from its int32 step. Returns a 0-d float32 tensor."""
    frac = torch.clamp(torch.as_tensor(step, dtype=torch.float32)
                       / max(total_steps, 1), 0.0, 1.0)
    return flux.tau_start + (flux.tau_end - flux.tau_start) * frac


def hard_route(params: Dict[str, torch.Tensor], x_q: torch.Tensor,
               flux: FluxConfig, pooling: str = "prefix_suffix"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic inference routing (§3.3).

    Returns (r_hard (B,) ∈ {0,1} with 1 = FA, p_fa (B,) the underlying
    probability)."""
    logits = router_logits(params, x_q, flux.pool_size, pooling)
    p_fa = torch.softmax(logits, dim=-1)[:, 0]
    return (logits[:, 0] > logits[:, 1]).to(torch.int32), p_fa


def prefix_routing_reusable(flux: FluxConfig, prefix_len: int,
                            seq_len: int, *, pooling: str = "prefix",
                            routable: bool = True) -> bool:
    """Can a routing decision taken on one prompt transfer exactly to
    another prompt sharing its first ``prefix_len`` tokens?

    The routing half of the prefix cache's match check
    (``serve/prefix_cache.py``). Hard routing with prefix-only pooling
    reads the first ``pool_size`` tokens of each layer's queries and
    nothing else, so two prompts agree iff both pool windows lie inside
    the shared prefix: ``prefix_len >= pool_size`` (the publisher decided
    on tokens the matcher also has) and ``seq_len >= pool_size`` (a
    shorter prompt pools ``min(pool_size, S)`` tokens and may decide
    otherwise). Prefix+suffix pooling reads the prompt's tail, so it
    never transfers. A model with no routed layers (``routable=False``)
    has no decision to disagree on."""
    if not routable:
        return True
    if pooling != "prefix":
        return False
    return prefix_len >= flux.pool_size and seq_len >= flux.pool_size


def sa_biased_threshold(level: int, *, step: float = 0.15,
                        max_level: int = 3) -> float:
    """FA-decision threshold for one rung of the load-adaptive sparsity
    ladder: 0.5 (the paper's argmax) at level 0, raised by ``step`` per
    rung, levels clamped to [0, max_level], never reaching 1.0."""
    lv = max(0, min(int(level), int(max_level)))
    return min(0.5 + lv * float(step), 0.999)


def decision_margin(p_fa: float, level: int, *, step: float = 0.15,
                    max_level: int = 3) -> float:
    """Signed score-vs-threshold margin of one hard routing decision:
    ``p_fa`` minus the rung's ``sa_biased_threshold`` (positive = the
    FA side of the cut, level 0 = the paper's 0.5 argmax).

    The serving telemetry observes this per routed layer at admission
    time (the ``flux_router_margin`` histogram): a margin
    distribution hugging zero means the router is deciding on a knife
    edge — exactly the layers a sparsity-rung change will flip.
    """
    return float(p_fa) - sa_biased_threshold(level, step=step,
                                             max_level=max_level)


class MarginDriftTracker:
    """Decision-margin drift over the request stream, keyed by
    (layer, sa_level) rung.

    Pure-host bookkeeping (no tensors): the serving engine feeds it the
    same per-layer ``decision_margin`` floats it already observes into
    the margin histograms.  Per key it keeps a Welford lifetime mean
    and a bounded window of recent margins; **drift** is
    ``recent_mean − lifetime_mean`` — positive drift at a rung means
    the router has been deciding more FA-ward than it historically did
    there, i.e. the traffic mix shifted under a fixed dial setting.
    That is the early-warning signal the load-adaptive sparsity dial
    needs before a rung change starts flipping layers."""

    __slots__ = ("window", "_stats")

    def __init__(self, window: int = 256):
        if window < 1:
            raise ValueError(
                f"MarginDriftTracker: window={window} must be >= 1")
        self.window = int(window)
        # (layer, sa_level) -> [count, lifetime_mean, recent deque]
        self._stats: Dict[Tuple[int, int], list] = {}

    def observe(self, layer: int, sa_level: int, margin: float) -> None:
        key = (int(layer), int(sa_level))
        st = self._stats.get(key)
        if st is None:
            st = self._stats[key] = [0, 0.0, deque(maxlen=self.window)]
        st[0] += 1
        st[1] += (float(margin) - st[1]) / st[0]  # Welford mean
        st[2].append(float(margin))

    def drift(self, layer: int, sa_level: int) -> float:
        st = self._stats.get((int(layer), int(sa_level)))
        if st is None or not st[2]:
            return 0.0
        return sum(st[2]) / len(st[2]) - st[1]

    def keys(self) -> Tuple[Tuple[int, int], ...]:
        return tuple(sorted(self._stats))

    def report(self) -> Dict[str, Dict[str, float]]:
        """{"layer:level": {count, lifetime_mean, recent_mean, drift}}
        — JSON-ready for the drain summary / ledger report."""
        out: Dict[str, Dict[str, float]] = {}
        for (layer, level), st in sorted(self._stats.items()):
            recent = (sum(st[2]) / len(st[2])) if st[2] else 0.0
            out[f"{layer}:{level}"] = {
                "count": float(st[0]),
                "lifetime_mean": st[1],
                "recent_mean": recent,
                "drift": recent - st[1],
            }
        return out
