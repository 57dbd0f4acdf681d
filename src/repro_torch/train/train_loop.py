"""Training loops (port of ``repro/train/train_loop.py``).

``RouterTrainer`` is the paper's parameter-efficient recipe (§3.2, App.
D): the backbone is frozen, only the Layer-Router parameters train (lr
5e-4), the Lagrange multipliers λ1, λ2 are ascended (lr 1e-3) and
projected to >= 0, the Gumbel temperature anneals linearly, and the loss
is CE + λ1·L_diff + λ2·L_diff² per task type (Eq. 6).

``PretrainTrainer`` trains every parameter (the small backbones of the
accuracy benches). ``ContinuedTrainer`` freezes the router and trains
the backbone (paper §5.3).

A step takes each routed layer's Gumbel sample as ``gumbel`` (n_routed,
B, 2), or draws it from ``generator``; ``run`` draws from one generator
seeded by ``seed``. The trainable leaves are held as plain tensors; a
step differentiates copies of them (``torch.autograd.grad``), so frozen
tensors never require grad and no weight gradient is made for them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import router as R
from repro_torch.core import sparsity as SP
from repro_torch.models import model as MD
from repro_torch.train import optimizer as OPT


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Masked mean token cross entropy in float32 over logits (B, S, V)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _chunk_nll(hc, lc, mc, w):
    logits = (hc @ w.to(hc.dtype)).float()
    logp = F.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, lc.long()[..., None])[..., 0]
    return (ll * mc).sum()


def chunked_cross_entropy(hidden: torch.Tensor, w: torch.Tensor,
                          labels: torch.Tensor, mask: torch.Tensor,
                          chunk: int = 512) -> torch.Tensor:
    """CE over hidden (B, S, d) and the unembedding w (d, V), computed per
    sequence chunk: the sequence is padded to a multiple of the chunk,
    each chunk's logits are float32 and recomputed in the backward pass
    (``torch.utils.checkpoint``), so no (B, S, V) tensor is ever held
    (at 256k vocab it would dominate memory)."""
    B, S, _ = hidden.shape
    c = min(chunk, S)
    pad = (-S) % c
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s in range(0, hidden.shape[1], c):
        part = slice(s, s + c)
        total = total - torch.utils.checkpoint.checkpoint(
            _chunk_nll, hidden[:, part], labels[:, part], mask[:, part], w,
            use_reentrant=False, preserve_rng_state=False)
    return total / torch.clamp(mask.sum(), min=1.0)


def _sum_aux(aux: Dict[str, torch.Tensor], key: str, device):
    v = aux.get(key)
    return (torch.sum(v) if v is not None
            else torch.zeros((), dtype=torch.float32, device=device))


def _grads(loss: torch.Tensor, leaves) -> list:
    """d loss / d leaf for each leaf (zeros where the loss does not reach
    a leaf, as JAX's gradient of an unused input)."""
    if not leaves:
        return []
    if not loss.requires_grad:
        return [torch.zeros_like(x) for x in leaves]
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for g, x in zip(gs, leaves)]


def _with_grad(tree) -> Tuple[Any, list]:
    """Copies of ``tree``'s tensors that require grad, and those leaves
    in tree order."""
    leaves = []

    def leaf(x):
        if x is None:
            return None
        t = x.detach().requires_grad_()
        leaves.append(t)
        return t
    return OPT.tree_map(leaf, tree), leaves


def _regrad(tree, grads: list):
    """``tree`` with its tensors replaced, in order, by ``grads``."""
    it = iter(grads)
    return OPT.tree_map(lambda x: None if x is None else next(it), tree)


def _device(tree) -> torch.device:
    return OPT.tree_leaves(tree)[0].device


def _batch(b, device) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.as_tensor(np.asarray(x), device=device)
                 for x in (b.tokens, b.labels, b.loss_mask, b.task_type))


# ---------------------------------------------------------------------------
# Router training (the paper's recipe)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RouterTrainer:
    cfg: ModelConfig
    total_steps: int
    lr_router: float = 5e-4      # paper: Mask LR 5e-4
    lr_lagrange: float = 1e-3    # paper: Reg LR 1e-3
    weight_decay: float = 0.1

    def init(self, params, generator: Optional[torch.Generator] = None):
        """The state: router leaves trainable, the rest frozen, λ from
        ``generator`` (``sparsity.lagrangian_init``) on the parameters'
        device, both AdamW states and the step."""
        mask = MD.router_param_filter(params)
        trainable, frozen = OPT.partition(params, mask)
        dev = _device(params)
        lagrange = {k: v.to(dev) for k, v in
                    SP.lagrangian_init(self.cfg.flux, generator).items()}
        return {"trainable": trainable, "frozen": frozen,
                "lagrange": lagrange,
                "opt_router": OPT.adamw_init(trainable),
                "opt_lagrange": OPT.adamw_init(lagrange),
                "step": torch.zeros((), dtype=torch.int32)}

    def params(self, state) -> Any:
        return OPT.combine(state["trainable"], state["frozen"])

    def loss_and_grads(self, state, tokens, labels, loss_mask, task_type, *,
                       gumbel=None, generator=None, prefix_embeddings=None,
                       encoder_frames=None):
        """(loss, metrics, router gradients, λ gradients) of one batch at
        the state's step: ``loss_fn`` and ``jax.value_and_grad`` of the
        JAX step."""
        cfg = self.cfg
        tau = R.anneal_tau(cfg.flux, state["step"], self.total_steps)
        trainable, t_leaves = _with_grad(state["trainable"])
        lagrange, l_leaves = _with_grad(state["lagrange"])
        params = OPT.combine(trainable, state["frozen"])
        out = MD.forward_train(params, cfg, tokens, gumbel=gumbel,
                               generator=generator, tau=tau,
                               output_hidden=True,
                               prefix_embeddings=prefix_embeddings,
                               encoder_frames=encoder_frames)
        ce = chunked_cross_entropy(out.logits,
                                   MD.unembed_matrix(params, cfg), labels,
                                   loss_mask)
        dev = ce.device
        if cfg.routable_layers() and cfg.flux.enabled:
            sp, diag = SP.sparsity_loss(out.r_soft, task_type, lagrange,
                                        cfg.flux)
            soft_msr = torch.mean(1.0 - out.r_soft)
            l_diff, per_task = diag["l_diff"], diag["per_task_sparsity"]
        else:  # e.g. an attention-free SSM: nothing to route
            sp = torch.zeros((), dtype=torch.float32, device=dev)
            soft_msr = torch.full((), float("nan"), device=dev)
            l_diff = per_task = torch.zeros((cfg.flux.num_task_types,),
                                            dtype=torch.float32, device=dev)
        loss = ce + sp
        grads = _grads(loss, t_leaves + l_leaves)
        metrics = {"loss": loss, "ce": ce, "sparsity_loss": sp,
                   "soft_msr": soft_msr, "l_diff": l_diff,
                   "per_task_sparsity": per_task, "tau": tau}
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (metrics["loss"], metrics,
                _regrad(state["trainable"], grads[:len(t_leaves)]),
                _regrad(state["lagrange"], grads[len(t_leaves):]))

    def step(self, state, tokens, labels, loss_mask, task_type, *,
             gumbel=None, generator=None, prefix_embeddings=None,
             encoder_frames=None):
        """One step → (new state, metrics)."""
        _, metrics, g_router, g_lagrange = self.loss_and_grads(
            state, tokens, labels, loss_mask, task_type, gumbel=gumbel,
            generator=generator, prefix_embeddings=prefix_embeddings,
            encoder_frames=encoder_frames)
        return self.update(state, metrics, g_router, g_lagrange)

    def update(self, state, metrics, g_router, g_lagrange):
        """The optimizer half of ``step``: AdamW on the router at the
        schedule's lr, ascent and projection on λ → (new state,
        metrics with the new λ)."""
        lr_r = OPT.cosine_warmup(self.lr_router, self.total_steps)(
            state["step"])
        lr_l = OPT.cosine_warmup(self.lr_lagrange, self.total_steps)(
            state["step"])
        metrics = dict(metrics)
        new_trainable, opt_r = OPT.adamw_update(
            g_router, state["opt_router"], state["trainable"], lr=lr_r,
            weight_decay=self.weight_decay)
        # max over λ: ascent + projection to λ >= 0
        new_lagrange, opt_l = OPT.adamw_update(
            g_lagrange, state["opt_lagrange"], state["lagrange"], lr=lr_l,
            ascend=True)
        new_lagrange = SP.project_lagrange(new_lagrange)
        metrics["lambda1"] = new_lagrange["lambda1"]
        metrics["lambda2"] = new_lagrange["lambda2"]
        return {"trainable": new_trainable, "frozen": state["frozen"],
                "lagrange": new_lagrange, "opt_router": opt_r,
                "opt_lagrange": opt_l,
                "step": state["step"] + 1}, metrics

    def run(self, state, data_iter, steps: int, log_every: int = 50,
            seed: int = 0, log_fn=print):
        dev = _device(state["frozen"])
        gen = torch.Generator(device=dev).manual_seed(seed)
        history = []
        for i in range(steps):
            tokens, labels, mask, task = _batch(next(data_iter), dev)
            state, m = self.step(state, tokens, labels, mask, task,
                                 generator=gen)
            if i % log_every == 0 or i == steps - 1:
                rec = {k: v.cpu().numpy().tolist() for k, v in m.items()}
                rec["step"] = i
                history.append(rec)
                log_fn(f"[router {i:5d}] loss={rec['loss']:.4f} "
                       f"ce={rec['ce']:.4f} msr={rec['soft_msr']:.3f} "
                       f"tau={rec['tau']:.2f}")
        return state, history


# ---------------------------------------------------------------------------
# Backbone pretraining (substrate for the accuracy benches)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PretrainTrainer:
    cfg: ModelConfig
    total_steps: int
    lr: float = 3e-4
    weight_decay: float = 0.1
    moe_balance_coef: float = 0.01
    flux_soft: bool = False  # joint backbone + router training if True

    def init(self, params):
        return {"params": params, "opt": OPT.adamw_init(params),
                "step": torch.zeros((), dtype=torch.int32)}

    def loss_and_grads(self, state, tokens, labels, loss_mask, *,
                       gumbel=None, generator=None):
        params, leaves = _with_grad(state["params"])
        out = MD.forward_train(params, self.cfg, tokens, gumbel=gumbel,
                               generator=generator, flux_soft=self.flux_soft,
                               tau=1.0)
        ce = cross_entropy(out.logits, labels, loss_mask)
        bal = _sum_aux(out.aux, "moe_balance", ce.device)
        loss = ce + self.moe_balance_coef * bal
        grads = _grads(loss, leaves)
        return (loss.detach(), {"ce": ce.detach(), "bal": bal.detach()},
                _regrad(state["params"], grads))

    def step(self, state, tokens, labels, loss_mask, *, gumbel=None,
             generator=None):
        loss, metrics, grads = self.loss_and_grads(
            state, tokens, labels, loss_mask, gumbel=gumbel,
            generator=generator)
        return self.update(state, loss, metrics, grads)

    def update(self, state, loss, metrics, grads):
        lr = OPT.cosine_warmup(self.lr, self.total_steps, 0.05)(
            state["step"])
        metrics = dict(metrics)
        new_params, opt = OPT.adamw_update(
            grads, state["opt"], state["params"], lr=lr,
            weight_decay=self.weight_decay)
        metrics["loss"] = loss
        return ({"params": new_params, "opt": opt,
                 "step": state["step"] + 1}, metrics)

    def run(self, state, data_iter, steps: int, log_every: int = 50,
            seed: int = 0, log_fn=print):
        dev = _device(state["params"])
        gen = torch.Generator(device=dev).manual_seed(seed)
        history = []
        for i in range(steps):
            tokens, labels, mask, _ = _batch(next(data_iter), dev)
            state, m = self.step(state, tokens, labels, mask, generator=gen)
            if i % log_every == 0 or i == steps - 1:
                rec = {k: float(v) for k, v in m.items()}
                rec["step"] = i
                history.append(rec)
                log_fn(f"[pretrain {i:5d}] loss={rec['loss']:.4f} "
                       f"ce={rec['ce']:.4f}")
        return state, history


# ---------------------------------------------------------------------------
# Continued training with a frozen router (paper §5.3)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ContinuedTrainer:
    """The backbone adapts to the router's (fixed) sparse pathways."""
    cfg: ModelConfig
    total_steps: int
    lr: float = 1e-4

    def init(self, params):
        mask = MD.router_param_filter(params)
        router, backbone = OPT.partition(params, mask)
        return {"backbone": backbone, "router": router,
                "opt": OPT.adamw_init(backbone),
                "step": torch.zeros((), dtype=torch.int32)}

    def loss_and_grads(self, state, tokens, labels, loss_mask, *,
                       gumbel=None, generator=None):
        backbone, leaves = _with_grad(state["backbone"])
        params = OPT.combine(state["router"], backbone)
        # router frozen; routing still soft at a fixed low tau so the
        # learned allocation shapes the gradients
        out = MD.forward_train(params, self.cfg, tokens, gumbel=gumbel,
                               generator=generator,
                               tau=self.cfg.flux.tau_end)
        ce = cross_entropy(out.logits, labels, loss_mask)
        grads = _grads(ce, leaves)
        return ce.detach(), {"ce": ce.detach()}, _regrad(
            state["backbone"], grads)

    def step(self, state, tokens, labels, loss_mask, *, gumbel=None,
             generator=None):
        _, metrics, grads = self.loss_and_grads(
            state, tokens, labels, loss_mask, gumbel=gumbel,
            generator=generator)
        return self.update(state, metrics, grads)

    def update(self, state, metrics, grads):
        lr = OPT.cosine_warmup(self.lr, self.total_steps, 0.1)(
            state["step"])
        new_backbone, opt = OPT.adamw_update(
            grads, state["opt"], state["backbone"], lr=lr)
        return ({"backbone": new_backbone, "router": state["router"],
                 "opt": opt, "step": state["step"] + 1}, metrics)

    def params(self, state):
        return OPT.combine(state["router"], state["backbone"])
