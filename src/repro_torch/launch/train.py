"""Training launcher (port of ``repro/launch/train.py``).

Runs the paper's router-training recipe end to end: a frozen backbone,
Gumbel soft routing, the Lagrangian sparsity loss and the annealed
temperature, on the synthetic task mixture (``data/synthetic.py``). It
runs on cuda unless ``--device cpu`` is given. Examples:

    # the smoke config on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch phi3-mini-3.8b --smoke --device cpu --steps 4 --batch 2 \\
        --seq 96 --out artifacts/train
    # full width and depth on the card (bf16 weights from the seed)
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch phi3-mini-3.8b --steps 300 --batch 2 --seq 4096

Writes ``<out>/<name>.pt`` (the trained parameters, ``train.checkpoint``)
and ``<out>/<name>_history.json``. An arch with no routable layer skips
router training.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import ALL_ARCHS, get_config, smoke_variant
from repro_torch.data import mixture_iterator
from repro_torch.models.model import init_params
from repro_torch.train import PretrainTrainer, RouterTrainer, checkpoint


def router_training(cfg, params, data, *, steps: int,
                    total_steps: Optional[int] = None, seed: int = 0,
                    log_every: int = 50, log_fn=print):
    """``steps`` RouterTrainer steps of a ``total_steps`` schedule (default
    ``steps``) from ``params`` over the batches of ``data``: λ drawn from
    a CPU generator seeded ``seed + 1`` (the same values on any device),
    the Gumbel noise from one seeded 0 on the parameters' device.
    Returns (trainer, final state, history)."""
    rt = RouterTrainer(cfg, total_steps=total_steps or steps)
    state = rt.init(params, torch.Generator().manual_seed(seed + 1))
    state, history = rt.run(state, data, steps, log_every=log_every,
                            log_fn=log_fn)
    return rt, state, history


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ALL_ARCHS, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--pretrain-steps", type=int, default=0,
                    help="backbone pretraining steps before router "
                         "training (0 = random backbone)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="artifacts/train")
    ap.add_argument("--load", default=None,
                    help="checkpoint to initialize the backbone from")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    params = init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    if args.load:
        params = checkpoint.load(args.load, params)
    data = mixture_iterator(cfg.vocab_size, args.batch, args.seq,
                            seed=args.seed)

    history = {}
    if args.pretrain_steps:
        pt = PretrainTrainer(cfg, total_steps=args.pretrain_steps)
        st = pt.init(params)
        st, history["pretrain"] = pt.run(st, data, args.pretrain_steps)
        params = st["params"]

    if cfg.routable_layers() and cfg.flux.enabled:
        rt, state, history["router"] = router_training(
            cfg, params, data, steps=args.steps, seed=args.seed)
        params = rt.params(state)
    else:
        print(f"{cfg.name}: no routable attention layers — router "
              "training skipped (DESIGN.md §Arch-applicability)")

    os.makedirs(args.out, exist_ok=True)
    ck = os.path.join(args.out, f"{cfg.name}.pt")
    checkpoint.save(ck, params)
    with open(os.path.join(args.out, f"{cfg.name}_history.json"), "w") as f:
        json.dump(history, f, indent=2)
    print(f"saved {ck}")


if __name__ == "__main__":
    main()
