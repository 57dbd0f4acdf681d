"""Serving launcher: a batch of requests through the port's engine
(port of the batch half of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch phi3-mini-3.8b --smoke --requests 2 --prompt-len 96 \\
        --gen-len 8 --prefill-chunk 32 --device cpu

    # full width on the GPU (seeded random weights)
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch phi3-mini-3.8b --requests 4 --prompt-len 4096 \\
        --gen-len 32 --prefill-chunk 512

Prompts are random tokens from a numpy generator seeded with 0; weights
are drawn from a ``torch.Generator`` seeded with 0. The decode caches hold
prompt + generated tokens. Prints each request's tokens,
routing and wall time, then each kernel's launch count (0 on the CPU,
where the kernels' plain versions run). ``--profile`` then runs the first
bucket's admission alone and the whole batch again under
``torch.profiler`` and prints where the time went: the device's busy
share of the wall time and the operators with the most device (or, on
the CPU, host) time.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ALL_ARCHS, get_config, smoke_variant
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models.model import init_params
from repro_torch.serve.engine import (Request, ServeEngine,
                                      serve_batch_finished)

ROUTINGS = ("router", "fa", "sa", "mixed")


def routing_pattern(cfg, routing: str):
    """The routing override of a ``--routing`` choice: None lets the
    router decide; "mixed" alternates FA and SA over the layers."""
    if routing == "router":
        return None
    if routing == "mixed":
        return tuple("fa" if i % 2 == 0 else "sa"
                     for i in range(cfg.num_layers))
    return (routing,) * cfg.num_layers


def _profiled(fn, device, top: int) -> dict:
    """Run ``fn`` under torch.profiler. On cuda: the device's busy time
    (the sum of its kernels' times; one stream, so they never overlap)
    and the kernels with the most time. On the CPU: the operators with
    the most host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    if cuda:
        rows = [e for e in rows if e.device_type == DeviceType.CUDA]
        key = "self_device_time_total"
    else:
        key = "self_cpu_time_total"
    rows = sorted(rows, key=lambda e: -getattr(e, key))
    busy_s = sum(getattr(e, key) for e in rows) / 1e6 if cuda else None
    return {
        "wall_s": wall, "device_busy_s": busy_s,
        "device_busy_share": busy_s / wall if cuda else None,
        "top": [{"name": e.key[:120], "calls": e.count,
                 "ms": getattr(e, key) / 1e3} for e in rows[:top]],
    }


def profile_batch(engine, reqs, device, top: int = 15) -> dict:
    """Profile the batch's admission alone (the chunked prefill of the
    first bucket's prompts) and then the whole ``serve_batch``; the
    difference is the decode."""
    toks = np.stack([r.tokens for r in reqs
                     if r.routing_override == reqs[0].routing_override
                     and len(r.tokens) == len(reqs[0].tokens)])
    out = {}
    if engine.chunked_eligible(toks.shape[1], reqs[0].routing_override):
        out["prefill"] = _profiled(
            lambda: engine.prefill_chunked(toks, reqs[0].routing_override),
            device, top)
    out["serve_batch"] = _profiled(
        lambda: serve_batch_finished(engine, reqs), device, top)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="phi3-mini-3.8b", choices=ALL_ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced smoke config (2 layers, d_model 256)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=512,
                    help="largest prefill chunk; 0 = monolithic prefill")
    ap.add_argument("--routing", choices=ROUTINGS, default="router",
                    help="router-driven, or a forced FA/SA/mixed pattern")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--profile", action="store_true",
                    help="serve the batch again under torch.profiler")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device)
    engine = ServeEngine(params, cfg,
                         max_len=args.prompt_len + args.gen_len,
                         prefill_chunk=args.prefill_chunk or None,
                         device=device)
    rng = np.random.default_rng(0)
    override = routing_pattern(cfg, args.routing)
    reqs = [Request(rid=i,
                    tokens=rng.integers(0, cfg.vocab_size, args.prompt_len),
                    n_steps=args.gen_len, routing_override=override)
            for i in range(args.requests)]
    reset_launch_counts()
    done = serve_batch_finished(engine, reqs)
    for rid in sorted(done):
        f = done[rid]
        print(json.dumps({
            "rid": rid, "tokens": f.tokens.tolist(),
            "routing": "".join(p[0] for p in f.routing),
            "msr": f.result.msr, "wall_s": round(f.wall_s, 4),
            "prefill_s": round(f.result.prefill_s, 4),
            "decode_s": round(f.result.decode_s, 4),
            "kv_bytes": f.result.kv_bytes}))
    print(json.dumps({"device": str(device), "launches": launch_counts()}))
    if args.profile:
        print(json.dumps({"profile": profile_batch(engine, reqs, device)}))


if __name__ == "__main__":
    main()
