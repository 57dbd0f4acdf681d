"""Serving launcher: batched or continuous requests through the port's
engine (port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch phi3-mini-3.8b --smoke --requests 2 --prompt-len 96 \\
        --gen-len 8 --prefill-chunk 32 --device cpu

    # full width on the GPU (seeded random weights)
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch phi3-mini-3.8b --requests 4 --prompt-len 4096 \\
        --gen-len 32 --prefill-chunk 512

    # continuous batching: Poisson arrivals into the slot pool, prompt
    # lengths prompt_len // (1 + rid % 3)
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch phi3-mini-3.8b --continuous --requests 8 \\
        --prompt-len 4096 --gen-len 32 --slots 4 --chunk 8

Prompts are random tokens from a numpy generator seeded with 0; weights
are drawn from a ``torch.Generator`` seeded with 0. The decode caches hold
prompt + generated tokens. Prints one JSON line per request (tokens,
routing and times), then each kernel's launch count (0 on the CPU, where
the kernels' plain versions run); ``--continuous`` adds TTFT, queue
delay, decode tokens/s and preemptions per request, and a totals line
with the number of cache geometries. ``--profile`` then serves the
requests again under ``torch.profiler`` (batch mode: the first bucket's
admission alone, then the whole batch) and prints where the time went:
the device's busy share of the wall time and the operators with the most
device (or, on the CPU, host) time.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ALL_ARCHS, get_config, smoke_variant
from repro_torch.kernels import _build, launch_counts, reset_launch_counts
from repro_torch.models.model import init_params
from repro_torch.serve.engine import (Request, ServeEngine,
                                      serve_batch_finished)
from repro_torch.serve.scheduler import STATUS_OK, ContinuousScheduler

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
    and the kernels with the most time; only device activity is traced,
    which keeps the profiler's own host cost off the host-bound decode
    loop. On the CPU: the operators with the most host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
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


def profile_batch(engine, reqs, device, top: int = 40) -> dict:
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


# prefill chunks streamed per tick: with 1, a prompt of several chunks
# takes as many ticks to stream while a resident request leaves after
# gen_len / chunk ticks, so at 4096-token prompts, 32 new tokens and
# chunks of 8 a pool of 4 never fills
PREFILL_CHUNKS_PER_TICK = 16


def serve_continuous(engine, reqs, *, slots: int, chunk: int,
                     mean_gap: float):
    """Submit ``reqs`` to a fresh slot-pool scheduler at Poisson arrival
    times (mean gap ``mean_gap`` s, numpy generator seeded with 1) and
    tick until all have retired. Returns (finished by rid, wall s,
    scheduler)."""
    # a scheduler registers with its engine: engine.submit / step use it
    sched = ContinuousScheduler(
        engine, slots_per_bucket=slots, chunk=chunk,
        prefill_chunks_per_tick=PREFILL_CHUNKS_PER_TICK)
    arrivals = np.cumsum(np.random.default_rng(1).exponential(
        mean_gap, len(reqs)))
    t0 = time.monotonic()
    pending, done = list(reqs), {}
    while pending or sched.waiting or sched.n_active():
        now = time.monotonic() - t0
        while pending and arrivals[len(reqs) - len(pending)] <= now:
            engine.submit(pending.pop(0))
        if sched.waiting or sched.n_active():
            for f in engine.step():
                done[f.rid] = f
        elif pending:  # idle until the next arrival
            time.sleep(min(max(arrivals[len(reqs) - len(pending)] - now,
                               0.0), 0.05))
    return done, time.monotonic() - t0, sched


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
    ap.add_argument("--continuous", action="store_true",
                    help="slot-pool continuous batching instead of "
                         "bucketed batches")
    ap.add_argument("--slots", type=int, default=4,
                    help="slots per geometry pool (--continuous)")
    ap.add_argument("--chunk", type=int, default=8,
                    help="decode steps per tick (--continuous)")
    ap.add_argument("--mean-gap", type=float, default=0.02,
                    help="mean Poisson inter-arrival gap in seconds "
                         "(--continuous)")
    ap.add_argument("--profile", action="store_true",
                    help="serve the requests again under torch.profiler")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda":
        _build.build()  # every kernel now, one nvcc each, side by side
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
    lens = [args.prompt_len // (1 + i % 3) if args.continuous
            else args.prompt_len for i in range(args.requests)]
    reqs = [Request(rid=i, tokens=rng.integers(0, cfg.vocab_size, n),
                    n_steps=args.gen_len, routing_override=override)
            for i, n in enumerate(lens)]
    reset_launch_counts()
    if args.continuous:
        _continuous_main(engine, reqs, args, device)
        return
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


def _continuous_main(engine, reqs, args, device) -> None:
    def run():
        return serve_continuous(engine, reqs, slots=args.slots,
                                chunk=args.chunk, mean_gap=args.mean_gap)

    done, wall, sched = run()
    total = 0
    for rid in sorted(done):
        f, m = done[rid], done[rid].metrics
        total += m.n_generated
        print(json.dumps({
            "rid": rid, "status": f.status, "prompt_len": m.prompt_len,
            "tokens": f.tokens.tolist(),
            "routing": "".join(p[0] for p in f.routing),
            "ttft_s": round(m.ttft, 4),
            "queue_delay_s": round(m.queue_delay, 4),
            "decode_tok_s": round(m.decode_tps, 2),
            "preemptions": m.preemptions}))
    n_ok = sum(f.status == STATUS_OK for f in done.values())
    print(json.dumps({
        "device": str(device), "requests": len(done), "ok": n_ok,
        "tokens": total, "wall_s": round(wall, 3),
        "tok_s": round(total / wall, 2),
        "geometries": sched.n_geometries(), "ticks": sched.ticks,
        "launches": launch_counts()}))
    if args.profile:
        print(json.dumps({"profile": {"continuous": _profiled(
            run, device, 40)}}))


if __name__ == "__main__":
    main()
