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

    # deepseek-v2-236b (MLA, 160 experts) at full width; its 60 layers
    # are 472 GB in bf16, so --layers cuts the depth to what one card holds
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-v2-236b --layers 4 --requests 4 \\
        --prompt-len 4096 --gen-len 32 --prefill-chunk 512

    # mamba2-780m (Mamba2 SSD in every layer, no attention kernel), and
    # jamba's hybrid period on the CPU (its 398 B parameters need more
    # than one card)
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch mamba2-780m --requests 4 --prompt-len 4096 \\
        --gen-len 32 --prefill-chunk 512
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch jamba-1.5-large-398b --smoke --device cpu --requests 2 \\
        --prompt-len 96 --gen-len 8 --prefill-chunk 32

    # gemma3-12b: 40 sliding-window (local) layers, never routed, and 8
    # routed global layers; head dim 256
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch gemma3-12b --requests 4 --prompt-len 4096 \\
        --gen-len 32 --prefill-chunk 512

    # tensor-parallel serving: 2 ranks (processes), each with half of the
    # heads, KV heads and FFN width; on the CPU over gloo, on one card
    # over gloo (NCCL refuses two ranks on one device), on 2 cards over
    # nccl
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke \\
        --device cpu --requests 2 --prompt-len 96 --gen-len 8 \\
        --prefill-chunk 32 --mesh-model 2 --dist-backend gloo
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch command-r-plus-104b --requests 4 --prompt-len 4096 \\
        --gen-len 32 --mesh-model 4 --dist-backend nccl

    # shared-system-prompt traffic through the prefix cache: every
    # prompt opens with the same 2048 tokens; snapshots up to 8 GiB on
    # the card and 8 GiB in pinned host memory
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch phi3-mini-3.8b --continuous --requests 8 \\
        --prompt-len 2048 --gen-len 32 --shared-prefix 2048 \\
        --prefix-cache-mb 8192 --prefix-cache-host-mb 8192

Prompts are random tokens from a numpy generator seeded with 0
(``--shared-prefix``'s preamble from one seeded with 2); weights are drawn
from a ``torch.Generator`` seeded with 0. The decode caches hold shared
prefix + prompt + generated tokens. Prints one JSON line per request (tokens,
routing as one letter a layer, "-" at a Mamba layer, and times), then
each kernel's launch count (0 on the CPU, where
the kernels' plain versions run); ``--continuous`` adds TTFT, queue
delay, decode tokens/s and preemptions per request, and a totals line
with the number of cache geometries. With ``--prefix-cache-mb`` each
request's line gives its ``prefix_hit_tokens``, and a last line sums up
the store: hits, misses, the prompt tokens served warm and each tier's
bytes. ``--profile`` then serves the requests again under
``torch.profiler`` (batch mode: the first bucket's admission alone, then
the whole batch) and prints where the time went: the device's busy share
of the wall time and the PROFILE_TOP operators with the most device (or,
on the CPU, host) time.

Guardrails (``serve/slo.py``), all off by default: ``--max-queue`` and
``--shed-policy`` bound the waiting queue, ``--deadline-s`` gives every
request a deadline, ``--preemption-budget`` and ``--aging-s`` bound
preemption and starvation, ``--adaptive-sparsity`` turns the load →
sparsity dial on. Observability: ``--metrics-out m.prom`` and
``--trace-out t.json`` write the Prometheus text and the Perfetto trace
(request spans exist on the ``--continuous`` path); validate them with
``python -m repro_torch.serve.telemetry m.prom`` and ``python -m
repro_torch.serve.tracing t.json``. ``--profile-every N`` samples every
Nth tick for the cost profiler, ``--fidelity-probe-every N`` probes every
Nth admission's attention-mass coverage, and ``--ledger-out l.json``
writes the memory ledger's reconciled report.

``--mesh-model N`` (the JAX launcher's name) serves tensor-parallel on N
ranks (``distributed/group.py`` ``launch``, one process a rank) over
``--dist-backend`` (nccl or gloo, the caller's choice): each rank draws
the seeded weights layer by layer and keeps its share
(``init_params_tp``); on the card rank 0 builds the kernels before the
others load them. Only rank 0 prints and writes files; a rank that fails
fails the run. Every arch the one-device path serves serves here, with
``--routing duo`` and ``--fidelity-probe-every`` too; a GQA model whose
KV heads N divides is served with each KV head replicated on N / Hkv
ranks (``distributed/sharding.py``), and one whose KV heads neither
divide by N nor divide N is refused (ValueError naming both counts).

``--routing duo`` is the DuoAttention baseline: ``("duo", n)`` at every
attention layer, the first ``--duo-heads`` n KV heads of the model on
full attention in the decode and the rest on sink + local (the batch
path only: the slot pool refuses head splits).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ALL_ARCHS, get_config, smoke_variant
from repro_torch.distributed.group import BACKENDS, launch
from repro_torch.distributed.sharding import init_params_tp
from repro_torch.kernels import _build, launch_counts, reset_launch_counts
from repro_torch.models.model import init_params
from repro_torch.serve.engine import (Request, ServeEngine,
                                      serve_batch_finished)
from repro_torch.serve.scheduler import ContinuousScheduler
from repro_torch.serve.slo import (SHED_POLICIES, SHED_REJECT_NEWEST,
                                   STATUS_OK, SLOConfig)

ROUTINGS = ("router", "fa", "sa", "mixed")
# ``--routing``'s choices: the routings above and the DuoAttention head
# split, which the slot pool refuses
ROUTING_CHOICES = ROUTINGS + ("duo",)


def routing_pattern(cfg, routing: str, duo_heads: int = 1):
    """The routing override of a ``--routing`` choice: None lets the
    router decide; "mixed" alternates FA and SA over the layers; "duo"
    is ``("duo", duo_heads)`` at every layer."""
    if routing == "router":
        return None
    if routing == "mixed":
        return tuple("fa" if i % 2 == 0 else "sa"
                     for i in range(cfg.num_layers))
    if routing == "duo":
        return (("duo", int(duo_heads)),) * cfg.num_layers
    return (routing,) * cfg.num_layers


def routing_letters(pattern) -> str:
    """A routing pattern as one letter a layer: f(a), s(a), d(uo), or
    "-" at a layer that is not routed (a Mamba layer)."""
    return "".join("-" if p is None else p[0] if isinstance(p, str)
                   else p[0][0] for p in pattern)


# operators --profile lists, most time first: enough to reach a kernel of
# a few ms beside deepseek's ≈ 1.4 s of serve_batch (the latent decode)
PROFILE_TOP = 200


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


def profile_batch(engine, reqs, device, top: int = PROFILE_TOP) -> dict:
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
    tick until all have retired. Arrivals go by the scheduler's clock
    (under tensor parallelism rank 0's, so every rank submits alike).
    Returns (finished by rid, wall s, scheduler)."""
    # a scheduler registers with its engine: engine.submit / step use it
    sched = ContinuousScheduler(
        engine, slots_per_bucket=slots, chunk=chunk,
        prefill_chunks_per_tick=PREFILL_CHUNKS_PER_TICK, slo=engine.slo)
    arrivals = np.cumsum(np.random.default_rng(1).exponential(
        mean_gap, len(reqs)))
    clock = sched.clock
    t0 = clock()
    pending, done = list(reqs), {}
    while pending or sched.waiting or sched.n_active():
        now = clock() - t0
        while pending and arrivals[len(reqs) - len(pending)] <= now:
            engine.submit(pending.pop(0))
        if sched.waiting or sched.n_active():
            for f in engine.step():
                done[f.rid] = f
        elif pending:  # idle until the next arrival
            time.sleep(min(max(arrivals[len(reqs) - len(pending)] - now,
                               0.0), 0.05))
    return done, clock() - t0, sched


def print_prefix_cache(engine, hits, reqs) -> None:
    """The prefix store's summary line (nothing without a store): hits
    and misses, prompt tokens served warm (``hits``: rid → tokens) and
    each tier's bytes."""
    store = engine.prefix_store
    if store is None:
        return
    s = store.stats()
    hit = sum(hits.values())
    prompt = sum(len(r.tokens) for r in reqs)
    print(f"prefix cache: {s.hits} hits / {s.misses} misses | "
          f"{hit}/{prompt} prompt tokens warm ({hit / max(prompt, 1):.0%})"
          f" | device={s.device_bytes} B host={s.host_bytes} B "
          f"snapshots={s.snapshots} demotions={s.demotions} "
          f"drops={s.drops}")


def write_telemetry(engine, args) -> None:
    """Export the run's telemetry to the paths the flags named, and
    print the profiler's table (nothing when no flag asked)."""
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(engine.metrics_text())
        print(f"metrics → {args.metrics_out}")
    if args.trace_out:
        engine.export_trace(args.trace_out)
        print(f"trace   → {args.trace_out} "
              f"(open in https://ui.perfetto.dev)")
    if args.profile_every:
        rep = engine.profiler_report()
        print(f"profiler on {engine.device}: {rep['sampled_ticks']} "
              f"sampled ticks (every {rep['every']})")
        for ph in rep["phases"]:
            print(f"  {ph['phase']:>14}: host={ph['host_s'] * 1e3:8.2f}ms "
                  f"device={ph['device_s'] * 1e3:8.2f}ms "
                  f"achieved={ph['achieved_gflops_per_s']:7.1f} GFLOP/s "
                  f"{ph['achieved_gbytes_per_s']:6.1f} GB/s "
                  f"n={ph['count']}")
    if args.ledger_out:
        rep = engine.attribution_report()
        with open(args.ledger_out, "w") as f:
            json.dump(rep, f, indent=2)
        snap = rep["ledger"]["snapshot"]
        if snap is None:
            print(f"ledger  → {args.ledger_out} (no tick snapshots; use "
                  f"--continuous for the per-tick ledger)")
        else:
            recon = rep["ledger"]["reconciliation"]
            print(f"ledger  → {args.ledger_out} | "
                  f"device={snap['device_bytes']} B "
                  f"hwm={snap['device_high_watermark_bytes']} B "
                  f"frag={snap['fragmentation_bytes']} B | reconciliation "
                  f"payload_delta={recon['payload_delta']} "
                  f"overhead_delta={recon['overhead_delta']} "
                  f"(aux={rep['ledger']['aux_bytes']})")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="phi3-mini-3.8b", choices=ALL_ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced smoke config (2 layers, d_model 256)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model's depth to this many layers, at "
                         "full width (0 = all)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=512,
                    help="largest prefill chunk; 0 = monolithic prefill")
    ap.add_argument("--routing", choices=ROUTING_CHOICES, default="router",
                    help="router-driven, or a forced FA/SA/mixed pattern, "
                         "or the DuoAttention head split (duo)")
    ap.add_argument("--duo-heads", type=int, default=1,
                    help="--routing duo: the model's KV heads on full "
                         "attention at every layer")
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
    ap.add_argument("--prefix-cache-mb", type=float, default=0.0,
                    help="device budget (MB) of the shared-prefix snapshot "
                         "store; 0 disables prefix reuse")
    ap.add_argument("--prefix-cache-host-mb", type=float, default=0.0,
                    help="pinned host tier budget (MB): evicted snapshots "
                         "demote to it instead of dropping")
    ap.add_argument("--no-prefix-reuse", action="store_true",
                    help="submit requests opted out of prefix reuse (the "
                         "store stays configured but untouched)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend a shared system prompt of this many "
                         "tokens to every request")
    ap.add_argument("--profile", action="store_true",
                    help="serve the requests again under torch.profiler")
    # SLO guardrails (serve/slo.py); all off by default
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bound on the waiting queue; overflow is shed "
                         "per --shed-policy (0 = unbounded)")
    ap.add_argument("--shed-policy", choices=SHED_POLICIES,
                    default=SHED_REJECT_NEWEST,
                    help="whom a full queue rejects")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="default per-request deadline in seconds; "
                         "expired work retires with status 'timeout' "
                         "(0 = no deadline)")
    ap.add_argument("--preemption-budget", type=int, default=-1,
                    help="max recompute preemptions per request before "
                         "it keeps its slot (-1 = unbudgeted)")
    ap.add_argument("--aging-s", type=float, default=0.0,
                    help="waiting seconds per +1 admission priority "
                         "(0 = no aging)")
    ap.add_argument("--adaptive-sparsity", action="store_true",
                    help="bias Layer Router decisions toward SA under "
                         "queue pressure (load-adaptive sparsity dial)")
    # telemetry; either flag turns it on
    ap.add_argument("--metrics-out", default=None,
                    help="write the run's metrics here as Prometheus text")
    ap.add_argument("--trace-out", default=None,
                    help="write the request-span Chrome-trace / Perfetto "
                         "JSON here (open in https://ui.perfetto.dev)")
    ap.add_argument("--profile-every", type=int, default=0,
                    help="sample every Nth scheduler tick for the host / "
                         "device cost profiler (device syncs on sampled "
                         "ticks only; 0 = off)")
    ap.add_argument("--fidelity-probe-every", type=int, default=0,
                    help="probe every Nth admission's attention-mass "
                         "coverage per routed layer (0 = off)")
    ap.add_argument("--ledger-out", default=None,
                    help="turn the memory ledger on and write its "
                         "reconciled report (with the profiler table when "
                         "--profile-every is set) here as JSON")
    # tensor parallelism
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="tensor-parallel ranks (one process each), each "
                         "holding 1/N of the heads and FFN width")
    ap.add_argument("--dist-backend", choices=BACKENDS, default=None,
                    help="the ranks' collective backend: nccl (a card a "
                         "rank) or gloo (the CPU, or ranks sharing a card)")
    args = ap.parse_args(argv)
    if args.mesh_model < 1:
        ap.error("--mesh-model must be >= 1")
    if args.mesh_model == 1:
        serve(args)
        return
    if args.dist_backend is None:
        ap.error("--mesh-model N > 1 needs --dist-backend nccl or gloo")
    launch(_serve_rank, args.mesh_model, args.dist_backend, args=(args,),
           device=args.device)


def _serve_rank(group, args) -> None:
    """One rank of ``--mesh-model``: serve, printing on rank 0 only."""
    if group.rank == 0:
        serve(args, group)
        return
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        serve(args, group)


def serve(args, tp=None) -> None:
    """Serve ``args``' requests on one device, or as rank ``tp.rank`` of
    a tensor-parallel group (files written by rank 0 only)."""
    device = resolve_device(args.device) if tp is None else tp.device
    if device.type == "cuda":
        if tp is None or tp.rank == 0:
            _build.build()  # every kernel now, one nvcc each, side by side
        if tp is not None:
            tp.barrier()  # the other ranks load rank 0's libraries
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    gen = torch.Generator(device=device).manual_seed(0)
    params = (init_params(cfg, gen, device) if tp is None
              else init_params_tp(cfg, gen, tp.rank, tp.world, device))
    engine = ServeEngine(
        params, cfg,
        max_len=args.shared_prefix + args.prompt_len + args.gen_len,
        prefill_chunk=args.prefill_chunk or None,
        prefix_cache_mb=args.prefix_cache_mb or None,
        prefix_cache_host_mb=args.prefix_cache_host_mb,
        slo=SLOConfig(
            max_queue=args.max_queue or None, shed_policy=args.shed_policy,
            default_deadline_s=args.deadline_s or None,
            preemption_budget=(None if args.preemption_budget < 0
                               else args.preemption_budget),
            aging_s=args.aging_s or None,
            adaptive_sparsity=args.adaptive_sparsity),
        telemetry=bool(args.metrics_out or args.trace_out),
        profile_every=args.profile_every,
        fidelity_probe_every=args.fidelity_probe_every,
        memory_ledger=bool(args.ledger_out), device=device, tp=tp)
    writer = tp is None or tp.rank == 0
    rng = np.random.default_rng(0)
    shared = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                               args.shared_prefix)
    override = routing_pattern(cfg, args.routing, args.duo_heads)
    lens = [args.prompt_len // (1 + i % 3) if args.continuous
            else args.prompt_len for i in range(args.requests)]
    reqs = [Request(rid=i, tokens=np.concatenate(
                        [shared, rng.integers(0, cfg.vocab_size, n)]),
                    n_steps=args.gen_len, routing_override=override,
                    prefix_reuse=not args.no_prefix_reuse)
            for i, n in enumerate(lens)]
    reset_launch_counts()
    if args.continuous:
        _continuous_main(engine, reqs, args, device)
        if writer:
            write_telemetry(engine, args)
        return
    done = serve_batch_finished(engine, reqs)
    for rid in sorted(done):
        f = done[rid]
        line = {"rid": rid, "status": f.status, "tokens": f.tokens.tolist()}
        if f.result is not None:  # its bucket ran
            line.update(
                routing=routing_letters(f.routing),
                msr=f.result.msr, wall_s=round(f.wall_s, 4),
                prefill_s=round(f.result.prefill_s, 4),
                decode_s=round(f.result.decode_s, 4),
                kv_bytes=f.result.kv_bytes,
                prefix_hit_tokens=f.result.prefix_hit_tokens)
        print(json.dumps(line))
    print(json.dumps({"device": str(device), "launches": launch_counts()}))
    print_prefix_cache(engine, {rid: f.result.prefix_hit_tokens
                                for rid, f in done.items()
                                if f.result is not None}, reqs)
    if args.profile:
        print(json.dumps({"profile": profile_batch(engine, reqs, device)}))
    if writer:
        write_telemetry(engine, args)


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
            "routing": (routing_letters(f.routing)
                        if f.routing is not None else None),
            "ttft_s": round(m.ttft, 4),
            "queue_delay_s": round(m.queue_delay, 4),
            "decode_tok_s": round(m.decode_tps, 2),
            "preemptions": m.preemptions,
            "prefix_hit_tokens": m.prefix_hit_tokens}))
    n_ok = sum(f.status == STATUS_OK for f in done.values())
    print(json.dumps({
        "device": str(device), "requests": len(done), "ok": n_ok,
        "tokens": total, "wall_s": round(wall, 3),
        "tok_s": round(total / wall, 2),
        "geometries": sched.n_geometries(), "ticks": sched.ticks,
        "launches": launch_counts()}))
    print_prefix_cache(engine, {rid: f.metrics.prefix_hit_tokens
                                for rid, f in done.items()}, reqs)
    if args.profile:
        print(json.dumps({"profile": {"continuous": _profiled(
            run, device, PROFILE_TOP)}}))


if __name__ == "__main__":
    main()
