#!/usr/bin/env python3
"""Tensor-parallel serving over NCCL, one card a rank.

    python3 tp_smoke.py [--world N] [--out report.json]

Needs N cards of one host (default 4; ``chip_smoke.py`` phase 31 runs 2
ranks on one card over gloo instead). Builds the five serving kernels,
then:
  1. phi3-mini at 2 layers, fp32 (phase 31a's runs, ``tp_parity_runs``):
     ``generate`` and a preempting drain, router-driven and mixed, on N
     ranks over nccl equal the one-card port's: tokens, routing and
     statuses, logits within 1e-4 of the largest;
  2. command-r-plus-104b at full width, COMMAND_R_LAYERS layers, bf16,
     mixed routing: 2 x TP_LONG tokens and TP_LONG_GEN decode steps
     through ``generate`` on card 0 alone and on N ranks, their prefill
     and decode tok/s side by side, each rank's launches exact, and the
     first decode step where the two runs' tokens part (their bf16 sums
     are added in another order); then the same prompts under a duo
     override of ``chip_smoke.TP_DUO`` (3 of the 8 KV heads on full
     attention at every layer: at 4 ranks, 2 KV heads a rank, the split
     falls inside rank 1), the step where its tokens part, and a drain
     of the 2 prompts with the fidelity probe on every admission, each
     routed layer's coverage on one card and on the ranks side by side;
  3. command-r-plus-104b at full width and depth (64 layers, 208 GB of
     bf16 weights, which no one card holds) on N ranks, the same load:
     finite logits, exact launches, a decode step's all-reduces 2 x
     layers of (B, 1, d_model), per-rank peak memory and tok/s; then the
     drain without the probe and with it on every admission, twice each
     in turn (coverage finite and in [0, 1], the probe's all-reduces
     counted apart from the serving ones), tok/s and the time in the
     probes of each;
  4. deepseek-v2-236b (MLA, 160 experts) at full width, DEEPSEEK_LAYERS
     layers, as step 2: on card 0 alone and on N ranks (128 / N heads a
     rank in the latent decode, which reads the whole latent cache that
     every rank holds), the first decode step where the tokens part;
  5. one full-width period of jamba-1.5-large-398b (8 layers: 7 Mamba
     blocks, replicated, and one attention layer; MoE on the even layers;
     90.3 GB of bf16 weights, which no one card holds) on N ranks, as
     step 3: finite logits, exact launches, the reduce count by layer
     (``chip_smoke.tp_reduces``: 9 a step), per-rank weight bytes, peak
     memory and tok/s;
  6. sequence-sharded long-context decode (``ServeEngine(seq_shard=)``):
     phi3-mini-3.8b at full width and depth, bf16, mixed routing (16 FA
     and 16 SA layers), B = 1, chunk SEQ_CHUNK, whole weights on every
     rank and each FA cache cut along its sequence over the N ranks.
     (a) capacity SEQ_A[0], a SEQ_A[1]-token prompt and SEQ_GEN steps on
     card 0 alone (whole caches) and on N ranks: prefill and decode
     tok/s, the step where their tokens part, per-rank FA KV bytes (1/N
     of one card's); (b) the long_500k shape, capacity SEQ_B[0], a
     SEQ_B[1]-token prompt, on N ranks only (its FA caches, 103 GB, fit
     no card beside the weights): finite logits, exact launches (the
     partial decode and the rank merge once a FA layer a step), a decode
     step's gathers (one a FA layer of B·Hq·(D + 1) fp32) and no
     all-reduce, the prefill's broadcasts, per-rank weight, KV and peak
     bytes, prefill and decode tok/s.
``--steps`` picks the steps to run (default all).
Prints each card's name and power limit, one line a step, and one JSON
line of the numbers (without the per-layer coverage lists, which go to
``--out`` with the rest); exits non-zero on any failure, in any rank.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TP_LONG, TP_LONG_GEN = 4096, 32
# step 6: (capacity, prompt tokens) of (a) and of (b), the long_500k
# shape (repro/configs/base.py), its prefill chunk and decode steps
SEQ_A, SEQ_B, SEQ_CHUNK, SEQ_GEN = (65536, 65472), (524288, 524256), 8192, 32
SEQ_MIN_SEQ = 8192  # the shortest cache cut (JAX's min_seq)


def parity_rank(tp, prompts):
    """Step 1 on one rank."""
    import chip_smoke as CS
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import init_params_tp
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(CS.ARCH).replace(num_layers=2, dtype=torch.float32,
                                      param_dtype=torch.float32)
    params = init_params_tp(cfg, torch.Generator(
        device=tp.device).manual_seed(0), tp.rank, tp.world, tp.device)
    return CS.tp_parity_runs(tp.device, params, cfg, prompts, tp)


def extras(arch, layers):
    """What steps 2 and 3 add to ``serve_long`` for command-r: the duo
    run (step 2) and the drains by probe dial (step 2: on; step 3: on
    and off)."""
    import chip_smoke as CS
    if arch != CS.COMMAND_R:
        return dict(duo=False, drains=())
    return (dict(duo=True, drains=(1,)) if layers
            else dict(duo=False, drains=(0, 1, 0, 1)))


def probe_drain(eng, cfg, prompts, every, tp):
    """A drain of ``prompts`` (B, TP_LONG) as B requests of TP_LONG_GEN
    steps into B slots under the mixed routing, on an engine over
    ``eng``'s weights with the fidelity probe on every ``every``-th
    admission (0: off). Exact launches (the probe adds one flash a layer
    a probe); the probe's all-reduces counted apart (2 a layer and one a
    routed layer a probe). Returns host results: tok/s, each probe's
    per-layer coverage, the reduce counts."""
    import chip_smoke as CS
    import repro_torch.kernels as KN
    from repro_torch.launch.serve import routing_pattern
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.scheduler import ContinuousScheduler
    B = prompts.shape[0]
    eng = ServeEngine(eng.params, cfg, max_len=eng.max_len,
                      prefill_chunk=CS.CHUNK, device=eng.device, tp=tp,
                      fidelity_probe_every=every)
    covs, probe_s = [], [0.0]
    probe = eng._maybe_fidelity_probe

    def recorded(*a, **k):  # each probe's per-layer coverage and time
        torch.cuda.synchronize()
        t = time.perf_counter()
        cov = probe(*a, **k)  # its coverage is read back: a sync
        probe_s[0] += time.perf_counter() - t
        if cov is not None:
            covs.append(cov.tolist())
        return cov
    eng._maybe_fidelity_probe = recorded
    sched = ContinuousScheduler(eng, slots_per_bucket=B, chunk=8,
                                prefill_chunks_per_tick=2)
    mixed = routing_pattern(cfg, "mixed")
    if tp is not None:
        tp.reset_counts()
    KN.reset_launch_counts()
    t0 = time.perf_counter()
    for rid in range(B):
        eng.submit(Request(rid=rid, tokens=prompts[rid],
                           n_steps=TP_LONG_GEN, routing_override=mixed))
    done = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert all(f.status == "ok" for f in done.values()), done
    want = CS.prefill_launches(cfg, sched.admissions)
    want.update(CS.decode_launches(cfg, sum(
        p.steps for p in sched.pools.values()), pooled=True))
    want["flash_attention"] += len(covs) * cfg.num_layers
    counts = KN.launch_counts()
    assert counts == want, (counts, want)
    assert len(covs) == (len(sched.admissions) if every else 0)
    for cov in covs:
        assert all(0.0 <= c <= 1.0 for c in cov), cov  # and finite
    out = dict(probe_every=every, wall_s=wall, probe_s=probe_s[0],
               tok_s=B * TP_LONG_GEN / wall, coverage=covs,
               tokens=[done[r].tokens.tolist() for r in range(B)])
    if tp is not None:
        per = 2 * cfg.num_layers + len(cfg.routable_layers())
        assert tp.probe_calls == len(covs) * per, tp.probe_calls
        out["all_reduces"] = dict(serving=tp.reduce_calls,
                                  probe=tp.probe_calls, probe_each=per)
    return out


def serve_long(dev, cfg, prompts, tp=None, duo=False, drains=()):
    """Steps 2 and 3: ``cfg``'s seeded weights (a rank's share under
    ``tp``), then ``generate`` of ``prompts`` under the mixed routing;
    with ``duo``, again under ``chip_smoke.TP_DUO`` at every layer; then
    a ``probe_drain`` at each dial of ``drains``. Returns host
    results."""
    import chip_smoke as CS
    import repro_torch.kernels as KN
    from repro_torch.distributed.sharding import (init_params_tp,
                                                  tensor_parallel)
    from repro_torch.launch.serve import routing_pattern
    from repro_torch.models import model as MD
    from repro_torch.serve.engine import ServeEngine
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = (MD.init_params(cfg, gen, dev) if tp is None else
              init_params_tp(cfg, gen, tp.rank, tp.world, dev))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = torch.cuda.memory_allocated(dev)
    eng = ServeEngine(params, cfg, max_len=TP_LONG + TP_LONG_GEN,
                      prefill_chunk=CS.CHUNK, device=dev, tp=tp)
    mixed = routing_pattern(cfg, "mixed")
    eng.generate(prompts[:, :CS.CHUNK], 2, routing_override=mixed)  # warm
    torch.cuda.reset_peak_memory_stats(dev)
    KN.reset_launch_counts()
    g = eng.generate(prompts, TP_LONG_GEN, routing_override=mixed)
    assert bool(torch.isfinite(g.logits).all()), "first logits"
    assert bool(torch.isfinite(g.final_logits).all()), "last logits"
    counts = KN.launch_counts()
    want = CS.prefill_launches(cfg, [(g.routing, TP_LONG, 0)])
    want.update(CS.decode_launches(cfg, TP_LONG_GEN, pooled=False))
    assert counts == want, (counts, want)
    B = prompts.shape[0]
    out = dict(init_s=init_s, weights_bytes=weights,
               peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
               prefill_s=g.prefill_s, decode_s=g.decode_s,
               prefill_tok_s=B * TP_LONG / g.prefill_s,
               decode_tok_s=B * TP_LONG_GEN / g.decode_s,
               tokens=g.tokens, launches=counts, kv_bytes=g.kv_bytes)
    if duo:
        KN.reset_launch_counts()
        d = eng.generate(prompts, TP_LONG_GEN,
                         routing_override=(CS.TP_DUO,) * cfg.num_layers)
        assert bool(torch.isfinite(d.final_logits).all()), "duo logits"
        counts = KN.launch_counts()
        # the repack's prefill runs full attention; the decode's head
        # split is plain torch
        want = CS.prefill_launches(cfg, [], repacks=[(
            ("fa",) * cfg.num_layers, TP_LONG)])
        want.update(CS.decode_launches(cfg, 0, pooled=False))
        assert counts == want, (counts, want)
        out["duo"] = dict(tokens=d.tokens, launches=counts,
                          decode_tok_s=B * TP_LONG_GEN / d.decode_s)
    if tp is not None:
        job = eng.prefill_chunked(prompts, mixed)
        tp.reset_counts()
        with tensor_parallel(tp):
            MD.decode_many(eng.params, eng.model_cfg, job.logits,
                           job.caches, TP_LONG, n_steps=4)
        calls, nbytes = tp.reduce_calls, tp.reduce_bytes
        assert calls == CS.tp_reduces(cfg) * 4, calls
        assert nbytes == calls * B * cfg.d_model * cfg.dtype.itemsize
        out["step_all_reduces"] = (calls // 4, nbytes // calls)
        del job
    out["drains"] = [probe_drain(eng, cfg, prompts, every, tp)
                     for every in drains]
    out["peak_mem_bytes_all"] = torch.cuda.max_memory_allocated(dev)
    return out


def long_rank(tp, prompts, arch, layers):
    """Steps 2-5 on one rank: ``arch`` at ``layers`` layers (0: its
    whole depth)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    return serve_long(tp.device, cfg, prompts, tp, **extras(arch, layers))


def _report(r):
    """A rank's or the one card's results without their tokens."""
    out = {k: v for k, v in r.items() if k != "tokens"}
    if "duo" in r:
        out["duo"] = {k: v for k, v in r["duo"].items() if k != "tokens"}
    out["drains"] = [{k: v for k, v in d.items() if k != "tokens"}
                     for d in r["drains"]]
    return out


def _without_coverage(tree):
    """``tree`` with every "coverage" list and per-layer pair list
    dropped (they run to a value a routed layer a probe)."""
    if isinstance(tree, dict):
        return {k: _without_coverage(v) for k, v in tree.items()
                if k not in ("coverage", "coverage_one_card_vs_ranks")}
    if isinstance(tree, list):
        return [_without_coverage(v) for v in tree]
    return tree


def _apart(a, b):
    """The first decode step where two (B, steps) token arrays part."""
    diff = np.flatnonzero((np.asarray(a) != np.asarray(b)).any(0))
    return int(diff[0]) if diff.size else None


def one_and_ranks(dev, world, arch, layers, prompts):
    """Steps 2 and 4: ``arch`` at ``layers`` layers on card 0 alone, then
    on ``world`` ranks over nccl. Returns (report entry, one card's
    results, rank 0's)."""
    import chip_smoke as CS
    from repro_torch.configs import get_config
    from repro_torch.distributed.group import launch
    alone = serve_long(dev, get_config(arch).replace(num_layers=layers),
                       prompts, **extras(arch, layers))
    CS.free_card()
    cut = launch(long_rank, world, "nccl", args=(prompts, arch, layers),
                 device="cuda")
    for r in cut:
        assert np.array_equal(r["tokens"], cut[0]["tokens"])
        if "duo" in r:
            assert np.array_equal(r["duo"]["tokens"],
                                  cut[0]["duo"]["tokens"])
        for d, d0 in zip(r["drains"], cut[0]["drains"]):
            assert d["tokens"] == d0["tokens"]
            assert d["coverage"] == d0["coverage"]  # every rank reads it
    entry = dict(layers=layers, one_card=_report(alone),
                 ranks=[_report(r) for r in cut],
                 first_token_step_apart=_apart(alone["tokens"],
                                               cut[0]["tokens"]))
    if "duo" in alone:
        entry["duo_first_token_step_apart"] = _apart(
            alone["duo"]["tokens"], cut[0]["duo"]["tokens"])
    for d1, dn in zip(alone["drains"], cut[0]["drains"]):
        if d1["coverage"]:
            entry["coverage_one_card_vs_ranks"] = [
                list(zip(a, b)) for a, b in zip(d1["coverage"],
                                                dn["coverage"])]
            entry["coverage_max_abs_diff"] = max(
                abs(x - y) for a, b in zip(d1["coverage"], dn["coverage"])
                for x, y in zip(a, b))
    return entry, alone, cut[0]


def long_steps(dev, world, report, steps=(2, 3, 4, 5)):
    """Steps 2-5 (those in ``steps``) into ``report``: each model on
    ``world`` ranks over nccl (steps 2 and 4 first on card 0 alone), 2 x
    TP_LONG tokens of seeded prompts (step 2's and 3's alike), mixed
    routing."""
    import chip_smoke as CS
    from repro_torch.configs import get_config
    from repro_torch.distributed.group import launch
    for step, arch, layers, key in (
            (2, CS.COMMAND_R, CS.COMMAND_R_LAYERS, "command_r_cut"),
            (3, CS.COMMAND_R, 0, "command_r_full"),
            (4, CS.DEEPSEEK, CS.DEEPSEEK_LAYERS, "deepseek_cut"),
            (5, CS.JAMBA, len(get_config(CS.JAMBA).layer_pattern),
             "jamba_period")):
        if step not in steps:
            continue
        t0 = time.perf_counter()
        seed = 12 if arch == CS.COMMAND_R else 12 + step
        prompts = np.random.default_rng(seed).integers(
            0, get_config(arch).vocab_size, (2, TP_LONG))
        if step in (2, 4):
            report[key], alone, cut = one_and_ranks(dev, world, arch,
                                                    layers, prompts)
            line = (f"step {step}: {arch} {layers} layers bf16, 2 x "
                    f"{TP_LONG} + {TP_LONG_GEN}: one card prefill "
                    f"{alone['prefill_tok_s']:.0f} tok/s decode "
                    f"{alone['decode_tok_s']:.1f} tok/s; {world} ranks "
                    f"prefill {cut['prefill_tok_s']:.0f} decode "
                    f"{cut['decode_tok_s']:.1f} (launches a rank "
                    f"{cut['launches']}); tokens apart from step "
                    f"{report[key]['first_token_step_apart']}")
            if "duo" in cut:
                line += (f"; duo {CS.TP_DUO}: decode one card "
                         f"{alone['duo']['decode_tok_s']:.1f} tok/s, "
                         f"{world} ranks {cut['duo']['decode_tok_s']:.1f}"
                         f", tokens apart from step "
                         f"{report[key]['duo_first_token_step_apart']}")
            if "coverage_one_card_vs_ranks" in report[key]:
                line += (f"; probe drain: coverage by routed layer (one "
                         f"card, ranks) "
                         f"{report[key]['coverage_one_card_vs_ranks']}, "
                         f"max diff "
                         f"{report[key]['coverage_max_abs_diff']:.2e}, "
                         f"probe all-reduces a rank "
                         f"{cut['drains'][0]['all_reduces']}")
            print(line + f" [{time.perf_counter() - t0:.1f} s]",
                  flush=True)
            continue
        full = launch(long_rank, world, "nccl", args=(prompts, arch, layers),
                      device="cuda")
        for r in full:
            assert np.array_equal(r["tokens"], full[0]["tokens"])
            for d, d0 in zip(r["drains"], full[0]["drains"]):
                assert d["tokens"] == d0["tokens"]
                assert d["coverage"] == d0["coverage"]
        report[key] = [_report(r) for r in full]
        drains = "".join(
            f"; drain probe_every={d['probe_every']} tok/s "
            f"{d['tok_s']:.2f} (wall {d['wall_s']:.2f} s, in the probes "
            f"{d['probe_s']:.2f} s, all-reduces {d['all_reduces']}" + (
                f", coverage {min(map(min, d['coverage'])):.4f}-"
                f"{max(map(max, d['coverage'])):.4f} over "
                f"{len(d['coverage'])} probes" if d["coverage"] else "")
            + ")" for d in full[0]["drains"])
        print(f"step {step}: {arch} {layers or 'full depth'} layers bf16 "
              f"on {world} ranks: "
              + "; ".join(f"rank {i} weights {r['weights_bytes']} bytes "
                          f"peak {r['peak_mem_bytes']} (with the drains "
                          f"{r['peak_mem_bytes_all']}) prefill "
                          f"{r['prefill_tok_s']:.0f} tok/s decode "
                          f"{r['decode_tok_s']:.1f} tok/s"
                          for i, r in enumerate(full))
              + f"; launches a rank {full[0]['launches']}; a decode "
              f"step's all-reduces {full[0]['step_all_reduces']}{drains} "
              f"[{time.perf_counter() - t0:.1f} s]", flush=True)


def seq_serve(dev, capacity, prompt, tp=None):
    """Step 6 on one card or one rank: phi3-mini at full width and depth
    (seeded weights, whole on every rank), ``generate`` of ``prompt`` (1,
    n) under the mixed routing, chunk SEQ_CHUNK, SEQ_GEN steps, with
    ``tp`` (a rank's group) its FA caches of ``capacity`` slots cut along
    the sequence over the ranks. Exact launches, and on the ranks exact
    collectives. Returns host results."""
    import chip_smoke as CS
    import repro_torch.kernels as KN
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import routing_pattern
    from repro_torch.models import model as MD
    from repro_torch.serve import kv_cache as KC
    from repro_torch.serve.engine import ServeEngine, chunk_plan
    cfg = get_config(CS.ARCH)
    t0 = time.perf_counter()
    params = MD.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    torch.cuda.synchronize()
    init_s, weights = time.perf_counter() - t0, torch.cuda.memory_allocated(
        dev)
    eng = ServeEngine(params, cfg, max_len=capacity, prefill_chunk=SEQ_CHUNK,
                      device=dev, seq_shard=tp, min_seq=SEQ_MIN_SEQ)
    mixed = routing_pattern(cfg, "mixed")
    eng.generate(prompt[:, :SEQ_CHUNK], 2, routing_override=mixed)  # warm
    CS.free_card()
    torch.cuda.reset_peak_memory_stats(dev)
    KN.reset_launch_counts()
    if tp is not None:
        tp.reset_counts()
    n = prompt.shape[1]
    g = eng.generate(prompt, SEQ_GEN, routing_override=mixed)
    assert bool(torch.isfinite(g.logits).all()), "first logits"
    assert bool(torch.isfinite(g.final_logits).all()), "last logits"
    counts = KN.launch_counts()
    n_fa = sum(p == "fa" for p in g.routing)
    want = {"flash_attention": n_fa,
            "streaming_attention": sum(p == "sa" for p in g.routing),
            "block_sparse_attention": n_fa * (len(chunk_plan(
                n, SEQ_CHUNK)) - 1)}
    want.update(CS.decode_launches(cfg, SEQ_GEN, pooled=False,
                                   seq_sharded=0 if tp is None else n_fa))
    assert counts == want, (counts, want)
    fa_whole = n_fa * 2 * capacity * cfg.num_kv_heads * cfg.head_dim * \
        cfg.dtype.itemsize
    out = dict(init_s=init_s, weights_bytes=weights,
               peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
               prefill_s=g.prefill_s, decode_s=g.decode_s,
               prefill_tok_s=n / g.prefill_s,
               decode_tok_s=SEQ_GEN / g.decode_s, tokens=g.tokens,
               launches=counts, kv_bytes=g.kv_bytes,
               kv_shard_bytes=g.kv_shard_bytes, fa_kv_bytes=fa_whole,
               fa_kv_shard_bytes=fa_whole)
    if tp is not None:
        shard = capacity // tp.world
        calls, nbytes, bcasts = CS.seq_gathers(cfg, g.routing, n, SEQ_GEN,
                                               shard, SEQ_CHUNK)
        got = (tp.gather_calls, tp.gather_bytes, tp.bcast_calls,
               tp.reduce_calls)
        assert got == (calls, nbytes, bcasts, 0), (got, calls, nbytes,
                                                    bcasts)
        assert KC.seq_shardable(capacity, tp.world, SEQ_MIN_SEQ)
        # the rank holds 1/world of every FA cache and the whole rings
        out["fa_kv_shard_bytes"] = fa_whole // tp.world
        assert g.kv_bytes - g.kv_shard_bytes == \
            fa_whole - out["fa_kv_shard_bytes"], (g.kv_bytes,
                                                  g.kv_shard_bytes)
        out["collectives"] = dict(
            gathers_a_step=calls // SEQ_GEN, gather_bytes=nbytes // calls,
            all_reduces=tp.reduce_calls, prefill_broadcasts=tp.bcast_calls,
            prefill_broadcast_bytes=tp.bcast_bytes)
    return out


def seq_rank(tp, prompt, capacity):
    """Step 6 on one rank."""
    return seq_serve(tp.device, capacity, prompt, tp)


def seq_steps(dev, world, report):
    """Step 6 into ``report``: (a) on card 0 alone and on ``world`` ranks,
    (b) on the ranks only."""
    import chip_smoke as CS
    from repro_torch.configs import get_config
    from repro_torch.distributed.group import launch
    vocab = get_config(CS.ARCH).vocab_size
    for part, (capacity, n) in (("a", SEQ_A), ("b", SEQ_B)):
        t0 = time.perf_counter()
        prompt = np.random.default_rng(60).integers(0, vocab, (1, n))
        alone = None
        if part == "a":
            alone = seq_serve(dev, capacity, prompt)
            CS.free_card()
        cut = launch(seq_rank, world, "nccl", args=(prompt, capacity),
                     device="cuda")
        for r in cut:
            assert np.array_equal(r["tokens"], cut[0]["tokens"])
        entry = dict(capacity=capacity, prompt=n, chunk=SEQ_CHUNK,
                     steps=SEQ_GEN, ranks=[_report_seq(r) for r in cut])
        line = (f"step 6{part}: {CS.ARCH} full width and depth bf16 mixed, "
                f"capacity {capacity}, prompt {n} + {SEQ_GEN}, chunk "
                f"{SEQ_CHUNK}: ")
        if alone is not None:
            entry["one_card"] = _report_seq(alone)
            entry["first_token_step_apart"] = _apart(alone["tokens"],
                                                     cut[0]["tokens"])
            line += (f"one card prefill {alone['prefill_tok_s']:.0f} tok/s "
                     f"decode {alone['decode_tok_s']:.2f} tok/s, FA KV "
                     f"{alone['fa_kv_bytes']} bytes, peak "
                     f"{alone['peak_mem_bytes']}; ")
        c = cut[0]["collectives"]
        line += (f"{world} ranks: " + "; ".join(
            f"rank {i} prefill {r['prefill_tok_s']:.0f} tok/s decode "
            f"{r['decode_tok_s']:.2f} tok/s weights {r['weights_bytes']} "
            f"KV {r['kv_shard_bytes']} (FA {r['fa_kv_shard_bytes']} of "
            f"{r['fa_kv_bytes']}) peak {r['peak_mem_bytes']}"
            for i, r in enumerate(cut))
            + f"; launches a rank {cut[0]['launches']}; a decode step: "
            f"{c['gathers_a_step']} gathers of {c['gather_bytes']} bytes, "
            f"{c['all_reduces']} all-reduces; the prefill: "
            f"{c['prefill_broadcasts']} broadcasts of "
            f"{c['prefill_broadcast_bytes']} bytes a rank")
        if alone is not None:
            line += (f"; tokens apart from step "
                     f"{entry['first_token_step_apart']}")
        report[f"seq_{part}"] = entry
        print(line + f" [{time.perf_counter() - t0:.1f} s]", flush=True)
        CS.free_card()


def _report_seq(r):
    return {k: v for k, v in r.items() if k != "tokens"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--steps", default="1,2,3,4,5,6",
                    help="the steps to run, comma-separated")
    ap.add_argument("--out", default=None,
                    help="write the whole report, coverage lists included, "
                         "here as JSON")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    world = args.world
    steps = {int(x) for x in args.steps.split(",")}
    if not torch.cuda.is_available():
        raise SystemExit("tp_smoke: no CUDA device")
    if torch.cuda.device_count() < world:
        raise SystemExit(f"tp_smoke: {world} ranks need {world} cards; "
                         f"{torch.cuda.device_count()} found")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as CS
    from repro_torch.kernels import _build
    t_all = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    print(f"built {_build.build(CS.SERVING_KERNELS)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    report = {"world": world, "cards": smi.splitlines()}

    if 1 in steps:
        parity_step(dev, world, report)
    long_steps(dev, world, report, steps)
    if 6 in steps:
        seq_steps(dev, world, report)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, default=str))
    print(json.dumps(_without_coverage(report), default=str), flush=True)
    print(f"total {time.perf_counter() - t_all:.1f} s", flush=True)
    return 0


def parity_step(dev, world, report):
    """Step 1 into ``report``."""
    import chip_smoke as CS
    from repro_torch.configs import get_config
    from repro_torch.distributed.group import launch
    from repro_torch.models import model as MD
    from repro_torch.serve.engine import ServeEngine
    t0 = time.perf_counter()
    cfg2 = get_config(CS.ARCH).replace(num_layers=2, dtype=torch.float32,
                                       param_dtype=torch.float32)
    params = MD.init_params(cfg2, torch.Generator(device=dev).manual_seed(0),
                            dev)
    probe = ServeEngine(params, cfg2, max_len=max(CS.TP_PARITY_LENS),
                        prefill_chunk=CS.CHUNK, device=dev)
    seed, prompts, margin = CS.router_margin_seed(probe, CS.TP_PARITY_LENS)
    one = CS.tp_parity_runs(dev, params, cfg2, prompts)
    del probe, params
    CS.free_card()
    ranks = launch(parity_rank, world, "nccl", args=(prompts,),
                   device="cuda")
    errs = []
    for r, got in enumerate(ranks):
        for name in ("router", "mixed"):
            assert got[name]["routing"] == one[name]["routing"], (r, name)
            assert np.array_equal(got[name]["tokens"],
                                  one[name]["tokens"]), (r, name)
            errs += [float(np.abs(got[name][k] - one[name][k]).max()
                           / np.abs(one[name][k]).max())
                     for k in ("logits", "final")]
            assert got[f"{name} drain"] == one[f"{name} drain"], (r, name)
    assert max(errs) < CS.FP32_TOL, errs
    assert sum(v[3] for v in one["mixed drain"].values()) >= 1
    report["parity_max_rel_err"] = max(errs)
    print(f"step 1: {CS.ARCH} 2 layers fp32 on {world} ranks over nccl = "
          f"one card (prompt seed {seed}, margin {margin:.2e}): tokens, "
          f"routing and statuses equal, logits rel err {max(errs):.2e} "
          f"[{time.perf_counter() - t0:.1f} s]", flush=True)


if __name__ == "__main__":
    sys.exit(main())
