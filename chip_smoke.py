#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line (any failure raises and exits non-zero;
nothing falls back to the CPU):
  1. the card (``nvidia-smi`` name and power limit), torch and CUDA;
  2. build the five hand-written attention kernels from ``csrc/``, and
     print the compiler's report (registers, spills, shared memory) and
     the SASS's HGMMA / UTMALDG counts of the bf16 tensor-core (wgmma)
     engine in the flash, block-sparse and streaming kernels at each head
     dim, and the report of the batch and slot-pool split decode kernels
     and their merge kernels;
  3. each kernel against its plain PyTorch version on the card: at the
     main paths' shapes in bf16 (the pooled decode kernel at the slot
     pool's: 4 slots of ragged live lengths, over a FullKV and over a
     ring whose entries are shuffled and partly empty), where every
     element must satisfy
     |kernel - plain| <= 0.05 * rms(plain) + 2**-7 * |plain| (one bf16 ulp
     of the output's own rounding beside a twentieth of a typical output
     value; the pooled kernel's rms is taken per slot, since a slot's
     outputs shrink with its live length), and at one GQA G = 4, D = 128,
     unaligned case in fp32 (max abs error 1e-4; the pooled kernel's holds
     a length-0 slot, whose rows must be zeros). To show the bf16 limit can
     see a wrong tile, the plain version with one 64-key tile of V zeroed
     must break it (the pooled kernel's: in every slot, the last full tile
     of that slot's live keys). The flash, block-sparse and streaming
     kernels run bf16 on their wgmma engine and fp32 on the CUDA cores,
     so the wgmma engine
     is also held to the bf16 limit (and its zeroed tile must break it) at
     each head dim 32 / 64 / 96 / 128 with G = 4, Sq = 200 queries at
     offset 100 over Skv = 300 keys: flash causal and bidirectional,
     block-sparse over a selection with holes, tiles past the diagonal
     and past Skv, and a duplicate removed by ``dedupe_selection``, and
     streaming at sink 0 / 16 / 100 and local 48 / 130; the split decode
     kernel at n_split 1, 2, 7 and the plan's (bf16, main shapes), with
     splits that hold no live key (cur_pos 1000) and a row with none
     (cur_pos -1), and over a shuffled, partly empty ring of 300 slots at
     each of those counts, at each head dim with G = 1 and G = 4: bf16
     under the bf16 limit (its zeroed tile above it), fp32 within 1e-4;
     the split pooled decode kernel at 1, 4 and 16 tiles a range and the
     plan's over the main path's FullKV pool (ranges past the shallow
     slots' lengths skipped), and over 4 slots of lengths 0 / 1 / 137 /
     300 at L 300, FullKV and a shuffled ring with holes (one 64-key range
     wholly masked), at 1, 2 and 5 tiles a range and the plan's, at each
     head dim with G = 1 and G = 4: bf16 under the limit per live slot
     (its zeroed tile above it), fp32 within 1e-4, and the length-0
     slot's rows zeros;
  4. each kernel's time at the main path's shapes (device time: CUDA
     events around back-to-back calls queued behind a device sleep, so the
     host's enqueue is off the clock; ``call_ms`` is one call on an idle
     card, host enqueue included) beside its plain version, one PyTorch
     library call as a yardstick (scaled_dot_product_attention, which the
     port never calls) and the least time the card could take (bytes at
     3.35 TB/s or bf16 operations at 989 TFLOP/s, whichever is larger);
     a second decode row and a second pooled decode row over the sink +
     local ring (L = 2176), the decode kernel's device time against
     n_split over the main path's FullKV at 32, 64 and 128 rows (1, 2 and
     4 requests), and the pooled decode kernel's device time and call_ms
     against its tiles a range over the FullKV pool at 4, 8 and 16 slots
     (POOL_LENS cycled);
  5. phi3-mini at full width, depth cut to 2 layers, fp32: the same
     weights served on cuda (kernels) and on cpu (plain versions), a
     2304-token prompt > sink + local, chunk 512, 8 greedy tokens; routing
     and tokens identical, first-step logits within 2e-3;
  5b. the same 2-layer weights through the slot-pool scheduler on cuda
     and on cpu: 5 requests of (2304, 1536, 1000, 700, 2304) tokens, 2
     slots per pool, decode chunks of 4, 8 new tokens, router-driven and
     with the mixed override, the last request at priority 9 submitted
     after the first decode tick (the mixed drain must preempt); routing
     and tokens identical on both devices and equal to ``generate`` of
     each request alone;
  6. the batch path: phi3-mini-3.8b at full width and depth, bf16, seeded
     weights, 4 requests of 4096 tokens, 32 new tokens, chunk 512, once
     router-driven and once with a mixed FA/SA override, through
     ``serve_batch_finished``; every logit finite, exact launch counts;
  7. the continuous path: the same model through ``ServeEngine.submit`` /
     ``step`` / ``drain``, 8 requests of 4096 // (1 + rid % 3) tokens, 32
     new tokens each, 4 slots per pool, decode chunks of 8; 5 requests
     take the mixed override (the last at priority 9, submitted once the
     mixed pool is full, so it preempts), 2 all-FA and 1 router-driven;
     every request finishes ok with 32 tokens, exact launch counts (the
     pooled decode kernel once per layer per pool decode step, the batch
     decode kernel never).
Then one JSON line of per-kernel numbers, and the last line
``{"ok": true, "device": {...}}``.
"""
import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core peak
ARCH = "phi3-mini-3.8b"
REQUESTS, PROMPT, GEN, CHUNK = 4, 4096, 32, 512
POOL_LENS = (4112, 2080, 1400, 1)  # live lengths of the timed slot pool

REPLACES = {  # kernel → the Pallas TPU kernel it replaces
    "flash_attention": "src/repro/kernels/flash_attention.py:75",
    "streaming_attention": "src/repro/kernels/streaming_attention.py:90",
    "block_sparse_attention": "src/repro/kernels/block_sparse_attention.py:86",
    "decode_attention": "src/repro/kernels/decode_attention.py:107",
    "decode_attention_pooled": "src/repro/kernels/decode_attention.py:202",
}
BF16_ATOL_RMS = 0.05  # bf16 limit's absolute part, as a share of rms(plain)
BF16_RTOL = 2.0 ** -7  # one bf16 ulp: kernel and plain round their outputs
FP32_TOL = 1e-4
SLEEP_CYCLES = 20_000_000  # ≈ 10 ms of device sleep before a timed run
TILE = slice(64, 128)  # the 64-key tile zeroed for the sensitivity check


def say(phase, msg, t0=None):
    extra = "" if t0 is None else f" [{time.perf_counter() - t0:.1f} s]"
    print(f"phase {phase}: {msg}{extra}", flush=True)


def call_ms(fn, reps=15, warmup=3):
    """Median over ``reps`` CUDA-event timings of one call of ``fn`` on an
    idle card: the device time, or the host's enqueue of the call where
    that takes longer."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def time_ms(fn, reps=10, rounds=5, warmup=3):
    """Device time of one call of ``fn``: the median over ``rounds`` of the
    mean of ``reps`` back-to-back calls between two CUDA events, queued
    behind a device-side sleep of SLEEP_CYCLES so that the host's enqueue
    of the calls stays off the clock."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / reps)
    return statistics.median(ts)


def max_err(a, b):
    torch.cuda.synchronize()
    return float((a.float() - b.float()).abs().max())


def bf16_ratios(out, plain, groups=1):
    """For each of ``groups`` equal runs of rows (a pool's slots), the max
    over its elements of |out - plain| / (atol + BF16_RTOL * |plain|),
    atol = BF16_ATOL_RMS * rms(plain over that run): below 1 passes the
    bf16 limit."""
    p = plain.float().reshape(groups, -1)
    atol = BF16_ATOL_RMS * p.square().mean(1, keepdim=True).sqrt()
    return (((out.float().reshape(groups, -1) - p).abs()
             / (atol + BF16_RTOL * p.abs())).amax(1).tolist())


def zero_tile(x):
    """x with keys TILE of every row zeroed: a kernel that misreads one
    key tile of V."""
    x = x.clone()
    x[:, TILE] = 0
    return x


def zero_slot_tiles(v, lens):
    """v (B·Hkv, L, D) with, in each slot b, the last full 64-key tile
    below its live length lens[b] zeroed (keys 0-63 below 128): a kernel
    that misreads one tile of every slot's live prefix."""
    v = v.clone()
    for b, rows in enumerate(v.view(len(lens), -1, *v.shape[1:])):
        t = max(lens[b] // 64 - 1, 0)
        rows[:, 64 * t:64 * t + 64] = 0
    return v


def ratio_text(rs):
    return "/".join(f"{r:.3f}" for r in rs)


def bound(n_bytes, flops):
    """(least ms, what bounds it) for this many bytes and operations."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def attn_work(BH, BHkv, Sq, D, keys_read, pairs, itemsize):
    """Bytes (q read, o written, the needed keys of k and v read once)
    and operations (QK^T and PV: 4·D per visible (query, key) pair)."""
    return (itemsize * (2 * BH * Sq * D + 2 * BHkv * keys_read * D),
            4 * D * pairs)


def streaming_pairs(q_pos, sink, local):
    """Visible keys per query position under sink + local (causal)."""
    p = np.asarray(q_pos, np.int64)
    n_sink = np.minimum(sink, p + 1)
    lo = np.maximum(sink, p - local + 1)
    return int((n_sink + np.maximum(p - lo + 1, 0)).sum())


def kernel_cases(dev, dtype, main):
    """(name → (kernel call, plain call, plain call with one V tile zeroed,
    library call, bytes, flops)) on random inputs; ``main`` picks the main
    path's shapes, else the small G = 4, D = 128, unaligned case."""
    from repro_torch.configs import get_config
    from repro_torch.core.modes import causal_selection
    from repro_torch.kernels import ref
    from repro_torch.kernels.block_sparse_attention import (
        KERNEL_BLOCK, block_sparse_attention_bh)
    from repro_torch.kernels.decode_attention import decode_attention_bh
    from repro_torch.kernels.decode_attention_pooled import \
        decode_attention_pooled_bh
    from repro_torch.kernels.flash_attention import flash_attention_bh
    from repro_torch.kernels.streaming_attention import \
        streaming_attention_bh
    from repro_torch.serve.engine import _ring_src
    F = torch.nn.functional
    g = torch.Generator(device=dev).manual_seed(0)
    cfg = get_config(ARCH)
    sink, local = cfg.flux.sink, cfg.flux.local

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    if main:
        BH = BHkv = REQUESTS * cfg.num_heads
        D, S, L = cfg.head_dim, CHUNK, PROMPT + GEN
        start, cur = PROMPT - CHUNK, PROMPT + GEN // 2 - 1
    else:
        BH, BHkv, D, S, L = 8, 2, 128, 200, 300
        start, cur, sink, local = 150, 250, 16, 48
    it = torch.tensor([], dtype=dtype).element_size()
    B4 = (BH // BHkv, BHkv)  # the (G, Hkv) split the library call takes

    def q4(x):  # (BH, S, D) → (Hkv, G, S, D) for the library call
        return x.view(B4[1], B4[0], *x.shape[1:]).transpose(0, 1)

    def kv4(x):
        return x[None].expand(B4[0], *x.shape)

    cases = {}
    q, k, v = rnd(BH, S, D), rnd(BHkv, S, D), rnd(BHkv, S, D)
    pairs = BH * S * (S + 1) // 2
    cases["flash_attention"] = (
        lambda: flash_attention_bh(q, k, v),
        lambda: ref.flash_attention_ref(q, k, v),
        lambda: ref.flash_attention_ref(q, k, zero_tile(v)),
        lambda: F.scaled_dot_product_attention(q4(q), kv4(k), kv4(v),
                                               is_causal=True),
        *attn_work(BH, BHkv, S, D, S, pairs, it))
    pos = torch.arange(S, device=dev)
    smask = (pos[None] <= pos[:, None]) & (
        (pos[None] < sink) | (pos[:, None] - pos[None] < local))
    cases["streaming_attention"] = (
        lambda: streaming_attention_bh(q, k, v, sink=sink, local=local),
        lambda: ref.streaming_attention_ref(q, k, v, sink=sink, local=local),
        lambda: ref.streaming_attention_ref(q, k, zero_tile(v), sink=sink,
                                            local=local),
        lambda: F.scaled_dot_product_attention(q4(q), kv4(k), kv4(v),
                                               attn_mask=smask),
        *attn_work(BH, BHkv, S, D, S,
                   BH * streaming_pairs(range(S), sink, local), it))
    # a streamed chunk of S queries at ``start`` over an L-slot FullKV
    Sq = S if main else 100
    qc, kc, vc = rnd(BH, Sq, D), rnd(BHkv, L, D), rnd(BHkv, L, D)
    sel = causal_selection(start, Sq, L, BH, dev)
    kpos = torch.arange(L, device=dev)
    cmask = kpos[None] <= start + torch.arange(Sq, device=dev)[:, None]
    live = start + Sq
    cases["block_sparse_attention"] = (
        lambda: block_sparse_attention_bh(qc, kc, vc, sel, q_offset=start),
        lambda: ref.block_sparse_attention_ref(qc, kc, vc, sel,
                                               block=KERNEL_BLOCK,
                                               q_offset=start),
        lambda: ref.block_sparse_attention_ref(qc, kc, zero_tile(vc), sel,
                                               block=KERNEL_BLOCK,
                                               q_offset=start),
        lambda: F.scaled_dot_product_attention(q4(qc), kv4(kc), kv4(vc),
                                               attn_mask=cmask),
        *attn_work(BH, BHkv, Sq, D, live,
                   BH * (Sq * start + Sq * (Sq + 1) // 2), it))
    # one decode token over a FullKV (positions = arange; main) or over a
    # ring whose slots hold a permutation of positions (the small case)
    qd, kd, vd = rnd(BH, 1, D), rnd(BHkv, L, D), rnd(BHkv, L, D)
    if main:
        dpos = torch.arange(L, dtype=torch.int32, device=dev)
    else:
        src = _ring_src(cur + 1, 40, L - 40, L)
        perm = torch.randperm(L, generator=g, device=dev)
        dpos = torch.as_tensor(src, dtype=torch.int32, device=dev)[perm]
    valid = (dpos >= 0) & (dpos <= cur)
    n_valid = int(valid.sum())
    cases["decode_attention"] = (
        lambda: decode_attention_bh(qd, kd, vd, dpos, cur),
        lambda: ref.decode_attention_ref(qd, kd, vd, dpos, cur),
        lambda: ref.decode_attention_ref(qd, kd, zero_tile(vd), dpos, cur),
        lambda: F.scaled_dot_product_attention(q4(qd), kv4(kd), kv4(vd),
                                               attn_mask=valid[None]),
        *attn_work(BH, BHkv, 1, D, n_valid, BH * n_valid, it))
    # one decode token per slot of a pool: FullKV rows of ragged live
    # lengths (main), or a ring with shuffled, partly empty entries and a
    # length-0 slot (the small case)
    if main:
        lens, Hq, Hkv = POOL_LENS, cfg.num_heads, cfg.num_kv_heads
        ppos = None
    else:
        lens, Hq, Hkv = (0, 137, L), 8, 2
        ppos = torch.as_tensor(ring_positions(np.random.default_rng(0),
                                              lens, L), device=dev)
    Bp = len(lens)
    qp, kp, vp = rnd(Bp * Hq, 1, D), rnd(Bp * Hkv, L, D), rnd(Bp * Hkv, L, D)
    plens = torch.tensor(lens, dtype=torch.int32, device=dev)
    pvis = torch.arange(L, device=dev)[None] < plens[:, None]
    if ppos is not None:
        pvis = pvis & (ppos >= 0)

    def kv_slots(x):  # (B·Hkv, L, D) → (B, Hq, L, D) for the library call
        return x.view(Bp, Hkv, L, D).repeat_interleave(Hq // Hkv, 1)

    cases["decode_attention_pooled"] = (
        lambda: decode_attention_pooled_bh(qp, kp, vp, ppos, plens,
                                           n_heads=Hq),
        lambda: ref.decode_attention_pooled_ref(qp, kp, vp, ppos, plens,
                                                n_heads=Hq),
        lambda: ref.decode_attention_pooled_ref(qp, kp,
                                                zero_slot_tiles(vp, lens),
                                                ppos, plens, n_heads=Hq),
        lambda: F.scaled_dot_product_attention(
            qp.view(Bp, Hq, 1, D), kv_slots(kp), kv_slots(vp),
            attn_mask=pvis[:, None, None]),
        *pooled_work(Bp, Hq, Hkv, D, [min(n, L) for n in lens],
                     ppos is not None, int(pvis.sum()), it))
    return cases


def ring_positions(rng, lens, L, hole=0.1):
    """(B, L) int32 ring positions: slot b's first min(n, L) entries hold
    distinct absolute positions of its last n tokens in shuffled order, a
    ``hole`` share of them re-marked -1 (never all), the rest -1."""
    pos = np.full((len(lens), L), -1, np.int32)
    for b, n in enumerate(lens):
        m = min(n, L)
        if m == 0:
            continue
        pos[b, :m] = rng.permutation(np.arange(n - m, n))
        cut = rng.random(m) < hole
        cut[rng.integers(m)] = False
        pos[b, :m][cut] = -1
    return pos


WGMMA_SEL = (  # the small block-sparse case's selection, one row a query
    # block (queries at 100 + 64 i ..); before dedupe_selection
    (0, -1, 2, 4, 0, 1),    # tile 4 past the diagonal, a duplicate 0
    (4, 3, -1, 1, 1, 0),    # an invisible tile first, a duplicate 1
    (2, -1, 4, 1, -1, 3),   # tile 4 crosses the diagonal and Skv
    (-1, 1, 4, 3, 4, 0),    # tile 2 left out, a duplicate 4
)


STREAM_SMALL = ((0, 48), (0, 130), (16, 48), (16, 130), (100, 48),
                (100, 130))  # (sink, local) of the small streaming cases


def wgmma_cases(dev):
    """The bf16 small cases of the flash, block-sparse and streaming wgmma
    engine: [(label, kernel call, plain call, plain call with one V tile
    zeroed)] at each head dim, G = 4, 200 queries at offset 100 over 300
    keys; streaming at each (sink, local) of STREAM_SMALL (a sink tile
    walked in both passes at sink 16 and 100, windows narrower than a
    query block and wider than a tile)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels._build import HEAD_DIMS
    from repro_torch.kernels.block_sparse_attention import (
        KERNEL_BLOCK, block_sparse_attention_bh, dedupe_selection)
    from repro_torch.kernels.flash_attention import flash_attention_bh
    from repro_torch.kernels.streaming_attention import \
        streaming_attention_bh
    g = torch.Generator(device=dev).manual_seed(3)
    BH, BHkv, Sq, Skv, off = 8, 2, 200, 300, 100
    sel = dedupe_selection(torch.tensor(WGMMA_SEL, dtype=torch.int32,
                                        device=dev))
    sel = sel[None].expand(BH, *sel.shape).contiguous()
    cases = []
    for D in HEAD_DIMS:
        q, k, v = (torch.randn(n, s, D, generator=g, device=dev).to(
            torch.bfloat16) for n, s in ((BH, Sq), (BHkv, Skv), (BHkv, Skv)))
        for causal in (True, False):
            kw = dict(causal=causal, q_offset=off if causal else 0)
            mode = "causal q_offset=100" if causal else "bidirectional"
            cases.append((
                f"flash D={D} {mode}",
                lambda q=q, k=k, v=v, kw=kw: flash_attention_bh(q, k, v,
                                                                **kw),
                lambda q=q, k=k, v=v, kw=kw: ref.flash_attention_ref(
                    q, k, v, **kw),
                lambda q=q, k=k, v=v, kw=kw: ref.flash_attention_ref(
                    q, k, zero_tile(v), **kw)))
        cases.append((
            f"block_sparse D={D} q_offset=100 holes/out-of-causal/deduped",
            lambda q=q, k=k, v=v: block_sparse_attention_bh(
                q, k, v, sel, q_offset=off),
            lambda q=q, k=k, v=v: ref.block_sparse_attention_ref(
                q, k, v, sel, block=KERNEL_BLOCK, q_offset=off),
            lambda q=q, k=k, v=v: ref.block_sparse_attention_ref(
                q, k, zero_tile(v), sel, block=KERNEL_BLOCK, q_offset=off)))
        for sink, local in STREAM_SMALL:
            kw = dict(sink=sink, local=local, q_offset=off)
            cases.append((
                f"streaming D={D} q_offset=100 sink={sink} local={local}",
                lambda q=q, k=k, v=v, kw=kw: streaming_attention_bh(
                    q, k, v, **kw),
                lambda q=q, k=k, v=v, kw=kw: ref.streaming_attention_ref(
                    q, k, v, **kw),
                lambda q=q, k=k, v=v, kw=kw: ref.streaming_attention_ref(
                    q, k, zero_tile(v), **kw)))
    return cases


def sass_counts(lib):
    """{kernel symbol: (HGMMA count, UTMALDG count, HGMMA shapes)} for the
    wgmma kernels of a library, from ``cuobjdump -sass`` of the CUDA
    toolkit; {} when it has no cuobjdump."""
    import os
    import shutil
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120).stdout
    out = {}
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        name = body.split(None, 1)[0]
        if "wgmma_kernel" in name:
            out[name] = (body.count("HGMMA."), body.count("UTMALDG."),
                         sorted(set(re.findall(r"HGMMA\.(\d+x\d+x\d+)",
                                               body))))
    return out


def compiler_report(lib, want):
    """{kernel symbol: {registers, smem, spill, stack}} of the kernels whose
    symbol holds ``want``, from the compiler's report beside the library
    (``<library>.log``, ``nvcc -Xptxas=-v``)."""
    log = Path(f"{lib}.log")
    report, name = {}, None
    for line in log.read_text().splitlines() if log.exists() else ():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        if name is None or want not in name:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            report.setdefault(name, {}).update(stack=int(m[1]),
                                               spill=f"{m[2]}/{m[3]}")
        m = re.search(r"Used (\d+) registers", line)
        if m:
            sm = re.search(r"(\d+) bytes smem", line)
            report.setdefault(name, {}).update(
                registers=int(m[1]), smem=int(sm[1]) if sm else 0)
    return report


def wgmma_report(n_sel):
    """One line per wgmma kernel instance of the flash, block-sparse and
    streaming libraries: registers, spill bytes and static shared memory
    from the compiler's report, the dynamic shared memory a CTA asks for
    (the block-sparse one with an n_sel-entry selection), and the
    tensor-core (HGMMA) and TMA-load (UTMALDG) instructions in its SASS."""
    from repro_torch.kernels import _build
    lines = []
    for source in ("flash_attention", "block_sparse_attention",
                   "streaming_attention"):
        lib = _build.library_path(source)
        sass = sass_counts(lib)
        smem = ctypes.CDLL(str(lib)).flux_wgmma_smem_bytes
        smem.argtypes, smem.restype = [ctypes.c_int, ctypes.c_int], \
            ctypes.c_int
        report = compiler_report(lib, "wgmma_kernel")
        if not report:
            lines.append(f"{source}: no compiler report at {lib.name}.log")
        for name, r in sorted(report.items()):
            D = int(re.search(r"ILi(\d+)E", name)[1])
            n = n_sel if source == "block_sparse_attention" else 0
            hgmma, tma, shapes = sass.get(name, (None, None, None))
            lines.append(
                f"{source} wgmma D={D}: registers={r.get('registers')} "
                f"spill_stores/loads={r.get('spill')} bytes "
                f"static_smem={r.get('smem')} dynamic_smem={smem(D, n)} "
                f"(n_sel={n}) sass HGMMA={hgmma} {shapes} UTMALDG={tma}")
    return lines


def decode_report():
    """One line per (kernel, dtype, rows a CTA) of the split decode
    libraries, batch (decode_*) and slot pool (pooled_*), which build the
    one split kernel of ``csrc/decode_split.cuh`` under their own masks:
    registers / spill stores / spill loads / stack bytes of each head
    dim's instance."""
    from repro_torch.kernels import _build
    lines, groups = [], {}
    for source, prefix in (("decode_attention", "decode"),
                           ("decode_attention_pooled", "pooled")):
        report = compiler_report(_build.library_path(source), "_kernel")
        if not report:
            lines.append(f"{source}: no compiler report")
        for name, r in report.items():
            kind = "split" if "split_kernel" in name else "merge"
            args = [int(x) for x in re.findall(r"Li(\d+)E", name)]
            dtype = "bf16" if "bfloat16" in name else "fp32"
            key = f"{prefix}_{kind} {dtype}" + (f" kG={args[1]}"
                                                if kind == "split" else "")
            groups.setdefault(key, []).append(
                (args[0], f"D={args[0]}: {r.get('registers')} regs "
                          f"spill {r.get('spill')} stack {r.get('stack')}"))
    return lines + [f"{k}: " + ", ".join(t for _, t in sorted(v))
                    for k, v in sorted(groups.items())]


def ring_decode_case(dev):
    """The decode kernel over a sink + local RingKV at the main path's
    shapes (bf16), the SA layers' decode: (kernel call, plain call, plain
    call with one V tile zeroed, library call, bytes, flops)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_bh
    from repro_torch.serve.engine import _ring_src
    cfg = get_config(ARCH)
    sink, local = cfg.flux.sink, cfg.flux.local
    ring, BH, D = sink + local, REQUESTS * cfg.num_heads, cfg.head_dim
    cur = PROMPT + GEN // 2 - 1
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(BH, n, D, generator=g, device=dev).to(
        torch.bfloat16) for n in (1, ring, ring))
    pos = torch.as_tensor(_ring_src(cur + 1, sink, local, ring),
                          dtype=torch.int32, device=dev)
    valid = (pos >= 0) & (pos <= cur)
    n_valid = int(valid.sum())
    return (lambda: decode_attention_bh(q, k, v, pos, cur),
            lambda: ref.decode_attention_ref(q, k, v, pos, cur),
            lambda: ref.decode_attention_ref(q, k, zero_tile(v), pos, cur),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q[None], k[None], v[None], attn_mask=valid[None]),
            *attn_work(BH, BH, 1, D, n_valid, BH * n_valid, 2))


def ring_decode_check(dev):
    """(max abs error, bf16 ratio of the kernel, bf16 ratio of the plain
    version with one V tile zeroed) of ``ring_decode_case``."""
    kern, plain, mutant, *_ = ring_decode_case(dev)
    out, want = kern(), plain()
    return (max_err(out, want), bf16_ratios(out, want),
            bf16_ratios(mutant(), want))


SWEEP_REQUESTS = (1, 2, 4)  # batch buckets of the sweep: 32, 64, 128 rows
SWEEP_SPLITS = (1, 2, 3, 4, 6, 8, 16, 33, 65)


def decode_split_sweep(dev):
    """{rows: {n_split: (device ms, whether it is the plan's)}} of the
    decode kernel over the main path's FullKV (bf16, L 4128) at the batch
    buckets of 1, 2 and 4 requests."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import (decode_attention_bh,
                                                      decode_split_plan,
                                                      sm_count)
    cfg = get_config(ARCH)
    D, L = cfg.head_dim, PROMPT + GEN
    g = torch.Generator(device=dev).manual_seed(5)
    pos = torch.arange(L, dtype=torch.int32, device=dev)
    out = {}
    for n_req in SWEEP_REQUESTS:
        BH = n_req * cfg.num_heads
        q, k, v = (torch.randn(BH, n, D, generator=g, device=dev).to(
            torch.bfloat16) for n in (1, L, L))
        plan = decode_split_plan(BH, 1, L, sm_count(dev.index or 0))
        out[BH] = {n: (time_ms(lambda n=n: decode_attention_bh(
                       q, k, v, pos, L - 17, n_split=n)), n == plan)
                   for n in sorted(set(SWEEP_SPLITS) | {plan})}
        del q, k, v
    return out


POOL_SWEEP_SLOTS = (4, 8, 16)  # pools of POOL_LENS cycled
POOL_SWEEP_TILES = (1, 2, 4, 8, 16, 33, 65)


def pooled_tiles_sweep(dev):
    """{slots: {tiles: (device ms, call ms, whether it is the plan's)}} of
    the pooled decode kernel over the main path's FullKV (bf16, L 4128)
    at 4, 8 and 16 slots of POOL_LENS cycled, and {slots: bound ms}."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import pooled_split_plan
    from repro_torch.kernels.decode_attention_pooled import \
        decode_attention_pooled_bh
    cfg = get_config(ARCH)
    H, D, L = cfg.num_heads, cfg.head_dim, PROMPT + GEN
    g = torch.Generator(device=dev).manual_seed(7)
    plan = pooled_split_plan(L)
    out, bounds = {}, {}
    for B in POOL_SWEEP_SLOTS:
        lens = [POOL_LENS[i % len(POOL_LENS)] for i in range(B)]
        q, k, v = (torch.randn(B * H, n, D, generator=g, device=dev).to(
            torch.bfloat16) for n in (1, L, L))
        n = torch.tensor(lens, dtype=torch.int32, device=dev)
        live = [min(x, L) for x in lens]
        bounds[B] = bound(*pooled_work(B, H, H, D, live, False,
                                       H * sum(live)))[0]

        def call(t):
            return decode_attention_pooled_bh(q, k, v, None, n, n_heads=H,
                                              tiles=t)
        out[B] = {t: (time_ms(lambda t=t: call(t)),
                      call_ms(lambda t=t: call(t)), t == plan)
                  for t in sorted(set(POOL_SWEEP_TILES) | {plan})}
        del q, k, v
    return out, bounds


def decode_split_cases(dev):
    """The split-KV decode kernel at forced and planned split counts:
    [(label, kernel call, plain call, plain call with one V tile zeroed or
    None, fp32 tolerance or None for the bf16 limit)]. At the main path's
    shapes (bf16, FullKV) n_split 1, 2, 7 and the plan's; at 7 and the
    plan's with cur_pos 1000, so that the splits past key 1000 hold no
    live key, and with cur_pos -1, a row with no live key (the plain
    version's uniform weights: the mean of V). Then small cases over a
    ring permutation of 300 slots (cur_pos 250, 49 slots empty) at
    n_split 1, 2, 7 (5 run) and the plan's, at each head dim with G = 1
    and G = 4 (every instance of the kernel): bf16 under the bf16 limit
    with its zeroed tile above it, fp32 within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels._build import HEAD_DIMS
    from repro_torch.kernels.decode_attention import (decode_attention_bh,
                                                      decode_split_plan,
                                                      normalize_split,
                                                      sm_count,
                                                      split_ranges)
    from repro_torch.serve.engine import _ring_src
    sms = sm_count(dev.index or 0)
    cfg = get_config(ARCH)
    BH, D, L = REQUESTS * cfg.num_heads, cfg.head_dim, PROMPT + GEN
    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (torch.randn(BH, n, D, generator=g, device=dev).to(
        torch.bfloat16) for n in (1, L, L))
    pos = torch.arange(L, dtype=torch.int32, device=dev)
    plan = decode_split_plan(BH, 1, L, sms)
    cases = []
    for n, cur in sorted({(n, L - 17) for n in (1, 2, 7, plan)}
                         | {(n, c) for n in (7, plan) for c in (1000, -1)}):
        dead = sum(s > cur for s, _ in split_ranges(L, normalize_split(L, n)))
        cases.append((
            f"decode bf16 main shapes cur_pos={cur} n_split={n}"
            f"{' (plan)' if n == plan else ''} all_masked_splits={dead}",
            lambda n=n, cur=cur: decode_attention_bh(q, k, v, pos, cur,
                                                     n_split=n),
            lambda cur=cur: ref.decode_attention_ref(q, k, v, pos, cur),
            lambda cur=cur: ref.decode_attention_ref(q, k, zero_tile(v), pos,
                                                     cur),
            None))
    BH, L, cur = 8, 300, 250
    perm = torch.randperm(L, generator=g, device=dev)
    rpos = torch.as_tensor(_ring_src(cur + 1, 40, L - 40, L),
                           dtype=torch.int32, device=dev)[perm]
    for dtype, D, G in [(t, D, G) for t in (torch.bfloat16, torch.float32)
                        for D in HEAD_DIMS for G in (1, 4)]:
        qs, ks, vs = (torch.randn(n, s, D, generator=g, device=dev).to(dtype)
                      for n, s in ((BH, 1), (BH // G, L), (BH // G, L)))
        plan = decode_split_plan(BH // G, G, L, sms)
        bf16 = dtype == torch.bfloat16
        for n in sorted({1, 2, 7, plan}):
            cases.append((
                f"decode {'bf16' if bf16 else 'fp32'} G={G} D={D} ring "
                f"L=300 n_split={n} (runs {normalize_split(L, n, G)})"
                f"{' (plan)' if n == plan else ''}",
                lambda qs=qs, ks=ks, vs=vs, n=n: decode_attention_bh(
                    qs, ks, vs, rpos, cur, n_split=n),
                lambda qs=qs, ks=ks, vs=vs: ref.decode_attention_ref(
                    qs, ks, vs, rpos, cur),
                (lambda qs=qs, ks=ks, vs=vs: ref.decode_attention_ref(
                    qs, ks, zero_tile(vs), rpos, cur)) if bf16 else None,
                None if bf16 else FP32_TOL))
    return cases


RING_POOL_LENS = (4112, 2080, 1400, 100)  # depths of the timed ring pool


def pooled_ring_case(dev):
    """The pooled decode kernel over sink + local rings at the slot pool's
    shapes (bf16), the SA layers' pooled decode: 4 slots at different
    depths, lengths min(len, ring), entries shuffled with a tenth
    re-marked -1: (kernel call, plain call, plain call with one live V
    tile of every slot zeroed, library call, bytes, flops)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention_pooled import \
        decode_attention_pooled_bh
    cfg = get_config(ARCH)
    ring, H, D = cfg.flux.sink + cfg.flux.local, cfg.num_heads, cfg.head_dim
    B = len(RING_POOL_LENS)
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn(B * H, n, D, generator=g,
                           device=dev).to(torch.bfloat16)
               for n in (1, ring, ring))
    pos = torch.as_tensor(ring_positions(np.random.default_rng(2),
                                         RING_POOL_LENS, ring), device=dev)
    live = [min(x, ring) for x in RING_POOL_LENS]
    n = torch.tensor(live, dtype=torch.int32, device=dev)
    vis = (torch.arange(ring, device=dev)[None] < n[:, None]) & (pos >= 0)
    return (lambda: decode_attention_pooled_bh(q, k, v, pos, n, n_heads=H),
            lambda: ref.decode_attention_pooled_ref(q, k, v, pos, n,
                                                    n_heads=H),
            lambda: ref.decode_attention_pooled_ref(
                q, k, zero_slot_tiles(v, live), pos, n, n_heads=H),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q.view(B, H, 1, D), k.view(B, H, ring, D),
                v.view(B, H, ring, D), attn_mask=vis[:, None, None]),
            *pooled_work(B, H, H, D, live, True, int(vis.sum())))


def pooled_work(B, Hq, Hkv, D, live, ring, visible, itemsize=2):
    """Bytes and operations of one pooled decode call: the live prefixes
    of K and V, q and o, lengths and (over a ring) the live positions
    each moved once; QK^T and PV (4·D per query row) for the visible
    (slot, key) pairs."""
    n = sum(live)
    return (itemsize * (2 * B * Hq * D + 2 * Hkv * n * D) + 4 * B
            + (4 * n if ring else 0), 4 * D * Hq * visible)


def pooled_ring_check(dev):
    """(max abs error, bf16 ratio of the kernel per slot, that of the
    plain version with one live V tile of every slot zeroed) of
    ``pooled_ring_case``."""
    kern, plain, mutant, *_ = pooled_ring_case(dev)
    out, want = kern(), plain()
    B = len(RING_POOL_LENS)
    return (max_err(out, want), bf16_ratios(out, want, B),
            bf16_ratios(mutant(), want, B))


SMALL_POOL_LENS = (0, 1, 137, 300)  # the small pooled cases' slots, L 300
SMALL_POOL_TILES = (1, 2, 5)  # forced tiles a range; 5: one range a row


def pooled_split_cases(dev):
    """The split pooled decode kernel at forced and planned tiles a range:
    [(label, slot lengths, L, [(tiles, kernel call)], plain call, plain
    call with one live V tile of every slot zeroed or None, fp32 tolerance
    or None for the bf16 limit)]. At the main path's shapes (bf16, FullKV, POOL_LENS)
    1, 4 and 16 tiles a range and the plan's, where whole ranges lie past
    the shallow slots' lengths. Then small cases, 4 slots of lengths
    SMALL_POOL_LENS (one empty) over L = 300, FullKV and a shuffled ring
    with holes whose slot 3 has keys 64-127 all -1 (a 1-tile range there
    sees nothing), at 1, 2 and 5 tiles a range (5: one range a row, no
    merge) and the plan's, at each head dim with G = 1 and G = 4 (every instance
    of the kernel): bf16 under the bf16 limit per live slot with its
    zeroed tile above it, fp32 within 1e-4, the empty slot's rows zeros."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels._build import HEAD_DIMS
    from repro_torch.kernels.decode_attention import (normalize_tiles,
                                                      pooled_split_plan)
    from repro_torch.kernels.decode_attention_pooled import \
        decode_attention_pooled_bh
    cfg = get_config(ARCH)
    H, D, L = cfg.num_heads, cfg.head_dim, PROMPT + GEN
    B = len(POOL_LENS)
    g = torch.Generator(device=dev).manual_seed(6)
    qm, km, vm = (torch.randn(B * H, n, D, generator=g, device=dev).to(
        torch.bfloat16) for n in (1, L, L))
    lm = torch.tensor(POOL_LENS, dtype=torch.int32, device=dev)
    cases = [(
        f"decode_attention_pooled bf16 main shapes FullKV lens={POOL_LENS}",
        POOL_LENS, L,
        [(t, lambda t=t: decode_attention_pooled_bh(qm, km, vm, None, lm,
                                                    n_heads=H, tiles=t))
         for t in sorted({1, 4, 16, pooled_split_plan(L)})],
        lambda: ref.decode_attention_pooled_ref(qm, km, vm, None, lm,
                                                n_heads=H),
        lambda: ref.decode_attention_pooled_ref(
            qm, km, zero_slot_tiles(vm, POOL_LENS), None, lm, n_heads=H),
        None)]
    L, Hq = 300, 8
    B = len(SMALL_POOL_LENS)
    lens = torch.tensor(SMALL_POOL_LENS, dtype=torch.int32, device=dev)
    rpos = ring_positions(np.random.default_rng(6), SMALL_POOL_LENS, L)
    rpos[3, 64:128] = -1
    rpos = torch.as_tensor(rpos, device=dev)
    for dtype, D, G, ring in [(t, D, G, r)
                              for t in (torch.bfloat16, torch.float32)
                              for D in HEAD_DIMS for G in (1, 4)
                              for r in (False, True)]:
        Hkv = Hq // G
        q, k, v = (torch.randn(B * h, n, D, generator=g, device=dev).to(
            dtype) for h, n in ((Hq, 1), (Hkv, L), (Hkv, L)))
        pos = rpos if ring else None
        bf16 = dtype == torch.bfloat16
        plan = pooled_split_plan(L, G)
        tiles = sorted({normalize_tiles(L, t, G)
                        for t in SMALL_POOL_TILES} | {plan})
        cases.append((
            f"decode_attention_pooled {'bf16' if bf16 else 'fp32'} G={G} "
            f"D={D} {'ring, slot 3 keys 64-127 -1' if ring else 'FullKV'} "
            f"L=300 lens={SMALL_POOL_LENS}", SMALL_POOL_LENS, L,
            [(t, lambda q=q, k=k, v=v, pos=pos, t=t:
              decode_attention_pooled_bh(q, k, v, pos, lens, n_heads=Hq,
                                         tiles=t)) for t in tiles],
            lambda q=q, k=k, v=v, pos=pos: ref.decode_attention_pooled_ref(
                q, k, v, pos, lens, n_heads=Hq),
            (lambda q=q, k=k, v=v, pos=pos: ref.decode_attention_pooled_ref(
                q, k, zero_slot_tiles(v, SMALL_POOL_LENS), pos, lens,
                n_heads=Hq)) if bf16 else None,
            None if bf16 else FP32_TOL))
    return cases


def pooled_split_check(dev):
    """Phase 3's lines for ``pooled_split_cases``: each case's max abs
    error (err) at each tiles a range, against its limit (bf16: the ratio
    to the limit per live slot, the zeroed tile's above it; fp32: 1e-4),
    the capacity's ranges skipped past the slots' lengths, and zeros in
    every length-0 slot's rows."""
    from repro_torch.kernels.decode_attention import pooled_ranges
    lines = []
    for label, lens, L, calls, plain, mutant, tol in pooled_split_cases(dev):
        want = plain()
        slots = sum(n > 0 for n in lens)  # rms per live slot
        live = torch.tensor([n > 0 for n in lens], device=dev)
        live = live.repeat_interleave(want.shape[0] // len(lens))
        parts = []
        for t, kern in calls:
            out = kern()
            e = max_err(out, want)
            skipped = sum(-(-L // (64 * t)) - len(pooled_ranges(n, L, t))
                          for n in lens)
            assert not bool(out[~live].any()), \
                f"{label} tiles={t}: a length-0 slot is not zeros"
            text = f"tiles={t} skipped={skipped} err={e:.2e}"
            if tol is not None:
                assert e < tol, f"{label} tiles={t}: max abs err {e} >= {tol}"
            else:
                r = bf16_ratios(out[live], want[live], slots)
                assert max(r) < 1, f"{label} tiles={t}: error {r} of limit"
                text += f" ratio={ratio_text(r)}"
            parts.append(text)
        if mutant is None:
            parts.append(f"tol={tol}")
        else:
            r_mut = bf16_ratios(mutant()[live], want[live], slots)
            assert min(r_mut) > 1, f"{label}: a zeroed tile is within the " \
                f"limit {r_mut}"
            parts.append(f"zeroed_tile_ratio={ratio_text(r_mut)}")
        zero = " length-0 slot rows all zero" if slots < len(lens) else ""
        lines.append(f"{label}: " + "; ".join(parts) + zero)
    return lines


def path_parity(dev):
    """Phase 5: the same 2-layer full-width fp32 weights on cuda and cpu.

    The hard decision is mean(p_fa) > 0.5 (strict), so a layer whose
    p_fa sits within rounding of 0.5 could route differently on the two
    devices. The prompt seed is the first whose router margins all exceed
    1e-3, found on the card; the CPU run must agree with it."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import routing_pattern
    from repro_torch.models import model as MD
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config(ARCH).replace(num_layers=2, dtype=torch.float32,
                                   param_dtype=torch.float32)
    params = MD.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    S, N = 2304, 8
    assert S > cfg.flux.sink + cfg.flux.local
    engines = {d.type: ServeEngine(params, cfg, max_len=S + N,
                                   prefill_chunk=CHUNK, device=d)
               for d in (dev, torch.device("cpu"))}
    for seed in range(32):
        toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                    (1, S))
        pf = MD.prefill(engines["cuda"].params, cfg,
                        torch.as_tensor(toks[:, :CHUNK],
                                        device=engines["cuda"].device),
                        routing_ctx="hard_prefix", want_cache=False)
        if float(np.abs(pf.p_fa.numpy() - 0.5).min()) > 1e-3:
            break
    else:
        raise AssertionError("no prompt seed with router margins > 1e-3")
    out = [f"prompt_seed={seed}"]
    for override in (None, routing_pattern(cfg, "mixed")):
        res = {d: e.generate(toks, N, routing_override=override)
               for d, e in engines.items()}
        g, c = res["cuda"], res["cpu"]
        err = float((g.logits.cpu() - c.logits).abs().max())
        assert g.routing == c.routing, (g.routing, c.routing)
        assert np.array_equal(g.tokens, c.tokens), (g.tokens, c.tokens)
        assert err < 2e-3, err  # fp32 both; summation order only
        if override is None:
            margin = float(np.abs(c.p_fa - 0.5).min())
            assert margin > 1e-3, c.p_fa
            out.append(f"p_fa={np.round(c.p_fa, 5).tolist()}")
        out.append(f"{'router' if override is None else 'mixed'} "
                   f"routing={''.join(p[0] for p in g.routing)} "
                   f"logits_err={err:.2e} tokens={g.tokens[0].tolist()}")
    return "; ".join(out)


def prefill_launches(cfg, admissions):
    """Each prefill kernel's launches for these (pattern, prompt length)
    admissions through the chunked prefill: flash (FA layers) and
    streaming (SA layers) once per layer on the routing chunk,
    block-sparse once per FA layer on every later chunk."""
    from repro_torch.serve.engine import chunk_plan
    want = {"flash_attention": 0, "streaming_attention": 0,
            "block_sparse_attention": 0}
    for pattern, n in admissions:
        n_fa = sum(p == "fa" for p in pattern)
        want["flash_attention"] += n_fa
        want["streaming_attention"] += cfg.num_layers - n_fa
        want["block_sparse_attention"] += n_fa * (len(chunk_plan(n, CHUNK))
                                                  - 1)
    return want


def router_margin_seed(engine, lens, max_seed=32):
    """The first prompt seed whose prompts' router decisions all sit more
    than 1e-3 from the 0.5 threshold on the card (the hard decision is a
    strict mean(p_fa) > 0.5, so a closer tie could flip on rounding), and
    its prompts."""
    from repro_torch.models import model as MD
    cfg = engine.cfg
    for seed in range(max_seed):
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
        margins = []
        for toks in prompts:
            pf = MD.prefill(engine.params, cfg,
                            torch.as_tensor(toks[None, :CHUNK],
                                            device=engine.device),
                            routing_ctx="hard_prefix", want_cache=False)
            margins.append(float(np.abs(pf.p_fa.numpy() - 0.5).min()))
        if min(margins) > 1e-3:
            return seed, prompts, min(margins)
    raise AssertionError("no prompt seed with router margins > 1e-3")


def pool_parity(dev):
    """Phase 5b: the slot-pool scheduler on cuda and cpu with the same
    2-layer full-width fp32 weights. Returns its report line."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (PREFILL_CHUNKS_PER_TICK,
                                          routing_pattern)
    from repro_torch.models import model as MD
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.scheduler import STATUS_OK, ContinuousScheduler
    cfg = get_config(ARCH).replace(num_layers=2, dtype=torch.float32,
                                   param_dtype=torch.float32)
    params = MD.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lens, N = (2304, 1536, 1000, 700, 2304), 8
    engines = {name: ServeEngine(params, cfg, max_len=max(lens) + N,
                                 prefill_chunk=CHUNK, device=d)
               for name, d in (("card", dev), ("cpu", "cpu"))}
    seed, prompts, margin = router_margin_seed(engines["card"], lens)
    out = [f"prompt_seed={seed} min_margin={margin:.2e}"]
    for name, override in (("router", None),
                           ("mixed", routing_pattern(cfg, "mixed"))):
        res = {}
        for d, eng in engines.items():
            sched = ContinuousScheduler(
                eng, slots_per_bucket=2, chunk=4,
                prefill_chunks_per_tick=PREFILL_CHUNKS_PER_TICK)
            for rid in range(4):
                eng.submit(Request(rid=rid, tokens=prompts[rid], n_steps=N,
                                   routing_override=override))
            while not sched.n_active():
                eng.step()
            eng.submit(Request(rid=4, tokens=prompts[4], n_steps=N,
                               priority=9, routing_override=override))
            res[d] = (eng.drain(), sched)
        (g, gs), (c, cs) = res["card"], res["cpu"]
        preempt = sum(f.metrics.preemptions for f in g.values())
        for rid, toks in enumerate(prompts):
            assert g[rid].status == c[rid].status == STATUS_OK, rid
            assert g[rid].routing == c[rid].routing, (rid, name)
            assert np.array_equal(g[rid].tokens, c[rid].tokens), (rid, name)
            alone = engines["card"].generate(toks[None], N,
                                             routing_override=override)
            assert np.array_equal(g[rid].tokens, alone.tokens[0]), (rid,
                                                                    name)
            assert g[rid].routing == alone.routing
        assert preempt == sum(f.metrics.preemptions for f in c.values())
        assert gs.n_geometries() == cs.n_geometries()
        if override is not None:
            assert preempt >= 1, "the mixed drain did not preempt"
        out.append(f"{name}: geometries={gs.n_geometries()} "
                   f"preemptions={preempt} ticks={gs.ticks} routing="
                   + ",".join("".join(p[0] for p in g[r].routing)
                              for r in range(len(lens)))
                   + f" tokens4={g[4].tokens.tolist()}")
    return "; ".join(out)


def main_path(dev, params):
    """Phase 6: full phi3-mini in bf16 through the batch frontend."""
    import repro_torch.kernels as KN
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import routing_pattern
    from repro_torch.serve.engine import (Request, ServeEngine,
                                          serve_batch_finished)
    cfg = get_config(ARCH)
    eng = ServeEngine(params, cfg, max_len=PROMPT + GEN, prefill_chunk=CHUNK,
                      device=dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (REQUESTS, PROMPT))
    mixed = routing_pattern(cfg, "mixed")
    lines = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    KN.reset_launch_counts()
    for name, override in (("router", None), ("mixed", mixed)):
        before = KN.launch_counts()
        reqs = [Request(rid=i, tokens=prompts[i], n_steps=GEN,
                        routing_override=override)
                for i in range(REQUESTS)]
        done = serve_batch_finished(eng, reqs)
        gen = done[0].result
        assert all(len(done[i].tokens) == GEN for i in range(REQUESTS))
        assert gen.logits.shape == (REQUESTS, cfg.vocab_size)
        assert bool(torch.isfinite(gen.logits).all()), "first logits"
        assert bool(torch.isfinite(gen.final_logits).all()), "last logits"
        delta = {k: v - before[k] for k, v in KN.launch_counts().items()}
        n_fa = sum(p == "fa" for p in gen.routing)
        n_sa = cfg.num_layers - n_fa
        n_chunks = PROMPT // CHUNK
        want = {"flash_attention": n_fa, "streaming_attention": n_sa,
                "block_sparse_attention": n_fa * (n_chunks - 1),
                "decode_attention": GEN * cfg.num_layers,
                "decode_attention_pooled": 0}
        assert delta == want, (delta, want)
        lines.append(
            f"{name}: routing={''.join(p[0] for p in gen.routing)} "
            f"msr={gen.msr:.3f} kv_bytes={gen.kv_bytes} "
            f"prefill_s={gen.prefill_s:.3f} "
            f"prefill_tok_s={REQUESTS * PROMPT / gen.prefill_s:.0f} "
            f"decode_s={gen.decode_s:.3f} "
            f"decode_tok_s={REQUESTS * GEN / gen.decode_s:.1f} "
            f"launches={delta} tokens0={done[0].tokens[:8].tolist()}")
    counts = KN.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    for k, n in counts.items():
        if k != "decode_attention_pooled":
            assert n > 0, f"{k} was never launched on the batch path"
    lines.append(f"peak_mem_bytes={peak} card={torch.cuda.get_device_name(0)}")
    return counts, lines


def continuous_path(dev, params):
    """Phase 7: full phi3-mini in bf16 through the continuous frontend."""
    import repro_torch.kernels as KN
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (PREFILL_CHUNKS_PER_TICK,
                                          routing_pattern)
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.scheduler import STATUS_OK, ContinuousScheduler
    cfg = get_config(ARCH)
    eng = ServeEngine(params, cfg, max_len=PROMPT + GEN, prefill_chunk=CHUNK,
                      device=dev)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT // (1 + rid % 3))
               for rid in range(8)]
    mixed, fa = routing_pattern(cfg, "mixed"), routing_pattern(cfg, "fa")
    override = [mixed] * 4 + [fa, fa, None, mixed]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    KN.reset_launch_counts()
    t0 = time.perf_counter()
    # the CLI's prefill budget: with 1 chunk a tick, each 2048-4096-token
    # prompt takes 4-8 ticks to stream while a resident request leaves
    # after 4 (32 tokens in chunks of 8), so a 4-slot pool never fills
    sched = ContinuousScheduler(
        eng, slots_per_bucket=4, chunk=8,
        prefill_chunks_per_tick=PREFILL_CHUNKS_PER_TICK)
    for rid in range(7):
        eng.submit(Request(rid=rid, tokens=prompts[rid], n_steps=GEN,
                           routing_override=override[rid]))
    for _ in range(64):
        eng.step()
        pool = next((p for p in sched.pools.values() if p.pattern == mixed),
                    None)
        if pool is not None and pool.occupancy() == pool.capacity:
            break
    else:
        raise AssertionError("the mixed pool never filled")
    eng.submit(Request(rid=7, tokens=prompts[7], n_steps=GEN, priority=9,
                       routing_override=mixed))
    done = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = KN.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    assert sorted(done) == list(range(8))
    for rid, f in done.items():
        assert f.status == STATUS_OK, (rid, f.status)  # all logits finite
        assert len(f.tokens) == GEN, (rid, len(f.tokens))
        if override[rid] is not None:
            assert f.routing == override[rid], rid
    preempt = sum(f.metrics.preemptions for f in done.values())
    assert preempt >= 1, "no preemption"
    assert 2 <= sched.n_geometries() <= 3, sched.n_geometries()
    steps = [p.steps for p in sched.pools.values()]
    want = prefill_launches(cfg, sched.admissions)
    want.update(decode_attention=0,
                decode_attention_pooled=sum(steps) * cfg.num_layers)
    assert counts == want, (counts, want)
    tokens = sum(f.metrics.n_generated for f in done.values())
    summ = done.summary
    lines = [
        f"requests=8 prompt_lens={[len(p) for p in prompts]} "
        f"tokens={tokens} wall_s={wall:.3f} tok_s={tokens / wall:.1f} "
        f"ttft_p50_s={summ['ttft_p50_s']:.3f} "
        f"prefill_time_p50_s={summ['prefill_time_p50_s']:.3f} "
        f"slot_wait_p50_s={summ['slot_wait_p50_s']:.3f}",
        f"geometries={sched.n_geometries()} pool_steps={steps} "
        f"pool_patterns="
        + ",".join("".join(p[0] for p in pl.pattern)
                   for pl in sched.pools.values())
        + f" ticks={sched.ticks} preemptions={preempt} "
        f"admissions={len(sched.admissions)} "
        f"kv_payload_bytes={summ['kv_payload_bytes']} peak_mem_bytes={peak}",
        f"launches={counts} tokens7={done[7].tokens[:8].tolist()}"]
    return counts, lines


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False); it runs on an NVIDIA "
                         "GPU only")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build  # fails outside the repo
    dev = torch.device("cuda")
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    say(1, f"torch {torch.__version__} cuda {torch.version.cuda} "
           f"device {torch.cuda.get_device_name(0)} "
           f"count {torch.cuda.device_count()}", t0)

    t0 = time.perf_counter()
    built = _build.build()
    say(2, "built " + ", ".join(f"{k} {v:.1f} s" for k, v in built.items()),
        t0)
    for line in wgmma_report(-(-(PROMPT + GEN) // 64)) + decode_report():
        say(2, line)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    errs = {}
    for name, (kern, plain, mutant, *_rest) in kernel_cases(
            dev, torch.bfloat16, True).items():
        out, want = kern(), plain()
        errs[name] = max_err(out, want)
        slots = len(POOL_LENS) if name == "decode_attention_pooled" else 1
        r = bf16_ratios(out, want, slots)
        r_mut = bf16_ratios(mutant(), want, slots)
        assert max(r) < 1, f"{name} bf16: error {r} of the limit"
        assert min(r_mut) > 1, f"{name} bf16: a zeroed tile is within " \
            f"the limit {r_mut}"
        say(3, f"{name} bfloat16 main shapes max_abs_err={errs[name]:.3e} "
               f"limit_ratio={ratio_text(r)} "
               f"zeroed_tile_ratio={ratio_text(r_mut)}")
    for name, (kern, plain, *_rest) in kernel_cases(
            dev, torch.float32, False).items():
        out = kern()
        e = max_err(out, plain())
        assert e < FP32_TOL, f"{name} fp32: max abs err {e} >= {FP32_TOL}"
        extra = ""
        if name == "decode_attention_pooled":  # slot 0 holds nothing
            assert not bool(out[:8].any()), "a length-0 slot is not zeros"
            extra = " length-0 slot rows all zero"
        say(3, f"{name} float32 G=4 D=128 unaligned max_abs_err={e:.3e} "
               f"tol={FP32_TOL}{extra}")
    for name, check in (("decode_attention", ring_decode_check),
                        ("decode_attention_pooled", pooled_ring_check)):
        e, r, r_mut = check(dev)
        assert max(r) < 1, f"ring {name} bf16: error {r} of the limit"
        assert min(r_mut) > 1, f"ring {name} bf16: a zeroed tile is " \
            f"within the limit {r_mut}"
        say(3, f"{name} bfloat16 ring main shapes max_abs_err={e:.3e} "
               f"limit_ratio={ratio_text(r)} "
               f"zeroed_tile_ratio={ratio_text(r_mut)}")
    for label, kern, plain, mutant in wgmma_cases(dev):
        out, want = kern(), plain()
        e, r = max_err(out, want), bf16_ratios(out, want)
        r_mut = bf16_ratios(mutant(), want)
        assert max(r) < 1, f"{label} bf16: error {r} of the limit"
        assert min(r_mut) > 1, f"{label} bf16: a zeroed tile is within " \
            f"the limit {r_mut}"
        say(3, f"{label} G=4 Sq=200 Skv=300 bfloat16 max_abs_err={e:.3e} "
               f"limit_ratio={ratio_text(r)} "
               f"zeroed_tile_ratio={ratio_text(r_mut)}")
    for label, kern, plain, mutant, tol in decode_split_cases(dev):
        out, want = kern(), plain()
        e = max_err(out, want)
        if tol is not None:
            assert e < tol, f"{label}: max abs err {e} >= {tol}"
            say(3, f"{label} max_abs_err={e:.3e} tol={tol}")
            continue
        r, r_mut = bf16_ratios(out, want), bf16_ratios(mutant(), want)
        assert max(r) < 1, f"{label}: error {r} of the limit"
        assert min(r_mut) > 1, f"{label}: a zeroed tile is within the " \
            f"limit {r_mut}"
        say(3, f"{label} max_abs_err={e:.3e} limit_ratio={ratio_text(r)} "
               f"zeroed_tile_ratio={ratio_text(r_mut)}")
    for line in pooled_split_check(dev):
        say(3, line)
    say(3, "kernels agree with their plain versions", t0)

    t0 = time.perf_counter()
    rows = {}
    for name, (kern, plain, _, lib, n_bytes, flops) in kernel_cases(
            dev, torch.bfloat16, True).items():
        b_ms, b_by = bound(n_bytes, flops)
        rows[name] = dict(ms=time_ms(kern), plain_ms=time_ms(plain),
                          library_ms=time_ms(lib), bound_ms=b_ms,
                          bound_by=b_by, call_ms=call_ms(kern))
        r = rows[name]
        say(4, f"{name} ms={r['ms']:.4f} call_ms={r['call_ms']:.4f} "
               f"plain_ms={r['plain_ms']:.4f} "
               f"library_ms={r['library_ms']:.4f} bound_ms={b_ms:.4f} "
               f"({b_by}; {n_bytes} bytes, {flops} flops) "
               f"roofline_share={b_ms / r['ms']:.3f}")
    kern, plain, _, lib, n_bytes, flops = ring_decode_case(dev)
    b_ms, b_by = bound(n_bytes, flops)
    ring = dict(ms=time_ms(kern), plain_ms=time_ms(plain),
                library_ms=time_ms(lib), bound_ms=b_ms, bound_by=b_by,
                call_ms=call_ms(kern))
    rows["decode_attention"]["ring"] = ring
    say(4, f"decode_attention ring L=2176 ms={ring['ms']:.4f} "
           f"call_ms={ring['call_ms']:.4f} plain_ms={ring['plain_ms']:.4f} "
           f"library_ms={ring['library_ms']:.4f} bound_ms={b_ms:.4f} "
           f"({b_by}; {n_bytes} bytes, {flops} flops) "
           f"roofline_share={b_ms / ring['ms']:.3f}")
    kern, plain, _, lib, n_bytes, flops = pooled_ring_case(dev)
    b_ms, b_by = bound(n_bytes, flops)
    ring = dict(ms=time_ms(kern), plain_ms=time_ms(plain),
                library_ms=time_ms(lib), bound_ms=b_ms, bound_by=b_by,
                call_ms=call_ms(kern))
    rows["decode_attention_pooled"]["ring"] = ring
    say(4, f"decode_attention_pooled ring L=2176 lens={RING_POOL_LENS} "
           f"ms={ring['ms']:.4f} call_ms={ring['call_ms']:.4f} "
           f"plain_ms={ring['plain_ms']:.4f} "
           f"library_ms={ring['library_ms']:.4f} bound_ms={b_ms:.4f} "
           f"({b_by}; {n_bytes} bytes, {flops} flops) "
           f"roofline_share={b_ms / ring['ms']:.3f}")
    pool_sweep, pool_bounds = pooled_tiles_sweep(dev)
    rows["decode_attention_pooled"].update(
        tiles=next(t for t, (*_, plan) in pool_sweep[POOL_SWEEP_SLOTS[0]]
                   .items() if plan),
        ms_by_slots_and_tiles={b: {t: ms for t, (ms, _, _) in by_t.items()}
                               for b, by_t in pool_sweep.items()})
    for b, by_t in pool_sweep.items():
        say(4, f"decode_attention_pooled ms (call_ms) by tiles a range "
            f"({b} slots of {POOL_LENS} cycled, L 4128, bound_ms "
            f"{pool_bounds[b]:.4f}): "
            + " ".join(f"{t}{'*' if plan else ''}={ms:.4f} ({c:.4f})"
                       for t, (ms, c, plan) in by_t.items())
            + " (* the plan's)")
    sweep = decode_split_sweep(dev)
    rows["decode_attention"].update(
        n_split=next(n for n, (_, plan) in sweep[max(sweep)].items() if plan),
        ms_by_rows_and_n_split={bh: {n: ms for n, (ms, _) in by_n.items()}
                                for bh, by_n in sweep.items()})
    for bh, by_n in sweep.items():
        say(4, f"decode_attention ms by n_split ({bh} rows, L 4128): "
            + " ".join(f"{n}{'*' if plan else ''}={ms:.4f}"
                       for n, (ms, plan) in by_n.items()) + " (* the plan's)")
    torch.cuda.empty_cache()
    say(4, f"timed at {card}", t0)

    t0 = time.perf_counter()
    say(5, path_parity(dev), t0)
    t0 = time.perf_counter()
    say("5b", pool_parity(dev), t0)
    torch.cuda.empty_cache()

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    params = init_params(get_config(ARCH),
                         torch.Generator(device=dev).manual_seed(0), dev)
    t0 = time.perf_counter()
    batch_counts, lines = main_path(dev, params)
    for line in lines:
        say(6, line)
    say(6, "batch path done", t0)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cont_counts, lines = continuous_path(dev, params)
    for line in lines:
        say(7, line)
    say(7, "continuous path done", t0)

    import repro_torch.kernels as KN
    kernels = []
    for name, replaces in REPLACES.items():
        src = _build.CSRC / f"{KN.KERNELS[name].source}.cu"
        # each kernel's count from the path it was ported for: the batch
        # path for the first four, the slot pool for the pooled decode
        own = cont_counts if name == "decode_attention_pooled" \
            else batch_counts
        kernels.append(dict(name=name, route="cuda",
                            source=str(src.relative_to(ROOT)),
                            replaces=replaces, launches=own[name],
                            launches_by_path={"batch": batch_counts[name],
                                              "continuous": cont_counts[name]},
                            max_abs_err=errs[name], **rows[name]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"total {time.perf_counter() - t_all:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
