#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--parent SRC]

``--parent SRC`` (another checkout's ``src``, e.g. a ``git archive`` of
the parent commit) builds that tree's kernels too and times its latent
decode and its attention backward beside this tree's in phase 4. Phases,
each printing one line (any failure raises and exits non-zero; nothing
falls back to the CPU):
  1. the card (``nvidia-smi`` name and power limit), torch and CUDA;
  2. build the hand-written attention kernels from ``csrc/``, and
     print the compiler's report (registers, spills, shared memory) and
     the SASS's HGMMA / UTMALDG counts of the bf16 tensor-core (wgmma)
     engine in the flash, block-sparse and streaming kernels at each head
     dim (flash and streaming also at (Dk, Dv) = (192, 128)), and the
     report of the batch and slot-pool split decode kernels, their merge
     kernels and the latent (MLA) decode kernels: the fp32 one on the
     CUDA cores and the bf16 one on the tensor cores (its registers,
     spills, shared memory and SASS HGMMA / UTMALDG counts, which must be
     > 0);
  2b. the stress phase (run after phase 30, beside the parity worker):
     every bf16 wgmma instance
     the main paths run (flash, streaming and block-sparse at D = 64, 96
     and 160 at granite's, phi3-mini's and stablelm's main shapes, flash
     and streaming at (192, 128), the latent decode over POOL_LENS and
     over the ring) STRESS_CALLS times each, every other call into an
     output pre-filled with NaN (the entries' test-only ``out=``), so an
     element the kernel never writes shows on each such call: the
     outputs holding a non-finite element and the elements past phase
     3's bf16 limit against the plain version (computed once) must both
     count 0;
  3. each kernel against its plain PyTorch version on the card: at the
     main paths' shapes in bf16 (the pooled decode kernel at the slot
     pool's: 4 slots of ragged live lengths, over a FullKV and over a
     ring whose entries are shuffled and partly empty), where every
     element must satisfy
     |kernel - plain| <= 0.05 * rms(plain) + 2**-7 * |plain| (one bf16 ulp
     of the output's own rounding beside a twentieth of a typical output
     value; the pooled kernel's rms is taken per slot, since a slot's
     outputs shrink with its live length), and at one GQA G = 4,
     unaligned case at D = 128 and at D = 160 in fp32 (max abs error
     1e-4; the pooled kernel's holds a length-0 slot, whose rows must be
     zeros). To show the bf16 limit can
     see a wrong tile, the plain version with one 64-key tile of V zeroed
     must break it (the pooled kernel's: in every slot, the last full tile
     of that slot's live keys); the bf16 main-shape checks run at
     phi3-mini's shapes (D = 96, G = 1) and at stablelm-12b's (D = 160,
     G = 4). The flash, block-sparse and streaming
     kernels run bf16 on their wgmma engine and fp32 on the CUDA cores,
     so the wgmma engine
     is also held to the bf16 limit (and its zeroed tile must break it) at
     each head dim 32 / 64 / 96 / 128 / 160 with G = 4, Sq = 200 queries at
     offset 100 over Skv = 300 keys: flash causal and bidirectional,
     block-sparse over a selection with holes, tiles past the diagonal
     and past Skv, and a duplicate removed by ``dedupe_selection``, and
     streaming at sink 0 / 16 / 100 and local 48 / 130; the split decode
     kernel at n_split 1, 2, 7 and the plan's (bf16, main shapes), with
     splits that hold no live key (cur_pos 1000) and a row with none
     (cur_pos -1), and over a shuffled, partly empty ring of 300 slots at
     each of those counts, at each head dim with G = 1 and G = 4 and at
     D = 128 with G = 12 (command-r): bf16 under the bf16 limit (its
     zeroed tile above it), fp32 within 1e-4;
     the split pooled decode kernel at 1, 4 and 16 tiles a range and the
     plan's over the main path's FullKV pool (ranges past the shallow
     slots' lengths skipped), and over 4 slots of lengths 0 / 1 / 137 /
     300 at L 300, FullKV and a shuffled ring with holes (one 64-key range
     wholly masked), at 1, 2 and 5 tiles a range and the plan's, at each
     head dim with G = 1 and G = 4 and at D = 128 with G = 12: bf16 under
     the limit per live slot
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
     (POOL_LENS cycled); then the five kernels again at stablelm-12b's
     main shapes (D = 160, G = 4: 128 query rows over 32 KV rows);
  5. phi3-mini at full width, depth cut to 2 layers, fp32: the same
     weights (drawn on the card) served on cuda (kernels) and on cpu
     (plain versions), a
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
     decode kernel never);
  8. the prefix path: the same model with the shared-prefix snapshot
     store. Batch: prompts A and B of 4096 tokens share a 3072-token
     preamble; an engine with a 4096 MB device tier and a 6144 MB pinned
     host tier serves A (cold, publishing 8 boundary snapshots), then
     ``offload_all``, A again (a full-cover hit from the host tier) and B
     (a 3072-token hit, 2 chunks streamed); tokens and first logits must
     be bitwise equal to an engine without a store, the store must
     demote, promote and drop, and the launch counts are exact (no flash
     or streaming launch on a hit). Continuous: 8 requests of a shared
     2048-token preamble and tails of 2048 / 1024 / 512 tokens through
     the slot pool with an 8192 MB store; every request after the first
     hits, tokens bitwise equal a drain without a store, exact launch
     counts; the step where each stream first departs from ``generate``
     of that request alone (the batch decode kernel, whose other splits
     round differently in bf16) is printed. Prints the snapshot bytes,
     the device time of a publish copy, the host time of a demotion and
     of a host-tier restore (GB/s), cold and warm prefill seconds and
     TTFT p50, and the store's stats.
  9. stablelm-12b (head dim 160, G = 4) at full width, depth cut to 2
     layers, fp32, card against CPU as in phase 5; 9b. one such layer
     through the slot-pool scheduler as in phase 5b;
  10. the batch path of stablelm-12b at full width, depth cut to
     STABLELM_LAYERS = 10 of its 40 layers, bf16, as phase 6 (phi3-mini's
     weights freed first);
  11. its continuous path, as phase 7;
  12. command-r-plus-104b (G = 12, tied embeddings) at full width, depth
     cut to 8 of its 64 layers (the whole model is 208 GB in bf16), bf16,
     2 requests of 4096 tokens through the batch path with the mixed
     override: every logit finite, exact launch counts;
  13. the guarded drain, card against CPU: phase 5's phi3-mini (full
     width, 2 layers, fp32, its own weights from seed 0) under one SLO
     config (a queue of 3 shedding the lowest priority, a preemption
     budget of 1, aging, the sparsity dial), one tick-advanced virtual
     clock, telemetry and a fidelity probe at every admission: 10
     requests of 2304 / 1536 / 1000 / 700 tokens, 2 slots a pool, decode
     chunks of 4, 8 new tokens; one is shed at its submit, one expires
     queued, one preempts, one is cancelled while resident and one is
     faulted (``inject_fault``) after its first decode tick. Both devices
     give the same statuses (all five), routing, tokens, rung after every
     tick, preemptions and ``metrics_text`` counters (histograms by
     count), coverage within 1e-4 per routed layer; the faulted
     request's pool siblings equal, bitwise, the same drain without the
     fault on the card;
  14. the guarded drain at full width, GUARD_LAYERS = 16 of 32 layers:
     phi3-mini-3.8b's seeded bf16 weights (drawn again after phase
     12), 12 requests of 4096 //
     (1 + rid % 3) tokens, 32 new tokens, 4 slots a pool, chunks of 8, 16
     prefill chunks a tick, on the real clock, with telemetry, the
     profiler every 4 ticks, the probe every 4 admissions and the memory
     ledger: every request retires once, all five statuses by
     construction, the siblings of the faulted request bitwise equal the
     same drain without the fault, tokens bitwise equal the same drain
     with every knob off, the rung rises and moves a layer FA -> SA,
     exact launch counts (flash once per layer per probe beside the
     routing chunks), ``metrics_text`` parses, the trace validates with
     one span per request, the ledger equals the pools' tensor bytes
     after every tick, and the profiler's expressed decode bytes over its
     device time stay within 1.05 of 3.35 TB/s. Prints the walls and
     TTFT p50 with telemetry on and off (no limit on either: host-bound
     walls move 30-40 % between runs), the ledger's peak beside
     ``torch.cuda.max_memory_allocated``, the coverage per layer and the
     rung trace.
  15. granite-moe-3b-a800m (40 experts top-8 in every layer, head dim 64,
     G = 3) at full width, depth cut to 2 layers, fp32, the same weights
     on the card and on the CPU: ``generate`` of a 2304-token prompt,
     chunk 512, 8 tokens, router-driven and mixed (routing, tokens and
     every MoE call's experts identical, first-step logits within 2e-3;
     the prompt seed is the first whose router margins exceed 1e-3 and
     whose smallest gap between a token's 8th and 9th gate probability
     on the card exceeds MOE_GAP), the slot-pool drain of phase 5b,
     layer 0's ``moe_apply`` over one chunk with drops (y within 1e-4,
     the same kept set), and a drain with one slot poisoned whose pool
     siblings stay bitwise equal to the drain without the fault;
  16. granite at full width, depth cut to GRANITE_LAYERS = 4 of its 32
     layers, bf16, seeded weights: the batch path as phase 6, the continuous
     path as phase 7 (every logit finite, exact launch counts, tok/s,
     TTFT p50, peak memory and KV bytes), and sampled ``generate``: one
     seed twice gives the same tokens, another seed others, and
     ``rng=None`` is greedy;
  17. deepseek-v2-236b narrowed for the CPU (2 layers, d_model 1024, 16
     heads, 8 experts top-6 + 2 shared) with its real per-head widths
     (q_lora 1536, kv_lora 512, nope 128, rope 64, v 128), fp32, the
     same weights on the card and on the CPU: ``generate`` router-driven
     and mixed (routing, tokens and every MoE call's experts identical,
     logits within 2e-3, seeds held to MOE_GAP as in phase 15) and the
     slot-pool drain of phase 5b;
  18. deepseek-v2-236b at full width, depth cut to 4 of its 60 layers
     (472 GB in bf16 whole), bf16, seeded weights: the batch path as
     phase 6, the continuous path as phase 7 (every logit finite, exact
     launch counts: flash and streaming at (192, 128) on the routing
     chunks, no block-sparse, since a latent chunk runs the absorbed
     attention in plain torch, and the latent decode once per layer per
     decode step on both frontends; tok/s, TTFT p50, peak memory and KV
     bytes a row), and a full-cover prefix hit bitwise equal to cold.
Phase 3 also holds every kernel at granite's grouping (G = 3, D = 64:
bf16 at its main shapes, fp32 small cases, both decode kernels' split
sweeps), and phase 4 also times the five kernels at granite's shapes.
Phase 3 also holds deepseek's instances: flash and streaming at (192,
128) and the latent decode (R 512, rope 64, 128 heads over one latent
KV row, scale 192 ** -0.5, over POOL_LENS and over a shuffled ring with
holes) in bf16 at the main path's shapes under the limit (a zeroed
tile of V, or of ``ckv`` in every slot, above it), the bf16 latent
decode also at the small case (slots of 0 / 1 / 137 / 300 keys at L
300, H = 32 and 16, FullKV and a ring with holes, 1 / 2 / 5 tiles a
range and the plan's: live slots under the limit, zeroed tiles above
it, the length-0 slot's rows zeros), fp32 at a small unaligned case
(the latent decode with a length-0 slot whose rows must be zeros);
phase 4 times flash and streaming beside SDPA (naming the backends that
refuse the shapes) and the latent decode at MLA_SHAPES (POOL_LENS, the
ring, long context: 4 slots of 32,768 keys, high batch: 64 slots of
4,096) beside SDPA, the parent's kernel (``--parent``) and its tiles a
range, each shape also held to the bf16 limit.
Phase 3 also holds the xa and ta calls: block-sparse at a real xa
selection (4 prompts of 4096 tokens at phi3-mini's and at stablelm's
widths, built on the card by ``xa_selection`` at the published block 128,
stride 16 and threshold 0.9: 4 of 32 blocks a query block, per head),
and the ta split (streaming over rows [0, b), flash at q_offset b; b =
100 of 300 keys, and b = 2048 of TA_PROMPT = 18,432 keys), each under
the bf16 limit with a zeroed tile above it; and an xa call on cuda at
block 16 must raise. Phase 4 times them at the main shapes beside their
plain versions and SDPA's efficient backend under the equivalent
boolean mask, with the plain-torch antidiagonal scoring's device time.
  19. phi3-mini at full width, 2 layers, fp32, card against CPU under the
     paper's comparison set: ``generate`` of a 3072-token prompt under xa
     (published block, stride and threshold) and ta (chunk 2048),
     router-driven and mixed, a duo override (("duo", 16), "sa") and
     ``prefill(routing_ctx="head_split", head_split_n=16)``: routing,
     every xa selection and the tokens identical, logits within 2e-3
     (the prompt seed is the first whose router margins exceed 1e-3 and
     whose smallest xa score gap at the keep-th place on the card
     exceeds XA_GAP); and a slot-pool drain under xa (XA_DRAIN: 4
     prompts, router-driven and mixed);
  20. phi3-mini-3.8b at full width, depth cut to SA_MODES_LAYERS = 8 of
     its 32 layers, bf16, seeded weights: the batch path of phase 6 under
     xa (router-driven and mixed) and with a duo override (the even
     layers split at 16 of 32 KV heads) through
     ``generate``, ta on one prompt of 18,432 tokens (boundary 2048 at
     the published chunk), and the continuous path of phase 7 under xa:
     every logit finite, exact launch counts (block-sparse once per SA
     layer an xa admission, flash once per FA layer and once more per SA
     layer under ta, streaming once per SA layer under ta and never under
     xa, the batch decode kernel never at a duo layer), and ssa at the
     same prompts beside them: prefill and decode tok/s, peak memory;
  21. modality side inputs, card against CPU in fp32 at full per-head
     widths: phi-3-vision-4.2b at 2 layers (576 image embeddings, then
     1728 tokens) and whisper-tiny at 2 encoder + 2 decoder layers (1500
     frames, 2304 decoder tokens) through ``generate``, router-driven,
     all-FA, all-SA and mixed: routing and tokens identical, first logits
     within FP32_TOL (the embeddings, frames and tokens are numpy draws
     of the first seed whose router margins exceed 1e-3);
  22. phi-3-vision-4.2b at full width and depth, bf16, seeded weights: 4
     requests of 576 image embeddings and 3520 tokens (4096 positions),
     32 new tokens, router-driven and mixed, through ``generate`` (the
     monolithic prefill and repack, as in JAX): every logit finite,
     exact launch counts (flash at FA layers, streaming at SA layers, the
     batch decode once a layer a step, block-sparse and the pooled
     decodes never), the slot pool refusing the model; prefill and
     decode tok/s, KV bytes, peak memory;
  23. whisper-tiny at full width and depth (4 + 4 layers), bf16: 4
     requests of 1500 frames and 384 decoder tokens, 32 new tokens (416
     positions in its 448-token context), router-driven and mixed: as
     phase 22, with flash at causal=False once an encoder layer (1500 x
     1500) and once a decoder layer (the cross attention, 384 x 1500),
     and the batch decode once more a layer a step over the 1500 encoder
     keys, each counted by ``SideRecorder``; the encode's seconds apart
     from the prefill's and the decode's;
  24. mamba2-780m's SSD at its full widths (B 4, H 48, P 64, N 128, Q
     256) on one seeded layer: ``ssd_chunked`` over S = 4096 and 1365 on
     the layer's own operands, then ``mamba_apply`` and 32
     ``mamba_decode_step``s, card against CPU in fp32 (1e-4 of the
     largest value) and the card in bf16 within phase 3's bf16 limit of
     the fp32 result;
  25. mamba2 at full width, 2 of 48 layers, fp32, card against CPU
     through phase 5's ``generate`` and phase 5b's drain (tokens
     identical, first logits within 2e-3); jamba-1.5-large-398b's smoke
     variant (one period: 7 Mamba layers, attention at index 3, MoE on
     the even layers) fp32 card = CPU under the router, all-FA, all-SA
     and mixed and through a drain, then in bf16 with exact launch
     counts of the five kernels (its attention layer only);
  26. mamba2-780m at full width, depth cut to MAMBA2_LAYERS = 6 of its
     48 layers, bf16, seeded weights: phase
     6's batch cell, phase 7's continuous cell and phase 8's prefix cell
     (warm = cold bitwise from the device and host tiers, a shared
     preamble drain), every attention kernel's launch count 0; prefill
     and decode tok/s, TTFT, the SSD state bytes a request, peak memory,
     and one prefill chunk's and one decode step's device time by
     operator (torch.profiler);
  27. gemma3-12b's smoke variant (5 local layers with a window of 16,
     then 1 routed; D = 32, G = 2) in fp32, card against CPU on the cases
     of ``tests/test_torch_gemma3.py``: ``generate`` of 8, 16 and 100
     tokens, 40 new ones (the local rings wrap), chunk 64 and
     monolithic, router-driven, all-FA, all-SA and alternating, and a
     drain with staggered arrivals and a preemption: routing, tokens,
     statuses and preemptions equal, first logits within 2e-3;
  28. gemma3-12b at full width, depth cut to GEMMA3_LAYERS = 6 of its 48
     layers (one period: 5 local with a 1024-token window, 1 routed; D =
     256, 16 heads over 8), bf16, seeded weights: phase 6's batch cell
     (router-driven, all-FA, all-SA), phase 7's continuous cell and phase
     8's prefix cell (stores in snapshots of its routed geometry), exact
     launch counts (streaming also once a local layer on a routing
     chunk), nonzero for all five kernels; every local ring holds 1024
     slots after a 4096-token admission.
Phases 3 and 4 also hold and time the five kernels at jamba's attention
layer (64 heads over 8 KV heads, D = 128) at the main shapes and its
ring decode over 2176 slots, and at gemma3's (4 x 16 heads over 4 x 8
KV heads, D = 256, G = 2), with its local layers' decode over a
1024-slot ring with no sink and the window (the streaming kernel at sink
0, local 1024) over 4 prompts of 4096 tokens; phase 2b stresses gemma3's
flash, streaming and block-sparse and that window; phase 3 holds every
kernel in fp32 at D = 256, G = 2, and the wgmma small cases cover
D = 256.
Phase 2b also stresses flash at whisper's encoder shape (causal=False,
4 x 6 heads, D = 64, 1500 x 1500); phases 3 and 4 hold and time
flash with causal=False at 1500 x 1500 and 384 x 1500 and the batch
decode over 1500 keys all visible, at those heads, beside SDPA without
a mask (``side_kernel_cases``).
Training (slices 16-17): phase 2 also prints the attention backward
kernel's registers, spills and shared memory per instance, and for its
bf16 tensor-core instances (``csrc/backward_wgmma.cuh``) the dynamic
shared memory and the SASS's HGMMA / UTMALDG counts, which must be > 0,
with no spill; phase 2b stresses the bf16 backward at phi3-mini's
training shapes (causal and streaming), whisper's encoder and the
unaligned G = 4 case (causal and one streaming mask at every head dim)
into NaN-prefilled dq / dk / dv and a NaN-prefilled stats scratch;
phase 3 holds it against the plain version's autograd (dq, dk and dv
each to the bf16 limit with rms per tensor, where the plain gradients
with one V tile zeroed must break it on dk; fp32 within FP32_TOL at the
unaligned G = 4 case at every head dim) at phi3-mini's and
stablelm-12b's training shapes, gemma3's window and whisper's
bidirectional encoder; phase 4 times it at every one of those main
shapes and at the unaligned D = 128 causal case beside SDPA's forward +
backward (and the parent's kernel with ``--parent``).
Slice 20 adds the backward at MLA's (Dk, Dv) = (192, 128) (deepseek-v2's
route chunk in training, 2 x 128 heads x DEEPSEEK_TRAIN_S, causal and
streaming, and the unaligned case) and the block-sparse backward
(``csrc/block_sparse_backward.cu``, ``sparse_backward_cases``: xa's
training shapes for phi3-mini and deepseek-v2 with the selection made on
the card, and the unaligned case with G = 1, 2 and 4 and a selection that
differs per head, at every head dim and (192, 128)) to phases 2 (both
libraries' registers), 2b, 3 (bf16 and fp32, as above) and 4 (beside SDPA
forward + backward under the same boolean mask, the backend named);
phases 3 and 4 also hold and time the block-sparse forward at (192, 128)
(``xa_case`` of deepseek-v2: one prompt of PROMPT tokens, 128 heads);
``refusal_checks`` asserts that xa and flash / streaming at (192, 128)
train on the card (one backward launch each, finite gradients) and that
a decode kernel still refuses grad.
  29. phi3-mini at 2 layers, fp32: one RouterTrainer step, one
     PretrainTrainer and one ContinuedTrainer step on the card and on
     the CPU from the same weights, batches and Gumbel noise: losses,
     gradients and states within TRAIN_TOL (last in the parity worker);
     Slice 20 adds ``parity_cases``: PARITY_XA_STEPS router steps of
     phi3-mini (2 layers) under xa and of phase 17's narrowed deepseek-v2
     under ssa and xa, card against CPU within TRAIN_TOL;
  30. router training of phi3-mini-3.8b at full width, depth cut to
     TRAIN_LAYERS = 16 of 32 layers, in bf16
     through ``launch/train.py``'s code path: TRAIN_STEPS steps of
     TRAIN_B x TRAIN_S tokens, exact launch counts, one step under the
     profiler, the backbone bitwise unchanged, a checkpoint round trip
     and one request served with the trained routers; then
     TRAIN_CELL_STEPS steps of the same under xa (``train_cell``: the
     block-sparse forward and backward at the SA layers, exact launches,
     the device's busy share and the backward kernels' share of it, the
     backbone bitwise unchanged); after phase 29's
     comparison, QUIET_STEPS more steps and one more profiled step, timed
     with the host to the script alone. 30b (run right after phase 18,
     on its weights): deepseek-v2-236b at full width, DEEPSEEK_LAYERS
     layers, TRAIN_CELL_STEPS router-training steps of TRAIN_B x
     DEEPSEEK_TRAIN_S under ssa and under xa (``train_cell``: the
     (192, 128) backward and the block-sparse one); phase 18 also serves
     two prompts under xa (``deepseek_xa_serve``: the block-sparse kernel
     at (192, 128) once an SA layer).
  31. tensor-parallel serving (slice 18), run after phase 26:
     TP_WORLD = 2 ranks (processes,
     ``distributed/group.py`` ``launch``) on the one card over gloo (NCCL
     refuses two ranks on one device), each holding half of the heads,
     KV heads and FFN width. (a) phi3-mini at full width, 2 layers,
     fp32: ``generate`` and a 4-request drain with a priority arrival
     that preempts, router-driven and mixed, on the ranks and on one
     device: tokens, routing and statuses equal, logits within 1e-4 of
     the largest; (b) phi3-mini at full width, TP_LAYERS = 8 of 32
     layers, in bf16: 2 x
     TP_PROMPT tokens through ``generate`` (TP_GEN steps, router-driven
     and mixed) and TP_REQUESTS requests on TP_SLOTS slots through the
     drain, finite, each rank's exact launches of all five kernels, its
     KV bytes half the one-device pool's, a decode step's all-reduces 2
     x layers of (B, 1, d_model); per-rank peak memory and tok/s,
     labelled "2 ranks on one card over gloo" (they say nothing of TP
     speed over several cards).
  32. tensor-parallel serving of the MoE, MLA, Mamba and encoder archs
     (slice 19), after phase 31, its TP_WORLD = 2 ranks spawned once:
     (a) fp32, each of granite-moe at full width and 2 layers, deepseek
     narrowed as in phase 17, mamba2 at 2 layers, jamba's smoke variant
     and whisper at 2 + 2 layers, drawn as each rank's share
     (``init_params_tp``): ``generate`` router-driven and mixed and, but
     for whisper (the slot pool refuses an encoder), a 4-request drain
     with a preempting arrival, against the one-device card run on the
     same weights: routing, tokens, every MoE call's experts, statuses
     and preemptions equal, logits within 1e-4 of the largest (the
     prompt seed the first whose router margins exceed 1e-3 and whose
     top-k gate gaps exceed MOE_GAP); (b) deepseek-v2-236b at full
     width, DEEPSEEK_LAYERS layers, bf16, each rank's share drawn layer
     by layer: phase 31b's ``generate`` and drain with exact launches
     (the latent decode at 64 heads a rank), finite logits, the latent
     KV bytes equal to one device's on each rank, a decode step's
     all-reduces 2 x layers of (B, 1, 5120), per-rank weight bytes, peak
     memory and tok/s, labelled as phase 31's. Phases 3 and 4 hold and
     time the bf16 latent decode at a rank's head counts (MLA_TP_HEADS:
     64, 32 and 8) at the pool's shape. (c) since slice 21, fp32, in the
     same spawn (``tp_case_runs``): phi3-mini's smoke variant through
     ``generate`` under TP_DUO at every layer (4 KV heads, 2 a rank: the
     split inside rank 1) and a 4-request drain with the fidelity probe
     on every admission; command-r's smoke variant narrowed to one KV
     head, which both ranks hold, through ``generate`` router-driven and
     mixed and a drain; against the one-device card run on the same
     weights: routing, tokens and statuses equal, logits within 1e-4 of
     the largest, every coverage within 1e-5, each run's launches exact
     on every rank, the probe's all-reduces 2 a layer and 1 a routed
     layer a probe, the shared KV head's caches bitwise equal on both
     ranks. (a)'s and (c)'s launches are the ``tp2_archs_rank*`` counts.
  33. sequence-sharded FA caches (slice 22), in phase 32's spawn after
     (b) (``seq_runs``): phi3-mini at full width, 2 layers, fp32, whole
     weights on both ranks, FA caches of SEQ_MAX_LEN slots cut in two
     from SEQ_MIN_SEQ on, a SEQ_PROMPT-token prompt (past the shard
     boundary) and TP_PARITY_N steps at chunk 512, ``generate``
     router-driven and mixed against the one-device card run: routing
     and tokens equal, logits within 1e-4 of the largest, each rank's
     launches exact (the partial decode and the rank merge once a FA
     layer a step, the batch decode at the SA layers), one gather of
     B·Hq·(D + 1) fp32 a FA layer a step, the prefill's broadcasts, no
     all-reduce, the global KV bytes one device's and a rank's FA bytes
     half of them (``seq_check``; launches as ``seq2_rank*``). Phase 3
     holds the partial decode and the rank merge against their plain
     versions (``seq_kernel_checks``: phi3-mini's decode shape over 4
     shards of 65,536 keys, the last with no live key, one long_500k
     shard of 131,072 keys, every head dim at G = 1 and 4 in bf16 and
     fp32; the merged kernels against the whole cache's decode) and
     block-sparse at the long_500k prefill's 524,288 keys
     (``long_block_sparse_check``: offsets past 2^31 bytes); phase 4
     times the partial decode on one of 4 shards of 65,536 keys beside
     ``decode_attention_bh`` over the whole cache, and the merge
     (``seq_kernel_times``).
The phases run in this order: 1, 2, 3, the paths (6-8, 10-12, 14, 16,
18, 30b, 20, 22, 23, 25's bf16 runs, 26, 31, 32 with 33, 28, 30) and 2b; beside
them the card-against-CPU phases (5, 5b, 9, 9b, 13, 15, 17, 19, 21, 24,
25's fp32 runs, 27, 29: ``parity_phases``) run in order in a spawned
process of their own (``parity_worker``, started after phase 2), the
host's cores shared
(WORKER_THREADS, MAIN_THREADS) until the paths end and then all the
worker's; once it has ended, phase 4 on the idle card and phase 30's
quiet steps. The worker launches kernels only to
compare them, in its own process, so the paths' launch counts (and the
recorders' tallies) are the main process's alone.
Then one JSON line of per-kernel numbers (phi3-mini's, and stablelm's,
granite's and deepseek's under ``stablelm_12b``, ``granite_moe_3b_a800m``
and ``deepseek_v2_236b``; the latent decode its own entry at deepseek's
shapes with its ring, long-context and high-batch rows and its
``tp_heads`` rows at 64, 32 and 8 heads; launches by
path, phase 14's as ``guardrails`` and phase 20's as ``xa_batch``,
``duo``, ``ta`` and ``xa_continuous``; each kernel's phase-2b counts
under ``stress``; block-sparse's xa rows and streaming's and flash's ta
rows under ``xa``, ``xa_stablelm_12b``, ``ta_streaming`` and
``ta_flash``; whisper's under ``whisper_encoder`` and ``whisper_cross``,
with their launches on phase 23's path; launches by path also as
``phi3_vision``, ``whisper``, ``jamba_smoke`` (phase 25's bf16 runs)
and ``mamba2`` (phase 26's three cells); jamba's G = 8 rows under
``jamba_1_5_large_398b``, launches "phase 3 / 4 only"; gemma3's rows
under ``gemma3_12b`` with its launches, the local ring's decode and the
window under ``local_ring`` and ``window``; the backward kernel's
entry with its launches from phase 30, its phase-2b counts and its rows:
phi3-mini's causal as the entry's own, ``streaming``, ``stablelm_12b``,
``gemma3_12b_window``, ``whisper_encoder`` and ``unaligned``; phase 31's
per-rank launches as ``tp2_rank0`` / ``tp2_rank1``, phase 32's as
``tp2_archs_rank*`` (a) and ``tp2_deepseek_rank*`` (b)); the
block-sparse forward's (192, 128) row as ``xa_deepseek_v2_236b`` and
the backward's as ``deepseek_v2_236b``; the block-sparse backward's
entry (phi3-mini's xa row as its own, deepseek-v2's, its launches from
phase 30 and 30b), the partial decode's and the rank merge's entries
(phase 3's main-shape errors, phase 4's rows, phase 33's rank-0
launches), the total seconds, and the last line ``{"ok": true,
"device": {...}}``.
"""
import collections
import ctypes
import gc
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
STABLELM = "stablelm-12b"  # head dim 160, G = 4: phases 9-11
COMMAND_R = "command-r-plus-104b"  # G = 12, tied embeddings: phase 12
GRANITE = "granite-moe-3b-a800m"  # MoE, head dim 64, G = 3: phases 15-16
DEEPSEEK = "deepseek-v2-236b"  # MLA, 160 experts top-6 + 2: phases 17-18
MAMBA2 = "mamba2-780m"  # every layer Mamba2 SSD, no attention: 24-26
# 7 Mamba : 1 routed attention layer a period, MoE on the even layers: its
# smoke variant in phase 25, its attention shapes (G = 8) in phases 3-4
JAMBA = "jamba-1.5-large-398b"
# 5 local (sliding-window) layers to 1 routed global layer, D = 256,
# G = 2: phases 27-28, its kernel shapes in phases 2b-4
GEMMA3 = "gemma3-12b"
# phase 28's prefix stores, in snapshots of the cold run's routed
# geometry: the batch store's device and host tiers (A's 8 boundaries
# fill both, so offload_all drops) and the continuous store
GEMMA3_STORE_SNAPSHOTS = (3.5, 5.5, 6.5)
# phase 28's depth: 1 of gemma3's 8 periods (5 local + 1 global layers),
# every layer kind and all five kernels kept, so that the whole script,
# training phases 29-30 included, fits its time on a slower host
GEMMA3_LAYERS = 6
# the same, for phases 10-11 (stablelm-12b: 10 of 40 layers), 16
# (granite-moe: 4 of 32), 20 (phi3-mini under xa / ta / duo: 8 of 32)
# and 26 (mamba2-780m: 6 of 48); each arch is uniform over depth. Phase
# 9b's slot-pool parity runs stablelm at 1 layer (phase 9 keeps 2)
STABLELM_LAYERS, GRANITE_LAYERS, SA_MODES_LAYERS, MAMBA2_LAYERS = \
    10, 4, 8, 6
# and, since phase 32 joined them, phase 14's guarded drains (phi3-mini
# at 16 of its 32 layers) and phase 31b's 2 ranks over gloo (8 since
# slice 20, whose phases 29, 30b and 2b grew the script); phase 30's
# router training under ssa at TRAIN_LAYERS of 32 since slice 20 (its xa
# cell keeps the full depth)
GUARD_LAYERS, TP_LAYERS, TRAIN_LAYERS = 16, 8, 16
# deepseek-v2 at 60 layers is 472 GB in bf16; 4 of them at full width
# (1.05 B embedding and unembedding + 4 x 3.98 B = 16.97 B parameters,
# ≈ 34 GB) fit
DEEPSEEK_LAYERS = 4
# phase 17's narrowing of deepseek for the CPU: its real per-head widths
# (q_lora 1536, kv_lora 512, nope 128, rope 64, v 128), fewer heads and
# experts
DEEPSEEK_NARROW = dict(num_layers=2, d_model=1024, num_heads=16,
                       num_kv_heads=16, num_experts=8, top_k=6,
                       num_shared_experts=2)
# command-r at 64 layers is 208 GB in bf16; 8 of them at full width
# (3.15 B tied embedding + 8 x 1.573 B = 15.7 B parameters, 31.5 GB) fit
COMMAND_R_LAYERS, COMMAND_R_REQUESTS = 8, 2
# phase 31: tensor-parallel ranks on the one card, (a)'s prompt lengths
# and decode steps (phase 5b's), (b)'s load
TP_WORLD, TP_LABEL = 2, "2 ranks on one card over gloo"
TP_PARITY_LENS, TP_PARITY_N = (2304, 1536, 1000, 700, 2304), 8
TP_PROMPT, TP_GEN, TP_REQUESTS, TP_SLOTS = 2048, 16, 4, 2
TP_DRAIN_LENS = (2048, 1024, 1536, 512)
# phase 32a: the parity prompts of the MoE, MLA and Mamba archs (whisper's
# one prompt of TP_WHISPER_LEN tokens over 1500 frames, as phase 23's)
TP_ARCH_LENS, TP_WHISPER_LEN = (1536, 1024, 700, 400, 1536), 384
# phase 32c: the duo override over phi3-mini's smoke variant (4 KV heads,
# 2 a rank: 3 on full attention puts the split inside rank 1)
TP_DUO = ("duo", 3)
# phase 33: sequence-sharded FA caches over the same ranks (phi3-mini, 2
# layers, fp32): a SEQ_PROMPT-token prompt in a SEQ_MAX_LEN cache, cut
# from SEQ_MIN_SEQ slots on, so the prompt crosses the shard boundary and
# the decode runs on rank 1's shard with rank 0's whole
SEQ_PROMPT, SEQ_MAX_LEN, SEQ_MIN_SEQ = 3000, 3072, 1024
REQUESTS, PROMPT, GEN, CHUNK = 4, 4096, 32, 512
POOL_LENS = (4112, 2080, 1400, 1)  # live lengths of the timed slot pool
PREAMBLE = 3072  # phase 8 batch: A and B share it, 1024-token tails
CONT_PREAMBLE, CONT_TAILS = 2048, (2048, 1024, 512)  # phase 8 continuous
# phase 8's store budgets (MB): at ≈ 1.19 GB a snapshot (14 FA / 18 SA
# layers at max_len 4128) the batch store's tiers hold 3 and 5, so A's 8
# boundaries fill both and offload_all makes it drop; the continuous store
# holds 6, so the 2048-token boundary, touched by every hit, survives
BATCH_STORE_MB, CONT_STORE_MB = (4096, 6144), 8192

REPLACES = {  # kernel → the Pallas TPU kernel it replaces
    "flash_attention": "src/repro/kernels/flash_attention.py:75",
    "streaming_attention": "src/repro/kernels/streaming_attention.py:90",
    "block_sparse_attention": "src/repro/kernels/block_sparse_attention.py:86",
    "decode_attention": "src/repro/kernels/decode_attention.py:107",
    "decode_attention_pooled": "src/repro/kernels/decode_attention.py:202",
    # the pooled kernel's instance at MLA's absorbed decode
    "decode_attention_mla": "src/repro/kernels/decode_attention.py:202",
    # the sequence-sharded decode: the decode kernel over one shard, and
    # the cross-device combine of lse_combine_decode (pmax and psum in
    # XLA, no pallas_call of its own)
    "decode_attention_partial": "src/repro/kernels/decode_attention.py:107",
    "decode_merge_ranks": "src/repro/distributed/decode.py:43",
}
BF16_ATOL_RMS = 0.05  # bf16 limit's absolute part, as a share of rms(plain)
BF16_RTOL = 2.0 ** -7  # one bf16 ulp: kernel and plain round their outputs
FP32_TOL = 1e-4
SLEEP_CYCLES = 20_000_000  # ≈ 10 ms of device sleep before a timed run
TILE = slice(64, 128)  # the 64-key tile zeroed for the sensitivity check


def free_card():
    """Give the card back the memory of everything dropped. An engine and
    its scheduler refer to each other, so only the cycle collector frees
    them (and with them a model's weights and caches)."""
    gc.collect()
    torch.cuda.empty_cache()


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


def kernel_cases(dev, dtype, main, arch=ARCH, small_d=128, small_g=4):
    """(name → (kernel call, plain call, plain call with one V tile zeroed,
    library call, bytes, flops)) on random inputs; ``main`` picks the main
    path's shapes of ``arch`` (4 requests of its heads), else the small
    unaligned case at head dim ``small_d``, 2 KV heads of ``small_g``
    query heads each."""
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
    cfg = get_config(arch)
    sink, local = cfg.flux.sink, cfg.flux.local

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    if main:
        BH, BHkv = REQUESTS * cfg.num_heads, REQUESTS * cfg.num_kv_heads
        D, S, L = cfg.head_dim, CHUNK, PROMPT + GEN
        start, cur = PROMPT - CHUNK, PROMPT + GEN // 2 - 1
    else:
        BH, BHkv, D, S, L = 2 * small_g, 2, small_d, 200, 300
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
        lambda **kw: flash_attention_bh(q, k, v, **kw),
        lambda: ref.flash_attention_ref(q, k, v),
        lambda: ref.flash_attention_ref(q, k, zero_tile(v)),
        lambda: F.scaled_dot_product_attention(q4(q), kv4(k), kv4(v),
                                               is_causal=True),
        *attn_work(BH, BHkv, S, D, S, pairs, it))
    pos = torch.arange(S, device=dev)
    smask = (pos[None] <= pos[:, None]) & (
        (pos[None] < sink) | (pos[:, None] - pos[None] < local))
    cases["streaming_attention"] = (
        lambda **kw: streaming_attention_bh(q, k, v, sink=sink, local=local,
                                            **kw),
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
        lambda **kw: block_sparse_attention_bh(qc, kc, vc, sel,
                                               q_offset=start, **kw),
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
        lens, Hq, Hkv = (0, 137, L), 2 * small_g, 2
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


def sdpa_backends(call):
    """Which of PyTorch's SDPA backends take ``call``'s shapes: {backend:
    "ok" or "refuses"} (the library yardstick's note where a backend
    cannot compute the function)."""
    import warnings
    from torch.nn.attention import SDPBackend, sdpa_kernel
    out = {}
    for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
              SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with warnings.catch_warnings(), sdpa_kernel(b):
                warnings.simplefilter("ignore")
                call()
            torch.cuda.synchronize()
            out[b.name.lower()] = "ok"
        except RuntimeError:
            out[b.name.lower()] = "refuses"
    return out


def mla_kernel_cases(dev, dtype, main):
    """deepseek-v2's kernel instances, as ``kernel_cases`` gives them:
    flash and streaming at (Dk, Dv) = (nope + rope, v) = (192, 128) and
    the latent decode (``decode_attention_mla_bh``: q (B·H, 1, R + rope)
    over ckv (B, L, R) and kr (B, L, rope), R = 512, rope = 64, scale
    (nope + rope) ** -0.5). ``main``: the route chunk of 4 requests of 128
    heads (G = 1) and the decode over POOL_LENS at L = PROMPT + GEN, plus
    ``decode_attention_mla_ring``, a shuffled ring with holes (L 2176,
    RING_POOL_LENS); else the small unaligned case (G = 4, 200 queries
    over 200 keys; the decode at 32 heads over slots of 0 / 1 / 137 /
    300 keys at L 300, a ring with holes)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bh
    from repro_torch.kernels.streaming_attention import \
        streaming_attention_bh
    F = torch.nn.functional
    g = torch.Generator(device=dev).manual_seed(0)
    cfg = get_config(DEEPSEEK)
    Dk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    Dv = cfg.v_head_dim
    it = torch.tensor([], dtype=dtype).element_size()

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    if main:
        BH = BHkv = REQUESTS * cfg.num_heads
        S, sink, local = CHUNK, cfg.flux.sink, cfg.flux.local
    else:
        BH, BHkv, S, sink, local = 8, 2, 200, 16, 48
    q, k, v = rnd(BH, S, Dk), rnd(BHkv, S, Dk), rnd(BHkv, S, Dv)
    G = BH // BHkv

    def qkv4():  # the library call's (G, Hkv, S, D) views
        return (q.view(BHkv, G, S, Dk).transpose(0, 1),
                k[None].expand(G, *k.shape), v[None].expand(G, *v.shape))

    def work(pairs):
        return (it * (BH * S * (Dk + Dv) + BHkv * S * (Dk + Dv)),
                2 * (Dk + Dv) * pairs)
    pos = torch.arange(S, device=dev)
    smask = (pos[None] <= pos[:, None]) & (
        (pos[None] < sink) | (pos[:, None] - pos[None] < local))
    cases = {
        "flash_attention": (
            lambda **kw: flash_attention_bh(q, k, v, **kw),
            lambda: ref.flash_attention_ref(q, k, v),
            lambda: ref.flash_attention_ref(q, k, zero_tile(v)),
            lambda: F.scaled_dot_product_attention(*qkv4(), is_causal=True),
            *work(BH * S * (S + 1) // 2), 1),
        "streaming_attention": (
            lambda **kw: streaming_attention_bh(q, k, v, sink=sink,
                                                local=local, **kw),
            lambda: ref.streaming_attention_ref(q, k, v, sink=sink,
                                                local=local),
            lambda: ref.streaming_attention_ref(q, k, zero_tile(v),
                                                sink=sink, local=local),
            lambda: F.scaled_dot_product_attention(*qkv4(),
                                                   attn_mask=smask),
            *work(BH * streaming_pairs(range(S), sink, local)), 1)}

    if main:
        cases["decode_attention_mla"] = mla_decode_case(
            dev, dtype, POOL_LENS, PROMPT + GEN, cfg.num_heads, False, g)
        cases["decode_attention_mla_ring"] = mla_decode_case(
            dev, dtype, RING_POOL_LENS, cfg.flux.sink + cfg.flux.local,
            cfg.num_heads, True, g)
    else:
        cases["decode_attention_mla"] = mla_decode_case(
            dev, dtype, MLA_SMALL_LENS, 300, 32, True, g)
    return cases


MLA_SMALL_LENS = (0, 1, 137, 300)  # the small latent decode's slots, L 300
MLA_SMALL_TILES = (1, 2, 5, None)  # forced tiles a range, then the plan's


def mla_decode_case(dev, dtype, lens, L, H, ring, g, tiles=None):
    """The latent decode of len(lens) slots of H heads at deepseek's
    widths (R 512, rope 64, scale 192 ** -0.5) over capacity L, FullKV or
    (``ring``) a shuffled ring with holes: (kernel call taking ``out=``,
    ``tiles=`` and ``entry=``, plain call, plain call with one ``ckv``
    tile zeroed in every slot, library call, bytes, flops, slots).
    ``tiles`` forces the kernel's tiles a range."""
    from repro_torch.kernels.decode_attention_mla import (
        decode_attention_mla_bh, decode_attention_mla_plain)
    R, rope, scale = 512, 64, 192 ** -0.5
    it = torch.tensor([], dtype=dtype).element_size()
    lens = tuple(min(n, L) for n in lens)
    Bp = len(lens)
    qd, ckv, krd = (torch.randn(*shape, generator=g, device=dev).to(dtype)
                    for shape in ((Bp * H, 1, R + rope), (Bp, L, R),
                                  (Bp, L, rope)))
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    ppos = (torch.as_tensor(ring_positions(np.random.default_rng(0),
                                           lens, L), device=dev)
            if ring else None)
    vis = torch.arange(L, device=dev)[None] < lengths[:, None]
    if ppos is not None:
        vis = vis & (ppos >= 0)
    n_vis = int(vis.sum())

    def library():  # k_eff built once, outside the timed call
        if not hasattr(library, "k_eff"):
            library.k_eff = torch.cat([ckv, krd], dim=-1)[:, None]
        return torch.nn.functional.scaled_dot_product_attention(
            qd.view(Bp, H, 1, R + rope),
            library.k_eff.expand(Bp, H, L, R + rope),
            ckv[:, None].expand(Bp, H, L, R), attn_mask=vis[:, None, None],
            scale=scale)

    def kernel(entry=None, **kw):  # entry: another tree's (parent_mla)
        kw.setdefault("tiles", tiles)
        return (entry or decode_attention_mla_bh)(
            qd, ckv, krd, ppos, lengths, n_heads=H, scale=scale, **kw)
    return (
        kernel,
        lambda: decode_attention_mla_plain(qd, ckv, krd, ppos, lengths,
                                           n_heads=H, scale=scale),
        lambda: decode_attention_mla_plain(
            qd, zero_slot_tiles(ckv, lens), krd, ppos, lengths, n_heads=H,
            scale=scale),
        library,
        # q read, o written, each live key's ckv and kr read once; the
        # 2·(Dk + Dv) operations of every visible (row, key) pair
        it * (Bp * H * (2 * R + rope) + sum(lens) * (R + rope)),
        2 * (2 * R + rope) * H * n_vis, Bp)


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
        smem.argtypes, smem.restype = [ctypes.c_int] * 3, ctypes.c_int
        report = compiler_report(lib, "wgmma_kernel")
        if not report:
            lines.append(f"{source}: no compiler report at {lib.name}.log")
        for name, r in sorted(report.items()):
            dims = [int(d) for d in re.findall(r"Li(\d+)E", name)]
            D, Dv = dims[0], dims[-1]  # one head dim, or (Dk, Dv)
            n = n_sel if source == "block_sparse_attention" else 0
            hgmma, tma, shapes = sass.get(name, (None, None, None))
            lines.append(
                f"{source} wgmma D={D}{f' Dv={Dv}' if Dv != D else ''}: "
                f"registers={r.get('registers')} "
                f"spill_stores/loads={r.get('spill')} bytes "
                f"static_smem={r.get('smem')} dynamic_smem={smem(D, Dv, n)} "
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
            if "mla_wgmma_kernel" in name:  # mla_report's
                continue
            if "mla_decode_kernel" in name:  # no head-dim argument
                lines.append(
                    f"pooled mla_decode {'bf16' if 'bfloat16' in name else 'fp32'}"
                    f" (R 512, rope 64, 16 heads a CTA): {r.get('registers')}"
                    f" regs spill {r.get('spill')} stack {r.get('stack')}")
                continue
            kind = ("partial_split" if "split_kernel" in name
                    and "Lb1E" in name else
                    "split" if "split_kernel" in name else
                    "partial_merge" if "merge_kernel" in name
                    and "Lb1E" in name else
                    "merge_ranks" if "merge_ranks" in name else "merge")
            args = [int(x) for x in re.findall(r"Li(\d+)E", name)]
            dtype = "bf16" if "bfloat16" in name else "fp32"
            key = f"{prefix}_{kind} {dtype}" + (f" kG={args[1]}"
                                                if "split" in kind else "")
            groups.setdefault(key, []).append(
                (args[0], f"D={args[0]}: {r.get('registers')} regs "
                          f"spill {r.get('spill')} stack {r.get('stack')}"))
    return lines + [f"{k}: " + ", ".join(t for _, t in sorted(v))
                    for k, v in sorted(groups.items())]


def mla_report():
    """Phase 2's lines for the bf16 latent decode (``mla_wgmma_kernel`` of
    the pooled library): registers, spills and stack from the compiler's
    report, the dynamic shared memory a CTA asks for, and its SASS's
    tensor-core (HGMMA) and TMA-load (UTMALDG) counts, which must be > 0."""
    from repro_torch.kernels import _build
    lib = _build.library_path("decode_attention_pooled")
    smem = ctypes.CDLL(str(lib)).flux_mla_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
    report = compiler_report(lib, "mla_wgmma_kernel")
    sass = sass_counts(lib)
    assert report, f"no compiler report of mla_wgmma_kernel in {lib.name}.log"
    lines = []
    for name, r in report.items():
        hgmma, tma, shapes = sass.get(name, (0, 0, []))
        assert hgmma > 0 and tma > 0, \
            f"{name}: HGMMA={hgmma} UTMALDG={tma}, not on the tensor cores"
        lines.append(
            f"pooled mla_wgmma bf16 (R 512, rope 64, 64 heads a CTA, 2 "
            f"warpgroups): registers={r.get('registers')} "
            f"spill_stores/loads={r.get('spill')} bytes stack="
            f"{r.get('stack')} dynamic_smem={smem(1)} (fp32 kernel's "
            f"{smem(0)}) sass HGMMA={hgmma} {shapes} UTMALDG={tma}")
    return lines


STRESS_CALLS = 1000  # calls of each instance in phase 2b


def stress_cases(dev):
    """Phase 2b's instances: [(label, kernel name, kernel call taking
    ``out=``, plain call, slots: the number of equal parts the limit's
    rms is taken over, or the parts' sizes)], every bf16 wgmma instance
    the main paths run at their shapes: flash, streaming and
    block-sparse at granite's (D = 64), phi3-mini's (96), stablelm's (160) and gemma3's
    (256, G = 2), streaming at gemma3's window over a whole prompt (sink
    0, local 1024), flash and streaming at deepseek's (192, 128), the
    latent decode over POOL_LENS and over the ring with holes, flash
    with causal=False at whisper's encoder shape (4 x 6 heads, D = 64,
    1500 x 1500), and the backward (dq, dk and dv flattened into one
    output, one part each, its scratch NaN-filled on the NaN-filled calls)
    at phi3-mini's training shapes, causal and streaming, at whisper's
    encoder and at the unaligned G = 4 case of every head dim, whose
    query rows end inside a 64-row block."""
    from repro_torch.configs import get_config
    cases = []
    for arch in (GRANITE, ARCH, STABLELM, GEMMA3):
        D = get_config(arch).head_dim
        kc = kernel_cases(dev, torch.bfloat16, True, arch)
        for name in ("flash_attention", "streaming_attention",
                     "block_sparse_attention"):
            cases.append((f"{name} {arch} D={D}", name, *kc[name][:2], 1))
    kern, plain, *_ = window_case(dev)
    cases.append((f"streaming_attention {GEMMA3} window D=256 sink=0 "
                  f"local=1024 {PROMPT} tokens", "streaming_attention", kern,
                  plain, 1))
    for name, c in mla_kernel_cases(dev, torch.bfloat16, True).items():
        kernel = "decode_attention_mla" if "mla" in name else name
        label = {"flash_attention": "flash_attention (192, 128)",
                 "streaming_attention": "streaming_attention (192, 128)",
                 "decode_attention_mla": "decode_attention_mla POOL_LENS",
                 "decode_attention_mla_ring":
                     "decode_attention_mla ring"}[name]
        cases.append((f"{label} {DEEPSEEK}", kernel, c[0], c[1], c[-1]))
    name = "flash_attention whisper_encoder"
    c = side_kernel_cases(dev)[name]
    cases.append((f"{name} {WHISPER} D=64 bidirectional 1500x1500",
                   "flash_attention", c[0], c[1], 1))
    c = xa_case(dev, DEEPSEEK, B=1)
    cases.append((c["label"], "block_sparse_attention", c["kern"],
                   c["plain"], 1))
    return cases + backward_stress_cases(dev)


def backward_stress_cases(dev):
    """``stress_cases``' bf16 backward instances (the limit's rms taken
    per gradient): phi3-mini's training shapes, causal and streaming,
    whisper's encoder (1500 rows, not a multiple of 64), deepseek-v2's
    (192, 128) causal row, and the unaligned G = 4 case,
    causal and the first streaming mask, at every head dim and at (192,
    128); the block-sparse backward at both xa training shapes and at the
    unaligned G = 4 case of every head dim and of (192, 128)."""
    main = backward_cases(dev, torch.bfloat16, True)
    small = [c for c in backward_cases(dev, torch.bfloat16, False)
             if "causal" in c["label"] or f"sink={BWD_SMALL_STREAM[0][0]} "
             f"local={BWD_SMALL_STREAM[0][1]} " in c["label"]]
    sparse = sparse_backward_cases(dev, torch.bfloat16, True)
    sparse += [c for c in sparse_backward_cases(dev, torch.bfloat16, False)
               if " G=4 " in c["label"]]
    cases = ([c for c in main if not c["label"].startswith(
        (STABLELM, GEMMA3))] + small + sparse)
    return [(f"{c['kernel']} {c['label']}", c["kernel"], c["flat"],
             c["plain_flat"], c["sizes"]) for c in cases]


def stress(dev, calls=STRESS_CALLS, cases=stress_cases):
    """Phase 2b: each of ``cases(dev)`` (``stress_cases``, or a part of
    it) ``calls`` times, every other call into an output pre-filled with
    NaN (the entries' ``out=``), so that an element the kernel leaves
    unwritten shows on every such call; the
    others into a fresh ``torch.empty``, as the main paths call them.
    Counts the outputs that hold a non-finite element and the elements
    past phase 3's bf16 limit against the plain version (computed once).
    Returns {label: counts} and the kernel each label belongs to."""
    rows, kernel_of = {}, {}
    for label, kernel, kern, plain, slots in cases(dev):
        t0 = time.perf_counter()
        want = plain().float()
        parts = want.reshape(slots, -1) if isinstance(slots, int) \
            else want.split(list(slots))
        rms = torch.cat([x.square().mean().sqrt().expand(x.numel())
                         for x in parts]).view(want.shape)
        limit = BF16_ATOL_RMS * rms + BF16_RTOL * want.abs()
        buf = torch.empty_like(kern())
        nonfinite = torch.zeros((), dtype=torch.int64, device=dev)
        past = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(calls):
            if i % 2:
                buf.fill_(float("nan"))
                out = kern(out=buf)
                assert out is buf
            else:
                out = kern()
            nonfinite += (~torch.isfinite(out)).any()
            past += ((out.float() - want).abs() > limit).sum()
        torch.cuda.synchronize()
        rows[label] = dict(calls=calls, nan_prefilled=calls // 2,
                           nonfinite_outputs=int(nonfinite),
                           past_limit=int(past),
                           seconds=time.perf_counter() - t0)
        kernel_of[label] = kernel
        del want, limit, buf
        free_card()
    return rows, kernel_of


def mla_small_checks(dev):
    """Phase 3's bf16 latent decode at the small case: slots of 0 / 1 /
    137 / 300 keys at L 300 and H = 32 or 16 heads (the q map's rows past H
    read as zeros and are never written), FullKV and a shuffled ring with
    holes, at each of MLA_SMALL_TILES tiles a range (None: the plan's).
    Every live slot under the bf16 limit (rms per slot), its zeroed ckv
    tile above it, the length-0 slot's rows zeros. Returns the lines."""
    g = torch.Generator(device=dev).manual_seed(5)
    lines = []
    for H in (32, 16):
        for ring in (False, True):
            for tiles in MLA_SMALL_TILES:
                kern, plain, mutant, *_, slots = mla_decode_case(
                    dev, torch.bfloat16, MLA_SMALL_LENS, 300, H, ring, g,
                    tiles)
                out, want = kern(), plain()
                rows = out.shape[0] // slots  # slot 0 holds nothing
                assert not bool(out[:rows].any()), \
                    f"latent decode bf16 H={H}: a length-0 slot not zeros"
                e = max_err(out, want)
                r = bf16_ratios(out[rows:], want[rows:], slots - 1)
                r_mut = bf16_ratios(mutant()[rows:], want[rows:], slots - 1)
                label = (f"decode_attention_mla bfloat16 small H={H} "
                         f"{'ring with holes' if ring else 'FullKV'} lens="
                         f"{MLA_SMALL_LENS} L=300 tiles={tiles or 'plan'}")
                assert max(r) < 1, f"{label}: error {r} of the limit"
                assert min(r_mut) > 1, \
                    f"{label}: a zeroed tile is within the limit {r_mut}"
                lines.append(f"{label} max_abs_err={e:.3e} limit_ratio="
                             f"{ratio_text(r)} zeroed_tile_ratio="
                             f"{ratio_text(r_mut)} length-0 slot zeros")
    return lines


def mla_tp_checks(dev):
    """Phase 3's bf16 latent decode at a tensor-parallel rank's head
    counts (MLA_TP_HEADS) at the main pool's shape (POOL_LENS, L PROMPT +
    GEN), at the plan's tiles and at one range a slot: under the bf16
    limit (rms per slot), a zeroed ckv tile above it. Returns ({"h<H>":
    max abs error at the plan's tiles}, the lines)."""
    g = torch.Generator(device=dev).manual_seed(6)
    errs, lines = {}, []
    L = PROMPT + GEN
    for H in MLA_TP_HEADS:
        for tiles in (None, -(-L // 64)):
            kern, plain, mutant, *_, slots = mla_decode_case(
                dev, torch.bfloat16, POOL_LENS, L, H, False, g, tiles)
            out, want = kern(), plain()
            e = max_err(out, want)
            r = bf16_ratios(out, want, slots)
            r_mut = bf16_ratios(mutant(), want, slots)
            label = (f"decode_attention_mla bfloat16 {DEEPSEEK} rank heads "
                     f"H={H} lens={POOL_LENS} L={L} tiles={tiles or 'plan'}")
            assert max(r) < 1, f"{label}: error {r} of the limit"
            assert min(r_mut) > 1, \
                f"{label}: a zeroed tile is within the limit {r_mut}"
            if tiles is None:
                errs[f"h{H}"] = e
            lines.append(f"{label} max_abs_err={e:.3e} limit_ratio="
                         f"{ratio_text(r)} zeroed_tile_ratio="
                         f"{ratio_text(r_mut)}")
    return errs, lines


def parent_mla(libs):
    """The latent decode entry of another tree (``libs``: its libraries,
    ``sass_diff.other_libraries`` of its ``src`` directory, e.g. a ``git
    archive`` of the parent): a callable taking
    ``decode_attention_mla_bh``'s arguments that launches that tree's
    ``decode_attention_mla_fwd`` (bf16, 4 tiles a range unless ``tiles``
    says)."""
    from repro_torch.kernels.decode_attention import normalize_tiles
    lib = libs["decode_attention_pooled"]
    fn = ctypes.CDLL(str(lib)).decode_attention_mla_fwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(q, ckv, kr, positions, lengths, *, n_heads, scale, tiles=None,
             out=None):
        B, L, R = ckv.shape
        t = normalize_tiles(L, 4 if tiles is None else tiles)
        n_split = -(-L // (64 * t))
        o = torch.empty((q.shape[0], 1, R), dtype=q.dtype, device=q.device)
        acc = torch.empty((q.shape[0], n_split, R), dtype=torch.float32,
                          device=q.device)
        ml = torch.empty((2, q.shape[0], n_split), dtype=torch.float32,
                         device=q.device)
        code = fn(q.data_ptr(), ckv.data_ptr(), kr.data_ptr(),
                  None if positions is None else positions.data_ptr(),
                  lengths.data_ptr(), o.data_ptr(), acc.data_ptr(),
                  ml[0].data_ptr(), ml[1].data_ptr(), B, n_heads, L, R,
                  kr.shape[-1], 1, t, scale,
                  torch.cuda.current_stream().cuda_stream)
        assert code == 0, f"{lib.name}: decode_attention_mla_fwd {code}"
        return o
    return call


def parent_backward(libs):
    """The backward entry of another tree (``libs`` as ``parent_mla``
    takes them): a callable taking ``attention_backward_bh``'s arguments
    (Dk = Dv) that launches that tree's ``attention_backward`` C entry,
    bound with the C interface it had before slice 20 (no Dv argument),
    and returns (dq, dk, dv)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import attention_backward as AB
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    kernel = _build.CudaKernel("attention_backward", "attention_backward",
                               [P] * 8 + [I] * 11 + [F],
                               libs["attention_backward"])

    def call(q, k, v, do, *, causal=True, sink=None, local=None,
             q_offset=0, scale=None):
        grads = tuple(torch.empty_like(t) for t in (q, k, v))
        BH, Sq, D = q.shape
        stats = AB.check_stats("parent_backward", None, q)
        kernel.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      do.data_ptr(), *(g.data_ptr() for g in grads),
                      stats.data_ptr(), BH, k.shape[0], Sq, k.shape[1], D,
                      _build.DTYPE_CODES[q.dtype],
                      AB.FLASH if local is None else AB.STREAMING,
                      int(causal), int(sink or 0), int(local or 1),
                      int(q_offset), _build.default_scale(D, scale))
        return grads
    return call


def sdpa_efficient_ms(lib):
    """The library call's device time on SDPA's memory-efficient backend
    alone (the math backend would expand k and v per head: 38.6 GB at 64
    slots), or None where it refuses the shapes."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    try:
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return time_ms(lib)
    except RuntimeError:
        return None


def time_mla(dev, parent=None):
    """Phase 4's latent decode rows, one per MLA_SHAPES entry (128 heads,
    and a tensor-parallel rank's MLA_TP_HEADS at the pool's shape): the
    kernel's device time and call_ms, its plain version's, the library
    call's (SDPA; at the two large shapes its memory-efficient backend
    alone), the bound, the other tree's kernel (``parent``, a
    ``parent_mla`` callable) in the same process, and the device time
    against the tiles a range (MLA_SWEEP_TILES). Each shape is also held
    to the bf16 limit, its zeroed ckv tile above it. Returns {shape:
    row}."""
    from repro_torch.kernels import decode_attention_mla as DM
    g = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    for shape, (lens, L, ring, H) in MLA_SHAPES.items():
        kern, plain, mutant, lib, n_bytes, flops, slots = mla_decode_case(
            dev, torch.bfloat16, lens, L, H, ring, g)
        out, want = kern(), plain()
        r = bf16_ratios(out, want, slots)
        r_mut = bf16_ratios(mutant(), want, slots)
        assert max(r) < 1, f"latent decode {shape}: error {r} of the limit"
        assert min(r_mut) > 1, \
            f"latent decode {shape}: a zeroed tile is within the limit"
        b_ms, b_by = bound(n_bytes, flops)
        large = shape in ("long_context", "high_batch")
        row = rows[shape] = dict(
            lens=f"{lens[0]} x {len(lens)}" if large else list(lens), L=L,
            max_abs_err=max_err(out, want), limit_ratio=max(r),
            zeroed_tile_ratio=min(r_mut), ms=time_ms(kern),
            call_ms=call_ms(kern), plain_ms=time_ms(plain),
            library_ms=sdpa_efficient_ms(lib) if large else time_ms(lib),
            bound_ms=b_ms, bound_by=b_by,
            heads=H,
            tiles=DM.mla_plan(len(lens), L, H, torch.bfloat16,
                              sms=torch.cuda.get_device_properties(
                                  dev).multi_processor_count).tiles)
        if not large:
            row["sdpa_backends"] = sdpa_backends(lib)
        if parent is not None:
            p_out = kern(entry=parent)
            row["parent_limit_ratio"] = max(bf16_ratios(p_out, want, slots))
            row["parent_ms"] = time_ms(lambda: kern(entry=parent))
            row["parent_call_ms"] = call_ms(lambda: kern(entry=parent))
        row["ms_by_tiles"] = {
            t: time_ms(lambda t=t: kern(tiles=t))
            for t in sorted({*MLA_SWEEP_TILES, row["tiles"]})
            if t <= -(-L // 64)}
        say(4, f"decode_attention_mla {shape} lens={row['lens']} L={L} "
               f"H={H} ms={row['ms']:.4f} call_ms={row['call_ms']:.4f} "
               f"parent_ms={row.get('parent_ms')} plain_ms="
               f"{row['plain_ms']:.4f} library_ms={row['library_ms']} "
               f"bound_ms={b_ms:.4f} ({b_by}; {n_bytes} bytes, {flops} "
               f"flops) roofline_share={b_ms / row['ms']:.3f} "
               f"limit_ratio={row['limit_ratio']:.3f} "
               f"zeroed_tile_ratio={row['zeroed_tile_ratio']:.2f}")
        say(4, f"decode_attention_mla {shape} ms by tiles a range: "
               + " ".join(f"{t}{'*' if t == row['tiles'] else ''}={ms:.4f}"
                          for t, ms in row["ms_by_tiles"].items())
               + " (* the plan's)")
        del out, want, kern, plain, mutant, lib
        free_card()
    return rows


def ring_decode_case(dev, arch=ARCH, window=False):
    """The decode kernel over a sink + local RingKV at the main path's
    shapes of ``arch`` (bf16), the SA layers' decode, or (``window``) over
    a local layer's ring of sliding_window slots with no sink: (kernel
    call, plain call, plain call with one V tile zeroed, library call,
    bytes, flops)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_bh
    from repro_torch.serve.engine import _ring_src
    cfg = get_config(arch)
    sink, local = ((0, cfg.sliding_window) if window
                   else (cfg.flux.sink, cfg.flux.local))
    ring, BH, D = sink + local, REQUESTS * cfg.num_heads, cfg.head_dim
    BHkv = REQUESTS * cfg.num_kv_heads
    G = BH // BHkv
    cur = PROMPT + GEN // 2 - 1
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(n_bh, n, D, generator=g, device=dev).to(
        torch.bfloat16) for n_bh, n in ((BH, 1), (BHkv, ring), (BHkv, ring)))
    pos = torch.as_tensor(_ring_src(cur + 1, sink, local, ring),
                          dtype=torch.int32, device=dev)
    valid = (pos >= 0) & (pos <= cur)
    n_valid = int(valid.sum())
    # the library call takes (G, Hkv) query heads over Hkv key heads
    q4 = q.view(BHkv, G, 1, D).transpose(0, 1)
    return (lambda: decode_attention_bh(q, k, v, pos, cur),
            lambda: ref.decode_attention_ref(q, k, v, pos, cur),
            lambda: ref.decode_attention_ref(q, k, zero_tile(v), pos, cur),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, k[None].expand(G, *k.shape),
                v[None].expand(G, *v.shape), attn_mask=valid[None]),
            *attn_work(BH, BHkv, 1, D, n_valid, BH * n_valid, 2))


def ring_decode_check(dev, arch=ARCH, window=False):
    """(max abs error, bf16 ratio of the kernel, bf16 ratio of the plain
    version with one V tile zeroed) of ``ring_decode_case``."""
    kern, plain, mutant, *_ = ring_decode_case(dev, arch, window)
    out, want = kern(), plain()
    return (max_err(out, want), bf16_ratios(out, want),
            bf16_ratios(mutant(), want))


def window_case(dev):
    """gemma3's local layers over a whole prompt (the monolithic
    admission's shape): the streaming kernel at sink 0 and local =
    sliding_window (1024) over REQUESTS prompts of PROMPT tokens at its
    widths (4 x 16 heads over 4 x 8 KV heads, D = 256), bf16: (kernel
    call taking ``out=``, plain call, plain call with one V tile zeroed,
    library call: SDPA's efficient backend under the band mask, bytes,
    flops)."""
    from torch.nn.attention import SDPBackend
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.streaming_attention import \
        streaming_attention_bh
    cfg = get_config(GEMMA3)
    BH, BHkv = REQUESTS * cfg.num_heads, REQUESTS * cfg.num_kv_heads
    S, D, w = PROMPT, cfg.head_dim, cfg.sliding_window
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn(n, S, D, generator=g, device=dev).to(
        torch.bfloat16) for n in (BH, BHkv, BHkv))
    kp = torch.arange(S, device=dev)
    band = (kp[None] <= kp[:, None]) & (kp[:, None] - kp[None] < w)
    kw = dict(sink=0, local=w)
    return (lambda **o: streaming_attention_bh(q, k, v, **kw, **o),
            lambda: rows_plain(ref.streaming_attention_ref, q, k, v, **kw),
            lambda: rows_plain(ref.streaming_attention_ref, q, k,
                               zero_tile(v), **kw),
            lambda: gqa_sdpa(q, k, v, band, SDPBackend.EFFICIENT_ATTENTION),
            *attn_work(BH, BHkv, S, D, S,
                       BH * streaming_pairs(range(S), 0, w), 2))


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
    and G = 4 (every instance of the kernel), and at D = 128 with G = 12
    (command-r: two CTAs a KV row, the second holding 4 rows): bf16
    under the bf16 limit with its zeroed tile above it, fp32 within
    1e-4."""
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
    dtypes = (torch.bfloat16, torch.float32)
    for dtype, D, G in ([(t, D, G) for t in dtypes for D in HEAD_DIMS
                         for G in (1, 4)]
                        + [(t, 128, 12) for t in dtypes]
                        + [(t, 64, 3) for t in dtypes]):
        rows = BH if BH % G == 0 else 2 * G  # G = 3, 12: two KV rows
        qs, ks, vs = (torch.randn(n, s, D, generator=g, device=dev).to(dtype)
                      for n, s in ((rows, 1), (rows // G, L),
                                   (rows // G, L)))
        plan = decode_split_plan(rows // G, G, L, sms)
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


# the sequence-sharded decode (phases 3, 4 and 33): one of SEQ_SHARDS
# shards of a SEQ_CAPACITY-key cache at phi3-mini's decode shape (32 rows,
# D = 96), and one rank's shard of the long_500k cache (524,288 / 4 keys)
SEQ_SHARDS, SEQ_CAPACITY, SEQ_LONG_SHARD = 4, 65536, 131072
SEQ_SMALL_L = 1200  # the small cases' cache: 4 shards of 300 keys
LSE_TOL = 1e-3  # a partial state's base-2 log-sum-exp, both dtypes
# the block-sparse prefill's keys at the long_500k shape: 64 queries at
# the end of 524,288 keys (one layer's K 3.2 GB, past 2^31 bytes)
LONG_SKV, LONG_SQ = 524288, 64


def seq_inputs(dev, dtype, BH, G, L, D, seed):
    """Random q (BH, 1, D), k / v (BH / G, L, D) and positions arange(L)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(n, s, D, generator=g, device=dev).to(dtype)
               for n, s in ((BH, 1), (BH // G, L), (BH // G, L)))
    return q, k, v, torch.arange(L, dtype=torch.int32, device=dev)


def seq_run(q, k, v, pos, cur, n, partial, merge):
    """The sequence-sharded decode of q over k / v cut into n shards:
    ``partial`` on each shard, ``merge`` over their stacked states.
    Returns ([(o, lse)] by shard, o_parts, lse_parts, merged)."""
    S = k.shape[1] // n
    parts = [partial(q, k[:, r * S:(r + 1) * S].contiguous(),
                     v[:, r * S:(r + 1) * S].contiguous(),
                     pos[r * S:(r + 1) * S].contiguous(), cur)
             for r in range(n)]
    o = torch.stack([o for o, _ in parts])
    lse = torch.stack([lse for _, lse in parts])
    return parts, o, lse, merge(o, lse, q.dtype)


def seq_kernel_checks(dev):
    """Phase 3: the partial decode (``decode_attention_partial_bh``) and
    the rank merge (``decode_merge_ranks_bh``) against their plain
    versions: at phi3-mini's decode shape over SEQ_SHARDS shards of
    SEQ_CAPACITY keys in bf16 with cur_pos in the third shard (the fourth
    holds no live key), at one rank's shard of the long_500k cache
    (SEQ_LONG_SHARD keys, 2048 tiles: at least 8 splits), and at every
    built head dim with G = 1 and 4, bf16 and fp32, over 4 shards of 300
    keys with the last one dead. Each shard's o is held to the bf16 limit
    (its zeroed tile above it on a live shard) or FP32_TOL, its lse
    within LSE_TOL; the merge kernel over the plain states and the merged
    kernels over the whole cache (``decode_attention_ref``) likewise.
    Returns ({kernel: max abs err at the main shape}, report lines)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels._build import HEAD_DIMS
    from repro_torch.kernels.decode_attention import (decode_split_plan,
                                                      sm_count)
    from repro_torch.kernels.decode_attention_partial import \
        decode_attention_partial_bh as partial
    from repro_torch.kernels.decode_merge_ranks import \
        decode_merge_ranks_bh as merge
    sms = sm_count(dev.index or 0)
    cfg_d, rows = 96, 32
    cases = [("bf16 main shapes", torch.bfloat16, rows, 1, SEQ_CAPACITY,
              cfg_d, SEQ_SHARDS, 3 * SEQ_CAPACITY // SEQ_SHARDS - 17),
             ("bf16 long_500k shard", torch.bfloat16, rows, 1,
              SEQ_LONG_SHARD, cfg_d, 1, SEQ_LONG_SHARD - 1)]
    cases += [(f"{'bf16' if t == torch.bfloat16 else 'fp32'} G={G} D={D}",
               t, 8, G, SEQ_SMALL_L, D, 4, 700)
              for t in (torch.bfloat16, torch.float32) for D in HEAD_DIMS
              for G in (1, 4)]
    errs, lines = {}, []

    def hold(label, out, want, mutant=None, tol=None):
        e = max_err(out, want)
        if tol is not None:
            assert e < tol, f"{label}: max abs err {e} >= {tol}"
            return e, f"max_abs_err={e:.3e} tol={tol}"
        r = bf16_ratios(out, want)
        assert max(r) < 1, f"{label}: error {r} of the limit"
        text = f"max_abs_err={e:.3e} limit_ratio={ratio_text(r)}"
        if mutant is not None:
            r_mut = bf16_ratios(mutant, want)
            assert min(r_mut) > 1, f"{label}: a zeroed tile is within " \
                f"the limit {r_mut}"
            text += f" zeroed_tile_ratio={ratio_text(r_mut)}"
        return e, text

    for label, dtype, BH, G, L, D, n, cur in cases:
        q, k, v, pos = seq_inputs(dev, dtype, BH, G, L, D, 33)
        tol = FP32_TOL if dtype == torch.float32 else None
        kparts, _, _, got = seq_run(q, k, v, pos, cur, n, partial, merge)
        pparts, po, plse, _ = seq_run(
            q, k, v, pos, cur, n, ref.decode_attention_partial_ref,
            ref.decode_merge_ranks_ref)
        S = L // n
        e_o = e_lse = 0.0
        texts = []
        for r, ((ko, kl), (wo, wl)) in enumerate(zip(kparts, pparts)):
            live = max(0, min(S, cur + 1 - r * S))
            mut = None
            if tol is None and live == S:  # a live shard's zeroed tile
                mut = ref.decode_attention_partial_ref(
                    q, k[:, r * S:(r + 1) * S],
                    zero_tile(v[:, r * S:(r + 1) * S]),
                    pos[r * S:(r + 1) * S], cur)[0]
            e, text = hold(f"decode_attention_partial {label} shard {r}",
                           ko, wo, mut, tol)
            e_lse_r = max_err(kl, wl)
            assert e_lse_r < LSE_TOL, (label, r, e_lse_r)
            if live == 0:  # no live key: lse -1e30 on both sides
                assert bool((kl == -1e30).all() and (wl == -1e30).all()), \
                    (label, r)
            e_o, e_lse = max(e_o, e), max(e_lse, e_lse_r)
            texts.append(f"shard {r} ({live} live keys) {text} "
                         f"lse_err={e_lse_r:.2e}")
        e_m, text_m = hold(f"decode_merge_ranks {label}",
                           merge(po, plse, dtype),
                           ref.decode_merge_ranks_ref(po, plse, dtype),
                           tol=tol)
        whole = ref.decode_attention_ref(q, k, v, pos, cur)[:, 0]
        mut = (None if tol is not None else
               ref.decode_attention_ref(q, k, zero_tile(v), pos, cur)[:, 0])
        e_w, text_w = hold(f"sharded decode {label}", got, whole, mut, tol)
        if label == "bf16 main shapes":
            errs = {"decode_attention_partial": e_o,
                    "decode_merge_ranks": e_m}
        splits = decode_split_plan(BH // G, G, S, sms, dtype, D)
        lines.append(f"decode_attention_partial {label} rows={BH} L={L} "
                     f"over {n} shard(s) of {S} keys ({splits} splits "
                     f"each), cur_pos={cur}: "
                     + "; ".join(texts))
        lines.append(f"decode_merge_ranks {label} {n} ranks: {text_m}; the "
                     f"merged kernels against the whole cache's decode: "
                     f"{text_w}")
        del q, k, v, kparts, pparts, po, plse, got, whole, mut
    free_card()
    return errs, lines


def long_block_sparse_check(dev):
    """Phase 3: block-sparse bf16 at the long_500k prefill's key count,
    phi3-mini's 32 heads at D = 96: LONG_SQ queries at the end of LONG_SKV
    keys under the causal selection (one layer's K and V 3.2 GB each, so
    the offsets past 2^31 bytes are read), against the plain version a
    few rows at a time. Returns the report line."""
    from repro_torch.core.modes import causal_selection
    from repro_torch.kernels import ref
    from repro_torch.kernels.block_sparse_attention import (
        KERNEL_BLOCK, block_sparse_attention_bh)
    H, D = 32, 96
    g = torch.Generator(device=dev).manual_seed(34)
    q = torch.randn(H, LONG_SQ, D, generator=g, device=dev).bfloat16()
    k = torch.randn(H, LONG_SKV, D, generator=g, device=dev).bfloat16()
    v = torch.randn(H, LONG_SKV, D, generator=g, device=dev).bfloat16()
    start = LONG_SKV - LONG_SQ
    sel = causal_selection(start, LONG_SQ, LONG_SKV, H, dev)
    out = block_sparse_attention_bh(q, k, v, sel, q_offset=start)
    kw = dict(block=KERNEL_BLOCK, q_offset=start)
    want = rows_plain(ref.block_sparse_attention_ref, q, k, v, sel, **kw)
    e, r = max_err(out, want), bf16_ratios(out, want)
    v[:, LONG_SKV - 2 * LONG_SQ:LONG_SKV - LONG_SQ] = 0  # a late tile
    r_mut = bf16_ratios(rows_plain(ref.block_sparse_attention_ref, q, k, v,
                                   sel, **kw), want)
    assert max(r) < 1, f"long block-sparse: error {r} of the limit"
    assert min(r_mut) > 1, f"long block-sparse: a zeroed tile {r_mut}"
    del q, k, v, out, want
    free_card()
    return (f"block_sparse_attention bfloat16 long_500k keys Skv={LONG_SKV} "
            f"Sq={LONG_SQ} H={H} D={D} (K {H * LONG_SKV * D * 2} bytes) "
            f"max_abs_err={e:.3e} limit_ratio={ratio_text(r)} "
            f"zeroed_tile_ratio={ratio_text(r_mut)}")


def lse_library(q, k, v):
    """The PyTorch calls that compute the partial decode's function on q
    (BH, 1, D) over every key of k / v (BH, L, D): aten's flash and
    memory-efficient SDPA entries each return the output and its
    log-sum-exp in one call. Returns {backend: call}, each call giving
    (o (BH, D), lse (BH,) in log2 units; aten's is natural)."""
    q4, k4, v4 = q[None], k[None], v[None]  # (1, BH, L, D)
    aten = torch.ops.aten
    log2e = 1 / float(np.log(2))

    def out(o, lse):
        return o[0, :, 0], lse[0, :, 0] * log2e

    return {
        "flash": lambda: out(*aten._scaled_dot_product_flash_attention(
            q4, k4, v4)[:2]),
        "efficient": lambda: out(
            *aten._scaled_dot_product_efficient_attention(
                q4, k4, v4, None, True)[:2])}


def seq_kernel_times(dev):
    """Phase 4: the partial decode at one of SEQ_SHARDS shards of
    SEQ_CAPACITY keys (32 rows, D = 96, bf16, every key live) beside the
    library's calls that compute the same function (``lse_library``; the
    faster is ``library_ms``, each backend's time and its error against
    the kernel in the row) and ``decode_attention_bh`` over the whole
    cache, and the rank merge of SEQ_SHARDS ranks' states at 32 rows
    (no one PyTorch call computes it). Each with its plain version and
    its bound (bytes at 3.35 TB/s). Returns ({kernel: row}, report
    lines)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_bh
    from repro_torch.kernels.decode_attention_partial import \
        decode_attention_partial_bh as partial
    from repro_torch.kernels.decode_merge_ranks import \
        decode_merge_ranks_bh as merge
    BH, D, L = 32, 96, SEQ_CAPACITY
    S = L // SEQ_SHARDS
    q, k, v, pos = seq_inputs(dev, torch.bfloat16, BH, 1, L, D, 35)
    cur = L - 1
    ks, vs, ps = k[:, :S].contiguous(), v[:, :S].contiguous(), pos[:S]
    n_bytes = 2 * BH * S * D * 2 + BH * D * 2 + BH * (D + 1) * 4 + S * 4
    b_ms, b_by = bound(n_bytes, 4 * D * BH * S)
    want_o, want_lse = partial(q, ks, vs, ps, cur)
    lib = {}
    for backend, call in lse_library(q, ks, vs).items():
        try:
            o, lse = call()
        except RuntimeError as exc:  # the backend refuses the shapes
            lib[backend] = dict(ms=None, refused=str(exc).split("\n")[0])
            continue
        lib[backend] = dict(ms=time_ms(call), o_err=max_err(o, want_o),
                            lse_err=max_err(lse, want_lse))
    timed = [(r["ms"], b) for b, r in lib.items() if r["ms"] is not None]
    lib_ms, lib_backend = min(timed) if timed else (None, None)
    rows = {"decode_attention_partial": dict(
        ms=time_ms(lambda: partial(q, ks, vs, ps, cur)),
        call_ms=call_ms(lambda: partial(q, ks, vs, ps, cur)),
        plain_ms=time_ms(lambda: ref.decode_attention_partial_ref(
            q, ks, vs, ps, cur)),
        library_ms=lib_ms, library_backend=lib_backend, library=lib,
        bound_ms=b_ms, bound_by=b_by,
        whole_cache_decode_ms=time_ms(
            lambda: decode_attention_bh(q, k, v, pos, cur)),
        shape=f"{BH} rows D={D} shard of {S} of {L} keys")}
    o = torch.randn(SEQ_SHARDS, BH, D, device=dev)
    lse = 10 * torch.randn(SEQ_SHARDS, BH, device=dev)
    n_bytes = SEQ_SHARDS * BH * (D + 1) * 4 + BH * D * 2
    b_ms, b_by = bound(n_bytes, 3 * SEQ_SHARDS * BH * D)
    rows["decode_merge_ranks"] = dict(
        ms=time_ms(lambda: merge(o, lse, torch.bfloat16)),
        call_ms=call_ms(lambda: merge(o, lse, torch.bfloat16)),
        plain_ms=time_ms(lambda: ref.decode_merge_ranks_ref(
            o, lse, torch.bfloat16)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        shape=f"{SEQ_SHARDS} ranks x {BH} rows D={D}")
    lines = []
    for name, r in rows.items():
        extra = ""
        if "whole_cache_decode_ms" in r:
            extra = (f" ({r['library_backend']}; {json.dumps(r['library'])})"
                     f" whole_cache_decode_ms="
                     f"{r['whole_cache_decode_ms']:.4f}")
        lines.append(f"{name} {r['shape']} ms={r['ms']:.4f} "
                     f"call_ms={r['call_ms']:.4f} plain_ms="
                     f"{r['plain_ms']:.4f} library_ms={r['library_ms']} "
                     f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
                     f"roofline_share={r['bound_ms'] / r['ms']:.3f}{extra}")
    del q, k, v, ks, vs
    free_card()
    return rows, lines


RING_POOL_LENS = (4112, 2080, 1400, 100)  # depths of the timed ring pool
# a tensor-parallel rank's heads of deepseek's 128: 64 at TP 2, 32 at TP
# 4, and 8 at TP 2 of phase 17's narrowing (16 heads); below 64 the bf16
# kernel's one CTA a slot runs a partial head block
MLA_TP_HEADS = (64, 32, 8)
# the latent decode's timed shapes: (slot lengths, capacity L, ring with
# holes, heads); long context and many concurrent decodes fill the card,
# and the pool at a tensor-parallel rank's head counts
MLA_SHAPES = {
    "pool": (POOL_LENS, PROMPT + GEN, False, 128),
    "ring": (RING_POOL_LENS, 2176, True, 128),
    "long_context": ((32768,) * 4, 32768, False, 128),
    "high_batch": ((4096,) * 64, 4096, False, 128),
    **{f"pool_h{H}": (POOL_LENS, PROMPT + GEN, False, H)
       for H in MLA_TP_HEADS},
}
MLA_SWEEP_TILES = (1, 2, 4, 8, 16, 32, 64)


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
    of the kernel), and at D = 128 with G = 12 (12 heads a slot): bf16
    under the bf16 limit per live slot with its zeroed tile above it, fp32
    within 1e-4, the empty slot's rows zeros."""
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
    L = 300
    B = len(SMALL_POOL_LENS)
    lens = torch.tensor(SMALL_POOL_LENS, dtype=torch.int32, device=dev)
    rpos = ring_positions(np.random.default_rng(6), SMALL_POOL_LENS, L)
    rpos[3, 64:128] = -1
    rpos = torch.as_tensor(rpos, device=dev)
    dtypes = (torch.bfloat16, torch.float32)
    for dtype, D, G, ring in (
            [(t, D, G, r) for t in dtypes for D in HEAD_DIMS
             for G in (1, 4) for r in (False, True)]
            + [(t, D, G, r) for t in dtypes for D, G in ((128, 12), (64, 3))
               for r in (False, True)]):
        Hq = {12: 12, 3: 6}.get(G, 8)
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
            [(t, lambda q=q, k=k, v=v, pos=pos, t=t, h=Hq:
              decode_attention_pooled_bh(q, k, v, pos, lens, n_heads=h,
                                         tiles=t)) for t in tiles],
            lambda q=q, k=k, v=v, pos=pos, h=Hq:
                ref.decode_attention_pooled_ref(q, k, v, pos, lens,
                                                n_heads=h),
            (lambda q=q, k=k, v=v, pos=pos, h=Hq:
                ref.decode_attention_pooled_ref(
                    q, k, zero_slot_tiles(v, SMALL_POOL_LENS), pos, lens,
                    n_heads=h)) if bf16 else None,
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


def path_parity(dev, arch=ARCH, cfg=None, routings=("router", "mixed")):
    """Phase 5 (phi3-mini), 9 (stablelm) and 25 (mamba2, jamba's smoke
    variant): the same 2-layer full-width fp32 weights of ``arch`` (or of
    ``cfg``) on cuda and cpu, through ``generate`` under each of
    ``routings``.

    The hard decision is mean(p_fa) > 0.5 (strict), so a layer whose
    p_fa sits within rounding of 0.5 could route differently on the two
    devices. The prompt seed is the first whose router margins all exceed
    1e-3, found on the card; the CPU run must agree with it."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import routing_letters, routing_pattern
    from repro_torch.models import model as MD
    from repro_torch.serve.engine import ServeEngine
    cfg = cfg or get_config(arch).replace(num_layers=2, dtype=torch.float32,
                                          param_dtype=torch.float32)
    routed = bool(cfg.flux.enabled and cfg.routable_layers())
    # drawn on the card (the CPU's generator takes ≈ 11 ns a parameter:
    # 21 s for stablelm's 2 layers); each engine copies them to its device
    params = MD.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    S, N = 2304, 8
    assert S > cfg.flux.sink + cfg.flux.local
    engines = {d.type: ServeEngine(params, cfg, max_len=S + N,
                                   prefill_chunk=CHUNK, device=d)
               for d in (dev, torch.device("cpu"))}
    for seed in range(32):
        toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                    (1, S))
        if not routed:
            break
        pf = MD.prefill(engines["cuda"].params, cfg,
                        torch.as_tensor(toks[:, :CHUNK],
                                        device=engines["cuda"].device),
                        routing_ctx="hard_prefix", want_cache=False)
        if float(np.abs(pf.p_fa.numpy() - 0.5).min()) > 1e-3:
            break
    else:
        raise AssertionError("no prompt seed with router margins > 1e-3")
    out = [f"prompt_seed={seed}"]
    for name in routings:
        override = routing_pattern(cfg, name)
        res = {d: e.generate(toks, N, routing_override=override)
               for d, e in engines.items()}
        g, c = res["cuda"], res["cpu"]
        err = float((g.logits.cpu() - c.logits).abs().max())
        assert g.routing == c.routing, (g.routing, c.routing)
        assert np.array_equal(g.tokens, c.tokens), (g.tokens, c.tokens)
        assert err < 2e-3, err  # fp32 both; summation order only
        assert g.kv_bytes == c.kv_bytes
        if override is None and routed:
            margin = float(np.abs(c.p_fa - 0.5).min())
            assert margin > 1e-3, c.p_fa
            out.append(f"p_fa={np.round(c.p_fa, 5).tolist()}")
        out.append(f"{name} routing={routing_letters(g.routing)} "
                   f"logits_err={err:.2e} kv_bytes={g.kv_bytes} "
                   f"tokens={g.tokens[0].tolist()}")
    return "; ".join(out)


def decode_launches(cfg, steps, pooled, seq_sharded=0):
    """The decode kernels' launches for ``steps`` decode steps of every
    attention layer, global or local (a Mamba layer launches none): an
    MLA model's latent decode on both frontends, else the batch kernel
    (an int pos) or the pooled one (a (B,) pos), but at the
    ``seq_sharded`` layers whose cache is a sequence shard the partial
    decode and the rank merge; and no launch of the backward kernel,
    which serving never runs."""
    n = steps * sum(k in ("attn", "local") for k in cfg.layer_kinds)
    sharded = steps * seq_sharded
    if cfg.use_mla:
        return dict(decode_attention=0, decode_attention_pooled=0,
                    decode_attention_mla=n, attention_backward=0,
                    block_sparse_backward=0, decode_attention_partial=0,
                    decode_merge_ranks=0)
    return dict(decode_attention=0 if pooled else n - sharded,
                decode_attention_pooled=n if pooled else 0,
                decode_attention_mla=0, attention_backward=0,
                block_sparse_backward=0, decode_attention_partial=sharded,
                decode_merge_ranks=sharded)


def prefill_launches(cfg, admissions, repacks=()):
    """Each prefill kernel's launches for these (pattern, prompt length,
    prefix hit boundary) admissions through the chunked prefill. Cold
    (hit 0): flash (FA layers) and streaming (SA layers) once per layer
    on the routing chunk, block-sparse once per FA layer on every later
    chunk (an MLA model's full-cache layers run the absorbed attention
    there, in plain torch). A local (sliding-window) layer runs
    streaming at sink 0 once on the routing chunk and its later chunks in
    plain torch. A hit skips the routing chunk and the chunks it covers:
    block-sparse once per FA layer on each chunk past the boundary.
    ``repacks`` are the (pattern, prompt length) of every monolithic
    prefill (the repack fallback, which serves the xa and ta SA modes),
    an admitted one also in ``admissions``: flash at each FA layer; at
    each SA layer streaming (ssa), block-sparse (xa), or flash and, past
    ta's chunk, streaming; streaming at each local layer."""
    from repro_torch.serve.engine import chunk_plan
    want = {"flash_attention": 0, "streaming_attention": 0,
            "block_sparse_attention": 0}
    mode = cfg.flux.sa_mode
    n_local = sum(k == "local" for k in cfg.layer_kinds)
    left = collections.Counter(repacks)
    for pattern, n in repacks:
        n_fa = sum(p == "fa" for p in pattern)
        n_sa = sum(p == "sa" for p in pattern)
        want["streaming_attention"] += n_local
        want["flash_attention"] += n_fa + (n_sa if mode == "ta" else 0)
        if mode == "xa":
            want["block_sparse_attention"] += n_sa
        elif mode == "ssa" or n > cfg.flux.chunk:
            want["streaming_attention"] += n_sa
    for pattern, n, hit in admissions:
        if not hit and left[pattern, n]:
            left[pattern, n] -= 1  # counted with the repacks
            continue
        n_fa = sum(p == "fa" for p in pattern)
        covered = hit // CHUNK if hit else 1  # a cold one: the route chunk
        if not hit:
            want["flash_attention"] += n_fa
            want["streaming_attention"] += sum(p == "sa" for p in pattern)
            want["streaming_attention"] += n_local
        if not cfg.use_mla:
            want["block_sparse_attention"] += n_fa * (
                len(chunk_plan(n, CHUNK)) - covered)
    return want


def router_margin_seed(engine, lens, max_seed=32, thresholds=(0.5,)):
    """The first prompt seed whose prompts' router decisions all sit more
    than 1e-3 from every one of ``thresholds`` on the card (the hard
    decision is a strict mean(p_fa) > threshold, so a closer tie could
    flip on rounding), and its prompts; seed 0 (margin inf) for a model
    with no routed layer."""
    from repro_torch.models import model as MD
    cfg = engine.cfg
    for seed in range(max_seed):
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
        if not (cfg.flux.enabled and cfg.routable_layers()):
            return seed, prompts, float("inf")
        margins = []
        for toks in prompts:
            pf = MD.prefill(engine.params, cfg,
                            torch.as_tensor(toks[None, :CHUNK],
                                            device=engine.device),
                            routing_ctx="hard_prefix", want_cache=False)
            p_fa = pf.p_fa.numpy()
            margins.append(min(float(np.abs(p_fa - t).min())
                               for t in thresholds))
        if min(margins) > 1e-3:
            return seed, prompts, min(margins)
    raise AssertionError("no prompt seed with router margins > 1e-3")


def pool_parity(dev, arch=ARCH, cfg=None, routings=("router", "mixed")):
    """Phases 5b (phi3-mini), 9b (stablelm) and 25 (mamba2, jamba's smoke
    variant): the slot-pool scheduler on cuda and cpu with the same
    2-layer full-width fp32 weights of ``arch`` (or of ``cfg``, phase 17's
    narrowed deepseek, phase 25's models), under each of ``routings``.
    Returns its report line."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (PREFILL_CHUNKS_PER_TICK,
                                          routing_letters, routing_pattern)
    from repro_torch.models import model as MD
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.scheduler import STATUS_OK, ContinuousScheduler
    cfg = cfg or get_config(arch).replace(num_layers=2, dtype=torch.float32,
                                          param_dtype=torch.float32)
    params = MD.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)  # on the card, as ``path_parity``'s
    lens, N = (2304, 1536, 1000, 700, 2304), 8
    engines = {name: ServeEngine(params, cfg, max_len=max(lens) + N,
                                 prefill_chunk=CHUNK, device=d)
               for name, d in (("card", dev), ("cpu", "cpu"))}
    seed, prompts, margin = router_margin_seed(engines["card"], lens)
    routed = bool(cfg.flux.enabled and cfg.routable_layers())
    out = [f"prompt_seed={seed} min_margin={margin:.2e}"]
    for name in routings:
        override = routing_pattern(cfg, name)
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
        replayed = []
        for rid, toks in enumerate(prompts):
            assert g[rid].status == c[rid].status == STATUS_OK, rid
            assert g[rid].routing == c[rid].routing, (rid, name)
            assert np.array_equal(g[rid].tokens, c[rid].tokens), (rid, name)
            if cfg.num_experts and g[rid].metrics.preemptions:
                # a recompute replays the generated tokens through prefill
                # chunks whose MoE capacity may drop some, where decode
                # (one token a row) drops none: the JAX reference's victim
                # leaves its uninterrupted stream too
                replayed.append(rid)
                continue
            alone = engines["card"].generate(toks[None], N,
                                             routing_override=override)
            assert np.array_equal(g[rid].tokens, alone.tokens[0]), (rid,
                                                                    name)
            assert g[rid].routing == alone.routing
        assert preempt == sum(f.metrics.preemptions for f in c.values())
        assert gs.n_geometries() == cs.n_geometries()
        if override is not None or not routed:  # one geometry: it fills
            assert preempt >= 1, f"the {name} drain did not preempt"
        out.append(f"{name}: geometries={gs.n_geometries()} "
                   f"preemptions={preempt} ticks={gs.ticks} "
                   f"{'replayed (not held to generate alone)=' if replayed else ''}"
                   f"{replayed if replayed else ''} routing="
                   + ",".join(routing_letters(g[r].routing)
                              for r in range(len(lens)))
                   + f" tokens4={g[4].tokens.tolist()}")
    return "; ".join(out)


def main_path(dev, params, cfg, requests=REQUESTS,
              routings=("router", "mixed")):
    """Phases 6 (phi3-mini), 10 (stablelm), 12 (command-r, depth cut), 25
    (jamba's smoke variant) and 28 (gemma3): ``cfg`` in bf16 through the batch
    frontend, ``requests`` prompts of PROMPT tokens, once per routing (the
    router, or a forced pattern)."""
    import repro_torch.kernels as KN
    from repro_torch.launch.serve import routing_letters, routing_pattern
    from repro_torch.serve.engine import (Request, ServeEngine,
                                          serve_batch_finished)
    eng = ServeEngine(params, cfg, max_len=PROMPT + GEN, prefill_chunk=CHUNK,
                      device=dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (requests, PROMPT))
    lines = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    KN.reset_launch_counts()
    for name in routings:
        override = routing_pattern(cfg, name)
        before = KN.launch_counts()
        reqs = [Request(rid=i, tokens=prompts[i], n_steps=GEN,
                        routing_override=override)
                for i in range(requests)]
        done = serve_batch_finished(eng, reqs)
        gen = done[0].result
        assert all(len(done[i].tokens) == GEN for i in range(requests))
        assert gen.logits.shape == (requests, cfg.vocab_size)
        assert bool(torch.isfinite(gen.logits).all()), "first logits"
        assert bool(torch.isfinite(gen.final_logits).all()), "last logits"
        delta = {k: v - before[k] for k, v in KN.launch_counts().items()}
        n_fa = sum(p == "fa" for p in gen.routing)
        n_sa = sum(p == "sa" for p in gen.routing)
        n_chunks = PROMPT // CHUNK
        n_local = sum(k == "local" for k in cfg.layer_kinds)
        want = {"flash_attention": n_fa,
                "streaming_attention": n_sa + n_local,
                "block_sparse_attention": 0 if cfg.use_mla
                else n_fa * (n_chunks - 1),
                **decode_launches(cfg, GEN, pooled=False)}
        assert delta == want, (delta, want)
        lines.append(
            f"{name}: routing={routing_letters(gen.routing)} "
            f"msr={gen.msr:.3f} kv_bytes={gen.kv_bytes} "
            f"prefill_s={gen.prefill_s:.3f} "
            f"prefill_tok_s={requests * PROMPT / gen.prefill_s:.0f} "
            f"kv_bytes_per_row={gen.kv_bytes // requests} "
            f"decode_s={gen.decode_s:.3f} "
            f"decode_tok_s={requests * GEN / gen.decode_s:.1f} "
            f"launches={delta} tokens0={done[0].tokens[:8].tolist()}")
    counts = KN.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    served = ({"flash_attention", "streaming_attention",
               "decode_attention_mla"} if cfg.use_mla else
              {"flash_attention", "streaming_attention",
               "block_sparse_attention", "decode_attention"})
    for k in served:
        assert counts[k] > 0, f"{k} was never launched on the batch path"
    lines.append(f"peak_mem_bytes={peak} card={torch.cuda.get_device_name(0)}")
    return counts, lines


def continuous_path(dev, params, cfg):
    """Phases 7 (phi3-mini), 11 (stablelm), 25 (jamba's smoke variant) and
    28 (gemma3): ``cfg`` at full depth in bf16 through the continuous
    frontend."""
    import repro_torch.kernels as KN
    from repro_torch.launch.serve import (PREFILL_CHUNKS_PER_TICK,
                                          routing_letters, routing_pattern)
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.scheduler import STATUS_OK, ContinuousScheduler
    eng = ServeEngine(params, cfg, max_len=PROMPT + GEN, prefill_chunk=CHUNK,
                      device=dev)
    repacks = []  # every monolithic prefill: (pattern, prompt length)
    repack = eng.prefill_route_repack

    def recorded(tokens, override=None):
        out = repack(tokens, override)
        repacks.append((out[1], out[3]))
        return out
    eng.prefill_route_repack = recorded
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT // (1 + rid % 3))
               for rid in range(8)]
    mixed, fa = routing_pattern(cfg, "mixed"), routing_pattern(cfg, "fa")
    override = [mixed] * 4 + [fa, fa, None, mixed]
    mixed_pattern = eng._pattern(None, mixed)  # None at a Mamba layer
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
        pool = next((p for p in sched.pools.values()
                     if p.pattern == mixed_pattern), None)
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
            assert f.routing == eng._pattern(None, override[rid]), rid
    preempt = sum(f.metrics.preemptions for f in done.values())
    assert preempt >= 1, "no preemption"
    assert 2 <= sched.n_geometries() <= 3, sched.n_geometries()
    steps = [p.steps for p in sched.pools.values()]
    want = prefill_launches(cfg, sched.admissions, repacks)
    want.update(decode_launches(cfg, sum(steps), pooled=True))
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
        + ",".join(routing_letters(pl.pattern)
                   for pl in sched.pools.values())
        + f" ticks={sched.ticks} preemptions={preempt} "
        f"admissions={len(sched.admissions)} repacks={len(repacks)} "
        f"kv_payload_bytes={summ['kv_payload_bytes']} peak_mem_bytes={peak}",
        f"launches={counts} tokens7={done[7].tokens[:8].tolist()}"]
    return counts, lines


def copy_times(eng, state):
    """Times of the prefix store's three copies of one boundary state:
    a publish (``snapshot_state``, device time), a demotion to pinned
    host memory and a host-tier restore to the card (host clock, median
    of 5; both are synchronous). Returns (bytes, {name: (ms, GB/s)})."""
    from repro_torch.models import model as MD
    from repro_torch.serve import kv_cache as KC
    from repro_torch.serve import prefix_cache as PXC
    caches, logits = state
    n = PXC.state_bytes(caches, logits)

    def host_ms(fn):
        out = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    host = PXC.host_state(caches, logits)
    assert all(t.is_pinned() for c in host[0] for t in KC.cache_fields(c))
    ms = {"publish": time_ms(lambda: MD.snapshot_state(caches, logits),
                             reps=3, rounds=3, warmup=1),
          "demote": host_ms(lambda: PXC.host_state(caches, logits)),
          "restore": host_ms(lambda: PXC.device_state(*host, eng.device))}
    return n, {k: (v, n / v / 1e6) for k, v in ms.items()}


def prefix_path(dev, params, cfg=None, snapshots=None):
    """Phases 8 (phi3-mini) and 28 (gemma3, ``cfg``): the shared-prefix
    snapshot store on both frontends, its budgets BATCH_STORE_MB and
    CONT_STORE_MB, or (``snapshots``) the batch store's device and host
    tiers and the continuous store in snapshots of the cold run's routed
    geometry. Returns (launch counts of the warm runs, report lines)."""
    import repro_torch.kernels as KN
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (PREFILL_CHUNKS_PER_TICK,
                                          routing_letters)
    from repro_torch.serve import prefix_cache as PXC
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.scheduler import STATUS_OK, ContinuousScheduler
    cfg = cfg or get_config(ARCH)
    V, L = cfg.vocab_size, cfg.num_layers
    kw = dict(max_len=PROMPT + GEN, prefill_chunk=CHUNK, device=dev)
    rng = np.random.default_rng(3)
    pre = rng.integers(0, V, PREAMBLE)
    A, B = (np.concatenate([pre, rng.integers(0, V, PROMPT - PREAMBLE)])
            [None] for _ in range(2))
    cold = ServeEngine(params, cfg, **kw)
    ref = {"A": cold.generate(A, GEN), "B": cold.generate(B, GEN)}
    batch_mb, cont_mb = BATCH_STORE_MB, CONT_STORE_MB
    if snapshots:
        mb = PXC.snapshot_spec_bytes(cfg, ref["A"].routing,
                                     kw["max_len"]) / 2 ** 20
        batch_mb, cont_mb = (snapshots[0] * mb, snapshots[1] * mb), \
            snapshots[2] * mb
    warm = ServeEngine(params, cfg, prefix_cache_mb=batch_mb[0],
                       prefix_cache_host_mb=batch_mb[1], **kw)
    store = warm.prefix_store
    events = collections.Counter()
    store.on_event = lambda name: events.update([name])
    torch.cuda.synchronize()
    KN.reset_launch_counts()
    runs = [("A cold", "A", warm.generate(A, GEN))]
    t_off = time.perf_counter()
    offloaded = store.offload_all()
    t_off = time.perf_counter() - t_off
    runs.append(("A host hit", "A", warm.generate(A, GEN)))
    runs.append(("B hit", "B", warm.generate(B, GEN)))
    torch.cuda.synchronize()
    counts = KN.launch_counts()
    pattern = ref["A"].routing
    lines = []
    for name, key, gen in runs:
        assert gen.routing == pattern == ref[key].routing, name
        assert np.array_equal(gen.tokens, ref[key].tokens), name
        assert torch.equal(gen.logits, ref[key].logits), name
        lines.append(f"batch {name}: prefix_hit_tokens="
                     f"{gen.prefix_hit_tokens} prefill_s={gen.prefill_s:.4f}"
                     f" (cold {ref[key].prefill_s:.4f}) tokens_equal=True "
                     f"first_logits_equal=True")
    assert [g.prefix_hit_tokens for *_, g in runs] == [0, PROMPT, PREAMBLE]
    want = prefill_launches(cfg, [(pattern, PROMPT, 0),
                                  (pattern, PROMPT, PROMPT),
                                  (pattern, PROMPT, PREAMBLE)])
    want.update(decode_launches(cfg, 3 * GEN, pooled=False))
    assert counts == want, (counts, want)
    s = store.stats()
    assert min(s.demotions, events["promotion"], s.drops) >= 1, (s, events)
    job = cold.prefill_chunked(A)
    n, ms = copy_times(cold, (job.caches, job.logits))
    lines.append(
        f"batch routing={routing_letters(pattern)} snapshot_bytes={n} "
        f"offloaded={offloaded} offload_all_s={t_off:.4f} "
        f"promotions={events['promotion']} "
        f"store={s.as_dict()} launches={counts}")
    lines.append("copy of one snapshot: " + " ".join(
        f"{k}_ms={v:.3f} ({gbs:.1f} GB/s copied)"
        for k, (v, gbs) in ms.items()))
    del warm, store, cold, job
    free_card()

    pre = rng.integers(0, V, CONT_PREAMBLE)
    prompts = [np.concatenate([pre, rng.integers(
        0, V, CONT_TAILS[rid % len(CONT_TAILS)])]) for rid in range(8)]

    def drain(**store_kw):
        eng = ServeEngine(params, cfg, **kw, **store_kw)
        sched = ContinuousScheduler(
            eng, slots_per_bucket=4, chunk=8,
            prefill_chunks_per_tick=PREFILL_CHUNKS_PER_TICK)
        for rid, toks in enumerate(prompts):
            eng.submit(Request(rid=rid, tokens=toks, n_steps=GEN))
        t0 = time.perf_counter()
        done = eng.drain()
        torch.cuda.synchronize()
        return eng, sched, done, time.perf_counter() - t0

    _, _, cold_done, cold_wall = drain()
    free_card()
    KN.reset_launch_counts()
    eng, sched, done, wall = drain(prefix_cache_mb=cont_mb)
    cont = KN.launch_counts()
    hits = [done[r].metrics.prefix_hit_tokens for r in range(8)]
    for rid in range(8):
        assert done[rid].status == cold_done[rid].status == STATUS_OK, rid
        assert len(done[rid].tokens) == GEN, rid
        assert np.array_equal(done[rid].tokens, cold_done[rid].tokens), rid
    assert hits[0] == 0 and all(h > 0 for h in hits[1:]), hits
    want = prefill_launches(cfg, sched.admissions)
    want.update(decode_launches(
        cfg, sum(p.steps for p in sched.pools.values()), pooled=True))
    assert cont == want, (cont, want)
    # generate alone decodes on the batch kernel, whose splits differ
    # from the pooled kernel's, so in bf16 a near-tied greedy step can
    # flip: report the first step where each stream departs (GEN = same)
    alone = []
    for rid in range(8):
        ref_toks = eng.generate(prompts[rid][None], GEN,
                                prefix_reuse=False).tokens[0]
        diff = np.flatnonzero(ref_toks != done[rid].tokens)
        alone.append(int(diff[0]) if diff.size else GEN)
    summ, csum = done.summary, cold_done.summary
    lines.append(
        f"continuous: prompt_lens={[len(p) for p in prompts]} "
        f"prefix_hit_tokens={hits} hit_fraction="
        f"{summ['prefix_hit_fraction']:.3f} tokens_equal_cold_drain=True "
        f"first_step_departing_from_generate_alone={alone} "
        f"wall_s={wall:.3f} (cold {cold_wall:.3f}) ttft_p50_s="
        f"{summ['ttft_p50_s']:.3f} (cold {csum['ttft_p50_s']:.3f}) "
        f"prefill_time_p50_s={summ['prefill_time_p50_s']:.4f} (cold "
        f"{csum['prefill_time_p50_s']:.4f})")
    lines.append(f"continuous store={summ['prefix_store'].as_dict()} "
                 f"launches={cont}")
    total = {k: counts[k] + cont[k] for k in counts}
    return total, lines


class VirtualClock:
    """The tick-advanced clock of phase 13, the same on both devices:
    arrivals at whole seconds, each tick half a second after them."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def guarded_drain(eng, sched, arrivals, *, cancel_tick, fault, clk=None,
                  on_tick=None):
    """Drive ``sched`` to the end through a scripted guarded drain.

    ``arrivals``: (when, request, pause) triples; ``when`` is a tick
    index or a predicate of the scheduler, tested before each tick, and
    ``pause`` seconds of real time pass after the submit (a deadline
    that must expire before the next tick). From tick ``cancel_tick`` on,
    the first resident request (by rid) that has decoded a chunk is
    cancelled, once. Once every arrival is in, the first resident (by
    rid) that has decoded a chunk and shares its pool is the fault
    target: with ``fault`` it is poisoned (``inject_fault``), without it
    the drain runs on untouched, so the two runs are tick for tick the
    same up to there, and its siblings, already routed and with no
    higher-priority arrival left to preempt them, decode the same
    chunks in both. Returns (finished by rid, the rung after every tick,
    (fault tick, target rid, its siblings' rids) or None, the siblings'
    logits rows after the fault tick, on the host)."""
    pending, levels, target, sib_rows = list(arrivals), [], None, None
    sib_logits = cancelled = None
    k = 0
    while pending or sched.waiting or sched.n_active():
        if k > 10_000:
            raise AssertionError(f"{len(pending)} arrivals never came")
        for item in list(pending):
            when, req, pause = item
            if (when(sched) if callable(when) else when == k):
                pending.remove(item)
                sched.submit(req)
                if pause:
                    time.sleep(pause)
        resident = sorted(
            (inf.req.rid, pool) for pool in sched.pools.values()
            for inf in pool.active.values() if inf.generated)
        if k >= cancel_tick and cancelled is None and resident:
            eng.cancel(resident[0][0])
            cancelled = True
            resident = resident[1:]
        if target is None and not pending:
            for rid, pool in resident:
                sibs = sorted((i.req.rid, s) for s, i in pool.active.items()
                              if i.req.rid != rid)
                if sibs:
                    target = (k, rid, [r for r, _ in sibs])
                    sib_rows = (pool, [s for _, s in sibs])
                    if fault:
                        eng.inject_fault(rid)
                    break
        if clk is not None:
            clk.t += 0.5
        sched.tick()
        if clk is not None:
            clk.t += 0.5
        if sib_rows is not None and sib_logits is None:
            pool, slots = sib_rows
            sib_logits = pool.logits[slots].cpu()
        levels.append(eng.sa_level)
        if on_tick is not None:
            on_tick()
        k += 1
    return ({f.rid: f for f in sched.finished}, levels, target,
            sib_logits)


def counters(text):
    """{(name, labels): value} of the counter samples and of every
    histogram's ``_count`` in a Prometheus text (the port's parser)."""
    from repro_torch.serve.telemetry import parse_prometheus_text
    kinds = dict(line.split()[2:4] for line in text.splitlines()
                 if line.startswith("# TYPE"))
    return {(name, tuple(sorted(lb.items()))): v
            for name, rows in parse_prometheus_text(text).items()
            for lb, v in rows
            if kinds.get(name) == "counter" or (
                name.endswith("_count")
                and kinds.get(name[:-len("_count")]) == "summary")}


def probe_log(eng):
    """Record every fidelity probe's per-layer coverage, in order."""
    log, probe = [], eng._maybe_fidelity_probe

    def logged(*args, **kw):
        cov = probe(*args, **kw)
        if cov is not None:
            log.append(cov)
        return cov
    eng._maybe_fidelity_probe = logged
    return log


def rung_text(levels):
    """The rung trace run-length coded: "0x1 1x3 ..." (rung x ticks)."""
    runs = []
    for lv in levels:
        if runs and runs[-1][0] == lv:
            runs[-1][1] += 1
        else:
            runs.append([lv, 1])
    return " ".join(f"{lv}x{n}" for lv, n in runs)


GUARD_LENS = (2304, 1536, 1000, 700)  # phase 13's prompts, cycled


def guarded_parity(dev):
    """Phase 13: a guarded drain of phase 5's phi3-mini (full width, 2
    layers, fp32, new weights from seed 0) on cuda and on cpu under one
    virtual clock. Returns its report line."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (PREFILL_CHUNKS_PER_TICK,
                                          routing_pattern)
    from repro_torch.models import model as MD
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.scheduler import ContinuousScheduler
    from repro_torch.serve.slo import STATUSES, SLOConfig
    cfg = get_config(ARCH).replace(num_layers=2, dtype=torch.float32,
                                   param_dtype=torch.float32)
    params = MD.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    N = 8
    lens = [GUARD_LENS[i % 4] for i in range(10)]
    slo = SLOConfig(max_queue=3, shed_policy="drop_lowest_priority",
                    preemption_budget=1, aging_s=8.0,
                    adaptive_sparsity=True, pressure_patience=1)
    engines = {name: ServeEngine(params, cfg, max_len=max(lens) + N,
                                 prefill_chunk=CHUNK, slo=slo,
                                 telemetry=True, fidelity_probe_every=1,
                                 device=d)
               for name, d in (("card", dev), ("cpu", "cpu"))}
    # decisions more than 1e-3 from every rung's threshold, so rounding
    # cannot route the two devices apart
    ladder = [engines["card"].fa_threshold(lv)
              for lv in range(slo.sa_level_max + 1)]
    seed, prompts, margin = router_margin_seed(engines["card"], lens,
                                               thresholds=ladder)
    mixed = routing_pattern(cfg, "mixed")

    def arrivals():
        # (tick, rid, override, priority, deadline): r3 is shed at its
        # submit, r4 preempts in the mixed pool, r5 expires queued
        plan = [(0, 0, mixed, 0, None), (0, 1, mixed, 0, None),
                (0, 2, None, 0, None), (0, 3, None, 0, None),
                (1, 4, mixed, 5, None), (1, 5, None, 1, 0.25),
                (2, 6, None, 0, None), (2, 7, None, 1, None),
                (3, 8, mixed, 0, None), (3, 9, mixed, 0, None)]
        return [(k, Request(rid=rid, tokens=prompts[rid], n_steps=N,
                            routing_override=ov, priority=prio,
                            deadline_s=dl), 0.0)
                for k, rid, ov, prio, dl in plan]

    res = {}
    for name, eng in engines.items():
        log = probe_log(eng)
        clk = VirtualClock()
        sched = ContinuousScheduler(
            eng, slots_per_bucket=2, chunk=4,
            prefill_chunks_per_tick=PREFILL_CHUNKS_PER_TICK, clock=clk,
            slo=slo)
        out, levels, target, rows = guarded_drain(
            eng, sched, arrivals(), cancel_tick=2, fault=True, clk=clk)
        res[name] = (out, levels, target, log, counters(eng.metrics_text()),
                     rows)
    (g, glev, gtgt, glog, gcnt, rows), (c, clev, ctgt, clog, ccnt, _) = \
        res["card"], res["cpu"]
    assert sorted(g) == sorted(c) == list(range(10))
    for rid in g:
        assert (g[rid].status, g[rid].routing, g[rid].metrics.preemptions) \
            == (c[rid].status, c[rid].routing, c[rid].metrics.preemptions), \
            rid
        assert np.array_equal(g[rid].tokens, c[rid].tokens), rid
    assert glev == clev and gtgt == ctgt and gtgt is not None
    assert {f.status for f in g.values()} == set(STATUSES), \
        {r: f.status for r, f in g.items()}
    assert gcnt == ccnt, {k: (v, ccnt.get(k)) for k, v in gcnt.items()
                          if ccnt.get(k) != v}
    assert len(glog) == len(clog) > 0
    cov_err = max(float(np.abs(a - b).max()) for a, b in zip(glog, clog))
    assert cov_err < 1e-4, cov_err
    # the same drain without the fault, on the card: the siblings
    clean_eng = engines["card"]
    clean_eng.set_sa_level(0)
    clk = VirtualClock()
    sched = ContinuousScheduler(
        clean_eng, slots_per_bucket=2, chunk=4,
        prefill_chunks_per_tick=PREFILL_CHUNKS_PER_TICK, clock=clk, slo=slo)
    clean, _, ctarget, clean_rows = guarded_drain(
        clean_eng, sched, arrivals(), cancel_tick=2, fault=False, clk=clk)
    tick, rid, sibs = gtgt
    assert ctarget == gtgt and g[rid].status == "failed"
    # the siblings' logits after the poisoned tick, bitwise
    assert torch.equal(rows, clean_rows)
    for s in sibs:
        assert g[s].status == clean[s].status == "ok", s
        assert np.array_equal(g[s].tokens, clean[s].tokens), s
    statuses = collections.Counter(f.status for f in g.values())
    return (f"prompt_seed={seed} min_margin={margin:.2e} statuses="
            f"{dict(statuses)} rungs={rung_text(glev)} "
            f"preemptions={sum(f.metrics.preemptions for f in g.values())} "
            f"fault=tick {tick} rid {rid} siblings {sibs} bitwise "
            f"probes={len(glog)} coverage_err={cov_err:.2e} "
            f"counters={len(gcnt)} equal routing="
            + ",".join("".join(p[0] for p in g[r].routing)
                       if g[r].routing else "-" for r in range(10)))


def pool_bytes(sched):
    """Every tensor byte the scheduler's pools hold (caches, logits, pos)."""
    from repro_torch.serve import kv_cache as KC
    return sum(t.nbytes for p in sched.pools.values() for c in p.caches
               for t in KC.cache_fields(c)) + sum(
        p.logits.nbytes + p.pos.nbytes for p in sched.pools.values())


def guarded_path(dev, params, cfg):
    """Phase 14: the guarded drain of phi3-mini-3.8b at full width and
    ``cfg``'s depth, bf16, on the real clock (phi3-mini's seeded weights,
    drawn again after phase 12). Returns (launch counts of the drain with
    telemetry, report lines)."""
    import repro_torch.kernels as KN
    from repro_torch.launch.serve import (PREFILL_CHUNKS_PER_TICK,
                                          routing_pattern)
    from repro_torch.models import model as MD
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.scheduler import ContinuousScheduler
    from repro_torch.serve.slo import STATUSES, SLOConfig
    from repro_torch.serve.telemetry import parse_prometheus_text
    from repro_torch.serve.tracing import request_spans, validate_trace
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT // (1 + rid % 3))
               for rid in range(12)]
    mixed, fa = routing_pattern(cfg, "mixed"), routing_pattern(cfg, "fa")
    slo = SLOConfig(max_queue=4, shed_policy="drop_lowest_priority",
                    preemption_budget=1, aging_s=30.0,
                    adaptive_sparsity=True, pressure_patience=1)

    def mixed_full(sched):
        return any(p.pattern == mixed and not p.free
                   for p in sched.pools.values())

    # (when, rid, override, priority, deadline): r4 is shed at its submit
    # (the queue holds 4); r6, priority 9, arrives once the mixed pool is
    # full and preempts; r7, with a 1 ms deadline, expires queued
    plan = [(0, 0, mixed, 0, None), (0, 1, mixed, 0, None),
            (0, 2, mixed, 0, None), (0, 3, None, 0, None),
            (0, 4, None, 0, None), (1, 5, mixed, 0, None),
            (mixed_full, 6, mixed, 9, None),
            (mixed_full, 7, None, 1, 1e-3),
            (3, 8, fa, 0, None), (3, 9, fa, 0, None),
            (4, 10, None, 0, None), (4, 11, mixed, 0, None)]

    def arrivals():
        return [(k, Request(rid=rid, tokens=prompts[rid], n_steps=GEN,
                            routing_override=ov, priority=prio,
                            deadline_s=dl), 2e-3 if dl else 0.0)
                for k, rid, ov, prio, dl in plan]

    def run(telemetry, fault):
        eng = ServeEngine(
            params, cfg, max_len=PROMPT + GEN, prefill_chunk=CHUNK,
            slo=slo, telemetry=telemetry,
            profile_every=4 if telemetry else 0,
            fidelity_probe_every=4 if telemetry else 0,
            memory_ledger=telemetry, device=dev)
        log = probe_log(eng)
        sched = ContinuousScheduler(
            eng, slots_per_bucket=4, chunk=8,
            prefill_chunks_per_tick=PREFILL_CHUNKS_PER_TICK, slo=slo)
        ledger = []

        def check_ledger():
            if eng.ledger is not None:
                snap = eng.ledger.last()
                ledger.append((snap.pool_payload_bytes
                               + snap.pool_overhead_bytes,
                               pool_bytes(sched)))
        torch.cuda.synchronize()
        KN.reset_launch_counts()
        t0 = time.perf_counter()
        out, levels, target, rows = guarded_drain(
            eng, sched, arrivals(), cancel_tick=4, fault=fault,
            on_tick=check_ledger)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return (eng, sched, out, levels, target, log, ledger, wall,
                KN.launch_counts(), eng._drain_summary(out), rows)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    (eng, sched, out, levels, target, log, ledger, wall, counts,
     summ, rows) = run(telemetry=True, fault=True)
    peak = torch.cuda.max_memory_allocated(dev)
    plain = run(telemetry=False, fault=True)
    clean = run(telemetry=False, fault=False)
    assert sorted(out) == list(range(12))  # each retired once
    assert len(sched.finished) == 12
    assert {f.status for f in out.values()} == set(STATUSES), \
        {r: f.status for r, f in out.items()}
    # telemetry and probes change no token; the fault reaches no sibling
    for rid, f in out.items():
        p = plain[2][rid]
        assert (f.status, f.routing) == (p.status, p.routing), rid
        assert np.array_equal(f.tokens, p.tokens), rid
    tick, rid, sibs = target
    assert clean[4] == target and out[rid].status == "failed"
    # the siblings' logits after the poisoned tick, bitwise
    assert torch.equal(rows, clean[10]) and torch.equal(rows, plain[10])
    for s in sibs:
        assert out[s].status == clean[2][s].status == "ok", s
        assert np.array_equal(out[s].tokens, clean[2][s].tokens), s
    # the dial: above rung 0, and an admission that routes a layer SA
    # its rung-0 decision would route FA
    assert max(levels) > 0, levels
    moved = []
    for (_, r, ov, _, _) in plan:
        f = out[r]
        if ov is None and f.routing is not None:
            pf = MD.prefill(eng.params, cfg,
                            torch.as_tensor(prompts[r][None, :CHUNK],
                                            device=dev),
                            routing_ctx="hard_prefix", want_cache=False)
            fa0 = pf.p_fa.numpy() > 0.5
            moved += [r for j, i in enumerate(cfg.routable_layers())
                      if fa0[j] and f.routing[i] == "sa"]
    assert moved, "no admission moved a layer FA -> SA"
    # launches: the routing chunks, the streamed chunks, every probe's
    # FA-only forward (flash at every layer) and the pool decode steps
    n_probes = -(-eng._probe_admissions // eng.fidelity_probe_every)
    assert n_probes == len(log) > 0
    want = prefill_launches(cfg, sched.admissions)
    want["flash_attention"] += n_probes * cfg.num_layers
    want.update(decode_launches(
        cfg, sum(p.steps for p in sched.pools.values()), pooled=True))
    assert counts == want, (counts, want)
    # telemetry surfaces
    samples = parse_prometheus_text(eng.metrics_text())
    path = ROOT / "artifacts" / "guarded_trace.json"  # git-ignored
    path.parent.mkdir(exist_ok=True)
    eng.export_trace(str(path))
    trace = json.loads(path.read_text())
    census = validate_trace(trace)
    assert sorted(request_spans(trace)) == list(range(12))
    assert ledger and all(a == b for a, b in ledger), ledger[:3]
    rep = eng.profiler_report()
    dec = next(p for p in rep["phases"] if p["phase"] == "decode")
    hbm_share = dec["achieved_gbytes_per_s"] * 1e9 / HBM_BYTES_PER_S
    assert 0 < hbm_share <= 1.05, hbm_share
    led = eng.ledger_report()
    assert led["reconciliation"]["payload_delta"] == 0
    # one probe layer's flash: a 4096-token prompt's 32 heads, causal
    from repro_torch.kernels.flash_attention import flash_attention_bh
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn((cfg.num_heads, PROMPT, cfg.head_dim),
                           generator=gen, device=dev, dtype=cfg.dtype)
               for _ in range(3))
    flash_ms = time_ms(lambda: flash_attention_bh(q, k, v))
    flash_bound, by = bound(*attn_work(
        cfg.num_heads, cfg.num_heads, PROMPT, cfg.head_dim, PROMPT,
        PROMPT * (PROMPT + 1) // 2 * cfg.num_heads, 2))
    cov = np.stack(log)
    statuses = collections.Counter(f.status for f in out.values())
    ttft_off = plain[9]["ttft_p50_s"]
    lines = [
        f"statuses={dict(statuses)} preemptions="
        f"{sum(f.metrics.preemptions for f in out.values())} "
        f"fault=tick {tick} rid {rid} siblings {sibs} bitwise; "
        f"telemetry on = off bitwise; rung FA->SA moves={len(moved)}",
        f"rungs={rung_text(levels)} ticks={sched.ticks} "
        f"geometries={sched.n_geometries()}",
        f"wall_s={wall:.3f} (telemetry off {plain[7]:.3f}) ttft_p50_s="
        f"{summ['ttft_p50_s']:.3f} (off {ttft_off:.3f}) clean_wall_s="
        f"{clean[7]:.3f}",
        f"launches={counts} probes={n_probes}; a probe layer's flash "
        f"({cfg.num_heads} x {PROMPT} x {cfg.head_dim}, causal) "
        f"{flash_ms:.4f} ms device, bound {flash_bound:.4f} ms ({by})",
        f"ledger: {len(ledger)} ticks reconciled, peak "
        f"{eng.ledger.high_watermark} B (params {eng.ledger.params_bytes} "
        f"B) vs max_memory_allocated {peak} B",
        f"profiler: {rep['sampled_ticks']} sampled ticks, decode "
        f"{dec['expressed_hbm_bytes']:.4g} B over {dec['device_s']:.4f} s "
        f"= {hbm_share:.4f} of 3.35 TB/s, host {dec['host_s']:.4f} s; "
        + " ".join(f"{p['phase']} dev {p['device_s']:.4f} s"
                   for p in rep["phases"] if p["device_s"]),
        f"coverage per layer (mean of {len(log)} probes): "
        + " ".join(f"{x:.4f}" for x in cov.mean(0)),
        f"metrics={len(samples)} names, trace {sum(census.values())} "
        f"events {census}, card={torch.cuda.get_device_name(0)}"]
    return counts, lines


MOE_GAP = 1e-6  # smallest k-th / (k+1)-th gate gap of phase 15's seeds
MOE_SEEDS = 64


class MoeRecorder:
    """While active, records every MoE dispatch of the port: the
    experts it chose (top_i and the kept mask, on the host) and every
    token's gap between its k-th and (k+1)-th gate probability."""

    def __init__(self):
        self.calls, self.gaps = [], []

    def __enter__(self):
        from repro_torch.models import moe as MOE
        self._mod, orig = MOE, MOE.dispatch

        def recorded(params, cfg, *a, **kw):
            d = orig(params, cfg, *a, **kw)
            top = torch.sort(d.probs, dim=-1, descending=True).values
            self.gaps.append((top[..., cfg.top_k - 1]
                              - top[..., cfg.top_k]).reshape(-1).cpu())
            self.calls.append((d.top_i.cpu(), d.keep.cpu()))
            return d
        self._orig = orig
        MOE.dispatch = recorded
        return self

    def __exit__(self, *exc):
        self._mod.dispatch = self._orig

    def min_gap(self):
        return float(torch.cat(self.gaps).min())

    def below(self, t):
        return int((torch.cat(self.gaps) < t).sum())


def moe_chunk_parity(dev, params, cfg):
    """One chunk of CHUNK tokens through layer 0's MoE of ``params`` on
    both devices, at granite's capacity factor: (report, drop fraction).
    The input stands for the normed residual the layer sees: seeded
    normal rows plus one direction every token shares (a residual stream
    has one; without it random gate weights spread the tokens so evenly
    that C = 128 slots hold every expert's load), each row scaled to
    unit rms. Its seed is the first whose smallest top-k gap on the card
    exceeds MOE_GAP."""
    from repro_torch.models import moe as MOE
    from repro_torch.models.model import params_to
    moe = params["layers"][0]["moe"]
    card_moe = params_to(moe, dev)
    for seed in range(MOE_SEEDS):
        rng = np.random.default_rng(seed)
        x = (rng.normal(size=(1, CHUNK, cfg.d_model))
             + 2 * rng.normal(size=cfg.d_model))
        x = torch.from_numpy((x / np.sqrt((x ** 2).mean(-1, keepdims=True))
                              ).astype(np.float32))
        d = MOE.dispatch(card_moe, cfg, x.to(dev))
        top = torch.sort(d.probs, dim=-1, descending=True).values
        gap = float((top[..., cfg.top_k - 1] - top[..., cfg.top_k]).min())
        if gap > MOE_GAP:
            break
    else:
        raise AssertionError(f"no chunk seed with a top-k gap > {MOE_GAP}")
    (yg, ag), (yc, ac) = (MOE.moe_apply(m, cfg, x.to(d0))
                          for m, d0 in ((card_moe, dev), (moe, "cpu")))
    dg, dc = MOE.dispatch(card_moe, cfg, x.to(dev)), MOE.dispatch(moe, cfg, x)
    drop = float(ag["drop_fraction"])
    err = float((yg.cpu() - yc).abs().max())
    assert drop > 0 and drop == float(ac["drop_fraction"]), (drop, ac)
    assert torch.equal(dg.top_i.cpu(), dc.top_i), "expert choices differ"
    assert torch.equal(dg.keep.cpu(), dc.keep), "kept sets differ"
    assert err < FP32_TOL, err
    pdiff = float((dg.probs.cpu() - dc.probs).abs().max())
    return (f"moe_apply one chunk (1 x {CHUNK} x {cfg.d_model}, C="
            f"{dg.C}, x seed {seed}): drop_fraction={drop:.4f} on both, "
            f"kept set and experts equal, y max_abs_err={err:.2e} "
            f"(tol {FP32_TOL}), gate probs max_abs_diff={pdiff:.2e}, "
            f"min top-k gap={gap:.2e}"), drop


def moe_fault_drain(dev, params, cfg, prompts):
    """The slot-pool drain of granite's 2-layer fp32 weights on the card
    with one resident request poisoned (``inject_fault``), beside the
    same drain without the fault: its pool siblings' logits after the
    fault tick and their tokens must be bitwise equal."""
    from repro_torch.launch.serve import (PREFILL_CHUNKS_PER_TICK,
                                          routing_pattern)
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.scheduler import ContinuousScheduler
    mixed = routing_pattern(cfg, "mixed")
    eng = ServeEngine(params, cfg, max_len=max(map(len, prompts)) + 8,
                      prefill_chunk=CHUNK, device=dev)
    runs = {}
    for fault in (True, False):
        sched = ContinuousScheduler(
            eng, slots_per_bucket=2, chunk=4,
            prefill_chunks_per_tick=PREFILL_CHUNKS_PER_TICK)
        arrivals = [(0, Request(rid=rid, tokens=t, n_steps=8,
                                routing_override=mixed), 0.0)
                    for rid, t in enumerate(prompts)]
        runs[fault] = guarded_drain(eng, sched, arrivals,
                                    cancel_tick=10 ** 9, fault=fault)
    (out, _, target, rows), (clean, _, ctarget, crows) = \
        runs[True], runs[False]
    assert target is not None and target == ctarget, (target, ctarget)
    tick, rid, sibs = target
    assert out[rid].status == "failed", out[rid].status
    assert torch.equal(rows, crows), "a sibling's logits moved"
    for s in sibs:
        assert out[s].status == clean[s].status == "ok", s
        assert np.array_equal(out[s].tokens, clean[s].tokens), s
    return (f"fault drain: tick {tick} rid {rid} failed, siblings {sibs} "
            f"bitwise equal (logits and tokens) to the drain without the "
            f"fault")


def moe_path_parity(dev, cfg=None):
    """Phase 15: granite at full width, 2 layers, fp32, the same weights
    on the card and on the CPU: ``generate`` (router-driven and mixed),
    a slot-pool drain as in phase 5b, one chunk's ``moe_apply`` with
    drops, and a faulted drain on the card. Returns its report lines.
    Phase 17 passes deepseek's narrowed ``cfg``: ``generate`` and the
    drain only.

    A token whose k-th and (k+1)-th gate probabilities lie within
    rounding can choose another expert on each device, so the prompt
    seed of ``generate`` is the first whose smallest top-k gap on the
    card, over every token and layer of both runs, exceeds MOE_GAP, and
    whose router margins exceed 1e-3; every MoE call must then choose
    the same experts on both devices."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import routing_pattern
    from repro_torch.models import model as MD
    from repro_torch.serve.engine import ServeEngine, chunk_plan
    extras = cfg is None
    cfg = cfg or get_config(GRANITE).replace(
        num_layers=2, dtype=torch.float32, param_dtype=torch.float32)
    params = MD.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    S, N = 2304, 8
    engines = {name: ServeEngine(params, cfg, max_len=S + N,
                                 prefill_chunk=CHUNK, device=d)
               for name, d in (("card", dev), ("cpu", "cpu"))}
    overrides = (None, routing_pattern(cfg, "mixed"))
    tried = []
    for seed in range(MOE_SEEDS):
        toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                    (1, S))
        pf = MD.prefill(engines["card"].params, cfg,
                        torch.as_tensor(toks[:, :CHUNK], device=dev),
                        routing_ctx="hard_prefix", want_cache=False)
        margin = float(np.abs(pf.p_fa.numpy() - 0.5).min())
        if margin <= 1e-3:
            continue
        recs = {}
        for ov in overrides:
            with MoeRecorder() as recs[ov]:
                engines["card"].generate(toks, N, routing_override=ov)
        gap = min(r.min_gap() for r in recs.values())
        tried.append(f"{seed}:{gap:.1e}")
        if gap > MOE_GAP:
            break
    else:
        raise AssertionError(f"no prompt seed with router margins > 1e-3 "
                             f"and a top-k gap > {MOE_GAP}: {tried}")
    out = [f"prompt_seed={seed} router_min_margin={margin:.2e} "
           f"min_topk_gap={gap:.2e} (seeds tried, seed:gap: "
           f"{' '.join(tried)}); tokens with a gap below 1e-5: "
           + ", ".join(f"{'router' if ov is None else 'mixed'} "
                       f"{r.below(1e-5)} of {sum(g.numel() for g in r.gaps)}"
                       for ov, r in recs.items())]
    for ov in overrides:
        res, rec = {}, {}
        for d, e in engines.items():
            with MoeRecorder() as rec[d]:
                res[d] = e.generate(toks, N, routing_override=ov)
        g, c = res["card"], res["cpu"]
        err = float((g.logits.cpu() - c.logits).abs().max())
        calls = rec["card"].calls
        # each layer's MoE once a chunk and once a decode step
        assert len(calls) == len(rec["cpu"].calls) == cfg.num_layers * (
            len(chunk_plan(S, CHUNK)) + N), len(calls)
        same = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                   for a, b in zip(calls, rec["cpu"].calls))
        assert same, "an MoE call chose other experts on the two devices"
        # how far rounding moved a token's top-k gap between the devices:
        # what MOE_GAP must stay well above
        gap_diff = max(float((a - b).abs().max())
                       for a, b in zip(rec["card"].gaps, rec["cpu"].gaps))
        assert g.routing == c.routing, (g.routing, c.routing)
        assert np.array_equal(g.tokens, c.tokens), (g.tokens, c.tokens)
        assert err < 2e-3, err  # fp32 both; summation order only
        if ov is None:
            out.append(f"p_fa={np.round(c.p_fa, 5).tolist()}")
        out.append(f"{'router' if ov is None else 'mixed'} routing="
                   f"{''.join(p[0] for p in g.routing)} logits_err={err:.2e}"
                   f" moe_calls={len(calls)} experts_equal=True "
                   f"topk_gap_max_diff_card_cpu={gap_diff:.2e} "
                   f"tokens={g.tokens[0].tolist()}")
    with MoeRecorder() as rec:
        out.append("drain " + pool_parity(dev, cfg=cfg))
    out.append(f"drain (both devices) min_topk_gap={rec.min_gap():.2e}, "
               f"gaps below "
               f"1e-5 / 1e-6 / 1e-7: {rec.below(1e-5)} / {rec.below(1e-6)}"
               f" / {rec.below(1e-7)} of "
               f"{sum(g.numel() for g in rec.gaps)}")
    if not extras:
        return out
    line, _ = moe_chunk_parity(dev, params, cfg)
    out.append(line)
    rng = np.random.default_rng(seed)
    out.append(moe_fault_drain(dev, params, cfg, [
        rng.integers(0, cfg.vocab_size, n) for n in (1000, 700, 1536, 600)]))
    return out


def moe_sampling(dev, params, cfg):
    """Phase 16's sampled ``generate``: one 4096-token prompt, GEN tokens;
    ``rng=None`` equals greedy, one seed gives the same tokens twice (an
    int seed and a generator seeded alike), another seed others."""
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(params, cfg, max_len=PROMPT + GEN, prefill_chunk=CHUNK,
                      device=dev)
    from repro_torch.models import moe as MOE
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, PROMPT))
    # the host's time inside the MoE's calls of the decode steps (one
    # token a row): the decode is host-bound, so this is the share of
    # its wall the MoE's small operators add
    ffn, host = MOE.moe_ffn, []

    def timed(params_, cfg_, x, *a, **kw):
        t = time.perf_counter()
        out = ffn(params_, cfg_, x, *a, **kw)
        if x.shape[1] == 1:
            host.append(time.perf_counter() - t)
        return out
    MOE.moe_ffn = timed
    try:
        greedy = eng.generate(toks, GEN)
    finally:
        MOE.moe_ffn = ffn
    moe_host = sum(host)
    assert len(host) == GEN * cfg.num_layers, len(host)
    runs = {"none": eng.generate(toks, GEN, greedy=False),
            "seed0": eng.generate(toks, GEN, greedy=False, rng=0),
            "gen0": eng.generate(
                toks, GEN, greedy=False,
                rng=torch.Generator(device=dev).manual_seed(0)),
            "seed1": eng.generate(toks, GEN, greedy=False, rng=1)}
    for r in (greedy, *runs.values()):
        assert bool(torch.isfinite(r.final_logits).all())
    assert np.array_equal(runs["none"].tokens, greedy.tokens)
    assert np.array_equal(runs["seed0"].tokens, runs["gen0"].tokens)
    assert not np.array_equal(runs["seed0"].tokens, runs["seed1"].tokens)
    return (f"sampling: rng=None equals greedy; seed 0 twice equal, seed 1 "
            f"differs; greedy={greedy.tokens[0, :8].tolist()} seed0="
            f"{runs['seed0'].tokens[0, :8].tolist()} seed1="
            f"{runs['seed1'].tokens[0, :8].tolist()} decode_s greedy "
            f"{greedy.decode_s:.3f} sampled {runs['seed0'].decode_s:.3f}; "
            f"the greedy decode's MoE host time {moe_host:.3f} s of its "
            f"{greedy.decode_s:.3f} s wall ({moe_host / greedy.decode_s:.3f})"
            f" over {len(host)} calls")


def mla_prefix_hit(dev, params, cfg):
    """Phase 18's prefix path: one 4096-token prompt through the batch
    frontend twice on an engine with a device store, mixed routing. The
    second is a full-cover hit: tokens and first logits bitwise equal to
    the cold run's, and no flash or streaming launch (the latent decode
    alone). Returns its report line."""
    import repro_torch.kernels as KN
    from repro_torch.launch.serve import routing_pattern
    from repro_torch.serve.engine import ServeEngine
    mixed = routing_pattern(cfg, "mixed")
    eng = ServeEngine(params, cfg, max_len=PROMPT + GEN, prefill_chunk=CHUNK,
                      prefix_cache_mb=1024, device=dev)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (1, PROMPT))
    cold = eng.generate(toks, GEN, routing_override=mixed)
    KN.reset_launch_counts()
    warm = eng.generate(toks, GEN, routing_override=mixed)
    counts = KN.launch_counts()
    want = dict(flash_attention=0, streaming_attention=0,
                block_sparse_attention=0,
                **decode_launches(cfg, GEN, pooled=False))
    assert counts == want, (counts, want)
    assert warm.prefix_hit_tokens == PROMPT, warm.prefix_hit_tokens
    assert np.array_equal(warm.tokens, cold.tokens), "warm tokens"
    assert torch.equal(warm.logits, cold.logits), "warm first logits"
    s = eng.prefix_store.stats()
    return (f"prefix: a {PROMPT}-token full-cover hit, tokens and first "
            f"logits bitwise equal to cold; prefill_s warm "
            f"{warm.prefill_s:.4f} cold {cold.prefill_s:.4f}; launches "
            f"{counts}; store inserts={s.inserts} hits={s.hits} "
            f"device_bytes={eng.prefix_store.device_bytes}")


# ---------------------------------------------------------------------------
# The paper's comparison set: the xa and ta SA modes and the DuoAttention
# head split (phases 3, 4, 19 and 20)
# ---------------------------------------------------------------------------

TA_PROMPT = 18432  # ta at the published chunk of 16384: boundary 2048
PARITY_TA_CHUNK = 2048  # phase 19's ta chunk: boundary 2048 of 3072
DUO_HEADS = 16  # full-attention KV heads of a duo layer (of phi3's 32)
# the smallest gap, on the card, between a (head, query block)'s keep-th
# and (keep+1)-th finite xa score that a phase-19 seed may show: card and
# CPU scores (≈ 5 in size, 2 layers in fp32) differ by rounding, up to
# a few 1e-5 (phase 19 prints the largest, score_diff), so a closer pair
# could pick another block on the CPU
XA_GAP = 1e-4
XA_SEEDS = 256
# phase 19's xa drain: (prompt length, routing: None = the router's,
# "mixed"); xa keeps 3 blocks of the long prompts and only the two forced
# ones of the short (keep = max(2, ceil(0.1 nkb))), so that two prompts,
# not four, must clear XA_GAP
XA_DRAIN = ((3072, None), (1536, None), (2816, "mixed"), (1024, "mixed"))
# phase 19's generate prompt: 24 blocks of 128, so xa keeps 3 (one past
# the two forced), and ta's chunk boundary at 2048 of it
SA_PARITY_PROMPT = 3072
PLAIN_ROWS = 4  # query rows a plain call takes at once at the long shapes


# phase 4's rows of the xa and ta calls: the kernel each times, and the
# phase-20 path whose launches the JSON line gives beside it
SA_ROWS = {"xa": ("block_sparse_attention", "xa_batch"),
           "xa_stablelm_12b": ("block_sparse_attention", None),
           "xa_deepseek_v2_236b": ("block_sparse_attention",
                                   "deepseek_xa_batch"),
           "ta_streaming": ("streaming_attention", "ta"),
           "ta_flash": ("flash_attention", "ta")}


def sa_cfg(cfg, sa_mode, **flux):
    """``cfg`` with another SA mode (and flux fields)."""
    return cfg.replace(flux=cfg.flux.replace(sa_mode=sa_mode, **flux))


def duo_pattern(n_layers):
    """Phase 19's and 20's duo override: ("duo", DUO_HEADS) on the even
    layers, "sa" and "fa" in turn on the odd ones."""
    return tuple(("duo", DUO_HEADS) if i % 2 == 0
                 else ("sa" if i % 4 == 1 else "fa") for i in range(n_layers))


def pattern_text(pattern):
    """A routing pattern as one letter a layer (f, s; d for a duo split)."""
    return "".join(p[0] for p in pattern)


def rows_plain(fn, q, k, v, *rows_args, rows=PLAIN_ROWS, **kw):
    """A plain version ``fn`` over ``rows`` query rows at a time (with
    their KV rows and the matching rows of ``rows_args``), concatenated:
    the same result in pieces whose dense scores fit the card."""
    G = q.shape[0] // k.shape[0]
    rows = max(rows, G)
    out = []
    for a in range(0, q.shape[0], rows):
        b = min(a + rows, q.shape[0])
        out.append(fn(q[a:b], k[a // G:b // G], v[a // G:b // G],
                      *(x[a:b] for x in rows_args), **kw))
    return torch.cat(out)


def gqa_sdpa(q, k, v, mask, backend=None):
    """The library yardstick: scaled_dot_product_attention of flattened
    (BH, S, D) q over (BHkv, S, D) k / v under a boolean mask (Sq, Skv)
    or (BH, Sq, Skv), with k / v expanded to the query heads (a view),
    on ``backend`` when one is named."""
    from torch.nn.attention import sdpa_kernel
    G = q.shape[0] // k.shape[0]
    q4 = q.view(k.shape[0], G, *q.shape[1:]).transpose(0, 1)
    k4, v4 = (x[None].expand(G, *x.shape) for x in (k, v))
    if mask.dim() == 3:
        mask = mask.view(k.shape[0], G, *mask.shape[1:]).transpose(0, 1)
    F = torch.nn.functional
    if backend is None:
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)
    with sdpa_kernel(backend):
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)


def xa_case(dev, arch=ARCH, B=REQUESTS):
    """Block-sparse at a real xa selection: B prompts of PROMPT tokens at
    ``arch``'s widths (deepseek-v2's route chunk at (Dk, Dv) = (192, 128)
    over its 128 heads, G = 1), random bf16 q / k / v, the selection
    built on the card by ``xa_selection`` at the published block 128,
    stride 16 and threshold 0.9 (4 of 32 blocks a query block) and
    expanded to the kernel's tiles. Returns a dict of calls (kernel,
    plain, plain with one V tile zeroed, SDPA's efficient backend under
    the equivalent boolean mask, the antidiagonal scoring and top-k) and
    the work (bytes, operations over the selected pairs)."""
    from torch.nn.attention import SDPBackend
    from repro_torch.configs import get_config
    from repro_torch.core import modes as M
    from repro_torch.kernels import ref
    from repro_torch.kernels.block_sparse_attention import (
        KERNEL_BLOCK, block_sparse_attention_bh)
    cfg = get_config(arch)
    mode = M.xa_mode(cfg.flux)
    if cfg.use_mla:
        Hq = Hkv = cfg.num_heads
        D, Dv = MLA_DK, MLA_DV
    else:
        Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        Dv = D
    S = PROMPT
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn(B, Hq, S, D, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(B, Hkv, S, D, generator=g, device=dev).to(
        torch.bfloat16)
    v = torch.randn(B, Hkv, S, Dv, generator=g, device=dev).to(
        torch.bfloat16)
    scale = D ** -0.5
    tiles, mask, keep = xa_tiles(q, k, mode)
    qf, kf = (x.reshape(-1, S, D) for x in (q, k))
    vf = v.reshape(-1, S, Dv)
    pairs = int(mask.sum())
    it = 2
    dims = f"D={D}" if Dv == D else f"(Dk, Dv)=({D}, {Dv})"
    return dict(
        label=f"block_sparse xa {arch} {dims} G={Hq // Hkv} "
              f"{B}x{S} block={mode.block} stride={mode.stride} "
              f"threshold={mode.threshold} keep={keep} of "
              f"{-(-S // mode.block)}",
        kern=lambda **kw: block_sparse_attention_bh(qf, kf, vf, tiles, **kw),
        plain=lambda: rows_plain(ref.block_sparse_attention_ref, qf, kf, vf,
                                 tiles, block=KERNEL_BLOCK, rows=32),
        mutant=lambda: rows_plain(ref.block_sparse_attention_ref, qf, kf,
                                  zero_tile(vf), tiles, block=KERNEL_BLOCK,
                                  rows=32),
        lib=lambda: gqa_sdpa(qf, kf, vf, mask,
                             SDPBackend.EFFICIENT_ATTENTION),
        score=lambda: M.xa_selection(q, k, mode, q_offset=0, scale=scale),
        work=(it * (B * Hq * S * (D + Dv) + B * Hkv * S * (D + Dv)),
              2 * (D + Dv) * pairs),
        keep=keep, blocks=-(-S // mode.block), pairs=pairs)


def ta_cases(dev):
    """The ta split's two calls at phi3-mini's widths (D = 96): the
    streaming kernel over query rows [0, b) and flash over rows [b, Skv)
    at q_offset b, both over all Skv keys; b = 100 of 300 keys (G = 4,
    sink 16, local 48: an unaligned boundary) and b = 2048 of TA_PROMPT
    (one prompt of 32 heads, the published sink 128 and local 2048: ta at
    chunk 16384). The yardstick is SDPA's efficient backend under the
    equivalent boolean mask. Returns [dict(label, kernel, size, kern,
    plain, mutant, lib, work)]."""
    from torch.nn.attention import SDPBackend
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bh
    from repro_torch.kernels.streaming_attention import \
        streaming_attention_bh
    cfg = get_config(ARCH)
    g = torch.Generator(device=dev).manual_seed(6)
    out = []
    for size, BH, BHkv, Skv, sink, local, rows in (
            ("small", 8, 2, 300, 16, 48, 8),
            ("main", cfg.num_heads, cfg.num_kv_heads, TA_PROMPT,
             cfg.flux.sink, cfg.flux.local, PLAIN_ROWS)):
        D = cfg.head_dim
        b = 100 if size == "small" else TA_PROMPT - cfg.flux.chunk
        q = torch.randn(BH, Skv, D, generator=g, device=dev).to(
            torch.bfloat16)
        k, v = (torch.randn(BHkv, Skv, D, generator=g, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        q_pre, q_last = q[:, :b].contiguous(), q[:, b:].contiguous()
        kp = torch.arange(Skv, device=dev)
        qp_pre, qp_last = kp[:b], kp[b:]
        smask = (kp[None] <= qp_pre[:, None]) & (
            (kp[None] < sink) | (qp_pre[:, None] - kp[None] < local))
        fmask = kp[None] <= qp_last[:, None]
        skw = dict(sink=sink, local=local)
        fkw = dict(causal=True, q_offset=b)
        tag = f"Skv={Skv} boundary={b} BH={BH} G={BH // BHkv} D={D}"
        out.append(dict(
            label=f"ta streaming rows [0, {b}) {tag} sink={sink} "
                  f"local={local}",
            kernel="streaming_attention", size=size,
            kern=lambda q=q_pre, k=k, v=v, kw=skw, **o:
                streaming_attention_bh(q, k, v, **kw, **o),
            plain=lambda q=q_pre, k=k, v=v, kw=skw, r=rows: rows_plain(
                ref.streaming_attention_ref, q, k, v, rows=r, **kw),
            mutant=lambda q=q_pre, k=k, v=v, kw=skw, r=rows: rows_plain(
                ref.streaming_attention_ref, q, k, zero_tile(v), rows=r,
                **kw),
            lib=lambda q=q_pre, k=k, v=v, m=smask: gqa_sdpa(
                q, k, v, m, SDPBackend.EFFICIENT_ATTENTION),
            work=attn_work(BH, BHkv, b, D, b,
                           BH * streaming_pairs(range(b), sink, local), 2)))
        out.append(dict(
            label=f"ta flash rows [{b}, {Skv}) at q_offset={b} {tag}",
            kernel="flash_attention", size=size,
            kern=lambda q=q_last, k=k, v=v, kw=fkw, **o:
                flash_attention_bh(q, k, v, **kw, **o),
            plain=lambda q=q_last, k=k, v=v, kw=fkw, r=rows: rows_plain(
                ref.flash_attention_ref, q, k, v, rows=r, **kw),
            mutant=lambda q=q_last, k=k, v=v, kw=fkw, r=rows: rows_plain(
                ref.flash_attention_ref, q, k, zero_tile(v), rows=r, **kw),
            lib=lambda q=q_last, k=k, v=v, m=fmask: gqa_sdpa(
                q, k, v, m, SDPBackend.EFFICIENT_ATTENTION),
            work=attn_work(BH, BHkv, Skv - b, D, Skv,
                           BH * int((qp_last + 1).sum()), 2)))
    return out


def sa_mode_cases(dev):
    """[(key, case)]: the xa case at phi3-mini's and stablelm's widths
    and the ta split's calls, small ("_small") and main."""
    yield "xa", xa_case(dev, ARCH)
    yield "xa_stablelm_12b", xa_case(dev, STABLELM)
    yield "xa_deepseek_v2_236b", xa_case(dev, DEEPSEEK, B=1)
    for c in ta_cases(dev):
        yield (f"ta_{c['kernel'].split('_')[0]}"
               f"{'_small' if c['size'] == 'small' else ''}"), c


def sa_mode_checks(dev):
    """Phase 3's checks of the xa and ta calls: each under the bf16
    limit against its plain version, with one zeroed V tile above it;
    and a CUDA-tensor xa call at block 16 (not a multiple of the kernel's
    64-token tile) must raise. Returns {key: max abs error}."""
    from repro_torch.core import modes as M
    errs = {}
    for key, c in sa_mode_cases(dev):
        out, want = c["kern"](), c["plain"]()
        errs[key] = e = max_err(out, want)
        r, r_mut = bf16_ratios(out, want), bf16_ratios(c["mutant"](), want)
        assert max(r) < 1, f"{c['label']}: error {r} of the limit"
        assert min(r_mut) > 1, f"{c['label']}: a zeroed tile is within " \
            f"the limit {r_mut}"
        say(3, f"{c['label']} bfloat16 max_abs_err={e:.3e} "
               f"limit_ratio={ratio_text(r)} "
               f"zeroed_tile_ratio={ratio_text(r_mut)}")
        del out, want, c
        free_card()
    q = torch.randn(1, 4, 96, 64, device=dev)
    try:
        M.attention(q, q, q, M.AttnMode("block_topk", block=16, stride=4,
                                        threshold=0.5))
    except ValueError as err:
        say(3, f"xa at block 16 on cuda raises ValueError: {err}")
    else:
        raise AssertionError("xa at block 16 ran on cuda: a fallback")
    return errs


def sa_mode_times(dev):
    """Phase 4's rows of the xa and ta calls (main shapes): device ms,
    call ms, plain ms, the SDPA yardstick and the bound; the xa rows also
    time the plain-torch antidiagonal scoring and top-k that choose the
    selection. Returns {"xa": row, "xa_stablelm_12b": row, "ta_streaming":
    row, "ta_flash": row}."""
    rows = {}
    for key, c in sa_mode_cases(dev):
        if key.endswith("_small"):
            continue
        b_ms, b_by = bound(*c["work"])
        r = rows[key] = dict(
            ms=time_ms(c["kern"]), call_ms=call_ms(c["kern"]),
            plain_ms=time_ms(c["plain"], reps=1, rounds=3, warmup=1),
            library_ms=time_ms(c["lib"], reps=3, rounds=3),
            bound_ms=b_ms, bound_by=b_by)
        extra = ""
        if "score" in c:
            r.update(scoring_ms=time_ms(c["score"]), keep=c["keep"],
                     blocks=c["blocks"])
            extra = f" scoring_ms={r['scoring_ms']:.4f} (plain torch)"
        say(4, f"{c['label']} ms={r['ms']:.4f} call_ms={r['call_ms']:.4f} "
               f"plain_ms={r['plain_ms']:.4f} library_ms="
               f"{r['library_ms']:.4f} bound_ms={b_ms:.4f} ({b_by}; "
               f"{c['work'][0]} bytes, {c['work'][1]} flops) "
               f"roofline_share={b_ms / r['ms']:.3f}{extra}")
        del c
        free_card()
    return rows


class XaRecorder:
    """While active, records every xa selection the port makes and its
    scores (on the host), and the smallest gap, per call, between a
    (head, query block)'s keep-th and (keep+1)-th score where both are
    finite: a near tie there could pick another block on another
    device."""

    def __init__(self):
        self.sels, self.scores, self.gaps = [], [], []

    def __enter__(self):
        from repro_torch.core import modes as M
        self._mod, orig = M, M.xa_selection

        def recorded(q, k, mode, **kw):
            sel = orig(q, k, mode, **kw)
            scores, keep = M.xa_scores(q, k, mode, **kw)
            top = torch.sort(scores, dim=-1, descending=True).values
            if keep < top.shape[-1]:
                a, b = top[..., keep - 1], top[..., keep]
                live = (a.abs() < 1e29) & (b.abs() < 1e29)
                if bool(live.any()):
                    self.gaps.append(float((a - b)[live].min()))
            self.sels.append(sel.cpu())
            self.scores.append(scores.cpu())
            return sel
        self._orig = orig
        M.xa_selection = recorded
        return self

    def __exit__(self, *exc):
        self._mod.xa_selection = self._orig

    def min_gap(self):
        return min(self.gaps, default=float("inf"))


def score_diff(a, b):
    """The largest |difference| between two recorders' finite xa scores
    (the masked -1e30 and forced +inf entries are equal by construction)."""
    out = 0.0
    for x, y in zip(a.scores, b.scores):
        live = x.abs() < 1e29
        out = max(out, float((x - y)[live].abs().max()))
    return out


def xa_seed(engine, specs):
    """The first prompt seed (of XA_SEEDS) whose prompts, one of each
    (length, overrides) of ``specs``, keep on the card under each of
    their overrides every router margin above 1e-3 and every xa score gap
    at the keep-th place above XA_GAP. Returns (seed, prompts, smallest
    gap)."""
    from repro_torch.models import model as MD
    cfg = engine.cfg
    for seed in range(XA_SEEDS):
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(0, cfg.vocab_size, n) for n, _ in specs]
        ok, gaps = True, []
        for toks, (_, overrides) in zip(prompts, specs):
            t = torch.as_tensor(toks[None], device=engine.device)
            for ov in overrides:
                ctx, fixed = engine._routing_ctx(ov)
                with XaRecorder() as rec:
                    pf = MD.prefill(engine.params, cfg, t, routing_ctx=ctx,
                                    fixed_pattern=fixed, want_cache=False)
                if ov is None:
                    ok &= float(np.abs(pf.p_fa.numpy() - 0.5).min()) > 1e-3
                gaps.append(rec.min_gap())
        if ok and min(gaps) > XA_GAP:
            return seed, prompts, min(gaps)
    raise AssertionError(f"no prompt seed of {XA_SEEDS} with router margins "
                         f"> 1e-3 and xa gaps > {XA_GAP}")


def sa_mode_parity(dev):
    """Phase 19: phi3-mini at full width, 2 layers, fp32, the same weights
    on the card and on the CPU: ``generate`` of a SA_PARITY_PROMPT-token
    prompt under
    xa (published block 128, stride 16, threshold 0.9) and ta (chunk
    PARITY_TA_CHUNK), router-driven and mixed, and a duo override under
    ssa; ``prefill(routing_ctx="head_split", head_split_n=DUO_HEADS)``;
    and a slot-pool drain under xa. Routing, every xa selection and the
    tokens identical, first logits within 2e-3. Returns report lines."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (PREFILL_CHUNKS_PER_TICK,
                                          routing_pattern)
    from repro_torch.models import model as MD
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.scheduler import STATUS_OK, ContinuousScheduler
    base = get_config(ARCH).replace(num_layers=2, dtype=torch.float32,
                                    param_dtype=torch.float32)
    params = MD.init_params(base, torch.Generator().manual_seed(0), "cpu")
    N = 8
    mixed = routing_pattern(base, "mixed")
    cfgs = {"xa": sa_cfg(base, "xa"),
            "ta": sa_cfg(base, "ta", chunk=PARITY_TA_CHUNK), "ssa": base}
    max_len = max(SA_PARITY_PROMPT, *(n for n, _ in XA_DRAIN)) + N
    devices = (("card", dev), ("cpu", torch.device("cpu")))
    eng = {(m, name): ServeEngine(params, c, max_len=max_len,
                                  prefill_chunk=CHUNK, device=d)
           for m, c in cfgs.items() for name, d in devices}
    seed, prompts, gap = xa_seed(eng["xa", "card"],
                                 [(SA_PARITY_PROMPT, (None, mixed))])
    toks = prompts[0][None]
    lines = [f"prompt_seed={seed} xa_min_gap={gap:.3e} (XA_GAP {XA_GAP:g})"]
    for mode, ov in (("xa", None), ("xa", mixed), ("ta", None),
                     ("ta", mixed), ("ssa", duo_pattern(2))):
        res, recs = {}, {}
        for d in ("card", "cpu"):
            assert not eng[mode, d].chunked_eligible(SA_PARITY_PROMPT, ov)
            with XaRecorder() as recs[d]:
                res[d] = eng[mode, d].generate(toks, N, routing_override=ov)
        sels = {d: r.sels for d, r in recs.items()}
        g, c = res["card"], res["cpu"]
        err = float((g.logits.cpu() - c.logits).abs().max())
        assert g.routing == c.routing, (mode, g.routing, c.routing)
        assert np.array_equal(g.tokens, c.tokens), (mode, g.tokens, c.tokens)
        assert err < 2e-3, (mode, err)
        n_sa = sum(p == "sa" for p in g.routing)
        assert len(sels["card"]) == len(sels["cpu"]) == (
            n_sa if mode == "xa" else 0)
        assert all(torch.equal(a, b) for a, b in zip(sels["card"],
                                                     sels["cpu"])), mode
        name = "router" if ov is None else "duo" if mode == "ssa" else \
            "mixed"
        lines.append(
            f"{mode} {name}: routing={pattern_text(g.routing)} "
            f"selections={len(sels['card'])} equal"
            + (f" score_diff={score_diff(recs['card'], recs['cpu']):.2e}"
               if sels["card"] else "")
            + f" logits_err={err:.2e} tokens={g.tokens[0].tolist()}")
    lg = {}
    for d in ("card", "cpu"):
        e = eng["ssa", d]
        lg[d] = MD.prefill(e.params, base, torch.as_tensor(toks,
                                                           device=e.device),
                           routing_ctx="head_split", head_split_n=DUO_HEADS,
                           want_cache=False).logits.cpu()
    err = float((lg["card"] - lg["cpu"]).abs().max())
    assert err < 2e-3 and torch.equal(lg["card"].argmax(-1),
                                      lg["cpu"].argmax(-1)), err
    lines.append(f"prefill head_split n={DUO_HEADS}: logits_err={err:.2e}")
    # the slot-pool drain of phase 5b under xa
    overrides = [mixed if ov else None for _, ov in XA_DRAIN]
    seed, prompts, gap = xa_seed(eng["xa", "card"],
                                 [(n, (ov,)) for (n, _), ov in
                                  zip(XA_DRAIN, overrides)])
    res = {}
    for d in ("card", "cpu"):
        e = eng["xa", d]
        sched = ContinuousScheduler(
            e, slots_per_bucket=2, chunk=4,
            prefill_chunks_per_tick=PREFILL_CHUNKS_PER_TICK)
        with XaRecorder() as rec:
            for rid, p in enumerate(prompts):
                e.submit(Request(rid=rid, tokens=p, n_steps=N,
                                 routing_override=overrides[rid]))
            res[d] = (e.drain(), sched, rec)
    (g, gs, grec), (c, cs, crec) = res["card"], res["cpu"]
    gsel, csel = grec.sels, crec.sels
    for rid in range(len(prompts)):
        assert g[rid].status == c[rid].status == STATUS_OK, rid
        assert g[rid].routing == c[rid].routing, rid
        assert np.array_equal(g[rid].tokens, c[rid].tokens), rid
    assert gs.n_geometries() == cs.n_geometries()
    assert len(gsel) == len(csel) and all(
        torch.equal(a, b) for a, b in zip(gsel, csel))
    lines.append(
        f"xa drain: prompt_seed={seed} xa_min_gap={gap:.3e} lens="
        f"{[n for n, _ in XA_DRAIN]} geometries={gs.n_geometries()} "
        f"selections={len(gsel)} equal "
        f"score_diff={score_diff(grec, crec):.2e} routing="
        + ",".join("".join(p[0] for p in g[r].routing)
                   for r in range(len(prompts)))
        + f" tokens0={g[0].tokens.tolist()}")
    return lines


def sa_batch(eng, prompts, override):
    """One bucket of GEN new tokens a prompt through
    ``serve_batch_finished``: its GenerationResult and each kernel's
    launches in it; every logit finite."""
    import repro_torch.kernels as KN
    from repro_torch.serve.engine import Request, serve_batch_finished
    before = KN.launch_counts()
    done = serve_batch_finished(eng, [
        Request(rid=i, tokens=p, n_steps=GEN, routing_override=override)
        for i, p in enumerate(prompts)])
    gen = done[0].result
    assert all(len(done[i].tokens) == GEN for i in range(len(prompts)))
    assert bool(torch.isfinite(gen.logits).all()), "first logits"
    assert bool(torch.isfinite(gen.final_logits).all()), "last logits"
    return gen, {k: v - before[k] for k, v in KN.launch_counts().items()}


def gen_text(gen, rows, prompt):
    return (f"prefill_s={gen.prefill_s:.3f} "
            f"prefill_tok_s={rows * prompt / gen.prefill_s:.0f} "
            f"decode_s={gen.decode_s:.3f} "
            f"decode_tok_s={rows * gen.tokens.shape[1] / gen.decode_s:.1f} "
            f"kv_bytes={gen.kv_bytes}")


def sa_mode_paths(dev, params, cfg):
    """Phase 20: phi3-mini at full width (SA_MODES_LAYERS deep), bf16: the
    batch path of phase 6 under xa (router-driven and mixed), ta on one
    TA_PROMPT
    prompt (mixed), the duo override through ``generate``, and the
    continuous path of phase 7 under xa; ssa at the same prompts beside
    each for prefill tok/s. Every logit finite; exact launch counts:
    block-sparse once per SA layer an xa admission, flash once per FA
    layer and once more per SA layer under ta, streaming once per SA
    layer under ta and never under xa, the batch decode kernel never at a
    duo layer. Returns ({path: launch counts}, lines)."""
    import repro_torch.kernels as KN
    from repro_torch.launch.serve import routing_pattern
    from repro_torch.serve.engine import ServeEngine
    L = cfg.num_layers
    mixed = routing_pattern(cfg, "mixed")
    counts, lines = {}, []
    zero = {k: 0 for k in KN.KERNELS}

    def want(**kw):
        return {**zero, "decode_attention": GEN * L, **kw}

    xa = sa_cfg(cfg, "xa")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                (REQUESTS, PROMPT))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    KN.reset_launch_counts()
    eng = ServeEngine(params, xa, max_len=PROMPT + GEN, prefill_chunk=CHUNK,
                      device=dev)
    for name in ("router", "mixed"):
        ov = routing_pattern(cfg, name)
        assert not eng.chunked_eligible(PROMPT, ov)
        gen, delta = sa_batch(eng, prompts, ov)
        n_sa = sum(p == "sa" for p in gen.routing)
        assert n_sa, f"xa {name}: no SA layer"
        assert delta == want(flash_attention=L - n_sa,
                             block_sparse_attention=n_sa), (name, delta)
        lines.append(f"xa batch {name}: routing="
                     f"{pattern_text(gen.routing)} "
                     f"{gen_text(gen, REQUESTS, PROMPT)} launches={delta} "
                     f"tokens0={gen.tokens[0, :8].tolist()}")
    counts["xa_batch"] = KN.launch_counts()
    ssa = ServeEngine(params, cfg, max_len=PROMPT + GEN, prefill_chunk=CHUNK,
                      device=dev)
    gen, _ = sa_batch(ssa, prompts, mixed)
    lines.append(f"ssa batch mixed (chunked) at the same prompts: "
                 f"{gen_text(gen, REQUESTS, PROMPT)}")
    gen, delta = sa_batch(ssa, prompts, duo_pattern(L))
    n_duo = sum(isinstance(p, tuple) for p in gen.routing)
    n_sa = sum(p == "sa" for p in gen.routing)
    assert not ssa.chunked_eligible(PROMPT, duo_pattern(L))
    assert delta == {**zero, "flash_attention": L - n_sa,
                     "streaming_attention": n_sa,
                     "decode_attention": GEN * (L - n_duo)}, delta
    counts["duo"] = delta
    lines.append(f"duo batch ({n_duo} duo layers of {DUO_HEADS} FA KV heads, "
                 f"{L - n_duo - n_sa} fa, {n_sa} sa): "
                 f"{gen_text(gen, REQUESTS, PROMPT)} launches={delta} "
                 f"tokens0={gen.tokens[0, :8].tolist()} peak_mem_bytes="
                 f"{torch.cuda.max_memory_allocated(dev)}")
    del eng, ssa
    free_card()

    ta = sa_cfg(cfg, "ta")
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                             (1, TA_PROMPT))
    torch.cuda.reset_peak_memory_stats(dev)
    for name, c in (("ta", ta), ("ssa", cfg)):
        e = ServeEngine(params, c, max_len=TA_PROMPT + GEN,
                        prefill_chunk=CHUNK, device=dev)
        gen, delta = sa_batch(e, toks, mixed)
        n_sa = sum(p == "sa" for p in gen.routing)
        if name == "ta":
            assert not e.chunked_eligible(TA_PROMPT, mixed)
            assert TA_PROMPT > ta.flux.chunk
            assert delta == want(flash_attention=L,
                                 streaming_attention=n_sa), delta
            counts["ta"] = delta
        lines.append(f"{name} mixed one prompt of {TA_PROMPT} tokens"
                     f"{' (chunked)' if name == 'ssa' else ''}: "
                     f"{gen_text(gen, 1, TA_PROMPT)} launches={delta} "
                     f"peak_mem_bytes={torch.cuda.max_memory_allocated(dev)}")
        del e
        free_card()

    counts["xa_continuous"], cont = continuous_path(dev, params, xa)
    lines += [f"xa continuous {line}" for line in cont]
    return counts, lines


# ---------------------------------------------------------------------------
# Modality side inputs (phases 2b, 3, 4, 21-23): phi-3-vision's prefix
# embeddings and whisper-tiny's encoder and cross attention
# ---------------------------------------------------------------------------

PHI3V = "phi-3-vision-4.2b"  # 576 prefix embeddings: phases 21-22
WHISPER = "whisper-tiny"  # 4 encoder + 4 decoder layers: phases 21, 23
PHI3V_PROMPT = PROMPT - 576  # text tokens after the 576 image embeddings
WHISPER_REQUESTS, WHISPER_PROMPT = 4, 384
# whisper's decoder context (arXiv:2212.04356): 384 + GEN positions fit
WHISPER_MAX_LEN = 448
# phase 21: positions a prompt holds (prefix included), past sink + local
SIDE_PARITY_LEN, SIDE_PARITY_GEN = 2304, 8


def side_inputs(cfg, rows, seed):
    """A request's side input, made with numpy from ``seed``: prefix
    embeddings (rows, P, d) of a VLM or encoder frames (rows, E, d)."""
    rng = np.random.default_rng(seed)
    if cfg.num_prefix_tokens:
        shape, key = (rows, cfg.num_prefix_tokens, cfg.d_model), \
            "prefix_embeddings"
    else:
        shape, key = (rows, cfg.encoder_ctx, cfg.d_model), "encoder_frames"
    return {key: rng.standard_normal(shape, dtype=np.float32)}


class SideRecorder:
    """While active, tallies the port's flash calls by (causal, Sq, Skv)
    and its batch decode calls by key count, through the names
    ``core.modes`` and ``models.model`` call them by: whisper's encoder
    runs flash (False, E, E), its cross attention flash (False, S, E) at
    prefill and the batch decode over E keys at a decode step."""

    def __enter__(self):
        from repro_torch.core import modes as M
        from repro_torch.models import model as MD
        self.flash, self.decode = collections.Counter(), \
            collections.Counter()
        flash, decode = M.flash_attention_bh, MD.decode_attention_bh
        self._saved = ((M, "flash_attention_bh", flash),
                       (MD, "decode_attention_bh", decode))

        def flash_rec(q, k, v, **kw):
            self.flash[kw.get("causal", True), q.shape[1], k.shape[1]] += 1
            return flash(q, k, v, **kw)

        def decode_rec(q, k, *a, **kw):
            self.decode[k.shape[1]] += 1
            return decode(q, k, *a, **kw)
        M.flash_attention_bh, MD.decode_attention_bh = flash_rec, decode_rec
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def side_kernel_cases(dev):
    """The instances whisper's path adds, bf16 at its main shapes (4
    requests of 6 heads, D = 64, G = 1), as ``kernel_cases`` gives them:
    flash with causal=False over the 1500 encoder frames (1500 x 1500)
    and over the decoder prompt (384 x 1500: the cross attention at
    prefill; the last key tile holds 28 keys), and the batch decode with
    all 1500 keys visible (positions arange(1500), cur_pos 1499: the
    cross attention at a decode step). SDPA is called without a mask and
    not causal."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_bh
    from repro_torch.kernels.flash_attention import flash_attention_bh
    F = torch.nn.functional
    cfg = get_config(WHISPER)
    BH, D, E = WHISPER_REQUESTS * cfg.num_heads, cfg.head_dim, \
        cfg.encoder_ctx
    g = torch.Generator(device=dev).manual_seed(4)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(
            torch.bfloat16)

    k, v = rnd(BH, E, D), rnd(BH, E, D)
    cases = {}
    for label, Sq in (("whisper_encoder", E), ("whisper_cross",
                                                WHISPER_PROMPT)):
        q = rnd(BH, Sq, D)
        cases[f"flash_attention {label}"] = (
            lambda q=q, **kw: flash_attention_bh(q, k, v, causal=False,
                                                 **kw),
            lambda q=q: ref.flash_attention_ref(q, k, v, causal=False),
            lambda q=q: ref.flash_attention_ref(q, k, zero_tile(v),
                                                causal=False),
            lambda q=q: F.scaled_dot_product_attention(q[None], k[None],
                                                       v[None]),
            *attn_work(BH, BH, Sq, D, E, BH * Sq * E, 2))
    qd = rnd(BH, 1, D)
    pos = torch.arange(E, dtype=torch.int32, device=dev)
    cases["decode_attention whisper_cross"] = (
        lambda: decode_attention_bh(qd, k, v, pos, E - 1),
        lambda: ref.decode_attention_ref(qd, k, v, pos, E - 1),
        lambda: ref.decode_attention_ref(qd, k, zero_tile(v), pos, E - 1),
        lambda: F.scaled_dot_product_attention(qd[None], k[None], v[None]),
        *attn_work(BH, BH, 1, D, E, BH * E, 2))
    return cases


def side_kernel_checks(dev):
    """Phase 3's whisper rows: each ``side_kernel_cases`` call under the
    bf16 limit, its zeroed tile above it. Returns ({name: max abs err},
    lines)."""
    errs, lines = {}, []
    for name, (kern, plain, mutant, *_rest) in side_kernel_cases(
            dev).items():
        out, want = kern(), plain()
        errs[name] = e = max_err(out, want)
        r, r_mut = bf16_ratios(out, want), bf16_ratios(mutant(), want)
        assert max(r) < 1, f"{WHISPER} {name} bf16: error {r} of the limit"
        assert min(r_mut) > 1, f"{WHISPER} {name} bf16: a zeroed tile is " \
            f"within the limit {r_mut}"
        lines.append(f"{name} bfloat16 {WHISPER} main shapes (4 x 6 heads, "
                     f"D=64, G=1, not causal) max_abs_err={e:.3e} "
                     f"limit_ratio={ratio_text(r)} "
                     f"zeroed_tile_ratio={ratio_text(r_mut)}")
    return errs, lines


def side_kernel_times(dev):
    """Phase 4's whisper rows: device ms, call_ms, the plain version's and
    SDPA's ms and the bound of each ``side_kernel_cases`` call. Returns
    ({name: row}, lines)."""
    rows, lines = {}, []
    for name, (kern, plain, _, lib, n_bytes, flops) in side_kernel_cases(
            dev).items():
        b_ms, b_by = bound(n_bytes, flops)
        r = rows[name] = dict(ms=time_ms(kern), plain_ms=time_ms(plain),
                              library_ms=time_ms(lib), bound_ms=b_ms,
                              bound_by=b_by, call_ms=call_ms(kern))
        lines.append(f"{name} {WHISPER} ms={r['ms']:.4f} "
                     f"call_ms={r['call_ms']:.4f} "
                     f"plain_ms={r['plain_ms']:.4f} library_ms="
                     f"{r['library_ms']:.4f} (sdpa, not causal, no mask) "
                     f"bound_ms={b_ms:.4f} ({b_by}; {n_bytes} bytes, "
                     f"{flops} flops) roofline_share={b_ms / r['ms']:.3f}")
    return rows, lines


def side_parity(dev):
    """Phase 21: phi-3-vision (2 layers) and whisper-tiny (2 encoder + 2
    decoder layers) at full per-head widths in fp32, the same weights
    served on cuda and on cpu through ``generate``: one prompt of
    SIDE_PARITY_LEN positions (phi-3-vision's 576 image embeddings and
    1728 tokens; 1500 frames and 2304 decoder tokens for whisper, past
    its 448-token context so that the SA layers' ring wraps), 8 new
    tokens, router-driven, all-FA, all-SA and mixed. Routing and tokens
    identical, first logits within FP32_TOL. The seed (of the tokens and
    the side input, numpy) is the first whose router margins all exceed
    1e-3 on the card. Returns lines."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import routing_pattern
    from repro_torch.models import model as MD
    from repro_torch.serve.engine import ServeEngine
    out = []
    for arch in (PHI3V, WHISPER):
        base = get_config(arch)
        cfg = base.replace(num_layers=2, dtype=torch.float32,
                           param_dtype=torch.float32,
                           num_encoder_layers=min(base.num_encoder_layers,
                                                  2))
        params = MD.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        S = SIDE_PARITY_LEN - cfg.num_prefix_tokens
        assert SIDE_PARITY_LEN > cfg.flux.sink + cfg.flux.local
        engines = {name: ServeEngine(
            params, cfg, max_len=SIDE_PARITY_LEN + SIDE_PARITY_GEN,
            prefill_chunk=CHUNK, device=d)
            for name, d in (("card", dev), ("cpu", "cpu"))}
        card = engines["card"]
        for seed in range(32):
            toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                        (1, S))
            side = side_inputs(cfg, 1, seed)
            pf = MD.prefill(card.params, cfg,
                            torch.as_tensor(toks, device=dev),
                            routing_ctx="hard_prefix", want_cache=False,
                            **{k: torch.as_tensor(v, device=dev)
                               for k, v in side.items()})
            margin = float(np.abs(pf.p_fa.numpy() - 0.5).min())
            if margin > 1e-3:
                break
        else:
            raise AssertionError(f"{arch}: no prompt seed with router "
                                 f"margins > 1e-3")
        enc = cfg.num_encoder_layers
        line = [f"{arch} ({cfg.num_layers} layers"
                f"{f' + {enc} encoder' if enc else ''}, fp32) "
                f"prompt_seed={seed} min_margin={margin:.2e}"]
        for name in ("router", "fa", "sa", "mixed"):
            ov = routing_pattern(cfg, name)
            res = {d: e.generate(toks, SIDE_PARITY_GEN, routing_override=ov,
                                 **side) for d, e in engines.items()}
            g, c = res["card"], res["cpu"]
            err = float((g.logits.cpu() - c.logits).abs().max())
            assert g.routing == c.routing, (arch, name, g.routing, c.routing)
            assert np.array_equal(g.tokens, c.tokens), (arch, name)
            assert err < FP32_TOL, (arch, name, err)
            assert g.dispatches == c.dispatches
            if name == "router":
                assert float(np.abs(c.p_fa - 0.5).min()) > 1e-3, c.p_fa
            line.append(f"{name} routing={pattern_text(g.routing)} "
                        f"logits_err={err:.2e} "
                        f"tokens={g.tokens[0].tolist()}")
        out.append("; ".join(line))
        del engines, card, params
        free_card()
    return out


def side_path(dev, params, cfg, prompt, max_len, requests=REQUESTS):
    """Phases 22 (phi-3-vision) and 23 (whisper-tiny): ``cfg`` at full
    width and depth in bf16 through ``generate``, ``requests`` prompts of
    ``prompt`` tokens with their side inputs (numpy, seed 0), GEN new
    tokens, router-driven and mixed: the monolithic prefill and repack,
    as in the JAX engine. Every logit finite, the unembedding's full
    vocabulary, exact launch counts: flash (causal) at each FA layer,
    streaming at each SA layer, the batch decode once a layer a step; for
    whisper also flash with causal=False once an encoder layer (E x E)
    and once a decoder layer (the cross attention, S x E), and the batch
    decode once more a layer a step over the E encoder keys; block-sparse
    and the pooled decodes never. The slot pool must refuse the model.
    Returns (launch counts, {instance: launches}, lines)."""
    import repro_torch.kernels as KN
    from repro_torch.launch.serve import routing_pattern
    from repro_torch.serve.engine import ServeEngine
    L, E = cfg.num_layers, cfg.num_encoder_layers
    ctx, P = cfg.encoder_ctx, cfg.num_prefix_tokens
    eng = ServeEngine(params, cfg, max_len=max_len, prefill_chunk=CHUNK,
                      device=dev)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                (requests, prompt))
    side = side_inputs(cfg, requests, 0)
    assert not eng.chunked_eligible(P + prompt, **side)
    try:
        eng.scheduler()
    except ValueError as e:
        assert "decoder-only" in str(e), e
    else:
        raise AssertionError(f"{cfg.name}: the slot pool took a model with "
                             f"a side input")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    KN.reset_launch_counts()
    zero = {k: 0 for k in KN.KERNELS}
    lines, inst = [], collections.Counter()
    for name in ("router", "mixed"):
        before = KN.launch_counts()
        with SideRecorder() as rec:
            gen = eng.generate(prompts, GEN,
                               routing_override=routing_pattern(cfg, name),
                               **side)
        delta = {k: v - before[k] for k, v in KN.launch_counts().items()}
        assert gen.tokens.shape == (requests, GEN)
        assert gen.logits.shape == (requests, cfg.vocab_size)
        assert bool(torch.isfinite(gen.logits).all()), "first logits"
        assert bool(torch.isfinite(gen.final_logits).all()), "last logits"
        n_fa = sum(p == "fa" for p in gen.routing)
        S = P + prompt
        want = {**zero, "flash_attention": n_fa + (E + L if E else 0),
                "streaming_attention": L - n_fa,
                "decode_attention": GEN * L * (2 if E else 1)}
        assert delta == want, (name, delta, want)
        flash = {k: c for k, c in {(True, S, S): n_fa, (False, ctx, ctx): E,
                                   (False, prompt, ctx): L if E else 0}
                 .items() if c}
        assert dict(rec.flash) == flash, (name, dict(rec.flash), flash)
        assert rec.decode[ctx] == (GEN * L if E else 0), dict(rec.decode)
        assert sum(rec.decode.values()) == want["decode_attention"]
        inst["flash_attention whisper_encoder"] += rec.flash[False, ctx, ctx]
        inst["flash_attention whisper_cross"] += rec.flash[False, prompt,
                                                           ctx]
        inst["decode_attention whisper_cross"] += rec.decode[ctx] if E else 0
        enc = (f"encode_s={gen.encode_s:.4f} encode_frames_s="
               f"{requests * ctx / gen.encode_s:.0f} " if E else "")
        lines.append(
            f"{name}: routing={pattern_text(gen.routing)} {enc}"
            f"prefill_s={gen.prefill_s:.3f} prefill_tok_s="
            f"{requests * S / gen.prefill_s:.0f} (positions, prefix "
            f"included) decode_s={gen.decode_s:.3f} decode_tok_s="
            f"{requests * GEN / gen.decode_s:.1f} kv_bytes={gen.kv_bytes} "
            f"dispatches={gen.dispatches} launches={delta} "
            f"flash_calls={dict(rec.flash)} decode_calls={dict(rec.decode)} "
            f"tokens0={gen.tokens[0, :8].tolist()}")
    counts = KN.launch_counts()
    for k in ("flash_attention", "streaming_attention", "decode_attention"):
        assert counts[k] > 0, f"{k} was never launched on {cfg.name}'s path"
    lines.append(f"peak_mem_bytes={torch.cuda.max_memory_allocated(dev)} "
                 f"card={torch.cuda.get_device_name(0)}")
    return counts, dict(inst), lines


# ---------------------------------------------------------------------------
# Mamba2 SSD (phases 24-26): the SSD pieces at mamba2's widths, mamba2 and
# jamba's smoke variant card against CPU, mamba2-780m at full width and
# depth on both frontends and through the prefix store
# ---------------------------------------------------------------------------

SSD_LENS = (4096, 1365)  # phase 24: 16 whole chunks; 5 and a 85-token tail
SSD_STEPS = 32           # phase 24's decode steps after each prefill
SSD_FP32_TOL = 1e-4      # card vs CPU in f32, relative to the largest |ref|
# bf16 against f32, relative to the largest |f32|: ssd_chunked on equal
# (bf16-rounded) operands, and the block (mamba_apply, then the decode
# steps), whose projections also round dt to bf16, an error exp(A·dt)
# multiplies by up to |A| = 16. Phase 3's per-element limit does not fit
# a sum over thousands of positions: an element's error follows the size
# of its terms, not its own (measured on the CPU at S = 4096: 1.45 of
# that limit, 4.8e-3 of the largest value)
SSD_BF16_TOL, SSD_BF16_BLOCK_TOL = 0.02, 0.05
MAMBA_STORE_MB = 1024    # phase 26's store: 13 snapshots of 76.6 MB
PROFILE_TOP_OPS = 8      # phase 26's operators by device time


def rel_err(a, b, floor=1.0):
    """max |a - b| over max(floor, max |b|), on the host."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).abs().max()) / max(floor, float(b.abs().max()))


def ssd_parity(dev):
    """Phase 24: ``ssd_chunked`` and SSD_STEPS ``mamba_decode_step``s at
    mamba2's full widths (B = REQUESTS; H 48, P 64, N 128, Q 256) on one
    seeded layer, card against CPU in f32 (SSD_FP32_TOL), and the card in
    bf16 against the CPU's f32 result: ``ssd_chunked`` within SSD_BF16_TOL
    (every operand rounded to bf16 first, so both runs see the same inputs
    and the bf16 run's error is its arithmetic's), the block and its
    decode steps within SSD_BF16_BLOCK_TOL."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm as SSM
    from repro_torch.models.model import params_to
    cfg = get_config(MAMBA2)
    p16 = SSM.mamba_init(torch.Generator().manual_seed(24), cfg)
    p32 = {k: (v.float() if isinstance(v, torch.Tensor)
               else {n: t.float() for n, t in v.items()})
           for k, v in p16.items()}
    c32, c16 = cfg.replace(dtype=torch.float32), cfg
    card = {torch.float32: (params_to(p32, dev), c32),
            torch.bfloat16: (params_to(p16, dev), c16)}
    lines = []
    for S in SSD_LENS:
        g = torch.Generator().manual_seed(S)
        x = torch.randn(REQUESTS, S + SSD_STEPS, cfg.d_model, generator=g
                        ).to(torch.bfloat16).float()
        _, _, (xs, dt, A, Bm, Cm) = SSM.ssd_operands(p32, c32, x[:, :S])
        # x, B and C in bf16 in the bf16 run (dt and A stay f32, as in
        # mamba_apply): both runs take the bf16-rounded values
        xs, Bm, Cm = (t.to(torch.bfloat16).float() for t in (xs, Bm, Cm))
        ref_y, ref_h = SSM.ssd_chunked(xs, dt, A, Bm, Cm, cfg.ssm_chunk)
        res = {dt_: SSM.ssd_chunked(xs.to(dev, dt_), dt.to(dev), A.to(dev),
                                    Bm.to(dev, dt_), Cm.to(dev, dt_),
                                    cfg.ssm_chunk)
               for dt_ in (torch.float32, torch.bfloat16)}
        e_y = rel_err(res[torch.float32][0], ref_y)
        e_h = rel_err(res[torch.float32][1], ref_h)
        assert max(e_y, e_h) < SSD_FP32_TOL, (S, e_y, e_h)
        b_y = rel_err(res[torch.bfloat16][0], ref_y, 0.0)
        b_h = rel_err(res[torch.bfloat16][1], ref_h, 0.0)
        assert max(b_y, b_h) < SSD_BF16_TOL, (S, b_y, b_h)
        # the block over S tokens, then SSD_STEPS decode steps
        want = [SSM.mamba_apply(p32, c32, x[:, :S])]
        state = want[0][1]
        for i in range(S, S + SSD_STEPS):
            y, *state = SSM.mamba_decode_step(p32, c32, x[:, i:i + 1],
                                              *state)
            want.append((y, tuple(state)))
        errs = {}
        for dt_, (pp, cc) in card.items():
            xd = x.to(dev, dt_)
            got = [SSM.mamba_apply(pp, cc, xd[:, :S])]
            state = got[0][1]
            for i in range(S, S + SSD_STEPS):
                y, *state = SSM.mamba_decode_step(pp, cc, xd[:, i:i + 1],
                                                  *state)
                got.append((y, tuple(state)))
            if dt_ == torch.float32:
                errs[dt_] = max(rel_err(a, b) for (ya, sa), (yb, sb)
                                in zip(got, want)
                                for a, b in zip((ya, *sa), (yb, *sb)))
            else:  # y and the SSD state
                errs[dt_] = max(rel_err(a, b, 0.0)
                                for (ya, sa), (yb, sb) in zip(got, want)
                                for a, b in zip((ya, sa[0]), (yb, sb[0])))
        assert errs[torch.float32] < SSD_FP32_TOL, (S, errs)
        assert errs[torch.bfloat16] < SSD_BF16_BLOCK_TOL, (S, errs)
        lines.append(
            f"S={S} B={REQUESTS} ssd_chunked fp32 rel_err y={e_y:.2e} "
            f"h={e_h:.2e} (tol {SSD_FP32_TOL}) bf16 rel_err y={b_y:.2e} "
            f"h={b_h:.2e} (tol {SSD_BF16_TOL}); mamba_apply + "
            f"{SSD_STEPS} decode steps fp32 rel_err="
            f"{errs[torch.float32]:.2e} bf16 rel_err (y, h)="
            f"{errs[torch.bfloat16]:.2e} (tol {SSD_BF16_BLOCK_TOL})")
    return lines


def op_profile(fn, dev):
    """Run ``fn`` twice: once on the host clock alone, then under
    torch.profiler (host operators and device kernels). Returns (wall ms
    of the first, wall ms of the profiled one, its device busy ms, the
    PROFILE_TOP_OPS operators with the most device time of their own as
    (name, calls, ms))."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(dev)
    plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    key = ("self_device_time_total"
           if hasattr(rows[0], "self_device_time_total")
           else "self_cuda_time_total")
    busy = sum(getattr(e, key) for e in rows
               if e.device_type == DeviceType.CUDA) / 1e3
    ops = sorted((e for e in rows if e.device_type == DeviceType.CPU
                  and e.key.startswith("aten::") and getattr(e, key) > 0),
                 key=lambda e: -getattr(e, key))
    return (1e3 * plain, 1e3 * wall, busy,
            [(e.key, e.count, getattr(e, key) / 1e3)
             for e in ops[:PROFILE_TOP_OPS]])


def profile_text(name, prof):
    plain, wall, busy, ops = prof
    return (f"{name}: wall_ms={plain:.3f} (profiled {wall:.3f}) "
            f"device_busy_ms={busy:.3f} idle_share="
            f"{1 - busy / plain:.3f} top_ops=" + ", ".join(
                f"{k} x{c} {ms:.3f} ms" for k, c, ms in ops))


def mamba_cells(dev, params, cfg):
    """Phase 26: mamba2-780m at full width (MAMBA2_LAYERS deep) in bf16 on
    three cells: phase 6's batch cell (REQUESTS x PROMPT, GEN tokens, chunk
    CHUNK), phase 7's continuous cell (8 requests, 4 slots, chunks of 8,
    a priority-9 preemption) and phase 8's prefix cell (warm = cold
    bitwise from the device and pinned host tiers, and a shared-preamble
    drain). No attention kernel may launch. Returns (launch counts,
    report lines)."""
    import repro_torch.kernels as KN
    from repro_torch.launch.serve import PREFILL_CHUNKS_PER_TICK
    from repro_torch.models import model as MD
    from repro_torch.serve import kv_cache as KC
    from repro_torch.serve.engine import (Request, ServeEngine,
                                          serve_batch_finished)
    from repro_torch.serve.scheduler import STATUS_OK, ContinuousScheduler
    kw = dict(max_len=PROMPT + GEN, prefill_chunk=CHUNK, device=dev)
    state_bytes = cfg.num_layers * (
        cfg.ssm_num_heads * cfg.ssm_head_dim * cfg.ssm_state_dim * 4
        + (cfg.ssm_conv_width - 1) * (cfg.ssm_inner + 2 * cfg.ssm_state_dim)
        * cfg.dtype.itemsize)
    zero = {k: 0 for k in KN.launch_counts()}
    total = collections.Counter()
    lines = []
    # --- batch cell
    eng = ServeEngine(params, cfg, **kw)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                (REQUESTS, PROMPT))
    serve_batch_finished(eng, [Request(rid=0, tokens=prompts[0, :CHUNK],
                                       n_steps=2)])  # the first calls

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    KN.reset_launch_counts()
    done = serve_batch_finished(eng, [Request(rid=i, tokens=prompts[i],
                                              n_steps=GEN)
                                      for i in range(REQUESTS)])
    gen = done[0].result
    assert all(len(done[i].tokens) == GEN for i in range(REQUESTS))
    assert bool(torch.isfinite(gen.logits).all()), "first logits"
    assert bool(torch.isfinite(gen.final_logits).all()), "last logits"
    assert KN.launch_counts() == zero, KN.launch_counts()
    total.update(KN.launch_counts())
    assert gen.kv_bytes == REQUESTS * state_bytes, (gen.kv_bytes,
                                                    state_bytes)
    peak = torch.cuda.max_memory_allocated(dev)
    lines.append(
        f"batch: {REQUESTS}x{PROMPT} gen={GEN} chunk={CHUNK} "
        f"prefill_s={gen.prefill_s:.3f} "
        f"prefill_tok_s={REQUESTS * PROMPT / gen.prefill_s:.0f} "
        f"decode_s={gen.decode_s:.3f} "
        f"decode_tok_s={REQUESTS * GEN / gen.decode_s:.1f} "
        f"ssd_state_bytes_per_request={gen.kv_bytes // REQUESTS} "
        f"peak_mem_bytes={peak} launches={KN.launch_counts()} "
        f"tokens0={done[0].tokens[:8].tolist()}")
    # one prefill chunk and one decode step by operator
    job = eng.start_chunked_prefill(prompts)
    job.step()  # the routing chunk; then chunks at CHUNK and 2 CHUNK
    lines.append(profile_text(f"prefill chunk (B={REQUESTS}, {CHUNK} "
                              f"tokens)", op_profile(job.step, dev)))
    while not job.done:
        job.step()
    tok = torch.argmax(job.logits, dim=-1)[:, None]
    lines.append(profile_text(
        f"decode step (B={REQUESTS} at {PROMPT})",
        op_profile(lambda: MD.decode_core(params, cfg, tok, job.caches,
                                          PROMPT), dev)))
    del job
    free_card()
    # --- continuous cell
    rng = np.random.default_rng(1)
    cprompts = [rng.integers(0, cfg.vocab_size, PROMPT // (1 + rid % 3))
                for rid in range(8)]
    eng = ServeEngine(params, cfg, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    KN.reset_launch_counts()
    t0 = time.perf_counter()
    sched = ContinuousScheduler(
        eng, slots_per_bucket=4, chunk=8,
        prefill_chunks_per_tick=PREFILL_CHUNKS_PER_TICK)
    for rid in range(7):
        eng.submit(Request(rid=rid, tokens=cprompts[rid], n_steps=GEN))
    for _ in range(64):
        eng.step()
        if any(p.occupancy() == p.capacity for p in sched.pools.values()):
            break
    else:
        raise AssertionError("the pool never filled")
    eng.submit(Request(rid=7, tokens=cprompts[7], n_steps=GEN, priority=9))
    cdone = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert sorted(cdone) == list(range(8))
    for rid, f in cdone.items():
        assert f.status == STATUS_OK, (rid, f.status)
        assert len(f.tokens) == GEN, rid
    preempt = sum(f.metrics.preemptions for f in cdone.values())
    assert preempt >= 1, "no preemption"
    assert sched.n_geometries() == 1
    assert KN.launch_counts() == zero, KN.launch_counts()
    total.update(KN.launch_counts())
    summ = cdone.summary
    tokens = sum(f.metrics.n_generated for f in cdone.values())
    lines.append(
        f"continuous: requests=8 prompt_lens={[len(p) for p in cprompts]} "
        f"tokens={tokens} wall_s={wall:.3f} tok_s={tokens / wall:.1f} "
        f"ttft_p50_s={summ['ttft_p50_s']:.3f} "
        f"prefill_time_p50_s={summ['prefill_time_p50_s']:.3f} "
        f"preemptions={preempt} ticks={sched.ticks} "
        f"pool_steps={[p.steps for p in sched.pools.values()]} "
        f"pool_state_bytes={summ['kv_payload_bytes']} "
        f"peak_mem_bytes={torch.cuda.max_memory_allocated(dev)} "
        f"launches={KN.launch_counts()}")
    del eng, sched
    free_card()
    # --- prefix cell
    rng = np.random.default_rng(3)
    pre = rng.integers(0, cfg.vocab_size, PREAMBLE)
    A, B = (np.concatenate([pre, rng.integers(0, cfg.vocab_size,
                                              PROMPT - PREAMBLE)])[None]
            for _ in range(2))
    cold = ServeEngine(params, cfg, **kw)
    ref = {"A": cold.generate(A, GEN), "B": cold.generate(B, GEN)}
    warm = ServeEngine(params, cfg, prefix_cache_mb=MAMBA_STORE_MB,
                       prefix_cache_host_mb=MAMBA_STORE_MB, **kw)
    KN.reset_launch_counts()
    runs = [("A cold", "A", warm.generate(A, GEN))]
    offloaded = warm.prefix_store.offload_all()
    runs.append(("A host hit", "A", warm.generate(A, GEN)))
    runs.append(("B hit", "B", warm.generate(B, GEN)))
    for name, key, g in runs:
        assert np.array_equal(g.tokens, ref[key].tokens), name
        assert torch.equal(g.logits, ref[key].logits), name
        assert torch.equal(g.final_logits, ref[key].final_logits), name
    hits = [g.prefix_hit_tokens for *_, g in runs]
    assert hits == [0, PROMPT, PREAMBLE], hits
    job = cold.prefill_chunked(A)
    snap = sum(t.nbytes for c in job.caches for t in KC.cache_fields(c))
    lines.append(
        f"prefix batch: prefix_hit_tokens={hits} offloaded={offloaded} "
        f"warm_equals_cold=True (tokens, first and last logits) "
        f"prefill_s=" + "/".join(f"{g.prefill_s:.4f}" for *_, g in runs)
        + f" (cold {ref['A'].prefill_s:.4f}) snapshot_state_bytes={snap} "
        f"store={warm.prefix_store.stats().as_dict()}")
    del warm, cold, job
    free_card()
    pre = rng.integers(0, cfg.vocab_size, CONT_PREAMBLE)
    dprompts = [np.concatenate([pre, rng.integers(
        0, cfg.vocab_size, CONT_TAILS[rid % len(CONT_TAILS)])])
        for rid in range(8)]

    def drain(**store_kw):
        e = ServeEngine(params, cfg, **kw, **store_kw)
        ContinuousScheduler(e, slots_per_bucket=4, chunk=8,
                            prefill_chunks_per_tick=PREFILL_CHUNKS_PER_TICK)
        for rid, toks in enumerate(dprompts):
            e.submit(Request(rid=rid, tokens=toks, n_steps=GEN))
        t0 = time.perf_counter()
        d = e.drain()
        torch.cuda.synchronize()
        return d, time.perf_counter() - t0

    cold_done, cold_wall = drain()
    free_card()
    wdone, wwall = drain(prefix_cache_mb=MAMBA_STORE_MB)
    hits = [wdone[r].metrics.prefix_hit_tokens for r in range(8)]
    for rid in range(8):
        assert wdone[rid].status == cold_done[rid].status == STATUS_OK
        assert np.array_equal(wdone[rid].tokens, cold_done[rid].tokens), rid
    assert hits[0] == 0 and all(h > 0 for h in hits[1:]), hits
    assert KN.launch_counts() == zero, KN.launch_counts()
    total.update(KN.launch_counts())
    lines.append(
        f"prefix continuous: prefix_hit_tokens={hits} "
        f"tokens_equal_cold_drain=True wall_s={wwall:.3f} (cold "
        f"{cold_wall:.3f}) ttft_p50_s={wdone.summary['ttft_p50_s']:.3f} "
        f"(cold {cold_done.summary['ttft_p50_s']:.3f}) "
        f"launches={KN.launch_counts()}")
    return {k: total[k] for k in zero}, lines


GEMMA3_LENS = (8, 16, 100)  # phase 27's prompts, against its window of 16


def gemma_parity(dev):
    """Phase 27: gemma3's smoke variant (6 layers: 5 local with a window of
    16, then 1 routed; D = 32, G = 2) in fp32, the same seeded weights on
    the card and on the CPU, on the cases of tests/test_torch_gemma3.py:
    ``generate`` of 2 prompts of GEMMA3_LENS tokens, 40 new tokens (the
    local rings wrap 2.5 times), chunk 64 and the monolithic repack,
    router-driven, and all-FA, all-SA and alternating at 100 tokens; then
    a slot-pool drain with staggered arrivals and a priority-9 arrival
    that preempts. Routing, tokens, statuses and preemptions equal; the
    first logits' gaps printed (within 2e-3: fp32 both, summation order
    only). Returns report lines."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.launch.serve import routing_letters, routing_pattern
    from repro_torch.models import model as MD
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.scheduler import STATUS_OK
    cfg = smoke_variant(get_config(GEMMA3))
    params = MD.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    N, max_len, devs = 40, 160, (dev, torch.device("cpu"))
    engines = {(d.type, c): ServeEngine(params, cfg, max_len=max_len,
                                        prefill_chunk=c, device=d)
               for d in devs for c in (64, None)}
    card = engines["cuda", 64]
    for seed in range(32):
        rng = np.random.default_rng(seed)
        prompts = {S: rng.integers(0, cfg.vocab_size, (2, S))
                   for S in GEMMA3_LENS}
        margin = min(float(np.abs(MD.prefill(
            card.params, cfg, card._tokens(p[:, :64]),
            routing_ctx="hard_prefix", want_cache=False).p_fa.numpy()
            - 0.5).min()) for p in prompts.values())
        if margin > 1e-3:
            break
    else:
        raise AssertionError("no prompt seed with router margins > 1e-3")
    lines = [f"prompt_seed={seed} min_margin={margin:.2e}"]
    cases = ([(S, "router", c) for c in (64, None) for S in GEMMA3_LENS]
             + [(100, r, c) for c in (64, None) for r in ("fa", "sa",
                                                           "mixed")])
    for S, routing, chunk in cases:
        ov = routing_pattern(cfg, routing)
        g, c = (engines[d.type, chunk].generate(prompts[S], N,
                                                routing_override=ov)
                for d in devs)
        err = float((g.logits.cpu() - c.logits).abs().max())
        assert g.routing == c.routing, (S, routing, chunk)
        assert np.array_equal(g.tokens, c.tokens), (S, routing, chunk)
        assert g.kv_bytes == c.kv_bytes and err < 2e-3, err
        lines.append(f"S={S} {routing} chunk={chunk or 'monolithic'} "
                     f"routing={routing_letters(g.routing)} "
                     f"logits_err={err:.2e} "
                     f"tokens0={g.tokens[0, :8].tolist()}")
    out = {}
    for d in devs:
        eng = ServeEngine(params, cfg, max_len=max_len, prefill_chunk=16,
                          device=d)
        sched = eng.scheduler(slots_per_bucket=2, chunk=4,
                              prefill_chunks_per_tick=2)
        rng = np.random.default_rng(2)
        ov = routing_pattern(cfg, "mixed")
        reqs = [Request(rid=rid, tokens=rng.integers(0, cfg.vocab_size, n),
                        n_steps=20, routing_override=ov)
                for rid, n in enumerate((20, 28, 9, 24))]
        eng.submit(reqs[0])
        eng.submit(reqs[1])
        eng.step()
        eng.submit(reqs[2])
        eng.submit(reqs[3])
        for _ in range(8):
            if sched.n_active() == 2:
                break
            eng.step()
        assert sched.n_active() == 2, "the pool never filled"
        eng.submit(Request(rid=9, tokens=rng.integers(0, cfg.vocab_size, 17),
                           n_steps=6, priority=9, routing_override=ov))
        out[d.type] = eng.drain()
    g, c = out["cuda"], out["cpu"]
    assert sorted(g) == sorted(c)
    for rid in g:
        assert g[rid].status == c[rid].status == STATUS_OK, rid
        assert np.array_equal(g[rid].tokens, c[rid].tokens), rid
        assert g[rid].metrics.preemptions == c[rid].metrics.preemptions
    preempt = sum(f.metrics.preemptions for f in g.values())
    assert preempt >= 1, "the drain did not preempt"
    lines.append(f"drain: {len(g)} requests ok, preemptions={preempt}, "
                 f"tokens equal")
    return lines


def gemma_cells(dev, params, cfg):
    """Phase 28: gemma3-12b at full width, depth cut to GEMMA3_LAYERS, in
    bf16, seeded weights: phase 6's batch cell (router-driven, all-FA and
    all-SA; the alternating override would route every global layer,
    each at an odd index, to SA), phase 7's continuous cell and phase
    8's prefix cell (stores of GEMMA3_STORE_SNAPSHOTS routed snapshots),
    each with exact launch counts; then one PROMPT-token admission whose
    local rings must hold the last sliding_window positions in
    sliding_window slots.
    Returns ({cell: launch counts}, report lines)."""
    from repro_torch.serve import kv_cache as KC
    from repro_torch.serve.engine import ServeEngine
    counts, lines = {}, []
    counts["batch"], out = main_path(dev, params, cfg,
                                     routings=("router", "fa", "sa"))
    lines += [f"batch {line}" for line in out]
    free_card()
    counts["continuous"], out = continuous_path(dev, params, cfg)
    lines += [f"continuous {line}" for line in out]
    free_card()
    counts["prefix"], out = prefix_path(dev, params, cfg,
                                        GEMMA3_STORE_SNAPSHOTS)
    lines += [f"prefix {line}" for line in out]
    free_card()
    eng = ServeEngine(params, cfg, max_len=PROMPT + GEN, prefill_chunk=CHUNK,
                      device=dev)
    job = eng.prefill_chunked(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, PROMPT)))
    w = cfg.sliding_window
    local = [c for c, k in zip(job.caches, cfg.layer_kinds) if k == "local"]
    assert all(KC.capacity(c) == w for c in local)
    for c in local:
        pos = c.positions[0].tolist()
        assert sorted(pos) == list(range(PROMPT - w, PROMPT))
        assert all(p % w == slot for slot, p in enumerate(pos))
    lines.append(f"local rings after a {PROMPT}-token admission: "
                 f"{len(local)} x {w} slots holding positions "
                 f"{PROMPT - w}-{PROMPT - 1}, {KC.kv_cache_bytes(local)} "
                 f"bytes a request")
    return counts, lines


# ---------------------------------------------------------------------------
# Training: the attention backward kernel (phases 2-4), the trainers card
# against CPU (29) and router training at full width and depth (30)
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S = 2, 4096  # phase 30's batch and phase 4's shapes
# deepseek-v2's training rows (phase 30b and phase 4's (192, 128) shapes)
# and MLA's route-chunk widths: nope + rope = 192 over v = 128
DEEPSEEK_TRAIN_S, MLA_DK, MLA_DV = 2048, 192, 128
TRAIN_STEPS, TRAIN_SCHEDULE = 8, 300  # phase 30: 8 steps of a 300 schedule
QUIET_STEPS = 2  # phase 30's steps timed again after the parity phases
# phase 29 (card against CPU, 2 layers at full width, fp32): one row of
# 3072 tokens, 896 past phi3-mini's sink + local (2176). Below that, FA
# and SA agree and r's gradient, sum (o_fa - o_sa) . dL/do, is the
# difference of two kernels' sums in different orders on the card and
# an exact 0 on the CPU: at 2304 tokens (128 rows past) a router leaf
# read 1.4e-4 of its largest value apart on an H100
PARITY_B, PARITY_S, PARITY_ROUTER_STEPS = 1, 3072, 1
# the PretrainTrainer and ContinuedTrainer steps of phase 29: their
# gradients reach every weight whatever the routing, so a shorter row
# (the CPU's dense plain attention is quadratic in it)
PARITY_BACKBONE_S = 512
TRAIN_TOL = 1e-4  # phase 29: relative to each leaf's largest CPU value
# phase 29's xa and deepseek cases (``parity_cases``): router steps each,
# phi3-mini's xa row, deepseek's row and the flux window it runs under
PARITY_XA_STEPS, PARITY_XA_S = 1, 1024
PARITY_DS_S, PARITY_DS_SINK, PARITY_DS_LOCAL = 1024, 64, 448
BWD_SMALL_STREAM = ((0, 48), (16, 48), (100, 130))  # (sink, local)


def backward_work(BH, BHkv, Sq, Skv, D, pairs, itemsize, Dv=None):
    """Bytes (q, k, v, dO read once, dq, dk, dv written once) and
    operations (S = QKᵀ, dQ = dS K and dK = dSᵀ Q over Dk; dP = dO Vᵀ and
    dV = Pᵀ dO over Dv: 2·(3·Dk + 2·Dv) for each visible (query, key)
    pair)."""
    Dv = D if Dv is None else Dv
    return (itemsize * (BH * Sq * (2 * D + Dv) + 2 * BHkv * Skv * (D + Dv)),
            2 * (3 * D + 2 * Dv) * pairs)


def backward_cases(dev, dtype, main):
    """[{label, kern: kernel call → (dq, dk, dv), plain, mutant: the plain
    call with one V tile zeroed, sdpa: SDPA forward + backward, fwd_bwd:
    the entry under autograd and ``torch.autograd.grad``, other(entry): the
    same call through another tree's entry (``parent_backward``), flat /
    plain_flat: the kernel's and the plain version's (dq, dk, dv)
    flattened into one tensor (``flat(out=buf)`` writes the kernel's into
    buf's views and returns buf), sizes: the three parts' sizes in it,
    bytes, flops}].
    ``main`` (bf16): phi3-mini's training shapes (2 x 32 heads, D = 96,
    4096 tokens: causal, and streaming at sink 128 / local 2048),
    stablelm-12b's (2 x 32 heads over 2 x 8, D = 160), gemma3-12b's
    window (2 x 16 over 2 x 8, D = 256, sink 0, local 1024), whisper's
    bidirectional encoder (4 x 6 heads, D = 64, 1500 x 1500) and
    deepseek-v2's route chunk in training (2 x 128 heads, (Dk, Dv) =
    (192, 128), DEEPSEEK_TRAIN_S tokens, causal); else the
    unaligned G = 4 case (200 queries at offset 100 over 300 keys) at
    every head dim and at (192, 128): flash causal and bidirectional, and
    streaming at BWD_SMALL_STREAM."""
    from repro_torch.configs import get_config
    from repro_torch.kernels._build import HEAD_DIMS
    from repro_torch.kernels.attention_backward import (
        attention_backward_bh, attention_backward_plain)
    from repro_torch.kernels.flash_attention import flash_attention_bh
    from repro_torch.kernels.streaming_attention import \
        streaming_attention_bh
    g = torch.Generator(device=dev).manual_seed(5)
    it = torch.tensor([], dtype=dtype).element_size()

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    # (label, B, H, Hkv, Sq, Skv, D, [(mode label, kw)][, Dv])
    shapes = []
    if main:
        for arch in (ARCH, STABLELM):
            c = get_config(arch)
            shapes.append((arch, TRAIN_B, c.num_heads, c.num_kv_heads,
                           TRAIN_S, TRAIN_S, c.head_dim,
                           [("causal", dict(causal=True)),
                            (f"streaming sink={c.flux.sink} "
                             f"local={c.flux.local}",
                             dict(sink=c.flux.sink, local=c.flux.local))]))
        c = get_config(GEMMA3)
        shapes.append((GEMMA3, TRAIN_B, c.num_heads, c.num_kv_heads,
                       TRAIN_S, TRAIN_S, c.head_dim,
                       [(f"window sink=0 local={c.sliding_window}",
                         dict(sink=0, local=c.sliding_window))]))
        c = get_config(WHISPER)
        shapes.append((WHISPER, WHISPER_REQUESTS, c.num_heads, c.num_heads,
                       c.encoder_ctx, c.encoder_ctx, c.head_dim,
                       [("bidirectional", dict(causal=False))]))
        # causal only: deepseek's sink + local (2176) covers its 2048
        # training tokens, so its streaming mask is the causal one there
        c = get_config(DEEPSEEK)
        shapes.append((DEEPSEEK, TRAIN_B, c.num_heads, c.num_heads,
                       DEEPSEEK_TRAIN_S, DEEPSEEK_TRAIN_S, MLA_DK,
                       [("causal", dict(causal=True))], MLA_DV))
    else:
        modes = [("causal q_offset=100", dict(causal=True, q_offset=100)),
                 ("bidirectional", dict(causal=False))]
        modes += [(f"streaming sink={s} local={w} q_offset=100",
                   dict(sink=s, local=w, q_offset=100))
                  for s, w in BWD_SMALL_STREAM]
        shapes = [(f"unaligned D={D}", 1, 8, 2, 200, 300, D, modes)
                  for D in HEAD_DIMS]
        shapes.append((f"unaligned (Dk, Dv)=({MLA_DK}, {MLA_DV})", 1, 8, 2,
                       200, 300, MLA_DK, modes, MLA_DV))
    cases = []
    for label, B, H, Hkv, Sq, Skv, D, modes, *dv in shapes:
        Dv = dv[0] if dv else D
        BH, BHkv = B * H, B * Hkv
        q, k, v = rnd(BH, Sq, D), rnd(BHkv, Skv, D), rnd(BHkv, Skv, Dv)
        do = rnd(BH, Sq, Dv)
        for mode, kw in modes:
            if "local" in kw:
                pos = kw.get("q_offset", 0) + np.arange(Sq)
                pairs = BH * streaming_pairs(pos, kw["sink"], kw["local"])
            else:
                off = kw.get("q_offset", 0)
                pairs = BH * (int(np.minimum(off + np.arange(Sq) + 1,
                                             Skv).sum())
                              if kw["causal"] else Sq * Skv)
            entry = streaming_attention_bh if "local" in kw \
                else flash_attention_bh
            n_bytes, flops = backward_work(BH, BHkv, Sq, Skv, D, pairs, it,
                                           Dv)
            dims = f"D={D}" if Dv == D else f"(Dk, Dv)=({D}, {Dv})"
            cases.append(dict(
                kernel="attention_backward",
                label=f"{label} {mode} BH={BH} G={H // Hkv} {dims} Sq={Sq} "
                      f"Skv={Skv}",
                kern=lambda q=q, k=k, v=v, do=do, kw=kw:
                    attention_backward_bh(q, k, v, do, **kw),
                plain=lambda q=q, k=k, v=v, do=do, kw=kw:
                    attention_backward_plain(q, k, v, do, **kw),
                mutant=lambda q=q, k=k, v=v, do=do, kw=kw:
                    attention_backward_plain(q, k, zero_tile(v), do, **kw),
                sdpa=sdpa_train_call(q, k, v, do, B, H, Hkv, kw),
                fwd_bwd=lambda q=q, k=k, v=v, do=do, kw=kw, entry=entry:
                    fwd_bwd_call(entry, q, k, v, do, kw),
                other=lambda other, q=q, k=k, v=v, do=do, kw=kw:
                    other(q, k, v, do, **kw),
                flat=lambda out=None, q=q, k=k, v=v, do=do, kw=kw:
                    flat_grads(attention_backward_bh, (q, k, v, do), kw,
                               out),
                plain_flat=lambda q=q, k=k, v=v, do=do, kw=kw: flat_grads(
                    attention_backward_plain, (q, k, v, do), kw),
                sizes=(q.numel(), k.numel(), v.numel()),
                bytes=n_bytes, flops=flops))
    return cases


def xa_tiles(q, k, mode, q_offset=0):
    """XAttention's selection on the card (``xa_selection`` at ``mode``)
    for q (B, Hq, Sq, Dk) over k (B, Hkv, Skv, Dk), in the block-sparse
    kernels' 64-token tiles (``expand_selection``), and its dense
    visibility (B·Hq, Sq, Skv) with the causal mask at ``q_offset``.
    Returns (tiles, mask, keep)."""
    from repro_torch.core import modes as M
    from repro_torch.kernels.block_sparse_attention import KERNEL_BLOCK
    B, Hq, Sq, D = q.shape
    Skv = k.shape[2]
    sel = M.xa_selection(q, k, mode, q_offset=q_offset, scale=D ** -0.5)
    tiles = M.expand_selection(sel, mode.block, Sq, Skv, q_offset)
    return (tiles, tile_mask(tiles, Sq, Skv, q_offset), sel.shape[-1])


def tile_mask(tiles, Sq, Skv, q_offset):
    """The dense visibility (BH, Sq, Skv) of a 64-token tile selection
    under the causal mask at ``q_offset``: what
    ``ref.block_sparse_attention_ref`` masks."""
    T = 64
    nqt, nkt = tiles.shape[1], -(-Skv // T)
    blk = torch.zeros(tiles.shape[0], nqt, nkt + 1, dtype=torch.bool,
                      device=tiles.device)
    live = (tiles >= 0) & (tiles < nkt)
    blk.scatter_(2, torch.where(live, tiles, nkt).long(), True)
    pos = q_offset + torch.arange(Sq, device=tiles.device)
    return (blk[:, :, :nkt].repeat_interleave(T, 1)
            .repeat_interleave(T, 2)[:, :Sq, :Skv]
            & (torch.arange(Skv, device=tiles.device)[None]
               <= pos[:, None])[None])


def small_selection(g, BH, Sq, Skv, K=5):
    """A selection of the unaligned cases: per query head and 64-row
    block, K tiles drawn from -1 to past Skv (repeats, holes, tiles past
    the diagonal and past Skv), tile 1 (the zeroed tile's) first."""
    nqt, nkt = -(-Sq // 64), -(-Skv // 64)
    sel = torch.randint(-1, nkt + 1, (BH, nqt, K), generator=g,
                        device=g.device, dtype=torch.int32)
    sel[:, :, 0] = 1
    return sel


def sparse_backward_cases(dev, dtype, main):
    """``backward_cases``' dicts for the block-sparse backward
    (``block_sparse_backward_bh``; ``kernel`` "block_sparse_backward",
    ``sdpa`` SDPA forward + backward under the same boolean mask).
    ``main`` (bf16): the xa training shapes, the selection built on the
    card by ``xa_tiles`` at the published block 128, stride 16, threshold
    0.9: phi3-mini's (2 x 32 heads, D = 96, TRAIN_S tokens; 4 of 32
    blocks a query block) and deepseek-v2's (2 x 128 heads, (192, 128),
    DEEPSEEK_TRAIN_S tokens; 2 of 16); else the unaligned cases (200
    queries at offset 100 over 300 keys, 2 KV heads of G = 1, 2 and 4
    query heads, ``small_selection``, which differs per query head) at
    every head dim and at (192, 128)."""
    from repro_torch.configs import get_config
    from repro_torch.core import modes as M
    from repro_torch.kernels._build import HEAD_DIMS
    from repro_torch.kernels.block_sparse_attention import \
        block_sparse_attention_bh
    from repro_torch.kernels.block_sparse_backward import (
        block_sparse_backward_bh, block_sparse_backward_plain)
    g = torch.Generator(device=dev).manual_seed(8)
    it = torch.tensor([], dtype=dtype).element_size()

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    shapes = []  # (label, B, H, Hkv, Sq, Skv, q_offset, Dk, Dv, mode)
    if main:
        c = get_config(ARCH)
        shapes.append((f"{ARCH} xa", TRAIN_B, c.num_heads, c.num_kv_heads,
                       TRAIN_S, TRAIN_S, 0, c.head_dim, c.head_dim,
                       M.xa_mode(c.flux)))
        c = get_config(DEEPSEEK)
        shapes.append((f"{DEEPSEEK} xa", TRAIN_B, c.num_heads, c.num_heads,
                       DEEPSEEK_TRAIN_S, DEEPSEEK_TRAIN_S, 0, MLA_DK, MLA_DV,
                       M.xa_mode(c.flux)))
    else:
        for D, Dv in [(D, D) for D in HEAD_DIMS] + [(MLA_DK, MLA_DV)]:
            for G in (1, 2, 4):
                shapes.append(("unaligned", 1, 2 * G, 2, 200, 300, 100, D,
                               Dv, None))
    cases = []
    for label, B, H, Hkv, Sq, Skv, off, D, Dv, mode in shapes:
        BH, BHkv = B * H, B * Hkv
        q, k, v = rnd(BH, Sq, D), rnd(BHkv, Skv, D), rnd(BHkv, Skv, Dv)
        do = rnd(BH, Sq, Dv)
        if mode is None:
            sel = small_selection(g, BH, Sq, Skv)
            mask, extra = tile_mask(sel, Sq, Skv, off), ""
        else:
            sel, mask, keep = xa_tiles(q.view(B, H, Sq, D),
                                       k.view(B, Hkv, Skv, D), mode)
            extra = (f" block={mode.block} stride={mode.stride} "
                     f"threshold={mode.threshold} keep={keep} of "
                     f"{-(-Sq // mode.block)}")
        pairs = int(mask.sum())
        kw = dict(q_offset=off)
        n_bytes, flops = backward_work(BH, BHkv, Sq, Skv, D, pairs, it, Dv)
        dims = f"D={D}" if Dv == D else f"(Dk, Dv)=({D}, {Dv})"
        cases.append(dict(
            kernel="block_sparse_backward",
            label=f"{label} block_sparse BH={BH} G={H // Hkv} {dims} "
                  f"Sq={Sq} Skv={Skv} q_offset={off}{extra}",
            kern=lambda q=q, k=k, v=v, do=do, sel=sel, kw=kw:
                block_sparse_backward_bh(q, k, v, do, sel, **kw),
            plain=lambda q=q, k=k, v=v, do=do, sel=sel, kw=kw:
                block_sparse_backward_plain(q, k, v, do, sel, **kw),
            mutant=lambda q=q, k=k, v=v, do=do, sel=sel, kw=kw:
                block_sparse_backward_plain(q, k, zero_tile(v), do, sel,
                                            **kw),
            sdpa=sdpa_mask_train_call(q, k, v, do, mask),
            fwd_bwd=lambda q=q, k=k, v=v, do=do, sel=sel, kw=kw:
                fwd_bwd_call(block_sparse_attention_bh, q, k, v, do,
                             dict(kw, sel=sel)),
            flat=lambda out=None, q=q, k=k, v=v, do=do, sel=sel, kw=kw:
                flat_grads(block_sparse_backward_bh, (q, k, v, do, sel), kw,
                           out),
            plain_flat=lambda q=q, k=k, v=v, do=do, sel=sel, kw=kw:
                flat_grads(block_sparse_backward_plain, (q, k, v, do, sel),
                           kw),
            sizes=(q.numel(), k.numel(), v.numel()),
            bytes=n_bytes, flops=flops, pairs=pairs))
    return cases


def flat_grads(entry, args, kw, out=None):
    """``entry(*args, **kw)``'s (dq, dk, dv) as one flat tensor: with
    ``out`` (a flat buffer of their sizes), written in place into its
    views through the kernel entry's ``out=``, its scratch a NaN-filled
    ``stats=`` (so that a row the kernels read and never wrote shows in
    the gradients, the padding rows past Sq too), and returned."""
    q, k, v = args[:3]
    if out is None:
        return torch.cat([g.flatten() for g in entry(*args, **kw)])
    views = tuple(part.view(t.shape) for part, t in zip(
        out.split([q.numel(), k.numel(), v.numel()]), (q, k, v)))
    stats = torch.full((3, q.shape[0], -(-q.shape[1] // 64) * 64),
                       float("nan"), device=q.device)
    entry(*args, out=views, stats=stats, **kw)
    return out


def fwd_bwd_call(entry, q, k, v, do, kw):
    """The port's forward + backward: ``entry`` on copies of q, k, v that
    require grad (so it goes through the autograd function), then
    ``torch.autograd.grad`` (the backward kernel). ``kw`` holds the
    entry's keywords (a block-sparse selection as ``sel``)."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    return torch.autograd.grad(entry(q, k, v, **kw), (q, k, v), do)


def sdpa_train_call(q, k, v, do, B, H, Hkv, kw):
    """SDPA forward + backward at the same shapes, the yardstick: the
    flash backend when causal from position 0 or bidirectional, the
    efficient one with a boolean mask for streaming (sink + local) and for
    a causal call at a query offset. KV heads repeated for G > 1
    (``repeat_interleave``; the backward sums them)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    F = torch.nn.functional
    S, Skv, D, Dv = q.shape[1], k.shape[1], q.shape[2], v.shape[2]
    G = H // Hkv
    q4 = q.view(B, H, S, D).detach().requires_grad_()
    k4 = k.view(B, Hkv, Skv, D).detach().requires_grad_()
    v4 = v.view(B, Hkv, Skv, Dv).detach().requires_grad_()
    do4 = do.view(B, H, S, Dv)

    def rep(x):
        return x.repeat_interleave(G, dim=1) if G > 1 else x

    if "local" in kw:
        pos = torch.arange(S, device=q.device)
        mask = (pos[None] <= pos[:, None]) & (
            (pos[None] < kw["sink"])
            | (pos[:, None] - pos[None] < kw["local"]))
        backend, args = SDPBackend.EFFICIENT_ATTENTION, dict(attn_mask=mask)
    elif kw["causal"] and (S != Skv or kw.get("q_offset", 0)):
        # SDPA's is_causal aligns query 0 with key 0: a query offset needs
        # the mask written out
        pos = kw.get("q_offset", 0) + torch.arange(S, device=q.device)
        mask = torch.arange(Skv, device=q.device)[None] <= pos[:, None]
        backend, args = SDPBackend.EFFICIENT_ATTENTION, dict(attn_mask=mask)
    else:
        backend, args = SDPBackend.FLASH_ATTENTION, dict(
            is_causal=kw["causal"])

    if D != Dv and backend == SDPBackend.FLASH_ATTENTION:
        # the flash backend takes one head dim: a causal mask written out
        # for the efficient one
        pos = torch.arange(S, device=q.device)
        mask = (pos[None] <= pos[:, None]) if kw["causal"] else None
        backend, args = SDPBackend.EFFICIENT_ATTENTION, dict(attn_mask=mask)

    def call():
        with sdpa_kernel(backend):
            o = F.scaled_dot_product_attention(q4, rep(k4), rep(v4), **args)
        return torch.autograd.grad(o, (q4, k4, v4), do4)
    call.backend = backend.name.lower()
    return call


def sdpa_mask_train_call(q, k, v, do, mask):
    """SDPA forward + backward under a boolean mask (BH, Sq, Skv) of the
    flattened (BH, S, D) q over (BHkv, S, D) k and (BHkv, S, Dv) v, the
    yardstick of the block-sparse backward: the efficient backend, where
    it takes the shapes, else the math one (``call.backend`` names the
    one that served). KV heads repeated for G > 1."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    F = torch.nn.functional
    G = q.shape[0] // k.shape[0]
    q4 = q[None].detach().requires_grad_()
    k4, v4 = (x[None].detach().requires_grad_() for x in (k, v))
    do4, m4 = do[None], mask[None]

    def rep(x):
        return x.repeat_interleave(G, dim=1) if G > 1 else x

    def run(backend):
        with sdpa_kernel(backend):
            o = F.scaled_dot_product_attention(q4, rep(k4), rep(v4),
                                               attn_mask=m4)
        return torch.autograd.grad(o, (q4, k4, v4), do4)

    def call():
        if call.backend is None:  # the first call picks the backend
            try:
                out = run(SDPBackend.EFFICIENT_ATTENTION)
                call.backend = "efficient_attention"
                return out
            except RuntimeError:
                call.backend = "math"
        return run(SDPBackend.EFFICIENT_ATTENTION
                   if call.backend == "efficient_attention"
                   else SDPBackend.MATH)
    call.backend = None
    return call


def backward_report():
    """One line per instance of both backward libraries (flash and
    streaming's ``attention_backward``, ``block_sparse_backward``):
    registers, spill bytes and static shared memory from the compiler's
    report. The bf16 tensor-core instances (``*_wgmma_kernel``,
    ``csrc/backward_wgmma.cuh``) also give the dynamic shared memory a
    CTA asks for (the engine's ``Layout<Dk, Dv>``, as the flash library's
    ``flux_backward_smem_bytes`` answers it) and their SASS's tensor-core
    (HGMMA) and TMA-load (UTMALDG) counts, which must be > 0, with no
    spill; the fp32 ones ask for ``Tiles<Dk, Dv>``'s bytes
    (``csrc/backward_fp32.cuh``)."""
    from repro_torch.kernels import _build
    lines = []
    smem = ctypes.CDLL(str(_build.library_path(
        "attention_backward"))).flux_backward_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int] * 2, ctypes.c_int
    for source in ("attention_backward", "block_sparse_backward"):
        lib = _build.library_path(source)
        report = compiler_report(lib, "bwd")
        assert report, f"{source}: no compiler report at {lib.name}.log"
        sass = sass_counts(lib)
        for name, r in sorted(report.items()):
            kind = "dq" if "dq_" in name else "dkdv"
            dims = [int(d) for d in re.findall(r"Li(\d+)E", name)]
            D, Dv = (dims + [0, 0])[:2]
            pol = ("streaming" if "Streaming" in name else "block_sparse"
                   if "Sparse" in name else "flash")
            wd = f"D={D}" if Dv == D else f"(Dk, Dv)=({D}, {Dv})"
            if "wgmma_kernel" not in name:
                lines.append(f"{source} {kind} fp32 {wd} {pol}: "
                             f"registers={r.get('registers')} "
                             f"spill_stores/loads={r.get('spill')} bytes "
                             f"static_smem={r.get('smem')}")
                continue
            hgmma, tma, shapes = sass.get(name, (0, 0, []))
            assert hgmma > 0 and tma > 0, \
                f"{name}: HGMMA={hgmma} UTMALDG={tma}, not on the tensor " \
                f"cores"
            assert r.get("spill") == "0/0", f"{name}: spills {r.get('spill')}"
            lines.append(f"{source} {kind} bf16 wgmma {wd} {pol}: "
                         f"registers={r.get('registers')} "
                         f"spill_stores/loads={r.get('spill')} bytes "
                         f"static_smem={r.get('smem')} "
                         f"dynamic_smem={smem(D, Dv)} sass HGMMA={hgmma} "
                         f"{shapes} UTMALDG={tma}")
    return lines


def all_backward_cases(dev, dtype, main):
    """Both backward kernels' cases: ``backward_cases`` (flash and
    streaming) and ``sparse_backward_cases`` (block-sparse)."""
    return (backward_cases(dev, dtype, main)
            + sparse_backward_cases(dev, dtype, main))


def check_backward(dev):
    """Phase 3: both backward kernels (flash and streaming's, block-
    sparse's) against their plain versions' autograd: dq, dk and dv each
    held to the bf16 limit (rms per tensor) at the main shapes and the
    unaligned cases, where the plain gradients with one 64-key V tile
    zeroed must break it on dk; fp32 within FP32_TOL at the unaligned
    cases. Then ``refusal_checks``. Returns (lines, {label: (max abs err,
    limit ratios, zeroed-tile ratio on dk)})."""
    lines, errs = [], {}
    for main in (True, False):
        for c in all_backward_cases(dev, torch.bfloat16, main):
            label = c["label"]
            got, want = c["kern"](), c["plain"]()
            r = [bf16_ratios(a, b)[0] for a, b in zip(got, want)]
            r_mut = bf16_ratios(c["mutant"]()[1], want[1])[0]
            e = max(max_err(a, b) for a, b in zip(got, want))
            assert max(r) < 1, \
                f"{c['kernel']} {label}: dq/dk/dv at {r} of the limit"
            assert r_mut > 1, f"{c['kernel']} {label}: a zeroed V tile " \
                f"is within the limit on dk ({r_mut})"
            errs[label] = (e, r, r_mut)
            lines.append(f"{c['kernel']} bfloat16 {label} max_abs_err="
                         f"{e:.3e} limit_ratio dq/dk/dv={ratio_text(r)} "
                         f"zeroed_tile_ratio(dk)={r_mut:.2f}")
            del got, want
            free_card()
    for c in all_backward_cases(dev, torch.float32, False):
        e = max(max_err(a, b) for a, b in zip(c["kern"](), c["plain"]()))
        assert e < FP32_TOL, f"{c['kernel']} fp32 {c['label']}: max abs " \
            f"err {e}"
        lines.append(f"{c['kernel']} float32 {c['label']} max_abs_err="
                     f"{e:.3e} tol={FP32_TOL}")
    lines += refusal_checks(dev)
    return lines, errs


def refusal_checks(dev):
    """xa (``block_topk``) and flash / streaming at MLA's (192, 128) on the
    card with operands that require grad train: each output is recorded
    for autograd, ``torch.autograd.grad`` launches one backward kernel
    (block-sparse's for xa, the flash and streaming one else) and gives
    finite gradients; the same calls without grad launch no backward. A
    decode kernel still refuses an operand that requires grad (no
    training path runs one)."""
    import repro_torch.kernels as KN
    from repro_torch.core import modes as M
    from repro_torch.kernels.decode_attention import decode_attention_bh
    g = torch.Generator(device=dev).manual_seed(6)
    lines = []

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev,
                           dtype=torch.bfloat16).requires_grad_()

    q, k, v = (rnd(1, 2, 512, 96) for _ in range(3))
    qm, km, vm = rnd(1, 2, 256, MLA_DK), rnd(1, 2, 256, MLA_DK), \
        rnd(1, 2, 256, MLA_DV)
    xa = M.AttnMode("block_topk", sink=16, local=64, block=128, stride=16,
                    threshold=0.5)
    for label, call, bwd in (
            ("xa (block_topk)", lambda: M.attention(q, k, v, xa),
             "block_sparse_backward"),
            ("xa (block_topk) at (192, 128)",
             lambda: M.attention(qm, km, vm, xa), "block_sparse_backward"),
            ("flash (192, 128)", lambda: M.attention(qm, km, vm, M.FULL),
             "attention_backward"),
            ("streaming (192, 128)", lambda: M.attention(
                qm, km, vm, M.AttnMode("streaming", sink=16, local=64)),
             "attention_backward")):
        KN.reset_launch_counts()
        with torch.no_grad():
            assert bool(torch.isfinite(call()).all()), label
        out = call()
        ins = (qm, km, vm) if out.shape[-1] == MLA_DV else (q, k, v)
        grads = torch.autograd.grad(out, ins, torch.ones_like(out))
        counts = KN.launch_counts()
        assert counts[bwd] == 1 and sum(
            counts[n] for n in ("attention_backward",
                                "block_sparse_backward")) == 1, counts
        assert all(bool(torch.isfinite(x).all()) and bool(x.abs().max() > 0)
                   for x in grads), label
        lines.append(f"{label} with requires_grad trains: recorded for "
                     f"autograd, one {bwd} launch, finite nonzero "
                     f"gradients; without grad no backward")
    try:
        decode_attention_bh(q[0, :, :1].contiguous(),
                            k[0].detach().contiguous(),
                            v[0].detach().contiguous(),
                            torch.arange(512, dtype=torch.int32,
                                         device=dev), 9)
    except NotImplementedError as e:
        lines.append(f"the batch decode with requires_grad raises "
                     f"NotImplementedError: {e}")
    else:
        raise AssertionError("decode_attention trained through a kernel "
                             "with no backward")
    return lines


BWD_UNALIGNED_TIMED = "unaligned D=128 causal"  # phase 4's small row


def time_backward(dev, parent=None):
    """Phase 4: the backward kernel at every main shape (phi3-mini's
    training shapes, causal and streaming; stablelm-12b's; gemma3-12b's
    window; whisper's bidirectional encoder) and at the unaligned G = 4
    case's D = 128 causal row: device ms and call ms, the port's forward +
    backward (the entry under autograd, then ``torch.autograd.grad``),
    the bound, the plain version's ms, SDPA forward + backward and, with
    ``parent`` (a ``parent_backward`` callable), the other tree's kernel
    in the same process. Returns {label: row}."""
    rows = {}
    cases = all_backward_cases(dev, torch.bfloat16, True) + [
        c for c in backward_cases(dev, torch.bfloat16, False)
        if c["label"].startswith(BWD_UNALIGNED_TIMED)]
    for c in cases:
        label = c["label"]
        n_bytes, flops = c["bytes"], c["flops"]
        b_ms, b_by = bound(n_bytes, flops)
        rows[label] = r = dict(
            ms=time_ms(c["kern"], reps=3, rounds=3, warmup=1),
            call_ms=call_ms(c["kern"], reps=3, warmup=1),
            fwd_bwd_ms=time_ms(c["fwd_bwd"], reps=3, rounds=3, warmup=1),
            plain_ms=time_ms(c["plain"], reps=1, rounds=3, warmup=1),
            library_ms=time_ms(c["sdpa"], reps=3, rounds=3, warmup=1),
            library_backend=getattr(c["sdpa"], "backend", None),
            bound_ms=b_ms, bound_by=b_by)
        if parent is not None and c["kernel"] == "attention_backward":
            got, want = c["other"](parent), c["plain"]()
            r["parent_limit_ratios"] = [bf16_ratios(a, b)[0]
                                        for a, b in zip(got, want)]
            del got, want
            r["parent_ms"] = time_ms(lambda: c["other"](parent), reps=1,
                                     rounds=3, warmup=1)
        say(4, f"{c['kernel']} {label} ms={r['ms']:.4f} "
               f"call_ms={r['call_ms']:.4f} fwd_bwd_ms={r['fwd_bwd_ms']:.4f}"
               f" plain_ms={r['plain_ms']:.4f} sdpa_fwd_bwd_ms="
               f"{r['library_ms']:.4f} ({r['library_backend']}) "
               f"parent_ms={r.get('parent_ms')} "
               f"bound_ms={b_ms:.4f} ({b_by}; {n_bytes} bytes, {flops} "
               f"flops) roofline_share={b_ms / r['ms']:.4f}")
        free_card()
    return rows


def leaf_rel(a, b):
    """max |a - b| over max |b| (1e-30 where b is all zeros), in float64
    on ``a``'s device (the card's, where the CPU would take seconds a
    full-width leaf)."""
    a = a.detach().double()
    b = b.detach().to(a.device).double()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


class Rel(float):
    """A relative error that names the leaf it was read at."""
    leaf = ""

    def __format__(self, spec):
        return f"{float(self):{spec}}" + (f" ({self.leaf})" if self.leaf
                                          else "")


def tree_rel(a, b):
    """The largest ``leaf_rel`` over two trees' paired tensors, naming
    its leaf."""
    from repro_torch.train.checkpoint import flatten
    fa, fb = flatten(a), flatten(b)
    assert fa.keys() == fb.keys(), (sorted(fa)[:4], sorted(fb)[:4])
    worst = Rel(0.0)
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            r = leaf_rel(fa[k], fb[k])
            if r > worst:
                worst = Rel(r)
                worst.leaf = k
    return worst


def train_side(cfg, d, params, batches, noise, router_steps=None,
               backbone=True):
    """One device's side of phase 29 from ``params``: ``router_steps``
    (PARITY_ROUTER_STEPS by default) RouterTrainer steps (each step's
    metrics, router and λ gradients, the metrics after the update and the
    state without its frozen weights), then, with ``backbone``, one
    PretrainTrainer and one ContinuedTrainer step from ``params`` (loss,
    gradients, new state; the router checked bitwise unchanged), and each
    part's seconds. The batches and noise are the same on both sides."""
    router_steps = router_steps or PARITY_ROUTER_STEPS
    from repro_torch.train import (ContinuedTrainer, PretrainTrainer,
                                   RouterTrainer)
    from repro_torch.train.optimizer import tree_leaves

    def on(b):
        return [torch.as_tensor(np.asarray(x), device=d)
                for x in (b.tokens, b.labels, b.loss_mask, b.task_type)]

    def sync():
        if d.type == "cuda":
            torch.cuda.synchronize(d)

    out = {"router": []}
    rt = RouterTrainer(cfg, total_steps=TRAIN_SCHEDULE)
    state = rt.init(params, torch.Generator().manual_seed(1))
    for i in range(router_steps):
        t0 = time.perf_counter()
        _, m, gr, gl = rt.loss_and_grads(state, *on(batches[i]),
                                         gumbel=noise[i].to(d))
        state, m2 = rt.update(state, m, gr, gl)
        sync()
        out["router"].append((m, gr, gl, m2, {
            k: v for k, v in state.items() if k != "frozen"},
            time.perf_counter() - t0))
    if not backbone:
        return out
    for name, trainer in (("pretrain", PretrainTrainer(cfg, TRAIN_SCHEDULE)),
                          ("continued", ContinuedTrainer(cfg,
                                                         TRAIN_SCHEDULE))):
        i = PARITY_ROUTER_STEPS + (name == "continued")
        t0 = time.perf_counter()
        st = trainer.init(params)
        loss, m, grads = trainer.loss_and_grads(st, *on(batches[i])[:3],
                                                gumbel=noise[i].to(d))
        new, _ = (trainer.update(st, loss, m, grads) if name == "pretrain"
                  else trainer.update(st, m, grads))
        if name == "continued":
            assert all(torch.equal(a, b) for a, b in zip(
                tree_leaves(new["router"]), tree_leaves(st["router"]))), \
                "ContinuedTrainer moved the router"
        sync()
        out[name] = (loss, grads, new, time.perf_counter() - t0)
    return out


def resolved_moments(mu, tol=TRAIN_TOL):
    """{state path: bool mask} of the router parameters whose CPU first
    moment m is resolved, |m| above ``tol`` of its leaf's largest: where
    it is not, the card's and the CPU's m may differ in sign within the
    gradients' tolerance, and Adam's step lr·m̂/(√v̂ + eps) is then ±lr
    either way."""
    from repro_torch.train.checkpoint import flatten
    return {f"trainable/{k}": v.abs() > tol * v.abs().max()
            for k, v in flatten(mu).items()}


def state_rel(card, cpu, resolved):
    """``tree_rel`` of two router-training states, each parameter leaf
    of ``resolved`` compared on its resolved elements only (its moments
    everywhere). Returns (the error, the share of parameter elements
    left out)."""
    from repro_torch.train.checkpoint import flatten
    fa, fb = flatten(card), flatten(cpu)
    assert fa.keys() == fb.keys()
    worst, skipped, total = Rel(0.0), 0, 0
    for k in fa:
        a, b = fa[k], fb[k]
        if k in resolved:
            mask = resolved[k]
            total += mask.numel()
            skipped += int((~mask).sum())
            a, b = a[mask.to(a.device)], b[mask]
            if not a.numel():
                continue
        r = leaf_rel(a, b)
        if r > worst:
            worst = Rel(r)
            worst.leaf = k
    return worst, skipped / max(total, 1)


def router_step_lines(card, cpu, label=""):
    """Phase 29's comparison of two ``train_side`` runs' router steps:
    each step's loss, router and λ gradients and metrics, and the state
    after it (``state_rel``), within TRAIN_TOL relative to each leaf's
    largest CPU value. Returns the report lines."""
    lines, resolved = [], None
    for i, ((md, grd, gld, m2d, sd, td), (mc, grc, glc, m2c, sc, tc)) \
            in enumerate(zip(card, cpu)):
        mask = resolved_moments(sc["opt_router"].mu)
        resolved = mask if resolved is None else {  # at every step
            k: v & resolved[k] for k, v in mask.items()}
        st_err, left_out = state_rel(sd, sc, resolved)
        errs = dict(loss=leaf_rel(md["loss"], mc["loss"]),
                    router_grad=tree_rel(grd, grc),
                    lagrange_grad=tree_rel(gld, glc),
                    metrics=max(leaf_rel(m2d[k], m2c[k]) for k in m2c),
                    state=st_err)
        lines.append(
            f"{label}router step {i}: loss card={float(md['loss']):.6f} "
            f"cpu={float(mc['loss']):.6f} rel_err " + " ".join(
                f"{k}={v:.2e}" for k, v in errs.items())
            + f" (router parameters compared where the CPU's first "
              f"moment is resolved: {100 * left_out:.4f} % left out; "
              f"cpu {tc:.1f} s, card {td:.1f} s)")
        assert max(errs.values()) < TRAIN_TOL, lines[-1]
    return lines


def parity_cases(dev, cfg, p_dev):
    """Phase 29's router-step cases past phi3-mini's ssa one, card side:
    [(label, config, card params, batches, noise, card's ``train_side``
    output)], PARITY_XA_STEPS RouterTrainer steps each, fp32: phi3-mini
    (2 layers, ``p_dev``) under xa on PARITY_XA_S tokens, and phase 17's
    narrowed deepseek-v2 (its real per-head widths, (Dk, Dv) = (192,
    128)) under ssa and xa on PARITY_DS_S tokens, its flux window cut to
    sink PARITY_DS_SINK and local PARITY_DS_LOCAL so that SA differs
    from FA within them. xa runs at its published block 128 and
    threshold 0.9, which below 21 blocks keeps 2 a query block: the sink
    block and the diagonal one, which it forces. So no score decides the
    selection, and a near tie between two scores cannot select another
    block on the CPU (phase 19 holds the scored selection, card against
    CPU, in serving)."""
    from repro_torch.configs import get_config
    from repro_torch.core import modes as M
    from repro_torch.core.router import gumbel_noise
    from repro_torch.data import mixture_iterator
    from repro_torch.models.model import init_params, soft_layers
    fp32 = dict(dtype=torch.float32, param_dtype=torch.float32)
    ds = get_config(DEEPSEEK).replace(**DEEPSEEK_NARROW, **fp32)
    ds = ds.replace(flux=ds.flux.replace(sink=PARITY_DS_SINK,
                                         local=PARITY_DS_LOCAL))
    p_ds = init_params(ds, torch.Generator(device=dev).manual_seed(0), dev)
    out = []
    for label, c, p, S in (
            (f"{ARCH} xa ", sa_cfg(cfg, "xa"), p_dev, PARITY_XA_S),
            (f"{DEEPSEEK} narrowed ssa ", ds, p_ds, PARITY_DS_S),
            (f"{DEEPSEEK} narrowed xa ", sa_cfg(ds, "xa"), p_ds,
             PARITY_DS_S)):
        if c.flux.sa_mode == "xa":
            nkb = -(-S // c.flux.block)
            keep = M.xa_keep_blocks(nkb, c.flux.threshold)
            assert keep == 2 < nkb, (label, keep, nkb)
            label += f"(keeps {keep} of {nkb} blocks) "
        data = mixture_iterator(c.vocab_size, PARITY_B, S, seed=0)
        batches = [next(data) for _ in range(PARITY_XA_STEPS)]
        noise_gen = torch.Generator().manual_seed(7)
        noise = [gumbel_noise((len(soft_layers(c)), PARITY_B, 2),
                              noise_gen) for _ in batches]
        card = train_side(c, dev, p, batches, noise,
                          router_steps=PARITY_XA_STEPS, backbone=False)
        out.append((label + f"{S} tokens: ", c, p, batches, noise, card))
    return out


def train_parity(dev):
    """Phase 29: phi3-mini at full width with its depth cut to 2 layers, in
    fp32: the same weights, batches (``mixture_iterator``) and Gumbel
    noise (drawn once on the CPU) on the card and on the CPU
    (``train_side``): PARITY_ROUTER_STEPS RouterTrainer steps on PARITY_S
    tokens, one
    PretrainTrainer and one ContinuedTrainer step on PARITY_BACKBONE_S
    tokens; then ``parity_cases``' router steps (phi3-mini under xa,
    deepseek-v2 narrowed under ssa and xa). Compares each step's loss,
    router and λ gradients and metrics, and the state after it
    (``state_rel``), the pretrain and continued steps' loss, every weight
    gradient and the new state, each within TRAIN_TOL relative to its
    leaf's largest CPU value; returns the report lines."""
    from repro_torch.configs import get_config
    from repro_torch.core.router import gumbel_noise
    from repro_torch.data import mixture_iterator
    from repro_torch.models.model import init_params, params_to, soft_layers
    cfg = get_config(ARCH).replace(num_layers=2, dtype=torch.float32,
                                   param_dtype=torch.float32)
    p_dev = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    p_cpu = params_to(p_dev, torch.device("cpu"))
    data = mixture_iterator(cfg.vocab_size, PARITY_B, PARITY_S, seed=0)
    batches = [next(data) for _ in range(PARITY_ROUTER_STEPS)]
    data = mixture_iterator(cfg.vocab_size, PARITY_B, PARITY_BACKBONE_S,
                            seed=1)
    batches += [next(data) for _ in range(2)]
    noise_gen = torch.Generator().manual_seed(7)
    noise = [gumbel_noise((len(soft_layers(cfg)), PARITY_B, 2), noise_gen)
             for _ in batches]
    card = train_side(cfg, dev, p_dev, batches, noise)
    extra = parity_cases(dev, cfg, p_dev)
    cpu = train_side(cfg, torch.device("cpu"), p_cpu, batches, noise)
    lines = router_step_lines(card["router"], cpu["router"])
    for name in ("pretrain", "continued"):
        (ld, gd, nd, td), (lc, gc, nc, tc) = card[name], cpu[name]
        errs = dict(loss=leaf_rel(ld, lc), grad=tree_rel(gd, gc),
                    state=tree_rel(nd, nc))
        lines.append(f"{name} step: loss card={float(ld):.6f} rel_err "
                     + " ".join(f"{k}={v:.2e}" for k, v in errs.items())
                     + (" router bitwise unchanged"
                        if name == "continued" else "")
                     + f" (cpu {tc:.1f} s, card {td:.1f} s)")
        assert max(errs.values()) < TRAIN_TOL, lines[-1]
    for label, c, p, b, n, card_out in extra:
        cpu_out = train_side(
            c, torch.device("cpu"), p_cpu if p is p_dev else
            params_to(p, torch.device("cpu")), b, n,
            router_steps=PARITY_XA_STEPS, backbone=False)["router"]
        lines += router_step_lines(card_out["router"], cpu_out, label)
    return lines


def device_kernels_profile(fn, dev, top=PROFILE_TOP_OPS):
    """``fn`` once under torch.profiler: (wall ms, device busy ms, the
    ``top`` device kernels by their own device time as (name, calls,
    ms)). The hand-written kernels launch through ctypes, so they show as
    device kernels, not as aten operators."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    key = ("self_device_time_total"
           if rows and hasattr(rows[0], "self_device_time_total")
           else "self_cuda_time_total")
    busy = sum(getattr(e, key) for e in rows) / 1e3
    rows.sort(key=lambda e: -getattr(e, key))
    return (1e3 * wall, busy, [(e.key[:60], e.count, getattr(e, key) / 1e3)
                               for e in rows[:top]])


def train_launches(cfg, n_steps):
    """The kernels' launches of ``n_steps`` router-training steps with
    every layer recomputed (remat): at each routed layer the flash and SA
    forwards twice a step (the forward and its recompute; the SA one
    streaming, or block-sparse under xa) and a backward kernel each for
    FA and SA (attention_backward, or block_sparse_backward for xa's SA),
    but for the first routed layer, whose q, k and v need no gradient
    (the embedding and the backbone are frozen); at a local layer the
    window (streaming) twice; no other kernel."""
    import repro_torch.kernels as KN
    from repro_torch.models.model import soft_layers
    routed = soft_layers(cfg)
    n_local = sum(k == "local" for k in cfg.layer_kinds)
    xa = cfg.flux.sa_mode == "xa"
    want = dict.fromkeys(KN.KERNELS, 0)
    want["flash_attention"] = n_steps * 2 * len(routed)
    want["block_sparse_attention" if xa else "streaming_attention"] += \
        n_steps * 2 * len(routed)
    want["streaming_attention"] += n_steps * 2 * n_local
    n_bwd = n_steps * max(len(routed) - 1, 0)
    want["attention_backward"] = n_bwd * (1 if xa else 2)
    want["block_sparse_backward"] = n_bwd if xa else 0
    return want


def train_path(dev, params, cfg):
    """Phase 30: router training of phi3-mini-3.8b at full width (its depth
    TRAIN_LAYERS as ``main`` gives ``cfg``)
    in bf16 through ``launch/train.py``'s code path (``router_training``:
    RouterTrainer, λ from a generator, Gumbel noise from the card's
    generator): TRAIN_STEPS steps of a TRAIN_SCHEDULE-step schedule over
    ``mixture_iterator`` batches of TRAIN_B x TRAIN_S; each step's loss,
    ce, soft_msr, τ, λ and wall s; train tokens/s after the first step;
    peak memory; exact launch counts; then one more step's gradients
    under torch.profiler (finite, each routed layer's router gradient
    nonzero; the device's busy share and its top kernels); router
    parameters moved, the backbone bitwise unchanged; the checkpoint
    saved and loaded back bitwise; one request served through
    ``ServeEngine.generate`` with the trained routers. Returns (launch
    counts, lines, ``quiet``: the call that times the steps again once
    the parity worker has finished, giving its line)."""
    import repro_torch.kernels as KN
    from repro_torch.data import mixture_iterator
    from repro_torch.launch.train import router_training
    from repro_torch.models.model import router_param_filter
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import checkpoint
    from repro_torch.train.optimizer import partition, tree_leaves
    lines = []
    router0, backbone = partition(params, router_param_filter(params))
    router0 = [x.clone() for x in tree_leaves(router0)]
    backbone0 = [x.clone() for x in tree_leaves(backbone)]
    data = mixture_iterator(cfg.vocab_size, TRAIN_B, TRAIN_S, seed=0)
    stamps = [time.perf_counter()]
    logs = []

    def log(msg):
        stamps.append(time.perf_counter())
        logs.append(msg)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    KN.reset_launch_counts()
    rt, state, history = router_training(
        cfg, params, data, steps=TRAIN_STEPS, total_steps=TRAIN_SCHEDULE,
        log_every=1, log_fn=log)
    counts = KN.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    walls = np.diff(stamps)
    want = train_launches(cfg, TRAIN_STEPS)
    assert counts == want, (counts, want)
    tok = TRAIN_B * TRAIN_S
    for rec, wall in zip(history, walls):
        assert all(np.isfinite(rec[k]) for k in ("loss", "ce", "soft_msr"))
        lines.append(f"step {rec['step']}: loss={rec['loss']:.4f} "
                     f"ce={rec['ce']:.4f} soft_msr={rec['soft_msr']:.4f} "
                     f"tau={rec['tau']:.4f} lambda1={rec['lambda1']} "
                     f"lambda2={rec['lambda2']} wall_s={wall:.3f}")
    lines.append(f"train_tok_s={tok * (len(walls) - 1) / walls[1:].sum():.1f}"
                 f" (steps 1-{len(walls) - 1}, {tok} tokens a step) "
                 f"first_step_s={walls[0]:.3f} peak_mem_bytes={peak} "
                 f"launches({TRAIN_STEPS} steps)={counts}")

    batch = next(data)
    b = [torch.as_tensor(np.asarray(x), device=dev)
         for x in (batch.tokens, batch.labels, batch.loss_mask,
                   batch.task_type)]
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}

    def one_step():
        out["r"] = rt.loss_and_grads(state, *b, generator=gen)

    KN.reset_launch_counts()
    wall, busy, top = device_kernels_profile(one_step, dev)
    assert KN.launch_counts() == train_launches(cfg, 1)
    loss, _, g_router, g_lagrange = out["r"]
    assert bool(torch.isfinite(loss))
    n_routed = 0
    for i, layer in enumerate(g_router["layers"]):
        if "router" not in layer:
            continue
        n_routed += 1
        gs = list(layer["router"].values())
        assert all(bool(torch.isfinite(x).all()) for x in gs), i
        assert any(bool(x.abs().max() > 0) for x in gs), \
            f"layer {i}: router gradient is zero"
    assert all(bool(torch.isfinite(x).all()) for x in g_lagrange.values())
    lines.append(f"one step's gradients: {n_routed} routed layers, every "
                 f"router gradient finite and nonzero; wall_ms={wall:.1f} "
                 f"device_busy_ms={busy:.1f} busy_share={busy / wall:.3f} "
                 f"top_kernels=" + ", ".join(
                     f"{k} x{c} {ms:.1f} ms" for k, c, ms in top))
    out.clear()

    trained = rt.params(state)
    r1, bb = partition(trained, router_param_filter(trained))
    moved = sum(not torch.equal(a, b) for a, b in zip(tree_leaves(r1),
                                                      router0))
    assert moved > 0, "no router parameter moved"
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(bb),
                                                 backbone0)), \
        "the frozen backbone changed"
    lines.append(f"router leaves moved: {moved} of {len(router0)}; backbone "
                 f"({len(backbone0)} tensors) bitwise unchanged")
    del backbone0, router0, bb
    free_card()

    ck = ROOT / "artifacts" / "train" / f"{cfg.name}.pt"
    t0 = time.perf_counter()
    checkpoint.save(str(ck), trained)
    loaded = checkpoint.load(str(ck), trained)
    same = all(torch.equal(a, b) and a.dtype == b.dtype
               for a, b in zip(tree_leaves(loaded), tree_leaves(trained)))
    assert same, "checkpoint round trip is not bitwise"
    size = ck.stat().st_size
    ck.unlink()
    lines.append(f"checkpoint {size} bytes saved and loaded back bitwise "
                 f"[{time.perf_counter() - t0:.1f} s]")
    del trained
    free_card()

    KN.reset_launch_counts()
    eng = ServeEngine(loaded, cfg, max_len=PROMPT + GEN, prefill_chunk=CHUNK,
                      device=dev)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (1, PROMPT))
    gen_res = eng.generate(torch.as_tensor(prompt, device=dev), GEN)
    assert bool(torch.isfinite(gen_res.logits).all())
    assert bool(torch.isfinite(gen_res.final_logits).all())
    served = KN.launch_counts()
    assert served["attention_backward"] == 0, served
    lines.append(f"served 1 request of {PROMPT} tokens + {GEN} with the "
                 f"trained routers: routing={gen_res.routing} "
                 f"msr={gen_res.msr:.3f} launches={served}")
    del eng, loaded
    free_card()

    def quiet():
        """QUIET_STEPS more steps and one more profiled step's gradients,
        for when nothing else runs on the host (the parity worker shares
        it with the steps above): each step's wall s, and the
        profiled step's wall and busy ms."""
        torch.cuda.synchronize(dev)
        marks = [time.perf_counter()]
        _, recs = rt.run(state, data, QUIET_STEPS, log_every=1,
                         log_fn=lambda msg: marks.append(time.perf_counter()))
        assert all(np.isfinite(r["loss"]) for r in recs)
        walls = np.diff(marks)
        KN.reset_launch_counts()
        wall, busy, _ = device_kernels_profile(one_step, dev)
        assert KN.launch_counts() == train_launches(cfg, 1)
        out.clear()
        return (f"with the host to itself: steps wall_s="
                + "/".join(f"{w:.3f}" for w in walls)
                + f" train_tok_s={tok * len(walls) / sum(walls):.1f}; one "
                f"step's gradients profiled: wall_ms={wall:.1f} "
                f"device_busy_ms={busy:.1f} busy_share={busy / wall:.3f}")
    return counts, lines, quiet


TRAIN_CELL_STEPS = 3  # phase 30's xa and deepseek cells: steps each


def backbone_copy(params):
    """The frozen backbone's tensors on the host (a bitwise copy that
    leaves the card's memory to training), and the router's leaf count."""
    from repro_torch.models.model import router_param_filter
    from repro_torch.train.optimizer import partition, tree_leaves
    router, backbone = partition(params, router_param_filter(params))
    return ([x.to("cpu") for x in tree_leaves(backbone)],
            len(tree_leaves(router)))


def backbone_unchanged(params, saved):
    """Every backbone tensor of ``params`` bitwise equal to its host copy
    (``backbone_copy``), compared one tensor at a time on the card."""
    from repro_torch.models.model import router_param_filter
    from repro_torch.train.optimizer import partition, tree_leaves
    _, backbone = partition(params, router_param_filter(params))
    leaves = tree_leaves(backbone)
    return len(leaves) == len(saved) and all(
        torch.equal(x, y.to(x.device)) for x, y in zip(leaves, saved))


def train_cell(dev, params, cfg, label, steps, B, S, saved=None):
    """Phase 30's router-training cells past phi3-mini's: phi3-mini under
    xa, and deepseek-v2 at full width, DEEPSEEK_LAYERS layers, under ssa
    and xa. ``steps`` steps of B x S tokens through ``launch.train``'s
    ``router_training`` in bf16: each step's loss and wall, train tok/s
    after the first step, peak memory, exact launches
    (``train_launches``); one more step's gradients under the profiler
    (finite, every routed layer's router gradient nonzero; wall, the
    device's busy share, the backward kernels' device ms and their share
    of it); the backbone bitwise unchanged (``backbone_copy`` and
    ``backbone_unchanged``; given ``saved``, a copy the caller made, the
    caller checks it after its last cell). Returns (launch counts,
    lines)."""
    import repro_torch.kernels as KN
    from repro_torch.data import mixture_iterator
    from repro_torch.launch.train import router_training
    check = saved is None
    saved, n_router = saved or backbone_copy(params)
    data = mixture_iterator(cfg.vocab_size, B, S, seed=0)
    stamps, lines = [time.perf_counter()], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    KN.reset_launch_counts()
    rt, state, history = router_training(
        cfg, params, data, steps=steps, total_steps=TRAIN_SCHEDULE,
        log_every=1, log_fn=lambda msg: stamps.append(time.perf_counter()))
    counts = KN.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    walls = np.diff(stamps)
    want = train_launches(cfg, steps)
    assert counts == want, (label, counts, want)
    assert all(np.isfinite(r["loss"]) for r in history), label
    tok = B * S
    lines.append(
        f"{label}: {steps} steps of {B} x {S}: loss="
        + "/".join(f"{r['loss']:.4f}" for r in history)
        + " wall_s=" + "/".join(f"{w:.3f}" for w in walls)
        + f" train_tok_s={tok * (len(walls) - 1) / walls[1:].sum():.1f} "
        f"(steps 1-{len(walls) - 1}) peak_mem_bytes={peak} launches="
        + str({k: v for k, v in counts.items() if v}))
    batch = next(data)
    b = [torch.as_tensor(np.asarray(x), device=dev)
         for x in (batch.tokens, batch.labels, batch.loss_mask,
                   batch.task_type)]
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}

    def one_step():
        out["r"] = rt.loss_and_grads(state, *b, generator=gen)

    KN.reset_launch_counts()
    wall, busy, top = device_kernels_profile(one_step, dev, top=64)
    assert KN.launch_counts() == train_launches(cfg, 1), label
    loss, _, g_router, _ = out.pop("r")
    assert bool(torch.isfinite(loss)), label
    for i, layer in enumerate(g_router["layers"]):
        if "router" in layer:
            gs = list(layer["router"].values())
            assert all(bool(torch.isfinite(x).all()) for x in gs), (label, i)
            assert any(bool(x.abs().max() > 0) for x in gs), (label, i)
    bwd_ms = sum(ms for k, _, ms in top if "bwd::" in k)
    lines.append(
        f"{label}: one step's gradients profiled: wall_ms={wall:.1f} "
        f"device_busy_ms={busy:.1f} busy_share={busy / wall:.3f} "
        f"backward_kernels_ms={bwd_ms:.1f} "
        f"backward_share_of_busy={bwd_ms / max(busy, 1e-9):.3f} top_kernels="
        + ", ".join(f"{k} x{c} {ms:.1f} ms" for k, c, ms in top[:6]))
    if check:
        assert backbone_unchanged(rt.params(state), saved), \
            f"{label}: backbone moved"
        lines.append(f"{label}: backbone ({len(saved)} tensors) bitwise "
                     f"unchanged, {n_router} router leaves trained")
    del rt, state, g_router
    free_card()
    return counts, lines


def deepseek_xa_serve(dev, params, cfg):
    """One bf16 ``generate`` of deepseek-v2 (DEEPSEEK_LAYERS layers) under
    xa at the published block 128 (the monolithic prefill: flash at FA
    layers and the block-sparse kernel at (192, 128) at SA layers, then
    the latent decode), router-driven, 2 prompts of PROMPT tokens: every
    logit finite, exact launches. Returns (launch counts, line)."""
    from repro_torch.serve.engine import ServeEngine
    xcfg = sa_cfg(cfg, "xa")
    eng = ServeEngine(params, xcfg, max_len=PROMPT + GEN,
                      prefill_chunk=CHUNK, device=dev)
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                                (2, PROMPT))
    gen, delta = sa_batch(eng, prompts, ("sa",) * cfg.num_layers)
    want = {**dict.fromkeys(delta, 0),
            **prefill_launches(xcfg, [], [(gen.routing, PROMPT)]),
            **decode_launches(xcfg, GEN, pooled=False)}
    assert delta == want, (delta, want)
    assert delta["block_sparse_attention"] == cfg.num_layers, delta
    del eng
    free_card()
    return delta, (f"{DEEPSEEK} under xa (block 128, every layer SA), 2 x "
                   f"{PROMPT} + {GEN}, bf16: " + gen_text(gen, 2, PROMPT)
                   + " launches="
                   + str({k: v for k, v in delta.items() if v}))


def check_kernels(dev):
    """Phase 3: every kernel against its plain version on the card.
    Returns {arch: {kernel: max abs error at that arch's main shapes}}."""
    from repro_torch.configs import get_config
    errs = {}
    for arch in (ARCH, STABLELM, GRANITE, JAMBA, GEMMA3):
        cfg = get_config(arch)
        errs[arch] = {}
        for name, (kern, plain, mutant, *_rest) in kernel_cases(
                dev, torch.bfloat16, True, arch).items():
            out, want = kern(), plain()
            errs[arch][name] = e = max_err(out, want)
            slots = len(POOL_LENS) if name == "decode_attention_pooled" \
                else 1
            r = bf16_ratios(out, want, slots)
            r_mut = bf16_ratios(mutant(), want, slots)
            assert max(r) < 1, f"{arch} {name} bf16: error {r} of the limit"
            assert min(r_mut) > 1, f"{arch} {name} bf16: a zeroed tile is " \
                f"within the limit {r_mut}"
            say(3, f"{name} bfloat16 {arch} main shapes D={cfg.head_dim} "
                   f"G={cfg.num_heads // cfg.num_kv_heads} "
                   f"max_abs_err={e:.3e} limit_ratio={ratio_text(r)} "
                   f"zeroed_tile_ratio={ratio_text(r_mut)}")
    for D, G in ((128, 4), (160, 4), (64, 3), (256, 2)):
        for name, (kern, plain, *_rest) in kernel_cases(
                dev, torch.float32, False, small_d=D, small_g=G).items():
            out = kern()
            e = max_err(out, plain())
            assert e < FP32_TOL, \
                f"{name} fp32 G={G} D={D}: max abs err {e} >= {FP32_TOL}"
            extra = ""
            if name == "decode_attention_pooled":  # slot 0 holds nothing
                assert not bool(out[:2 * G].any()), \
                    "a length-0 slot is not zeros"
                extra = " length-0 slot rows all zero"
            say(3, f"{name} float32 G={G} D={D} unaligned max_abs_err="
                   f"{e:.3e} tol={FP32_TOL}{extra}")
    for name, check in (("decode_attention", ring_decode_check),
                        ("decode_attention_pooled", pooled_ring_check)):
        e, r, r_mut = check(dev)
        assert max(r) < 1, f"ring {name} bf16: error {r} of the limit"
        assert min(r_mut) > 1, f"ring {name} bf16: a zeroed tile is " \
            f"within the limit {r_mut}"
        say(3, f"{name} bfloat16 ring main shapes max_abs_err={e:.3e} "
               f"limit_ratio={ratio_text(r)} "
               f"zeroed_tile_ratio={ratio_text(r_mut)}")
    # jamba's attention layer (G = 8, D = 128) decoding over its SA ring
    e, r, r_mut = ring_decode_check(dev, JAMBA)
    assert max(r) < 1, f"{JAMBA} ring decode bf16: error {r} of the limit"
    assert min(r_mut) > 1, f"{JAMBA} ring decode bf16: a zeroed tile is " \
        f"within the limit {r_mut}"
    errs[JAMBA]["decode_attention_ring"] = e
    say(3, f"decode_attention bfloat16 {JAMBA} ring L=2176 D=128 G=8 "
           f"max_abs_err={e:.3e} limit_ratio={ratio_text(r)} "
           f"zeroed_tile_ratio={ratio_text(r_mut)}")
    # gemma3's local layers: the decode over a 1024-slot ring with no
    # sink, and the window (sink 0) over a whole prompt
    e, r, r_mut = ring_decode_check(dev, GEMMA3, window=True)
    assert max(r) < 1, f"{GEMMA3} local ring decode bf16: error {r}"
    assert min(r_mut) > 1, f"{GEMMA3} local ring decode bf16: a zeroed " \
        f"tile is within the limit {r_mut}"
    errs[GEMMA3]["decode_attention_local_ring"] = e
    say(3, f"decode_attention bfloat16 {GEMMA3} local ring L=1024 sink=0 "
           f"D=256 G=2 max_abs_err={e:.3e} limit_ratio={ratio_text(r)} "
           f"zeroed_tile_ratio={ratio_text(r_mut)}")
    kern, plain, mutant, *_ = window_case(dev)
    out, want = kern(), plain()
    errs[GEMMA3]["streaming_attention_window"] = e = max_err(out, want)
    r, r_mut = bf16_ratios(out, want), bf16_ratios(mutant(), want)
    assert max(r) < 1, f"{GEMMA3} window bf16: error {r} of the limit"
    assert min(r_mut) > 1, f"{GEMMA3} window bf16: a zeroed tile is " \
        f"within the limit {r_mut}"
    say(3, f"streaming_attention bfloat16 {GEMMA3} window sink=0 local=1024"
           f" over {PROMPT} tokens D=256 G=2 max_abs_err={e:.3e} "
           f"limit_ratio={ratio_text(r)} "
           f"zeroed_tile_ratio={ratio_text(r_mut)}")
    del out, want
    free_card()
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
    errs[DEEPSEEK] = {}
    for name, (kern, plain, mutant, _, _, _, slots) in mla_kernel_cases(
            dev, torch.bfloat16, True).items():
        out, want = kern(), plain()
        errs[DEEPSEEK][name] = e = max_err(out, want)
        r, r_mut = bf16_ratios(out, want, slots), \
            bf16_ratios(mutant(), want, slots)
        assert max(r) < 1, f"{DEEPSEEK} {name} bf16: error {r} of the limit"
        assert min(r_mut) > 1, f"{DEEPSEEK} {name} bf16: a zeroed tile is " \
            f"within the limit {r_mut}"
        say(3, f"{name} bfloat16 {DEEPSEEK} main shapes "
               f"{'(Dk, Dv)=(192, 128) G=1' if slots == 1 else 'R=512 rope=64 G=128 scale=192**-0.5'} "
               f"max_abs_err={e:.3e} limit_ratio={ratio_text(r)} "
               f"zeroed_tile_ratio={ratio_text(r_mut)}")
    for name, (kern, plain, *_rest, slots) in mla_kernel_cases(
            dev, torch.float32, False).items():
        out = kern()
        e = max_err(out, plain())
        assert e < FP32_TOL, f"{name} fp32 {DEEPSEEK}: max abs err {e}"
        extra = ""
        if slots > 1:  # slot 0 holds nothing
            assert not bool(out[:out.shape[0] // slots].any()), \
                "a length-0 slot is not zeros"
            extra = " ring with holes, length-0 slot rows all zero"
        say(3, f"{name} float32 {DEEPSEEK} small unaligned max_abs_err="
               f"{e:.3e} tol={FP32_TOL}{extra}")
    for line in mla_small_checks(dev):
        say(3, line)
    tp_errs, lines = mla_tp_checks(dev)
    for h, e in tp_errs.items():
        errs[DEEPSEEK][f"decode_attention_mla_{h}"] = e
    for line in lines:
        say(3, line)
    errs["sa_modes"] = sa_mode_checks(dev)
    errs[WHISPER], lines = side_kernel_checks(dev)
    for line in lines:
        say(3, line)
    errs["seq"], lines = seq_kernel_checks(dev)
    for line in lines + [long_block_sparse_check(dev)]:
        say(3, line)
    return errs


def time_kernels(dev, parent=None):
    """Phase 4: each kernel's times at phi3-mini's main shapes (with the
    ring rows and the n_split and tiles sweeps), at stablelm's (D = 160,
    G = 4), at granite's (D = 64, G = 3), at jamba's attention layer's
    (D = 128, G = 8, with its ring decode) and at deepseek's (the latent
    decode at MLA_SHAPES, beside ``parent``'s kernel when given). Returns
    {arch: {kernel: row}}."""
    from repro_torch.configs import get_config
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
    free_card()
    out = {ARCH: rows}
    for arch in (STABLELM, GRANITE, JAMBA, GEMMA3):
        cfg = get_config(arch)
        out[arch] = {}
        for name, (kern, plain, _, lib, n_bytes, flops) in kernel_cases(
                dev, torch.bfloat16, True, arch).items():
            b_ms, b_by = bound(n_bytes, flops)
            r = out[arch][name] = dict(
                ms=time_ms(kern), plain_ms=time_ms(plain),
                library_ms=time_ms(lib), bound_ms=b_ms, bound_by=b_by,
                call_ms=call_ms(kern))
            say(4, f"{name} {arch} D={cfg.head_dim} "
                   f"G={cfg.num_heads // cfg.num_kv_heads} ms={r['ms']:.4f} "
                   f"call_ms={r['call_ms']:.4f} plain_ms={r['plain_ms']:.4f}"
                   f" library_ms={r['library_ms']:.4f} bound_ms={b_ms:.4f} "
                   f"({b_by}; {n_bytes} bytes, {flops} flops) "
                   f"roofline_share={b_ms / r['ms']:.3f}")
        free_card()
    kern, plain, _, lib, n_bytes, flops = ring_decode_case(dev, JAMBA)
    b_ms, b_by = bound(n_bytes, flops)
    r = out[JAMBA]["decode_attention"]["ring"] = dict(
        ms=time_ms(kern), plain_ms=time_ms(plain), library_ms=time_ms(lib),
        bound_ms=b_ms, bound_by=b_by, call_ms=call_ms(kern))
    say(4, f"decode_attention {JAMBA} ring L=2176 D=128 G=8 "
           f"ms={r['ms']:.4f} call_ms={r['call_ms']:.4f} "
           f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
           f"bound_ms={b_ms:.4f} ({b_by}; {n_bytes} bytes, {flops} flops) "
           f"roofline_share={b_ms / r['ms']:.3f}")
    free_card()
    for key, label, case in (
            ("local_ring", "decode_attention local ring L=1024 sink=0",
             ring_decode_case(dev, GEMMA3, window=True)),
            ("window", f"streaming_attention window sink=0 local=1024 over "
                       f"{PROMPT} tokens", window_case(dev))):
        kern, plain, _, lib, n_bytes, flops = case
        b_ms, b_by = bound(n_bytes, flops)
        r = out[GEMMA3][label.split()[0]][key] = dict(
            ms=time_ms(kern), plain_ms=time_ms(plain, reps=2, rounds=3),
            library_ms=time_ms(lib), bound_ms=b_ms, bound_by=b_by,
            call_ms=call_ms(kern))
        say(4, f"{label} {GEMMA3} D=256 G=2 ms={r['ms']:.4f} "
               f"call_ms={r['call_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
               f"library_ms={r['library_ms']:.4f} bound_ms={b_ms:.4f} "
               f"({b_by}; {n_bytes} bytes, {flops} flops) "
               f"roofline_share={b_ms / r['ms']:.3f}")
        del case, kern, plain, lib
        free_card()
    out[DEEPSEEK] = {}
    cases = mla_kernel_cases(dev, torch.bfloat16, True)
    for name, (kern, plain, _, lib, n_bytes, flops, _) in cases.items():
        if name.startswith("decode_attention_mla"):  # time_mla's
            continue
        b_ms, b_by = bound(n_bytes, flops)
        r = out[DEEPSEEK][name] = dict(
            ms=time_ms(kern), plain_ms=time_ms(plain),
            library_ms=time_ms(lib), bound_ms=b_ms, bound_by=b_by,
            call_ms=call_ms(kern), sdpa_backends=sdpa_backends(lib))
        say(4, f"{name} {DEEPSEEK} ms={r['ms']:.4f} "
               f"call_ms={r['call_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
               f"library_ms={r['library_ms']:.4f} (sdpa backends "
               f"{r['sdpa_backends']}) bound_ms={b_ms:.4f} ({b_by}; "
               f"{n_bytes} bytes, {flops} flops) "
               f"roofline_share={b_ms / r['ms']:.3f}")
    del cases
    free_card()
    out[DEEPSEEK]["decode_attention_mla"] = time_mla(dev, parent)
    free_card()
    out["sa_modes"] = sa_mode_times(dev)
    free_card()
    out[WHISPER], lines = side_kernel_times(dev)
    for line in lines:
        say(4, line)
    out["seq"], lines = seq_kernel_times(dev)
    for line in lines:
        say(4, line)
    return out


def tp_parity_runs(dev, params, cfg, prompts, tp=None, frames=None):
    """Phase 31a's and 32a's runs on one engine (``tp`` a rank's group,
    or None on one device): ``generate`` of prompts[0] (with an encoder's
    ``frames`` (1, E, d)) and, for a model the slot pool serves (not an
    encoder's), a drain of prompts[:4] into 2 slots with prompts[4]
    arriving at priority 9 once a slot is taken, router-driven and mixed.
    Each generate run records every MoE call's experts (numpy: a rank's
    results cross a process boundary) and its smallest top-k gate gap
    (``MoeRecorder``). Returns host results."""
    from repro_torch.launch.serve import (PREFILL_CHUNKS_PER_TICK,
                                          routing_pattern)
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.scheduler import ContinuousScheduler
    N = TP_PARITY_N
    eng = ServeEngine(params, cfg, max_len=max(map(len, prompts)) + N,
                      prefill_chunk=CHUNK, device=dev, tp=tp)
    out = {}
    for name in ("router", "mixed"):
        ov = routing_pattern(cfg, name)
        with MoeRecorder() as rec:
            g = eng.generate(prompts[0][None], N, routing_override=ov,
                             encoder_frames=frames)
        out[name] = dict(tokens=g.tokens, routing=g.routing,
                         logits=g.logits.float().cpu().numpy(),
                         final=g.final_logits.float().cpu().numpy(),
                         experts=[tuple(t.numpy() for t in c)
                                  for c in rec.calls], min_gap=(
                             rec.min_gap() if rec.gaps else float("inf")))
        if frames is not None:
            continue  # the slot pool refuses a model with an encoder
        sched = ContinuousScheduler(
            eng, slots_per_bucket=2, chunk=4,
            prefill_chunks_per_tick=PREFILL_CHUNKS_PER_TICK)
        for rid in range(4):
            eng.submit(Request(rid=rid, tokens=prompts[rid], n_steps=N,
                               routing_override=ov))
        while not sched.n_active():
            eng.step()
        eng.submit(Request(rid=4, tokens=prompts[4], n_steps=N, priority=9,
                           routing_override=ov))
        out[f"{name} drain"] = {
            rid: (f.status, f.tokens.tolist(), f.routing,
                  f.metrics.preemptions)
            for rid, f in eng.drain().items()}
    return out


def tp_full_runs(dev, cfg, prompts, drain_prompts, tp):
    """Phase 31b on one rank: the full model's share (drawn layer by
    layer from the seed of every phase, ``init_params_tp``), then
    ``generate`` router-driven and mixed, the drain, and a decode step's
    all-reduces. Returns the rank's host results."""
    import repro_torch.kernels as KN
    from repro_torch.distributed.pool_sharding import cache_bytes
    from repro_torch.distributed.sharding import (init_params_tp,
                                                  tensor_parallel)
    from repro_torch.launch.serve import (PREFILL_CHUNKS_PER_TICK,
                                          routing_pattern)
    from repro_torch.models import model as MD
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.scheduler import ContinuousScheduler
    t0 = time.perf_counter()
    params = init_params_tp(cfg, torch.Generator(device=dev).manual_seed(0),
                            tp.rank, tp.world, dev)
    torch.cuda.synchronize()
    out = dict(rank=tp.rank, init_s=time.perf_counter() - t0,
               params_bytes=torch.cuda.memory_allocated(dev), runs={})
    eng = ServeEngine(params, cfg, max_len=TP_PROMPT + TP_GEN,
                      prefill_chunk=CHUNK, device=dev, tp=tp)
    mixed = routing_pattern(cfg, "mixed")
    torch.cuda.reset_peak_memory_stats(dev)
    KN.reset_launch_counts()
    for name in ("router", "mixed"):
        before = KN.launch_counts()
        g = eng.generate(prompts, TP_GEN,
                         routing_override=routing_pattern(cfg, name))
        assert bool(torch.isfinite(g.logits).all()), "first logits"
        assert bool(torch.isfinite(g.final_logits).all()), "last logits"
        delta = {k: v - before[k] for k, v in KN.launch_counts().items()}
        want = prefill_launches(cfg, [(g.routing, TP_PROMPT, 0)])
        want.update(decode_launches(cfg, TP_GEN, pooled=False))
        B = prompts.shape[0]
        out["runs"][name] = dict(
            tokens=g.tokens, routing=g.routing, launches=delta, want=want,
            prefill_tok_s=B * TP_PROMPT / g.prefill_s,
            decode_tok_s=B * TP_GEN / g.decode_s, kv_bytes=g.kv_bytes)
    before = KN.launch_counts()
    sched = ContinuousScheduler(
        eng, slots_per_bucket=TP_SLOTS, chunk=8,
        prefill_chunks_per_tick=PREFILL_CHUNKS_PER_TICK)
    for rid, toks in enumerate(drain_prompts):
        eng.submit(Request(rid=rid, tokens=toks, n_steps=TP_GEN,
                           routing_override=mixed))
    t0 = time.perf_counter()
    done = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delta = {k: v - before[k] for k, v in KN.launch_counts().items()}
    want = prefill_launches(cfg, sched.admissions)
    want.update(decode_launches(cfg, sum(p.steps for p in
                                         sched.pools.values()),
                                pooled=True))
    (pool,) = sched.pools.values()
    kv = cache_bytes(pool.caches, tp.world)
    out["runs"]["drain"] = dict(
        done={rid: (f.status, f.tokens.tolist()) for rid, f in done.items()},
        launches=delta, want=want, wall_s=wall,
        tok_s=sum(f.metrics.n_generated for f in done.values()) / wall,
        pattern=pool.pattern, kv_shard=kv.payload_shard, kv_global=kv.payload)
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    counts = KN.launch_counts()
    # a decode step's collectives after a chunked admission
    job = eng.prefill_chunked(prompts, mixed)
    tp.reset_counts()
    with tensor_parallel(tp):
        MD.decode_many(eng.params, eng.model_cfg, job.logits, job.caches,
                       TP_PROMPT, n_steps=4)
    out["collectives"] = (tp.reduce_calls, tp.reduce_bytes, 4)
    out["counts"] = counts
    return out


def tp_rank(tp, parity_prompts, prompts, drain_prompts):
    """Phase 31 on one rank (a spawned process): (a), then (b)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import init_params_tp
    dev = tp.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(ARCH).replace(num_layers=2, dtype=torch.float32,
                                   param_dtype=torch.float32)
    params = init_params_tp(cfg, torch.Generator(device=dev).manual_seed(0),
                            tp.rank, tp.world, dev)
    parity = tp_parity_runs(dev, params, cfg, parity_prompts, tp)
    del params
    free_card()
    return parity, tp_full_runs(
        dev, get_config(ARCH).replace(num_layers=TP_LAYERS), prompts,
        drain_prompts, tp)


def tp_parity_check(arch, one, ranks, drains=True):
    """Phase 31a's and 32a's comparison of each rank's ``tp_parity_runs``
    with the one-device runs: routing, tokens, every MoE call's experts
    and (``drains``) the drains' statuses, tokens, routing and
    preemptions equal, logits within FP32_TOL of the largest, a
    preemption in the mixed drain. Returns the report lines."""
    from repro_torch.launch.serve import routing_letters
    lines = []
    for name in ("router", "mixed"):
        want = one[name]
        errs = []
        for r, parity in enumerate(ranks):
            got = parity[name]
            assert got["routing"] == want["routing"], (arch, r, name)
            assert np.array_equal(got["tokens"], want["tokens"]), \
                (arch, r, name)
            assert len(got["experts"]) == len(want["experts"]), (arch, r)
            assert all(np.array_equal(a, b) for g, w in zip(
                got["experts"], want["experts"]) for a, b in zip(g, w)), \
                f"{arch} rank {r} {name}: an MoE call chose other experts"
            errs += [float(np.abs(got[k] - want[k]).max()
                           / np.abs(want[k]).max()) for k in ("logits",
                                                              "final")]
            if drains:
                d = parity[f"{name} drain"]
                assert d == one[f"{name} drain"], (arch, r, name)
                assert all(v[0] == "ok" for v in d.values()), d
        assert max(errs) < FP32_TOL, (arch, name, errs)
        line = (f"{name}: routing={routing_letters(want['routing'])} tokens "
                f"equal on the ranks and one device, logits rel err "
                f"{max(errs):.2e} (limit {FP32_TOL})")
        if want["experts"]:
            line += (f", {len(want['experts'])} MoE calls' experts equal "
                     f"(min top-k gap {want['min_gap']:.2e})")
        if drains:
            preempt = sum(v[3] for v in one[f"{name} drain"].values())
            if name == "mixed":
                assert preempt >= 1, f"{arch}: the mixed drain did not " \
                    f"preempt"
            line += (f"; drain of 5 on 2 slots: statuses, tokens and "
                     f"routing equal, preemptions={preempt}")
        lines.append(line)
    return lines


def tp_reduces(cfg):
    """A decode step's all-reduces under tensor parallelism: one at each
    attention or MLA layer and at each cross attention, one at each FFN
    or MoE, none at a Mamba block."""
    from repro_torch.models.model import has_ffn
    return sum((kind != "mamba") * (1 + bool(cfg.num_encoder_layers))
               + has_ffn(cfg, i) for i, kind in enumerate(cfg.layer_kinds))


def tp_full_check(cfg, fulls, B, must_launch):
    """Phase 31b's and 32b's checks of each rank's ``tp_full_runs`` of
    ``cfg`` (B prompts of TP_PROMPT tokens): exact launches, the ranks'
    tokens and routing alike, the drain's statuses, its pool's KV bytes
    (global = one device's pool; a rank holds 1/TP_WORLD of k / v and
    the whole of a latent cache), a decode step's all-reduces (2 x
    layers for these models, ``tp_reduces``) of (B, 1, d_model), each of
    ``must_launch`` launched. Returns (each rank's launches, report
    lines)."""
    from repro_torch.launch.serve import routing_letters, routing_pattern
    from repro_torch.serve import kv_cache as KC
    one_pool = KC.kv_cache_bytes(KC.init_decode_caches(
        cfg, routing_pattern(cfg, "mixed"), TP_SLOTS, TP_PROMPT + TP_GEN,
        "meta"))
    shard_pool = one_pool if cfg.use_mla else one_pool // TP_WORLD
    counts, lines = [], []
    first = fulls[0]
    for r, full in enumerate(fulls):
        for name in ("router", "mixed"):
            run = full["runs"][name]
            assert run["launches"] == run["want"], (r, name, run)
            assert run["routing"] == first["runs"][name]["routing"]
            assert np.array_equal(run["tokens"],
                                  first["runs"][name]["tokens"]), (r, name)
        drain = full["runs"]["drain"]
        assert drain["launches"] == drain["want"], (r, drain)
        assert drain["done"] == first["runs"]["drain"]["done"], r
        assert all(v[0] == "ok" for v in drain["done"].values())
        assert drain["kv_global"] == one_pool, (drain["kv_global"], one_pool)
        assert drain["kv_shard"] == shard_pool, (drain["kv_shard"],
                                                 shard_pool)
        calls, nbytes, steps = full["collectives"]
        assert calls == tp_reduces(cfg) * steps, (calls, cfg.num_layers)
        assert nbytes == calls * B * cfg.d_model * cfg.dtype.itemsize, \
            nbytes
        served = full["counts"]
        for k in must_launch:
            assert served[k] > 0, f"rank {r}: {k} never launched"
        counts.append(served)
        runs = full["runs"]
        lines.append(
            f"(b) {TP_LABEL}: rank {r} of {TP_WORLD}, {cfg.name} full width "
            f"({cfg.num_layers} layers) bf16, params share "
            f"{full['params_bytes']} bytes (drawn in {full['init_s']:.1f} "
            f"s), peak_mem_bytes={full['peak_mem_bytes']}; generate "
            f"{B} x {TP_PROMPT} + {TP_GEN}: " + "; ".join(
                f"{n} routing={routing_letters(runs[n]['routing'])} "
                f"prefill_tok_s={runs[n]['prefill_tok_s']:.0f} "
                f"decode_tok_s={runs[n]['decode_tok_s']:.1f} "
                f"launches={runs[n]['launches']}" for n in ("router",
                                                            "mixed"))
            + f"; drain {TP_REQUESTS} on {TP_SLOTS} slots: tok_s="
            f"{drain['tok_s']:.1f} wall_s={drain['wall_s']:.3f} "
            f"launches={drain['launches']} kv_shard_bytes="
            f"{drain['kv_shard']} kv_global_bytes={drain['kv_global']} "
            f"(one device {one_pool}); decode step all-reduces "
            f"{calls // steps} of {nbytes // calls} bytes")
    return counts, lines


SERVING_KERNELS = ("flash_attention", "streaming_attention",
                   "block_sparse_attention", "decode_attention",
                   "decode_attention_pooled")


def tp_phase(dev):
    """Phase 31: TP_WORLD ranks on the one card over gloo against the
    one-device port. Returns (each rank's launches, report lines)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.group import launch
    from repro_torch.models import model as MD
    from repro_torch.serve.engine import ServeEngine
    cfg2 = get_config(ARCH).replace(num_layers=2, dtype=torch.float32,
                                    param_dtype=torch.float32)
    params = MD.init_params(cfg2, torch.Generator(device=dev).manual_seed(0),
                            dev)
    probe = ServeEngine(params, cfg2, max_len=max(TP_PARITY_LENS),
                        prefill_chunk=CHUNK, device=dev)
    seed, parity_prompts, margin = router_margin_seed(probe, TP_PARITY_LENS)
    one = tp_parity_runs(dev, params, cfg2, parity_prompts)
    del probe, params
    free_card()
    cfg = get_config(ARCH).replace(num_layers=TP_LAYERS)
    rng = np.random.default_rng(31)
    prompts = rng.integers(0, cfg.vocab_size, (2, TP_PROMPT))
    drain_prompts = [rng.integers(0, cfg.vocab_size, n)
                     for n in TP_DRAIN_LENS]
    t0 = time.perf_counter()
    ranks = launch(tp_rank, TP_WORLD, "gloo",
                   args=(parity_prompts, prompts, drain_prompts),
                   device=dev.type)
    wall = time.perf_counter() - t0
    lines = [f"(a) {ARCH} 2 layers fp32, prompt_seed={seed} "
             f"min_margin={margin:.2e}"]
    lines += ["(a) " + line for line in tp_parity_check(
        ARCH, one, [parity for parity, _ in ranks])]
    served, full_lines = tp_full_check(cfg, [full for _, full in ranks],
                                       prompts.shape[0], SERVING_KERNELS)
    counts = {f"tp{TP_WORLD}_rank{r}": c for r, c in enumerate(served)}
    lines += full_lines
    lines.append(f"{TP_LABEL}: launch of {TP_WORLD} ranks {wall:.1f} s; "
                 f"these rates say nothing of TP speed over several cards")
    return counts, lines


def tp_arch_configs():
    """Phase 32a's models, fp32: granite-moe at full width and 2 layers,
    deepseek narrowed as in phase 17 (the latent decode is built only at
    deepseek's (R, rope) = (512, 64)), mamba2 at 2 layers, jamba's smoke
    variant (one period, as phase 25) and whisper at 2 encoder + 2
    decoder layers (as phase 21)."""
    from repro_torch.configs import get_config, smoke_variant
    fp32 = dict(dtype=torch.float32, param_dtype=torch.float32)
    return {
        GRANITE: get_config(GRANITE).replace(num_layers=2, **fp32),
        DEEPSEEK: get_config(DEEPSEEK).replace(**DEEPSEEK_NARROW, **fp32),
        MAMBA2: get_config(MAMBA2).replace(num_layers=2, **fp32),
        JAMBA: smoke_variant(get_config(JAMBA)),
        WHISPER: get_config(WHISPER).replace(num_layers=2,
                                             num_encoder_layers=2, **fp32)}


def tp_arch_seed(dev, params, cfg, lens):
    """Phase 32a's prompts for ``cfg`` and their one-device runs: the
    first seed whose router margins on the card exceed 1e-3 and whose
    generate runs keep every MoE top-k gate gap above MOE_GAP (a closer
    pair could choose another expert once the ranks sum in another
    order). Returns (seed, prompts, frames, router margin, gap,
    one-device results)."""
    from repro_torch.models import model as MD
    routed = bool(cfg.flux.enabled and cfg.routable_layers())
    for seed in range(MOE_SEEDS):
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
        frames = (side_inputs(cfg, 1, seed)["encoder_frames"]
                  if cfg.num_encoder_layers else None)
        side = ({} if frames is None else
                dict(encoder_frames=torch.as_tensor(frames, device=dev)))
        margin = float("inf")
        if routed:
            margin = min(float(np.abs(MD.prefill(
                params, cfg, torch.as_tensor(t[None, :CHUNK], device=dev),
                routing_ctx="hard_prefix", want_cache=False,
                **side).p_fa.numpy() - 0.5).min()) for t in prompts)
            if margin <= 1e-3:
                continue
        one = tp_parity_runs(dev, params, cfg, prompts, frames=frames)
        gap = min(one[n]["min_gap"] for n in ("router", "mixed"))
        if gap > MOE_GAP:
            return seed, prompts, frames, margin, gap, one
    raise AssertionError(f"{cfg.name}: no prompt seed with router margins "
                         f"> 1e-3 and top-k gaps > {MOE_GAP}")


def tp_arch_rank(tp, parity, prompts, drain_prompts, case_prompts,
                 seq_prompt):
    """Phase 32 on one rank (a spawned process): (a) each of
    ``tp_arch_configs``' models drawn as the rank's share and run as on
    one device, (c) the cases of ``tp_case_runs``, then (b) deepseek at
    full width, and phase 33 (``seq_runs``: the same ranks as a
    sequence-sharding group). Returns ((a)'s results by arch, the
    launches of (a) and (c), (b)'s results, (c)'s results, phase 33's
    results)."""
    import repro_torch.kernels as KN
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import init_params_tp
    dev = tp.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    KN.reset_launch_counts()
    out = {}
    for arch, cfg in tp_arch_configs().items():
        params = init_params_tp(cfg, torch.Generator(
            device=dev).manual_seed(0), tp.rank, tp.world, dev)
        toks, frames = parity[arch]
        out[arch] = tp_parity_runs(dev, params, cfg, toks, tp, frames)
        del params
        free_card()
    cases = tp_case_runs(dev, case_prompts, tp)
    counts = KN.launch_counts()
    full = tp_full_runs(
        dev, get_config(DEEPSEEK).replace(num_layers=DEEPSEEK_LAYERS),
        prompts, drain_prompts, tp)
    free_card()
    return out, counts, full, cases, seq_runs(dev, seq_prompt, tp)


def tp_case_configs():
    """Phase 32c's models, fp32 (smoke variants): phi3-mini's (4 heads
    over 4 KV heads, 2 layers) for the duo override and the probe drain,
    and command-r-plus's narrowed to one KV head, which the 2 ranks
    replicate (each holds it whole beside its 2 query heads)."""
    from repro_torch.configs import get_config, smoke_variant
    return {ARCH: smoke_variant(get_config(ARCH)),
            COMMAND_R: smoke_variant(get_config(COMMAND_R)).replace(
                num_kv_heads=1)}


def tp_case_runs(dev, prompts, tp=None):
    """Phase 32c on one engine set (``tp`` a rank's group, or None on
    one device), each model drawn from the seed of every phase: phi3's
    ``generate`` of prompts[ARCH][0] under ``TP_DUO`` at every layer
    (its prefill full attention, its decode the masked head split in
    plain torch: flash once a layer and no decode kernel) and a drain of
    its first 4 prompts into 2 slots with the fidelity probe on every
    admission (one flash a layer a probe besides the admissions'
    kernels); command-r's ``generate`` router-driven and mixed and the
    same drain (no probe). Each run's launches beside the exact counts
    it must give. Returns host results by run."""
    import repro_torch.kernels as KN
    from repro_torch.distributed.group import digest
    from repro_torch.distributed.sharding import init_params_tp
    from repro_torch.launch.serve import (PREFILL_CHUNKS_PER_TICK,
                                          routing_pattern)
    from repro_torch.models import model as MD
    from repro_torch.serve import kv_cache as KC
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.scheduler import ContinuousScheduler
    N = TP_PARITY_N
    out = {}

    def delta(before):
        return {k: v - before[k] for k, v in KN.launch_counts().items()}

    def drain(eng, cfg, toks, probe):
        sched = ContinuousScheduler(
            eng, slots_per_bucket=2, chunk=4,
            prefill_chunks_per_tick=PREFILL_CHUNKS_PER_TICK)
        before = KN.launch_counts()
        for rid in range(4):
            eng.submit(Request(rid=rid, tokens=toks[rid], n_steps=N))
        done = eng.drain()
        want = prefill_launches(cfg, sched.admissions)
        want.update(decode_launches(cfg, sum(
            p.steps for p in sched.pools.values()), pooled=True))
        n_attn = sum(k in ("attn", "local") for k in cfg.layer_kinds)
        want["flash_attention"] += eng._probe_admissions * n_attn
        kv = [t.cpu().numpy().tobytes() for pool in sched.pools.values()
              for c in pool.caches if isinstance(c, (KC.FullKV, KC.RingKV))
              for t in (c.k, c.v)]
        return dict(
            done={rid: (f.status, f.tokens.tolist(), f.routing,
                        f.metrics.preemptions) for rid, f in done.items()},
            fidelity={rid: (f.metrics.fidelity, f.metrics.fidelity_sa_min)
                      for rid, f in done.items()},
            probes=eng._probe_admissions, launches=delta(before),
            want=want, kv_digest=digest(*kv),
            probe_calls=None if tp is None else tp.probe_calls)

    for arch, cfg in tp_case_configs().items():
        gen = torch.Generator(device=dev).manual_seed(0)
        params = (MD.init_params(cfg, gen, dev) if tp is None else
                  init_params_tp(cfg, gen, tp.rank, tp.world, dev))
        toks = prompts[arch]
        probe = arch == ARCH
        eng = ServeEngine(params, cfg, max_len=max(map(len, toks)) + N,
                          prefill_chunk=CHUNK, device=dev, tp=tp,
                          fidelity_probe_every=int(probe))
        runs = (("duo", (TP_DUO,) * cfg.num_layers),) if probe else tuple(
            (n, routing_pattern(cfg, n)) for n in ("router", "mixed"))
        for name, ov in runs:
            before = KN.launch_counts()
            g = eng.generate(toks[0][None], N, routing_override=ov)
            if name == "duo":  # the repack's prefill: full attention
                want = prefill_launches(cfg, [], repacks=[(
                    ("fa",) * cfg.num_layers, len(toks[0]))])
                want.update(decode_launches(cfg, 0, pooled=False))
            else:
                want = prefill_launches(cfg, [(g.routing, len(toks[0]),
                                               0)])
                want.update(decode_launches(cfg, N, pooled=False))
            out[arch, name] = dict(
                tokens=g.tokens, routing=g.routing,
                logits=g.logits.float().cpu().numpy(),
                final=g.final_logits.float().cpu().numpy(),
                launches=delta(before), want=want)
        if tp is not None:
            tp.reset_counts()
        out[arch, "drain"] = drain(eng, cfg, toks, probe)
        del params, eng
        free_card()
    return out


def tp_case_check(one, ranks):
    """Phase 32c's comparison of each rank's ``tp_case_runs`` with the
    one-device runs: routing, tokens and statuses equal, logits within
    FP32_TOL of the largest, every request's coverage within 1e-5, each
    run's launches exact on every rank and on one device, the probe's
    reduces 2 a layer and one a routed layer a probe, and the replicated
    KV head's caches bitwise equal on both ranks. Returns the report
    lines."""
    from repro_torch.launch.serve import routing_letters
    cfgs = tp_case_configs()
    lines = []
    for key, want in one.items():
        arch, name = key
        cfg = cfgs[arch]
        assert want["launches"] == want["want"], (key, want)
        errs, cov = [0.0], [0.0]
        for r, res in enumerate(ranks):
            got = res[key]
            assert got["launches"] == got["want"] == want["want"], \
                (key, r, got["launches"], got["want"])
            if name != "drain":
                assert got["routing"] == want["routing"], (key, r)
                assert np.array_equal(got["tokens"], want["tokens"]), \
                    (key, r)
                errs += [float(np.abs(got[k] - want[k]).max()
                               / np.abs(want[k]).max())
                         for k in ("logits", "final")]
                continue
            assert got["done"] == want["done"], (key, r)
            assert all(v[0] == "ok" for v in got["done"].values())
            assert got["probes"] == want["probes"], (key, r)
            for rid, (fid, sa_min) in want["fidelity"].items():
                gf, gs = got["fidelity"][rid]
                assert (gf is None) == (fid is None), (key, r, rid)
                if fid is not None:
                    cov.append(abs(gf - fid))
                if sa_min is not None:
                    cov.append(abs(gs - sa_min))
            if got["probes"]:
                assert got["probe_calls"] == got["probes"] * (
                    2 * cfg.num_layers + len(cfg.routable_layers())), \
                    (key, r, got["probe_calls"])
            assert got["fidelity"] == ranks[0][key]["fidelity"], (key, r)
        assert max(errs) < FP32_TOL, (key, errs)
        assert max(cov) < 1e-5, (key, cov)
        head = (f"(c) {arch} smoke ({cfg.num_heads} heads over "
                f"{cfg.num_kv_heads} KV heads, fp32) {name}: ")
        if name != "drain":
            lines.append(head + (
                f"routing={routing_letters(want['routing'])} tokens equal "
                f"on the ranks and one device, logits rel err "
                f"{max(errs):.2e} (limit {FP32_TOL}), launches exact "
                f"{want['launches']}"))
            continue
        fids = [f for f, _ in want["fidelity"].values() if f is not None]
        line = (f"drain of 4 on 2 slots: statuses and tokens equal, "
                f"launches exact {want['launches']}")
        if want["probes"]:
            assert fids and min(fids) < 1 - 1e-3, fids
            line += (f"; {want['probes']} probes, coverage "
                     f"{min(fids):.4f}-{max(fids):.4f}, max diff "
                     f"{max(cov):.2e} (limit 1e-5), probe all-reduces "
                     f"{ranks[0][key]['probe_calls']} a rank")
        else:  # one KV head, held whole by both ranks
            assert all(res[key]["kv_digest"] == ranks[0][key]["kv_digest"]
                       for res in ranks), key
            line += "; both ranks' caches of the one KV head bitwise equal"
        lines.append(head + line)
    return lines


def seq_config():
    """Phase 33's model: phi3-mini at full width, 2 layers, fp32."""
    from repro_torch.configs import get_config
    return get_config(ARCH).replace(num_layers=2, dtype=torch.float32,
                                    param_dtype=torch.float32)


def seq_gathers(cfg, pattern, n_prompt, steps, shard, chunk=None):
    """A ``generate``'s collectives with sequence-sharded FA caches of
    ``shard`` slots a rank: (gathers, their bytes a rank, broadcasts):
    one gather of B·Hq·(D + 1) fp32 a FA layer a decode step; on each
    prefill chunk past the first, a broadcast of k and one of v a FA
    layer from each rank holding part of the live prefix."""
    from repro_torch.serve.engine import chunk_plan
    n_fa = sum(p == "fa" for p in pattern)
    bcasts = sum(2 * n_fa * -(-start // shard)
                 for start, _ in chunk_plan(n_prompt, chunk or CHUNK)[1:])
    calls = steps * n_fa
    return calls, calls * cfg.num_heads * (cfg.head_dim + 1) * 4, bcasts


def seq_runs(dev, prompt, tp=None):
    """Phase 33 on one engine: ``generate`` of ``prompt`` (SEQ_PROMPT
    tokens, TP_PARITY_N steps, chunk CHUNK) router-driven and mixed on
    phi3-mini's 2 layers in fp32 (whole weights from the seed of every
    phase), with ``tp`` (a rank's group) the FA caches cut along the
    sequence over the ranks from SEQ_MIN_SEQ slots on. Each run's
    launches beside the exact counts, its KV bytes and (``tp``) its
    collectives. Returns host results."""
    import repro_torch.kernels as KN
    from repro_torch.launch.serve import routing_pattern
    from repro_torch.models import model as MD
    from repro_torch.serve.engine import ServeEngine
    N = TP_PARITY_N
    cfg = seq_config()
    params = MD.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    eng = ServeEngine(params, cfg, max_len=SEQ_MAX_LEN, prefill_chunk=CHUNK,
                      device=dev, seq_shard=tp, min_seq=SEQ_MIN_SEQ)
    out = {}
    for name in ("router", "mixed"):
        before = KN.launch_counts()
        if tp is not None:
            tp.reset_counts()
        g = eng.generate(prompt[None], N,
                         routing_override=routing_pattern(cfg, name))
        n_fa = 0 if tp is None else sum(p == "fa" for p in g.routing)
        want = prefill_launches(cfg, [(g.routing, len(prompt), 0)])
        want.update(decode_launches(cfg, N, pooled=False,
                                    seq_sharded=n_fa))
        out[name] = dict(
            tokens=g.tokens, routing=g.routing,
            logits=g.logits.float().cpu().numpy(),
            final=g.final_logits.float().cpu().numpy(),
            launches={k: v - before[k]
                      for k, v in KN.launch_counts().items()},
            want=want, kv_bytes=g.kv_bytes, kv_shard_bytes=g.kv_shard_bytes,
            collectives=None if tp is None else (
                tp.gather_calls, tp.gather_bytes, tp.bcast_calls,
                tp.bcast_bytes, tp.reduce_calls))
    del eng, params
    free_card()
    return out


def seq_check(one, ranks, prompt_seed, margin):
    """Phase 33's comparison of each rank's ``seq_runs`` with the
    one-device run: routing and tokens equal, logits within FP32_TOL of
    the largest, each run's launches exact (the partial decode and the
    rank merge once a FA layer a step on each rank, the batch decode at
    the SA layers only), one gather a FA layer a step of B·Hq·(D + 1)
    fp32 and the prefill's broadcasts, no all-reduce, the global KV bytes
    one device's and each rank's FA bytes half of them. Returns (each
    rank's launches, report lines)."""
    from repro_torch.launch.serve import routing_letters
    cfg = seq_config()
    world = len(ranks)
    shard = SEQ_MAX_LEN // world
    lines = [f"(33) {ARCH} 2 layers fp32, FA caches of {SEQ_MAX_LEN} slots "
             f"cut in {world} shards of {shard} (min_seq {SEQ_MIN_SEQ}), "
             f"prompt {SEQ_PROMPT} tokens (seed {prompt_seed}, router "
             f"margin {margin:.2e}), {TP_PARITY_N} steps, chunk {CHUNK}"]
    counts = [collections.Counter() for _ in ranks]
    for name in ("router", "mixed"):
        want = one[name]
        assert want["launches"] == want["want"], (name, want["launches"])
        errs = []
        for r, res in enumerate(ranks):
            got = res[name]
            assert got["routing"] == want["routing"], (r, name)
            assert np.array_equal(got["tokens"], want["tokens"]), (r, name)
            assert got["launches"] == got["want"], (r, name, got)
            assert got["kv_bytes"] == want["kv_bytes"], (r, name)
            errs += [float(np.abs(got[k] - want[k]).max()
                           / np.abs(want[k]).max())
                     for k in ("logits", "final")]
            calls, nbytes, bcasts = seq_gathers(
                cfg, got["routing"], SEQ_PROMPT, TP_PARITY_N, shard)
            g_calls, g_bytes, b_calls, b_bytes, reduces = got["collectives"]
            assert (g_calls, g_bytes, b_calls, reduces) == \
                (calls, nbytes, bcasts, 0), (r, name, got["collectives"])
            n_fa = sum(p == "fa" for p in got["routing"])
            fa_bytes = n_fa * 2 * SEQ_MAX_LEN * cfg.num_kv_heads * \
                cfg.head_dim * 4
            assert got["kv_shard_bytes"] == want["kv_bytes"] - fa_bytes \
                + fa_bytes // world, (r, name, got["kv_shard_bytes"])
            counts[r].update(got["launches"])
        assert max(errs) < FP32_TOL, (name, errs)
        first = ranks[0][name]
        lines.append(
            f"(33) {name}: routing={routing_letters(want['routing'])} tokens "
            f"equal on the {world} ranks and one device, logits rel err "
            f"{max(errs):.2e} (limit {FP32_TOL}); launches exact on each "
            f"rank {first['launches']}; a rank's collectives: "
            f"{first['collectives'][0]} gathers of "
            f"{first['collectives'][1] // max(first['collectives'][0], 1)} "
            f"bytes, {first['collectives'][2]} prefill broadcasts of "
            f"{first['collectives'][3]} bytes in all, 0 all-reduces; "
            f"kv_bytes {first['kv_bytes']} global, {first['kv_shard_bytes']} "
            f"a rank")
    return [dict(c) for c in counts], lines


def tp_arch_phase(dev):
    """Phase 32: TP_WORLD ranks on the one card over gloo, spawned once:
    (a) the MoE, MLA, Mamba and encoder archs of ``tp_arch_configs`` in
    fp32 against the one-device port on the same weights; (c) the duo
    head split, the fidelity probe and KV replication (``tp_case_runs``)
    against the one-device port; (b) deepseek-v2-236b at full width,
    DEEPSEEK_LAYERS layers, bf16; and phase 33, sequence-sharded FA
    caches (``seq_runs``) against the one-device port. Returns (each
    rank's launches, report lines, phase 33's lines)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.group import launch
    from repro_torch.models import model as MD
    from repro_torch.serve.engine import ServeEngine
    parity, ones, lines = {}, {}, []
    for arch, cfg in tp_arch_configs().items():
        t0 = time.perf_counter()
        params = MD.init_params(cfg, torch.Generator(
            device=dev).manual_seed(0), dev)
        lens = (TP_WHISPER_LEN,) if cfg.num_encoder_layers else TP_ARCH_LENS
        seed, prompts, frames, margin, gap, ones[arch] = tp_arch_seed(
            dev, params, cfg, lens)
        parity[arch] = (prompts, frames)
        enc = cfg.num_encoder_layers
        lines.append(f"(a) {arch} ({cfg.num_layers} layers"
                     f"{f' + {enc} encoder' if enc else ''}"
                     f", d_model {cfg.d_model}, {cfg.num_heads} heads over "
                     f"{cfg.num_kv_heads}, fp32) one device: prompt_seed="
                     f"{seed} router_min_margin={margin:.2e} "
                     f"min_topk_gap={gap:.2e} "
                     f"[{time.perf_counter() - t0:.1f} s]")
        del params
        free_card()
    case_prompts = {}
    for arch, cfg in tp_case_configs().items():
        t0 = time.perf_counter()
        eng = ServeEngine(MD.init_params(cfg, torch.Generator(
            device=dev).manual_seed(0), dev), cfg,
            max_len=max(TP_ARCH_LENS), prefill_chunk=CHUNK, device=dev)
        seed, case_prompts[arch], margin = router_margin_seed(
            eng, TP_ARCH_LENS)
        lines.append(f"(c) {arch} smoke: prompt_seed={seed} "
                     f"router_min_margin={margin:.2e} "
                     f"[{time.perf_counter() - t0:.1f} s]")
        del eng
        free_card()
    case_one = tp_case_runs(dev, case_prompts)
    t0 = time.perf_counter()
    eng = ServeEngine(MD.init_params(seq_config(), torch.Generator(
        device=dev).manual_seed(0), dev), seq_config(),
        max_len=SEQ_MAX_LEN, prefill_chunk=CHUNK, device=dev)
    seq_seed, (seq_prompt,), seq_margin = router_margin_seed(
        eng, (SEQ_PROMPT,))
    del eng
    free_card()
    seq_one = seq_runs(dev, seq_prompt)
    seq_lines = [f"(33) one device: prompt_seed={seq_seed} "
                 f"[{time.perf_counter() - t0:.1f} s]"]
    cfg = get_config(DEEPSEEK).replace(num_layers=DEEPSEEK_LAYERS)
    rng = np.random.default_rng(32)
    prompts = rng.integers(0, cfg.vocab_size, (2, TP_PROMPT))
    drain_prompts = [rng.integers(0, cfg.vocab_size, n)
                     for n in TP_DRAIN_LENS]
    t0 = time.perf_counter()
    ranks = launch(tp_arch_rank, TP_WORLD, "gloo",
                   args=(parity, prompts, drain_prompts, case_prompts,
                         seq_prompt),
                   device=dev.type)
    wall = time.perf_counter() - t0
    for arch, cfg_a in tp_arch_configs().items():
        lines += [f"(a) {arch}: {line}" for line in tp_parity_check(
            arch, ones[arch], [a[arch] for a, *_ in ranks],
            drains=not cfg_a.num_encoder_layers)]
    lines += tp_case_check(case_one, [c for _, _, _, c, _ in ranks])
    seq_counts, more = seq_check(seq_one, [q for *_, q in ranks], seq_seed,
                                 seq_margin)
    seq_lines += more
    counts = {f"seq{TP_WORLD}_rank{r}": c for r, c in enumerate(seq_counts)}
    for r, (_, served, *_) in enumerate(ranks):
        for k in SERVING_KERNELS + ("decode_attention_mla",):
            assert served[k] > 0, f"(a) rank {r}: {k} never launched"
        counts[f"tp{TP_WORLD}_archs_rank{r}"] = served
    served, full_lines = tp_full_check(
        cfg, [full for _, _, full, *_ in ranks], prompts.shape[0],
        ("flash_attention", "streaming_attention", "decode_attention_mla"))
    counts.update({f"tp{TP_WORLD}_deepseek_rank{r}": c
                   for r, c in enumerate(served)})
    lines += full_lines
    lines.append(f"{TP_LABEL}: launch of {TP_WORLD} ranks {wall:.1f} s; "
                 f"these rates say nothing of TP speed over several cards")
    return counts, lines, seq_lines


# The host's cores while the paths run beside the parity worker: the
# worker's CPU threads and the main process's. The paths' host work, the
# card's driver and phase 31-32's ranks keep 2-3 cores busy, and an OpenMP
# team with more threads than free cores waits on its slowest at every
# barrier (a worker of 7 threads ran its phases at 46 % of their speed
# alone). Once the paths have ended the worker takes every core.
WORKER_THREADS, MAIN_THREADS = 5, 2


def parity_phases(dev, free_card=free_card):
    """Phases 5, 5b, 9, 9b, 13, 15, 17, 19, 21, 24, 25's card-against-CPU
    runs, 27 and 29: each model's card run against its CPU run on the
    same weights and inputs. They launch kernels only to compare them and
    spend most of their time on the host, so ``parity_worker`` runs them
    in a process of their own beside the main process's paths, whose
    launch counts they do not touch. ``free_card`` runs after each."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.launch.serve import ROUTINGS
    fp32 = dict(dtype=torch.float32, param_dtype=torch.float32)
    t0 = time.perf_counter()
    say(5, path_parity(dev), t0)
    t0 = time.perf_counter()
    say("5b", pool_parity(dev), t0)
    free_card()
    t0 = time.perf_counter()
    say(9, path_parity(dev, STABLELM), t0)
    free_card()
    t0 = time.perf_counter()
    say("9b", pool_parity(dev, STABLELM, cfg=get_config(STABLELM).replace(
        num_layers=1, **fp32)), t0)
    free_card()
    t0 = time.perf_counter()
    say(13, guarded_parity(dev), t0)
    free_card()
    t0 = time.perf_counter()
    for line in moe_path_parity(dev):
        say(15, line)
    say(15, f"{GRANITE} card = cpu done", t0)
    free_card()
    t0 = time.perf_counter()
    narrow = get_config(DEEPSEEK).replace(**DEEPSEEK_NARROW, **fp32)
    for line in moe_path_parity(dev, narrow):
        say(17, line)
    say(17, f"{DEEPSEEK} (per-head widths kept, {DEEPSEEK_NARROW}) card = "
            f"cpu done", t0)
    free_card()
    t0 = time.perf_counter()
    for line in sa_mode_parity(dev):
        say(19, line)
    say(19, "xa, ta, duo and head-split card = cpu done", t0)
    free_card()
    t0 = time.perf_counter()
    for line in side_parity(dev):
        say(21, line)
    say(21, f"{PHI3V} and {WHISPER} card = cpu done", t0)
    free_card()
    t0 = time.perf_counter()
    for line in ssd_parity(dev):
        say(24, line)
    say(24, f"{MAMBA2} SSD pieces card = cpu done", t0)
    free_card()
    t0 = time.perf_counter()
    cfg = get_config(MAMBA2).replace(num_layers=2, **fp32)
    say(25, f"{MAMBA2} 2 layers: " + path_parity(dev, cfg=cfg,
                                                 routings=("router",)))
    say(25, f"{MAMBA2} 2 layers: " + pool_parity(dev, cfg=cfg,
                                                 routings=("router",)))
    cfg = smoke_variant(get_config(JAMBA))
    say(25, f"{JAMBA} smoke: " + path_parity(dev, cfg=cfg,
                                             routings=ROUTINGS))
    say(25, f"{JAMBA} smoke: " + pool_parity(dev, cfg=cfg))
    say(25, f"{MAMBA2} (2 layers) and {JAMBA} smoke card = cpu done", t0)
    free_card()
    t0 = time.perf_counter()
    for line in gemma_parity(dev):
        say(27, f"{GEMMA3} smoke " + line)
    say(27, f"{GEMMA3} smoke card = cpu done", t0)
    free_card()
    t0 = time.perf_counter()
    for line in train_parity(dev):
        say(29, line)
    say(29, f"{ARCH} (2 layers, fp32) router, pretrain and continued "
            f"training card = cpu done", t0)
    free_card()


def parity_worker(paths_done):
    """The spawned parity process: ``parity_phases`` on the card with
    WORKER_THREADS CPU threads, and from the first phase after the main
    process sets ``paths_done`` with every core. Its lines go to the
    shared standard output; a failed check exits it non-zero, which
    ``run`` raises."""
    import os
    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(WORKER_THREADS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    widened = []

    def between():
        free_card()
        if paths_done.is_set() and not widened:
            widened.append(len(os.sched_getaffinity(0)))
            torch.set_num_threads(widened[0])
            say("5-29", f"the paths have ended: the worker takes "
                        f"{widened[0]} CPU threads")

    t0 = time.perf_counter()
    parity_phases(torch.device("cuda"), between)
    say("5-29", f"parity worker ({WORKER_THREADS} CPU threads beside the "
                f"paths) done", t0)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--parent"] and len(argv) == 2:
        parent_src = argv[1]
    elif argv:
        raise SystemExit("usage: python3 chip_smoke.py [--parent SRC]")
    else:
        parent_src = None
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False); it runs on an NVIDIA "
                         "GPU only")
    import signal
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    procs = []  # the parity worker, stopped however the run ends
    try:
        return run(parent_src, procs)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()


def run(parent_src, procs) -> int:
    import multiprocessing as mp
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
    for line in (wgmma_report(-(-(PROMPT + GEN) // 64)) + decode_report()
                 + mla_report() + backward_report()):
        say(2, line)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the card-against-CPU phases run in a process of their own beside the
    # paths below; phase 4 times the kernels once it has ended and the
    # card is idle
    t_parity = time.perf_counter()
    ctx = mp.get_context("spawn")
    paths_done = ctx.Event()
    worker = ctx.Process(target=parity_worker, args=(paths_done,),
                         name="parity", daemon=True)
    worker.start()
    procs.append(worker)
    threads = torch.get_num_threads()
    torch.set_num_threads(MAIN_THREADS)

    t0 = time.perf_counter()
    errs = check_kernels(dev)
    bwd_lines, bwd_errs = check_backward(dev)
    for line in bwd_lines:
        say(3, line)
    say(3, "kernels agree with their plain versions", t0)
    free_card()

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    cfg = get_config(ARCH)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    counts = {}
    t0 = time.perf_counter()
    counts["batch"], lines = main_path(dev, params, cfg)
    for line in lines:
        say(6, line)
    say(6, "batch path done", t0)
    free_card()

    t0 = time.perf_counter()
    counts["continuous"], lines = continuous_path(dev, params, cfg)
    for line in lines:
        say(7, line)
    say(7, "continuous path done", t0)
    free_card()

    t0 = time.perf_counter()
    counts["prefix"], lines = prefix_path(dev, params)
    for line in lines:
        say(8, line)
    say(8, "prefix path done", t0)
    del params  # phi3-mini's 7.6 GB leave the card before stablelm's
    free_card()

    cfg = get_config(STABLELM).replace(num_layers=STABLELM_LAYERS)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    torch.cuda.synchronize()
    say(10, f"{STABLELM} full width, depth cut to {cfg.num_layers} of "
            f"{get_config(STABLELM).num_layers} layers, "
            f"{cfg.param_count()} parameters, "
            f"{torch.cuda.memory_allocated(dev)} bytes on the card", t0)
    t0 = time.perf_counter()
    counts["stablelm_batch"], lines = main_path(dev, params, cfg)
    for line in lines:
        say(10, line)
    say(10, f"{STABLELM} batch path done", t0)
    free_card()

    t0 = time.perf_counter()
    counts["stablelm_continuous"], lines = continuous_path(dev, params, cfg)
    for line in lines:
        say(11, line)
    say(11, f"{STABLELM} continuous path done", t0)
    del params
    free_card()

    cfg = get_config(COMMAND_R).replace(num_layers=COMMAND_R_LAYERS)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    counts["command_r_batch"], lines = main_path(
        dev, params, cfg, requests=COMMAND_R_REQUESTS, routings=("mixed",))
    for line in lines:
        say(12, line)
    say(12, f"{COMMAND_R} at full width, depth cut to {COMMAND_R_LAYERS} "
            f"of {get_config(COMMAND_R).num_layers} layers "
            f"({cfg.param_count()} parameters): batch path done", t0)
    del params
    free_card()

    # phi3-mini's seeded weights again (phases 6-8 dropped them for
    # stablelm's and command-r's), GUARD_LAYERS of them
    cfg = get_config(ARCH).replace(num_layers=GUARD_LAYERS)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    counts["guardrails"], lines = guarded_path(dev, params, cfg)
    for line in lines:
        say(14, line)
    say(14, "guarded path done", t0)
    del params
    free_card()

    cfg = get_config(GRANITE).replace(num_layers=GRANITE_LAYERS)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    torch.cuda.synchronize()
    say(16, f"{GRANITE} full width, depth cut to {cfg.num_layers} of "
            f"{get_config(GRANITE).num_layers} layers ("
            f"{cfg.num_experts} experts top-{cfg.top_k}), "
            f"{cfg.param_count()} parameters "
            f"({cfg.param_count(active_only=True)} active a token), "
            f"{torch.cuda.memory_allocated(dev)} bytes on the card", t0)
    counts["granite_batch"], lines = main_path(dev, params, cfg)
    for line in lines:
        say(16, line)
    counts["granite_continuous"], lines = continuous_path(dev, params, cfg)
    for line in lines:
        say(16, "continuous " + line)
    say(16, moe_sampling(dev, params, cfg))
    say(16, f"{GRANITE} batch, continuous and sampled paths done", t0)
    del params
    free_card()

    cfg = get_config(DEEPSEEK).replace(num_layers=DEEPSEEK_LAYERS)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    torch.cuda.synchronize()
    say(18, f"{DEEPSEEK} at full width, depth cut to {DEEPSEEK_LAYERS} of "
            f"{get_config(DEEPSEEK).num_layers} layers ({cfg.num_experts} "
            f"experts top-{cfg.top_k} + {cfg.num_shared_experts} shared, "
            f"MLA R {cfg.kv_lora_rank} rope {cfg.qk_rope_head_dim}), "
            f"{cfg.param_count()} parameters "
            f"({cfg.param_count(active_only=True)} active a token), "
            f"{torch.cuda.memory_allocated(dev)} bytes on the card", t0)
    counts["deepseek_batch"], lines = main_path(dev, params, cfg)
    for line in lines:
        say(18, line)
    counts["deepseek_continuous"], lines = continuous_path(dev, params, cfg)
    for line in lines:
        say(18, "continuous " + line)
    say(18, mla_prefix_hit(dev, params, cfg))
    counts["deepseek_xa_batch"], line = deepseek_xa_serve(dev, params, cfg)
    say(18, line)
    say(18, f"{DEEPSEEK} batch, continuous, prefix and xa paths done", t0)
    free_card()
    # phase 30b: router training of deepseek-v2 on phase 18's weights
    t0 = time.perf_counter()
    saved = backbone_copy(params)  # 34 GB to the host once, for both
    for mode in ("ssa", "xa"):
        c, lines = train_cell(dev, params, sa_cfg(cfg, mode),
                              f"{DEEPSEEK} {mode}", TRAIN_CELL_STEPS,
                              TRAIN_B, DEEPSEEK_TRAIN_S, saved)
        counts[f"deepseek_train_{mode}"] = c
        for line in lines:
            say("30b", line)
    # each cell trains its own router state over the backbone the two
    # share, which must still be bitwise the one drawn
    assert backbone_unchanged(params, saved[0]), "deepseek backbone moved"
    say("30b", f"backbone ({len(saved[0])} tensors) bitwise unchanged "
               f"after both cells, {saved[1]} router leaves trained")
    del saved
    say("30b", f"{DEEPSEEK} router training at full width, depth cut to "
               f"{DEEPSEEK_LAYERS} layers, under ssa and xa done", t0)
    del params
    free_card()

    cfg = get_config(ARCH).replace(num_layers=SA_MODES_LAYERS)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    sa_counts, lines = sa_mode_paths(dev, params, cfg)
    counts.update(sa_counts)
    for line in lines:
        say(20, line)
    say(20, "xa, ta and duo paths done", t0)
    del params
    free_card()

    cfg = get_config(PHI3V)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    torch.cuda.synchronize()
    say(22, f"{PHI3V} full width and depth ({cfg.num_layers} layers, "
            f"{cfg.num_prefix_tokens} prefix embeddings), "
            f"{cfg.param_count()} parameters, "
            f"{torch.cuda.memory_allocated(dev)} bytes on the card", t0)
    counts["phi3_vision"], _, lines = side_path(
        dev, params, cfg, PHI3V_PROMPT, PROMPT + GEN)
    for line in lines:
        say(22, line)
    say(22, f"{PHI3V} batch path done", t0)
    del params
    free_card()

    cfg = get_config(WHISPER)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    torch.cuda.synchronize()
    say(23, f"{WHISPER} full width and depth ({cfg.num_encoder_layers} "
            f"encoder + {cfg.num_layers} decoder layers over "
            f"{cfg.encoder_ctx} frames, tied vocabulary "
            f"{cfg.vocab_size}), {cfg.param_count()} parameters, "
            f"{torch.cuda.memory_allocated(dev)} bytes on the card", t0)
    counts["whisper"], side_launches, lines = side_path(
        dev, params, cfg, WHISPER_PROMPT, WHISPER_MAX_LEN,
        requests=WHISPER_REQUESTS)
    for line in lines:
        say(23, line)
    say(23, f"{WHISPER} batch path done", t0)
    del params
    free_card()

    from repro_torch.configs import smoke_variant
    from repro_torch.launch.serve import ROUTINGS
    t0 = time.perf_counter()
    # jamba's smoke variant in bf16 on the card: exact counts of the five
    # kernels (its attention layer) under every routing and in the pool
    cfg = smoke_variant(get_config(JAMBA)).replace(
        dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    jamba_counts, lines = main_path(dev, params, cfg, routings=ROUTINGS)
    for line in lines:
        say(25, f"{JAMBA} smoke bf16 batch " + line)
    cont, lines = continuous_path(dev, params, cfg)
    for line in lines:
        say(25, f"{JAMBA} smoke bf16 continuous " + line)
    counts["jamba_smoke"] = {k: v + cont[k] for k, v in jamba_counts.items()}
    assert all(counts["jamba_smoke"][k] > 0 for k in (
        "flash_attention", "streaming_attention", "block_sparse_attention",
        "decode_attention", "decode_attention_pooled"))
    del params
    say(25, f"{JAMBA} smoke's launches done", t0)
    free_card()

    cfg = get_config(MAMBA2).replace(num_layers=MAMBA2_LAYERS)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    torch.cuda.synchronize()
    say(26, f"{MAMBA2} full width, depth cut to {cfg.num_layers} of "
            f"{get_config(MAMBA2).num_layers} layers ("
            f"d_model {cfg.d_model}, {cfg.ssm_num_heads} SSM heads of "
            f"{cfg.ssm_head_dim}, state {cfg.ssm_state_dim}), "
            f"{cfg.param_count()} parameters, "
            f"{torch.cuda.memory_allocated(dev)} bytes on the card", t0)
    counts["mamba2"], lines = mamba_cells(dev, params, cfg)
    for line in lines:
        say(26, line)
    say(26, f"{MAMBA2} batch, continuous and prefix cells done", t0)
    del params
    free_card()

    t0 = time.perf_counter()
    tp_counts, lines = tp_phase(dev)
    counts.update(tp_counts)
    for line in lines:
        say(31, line)
    say(31, f"tensor-parallel serving, {TP_LABEL}, done", t0)
    free_card()

    t0 = time.perf_counter()
    tp_counts, lines, seq_lines = tp_arch_phase(dev)
    counts.update(tp_counts)
    for line in lines:
        say(32, line)
    for line in seq_lines:
        say(33, line)
    for r in range(TP_WORLD):
        for k in ("decode_attention_partial", "decode_merge_ranks"):
            assert counts[f"seq{TP_WORLD}_rank{r}"][k] > 0, (r, k)
    say(32, f"tensor-parallel MoE, MLA, Mamba and encoder archs and (33) "
            f"sequence-sharded FA caches, {TP_LABEL}, done", t0)
    free_card()

    cfg = get_config(GEMMA3).replace(num_layers=GEMMA3_LAYERS)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    torch.cuda.synchronize()
    say(28, f"{GEMMA3} full width, depth cut to {cfg.num_layers} of "
            f"{get_config(GEMMA3).num_layers} layers ({cfg.num_layers}: "
            f"{cfg.layer_kinds.count('local')} local with a window of "
            f"{cfg.sliding_window}, {len(cfg.routable_layers())} routed; "
            f"D {cfg.head_dim}, {cfg.num_heads} heads over "
            f"{cfg.num_kv_heads}), {cfg.param_count()} parameters, "
            f"{torch.cuda.memory_allocated(dev)} bytes on the card", t0)
    gemma_counts, lines = gemma_cells(dev, params, cfg)
    for line in lines:
        say(28, line)
    for cell, c in gemma_counts.items():
        counts[f"gemma3_{cell}"] = c
    assert all(gemma_counts["batch"][k] > 0 for k in (
        "flash_attention", "streaming_attention", "block_sparse_attention",
        "decode_attention"))
    assert gemma_counts["continuous"]["decode_attention_pooled"] > 0
    say(28, f"{GEMMA3} batch, continuous and prefix cells done", t0)
    del params
    free_card()

    cfg = get_config(ARCH).replace(num_layers=TRAIN_LAYERS)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    counts["train"], lines, train_quiet = train_path(dev, params, cfg)
    for line in lines:
        say(30, line)
    say(30, f"{ARCH} router training at full width, depth cut to "
            f"{cfg.num_layers} of {get_config(ARCH).num_layers} layers "
            f"(bf16, {TRAIN_STEPS} steps of {TRAIN_B} x {TRAIN_S}) done",
        t0)
    del params
    free_card()
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    counts["train_xa"], lines = train_cell(
        dev, params, sa_cfg(cfg, "xa"), f"{ARCH} xa", TRAIN_CELL_STEPS,
        TRAIN_B, TRAIN_S)
    for line in lines:
        say(30, line)
    say(30, f"{ARCH} router training under xa at full width and depth "
            f"({cfg.num_layers} layers) done", t0)
    del params
    free_card()
    t0 = time.perf_counter()
    stressed, stress_kernel = stress(dev)
    for label, c in stressed.items():
        say("2b", f"{label}: {c['calls']} calls ({c['nan_prefilled']} into "
                  f"a NaN-filled out) nonfinite_outputs="
                  f"{c['nonfinite_outputs']} past_limit={c['past_limit']} "
                  f"[{c['seconds']:.1f} s]")
    bad = {k: c for k, c in stressed.items()
           if c["nonfinite_outputs"] or c["past_limit"]}
    assert not bad, f"stress: outputs non-finite or past the limit: {bad}"
    say("2b", f"{len(stressed)} wgmma instances x {STRESS_CALLS} calls: no "
              f"non-finite output, no element past the limit", t0)
    free_card()
    paths_done.set()
    t0 = time.perf_counter()
    worker.join()
    if worker.exitcode != 0:
        raise SystemExit(f"chip_smoke: the parity worker (phases 5-29) "
                         f"failed with exit code {worker.exitcode}")
    say("5-29", f"the paths waited {time.perf_counter() - t0:.1f} s for "
                f"the parity worker", t_parity)
    torch.set_num_threads(threads)

    t0 = time.perf_counter()
    parent = None
    if parent_src is not None:
        from repro_torch.kernels.sass_diff import other_libraries
        parent = other_libraries(Path(parent_src))
    rows = time_kernels(dev, None if parent is None else parent_mla(parent))
    free_card()
    bwd_rows = time_backward(
        dev, None if parent is None else parent_backward(parent))
    free_card()
    say(4, f"timed at {card}", t0)
    t0 = time.perf_counter()
    say(30, train_quiet(), t0)
    del train_quiet
    free_card()

    import repro_torch.kernels as KN
    kernels = []
    for name, replaces in REPLACES.items():
        src = _build.CSRC / f"{KN.KERNELS[name].source}.cu"
        stress_counts = {k: c for k, c in stressed.items()
                         if stress_kernel[k] == name}
        if name == "decode_attention_mla":  # deepseek's paths only
            mla = rows[DEEPSEEK][name]
            kernels.append(dict(
                name=name, route="cuda", source=str(src.relative_to(ROOT)),
                replaces=replaces, launches=counts["deepseek_batch"][name],
                launches_by_path={k: c[name] for k, c in counts.items()},
                **{**mla["pool"], "max_abs_err": errs[DEEPSEEK][name]},
                ring={**mla["ring"],
                      "max_abs_err": errs[DEEPSEEK][f"{name}_ring"]},
                # a tensor-parallel rank's heads (phase 32: 64 at TP 2)
                tp_heads={f"h{H}": {
                    **mla[f"pool_h{H}"],
                    "max_abs_err": errs[DEEPSEEK][f"{name}_h{H}"]}
                    for H in MLA_TP_HEADS},
                long_context=mla["long_context"],
                high_batch=mla["high_batch"], stress=stress_counts))
            continue
        if name in rows["seq"]:  # phase 33's ranks: rank 0's launches
            kernels.append(dict(
                name=name, route="cuda", source=str(src.relative_to(ROOT)),
                replaces=replaces,
                launches=counts[f"seq{TP_WORLD}_rank0"][name],
                launches_by_path={k: c.get(name, 0)
                                  for k, c in counts.items()},
                max_abs_err=errs["seq"][name], **rows["seq"][name],
                stress={}))
            continue
        # each kernel's count from the path it was ported for: the batch
        # path for the first four, the slot pool for the pooled decode
        own = "continuous" if name == "decode_attention_pooled" \
            else "batch"
        kernels.append(dict(
            name=name, route="cuda", source=str(src.relative_to(ROOT)),
            replaces=replaces, launches=counts[own][name],
            launches_by_path={k: c[name] for k, c in counts.items()},
            max_abs_err=errs[ARCH][name], **rows[ARCH][name],
            stablelm_12b=dict(launches=counts[f"stablelm_{own}"][name],
                              max_abs_err=errs[STABLELM][name],
                              **rows[STABLELM][name]),
            granite_moe_3b_a800m=dict(
                launches=counts[f"granite_{own}"][name],
                max_abs_err=errs[GRANITE][name], **rows[GRANITE][name]),
            # full-width jamba does not fit one card: its attention
            # layer's shapes are held and timed in phases 3 and 4 only
            jamba_1_5_large_398b=dict(
                launches=None, launches_note="phase 3 / 4 only",
                max_abs_err=errs[JAMBA][name], **rows[JAMBA][name]),
            gemma3_12b=dict(launches=counts[f"gemma3_{own}"][name],
                            max_abs_err=errs[GEMMA3][name],
                            **rows[GEMMA3][name]),
            stress=stress_counts))
        # gemma3's local layers: the decode over the 1024-slot ring, and
        # the window over a whole prompt (the monolithic admission's
        # shape; on the chunked path the window runs at the route chunk,
        # counted in gemma3_12b's streaming launches)
        for key in ("local_ring", "window"):
            if key in rows[GEMMA3][name]:
                kernels[-1]["gemma3_12b"][key]["max_abs_err"] = \
                    errs[GEMMA3][f"{name}_{key}"]
        if name == "decode_attention":  # and its SA ring
            kernels[-1]["jamba_1_5_large_398b"]["ring"]["max_abs_err"] = \
                errs[JAMBA]["decode_attention_ring"]
        if name in errs[DEEPSEEK]:  # flash and streaming at (192, 128)
            kernels[-1]["deepseek_v2_236b"] = dict(
                launches=counts["deepseek_batch"][name],
                max_abs_err=errs[DEEPSEEK][name], **rows[DEEPSEEK][name])
        # the xa and ta calls: block-sparse at the xa selection (phase 20's
        # xa batch path), streaming and flash at ta's split (its ta path)
        for key, (kern, path) in SA_ROWS.items():
            if kern == name:
                kernels[-1][key] = dict(
                    launches=counts[path][name] if path else None,
                    max_abs_err=errs["sa_modes"][key],
                    **rows["sa_modes"][key])
        # whisper's instances (not causal): their launches on phase 23's
        # path, as SideRecorder tallied them
        for case in rows[WHISPER]:
            kern, key = case.split()
            if kern == name:
                kernels[-1][key] = dict(launches=side_launches[case],
                                        max_abs_err=errs[WHISPER][case],
                                        **rows[WHISPER][case])
    # the backward kernel: no TPU counterpart; its launches from phase 30,
    # its rows phase 3's errors beside phase 4's times

    def bwd_row(prefix):
        label = next(k for k in bwd_rows if k.startswith(prefix))
        e, ratios, mutant = bwd_errs[label]
        return dict(label=label, max_abs_err=e, limit_ratios_dq_dk_dv=ratios,
                    zeroed_tile_ratio_dk=mutant, **bwd_rows[label])

    kernels.append(dict(
        name="attention_backward", route="cuda",
        source=str((_build.CSRC / "attention_backward.cu").relative_to(
            ROOT)),
        bf16_engine=str((_build.CSRC / "backward_wgmma.cuh").relative_to(
            ROOT)),
        replaces="none: the gradient of flash and streaming (the JAX "
                 "package differentiates src/repro/core/modes.py:120 by "
                 "XLA's autodiff)",
        launches=counts["train"]["attention_backward"],
        launches_by_path={k: c_["attention_backward"]
                          for k, c_ in counts.items()},
        **bwd_row(f"{ARCH} causal"),
        streaming=bwd_row(f"{ARCH} streaming"),
        stablelm_12b=dict(causal=bwd_row(f"{STABLELM} causal"),
                          streaming=bwd_row(f"{STABLELM} streaming")),
        gemma3_12b_window=bwd_row(f"{GEMMA3} window"),
        whisper_encoder=bwd_row(f"{WHISPER} bidirectional"),
        deepseek_v2_236b=dict(
            launches=counts["deepseek_train_ssa"]["attention_backward"],
            **bwd_row(f"{DEEPSEEK} causal")),
        unaligned=bwd_row(BWD_UNALIGNED_TIMED),
        stress={k: c_ for k, c_ in stressed.items()
                if stress_kernel[k] == "attention_backward"}))
    kernels.append(dict(
        name="block_sparse_backward", route="cuda",
        source=str((_build.CSRC / "block_sparse_backward.cu").relative_to(
            ROOT)),
        bf16_engine=str((_build.CSRC / "backward_wgmma.cuh").relative_to(
            ROOT)),
        replaces="none: the gradient of block-sparse (the JAX package "
                 "differentiates src/repro/core/modes.py:473 _block_topk "
                 "by XLA's autodiff)",
        launches=counts["train_xa"]["block_sparse_backward"],
        launches_by_path={k: c_["block_sparse_backward"]
                          for k, c_ in counts.items()},
        **bwd_row(f"{ARCH} xa"),
        deepseek_v2_236b=dict(
            launches=counts["deepseek_train_xa"]["block_sparse_backward"],
            **bwd_row(f"{DEEPSEEK} xa")),
        stress={k: c_ for k, c_ in stressed.items()
                if stress_kernel[k] == "block_sparse_backward"}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"total {time.perf_counter() - t_all:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
