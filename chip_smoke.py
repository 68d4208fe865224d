#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Drives the port's main path on one CUDA card and fails loudly if any phase
fails.  It imports nothing of JAX or of the JAX package ``repro``.

1. Build every CUDA kernel from the sources in this checkout (``nvcc`` for
   ``sm_90a`` into ``build/``), all sources in parallel.
2. Hold each kernel to its plain PyTorch version on the card at the main
   paths' shapes.
   Flash attention: smollm-360m heads 15/5 at D 64, h2o-danube-1.8b heads
   32/8 at D 80, zamba2-7b heads 32/32 at D 112, internvl2-2b heads 16/8
   at D 128, minicpm3-4b heads 40/40 at q/k head dim 96 and v head dim 64
   (MLA, at its scale 96^-½), llama4-scout-17b-a16e heads 40/8 (a GQA
   group of 5) at D 128; bf16 and fp32; bulk
   S = 1000 and 2048, 128-row chunks at q_offset 0, 128, 896, 1024 and
   1920 of a 2048 scratch, a ragged 100-row chunk at 896, a 256 window at
   2048 and at the chunk at 1024, and a window of 0 at 2048 (only None
   means no window: no row sees a column, every output 0).
   Tolerances: max abs error 2e-4 in fp32 (TF32 off), 3e-2 in bf16 at
   bulk, the chunk at 1024 and the windows at 2048; bf16 at the other
   chunks, and every bf16 case against the split-and-merge plain version
   at the kernel's split plan, to 1e-2 of the largest plain output.  At
   bulk-2048 and chunk-128@1024 of the six models in bf16, time the kernel,
   the plain version, the bound and ``scaled_dot_product_attention`` over
   the same visible columns (the library yardstick, bottom-right causal
   for a chunk; the port never calls it), and name the kernel SDPA ran.
   Times are CUDA events around back-to-back calls, host launch cost
   included; the kernel's and the yardstick's device times
   (torch.profiler) are printed beside them.  Then flash without a mask
   at whisper-tiny's shapes (heads 6/6, D 64): its encoder's 1500 × 1500
   and the cross-attention of 1, 37 and 448 decoder rows over 1500
   encoder rows, bf16 and fp32, at the same tolerances (bf16 also to
   1e-2 of the largest against the plain version); the encoder and the
   448-row call timed, SDPA without a mask as the yardstick.
   SSD scan: mamba2-2.7b heads (H 80, P 64, N 128, G 1, chunk 128) at
   S 2048, ragged S 1000, a 128-row chunk with a carried state and B 2 at
   S 384 with a state, plus one zamba2 shape (H 112, N 64, S 512); bf16
   and fp32.  Tolerances, as max error over max |plain|: y 1e-4 in fp32
   and 2e-2 in bf16, the final state 1e-4.  Every case is timed by CUDA
   events and by device time (torch.profiler, the sum of the call's CUDA
   kernels, each timed apart; fails unless a call is three kernels for
   more than one chunk and one for a single chunk) beside
   its bound (operations at the bf16 tensor-core peak for bf16, at the
   CUDA cores' fp32 peak for fp32); the plain version is timed at S 2048
   and at the 128-row chunk in bf16 (no single PyTorch call computes the
   scan, so there is no library yardstick).
   SSD backward (``csrc/ssd_bwd.cu``, ``ops.SSD_BWD_KERNELS`` CUDA kernels
   a call; bf16 on the tensor cores in head tiles) against
   ``ssd_bwd_plain`` at the same five shapes in bf16 and fp32 (a random
   dstate where there is an init_state), reading the entering states the
   forward kept, plus the training microbatch (B 4, S 2048) in bf16.
   Printed: each case's plan as the wrapper launched it (heads a block,
   blocks; shared memory a block, blocks an SM by the occupancy query;
   ptxas's registers and spills above) and the scratch a call allocates
   (the caching allocator's peak less what the call keeps).
   Tolerances, each gradient's max error over its max against the plain
   backward on fp32-upcast inputs: fp32 1e-4 (ddt and da 5e-4: sums of
   both signs through a reverse cumsum), bf16 1e-2 (dx, dB, dC written in
   bf16; the kept entering states are bf16).  bf16 is also held to
   ``ssd_bwd_bf16_emulated`` on the same kept states (``SSD_BWD_EMU_TOL``:
   dx, dB, dC 2^-8, dd and d init_state 1e-4, ddt and da 5e-4).  Two calls must give the
   same bits, and a call must be exactly ``ops.SSD_BWD_KERNELS`` CUDA
   kernels.  Timed by events and on the device (split by CUDA kernel)
   beside the bound and, at S 2048, the 128-row chunk and the training
   shape in bf16, the plain backward.
3. Serve full-width smollm-360m in bf16 (random weights from a seed): 8
   requests with prompts of 256–1024 tokens, 32 new tokens each, batch 4,
   max_seq 2048, prefill chunks of 128, one arrival every 2 steps —
   contiguous, then paged with 128-token blocks.  The two must emit the
   same tokens, and the flash kernel must have launched n_layers times per
   prefill chunk.
3b. Serve full-width internvl2-2b in bf16 (random weights from a seed; 24
   layers, heads 16/8 at D 128): phase 3's recipe, each request with 256
   patch embeddings of width 1024 (standard normal from the seed) before
   its 256–1024 text tokens, contiguous then paged.  Held: every request
   answered; flash launched 24 times a prefill chunk (53 chunks a run)
   and no other kernel of the port; paged ≡ contiguous tokens; then
   phase 4's fp32 check (chunked ≡ bulk first-token logits 1e-3, each
   bf16 run against fp32 1.5e-1).  Printed: phase 4's serving numbers and
   one profiled decode step and 128-row chunk (the card's idle share).
3c. Serve full-width whisper-tiny in bf16 the same way: 6 requests of
   64–448 decoder tokens, each with 1500 frame embeddings of width 384,
   16 new tokens, max_seq 512, chunked (128) then bulk.  Held: flash
   launched 12 times a bulk pass and on chunk 0 (4 encoder layers
   without a mask, 4 causal self- and 4 unmasked cross-attentions), 8
   times a later chunk, never in decode; phase 4's fp32 check.
3d. Serve full-width minicpm3-4b in bf16 (random weights from a seed; 31
   of its 62 MLA layers, to fit the time limit; 40 heads, a 256-wide
   latent and a 32-wide shared rope key cached a token, attention at q/k
   head dim 96 and v head dim 64): phase 3's recipe, chunked (128) then
   bulk (MLA has no paged layout).
   Held: every request answered; flash launched 31 times a prefill chunk
   and bulk pass, never in decode (the absorbed form over the latent),
   and no other kernel of the port; phase 4's fp32 check.  Printed as
   phase 3b.
3e. Serve llama4-scout-17b-a16e in bf16 at full width with its depth cut
   to 8 of its 48 layers (19.69 B parameters, random weights from a seed;
   16 experts, top-1, a shared expert; heads 40/8 at D 128): phase 3's
   recipe, contiguous and paged (chunks of 128), then bulk.  Held: the
   parameter count against ``count_params_analytic``; every request
   answered; flash launched 8 times a chunk or bulk pass (296 a chunked
   run, 64 the bulk run), never in decode, and no other kernel of the
   port; paged ≡ contiguous tokens; no op of a profiled decode step or
   chunk makes a new tensor the size of an expert weight (a copy or cast
   of one).  Printed: prefill and decode tokens/s, TTFT, ITL, peak GiB,
   the profiled step and chunk (idle share, top device ops).  Then, the
   bf16 model freed, the same widths at 2 layers in fp32 (6.47 B
   parameters) with ``capacity_factor = n_experts``: chunked ≡ bulk
   first-token logits to 1e-4 of the largest, and layer 0's keep
   decisions agree everywhere; at the published capacity factor (1.25)
   the share of layer 0's (token, choice) keep decisions that chunk-local
   and bulk routing decide differently is printed, not held.
4. Serve full-width mamba2-2.7b in bf16 (random weights from a seed): 6
   requests with prompts of 256–1024 tokens, 16 new tokens each, batch 4,
   one arrival every 2 steps — chunked admission (128-token chunks), then
   bulk.  The SSD kernel must have launched n_layers times per prefill
   chunk and per bulk request.  The same prompts then run in fp32 (the
   weights widened), bulk and chunked outside the server: their
   first-token logits must agree to 1e-3 of their largest magnitude, and
   each bf16 server run's to 1.5e-1 of the fp32 ones (bf16 rounding alone
   moves this random-init model's logits by ~7.5%; the share of agreeing
   generated tokens is printed, not held).
4b. Serve full-width zamba2-7b in bf16 (random weights from a seed; 81
   Mamba-2 layers, 13 applications of 2 shared attention blocks at head
   dim 112) as phase 4 serves mamba2: 6 requests of 256–1024 tokens, 16
   new each, batch 4, max_seq 2048, one arrival every 2 steps, chunked
   (128) then bulk.  Held: every request answered; the SSD kernel
   launched 81 times and the flash kernel 13 times a prefill pass, and no
   other kernel of the port; then the fp32 check of phase 4 (chunked ≡
   bulk first-token logits 1e-3, each bf16 run against fp32 1.5e-1).
   Printed: the parameters, init time, prefill and decode tokens/s, TTFT,
   ITL, the peak memory of each run and the phase's wall time.
5. The reduced configs in fp32: prefill logits (and mamba2's and
   zamba2's final SSD states, minicpm3's latent cache, the MoE archs' K/V
   cache) through the kernels on the card against their plain versions
   on the CPU; minicpm3 at its full width's head dims (q/k 96, v 64);
   llama4-scout and grok-1 with every layer's routing decisions (``idx``,
   ``keep``) equal on the two (a flipped choice is printed with its
   top-k margin; one above 1e-5 fails).
6. The fused collective matmul's three hop kernels (``cc_matmul.cu``)
   against their plain versions at the shapes full-width h2o-danube-1.8b
   gives them at TP 4 (B 2, 512 rows a rank, bidirectional half rings of
   256 rows): bf16 × bf16, fp32 × fp32 (TF32 off) and the path's own
   fp32 activations × bf16 weights, plus a ragged case; the consume
   kernels read slot 1 of a (2, B, rows, ·) scratch through its strides.
   Tolerance, as max error over max |plain|: 1e-5 when an operand is
   fp32, 1e-4 for bf16 × bf16.  Time the kernel, the plain version and
   one cuBLAS call computing the same function (named in the output), and
   for every case in the path's own types their device times
   (torch.profiler).  The bound takes the operations at the bf16
   tensor-core peak for bf16 × bf16, at the CUDA cores' fp32 peak when an
   operand is fp32 (no TF32).  The kernels line carries
   ``consume_matmul`` at the q edge and at the up|gate edge (bf16) and,
   as ``fp32_*``, fp32 × bf16 at the o edge backward (the q edge's
   shape).
7. The two whole-ring ops (``ag_matmul_ring``/``rs_matmul_ring``) in
   four rank processes sharing the card, each mapping its ring
   neighbours' channels, against their plain versions (the unfused
   gather-then-matmul and matmul-then-reduce-scatter over the gloo
   group) at every TP-4 edge shape of full-width h2o-danube-1.8b (the
   vocab-parallel head's two edges among them: N = V/4 = 8000), both
   ring directions, plus a ragged case.  Same tolerances as the hop
   kernels.  A call is n hop products (the hop kernel, counted by the
   launcher into the group's ``ring_kernels`` and by torch.profiler:
   both must be 4 a rank), n − 1 forwards by the copy engine and
   stream-ordered waits (``kernels/cc_matmul/ring.py``).  Time the ring
   and the plain version as the group's wall time per call over 5 calls
   (the slowest rank, from a barrier; the ring over 20 calls beside it),
   and, by torch.profiler in every
   rank, the device time of the group's hop products a call (the
   serialized floor: 4 x 4 products run one after another) and of its
   forwards; no single PyTorch call computes a collective matmul across
   processes (NCCL takes one card a rank), so there is no library
   yardstick.
8. TP training of full-width h2o-danube-1.8b (``get_tp_preset``'s
   transport) with the vocab-parallel embedding and LM head (``embed``'s
   rows and ``lm_head``'s columns split over the model line, the head an
   AG ring edge with N = V/tp, the ranks' log-sum-exps combined a token):
   rank processes sharing the card, bf16 parameters from seed 0, fp32
   AdamW moments, remat full, SyntheticLM batches of 2 × 2048 tokens,
   seq_chunk 512, warmup 1.  The fused edges take the in-kernel ring (the
   ranks map each other's channels, the reference's remote-DMA path): 2
   steps at a model axis of 4, then step 0 at the preset's 8, 8 of the 24
   layers both (to fit the time limit); the rest of the group's traffic (the
   embedding's reduce-scatter, weight-gradient gathers, the K/V ring, the
   CE's log-sum-exp gather, the replicated leaves' gradient all-reduce)
   goes over gloo staged through host memory.  Held: every step's ring
   calls equal the schedule's count with the head's edges (an AG edge
   forward and an RS edge backward a CE chunk), each of them tp hop
   products (``ring_kernels``), and no hop kernel's wrapper or plain
   version runs; every rank reports the same loss; the step-0 loss is
   within 0.5 of ln 32000; every replicated leaf is bitwise equal on the
   ranks after the last step, and ``embed`` and ``lm_head`` are not
   among them; their shards after step 0, gathered, hold the 32000 vocab
   rows (columns) once each, the same in every run (exact checksums);
   TP 8 agrees with TP 4 at step 0 (loss 2e-2, grad norm 5e-2 relative,
   and the limits set from the readings, 1e-3 and 1e-2).  Before the
   TP-8 step, its eight-rank pool holds each ring call of that step at
   its shapes (``tp_ring_cases``: the blocks' edges and the head's, N =
   4000) to the plain version at phase 7's tolerances, with one ring
   launch and 8 hop products a call a rank.
   Printed a run: parameters and peak memory a rank, the step time (the
   slowest rank), and the model line's bytes staged through the host a
   step, the replicated leaves' gradient all-reduce apart.  The last
   TP-4 step runs under torch.profiler in every rank: the share of its
   wall with no kernel of any rank from the ranks' kernel spans summed
   (a lower bound: a preempted kernel's span stays open) and from their
   union on the profiler's host clock.  On the same TP-4 pool (which
   first runs phase 12's peer-mapped quickstart), the model cut to 4 of
   its 24 layers, step 0 under each TP family of ``TransportPolicy.tp``:
   ``fused``, ``ring`` and ``bidir`` (the overlap schedules of
   ``core/overlap.py``, each hop a gloo permute, each block product
   cuBLAS), ``auto`` (the conduit's cost model) and ``xla`` (the
   reference's GSPMD layout, ``models/tp_block.py``: gloo's gathers and
   scatters, cuBLAS products, no TP edge and no ring).  Held
   (``family_plan``): the edges a rank ran (``artblock.EDGE_CALLS``: op,
   bytes, modeled time, family, direction, calls) are the schedule's
   with the CPU's ``matmul_schedule`` decisions, so ``auto`` decides on
   the card as on the CPU; the ring launches its fused edges make; the
   ring permutes a rank sends (``Group.stats["hops"]``: n − 1 an edge
   call and direction, forward and backward, and the bare K/V and
   embedding collectives' on the policy's conduit; ``xla``: no edge, no
   ring launch); each other family's loss and grad norm within 1e-3 and
   1e-2 relative of the fused step's (the TP-8 check's limits).
   Printed: each run's step time, staged bytes, wire time and peak
   memory a rank, and ``auto``'s decision at each edge shape.  Then, on
   a pool without peer memory (which first runs phase 12's wire
   quickstart), step 0 at 4 layers on the emulated schedule (every hop
   over the gloo wire, each arrival consumed by a hop kernel): its
   hop-kernel launches equal the schedule's count, no ring kernel or
   plain version runs, and its loss and grad norm agree with the fused
   family's step 0 at 1e-6 relative (the same tile arithmetic on both
   paths).
9. Reduced h2o-danube-1.8b in fp32 at TP 2 and 4, at TP 4 with a
   vocab of 250 (which the line does not divide, so ``embed`` and
   ``lm_head`` stay replicated: the plain lookup of the rank's rows and
   the replicated head's CE), at TP 4 under ``tp="bidir"`` (every
   edge on the overlap schedules, no ring kernel) and at TP 4 under
   ``tp="xla"`` (the reference's GSPMD layout) with 6 query heads and 3
   KV heads, which 4 divides in neither (each rank attends the whole
   heads its rows of ``wo`` cut, ``wq``/``wk``/``wv`` gathered); and
   reduced minicpm3-4b (MLA) and internvl2-2b (seeded patch rows first
   in the split sequence) at TP 2 under ``xla``; 2 steps on the card and
   on the CPU (gloo both):
   loss and grad norm within 1e-4 relative, every parameter leaf by the
   parameter rule at 1e-4 (mean |Δ| ≤ 1e-4 × the leaf's mean magnitude,
   max |Δ| ≤ 2·peak_lr + 1e-4 × its max), and the two vocab leaves among
   the sharded (vocab 250: the replicated) leaves on every rank.
9b. Expert parallelism (``models/moe_ep.py``), on phase 9's pools of 2
   and 4 rank processes.  (a) Reduced llama4-scout and grok-1 in fp32,
   their experts split over 2 and 4 ranks, 2 steps of the EP train step
   (2 microbatches of 4 rows) with the exchange on ``ring`` and on
   ``xla``, and at 4 ranks grok-1 under its EP preset's own policy
   (``moe="auto"``, streamed in 4 chunks; 4 rows a rank), on the card
   and on the CPU from the same CPU-drawn
   parameters: loss, grad norm and ``moe_aux`` within 1e-4 relative,
   every leaf by the parameter rule at 1e-4, the replicated leaves
   bitwise equal on every rank.  (b) One full-width llama4-scout MoE layer
   in bf16 (D 5120, 16 experts, F 8192, top-1, capacity 160 a row at S
   2048, the shared expert) at EP 4, a row of 2048 a rank, forward and
   backward against the dense ``layers.moe`` and its autograd on all 16
   experts in the main process (the inputs and the dense results reach
   the ranks through CUDA IPC): the routing (``idx``, ``keep``) equal, y,
   x's gradient and every parameter's (an expert shard's whole, a
   replicated leaf's summed over the ranks) within ``EP_LAYER_TOL``
   relative (Frobenius), a gradient that is zero up to rounding within
   ``EP_ZERO_TOL``; the exchange's wire seconds printed.  (c) Full-width
   llama4-scout cut to 4 layers served at EP 4 (each rank draws the same
   seed on the card and keeps 4 of the 16 experts a layer), one row a
   rank, the exchange on ``ring`` and then on ``xla``: bulk prefill of
   128 tokens (flash launched a layer, counted), then 16 decode steps
   through ``serve_step`` with the EP decode runner, fed the tokens of
   the dense-combine decode of the same model run first in the main
   process: the prefill logits and every step's within ``EP_SERVE_TOL``
   of the dense run's maximum, and the greedy-token agreement printed,
   with the decode wall ms and wire seconds a step, the device's idle
   share of a profiled step (``ring``; the union of the ranks' kernel
   spans) and the peak memory a rank.  (c) runs first on the 4-rank
   pool, (b) last.
9c. The data axis on phase 9's four-rank pool (``phase_grid``).
9d. The reference launcher's default job, ``smollm-360m`` on data 2 ×
   model 2 under ``tp="xla"``, at full width and all 32 layers, through
   the launcher's Trainer grid task with its step settings, 2 steps of 4
   × 1024 tokens, on phase 9's four-rank pool: every rank on the ``xla``
   path (15 heads over 2 ranks: ``wq``/``wk``/``wv`` gathered), finite
   losses, the step-0 loss within 0.5 of ln 49152, parameters bitwise
   equal across data ranks; printed a step: the slowest rank's time, each
   line's wire seconds and staged bytes; the peak memory a rank.
9e. ``minicpm3-4b`` (MLA) and ``internvl2-2b`` (VLM) at full width cut
   to 8 layers, tp 2 under ``xla``, step 0 on phase 9's two-rank pool:
   the ``xla`` path, no cc_matmul launch, the same finite loss on both
   ranks within 0.5 of ln V; printed: the step time, wire, staged bytes
   and the peak memory a rank.

10. One-GPU training of full-width smollm-360m through the Trainer (16
    of its 32 layers, bf16 parameters from seed 0, fp32 AdamW masters and
    moments,
    remat full): SyntheticLM batches of 8 × 2048 tokens in 2 microbatches,
    seq_chunk 512, 4 steps with a checkpoint at step 2; the final
    checkpoint is dropped and a fresh Trainer restores step 2 and runs
    steps 2–3 again; then one more step under torch.profiler.  The steps
    run under torch's deterministic algorithms (without the fill of
    uninitialized memory).  Held: the step-0 loss
    within 0.5 of ln 49152; every loss and grad norm finite; the resumed
    steps' loss and grad norm equal to the uninterrupted run's (bitwise
    expected; the stated tolerance is 1e-4 relative for the loss and 1e-3
    for the grad norm); no kernel of the port launched during training
    (counted by the wrappers) and no flash or SSD device event in the
    profiled step.  Printed: each step's wall time, tokens/s and peak
    memory, the profiled step's ten device ops that take the most time
    and the device's idle share of the step, beside the card's name and
    power limit.  Then reduced smollm-360m in fp32, 2 tp-1 steps
    (microbatches 2) on the card and on the CPU from the same parameters:
    loss and grad norm within 1e-4 relative, every parameter leaf by the
    parameter rule at 1e-4.
10b. One-GPU training of full-width mamba2-2.7b through the Trainer (64
    layers, bf16 parameters from seed 0, fp32 AdamW masters and moments,
    remat full, no checkpoint): SyntheticLM batches of 8 × 2048 tokens in
    2 microbatches, seq_chunk 512, 3 steps, then one more under
    torch.profiler, under torch's deterministic algorithms.  Held: every
    step's launches exact (SSD forward 2 × 64 × 2, the forward and the
    remat recompute; SSD backward 64 × 2; flash, DLA and cc_matmul 0), and
    in the profiled step as many SSD device events (3 CUDA kernels a
    forward launch, ``ops.SSD_BWD_KERNELS`` a backward one); the step-0
    loss within 0.5 of ln 50280; every loss and grad norm finite.
    Printed: each step's wall time, tokens/s, loss, grad norm and peak
    memory, the profiled step's top device ops and idle share, beside the
    card's name and power limit.  Then reduced
    mamba2-2.7b and reduced zamba2-7b in fp32, 2 tp-1 steps each on the
    card and on the CPU, held as in phase 10.
11. The DLA matmul kernel (``kernels/matmul/csrc/matmul.cu``): first the
    entry point driven as a user calls the DLA instruction — ``matmul`` at
    the case study's sizes (256/512/1024 square, fp32, gelu with a bias)
    and at a dense MLP edge of full-width h2o-danube-1.8b (x 4096 × 2560
    @ w_up 2560 × 6912, bf16 in and out, silu) — with the launch count set
    to 0 before and read after (4 expected; no module of the reference
    calls the kernel, so this entry point is its path).  Then every case
    against the plain version: the reference's kernel-test shapes, the
    case-study sizes with each of the five activations and a bias, a
    ragged 77 × 130 × 45, a batched (3, 40, 64) and the MLP edge.
    Tolerance, as max error over max |plain|: fp32 in and out 1e-5 (TF32
    off), bf16 in and fp32 out 1e-4, bf16 out 1e-2.  At 1024 fp32 and at
    the MLP edge, time the kernel, the plain version, the bound (flops at
    the operand type's peak, bytes at 3.35 TB/s) and one PyTorch call of
    the same function where one exists (``torch.addmm`` for none + bias,
    ``torch._addmm_activation`` for relu/gelu + bias), with the kernel's
    and the call's device times, by CUDA events queued behind a busy card
    (``queued_ms``: this late in the run torch.profiler drops launches);
    beside the MLP edge ``torch.mm`` in bf16, a floor that computes less
    (no bias, no silu).
12. The PGAS substrate on the card: the quickstart (ring PUT, ``SCALE``
    Active Message, ART matmul) in four rank processes with peer-mapped
    heaps and in four on the card's gloo wire (``peer_memory=False``),
    each run on phase 8's fresh four-rank pool, and in four CPU ranks
    here: bit-identical heaps, four heaps one after another on the peer
    pool holding one partition at each mapping, the peer run's PUT through peer
    stores, the ART result within 2e-4 of ``M @ N``.  Then a PUT/GET sweep
    between ranks 0 and 1 of a 2-rank group, 4 B to 2 MB in powers of two
    and 64 MB, on a 2^24-word fp32 heap, over peer memory and over the
    wire: the transfer alone and the whole collective call, latency and
    bandwidth, GET over PUT; every read-back checked.
13. The paper's Sec. V case study on the 2-rank peer group (fp32, TF32
    off): ``art_matmul_reducescatter`` (8 chunks) and
    ``bulk_matmul_reducescatter`` at 256/512/1024 and 8192, each within
    2e-4 of one ``torch.matmul`` relative to the largest output, and
    ``split_conv_allgather`` on the paper's three conv sets (64 × 64
    fmaps) at batch 1 and 64, within 2e-4 of one ``conv2d``; the group's
    wall time of each call.

14. Family training: every family the port serves trained at full width
    on the card, tp 1, in a process of its own (``--train-families``):
    3 steps from seed 0 in bf16, 2 microbatches, seq_chunk 512, the AdamW
    state by the reference's ``step_config`` rule on the published config
    (``launch.train.optimizer_state``), every attention through blockwise
    attention (flash has no backward).  14a zamba2-7b at 12 of its 81
    layers (1 576 172 480 parameters), ``remat="dots"``, 4 × 2048 tokens
    through the Trainer; 14b llama4-scout-17b-a16e at 1 of its 48 layers
    (4 271 078 400: the 16 stacked experts, the router, the shared expert,
    the 202 048-row embedding and head), bf16 moments and no master, 4 ×
    2048 tokens through the Trainer; 14c minicpm3-4b at 16 of 62 layers,
    the same; 14d internvl2-2b at all 24 layers through
    ``build_train_step``, 4 rows of 256 patch embeddings (width 1024,
    standard normal from a seed) and 1792 text tokens; 14e whisper-tiny
    at all 4 + 4 layers, 8 rows of 1500 frames (width 384) and 448 decoder
    tokens.  Held: the parameter count against ``count_params_analytic``;
    the optimizer state's dtype; every loss and grad norm finite; every
    step's launches exact (zamba2: SSD forward 12 × 2 × 2 = 48, the
    forward and the recompute that ``"dots"`` leaves to the scan, and
    backward 12 × 2 = 24; every other kernel 0, flash included), and in
    zamba2's profiled step 3 and ``ops.SSD_BWD_KERNELS`` SSD device events
    a launch; zamba2's products with no batch dimension that run in one
    step of 1 × 512 tokens (a dispatch mode below selective checkpointing's
    cache) equal under ``"dots"`` and ``"none"`` and fewer than under
    ``"full"``; llama4's ``moe_aux`` > 0, and no op of a step (forward,
    backward, AdamW) copies or casts a whole expert weight (1.34 GB).
    Printed: each step's time, tokens/s, loss, grad norm and peak memory,
    zamba2's step and peak under ``"full"`` beside ``"dots"``, one profiled
    step's idle share, top device ops and GEMM kernels (by name).  Then
    the reduced configs in fp32, 2 tp-1 steps on the card and on the CPU,
    held as in phase 10: llama4-scout, grok-1, minicpm3, internvl2 and
    whisper (the last two with frontend embeddings from a seed), and
    zamba2 under ``remat="dots"``.

Prints a ``kernels`` JSON line, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``.  Exits nonzero, printing
no result, when there is no CUDA device or the port cannot be imported.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak
PEAK_FP32_FLOPS = 67e12       # H100 SXM fp32 peak outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 bandwidth
TOL = {"float32": 2e-4, "bfloat16": 3e-2}
# bf16 flash at the chunk offsets added with split-KV, and every bf16 case
# against the split-and-merge plain version: max error over max |plain|
# (one bf16 rounding step of the largest output is at most 2^-7 of it)
BF16_SPLIT_REL = 1e-2


def card_name_and_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# host seconds the profiler records before the first launch and after the
# last kernel ends: kineto keeps only the device events inside its capture
# window, so no call's kernels lie near the window's edges
PROFILE_PAD_S = 0.05
# profiles taken of one function until its record is whole
PROFILE_TRIES = 3


def device_kernels(fn, iters: int = 20):
    """Device time of one call from torch.profiler (CUPTI), the host's
    launch cost excluded: (ms a call, device events a call, [(kernel,
    ms a call)] in launch order).  Every kernel, copy or fill on the card
    is an event, so a call that gains one shows it.  A record is whole when
    every call shows the same sequence of events; one that is not (the
    profiler lost events) is taken again, up to ``PROFILE_TRIES`` times.
    If none is whole, the time is ``queued_ms``'s and the count the last
    record's events over ``iters`` (a fraction, which no kernel count
    equals).  (None, 0, []) when the profiler records no device time."""
    import torch

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_TRIES + 1):
        events = profiled_events(fn, iters)
        whole = len(events) % iters == 0 and all(
            e.name == events[i % (len(events) // iters)].name
            for i, e in enumerate(events))
        if whole or attempt == PROFILE_TRIES:
            break
        print(f"[profiler] {len(events)} device events for {iters} calls, "
              f"not the same events in every call: profiled again "
              f"({attempt} of {PROFILE_TRIES})", flush=True)
    total = sum(e.time_range.elapsed_us() for e in events)
    if total <= 0:
        return None, 0, []
    if not whole:
        ms = queued_ms(fn, iters)
        print(f"[profiler] no whole record in {PROFILE_TRIES} profiles: "
              f"device time {ms:.4f} ms a call by CUDA events queued behind "
              f"a busy card", flush=True)
        return ms, len(events) / iters, []
    per_call = len(events) // iters
    split = []
    for i in range(per_call):
        name = events[i].name.replace("(anonymous namespace)::", "")
        name = re.match(r"(?:void\s+)?([\w:]*)", name).group(1)
        split.append((name.split("::")[-1] or events[i].name, sum(
            e.time_range.elapsed_us() for e in events[i::per_call])
            / iters / 1e3))
    return total / iters / 1e3, per_call, split


def profiled_events(fn, iters: int):
    """The device events of ``iters`` calls of ``fn`` under torch.profiler,
    in start order, the capture window padded by ``PROFILE_PAD_S`` on each
    side."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    return sorted((e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: e.time_range.start)


def device_ms(fn, iters: int = 20):
    """Device time of one call: the durations of the kernels it launched,
    from torch.profiler (CUPTI), the host's launch cost excluded.  Beside
    ``time_ms`` (CUDA events around back-to-back calls), which for calls
    of a few microseconds measures the host.  None when the profiler
    records no device time."""
    return device_kernels(fn, iters)[0]


def queued_ms(fn, iters: int = 20) -> float:
    """Device time of one call without the profiler: CUDA events recorded
    right before and after each call, queued behind a kernel that keeps
    the card busy (``torch.cuda._sleep``) while the host enqueues them, so
    the span between them is the call's kernels alone.  The DLA phase
    times by it: after the rank-pool phases torch.profiler recorded none,
    or only some, of the launches there."""
    import torch

    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        torch.cuda._sleep(400_000)          # ~0.2 ms of busy card
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def attention_bound_ms(q, k, v, causal, window, q_offset):
    """Least time for the attention call: the larger of its visible
    operations at the bf16 peak (2·(DK + DV) a visible (row, col) pair and
    head: q·k and p·v) and its bytes (q, the k/v rows it can see and out,
    once each, q and k at DK and v and out at DV) at the memory rate.
    Visible pairs are counted for these inputs."""
    import torch

    b, hq, sq, dk = q.shape
    skv, dv = k.shape[2], v.shape[-1]
    rows = q_offset + torch.arange(sq, dtype=torch.int64)
    hi = torch.minimum(rows + 1, torch.tensor(skv)) if causal \
        else torch.full_like(rows, skv)
    lo = (rows - window + 1).clamp_min(0) if window is not None \
        else torch.zeros_like(rows)
    pairs = int((hi - lo).clamp_min(0).sum())
    flops = 2.0 * (dk + dv) * pairs * hq * b
    cols = max(0, int(hi.max()) - int(lo.min()))   # k/v rows read
    nbytes = (b * hq * sq + b * k.shape[1] * cols) * (dk + dv) \
        * q.element_size()
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_build():
    from repro_torch.kernels import KERNEL_NAMES
    from repro_torch.kernels.common import build

    t0 = time.perf_counter()
    secs = build(KERNEL_NAMES)
    print(f"[build] {', '.join(f'{n} {s:.1f}s' for n, s in secs.items())}; "
          f"total {time.perf_counter() - t0:.1f}s", flush=True)


def sdpa_yardstick(q, k, v, window, q_offset, causal=True):
    """One ``scaled_dot_product_attention`` call over the same visible
    columns (the library yardstick; the port never calls it): bottom-right
    causal alignment for a chunk (``is_causal`` is top-left when Sq < Skv),
    an explicit mask for a window, no mask for a non-causal call.  Returns
    the call and the name of the kernel it ran, read from the profiler."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    sq = q.shape[2]
    end = q_offset + sq if causal else k.shape[2]
    kk, vv = k[:, :, :end], v[:, :, :end]
    if not causal:
        mask = None
    elif window is not None:
        rows = q_offset + torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(end, device=q.device)[None, :]
        mask = (cols <= rows) & (cols > rows - window)
    elif q_offset:
        mask = causal_lower_right(sq, end)
    else:
        mask = None

    def call():
        return F.scaled_dot_product_attention(
            q, kk, vv, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)

    call()
    name = "unknown"
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if "memcpy" not in e.key.lower()
                 and "memset" not in e.key.lower()]
        name = max(names, key=len)[:60] if names else name
    except Exception as e:            # the profiler is only a label here
        name = f"profiler unavailable ({type(e).__name__})"
    return call, name


def phase_kernels():
    """Kernel vs plain on the card; returns the main-path shapes' numbers
    (bulk-2048 and chunk-128@1024 of smollm-360m in bf16; h2o-danube-1.8b's,
    zamba2-7b's, internvl2-2b's, minicpm3-4b's (q/k head dim 96, v 64) and
    llama4-scout-17b-a16e's (40/8 heads) under ``h2o_*``, ``zamba2_*``,
    ``internvl2_*``, ``minicpm3_*`` and ``llama4_*``;
    whisper-tiny's non-causal encoder and cross calls under ``whisper_*``,
    from :func:`flash_noncausal`)."""
    import torch

    from repro_torch.kernels.flash_attention import (
        FLASH,
        attention_plain,
        attention_split_plain,
        flash_attention,
        kv_split_plan,
    )

    name = "?"
    for line in FLASH.ptxas_report().splitlines():
        entry = re.search(r"(flash_fwd_bf16|flash_fwd_f32|flash_merge)"
                          r"I((?:Li\d+E)+)E", line)
        if entry:
            name = (f"{entry.group(1)}<"
                    f"{','.join(re.findall(r'Li(\d+)E', entry.group(2)))}>")
        elif "registers" in line or "spill" in line or "smem" in line:
            print(f"[ptxas] {name}: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    # (Hq, Hkv, q/k head dim, v head dim)
    heads = {"smollm-360m": (15, 5, 64, 64),
             "h2o-danube-1.8b": (32, 8, 80, 80),
             "zamba2-7b": (32, 32, 112, 112),
             "internvl2-2b": (16, 8, 128, 128),
             "minicpm3-4b": (40, 40, 96, 64),
             "llama4-scout-17b-a16e": (40, 8, 128, 128)}
    # (label, Sq, Skv, q_offset, window); the first five at TOL, the rest
    # (in bf16) at BF16_SPLIT_REL.  window-0: no row sees a column, every
    # output 0 (only None means no window)
    held_abs = 5
    cases = [("bulk-1000", 1000, 1000, None, None),
             ("bulk-2048", 2048, 2048, None, None),
             ("chunk-128@1024", 128, 2048, 1024, None),
             ("window-256", 2048, 2048, None, 256),
             ("window-0", 2048, 2048, None, 0),
             ("chunk-128@0", 128, 2048, 0, None),
             ("chunk-128@128", 128, 2048, 128, None),
             ("chunk-128@896", 128, 2048, 896, None),
             ("chunk-128@1920", 128, 2048, 1920, None),
             ("chunk-100@896", 100, 2048, 896, None),
             ("window-256 chunk-128@1024", 128, 2048, 1024, 256)]
    timed = ("bulk-2048", "chunk-128@1024")
    main = {}
    for arch, (hq, hkv, d, dv) in heads.items():
        for dtype in (torch.bfloat16, torch.float32):
            for i, (label, sq, skv, q_offset, window) in enumerate(cases):
                q = torch.randn(1, hq, sq, d, generator=gen, device=dev)
                k = torch.randn(1, hkv, skv, d, generator=gen, device=dev)
                v = torch.randn(1, hkv, skv, dv, generator=gen, device=dev)
                q, k, v = (t.to(dtype) for t in (q, k, v))
                kw = dict(causal=True, window=window, q_offset=q_offset)
                if dv != d:          # MLA's scale, (qk_nope + qk_rope)^-½
                    kw["scale"] = d ** -0.5
                got = flash_attention(q, k, v, **kw)
                torch.cuda.synchronize()
                want = attention_plain(q, k, v, **kw)
                if not torch.isfinite(got).all():
                    fail(f"flash {arch} {label} {dtype}: non-finite output")
                err = (got.float() - want.float()).abs().max().item()
                rel = err / max(want.float().abs().max().item(), 1e-30)
                tol = TOL[str(dtype).split(".")[1]]
                offset = skv - sq if q_offset is None else q_offset
                if dtype == torch.bfloat16 and i >= held_abs:
                    held = (f"max_abs_err {err:.3g}, max_err/max {rel:.3g} "
                            f"(tol {BF16_SPLIT_REL})")
                    bad = rel > BF16_SPLIT_REL
                else:
                    held = f"max_abs_err {err:.3g} (tol {tol})"
                    bad = err > tol
                if dtype == torch.bfloat16:
                    plan = kv_split_plan(sq, skv, offset, True, window, hq)
                    split = attention_split_plain(q, k, v, plan, **kw).float()
                    rel_split = ((got.float() - split).abs().max()
                                 / split.abs().max().clamp_min(1e-30)).item()
                    held += (f", vs split plain max_err/max {rel_split:.3g} "
                             f"(tol {BF16_SPLIT_REL}), plan {plan.splits} "
                             f"split(s) x {plan.tiles_per_split} kv tiles")
                    if rel_split > BF16_SPLIT_REL:
                        fail(f"flash {arch} {label}: max_err/max vs split "
                             f"plain {rel_split} > {BF16_SPLIT_REL}")
                ms = time_ms(lambda: flash_attention(q, k, v, **kw), iters=10)
                print(f"[flash] {arch} {label} {str(dtype)[6:]}: {held}, "
                      f"{ms:.4f} ms", flush=True)
                if bad:
                    fail(f"flash {arch} {label} {dtype}: {held}")
                if label in timed and dtype == torch.bfloat16:
                    kernel_ms = time_ms(
                        lambda: flash_attention(q, k, v, **kw))
                    plain_ms = time_ms(
                        lambda: attention_plain(q, k, v, **kw))
                    lib, lib_name = sdpa_yardstick(q, k, v, window, offset)
                    library_ms = time_ms(lib)
                    dev_ms = device_ms(
                        lambda: flash_attention(q, k, v, **kw))
                    lib_dev_ms = device_ms(lib)
                    bound_ms, bound_by = attention_bound_ms(
                        q, k, v, True, window, offset)
                    main[(arch, label)] = dict(
                        max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=library_ms, device_ms=dev_ms,
                        library_device_ms=lib_dev_ms)
                    print(f"[flash] timed {arch} {label} (B1 Hq{hq}/Hkv{hkv}"
                          f" Sq{sq} Skv{skv} q_offset {offset} D{d}"
                          f"{'' if dv == d else f'/{dv}'} causal "
                          f"bf16, plan {plan.splits} x "
                          f"{plan.tiles_per_split}): kernel {kernel_ms:.4f} "
                          f"ms, plain {plain_ms:.4f} ms, sdpa "
                          f"{library_ms:.4f} ms ({lib_name}), bound "
                          f"{bound_ms:.5f} ms ({bound_by}); on the device "
                          f"(torch.profiler) kernel {fmt_ms(dev_ms)}, sdpa "
                          f"{fmt_ms(lib_dev_ms)}", flush=True)
                del q, k, v, got, want
    out = dict(main[("smollm-360m", "bulk-2048")])
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "device_ms",
            "library_device_ms")
    for arch, label, tag in (
            ("smollm-360m", "chunk-128@1024", "chunk"),
            ("h2o-danube-1.8b", "bulk-2048", "h2o_bulk"),
            ("h2o-danube-1.8b", "chunk-128@1024", "h2o_chunk"),
            ("zamba2-7b", "bulk-2048", "zamba2_bulk"),
            ("zamba2-7b", "chunk-128@1024", "zamba2_chunk"),
            ("internvl2-2b", "bulk-2048", "internvl2_bulk"),
            ("internvl2-2b", "chunk-128@1024", "internvl2_chunk"),
            ("minicpm3-4b", "bulk-2048", "minicpm3_bulk"),
            ("minicpm3-4b", "chunk-128@1024", "minicpm3_chunk"),
            ("llama4-scout-17b-a16e", "bulk-2048", "llama4_bulk"),
            ("llama4-scout-17b-a16e", "chunk-128@1024", "llama4_chunk")):
        out.update({f"{tag}_{key}": main[(arch, label)][key]
                    for key in keys})
    for tag, case in flash_noncausal(gen).items():
        out.update({f"{tag}_{key}": case[key]
                    for key in keys + ("max_abs_err", "bound_by")})
    return out


#: whisper-tiny's non-causal flash calls (heads 6/6, D 64): the encoder's
#: bidirectional self-attention over its 1500 frames, and the decoder's
#: cross-attention of 1, 37 and 448 rows (a decode-sized, a ragged and the
#: longest prompt) over the encoder's 1500 rows; the 1500-row edge
#: (23 × 64 + 28) is masked only by the column bound
NONCAUSAL_CASES = (("whisper_enc", 1500), ("whisper_cross1", 1),
                   ("whisper_cross37", 37), ("whisper_cross", 448))


def flash_noncausal(gen):
    """Each of ``NONCAUSAL_CASES`` in bf16 and fp32 against the plain
    version (fp32 at ``TOL``; bf16 at ``TOL`` and, against the plain and
    the split-and-merge plain versions at the kernel's split plan, at
    ``BF16_SPLIT_REL``); the encoder and the 448-row cross call timed in
    bf16 beside their bound and SDPA's time.  Returns the timed cases."""
    import torch

    from repro_torch.kernels.flash_attention import (
        attention_plain,
        attention_split_plain,
        flash_attention,
        kv_split_plan,
    )

    dev = torch.device("cuda")
    hq = hkv = 6
    d, skv = 64, 1500
    timed = {}
    for tag, sq in NONCAUSAL_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn(1, hq, sq, d, generator=gen, device=dev)
            k = torch.randn(1, hkv, skv, d, generator=gen, device=dev)
            v = torch.randn(1, hkv, skv, d, generator=gen, device=dev)
            q, k, v = (t.to(dtype) for t in (q, k, v))
            got = flash_attention(q, k, v, causal=False)
            torch.cuda.synchronize()
            want = attention_plain(q, k, v, causal=False).float()
            if not torch.isfinite(got).all():
                fail(f"flash {tag} {dtype}: non-finite output")
            err = (got.float() - want).abs().max().item()
            tol = TOL[str(dtype).split(".")[1]]
            held = f"max_abs_err {err:.3g} (tol {tol})"
            bad = err > tol
            plan = kv_split_plan(sq, skv, 0, False, None, hq)
            if dtype == torch.bfloat16:
                split = attention_split_plain(q, k, v, plan,
                                              causal=False).float()
                rels = [((got.float() - w).abs().max()
                         / w.abs().max().clamp_min(1e-30)).item()
                        for w in (want, split)]
                held += (f", max_err/max vs plain {rels[0]:.3g}, vs split "
                         f"plain {rels[1]:.3g} (tol {BF16_SPLIT_REL}), plan "
                         f"{plan.splits} split(s) x {plan.tiles_per_split} "
                         f"kv tiles")
                bad = bad or max(rels) > BF16_SPLIT_REL
            print(f"[flash] whisper-tiny non-causal {tag} (Sq {sq}, Skv "
                  f"{skv}) {str(dtype)[6:]}: {held}", flush=True)
            if bad:
                fail(f"flash {tag} {dtype}: {held}")
            if dtype == torch.bfloat16 and tag in ("whisper_enc",
                                                   "whisper_cross"):
                call = lambda: flash_attention(q, k, v, causal=False)
                lib, lib_name = sdpa_yardstick(q, k, v, None, 0,
                                               causal=False)
                bound_ms, bound_by = attention_bound_ms(q, k, v, False,
                                                        None, 0)
                timed[tag] = dict(
                    max_abs_err=err, ms=time_ms(call),
                    plain_ms=time_ms(lambda: attention_plain(
                        q, k, v, causal=False)),
                    bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=time_ms(lib), device_ms=device_ms(call),
                    library_device_ms=device_ms(lib))
                t = timed[tag]
                print(f"[flash] timed whisper-tiny {tag} (B1 Hq{hq}/Hkv"
                      f"{hkv} Sq{sq} Skv{skv} D{d} non-causal bf16, plan "
                      f"{plan.splits} x {plan.tiles_per_split}): kernel "
                      f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, sdpa "
                      f"{t['library_ms']:.4f} ms ({lib_name}), bound "
                      f"{bound_ms:.5f} ms ({bound_by}); on the device "
                      f"(torch.profiler) kernel {fmt_ms(t['device_ms'])}, "
                      f"sdpa {fmt_ms(t['library_device_ms'])}", flush=True)
            del q, k, v, got, want
    return timed


def ssd_bound_ms(x, b, chunk, with_init):
    """Least time for the SSD call: the larger of its operations (C·Bᵀ
    once per group, the other three products per head, for the rows of
    each chunk; C·Bᵀ and W·X over the causal triangle only, i ≥ j, as the
    scan needs them) at the bf16 tensor-core peak, or at the CUDA cores' fp32
    peak for fp32 inputs (the kernel runs no TF32), and its bytes (x, dt,
    B, C and the state in, y and the state out, once each) at the memory
    rate."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    flops = 0.0
    for lo in range(0, s, chunk):
        r = min(chunk, s - lo)
        flops += bsz * (r * (r + 1.0) * n * g      # C·Bᵀ, the causal half
                        + h * (r * (r + 1.0) * p     # W·X, the causal half
                               + 2 * 2.0 * r * n * p))
    state_bytes = bsz * h * n * p * 4
    nbytes = (2 * x.numel() * x.element_size() + bsz * s * h * 4
              + 2 * b.numel() * b.element_size()
              + (2 if with_init else 1) * state_bytes + 2 * h * 4)
    peak = PEAK_FP32_FLOPS if x.element_size() == 4 else PEAK_BF16_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


#: (label, B, S, H, P, N, with init_state) of the SSD phases, chunk 128
SSD_CASES = [("mamba2 S2048", 1, 2048, 80, 64, 128, False),
             ("mamba2 S1000 ragged", 1, 1000, 80, 64, 128, False),
             ("mamba2 chunk128+state", 1, 128, 80, 64, 128, True),
             ("mamba2 B2 S384+state", 2, 384, 80, 64, 128, True),
             ("zamba2 S512", 1, 512, 112, 64, 64, False)]


def ssd_case_inputs(gen, bsz, s, h, p, n, with_init, dtype):
    """x, dt, a, b, c, d and init_state (or None) of an SSD case, drawn on
    the card as the model makes them."""
    import torch

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = randn(bsz, s, h, p).to(dtype)
    dt = torch.nn.functional.softplus(randn(bsz, s, h))
    a = -torch.exp(torch.log(torch.linspace(1.0, 16.0, h, device=dev)))
    b = randn(bsz, s, 1, n).to(dtype)
    c = randn(bsz, s, 1, n).to(dtype)
    d = torch.ones(h, device=dev)
    init = randn(bsz, h, n, p) if with_init else None
    return (x, dt, a, b, c, d), init


def phase_ssd_kernels():
    """SSD kernel vs ``ssd_plain`` on the card at the mamba2-2.7b head
    shapes and one zamba2 shape; returns every case's numbers by (label,
    dtype name)."""
    import torch

    from repro_torch.kernels.ssd import SSD, ssd, ssd_plain

    report = SSD.ptxas_report().splitlines()
    for line in report:
        if "C7519" not in line and ("registers" in line or "spill" in line
                                    or "smem" in line):
            print(f"[ptxas] {line.strip()}")
    print(f"[ptxas] ssd: {sum('C7519' in line for line in report)} wgmma "
          f"register fences inserted by ptxas (C7519)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    chunk = 128
    out = {}
    for label, bsz, s, h, p, n, with_init in SSD_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            args, init = ssd_case_inputs(gen, bsz, s, h, p, n, with_init,
                                         dtype)
            x, _, _, b, c, _ = args
            kw = dict(chunk=chunk, init_state=init)
            y, st = ssd(*args, **kw)
            torch.cuda.synchronize()
            y_want, st_want = ssd_plain(*args, **kw)
            if not (torch.isfinite(y).all() and torch.isfinite(st).all()):
                fail(f"ssd {label} {dtype}: non-finite output")
            err_y = ((y.float() - y_want.float()).abs().max()
                     / y_want.float().abs().max()).item()
            err_s = ((st - st_want).abs().max() / st_want.abs().max()).item()
            tol_y = 2e-2 if dtype == torch.bfloat16 else 1e-4
            name = str(dtype).split(".")[1]
            print(f"[ssd] {label} {name}: y max_err/max {err_y:.3g} "
                  f"(tol {tol_y}), state {err_s:.3g} (tol 1e-4)", flush=True)
            if err_y > tol_y or err_s > 1e-4:
                fail(f"ssd {label} {dtype}: errors {err_y}, {err_s}")
            kernel_ms = time_ms(lambda: ssd(*args, **kw))
            dev_ms, n_kernels, split = device_kernels(
                lambda: ssd(*args, **kw))
            want_kernels = 1 if s <= chunk else 3
            if n_kernels != want_kernels:
                fail(f"ssd {label} {name}: {n_kernels} device events a "
                     f"call, expected {want_kernels} CUDA kernels")
            bound_ms, bound_by = ssd_bound_ms(x, b, chunk, with_init)
            rec = dict(max_abs_err=(y.float() - y_want.float()).abs().max()
                       .item(), ms=kernel_ms, device_ms=dev_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       cuda_kernels_a_call=n_kernels,
                       kernel_device_ms=[[k, t] for k, t in split])
            if dtype == torch.bfloat16 and label in (
                    "mamba2 S2048", "mamba2 chunk128+state"):
                rec["plain_ms"] = time_ms(lambda: ssd_plain(*args, **kw),
                                          iters=5)
            out[(label, name)] = rec
            print(f"[ssd] {label} {name}: kernel {kernel_ms:.4f} ms by "
                  f"events, {fmt_ms(dev_ms)} on the device "
                  f"({n_kernels} CUDA kernels a call: "
                  + " + ".join(f"{k} {t:.4f}" for k, t in split) + "), "
                  f"plain {fmt_ms(rec.get('plain_ms'))}, bound "
                  f"{bound_ms:.5f} ms ({bound_by})", flush=True)
            del args, x, b, c, y, st, y_want, st_want
    return out


SSD_GRADS = ("dx", "ddt", "da", "db", "dc", "dd", "dinit")
# the SSD backward against ssd_bwd_plain on fp32-upcast inputs, max |error|
# over max |plain| by gradient.  fp32: full fp32 on the CUDA cores in
# another order, 1e-4; ddt and da 5e-4, sums of both signs through the
# reverse cumsum of dcum (the fp32 plain version alone is up to 6e-5 from
# fp64 at S 2048).  bf16: 1e-2 -- dx, dB and dC are written in bf16 (half
# an ulp is 2^-8 of a value) and the forward keeps the entering states in
# bf16 (~2^-9 of the terms that read them).
SSD_BWD_TOL = {"float32": dict.fromkeys(SSD_GRADS, 1e-4)
               | {"ddt": 5e-4, "da": 5e-4},
               "bfloat16": dict.fromkeys(SSD_GRADS, 1e-2)}
# the bf16 backward against ssd_bwd_bf16_emulated (its roundings in plain
# PyTorch) on the same inputs and kept entering states, max |error| over
# max |emulation|, d init_state with or without one: dx, dB and dC 2^-8
# (written in bf16; fp32 sums in another order may round to the
# neighbouring bf16), dd and d init_state 1e-4, each above the sound
# build's reading and below that of a build whose split fp32 operands lose
# their low parts (probe_bwd's no_lo; PERF.md); ddt and da 5e-4, as the
# fp32 backward's: sum-order noise through the reverse cumsum, which at S
# 2048 is as large as what the low parts add to them
SSD_BWD_EMU_TOL = dict.fromkeys(("dx", "db", "dc"), 2.0 ** -8) \
    | dict.fromkeys(("dd", "dinit"), 1e-4) \
    | dict.fromkeys(("ddt", "da"), 5e-4)
#: the backward's training shape: one microbatch of the mamba2 phase
SSD_TRAIN_CASE = ("mamba2 B4 S2048 (train)", 4, 2048, 80, 64, 128, False)


def ssd_bwd_bound_ms(x, b, chunk, with_init):
    """Least time for the SSD backward: the larger of its operations and its
    bytes.  Operations, for the rows of each chunk: C·Bᵀ once a group and
    dy·xᵀ, Wᵀ·dy, dSᵀ·C and dS·B a head over the causal triangle (i ≥ j),
    and four row-by-state products a head (dlocal, B·g, x·gᵀ, dy·s_inᵀ),
    at the bf16 tensor-core peak for bf16 inputs and the CUDA cores' fp32
    peak for fp32.  Bytes: x, dy, dt, B, C (and init_state and dstate where
    given) in, dx, ddt, dB, dC (and d init_state) out, once each."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    flops = 0.0
    for lo in range(0, s, chunk):
        r = min(chunk, s - lo)
        tri = r * (r + 1.0) / 2
        flops += 2 * bsz * (tri * n * g
                            + h * (2 * tri * (p + n) + 4.0 * r * n * p))
    state_bytes = bsz * h * n * p * 4
    nbytes = (3 * x.numel() * x.element_size() + 2 * bsz * s * h * 4
              + 4 * b.numel() * b.element_size()
              + (3 * state_bytes if with_init else 0) + 4 * h * 4)
    peak = PEAK_FP32_FLOPS if x.element_size() == 4 else PEAK_BF16_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_ssd_bwd():
    """The SSD backward kernels vs ``ssd_bwd_plain`` on the card at the
    forward phase's shapes (bf16 and fp32, a random dstate where there is
    an init_state) and at the training microbatch (bf16), and bf16 against
    its rounding plan (``ssd_bwd_bf16_emulated``); two calls must give the
    same bits.  Returns every case's numbers by (label, dtype name)."""
    import torch

    from repro_torch.kernels.ssd import (
        SSD_BWD,
        ssd_bwd,
        ssd_bwd_bf16_emulated,
        ssd_bwd_plain,
    )
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ops import _forward

    report = SSD_BWD.ptxas_report().splitlines()
    for line in report:
        if "C7519" not in line and ("registers" in line or "spill" in line
                                    or "smem" in line or "C7520" in line):
            print(f"[ptxas] {line.strip()}")
    print(f"[ptxas] ssd_bwd: {sum('C7519' in line for line in report)} wgmma "
          f"register fences inserted by ptxas (C7519), "
          f"{sum('C7520' in line for line in report)} kernels with their "
          f"wgmmas serialized (C7520)")
    gen = torch.Generator(device="cuda").manual_seed(1)
    chunk = 128
    out = {}
    cases = [(case, dtype) for case in SSD_CASES
             for dtype in (torch.bfloat16, torch.float32)]
    cases.append((SSD_TRAIN_CASE, torch.bfloat16))
    for (label, bsz, s, h, p, n, with_init), dtype in cases:
        name = str(dtype).split(".")[1]
        args, init = ssd_case_inputs(gen, bsz, s, h, p, n, with_init, dtype)
        x, b = args[0], args[3]
        dl_occ, ch_occ = ssd_ops.bwd_occupancy(chunk, n, p, dtype)
        dl_smem, ch_smem = ssd_ops.bwd_smem(chunk, n, p, dtype)
        dy = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
        dstate = (torch.randn(init.shape, generator=gen, device="cuda")
                  if with_init else None)
        _, _, s_in = _forward(*args, chunk, init)
        kw = dict(chunk=chunk, init_state=init, s_in=s_in)
        # the scratch a call allocates, by the caching allocator: its peak
        # during the call less what the call leaves allocated (the grads)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        got = ssd_bwd(*args, dy, dstate, **kw)
        torch.cuda.synchronize()
        scratch = (torch.cuda.max_memory_allocated()
                   - torch.cuda.memory_allocated())
        plan = dict(ssd_ops.BWD_LAUNCHED)
        _, modelled = ssd_ops.bwd_scratch_bytes(
            bsz, s, h, b.shape[2], n, p, chunk, dtype, plan["heads_a_block"])
        print(f"[ssd-bwd] {label} {name}: launched {plan['heads_a_block']} "
              f"heads a block, {plan['blocks']} blocks of dlocal and of the "
              f"chunks kernel; shared memory a block {dl_smem} / {ch_smem} "
              f"B, blocks an SM {dl_occ} / {ch_occ} (occupancy query); "
              f"scratch {scratch / 1e6:.1f} MB (allocator: the call's peak "
              f"less what it keeps); {modelled / 1e6:.1f} MB moved by the "
              f"model ops.bwd_scratch_bytes (each buffer written and read "
              f"once; not measured)", flush=True)
        again = ssd_bwd(*args, dy, dstate, **kw)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(u, v) for u, v in zip(got, again))
        del again
        up = [t.float() for t in args]
        want = ssd_bwd_plain(*up, dy.float(), dstate, chunk=chunk,
                             init_state=init)
        errs, worst_abs = {}, 0.0
        for gname, u, w in zip(SSD_GRADS, got, want):
            if gname == "dinit" and not with_init:
                continue
            if not torch.isfinite(u).all():
                fail(f"ssd_bwd {label} {name}: non-finite {gname}")
            diff = (u.float() - w).abs().max().item()
            worst_abs = max(worst_abs, diff)
            errs[gname] = diff / w.abs().max().item()
        tol = SSD_BWD_TOL[name]
        print(f"[ssd-bwd] {label} {name}: max_err/max "
              + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
              + f" (tol {tol['dx']:g}, ddt/da {tol['da']:g}); two calls "
              f"bitwise equal: {bitwise}", flush=True)
        if not bitwise:
            fail(f"ssd_bwd {label} {name}: two calls differ")
        bad = {k: v for k, v in errs.items() if v > tol[k]}
        if bad:
            fail(f"ssd_bwd {label} {name}: out of tolerance: {bad}")
        del want, up
        if dtype == torch.bfloat16:
            # the precision plan: the same kept states, the kernels' roundings
            emu = ssd_bwd_bf16_emulated(*args, dy, dstate, ht=plan[
                "heads_a_block"], **kw)
            emu_errs = {gname: ((u.float() - w.float()).abs().max()
                                / w.float().abs().max()).item()
                        for gname, u, w in zip(SSD_GRADS, got, emu)}
            print(f"[ssd-bwd] {label} {name}: against the bf16 emulation "
                  f"on the kept states, max_err/max "
                  + ", ".join(f"{k} {v:.3g}" for k, v in emu_errs.items())
                  + f" (tol dx/dB/dC {SSD_BWD_EMU_TOL['dx']:g}, dd/dinit "
                  f"{SSD_BWD_EMU_TOL['dd']:g}, ddt/da "
                  f"{SSD_BWD_EMU_TOL['ddt']:g})", flush=True)
            bad = {k: v for k, v in emu_errs.items()
                   if v > SSD_BWD_EMU_TOL[k]}
            if bad:
                fail(f"ssd_bwd {label} {name}: off the bf16 emulation: "
                     f"{bad}")
            del emu
        del got
        call = lambda: ssd_bwd(*args, dy, dstate, **kw)   # noqa: E731
        kernel_ms = time_ms(call, iters=10)
        dev_ms, n_kernels, split = device_kernels(call, iters=10)
        if n_kernels != ssd_ops.SSD_BWD_KERNELS:
            fail(f"ssd_bwd {label} {name}: {n_kernels} device events a "
                 f"call, expected {ssd_ops.SSD_BWD_KERNELS} CUDA kernels")
        bound_ms, bound_by = ssd_bwd_bound_ms(x, b, chunk, with_init)
        rec = dict(max_err=errs, max_abs_err=worst_abs, ms=kernel_ms,
                   device_ms=dev_ms, bound_ms=bound_ms, bound_by=bound_by,
                   cuda_kernels_a_call=n_kernels,
                   kernel_device_ms=[[k, t] for k, t in split],
                   scratch_bytes=scratch)
        if dtype == torch.bfloat16 and label in (
                "mamba2 S2048", "mamba2 chunk128+state", SSD_TRAIN_CASE[0]):
            rec["plain_ms"] = time_ms(lambda: ssd_bwd_plain(
                *args, dy, dstate, chunk=chunk, init_state=init), iters=3,
                warmup=1)
        out[(label, name)] = rec
        print(f"[ssd-bwd] {label} {name}: kernels {kernel_ms:.4f} ms by "
              f"events, {fmt_ms(dev_ms)} on the device ({n_kernels} CUDA "
              f"kernels a call: "
              + " + ".join(f"{k} {t:.4f}" for k, t in split) + "), plain "
              f"{fmt_ms(rec.get('plain_ms'))}, bound {bound_ms:.5f} ms "
              f"({bound_by})", flush=True)
        del args, x, b, dy, dstate, s_in
    return out


def phase_serve():
    """Full-width smollm-360m, contiguous then paged; returns the flash
    launches of the two runs."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import FLASH
    from repro_torch.kernels.ssd import SSD
    from repro_torch.models.model import count_params, init_params
    from repro_torch.runtime.server import Server, ServerConfig, drive_arrivals

    cfg = get_config("smollm-360m")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name} full width, {count_params(params)/1e6:.1f}M "
          f"params in {cfg.param_dtype}, init {time.perf_counter()-t0:.1f}s",
          flush=True)
    rng = np.random.default_rng(0)
    lens = rng.integers(256, 1025, size=8)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)) for n in lens]
    chunk = 128
    want_chunks = int(sum(-(-int(n) // chunk) for n in lens))
    outs = {}
    FLASH.launches = SSD.launches = 0
    for mode, extra in (("contiguous", {}),
                        ("paged", dict(paged=True, block_size=128))):
        before = FLASH.launches
        srv = Server(cfg, params, ServerConfig(
            max_batch=4, max_seq=2048, max_new_tokens=32,
            prefill_chunk=chunk, **extra))
        t0 = time.perf_counter()
        steps = drive_arrivals(srv, prompts, every=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = srv.stats()
        n = FLASH.launches - before
        print(f"[serve:{mode}] {st['requests']} requests, {st['tokens']} "
              f"tokens in {steps} steps, {wall:.2f}s; prefill "
              f"{st['prefill_tok_s']:.1f} tok/s, decode "
              f"{st['decode_tok_s']:.1f} tok/s, ttft "
              f"{st['mean_ttft_s']*1e3:.1f} ms, itl "
              f"{st['mean_itl_s']*1e3:.2f} ms; flash launches {n} over "
              f"{st['prefill_chunks']} prefill chunks", flush=True)
        if st["requests"] != len(prompts) or any(
                len(r.out_tokens) != 32 for r in srv.done):
            fail(f"{mode}: not every request answered with 32 tokens")
        if st["prefill_chunks"] != want_chunks:
            fail(f"{mode}: {st['prefill_chunks']} prefill chunks run, "
                 f"expected {want_chunks}")
        if n != cfg.n_layers * want_chunks:
            fail(f"{mode}: flash launched {n} times, expected "
                 f"{cfg.n_layers} x {want_chunks}")
        outs[mode] = {r.rid: r.out_tokens for r in srv.done}
        del srv
    launches = FLASH.launches
    if SSD.launches:
        fail(f"smollm: ssd launched {SSD.launches} times (expected 0)")
    if outs["paged"] != outs["contiguous"]:
        fail("paged tokens differ from contiguous tokens")
    print(f"[serve] paged == contiguous: {len(outs['paged'])} requests "
          f"token-identical", flush=True)
    return launches


def drive_recorded(srv, items):
    """Drive ``srv`` through ``items`` (one arrival every 2 steps) with
    every kernel count set to 0 just before, recording each request's
    first-token logits: (steps, wall s, peak GiB, kernel counts, {rid:
    logits})."""
    import torch

    from repro_torch.runtime.server import drive_arrivals

    first = {}
    emit = srv._emit_first_token

    def record(i, req, logits):
        first[req.rid] = logits[0].float().cpu()
        emit(i, req, logits)

    srv._emit_first_token = record
    reset_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    steps = drive_arrivals(srv, items, every=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = kernel_counts()
    # the hook holds the server through the bound method it wraps: a
    # cycle that only Python's cyclic collector frees, which kept the
    # server's weights and caches (5.7 GiB) allocated phases later
    del srv._emit_first_token
    return steps, wall, peak, counts, first


def print_profiles(tag, calls):
    """Each ``(label, call)`` once under torch.profiler: its wall time,
    the device's idle share of it (how far the host holds the card back),
    the port's device events and the top device ops."""
    for label, call in calls:
        call()
        top, idle, wall_ms, events = profile_call(call)
        busy = sum(ms for _, ms, _ in top)
        print(f"[{tag}] profiled {label}: {wall_ms:.2f} ms wall, device "
              f"idle share {'not measured' if idle is None else f'{idle:.4f}'}"
              f", port device events {events}; top device ops "
              f"{busy:.3f} ms:", flush=True)
        for name, ms, n in top[:6]:
            print(f"[{tag}]   {ms:8.3f} ms  x{n:<5} {name[:90]}", flush=True)


def phase_serve_state(arch):
    """Full-width ``arch`` (mamba2-2.7b, phase 4; zamba2-7b, phase 4b) in
    bf16, chunked then bulk admission, then the fp32 check; returns the
    SSD and flash launches of the two server runs."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist.steps import serve_step
    from repro_torch.models.decode import init_cache
    from repro_torch.models.model import (
        count_params,
        count_params_analytic,
        init_params,
        n_applications,
    )
    from repro_torch.models.prefill import (
        init_prefill_scratch,
        prefill,
        prefill_chunk,
        prefill_chunk_cuts,
    )
    from repro_torch.runtime.server import Server, ServerConfig

    cfg = get_config(arch)
    tag = arch.split("-")[0]
    apps = n_applications(cfg) if cfg.family == "hybrid" else 0
    t_phase = t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = count_params(params)
    print(f"[{tag}] {cfg.name} full width, {n_params/1e6:.1f}M params in "
          f"{cfg.param_dtype}, init {time.perf_counter()-t0:.1f}s", flush=True)
    if n_params != count_params_analytic(cfg):
        fail(f"{tag}: {n_params} params, expected "
             f"{count_params_analytic(cfg)}")
    rng = np.random.default_rng(0)
    lens = rng.integers(256, 1025, size=6)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)) for n in lens]
    chunk, max_new = 128, 16
    want_chunks = int(sum(-(-int(n) // chunk) for n in lens))
    runs = {}
    launches = {"ssd": 0, "flash": 0}
    for mode, admit_chunk, passes in (("chunked", chunk, want_chunks),
                                      ("bulk", None, len(prompts))):
        srv = Server(cfg, params, ServerConfig(
            max_batch=4, max_seq=2048, max_new_tokens=max_new,
            prefill_chunk=admit_chunk))
        steps, wall, peak, counts, first = drive_recorded(srv, prompts)
        want = dict.fromkeys(counts, 0)
        want.update(ssd=cfg.n_layers * passes,
                    flash_attention=apps * passes)
        launches["ssd"] += counts["ssd"]
        launches["flash"] += counts["flash_attention"]
        st = srv.stats()
        print(f"[{tag}:{mode}] {st['requests']} requests, {st['tokens']} "
              f"tokens in {steps} steps, {wall:.2f}s; prefill "
              f"{st['prefill_tok_s']:.1f} tok/s, decode "
              f"{st['decode_tok_s']:.1f} tok/s, ttft "
              f"{st['mean_ttft_s']*1e3:.1f} ms, itl "
              f"{st['mean_itl_s']*1e3:.2f} ms, peak {peak:.2f} GiB; ssd "
              f"launches {counts['ssd']}, flash {counts['flash_attention']} "
              f"over {st['prefill_chunks']} prefill passes", flush=True)
        if st["requests"] != len(prompts) or any(
                len(r.out_tokens) != max_new for r in srv.done):
            fail(f"{tag} {mode}: not every request answered with "
                 f"{max_new} tokens")
        if st["prefill_chunks"] != passes or counts != want:
            fail(f"{tag} {mode}: {st['prefill_chunks']} prefill passes "
                 f"(expected {passes}), launches {counts} (expected "
                 f"{want}: ssd {cfg.n_layers} and flash {apps} a pass)")
        if not all(torch.isfinite(v).all() for v in first.values()):
            fail(f"{tag} {mode}: non-finite first-token logits")
        runs[mode] = ({r.rid: r.out_tokens for r in srv.done}, first)
        del srv
    (tok_c, first_c), (tok_b, first_b) = runs["chunked"], runs["bulk"]
    agree = sum(a == b for r in tok_b for a, b in zip(tok_c[r], tok_b[r]))
    total = sum(len(t) for t in tok_b.values())

    # where a server step's time goes: one decode step of a full batch
    # over 2048 slots, and one 128-token prefill chunk at 512 of a
    # 1024-token carry, each under torch.profiler (the device's idle
    # share of the call says how far the host holds the card back)
    cache = init_cache(cfg, 4, 2048, "cuda")
    step_toks = torch.zeros(4, dtype=torch.long, device="cuda")
    scr = init_prefill_scratch(cfg, 1, 1024, "cuda")
    chunk_toks = torch.as_tensor(prompts[0][None, :chunk], dtype=torch.long,
                                 device="cuda")
    print_profiles(tag, (
        ("decode step, batch 4 over 2048 slots",
         lambda: serve_step(cfg, params, cache, step_toks)),
        (f"prefill chunk, {chunk} rows at 512",
         lambda: prefill_chunk(cfg, params, scr, chunk_toks, 512))))
    del cache, scr

    # The same prompts in fp32 (the bf16 weights, widened), bulk and in
    # 128-token chunks outside the server: chunked ≡ bulk is held here, in
    # fp32, where only the GEMMs' summation order differs between the two.
    # bf16 rounding alone moves these random-init models' first-token
    # logits by several percent of their largest magnitude against fp32
    # (mamba2: ~7.5%; two bf16 runs whose GEMMs round differently as far
    # apart), so each bf16 server run is held to the fp32 logits at 1.5e-1
    # instead of to each other; a fault in the carry or a kernel moves
    # them by O(1).
    torch.backends.cuda.matmul.allow_tf32 = False       # full fp32 GEMMs
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    params32 = widen(params)
    del params
    err = {"c16-b16": 0.0, "c32-b32": 0.0, "c16-b32": 0.0, "b16-b32": 0.0}
    for rid, prompt in enumerate(prompts):
        toks = torch.as_tensor(prompt[None, :], dtype=torch.long,
                               device="cuda")
        _, b32 = prefill(cfg32, params32, toks)
        scr = init_prefill_scratch(cfg32, 1, toks.shape[1], "cuda")
        for lo, hi in prefill_chunk_cuts(toks.shape[1], chunk_len=chunk,
                                         multiple=cfg.ssm_chunk):
            scr, c32 = prefill_chunk(cfg32, params32, scr, toks[:, lo:hi], lo)
        b32, c32 = b32[0].cpu(), c32[0].cpu()
        for key, (got, want) in {"c16-b16": (first_c[rid], first_b[rid]),
                                 "c32-b32": (c32, b32),
                                 "c16-b32": (first_c[rid], b32),
                                 "b16-b32": (first_b[rid], b32)}.items():
            e = ((got - want).abs().max() / want.abs().max()).item()
            err[key] = max(err[key], e)
    del params32, scr
    peak32 = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{tag}] first-token logits, max_err/max over the 6 requests: "
          f"bf16 chunked vs bulk {err['c16-b16']:.3g}; fp32 chunked vs bulk "
          f"{err['c32-b32']:.3g} (tol 1e-3); bf16 chunked vs fp32 "
          f"{err['c16-b32']:.3g}, bf16 bulk vs fp32 {err['b16-b32']:.3g} "
          f"(tol 1.5e-1); generated tokens agree {agree}/{total} "
          f"({agree / total:.1%}); fp32 check peak {peak32:.2f} GiB; phase "
          f"{time.perf_counter() - t_phase:.1f}s", flush=True)
    if not (err["c32-b32"] <= 1e-3 and err["c16-b32"] <= 1.5e-1
            and err["b16-b32"] <= 1.5e-1):
        fail(f"{tag}: first-token logits out of tolerance: {err}")
    return launches


#: the serving phases of :func:`phase_serve_runs`: requests, the range
#: of their text or decoder prompt lengths, new tokens, max_seq and the
#: two server runs (each admitting in 128-row chunks or in one bulk pass
#: per request)
SERVE_RUNS = {
    "internvl2-2b": (8, (256, 1024), 32, 2048, (
        ("contiguous", dict(prefill_chunk=128)),
        ("paged", dict(prefill_chunk=128, paged=True, block_size=128)))),
    "whisper-tiny": (6, (64, 448), 16, 512, (
        ("chunked", dict(prefill_chunk=128)),
        ("bulk", dict(prefill_chunk=None)))),
    # MLA has no paged layout (its cache is the latent, not K/V rows)
    "minicpm3-4b": (8, (256, 1024), 32, 2048, (
        ("chunked", dict(prefill_chunk=128)),
        ("bulk", dict(prefill_chunk=None)))),
}
#: depth cuts of phase 3's full-width serving, every width kept:
#: minicpm3 at 31 of its 62 layers (all 62 took ~25 s more of the time
#: limit)
SERVE_LAYERS = {"minicpm3-4b": 31}


def flash_per_pass(cfg, lo):
    """Flash launches of a prefill pass (a chunk at row ``lo``, or a bulk
    pass at 0): one a dense block, and for the encoder-decoder one a
    decoder layer's self- and one its cross-attention, plus the encoder's
    layers where the pass runs the encoder (chunk 0 and bulk)."""
    if cfg.family == "encdec":
        return 2 * cfg.n_layers + (cfg.n_encoder_layers if lo == 0 else 0)
    return cfg.n_layers


def phase_serve_runs(arch):
    """Full-width ``arch`` (internvl2-2b, phase 3b; whisper-tiny, phase 3c;
    minicpm3-4b, phase 3d) in bf16 through the server, a frontend arch's
    request carrying its embeddings (256 patch rows of width 1024; 1500
    frames of width 384), in the two runs of ``SERVE_RUNS``; then one
    profiled decode step and prefill chunk, and the fp32 check of phase
    4.  Returns the flash launches of the two server runs."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist.steps import serve_step
    from repro_torch.models.decode import init_cache
    from repro_torch.models.model import (
        count_params,
        count_params_analytic,
        init_params,
    )
    from repro_torch.models.prefill import (
        chunk_rows,
        init_prefill_scratch,
        prefill,
        prefill_chunk,
        prefill_chunk_cuts,
        prefill_rows,
    )
    from repro_torch.runtime.server import Server, ServerConfig

    cfg = get_config(arch)
    depth = f"all {cfg.n_layers} layers"
    if arch in SERVE_LAYERS:
        depth = f"{SERVE_LAYERS[arch]} of {cfg.n_layers} layers"
        cfg = dataclasses.replace(cfg, n_layers=SERVE_LAYERS[arch])
    tag = arch.split("-")[0]
    n_req, (lo_len, hi_len), max_new, max_seq, runs = SERVE_RUNS[arch]
    t_phase = t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = count_params(params)
    print(f"[{tag}] {cfg.name} full width at {depth}, {n_params/1e6:.1f}M "
          f"params in {cfg.param_dtype}, init "
          f"{time.perf_counter()-t0:.1f}s", flush=True)
    if n_params != count_params_analytic(cfg):
        fail(f"{tag}: {n_params} params, expected "
             f"{count_params_analytic(cfg)}")
    rng = np.random.default_rng(0)
    lens = rng.integers(lo_len, hi_len + 1, size=n_req)
    items = [(rng.integers(0, cfg.vocab_size, size=int(n)),
              rng.standard_normal((cfg.frontend_tokens, cfg.frontend_dim),
                                  dtype=np.float32) if cfg.frontend
              else None) for n in lens]
    rows = [prefill_rows(cfg, int(n)) for n in lens]
    chunk = 128
    out, launches = {}, 0
    for mode, extra in runs:
        admit = extra["prefill_chunk"]
        starts = [lo for r in rows for lo, _ in (
            prefill_chunk_cuts(r, chunk_len=admit) if admit else [(0, r)])]
        srv = Server(cfg, params, ServerConfig(
            max_batch=4, max_seq=max_seq, max_new_tokens=max_new, **extra))
        steps, wall, peak, counts, first = drive_recorded(srv, items)
        want = dict.fromkeys(counts, 0)
        want["flash_attention"] = sum(flash_per_pass(cfg, lo)
                                      for lo in starts)
        launches += counts["flash_attention"]
        st = srv.stats()
        print(f"[{tag}:{mode}] {st['requests']} requests, {st['tokens']} "
              f"tokens in {steps} steps, {wall:.2f}s; prefill "
              f"{st['prefill_tokens']} rows, {st['prefill_tok_s']:.1f} "
              f"tok/s, decode {st['decode_tok_s']:.1f} tok/s, ttft "
              f"{st['mean_ttft_s']*1e3:.1f} ms, itl "
              f"{st['mean_itl_s']*1e3:.2f} ms, peak {peak:.2f} GiB; flash "
              f"launches {counts['flash_attention']} over "
              f"{st['prefill_chunks']} prefill passes", flush=True)
        if st["requests"] != n_req or any(
                len(r.out_tokens) != max_new for r in srv.done):
            fail(f"{tag} {mode}: not every request answered with "
                 f"{max_new} tokens")
        if st["prefill_chunks"] != len(starts) or counts != want:
            fail(f"{tag} {mode}: {st['prefill_chunks']} prefill passes "
                 f"(expected {len(starts)}), launches {counts} (expected "
                 f"{want})")
        if not all(torch.isfinite(v).all() for v in first.values()):
            fail(f"{tag} {mode}: non-finite first-token logits")
        out[mode] = ({r.rid: r.out_tokens for r in srv.done}, first)
        del srv
    (a, (tok_a, first_a)), (b, (tok_b, first_b)) = out.items()
    agree = sum(x == y for r in tok_b for x, y in zip(tok_a[r], tok_b[r]))
    total = sum(len(t) for t in tok_b.values())
    if b == "paged" and tok_a != tok_b:
        fail(f"{tag}: paged tokens differ from contiguous tokens")

    # one decode step of a full batch, and one 128-row prefill chunk (at
    # row 512 of the longest request's carry; whisper's chunk 0, which
    # runs the encoder), each under torch.profiler
    cache = init_cache(cfg, 4, max_seq, "cuda")
    step_toks = torch.zeros(4, dtype=torch.long, device="cuda")
    carry = rows[int(np.argmax(rows))]
    lo = 0 if cfg.family == "encdec" else 512
    scr = init_prefill_scratch(cfg, 1, carry, "cuda")
    t_rows, f_rows = chunk_rows(cfg, lo, lo + chunk)
    prompt, fe = items[int(np.argmax(rows))]
    chunk_toks = torch.as_tensor(prompt[None, t_rows], dtype=torch.long,
                                 device="cuda")
    chunk_fe = (None if f_rows is None else
                torch.as_tensor(fe[None, f_rows], device="cuda"))
    print_profiles(tag, (
        (f"decode step, batch 4 over {max_seq} slots",
         lambda: serve_step(cfg, params, cache, step_toks)),
        (f"prefill chunk, {chunk} rows at {lo}",
         lambda: prefill_chunk(cfg, params, scr, chunk_toks, lo, chunk_fe))))
    del cache, scr

    # phase 4's fp32 check: the same requests in fp32 (the bf16 weights
    # widened), bulk and in 128-row chunks outside the server; chunked ≡
    # bulk at 1e-3 of the largest first-token logit, each bf16 server
    # run against fp32 at 1.5e-1
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    params32 = widen(params)
    del params
    err = {f"{a}-{b}": 0.0, "c32-b32": 0.0, f"{a}-b32": 0.0,
           f"{b}-b32": 0.0}
    for rid, (prompt, fe) in enumerate(items):
        toks = torch.as_tensor(prompt[None, :], dtype=torch.long,
                               device="cuda")
        fet = None if fe is None else torch.as_tensor(fe[None],
                                                      device="cuda")
        _, b32 = prefill(cfg32, params32, toks, fet)
        scr = init_prefill_scratch(cfg32, 1, rows[rid], "cuda")
        for lo, hi in prefill_chunk_cuts(rows[rid], chunk_len=chunk):
            t_rows, f_rows = chunk_rows(cfg, lo, hi)
            scr, c32 = prefill_chunk(cfg32, params32, scr, toks[:, t_rows],
                                     lo, None if f_rows is None
                                     else fet[:, f_rows])
        b32, c32 = b32[0].cpu(), c32[0].cpu()
        for key, (got, want) in {f"{a}-{b}": (first_a[rid], first_b[rid]),
                                 "c32-b32": (c32, b32),
                                 f"{a}-b32": (first_a[rid], b32),
                                 f"{b}-b32": (first_b[rid], b32)}.items():
            e = ((got - want).abs().max() / want.abs().max()).item()
            err[key] = max(err[key], e)
    del params32, scr
    peak32 = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{tag}] first-token logits, max_err/max over the {n_req} "
          f"requests: bf16 {a} vs {b} {err[f'{a}-{b}']:.3g}; fp32 chunked "
          f"vs bulk {err['c32-b32']:.3g} (tol 1e-3); bf16 {a} vs fp32 "
          f"{err[f'{a}-b32']:.3g}, bf16 {b} vs fp32 {err[f'{b}-b32']:.3g} "
          f"(tol 1.5e-1); generated tokens agree {agree}/{total} "
          f"({agree / total:.1%}); fp32 check peak {peak32:.2f} GiB; phase "
          f"{time.perf_counter() - t_phase:.1f}s", flush=True)
    if not (err["c32-b32"] <= 1e-3 and err[f"{a}-b32"] <= 1.5e-1
            and err[f"{b}-b32"] <= 1.5e-1):
        fail(f"{tag}: first-token logits out of tolerance: {err}")
    return launches


#: phase 3e: llama4-scout-17b-a16e at full width, its depth cut to 8 of
#: 48 layers (19.69 B parameters, 36.7 GiB in bf16), then the fp32 check
#: at 2 layers (6.47 B parameters, 25.9 GB)
MOE_ARCH, MOE_LAYERS, MOE_CHECK_LAYERS = "llama4-scout-17b-a16e", 8, 2
MOE_RUNS = (("contiguous", dict(prefill_chunk=128)),
            ("paged", dict(prefill_chunk=128, paged=True, block_size=128)),
            ("bulk", dict(prefill_chunk=None)))


def new_large_tensors(fn, numel):
    """The ops of one call of ``fn`` whose output is a new tensor (not a
    view of, or written into, one of its inputs) of at least ``numel``
    elements: [(op, shape, dtype)].  At an expert weight's size, such an
    op copies or casts one."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    def tensors(tree):
        return [t for t in tree_flatten(tree)[0]
                if isinstance(t, torch.Tensor)]

    hits = []

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins = {t.untyped_storage().data_ptr()
                   for t in tensors((args, kwargs))}
            hits.extend((str(func), tuple(t.shape), str(t.dtype))
                        for t in tensors(out) if t.numel() >= numel
                        and t.untyped_storage().data_ptr() not in ins)
            return out

    with Watch():
        fn()
    torch.cuda.synchronize()
    return hits


def moe_layer0_input(cfg, params, toks):
    """Layer 0's MoE input rows of a prompt (B, S, D): the embedding,
    attention and its residual, then the second norm."""
    import torch

    from repro_torch.models import layers as L

    lp = params["layers"][0]
    x = params["embed"][toks]
    pos = torch.arange(x.shape[1], device=x.device)
    h = x + L.attention(cfg, lp["attn"], L.rms_norm(lp["ln1"], x,
                                                     cfg.norm_eps), pos)
    return L.rms_norm(lp["ln2"], h, cfg.norm_eps)


def phase_serve_moe():
    """llama4-scout-17b-a16e at full width and 8 of its 48 layers in bf16
    through the server (``MOE_RUNS``), one profiled decode step and
    prefill chunk with the expert-weight copy check, then the fp32 check
    at 2 layers.  Returns the flash launches of the three server runs."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist.steps import serve_step
    from repro_torch.models.decode import init_cache
    from repro_torch.models.model import (
        count_params,
        count_params_analytic,
        init_params,
    )
    from repro_torch.models.prefill import (
        init_prefill_scratch,
        moe_chunk_agree_mask,
        prefill,
        prefill_chunk,
        prefill_chunk_cuts,
    )
    from repro_torch.runtime.server import Server, ServerConfig

    tag = "llama4"
    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    t_phase = t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = count_params(params)
    print(f"[{tag}] {cfg.name} full width, depth cut n_layers "
          f"{full.n_layers} -> {cfg.n_layers}: {n_params} params "
          f"(count_params_analytic {count_params_analytic(cfg)}; "
          f"{count_params_analytic(full)} at {full.n_layers} layers) in "
          f"{cfg.param_dtype}, {torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB, init {time.perf_counter() - t0:.1f}s", flush=True)
    if n_params != count_params_analytic(cfg):
        fail(f"{tag}: {n_params} params, expected "
             f"{count_params_analytic(cfg)}")
    rng = np.random.default_rng(0)
    lens = rng.integers(256, 1025, size=8)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)) for n in lens]
    chunk, max_new = 128, 32
    out, launches = {}, {}
    for mode, extra in MOE_RUNS:
        admit = extra["prefill_chunk"]
        passes = (sum(-(-int(n) // admit) for n in lens) if admit
                  else len(lens))
        srv = Server(cfg, params, ServerConfig(
            max_batch=4, max_seq=2048, max_new_tokens=max_new, **extra))
        steps, wall, peak, counts, first = drive_recorded(srv, prompts)
        want = dict.fromkeys(counts, 0)
        want["flash_attention"] = cfg.n_layers * passes
        launches[mode] = counts["flash_attention"]
        st = srv.stats()
        print(f"[{tag}:{mode}] {st['requests']} requests, {st['tokens']} "
              f"tokens in {steps} steps, {wall:.2f}s; prefill "
              f"{st['prefill_tokens']} rows, {st['prefill_tok_s']:.1f} "
              f"tok/s, decode {st['decode_tok_s']:.1f} tok/s, ttft "
              f"{st['mean_ttft_s']*1e3:.1f} ms, itl "
              f"{st['mean_itl_s']*1e3:.2f} ms, peak {peak:.2f} GiB; flash "
              f"launches {counts['flash_attention']} over "
              f"{st['prefill_chunks']} prefill passes", flush=True)
        if st["requests"] != len(prompts) or any(
                len(r.out_tokens) != max_new for r in srv.done):
            fail(f"{tag} {mode}: not every request answered with "
                 f"{max_new} tokens")
        if st["prefill_chunks"] != passes or counts != want:
            fail(f"{tag} {mode}: {st['prefill_chunks']} prefill passes "
                 f"(expected {passes}), launches {counts} (expected "
                 f"{want})")
        if not all(torch.isfinite(v).all() for v in first.values()):
            fail(f"{tag} {mode}: non-finite first-token logits")
        out[mode] = ({r.rid: r.out_tokens for r in srv.done}, first)
        del srv
    if out["paged"][0] != out["contiguous"][0]:
        fail(f"{tag}: paged tokens differ from contiguous tokens")
    (tok_c, first_c), (tok_b, first_b) = out["contiguous"], out["bulk"]
    agree = sum(x == y for r in tok_b for x, y in zip(tok_c[r], tok_b[r]))
    total = sum(len(t) for t in tok_b.values())
    err16 = max(((first_c[r] - first_b[r]).abs().max()
                 / first_b[r].abs().max()).item() for r in first_b)
    print(f"[{tag}] paged == contiguous: {len(tok_c)} requests "
          f"token-identical; bf16 chunked vs bulk first-token logits "
          f"max_err/max {err16:.3g} and generated tokens agree "
          f"{agree}/{total} (chunk-local capacity at factor "
          f"{cfg.capacity_factor}: not held)", flush=True)

    # one decode step of a full batch over 2048 slots, and one 128-row
    # chunk at 512 of a 1024-row carry, each under torch.profiler, then
    # once more under a dispatch mode that lists every op making a new
    # tensor the size of an expert weight (none expected: the experts'
    # products take the stacked weights as they lie)
    cache = init_cache(cfg, 4, 2048, "cuda")
    step_toks = torch.zeros(4, dtype=torch.long, device="cuda")
    scr = init_prefill_scratch(cfg, 1, 1024, "cuda")
    chunk_toks = torch.as_tensor(prompts[0][None, :chunk], dtype=torch.long,
                                 device="cuda")
    calls = (("decode step, batch 4 over 2048 slots",
              lambda: serve_step(cfg, params, cache, step_toks)),
             (f"prefill chunk, {chunk} rows at 512",
              lambda: prefill_chunk(cfg, params, scr, chunk_toks, 512)))
    print_profiles(tag, calls)
    expert_numel = params["layers"][0]["moe"]["w_up"].numel()
    for label, call in calls:
        hits = new_large_tensors(call, expert_numel)
        print(f"[{tag}] {label}: ops making a new tensor of >= "
              f"{expert_numel} elements (an expert weight's size): "
              f"{hits or 'none'}", flush=True)
        if hits:
            fail(f"{tag}: {label} copies or casts an expert weight: {hits}")
    del cache, scr, calls, params
    torch.cuda.empty_cache()

    # fp32 at 2 layers with capacity_factor = n_experts, where no choice
    # drops in either program: chunked ≡ bulk on the first-token logits
    # (only the GEMMs' summation order differs), and layer 0's keep
    # decisions agree everywhere.  At the published capacity factor the
    # share of layer 0's keep decisions that differ is reported: a
    # 128-row chunk has cap 10 against a mean load of 8
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(full, n_layers=MOE_CHECK_LAYERS,
                                param_dtype="float32",
                                compute_dtype="float32",
                                capacity_factor=float(full.n_experts))
    torch.cuda.reset_peak_memory_stats()
    params32 = init_params(cfg32, seed=0, device="cuda")
    n32 = count_params(params32)
    err, differ, decisions = 0.0, 0, 0
    for prompt in prompts:
        toks = torch.as_tensor(prompt[None, :], dtype=torch.long,
                               device="cuda")
        _, b32 = prefill(cfg32, params32, toks)
        scr = init_prefill_scratch(cfg32, 1, toks.shape[1], "cuda")
        cuts = prefill_chunk_cuts(toks.shape[1], chunk_len=chunk)
        for lo, hi in cuts:
            scr, c32 = prefill_chunk(cfg32, params32, scr, toks[:, lo:hi], lo)
        err = max(err, ((c32 - b32).abs().max() / b32.abs().max()).item())
        x0 = moe_layer0_input(cfg32, params32, toks)
        moe0 = params32["layers"][0]["moe"]
        agree, _, _ = moe_chunk_agree_mask(cfg32, moe0, x0, cuts)
        if not bool(agree.all()):
            fail(f"{tag}: at capacity factor {cfg32.capacity_factor} layer "
                 f"0's chunk-local keep decisions differ from bulk's")
        _, kb, kc = moe_chunk_agree_mask(
            dataclasses.replace(cfg32, capacity_factor=full.capacity_factor),
            moe0, x0, cuts)
        differ += int((kb != kc).sum())
        decisions += kb.numel()
    del params32, scr
    peak32 = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{tag}] fp32 at {cfg32.n_layers} layers ({n32} params, "
          f"capacity factor {cfg32.capacity_factor}): first-token logits "
          f"chunked vs bulk max_err/max {err:.3g} over the {len(prompts)} "
          f"requests (tol 1e-4); layer 0's keep decisions agree "
          f"everywhere; at capacity factor {full.capacity_factor} they "
          f"differ for {differ}/{decisions} (token, choice) decisions "
          f"({differ / decisions:.2%}); fp32 check peak {peak32:.2f} GiB; "
          f"phase {time.perf_counter() - t_phase:.1f}s", flush=True)
    if not err <= 1e-4:
        fail(f"{tag}: fp32 chunked vs bulk first-token logits {err} > 1e-4")
    return launches


def widen(tree):
    """A copy of a parameter tree with its bf16 leaves in fp32."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.float() if tree.dtype == torch.bfloat16 else tree
    if isinstance(tree, dict):
        return {k: widen(v) for k, v in tree.items()}
    return [widen(v) for v in tree]


#: minicpm3's full-width head dims (q/k 64 + 32 = 96, v 64) on its
#: reduced widths: phase 5 runs MLA through flash's unequal pair
MLA_FULL_DIMS = dict(qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64,
                     head_dim=96)


def recorded_routes(fn):
    """``fn()`` with ``layers.moe_route`` recording every call: (fn's
    result, [(router probabilities, idx, keep)] on the CPU, one a MoE
    layer in order)."""
    import torch

    from repro_torch.models import layers as L

    route, calls = L.moe_route, []

    def record(cfg, router, xc):
        out = route(cfg, router, xc)
        probs = torch.softmax(xc.float() @ router.float(), dim=-1)
        calls.append((probs.cpu(), out[1].cpu(), out[2].cpu()))
        return out

    L.moe_route = record
    try:
        return fn(), calls
    finally:
        L.moe_route = route


def check_routes(name, k, cpu_calls, gpu_calls):
    """Every MoE layer's idx and keep equal on the card and the CPU; a
    flipped choice is printed with its top-k margin (the CPU's gap
    between the k-th and the next probability of that token), and one
    above 1e-5 fails, as does a keep decision that differs without a
    flip."""
    if len(cpu_calls) != len(gpu_calls):
        fail(f"reduced {name}: {len(gpu_calls)} routing calls on the card, "
             f"{len(cpu_calls)} on the CPU")
    flips = 0
    for li, ((probs, idx_c, keep_c), (_, idx_g, keep_g)) in enumerate(
            zip(cpu_calls, gpu_calls)):
        bad = (idx_c != idx_g).any(-1)
        for b, t in bad.nonzero().tolist():
            top = probs[b, t].sort(descending=True).values
            margin = (top[k - 1] - top[k]).item() if k < top.numel() \
                else float("inf")
            flips += 1
            print(f"[reduced] {name} layer {li} token ({b}, {t}): choice "
                  f"{idx_c[b, t].tolist()} on the CPU, {idx_g[b, t].tolist()}"
                  f" on the card, top-k margin {margin:.3g}", flush=True)
            if margin > 1e-5:
                fail(f"reduced {name}: a choice with top-k margin {margin} "
                     f"flipped")
        if not bad.any() and not (keep_c == keep_g).all():
            fail(f"reduced {name} layer {li}: keep decisions differ with "
                 f"no flipped choice")
    print(f"[reduced] {name} routing, card vs CPU: {len(cpu_calls)} MoE "
          f"layer calls, {flips} flipped choices; idx and keep "
          f"{'equal' if not flips else 'equal but for the flips'}",
          flush=True)


def phase_reduced_vs_cpu():
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params, params_to
    from repro_torch.models.prefill import prefill

    for name in ("smollm-360m", "h2o-danube-1.8b", "mamba2-2.7b",
                 "zamba2-7b", "minicpm3-4b", "llama4-scout-17b-a16e",
                 "grok-1-314b"):
        cfg = get_config(name).reduced()
        if cfg.attn_type == "mla":
            cfg = dataclasses.replace(cfg, **MLA_FULL_DIMS)
        params = init_params(cfg, seed=1, device="cpu")
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, size=(2, 300))).long()
        (c_cpu, l_cpu), r_cpu = recorded_routes(
            lambda: prefill(cfg, params, toks, cache_len=512))
        (c_gpu, l_gpu), r_gpu = recorded_routes(
            lambda: prefill(cfg, params_to(params, "cuda"), toks.cuda(),
                            cache_len=512))
        if cfg.family == "moe":
            check_routes(name, cfg.experts_per_token, r_cpu, r_gpu)
        err = (l_gpu.cpu() - l_cpu).abs().max().item()
        print(f"[reduced] {name} fp32 prefill logits, card vs CPU: max abs "
              f"diff {err:.3g} (tol 1e-4)", flush=True)
        if not err <= 1e-4:
            fail(f"reduced {name}: card vs CPU logits differ by {err}")
        if cfg.family in ("ssm", "hybrid"):
            want = c_cpu["ssm_state"]
            err = ((c_gpu["ssm_state"].cpu() - want).abs().max()
                   / want.abs().max()).item()
            print(f"[reduced] {name} final ssm_state, card vs CPU: "
                  f"max_err/max {err:.3g} (tol 1e-4)", flush=True)
            if not err <= 1e-4:
                fail(f"reduced {name}: card vs CPU ssm_state differ by {err}")
        if cfg.attn_type == "mla":
            err = (c_gpu["ckv"].cpu() - c_cpu["ckv"]).abs().max().item()
            print(f"[reduced] {name} (q/k 96, v 64) latent cache ckv, card "
                  f"vs CPU: max abs diff {err:.3g} (tol 1e-4)", flush=True)
            if not err <= 1e-4:
                fail(f"reduced {name}: card vs CPU ckv differ by {err}")
        if cfg.family == "moe":
            err = max((c_gpu[n].cpu() - c_cpu[n]).abs().max().item()
                      for n in ("k", "v"))
            print(f"[reduced] {name} K/V cache, card vs CPU: max abs diff "
                  f"{err:.3g} (tol 1e-4)", flush=True)
            if not err <= 1e-4:
                fail(f"reduced {name}: card vs CPU K/V differ by {err}")


HOP_TOL = {("float32", "float32"): 1e-5, ("float32", "bfloat16"): 1e-5,
           ("bfloat16", "bfloat16"): 1e-4}


def hop_bound_ms(flops, nbytes, dx, dw):
    """Least time for a product of operand types dx, dw (names): its
    operations at the bf16 tensor-core peak for bf16 x bf16, else at the
    CUDA cores' fp32 peak (the kernels run an fp32 operand in full fp32,
    no TF32), or its bytes at the memory rate, whichever is larger."""
    peak = PEAK_BF16_FLOPS if dx == dw == "bfloat16" else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def library_call(x, w, acc):
    """One cuBLAS call computing the hop's function (fp32 out), and its
    name: ``torch.mm``/``torch.addmm`` with ``out_dtype=torch.float32``
    for bf16 operands where this torch has it, else in fp32 (a bf16 weight
    widened beforehand, outside the timed call)."""
    import torch

    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    a2 = None if acc is None else acc.reshape(-1, w.shape[1]).contiguous()
    if x.dtype == w.dtype == torch.bfloat16:
        try:
            if a2 is None:
                torch.mm(x2, w, out_dtype=torch.float32)
                return (lambda: torch.mm(x2, w, out_dtype=torch.float32),
                        "torch.mm(x, w, out_dtype=torch.float32)")
            torch.addmm(a2, x2, w, out_dtype=torch.float32)
            return (lambda: torch.addmm(a2, x2, w, out_dtype=torch.float32),
                    "torch.addmm(acc, x, w, out_dtype=torch.float32)")
        except (TypeError, RuntimeError):
            pass
    xf, wf = x2.float(), w.float().contiguous()
    if a2 is None:
        return lambda: torch.mm(xf, wf), "torch.mm in fp32"
    return lambda: torch.addmm(a2, xf, wf), "torch.addmm in fp32"


def phase_cc_kernels():
    """The three hop kernels vs their plain versions at the TP-4 shapes of
    full-width h2o-danube-1.8b; returns each entry's main-path numbers."""
    import torch

    from repro_torch.kernels.cc_matmul import ops as cc_ops
    from repro_torch.kernels.cc_matmul import ref as cc_ref

    for line in cc_ops.MATMUL_TILE.ptxas_report().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[ptxas] {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    # (entry, label, B, M, N, K, path dtypes (x, w)); M rows a hop
    cases = [
        ("consume_matmul", "q edge fwd", 2, 256, 640, 2560, (bf16, bf16)),
        ("consume_matmul", "up|gate edge fwd", 2, 256, 3456, 2560,
         (bf16, bf16)),
        ("consume_matmul", "o edge bwd", 2, 256, 640, 2560, (f32, bf16)),
        ("consume_matmul", "down edge bwd", 2, 256, 1728, 2560,
         (f32, bf16)),
        ("matmul_tile", "o edge fwd", 2, 512, 1280, 640, (f32, bf16)),
        ("matmul_tile", "down edge fwd", 2, 512, 1280, 1728, (f32, bf16)),
        ("matmul_tile", "up|gate edge bwd", 2, 512, 1280, 3456,
         (f32, bf16)),
        ("consume_matmul_acc", "o edge fwd", 2, 512, 1280, 640,
         (f32, bf16)),
        ("consume_matmul_acc", "down edge fwd", 2, 512, 1280, 1728,
         (f32, bf16)),
        ("consume_matmul_acc", "up|gate edge bwd", 2, 512, 1280, 3456,
         (f32, bf16)),
    ]
    ragged = [(e, "ragged", 2, 77, 45, 130, None) for e in
              ("matmul_tile", "consume_matmul", "consume_matmul_acc")]
    main_case = {"consume_matmul": "q edge fwd", "matmul_tile": "o edge fwd",
                 "consume_matmul_acc": "o edge fwd"}
    out = {}
    for entry, label, bsz, m, n, k, path in cases + ragged:
        for dx, dw in [(bf16, bf16), (f32, f32), (f32, bf16)]:
            def randn(*shape, dtype=f32):
                return torch.randn(shape, generator=gen,
                                   device=dev).to(dtype)

            w = randn(k, n + 8, dtype=dw)[:, :n]     # a column slice
            acc = None
            if entry == "consume_matmul":
                scr = randn(2, bsz, m, k, dtype=dx)
                args, kw, x = (scr, w), {"slot": 1}, scr[1]
            else:
                x = randn(bsz, 4 * m, k, dtype=dx)[:, m:2 * m]   # row block
                args, kw = (x, w), {}
                if entry == "consume_matmul_acc":
                    scr = randn(2, bsz, m, n)
                    acc = scr[1]
                    args = (scr, x, w)
                    kw = {"slot": 1}
            wrapper = getattr(cc_ops, entry)
            plain = getattr(cc_ref, entry + "_plain")
            got = wrapper(*args, **kw)
            torch.cuda.synchronize()
            want = plain(*args, **kw)
            if not torch.isfinite(got).all():
                fail(f"{entry} {label}: non-finite output")
            err_abs = (got - want).abs().max().item()
            err = err_abs / want.abs().max().item()
            names = (str(dx)[6:], str(dw)[6:])
            tol = HOP_TOL[names]
            flops = 2.0 * bsz * m * n * k
            nbytes = (x.numel() * x.element_size()
                      + w.numel() * w.element_size() + 4 * bsz * m * n
                      + (0 if acc is None else 4 * acc.numel()))
            bound_ms, bound_by = hop_bound_ms(flops, nbytes, *names)
            ms = time_ms(lambda: wrapper(*args, **kw))
            plain_ms = time_ms(lambda: plain(*args, **kw))
            lib_fn, lib_name = library_call(x, w, acc)
            lib_ms = time_ms(lib_fn)
            timed = path == (dx, dw)
            dev_ms = device_ms(lambda: wrapper(*args, **kw)) if timed \
                else None
            lib_dev_ms = device_ms(lib_fn) if timed else None
            tag = "path" if path == (dx, dw) else "    "
            print(f"[cc_matmul] {entry} {label} B{bsz} M{m} N{n} K{k} "
                  f"{names[0]} x {names[1]} {tag}: max_err/max {err:.3g} "
                  f"(tol {tol}), kernel {ms:.4f} ms "
                  f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} "
                  f"ms, {lib_name} {lib_ms:.4f} ms, bound {bound_ms:.5f} ms "
                  f"({bound_by})" + (
                      f"; on the device (torch.profiler; queued events "
                      f"after a [profiler] line) kernel "
                      f"{fmt_ms(dev_ms)}, library {fmt_ms(lib_dev_ms)}"
                      if timed else ""), flush=True)
            if not err <= tol:
                fail(f"{entry} {label} {names}: err {err} > {tol}")
            if label == main_case[entry] and path == (dx, dw):
                out[entry] = dict(max_abs_err=err_abs, ms=ms,
                                  plain_ms=plain_ms, bound_ms=bound_ms,
                                  bound_by=bound_by, library_ms=lib_ms,
                                  library_call=lib_name, device_ms=dev_ms,
                                  library_device_ms=lib_dev_ms,
                                  shape=f"B{bsz} M{m} N{n} K{k} "
                                        f"{names[0]} x {names[1]}")
            if (entry, label) == ("consume_matmul", "o edge bwd") \
                    and path == (dx, dw):
                fp32 = dict(fp32_max_abs_err=err_abs, fp32_ms=ms,
                            fp32_plain_ms=plain_ms, fp32_bound_ms=bound_ms,
                            fp32_library_ms=lib_ms,
                            fp32_device_ms=dev_ms,
                            fp32_library_device_ms=lib_dev_ms,
                            fp32_shape=f"B{bsz} M{m} N{n} K{k} float32 x "
                                       f"bfloat16")
            if (entry, label) == ("consume_matmul", "up|gate edge fwd") \
                    and path == (dx, dw):
                upgate = dict(upgate_ms=ms, upgate_plain_ms=plain_ms,
                              upgate_bound_ms=bound_ms,
                              upgate_library_ms=lib_ms,
                              upgate_device_ms=dev_ms,
                              upgate_library_device_ms=lib_dev_ms)
            del got, want, args, x, w, acc
    out["consume_matmul"].update(upgate)
    out["consume_matmul"].update(fp32)
    return out


RING_CASES = [
    # (label, op, direction, B, b, N, K, dx, dw): b rows a rank gathers
    # (AG, a bidirectional half) or keeps (RS); N a half of the columns
    ("q edge fwd", "ag", 1, 2, 256, 640, 2560, "bfloat16", "bfloat16"),
    ("up|gate edge fwd", "ag", -1, 2, 256, 3456, 2560, "bfloat16",
     "bfloat16"),
    ("o edge bwd", "ag", 1, 2, 256, 640, 2560, "float32", "bfloat16"),
    ("down edge bwd", "ag", -1, 2, 256, 1728, 2560, "float32", "bfloat16"),
    ("o edge fwd", "rs", 1, 2, 512, 1280, 640, "float32", "bfloat16"),
    ("down edge fwd", "rs", -1, 2, 512, 1280, 1728, "float32", "bfloat16"),
    ("up|gate edge bwd", "rs", 1, 2, 512, 1280, 3456, "float32",
     "bfloat16"),
    # the vocab-parallel head at TP 4: a CE chunk's 128 local rows a rank
    # (64 a half ring) over V/4 = 8000 columns, and its dh backward
    ("head edge fwd", "ag", 1, 2, 64, 8000, 2560, "bfloat16", "bfloat16"),
    ("head edge bwd", "rs", 1, 2, 128, 1280, 8000, "float32", "bfloat16"),
    ("ragged", "ag", -1, 2, 77, 45, 130, "bfloat16", "bfloat16"),
    ("ragged", "ag", 1, 2, 77, 45, 130, "float32", "bfloat16"),
    ("ragged", "rs", -1, 2, 77, 45, 130, "bfloat16", "bfloat16"),
    ("ragged", "rs", 1, 2, 77, 45, 130, "float32", "bfloat16"),
]


#: ring calls each rank profiles a case (phase 7)
RING_PROFILE_CALLS = 5
#: calls a group time averages (phase 7): the reported time over 5 as
#: before, and the ring's over 20 beside it
RING_ITERS, RING_LONG_ITERS = 5, 20


def ring_bound_ms(op, tp, bsz, b, n, k, dx, dw):
    """Least time for one ring call of the whole group on the one card:
    every rank's product (2·n·b·K·N each) at the peak of the operand types
    (``hop_bound_ms``) against every rank's inputs read once and outputs
    written once."""
    ex = 2 if dx == "bfloat16" else 4
    ew = 2 if dw == "bfloat16" else 4
    rows_in, rows_out = (b, tp * b) if op == "ag" else (tp * b, b)
    flops = tp * 2.0 * bsz * tp * b * k * n
    nbytes = tp * (bsz * rows_in * k * ex + k * n * ew
                   + bsz * rows_out * n * 4)
    return hop_bound_ms(flops, nbytes, dx, dw)


def check_ring_case(entry, label, rows, tp, err, tol):
    """Fails unless every rank's output of a ``ring_kernels`` case is
    finite and within ``tol`` of the plain version (``err``: max error
    over max |plain|), and each rank launched the op's kernel once, no
    other cc_matmul kernel, and ``tp`` hop products."""
    if not all(r["finite"] for r in rows):
        fail(f"{entry} {label}: non-finite output")
    if not err <= tol:
        fail(f"{entry} {label}: err {err} > {tol}")
    if [r["launches"][entry] for r in rows] != [1] * tp or any(
            v for name, v in rows[0]["launches"].items() if name != entry):
        fail(f"{entry} {label}: launches {rows[0]['launches']}")
    kernels = [r["ring_kernels"] for r in rows]
    if kernels != [tp] * tp:
        fail(f"{entry} {label}: {kernels} hop products launched a call, "
             f"expected {tp} a rank")


def tp_ring_cases(cfg, tp, batch, seq, seq_chunk):
    """The ring calls of a TP step of a dense gated-MLP model at the
    shapes its edges give them (``models/artblock.py``,
    ``models/vocab_parallel.py``), as ``RING_CASES`` entries: an AG
    bidirectional half gathers half of the rank's ``seq / tp`` rows, an
    RS half keeps all of them over half of the columns; the head's edges
    take a CE chunk's ``seq_chunk / tp`` rows over the rank's V/tp ids."""
    bf, f32 = "bfloat16", "float32"
    d, local, chunk = cfg.d_model, seq // tp, seq_chunk // tp
    nq, ff = cfg.n_heads * cfg.head_dim // tp, cfg.d_ff // tp
    v = cfg.vocab_size // tp
    return [
        ("q edge fwd", "ag", 1, batch, local // 2, nq, d, bf, bf),
        ("up|gate edge fwd", "ag", -1, batch, local // 2, 2 * ff, d, bf,
         bf),
        ("o edge bwd", "ag", 1, batch, local // 2, nq, d, f32, bf),
        ("down edge bwd", "ag", -1, batch, local // 2, ff, d, f32, bf),
        ("o edge fwd", "rs", 1, batch, local, d // 2, nq, f32, bf),
        ("down edge fwd", "rs", -1, batch, local, d // 2, ff, f32, bf),
        ("up|gate edge bwd", "rs", 1, batch, local, d // 2, 2 * ff, f32,
         bf),
        ("head edge fwd", "ag", 1, batch, chunk // 2, v, d, bf, bf),
        ("head edge bwd", "rs", 1, batch, chunk, d // 2, v, f32, bf),
    ]


def phase_ring_kernels():
    """The two whole-ring ops vs their plain versions in four ranks on the
    card; returns each op's main-path numbers."""
    from repro_torch.dist import rank_tasks
    from repro_torch.dist.group import RankPool

    tp = 4
    cases = [dict(op=op, direction=d, B=bsz, b=b, N=n, K=k, dx=dx, dw=dw)
             for _, op, d, bsz, b, n, k, dx, dw in RING_CASES]
    with RankPool(tp, device="cuda") as pool:
        res = pool.run(rank_tasks.ring_kernels, cases,
                       iters=RING_ITERS, long_iters=RING_LONG_ITERS,
                       profile_calls=RING_PROFILE_CALLS)
    main_case = {"ag": "q edge fwd", "rs": "o edge fwd"}
    out = {}
    for i, (label, op, d, bsz, b, n, k, dx, dw) in enumerate(RING_CASES):
        rows = [r[i] for r in res]
        entry = f"{op}_matmul_ring"
        err_abs = max(r["max_abs_err"] for r in rows)
        err = err_abs / max(r["max_plain"] for r in rows)
        tol = HOP_TOL[(dx, dw)]
        ms, plain_ms = rows[0]["ms"], rows[0]["plain_ms"]
        ms_long = rows[0]["ms_long"]
        bound_ms, bound_by = ring_bound_ms(op, tp, bsz, b, n, k, dx, dw)
        kernels = [r["ring_kernels"] for r in rows]
        # the group's hop products of one call by torch.profiler (tp ranks
        # x tp hops): the time the card needs if it runs them one after
        # another, the serialized floor of a call
        hop_ms = sum(r["hop_ms"] for r in rows)
        events = [r["hop_events"] for r in rows]
        copy_ms = sum(r["copy_ms"] for r in rows)
        print(f"[ring] {entry} {label} dir {d:+d} B{bsz} b{b} N{n} K{k} "
              f"{dx} x {dw}, {tp} ranks: max_err/max {err:.3g} (tol {tol}),"
              f" ring {ms:.4f} ms ({ms_long:.4f} ms over "
              f"{RING_LONG_ITERS} calls), plain {plain_ms:.4f} ms (gloo), "
              f"the group's wall time a call over {RING_ITERS} calls; hop "
              f"products {kernels} a call a rank as launched (profiled "
              f"{events}), {hop_ms:.4f} ms of device time "
              f"a call over the group (the serialized floor, {tp}x{tp} x "
              f"{hop_ms / (tp * tp):.4f} ms), forwards {copy_ms:.4f} ms; "
              f"bound {bound_ms:.5f} ms ({bound_by})", flush=True)
        check_ring_case(entry, label, rows, tp, err, tol)
        if events != [float(tp)] * tp:
            fail(f"{entry} {label}: {events} hop products profiled a call, "
                 f"expected {tp} a rank")
        if label == main_case[op] and entry not in out:
            out[entry] = dict(max_abs_err=err_abs, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by,
                              library_ms=None, ms_long=ms_long,
                              long_calls=RING_LONG_ITERS,
                              hop_kernels_a_call=kernels[0],
                              profiled_hop_kernels_a_call=events[0],
                              hop_device_ms=hop_ms, copy_device_ms=copy_ms,
                              shape=f"TP{tp} B{bsz} b{b} N{n} K{k} "
                                    f"{dx} x {dw}, one direction")
    return out


def head_chunks(seq, tp, seq_chunk, microbatches=1):
    """The vocab-parallel CE's chunks a step (``dist/loss.py``): each
    microbatch's ``seq / tp`` local rows in chunks of ``seq_chunk / tp``."""
    local, k = seq // tp, max(seq_chunk // tp, 1)
    return microbatches * -(-local // k)


def tp_launches(n_layers, tp, remat, peer, chunks=0):
    """cc_matmul launches of one TP step from the schedule: per layer two
    AG edges (q, up‖gate) and two RS edges (o, down) forward, the other op
    at each edge in backward, the forward again under remat full; the
    vocab-parallel head's AG edge forward and its RS edge backward a CE
    chunk (``chunks``, never recomputed); batch folded into each launch.
    In-kernel ring (``peer``): one ring launch a direction, two
    counter-rotating half rings at tp > 2.  Emulated: an AG at tp > 2
    consumes 2 + 2(tp−1) times, an RS launches 2 tiles and 2(tp−1)
    accumulating consumes; at tp 2 one ring: tp, 1 and tp−1."""
    bidir = tp > 2
    calls = n_layers * (6 if remat == "full" else 4) + chunks  # per op kind
    zero = dict.fromkeys(("matmul_tile", "consume_matmul",
                          "consume_matmul_acc", "ag_matmul_ring",
                          "rs_matmul_ring"), 0)
    if peer:
        rings = calls * (2 if bidir else 1)
        return dict(zero, ag_matmul_ring=rings, rs_matmul_ring=rings)
    return dict(zero,
                consume_matmul=calls * (2 * tp if bidir else tp),
                matmul_tile=calls * (2 if bidir else 1),
                consume_matmul_acc=calls * (2 * (tp - 1) if bidir
                                            else tp - 1))


#: phase 8's runs: (tag, model axis, steps, in-kernel ring, layers):
#: TP 4 and TP 8 at all of h2o-danube-1.8b's 24 layers (the reckoning of
#: the eight ranks' bytes against the card is in PERF.md §6), the emulated
#: schedule at the families' cut depth (its check is against the fused
#: family's step there)
TP_FAMILY_LAYERS = 4
#: the TP-4 and TP-8 runs at 8 of h2o's 24 layers (all 24 took ~40 s more
#: of the time limit)
TP_RUNS = (("tp4", 4, 2, True, 8), ("tp8", 8, 1, True, 8),
           ("tp4-emulated", 4, 1, False, TP_FAMILY_LAYERS))
#: the TP families each run at full width, depth cut to 4 of 24 layers,
#: step 0, on the TP-4 peer pool: the ART edge families, and ``xla`` (the
#: reference's GSPMD layout, ``models/tp_block.py``); each held to the
#: fused step relative, at the TP-8 check's limits (the products round
#: differently: cuBLAS on the overlap and xla paths, the hop kernel on
#: the fused)
TP_FAMILIES = ("fused", "ring", "bidir", "auto", "xla")
FAMILY_LOSS_TOL, FAMILY_NORM_TOL = 1e-3, 1e-2


def bare_hops(conduit, op, shape, item, dim):
    """The ring permutes (a tensor a hop) one bare all_gather or
    reduce_scatter along ``dim`` of a (B, rows, cols) tensor sends a rank
    on ``conduit``, as ``core/conduit.py`` schedules it: none on ``xla``,
    n − 1 a piece on the ring (``fused`` rides it), 2(n − 1) on bidir
    unless it falls back to the ring; its backward sends as many."""
    from repro_torch.core import pipeline as pl

    n = conduit.axis.size
    numel = math.prod(shape)
    rows = shape[dim]
    size = numel * item * (n if op == "all_gather" else 1)
    name, chunk = conduit._resolve(op, size)
    if name == "xla" or n == 1:
        return 0
    b = rows if op == "all_gather" else rows // n
    cols = numel // rows
    if name == "bidir" and n > 2 and b >= 2:
        hop = (numel // 2 if op == "all_gather" else numel // n // 2) * item
        return 2 * (n - 1) * pl.n_chunks(hop, chunk, cols)
    hop = (numel if op == "all_gather" else numel // n) * item
    return (n - 1) * pl.n_chunks(hop, chunk, cols)


def family_plan(cfg, tp, transport, batch, seq, seq_chunk):
    """What one TP step of the policy ``transport`` runs, from the
    schedule: every edge shape with the family and direction the port's
    conduit picks for it on the CPU (``artblock._edge_cost``,
    ``matmul_schedule``), as ``artblock.EDGE_CALLS`` records a step
    (forward calls, the remat recompute among them), the cc_matmul ring
    launches of its fused edges, and the ring permutes a rank sends
    (n − 1 an edge call and direction, forward and backward, on the peer
    ring or the gloo wire alike, and the bare K/V and embedding
    collectives')."""
    import torch

    from repro_torch.core import overlap
    from repro_torch.core.conduit import Conduit
    from repro_torch.dist.group import Group
    from repro_torch.models import artblock
    from repro_torch.models import layers as L

    c = Conduit(axis=Group(rank=0, size=tp, device=torch.device("cpu")),
                transport=transport)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, f = cfg.n_heads // tp * hd, cfg.d_ff // tp
    s_loc, rows = seq // tp, max(seq_chunk // tp, 1)
    again = 2 if cfg.remat == "full" else 1
    cd = L.cdtype(cfg)
    meta = dict(device="meta", dtype=cd)
    # an RS edge's input is the fp32 product of an AG edge (attention's
    # output, the MLP's activation)
    fp32 = dict(device="meta", dtype=torch.float32)
    up = 2 * f if cfg.gated_mlp else f
    edges = [("all_gather", (batch, s_loc, d), (d, nq), cfg.n_layers),
             ("all_gather", (batch, s_loc, d), (d, up), cfg.n_layers),
             ("reduce_scatter", (batch, seq, nq), (nq, d), cfg.n_layers),
             ("reduce_scatter", (batch, seq, f), (f, d), cfg.n_layers)]
    record, launches, hops = {}, {"ag_matmul_ring": 0, "rs_matmul_ring": 0}, 0
    heads = [min(rows, s_loc - c0) for c0 in range(0, s_loc, rows)]
    for op, xs, ws, layers in edges + [("all_gather", (batch, r, d),
                                        (d, cfg.vocab_size // tp), 0)
                                       for r in heads]:
        x = torch.empty(xs, **(meta if op == "all_gather" else fp32))
        w = torch.empty(ws, **meta)
        size, tc = artblock._edge_cost(op, x, w, c)
        family = c.matmul_schedule(op, size, tc)
        bidir = c.matmul_bidirectional(
            size if family == "fused" else overlap.payload_bytes(op, x, w,
                                                                 tp))
        fwd, bwd = (layers * again, layers) if layers else (1, 1)
        key = (op, size, tc, family, bidir)
        record[key] = record.get(key, 0) + fwd
        dirs = 2 if bidir and tp > 2 else 1
        hops += (fwd + bwd) * dirs * (tp - 1)
        if family == "fused":
            mine, other = (("ag_matmul_ring", "rs_matmul_ring")
                           if op == "all_gather"
                           else ("rs_matmul_ring", "ag_matmul_ring"))
            launches[mine] += fwd * dirs
            launches[other] += bwd * dirs
    kv = cfg.n_kv_heads * hd
    item = torch.empty((), dtype=cd).element_size()
    hops += (2 * cfg.n_layers * (again + 1)
             * bare_hops(c, "all_gather", (batch, s_loc, kv), item, 1))
    embed_item = torch.empty((), dtype=getattr(
        torch, cfg.param_dtype)).element_size()
    hops += 2 * bare_hops(c, "reduce_scatter", (batch, seq, d), embed_item,
                          1)
    return record, launches, hops
TP_SEQ, TP_SEQ_CHUNK, TP_BATCH = 2049, 512, 2
#: step 0 at TP 8 against TP 4, relative: besides the tolerances of the
#: TP-2 check this run replaced (2e-2, 5e-2), limits set from the
#: readings (loss 1.95e-6, grad norm 1.77e-4 on an H100, PERF.md §6)
TP8_LOSS_TOL, TP8_NORM_TOL = 1e-3, 1e-2


def tp8_ring_cases(pool, cfg, smi):
    """The TP-8 step's ring calls at its shapes (the blocks' and the
    head's edges), each against its plain version on the eight-rank pool
    of phase 8 before it trains: phase 7 holds the rings at four ranks
    only."""
    from repro_torch.dist import rank_tasks

    tp = pool.size
    cases = tp_ring_cases(cfg, tp, TP_BATCH, TP_SEQ - 1, TP_SEQ_CHUNK)
    res = pool.run(rank_tasks.ring_kernels,
                   [dict(op=op, direction=d, B=bsz, b=b, N=n, K=k, dx=dx,
                         dw=dw) for _, op, d, bsz, b, n, k, dx, dw in cases],
                   iters=1)
    for i, (label, op, d, bsz, b, n, k, dx, dw) in enumerate(cases):
        rows = [r[i] for r in res]
        entry = f"{op}_matmul_ring"
        err = (max(r["max_abs_err"] for r in rows)
               / max(r["max_plain"] for r in rows))
        tol = HOP_TOL[(dx, dw)]
        print(f"[tp8] {entry} {label} dir {d:+d} B{bsz} b{b} N{n} K{k} "
              f"{dx} x {dw}, {tp} ranks: max_err/max {err:.3g} (tol {tol}),"
              f" ring {rows[0]['ms']:.4f} ms, plain "
              f"{rows[0]['plain_ms']:.4f} ms (gloo), one call ({smi})",
              flush=True)
        check_ring_case(entry, f"{label} at tp {tp}", rows, tp, err, tol)


def tp_family_runs(pool, cfg, kw, smi):
    """On the TP-4 peer pool: step 0 of full-width h2o cut to
    ``TP_FAMILY_LAYERS`` layers under each of ``TP_FAMILIES``; each run's
    edges, ring launches and ring permutes held to ``family_plan`` (so
    ``auto``'s decision at each edge shape is the CPU's; ``xla`` runs no
    edge and no ring), and each other family's loss and grad norm to the
    fused step's.  Returns the runs by family."""
    from repro_torch.dist import rank_tasks

    tp = pool.size
    runs = {}
    for fam in TP_FAMILIES:
        t0 = time.perf_counter()
        res = pool.run(rank_tasks.train, cfg.name, **dict(
            kw, steps=1, tp_transport=fam,
            cfg_overrides=dict(n_layers=TP_FAMILY_LAYERS)))
        runs[fam] = res
        lcfg = dataclasses.replace(cfg, n_layers=TP_FAMILY_LAYERS)
        if fam == "xla":
            # no TP edge and no ring: gloo's gathers and scatters and
            # cuBLAS products (its permutes are not a ring schedule's)
            record, want, hops = {}, {"ag_matmul_ring": 0,
                                      "rs_matmul_ring": 0}, None
        else:
            record, want, hops = family_plan(lcfg, tp, fam, TP_BATCH,
                                             TP_SEQ - 1, TP_SEQ_CHUNK)
        chosen = sorted({(op, family, bidir)
                         for op, _, _, family, bidir in record})
        r0 = res[0]
        m = r0["metrics"][0]
        print(f"[tp4 {fam}] {cfg.name} full width at {TP_FAMILY_LAYERS} of "
              f"{cfg.n_layers} layers, {tp} ranks, step 0: "
              f"{max(r['seconds'][0] for r in res):.2f}s, loss "
              f"{m['loss']:.6f}, grad_norm {m['grad_norm']:.6f}; edges "
              f"(op, family, bidirectional) {chosen}; ring launches a rank "
              f"{ {k: v for k, v in r0['launches'][0].items() if v} }; "
              f"{r0['stats'][0]['hops']} permutes a rank (the ring "
              f"schedule's {'-' if hops is None else hops}); staged "
              f"{sum(r['stats'][0]['staged_bytes'] for r in res) / 2**30:.3f}"
              f" GiB through the host (all ranks), wire "
              f"{max(r['stats'][0]['wire_s'] for r in res):.2f}s; peak "
              f"{', '.join('%.2f' % (r['peak_bytes'] / 2**30) for r in res)}"
              f" GiB a rank; pool "
              f"{time.perf_counter() - t0:.1f}s ({smi})", flush=True)
        if fam == "auto":
            for (op, size, tc, family, bidir), calls in sorted(record.items()):
                print(f"[tp4 auto] {op} edge of {size} bytes, modeled "
                      f"matmul {tc:.4g}s: {family}"
                      f"{' bidirectional' if bidir else ''} x{calls} a step "
                      f"(the CPU's matmul_schedule: the same)", flush=True)
        for rank, r in enumerate(res):
            if r["scheme"] != ("xla" if fam == "xla" else "art"):
                fail(f"tp4 {fam} rank {rank}: the {r['scheme']} TP path")
            got = dict(r["edges"][0])
            if got != record:
                fail(f"tp4 {fam} rank {rank}: edges {sorted(got.items())}, "
                     f"the schedule's (the CPU's decisions) "
                     f"{sorted(record.items())}")
            launched = {k: r["launches"][0][k] for k in want}
            if launched != want or any(
                    v for k, v in r["launches"][0].items() if k not in want):
                fail(f"tp4 {fam} rank {rank}: cc_matmul launches "
                     f"{r['launches'][0]}, expected {want}")
            rings = sum(want.values())
            if r["stats"][0]["ring_kernels"] != tp * rings:
                fail(f"tp4 {fam} rank {rank}: "
                     f"{r['stats'][0]['ring_kernels']} hop products in "
                     f"{rings} ring calls")
            if hops is not None and r["stats"][0]["hops"] != hops:
                fail(f"tp4 {fam} rank {rank}: {r['stats'][0]['hops']} ring "
                     f"permutes, the schedule's {hops}")
            if any(r["plain"][0].values()):
                fail(f"tp4 {fam} rank {rank}: plain versions ran "
                     f"{r['plain'][0]}")
            if r["metrics"][0]["loss"] != m["loss"]:
                fail(f"tp4 {fam}: ranks report different losses")
        if any(r["replicated"] != r0["replicated"] for r in res):
            fail(f"tp4 {fam}: replicated leaves differ across ranks")
    mf = runs["fused"][0]["metrics"][0]
    for fam in TP_FAMILIES[1:]:
        mo = runs[fam][0]["metrics"][0]
        d_loss = abs(mo["loss"] - mf["loss"]) / abs(mf["loss"])
        d_norm = abs(mo["grad_norm"] - mf["grad_norm"]) / abs(mf["grad_norm"])
        print(f"[tp4 {fam}] step 0 vs the fused step: loss rel {d_loss:.3g} "
              f"(tol {FAMILY_LOSS_TOL}), grad_norm rel {d_norm:.3g} (tol "
              f"{FAMILY_NORM_TOL})", flush=True)
        if not (d_loss <= FAMILY_LOSS_TOL and d_norm <= FAMILY_NORM_TOL):
            fail(f"tp4 {fam} and the fused family disagree at step 0")
    return runs


def phase_tp_train():
    """Full-width h2o-danube-1.8b TP training with the vocab-parallel
    embedding and head: 2 steps at a model axis of 4 on the in-kernel
    ring, then on the same pool step 0 of every TP family at 4 layers
    (:func:`tp_family_runs`), step 0 at 8 (the preset's extent), and step
    0 at 4 on the emulated schedule at 4 layers; each TP-4 pool first
    runs phase 12's quickstart (peer-mapped, then over the wire).
    Returns (the cc_matmul launches, all ranks, all steps: the rings' of
    the TP-4 and TP-8 runs, the hop kernels' of the emulated run, and the
    TP-8 run's rings apart; the quickstarts)."""
    import math

    import numpy as np

    from repro_torch.configs.presets import get_tp_preset
    from repro_torch.dist import rank_tasks
    from repro_torch.dist.group import RankPool

    preset = get_tp_preset("h2o-danube-1.8b-tp")
    cfg = preset.config
    smi = card_name_and_limit()
    if preset.tp_axis != 8:
        fail(f"the h2o TP preset's extent is {preset.tp_axis}, not 8")
    kw = dict(tp_transport=preset.tp_transport, seed=0, vocab_rows=True,
              step_overrides=dict(seq_chunk=TP_SEQ_CHUNK, warmup_steps=1),
              data=dict(seq_len=TP_SEQ, global_batch=TP_BATCH))
    profile_step = 1          # the TP-4 run's last step, under the profiler
    runs, quick = {}, {}
    for tag, tp, steps, peer, layers in TP_RUNS:
        t0 = time.perf_counter()
        with RankPool(tp, device="cuda", peer_memory=peer) as pool:
            if tp == 4:
                quick["peer" if peer else "wire"] = (
                    pool.run(rank_tasks.quickstart),
                    pool.run(rank_tasks.heap_churn, 4, 1 << 20)
                    if peer else None)
            if tag == "tp8":
                tp8_ring_cases(pool, cfg, smi)
            over = ({} if layers == cfg.n_layers
                    else dict(cfg_overrides=dict(n_layers=layers)))
            res = pool.run(rank_tasks.train, cfg.name,
                           **dict(kw, steps=steps, profile_step=(
                               profile_step if tag == "tp4" else None),
                               **over))
            if tag == "tp4":
                families = tp_family_runs(pool, cfg, kw, smi)
        runs[tag] = res
        print(f"[{tag}] {cfg.name} full width at {layers} of {cfg.n_layers} "
              f"layers, {tp} ranks on one card "
              f"({preset.tp_transport} edges, "
              f"{'in-kernel ring' if peer else 'emulated schedule'}; embed "
              f"and lm_head split over the vocab, {cfg.vocab_size // tp} ids "
              f"a rank), {res[0]['n_params']/1e6:.1f}M params a rank in "
              f"{cfg.param_dtype}, init "
              f"{max(r['init_seconds'] for r in res):.1f}s, pool "
              f"{time.perf_counter() - t0:.1f}s ({smi})", flush=True)
        chunks = head_chunks(TP_SEQ - 1, tp, TP_SEQ_CHUNK)
        want = tp_launches(layers, tp, cfg.remat, peer, chunks)
        for k in range(steps):
            m = res[0]["metrics"][k]
            wall = max(r["seconds"][k] for r in res)
            staged = sum(r["stats"][k]["staged_bytes"] for r in res)
            rep = sum(r["rep_wire"][k]["staged_bytes"] for r in res)
            rep_payload = res[0]["rep_wire"][k]["bytes"]
            forwarded = sum(r["stats"][k]["peer_bytes"] for r in res)
            wire = max(r["stats"][k]["wire_s"] for r in res)
            hops = res[0]["stats"][k]["hops"]
            peak = [r["peak_bytes"] / 2**30 for r in res]
            launched = {n: v for n, v in res[0]["launches"][k].items() if v}
            print(f"[{tag}] step {k}{' (profiled)' if tag == 'tp4' and k == profile_step else ''}: "
                  f"{wall:.2f}s, loss {m['loss']:.6f}, "
                  f"grad_norm {m['grad_norm']:.6f}, lr {m['lr']:.3g}; "
                  f"cc_matmul launches a rank {launched} ({chunks} head "
                  f"chunks); {hops} ring hops "
                  f"and {res[0]['stats'][k]['ring_kernels']} ring hop "
                  f"products a rank, {forwarded / 2**30:.2f} GiB forwarded "
                  f"through peer memory; the model line staged "
                  f"{staged / 2**30:.3f} GiB through the host (all ranks): "
                  f"the replicated leaves' gradient all-reduce "
                  f"{rep / 2**30:.3f} GiB ({rep_payload / 1e6:.1f} MB of "
                  f"fp32 gradients a rank), everything else "
                  f"{(staged - rep) / 2**30:.3f} GiB; {wire:.2f}s in the "
                  f"wire (host clock, the slowest rank); peak memory a rank "
                  f"{', '.join(f'{p:.2f}' for p in peak)} GiB ({smi})",
                  flush=True)
            rings = want["ag_matmul_ring"] + want["rs_matmul_ring"]
            for rank, r in enumerate(res):
                if r["launches"][k] != want:
                    fail(f"{tag} step {k} rank {rank}: cc_matmul launches "
                         f"{r['launches'][k]}, expected {want}")
                if r["stats"][k]["ring_kernels"] != tp * rings:
                    fail(f"{tag} step {k} rank {rank}: "
                         f"{r['stats'][k]['ring_kernels']} hop products in "
                         f"{rings} ring calls, expected {tp} a call")
                if any(r["plain"][k].values()):
                    fail(f"{tag} step {k} rank {rank}: plain versions ran "
                         f"{r['plain'][k]}")
                if r["metrics"][k]["loss"] != m["loss"]:
                    fail(f"{tag} step {k}: ranks report different losses")
        if tag == "tp4":
            prof = [r.get("profile") for r in res]
            wall = max(r["seconds"][profile_step] for r in res)
            if all(p and p["kernel_ms"] > 0 for p in prof):
                spans = sum(p["kernel_ms"] for p in prof) / 1e3
                cc = sum(p["cc_ms"] for p in prof) / 1e3
                # a kernel that the card preempts for another rank's
                # context keeps its span open, so spans of different
                # ranks may overlap: their sum bounds the card's busy time
                # from above (1 - sum/wall bounds the time with no kernel
                # running from below), and the union of the spans on the
                # profiler's host clock is the time with some kernel of
                # some rank in flight
                print(f"[tp4] step {profile_step} on the card (torch.profiler,"
                      f" summed over the ranks): kernel spans {spans:.2f}s "
                      f"against {wall:.2f}s wall (at least "
                      f"{100 * (1 - spans / wall):.2f}% of the wall with "
                      f"no kernel of any rank running), of which "
                      f"cc_matmul hop products {cc:.2f}s and the other "
                      f"kernels {spans - cc:.2f}s; copies (host<->device and "
                      f"the ring's forwards) "
                      f"{sum(p['copy_ms'] for p in prof) / 1e3:.2f}s",
                      flush=True)
                union = rank_tasks.union_spans(
                    [sp for p in prof for sp in p["kernel_spans"]])
                extent = ((union[-1][1] - union[0][0]) / 1e9 if union
                          else float("inf"))
                if extent <= 1.05 * wall:
                    busy = sum(e - s for s, e in union) / 1e9
                    print(f"[tp4] step {profile_step}: the union of the "
                          f"ranks' kernel spans is {busy:.4f}s of the "
                          f"{wall:.2f}s wall ({100 * (1 - busy / wall):.2f}%"
                          f" of the wall with no kernel of any rank in "
                          f"flight; the spans lie within {extent:.2f}s)",
                          flush=True)
                else:
                    print(f"[tp4] step {profile_step}: the ranks' kernel "
                          f"spans lie {extent:.2f}s apart against "
                          f"{wall:.2f}s wall, so their clocks do not agree: "
                          f"the union not measured", flush=True)
                for name, ms, count in prof[0]["top"]:
                    print(f"[tp4]   rank 0: {ms:9.1f} ms  x{count:<6} "
                          f"{name[:90]}", flush=True)
            else:
                print("[tp4] torch.profiler saw no device time: device "
                      "busy share not measured", flush=True)
        if any(r["replicated"] != res[0]["replicated"] for r in res):
            fail(f"{tag}: replicated leaves differ across ranks")
        if any(name in res[0]["replicated"] for name in ("embed", "lm_head")):
            fail(f"{tag}: embed or lm_head replicated at tp {tp}")
        print(f"[{tag}] {len(res[0]['replicated'])} replicated leaves "
              f"bitwise equal on all {tp} ranks", flush=True)
    # the vocab shards after step 0 (learning rate 0: the draw itself),
    # gathered: V rows (columns) each, every rank's part once, the same
    # in every run whatever its extent
    gathered = {tag: {name: np.concatenate([r["vocab_rows"][0][name]
                                            for r in res])
                      for name in ("embed", "lm_head")}
                for tag, res in runs.items()}
    for tag, g in gathered.items():
        for name, rows in g.items():
            if len(rows) != cfg.vocab_size or not np.array_equal(
                    rows, gathered["tp4"][name]):
                fail(f"{tag}: the gathered {name} shards hold "
                     f"{len(rows)} rows, not tp4's {cfg.vocab_size}")
    print(f"[tp] embed and lm_head shards gathered after step 0: "
          f"{cfg.vocab_size} vocab rows and columns each, every rank's "
          f"part once, equal across the TP-4, TP-8 and emulated runs "
          f"(exact checksums)", flush=True)
    loss0 = runs["tp4"][0]["metrics"][0]["loss"]
    if not (math.isfinite(loss0) and abs(loss0 - math.log(cfg.vocab_size))
            <= 0.5):
        fail(f"tp4 step-0 loss {loss0} not within 0.5 of "
             f"ln {cfg.vocab_size}")

    def rel(a, b, key):
        return abs(a[key] - b[key]) / abs(b[key])

    m4, m8 = runs["tp4"][0]["metrics"][0], runs["tp8"][0]["metrics"][0]
    d_loss, d_norm = rel(m8, m4, "loss"), rel(m8, m4, "grad_norm")
    print(f"[tp] step 0, TP 8 vs TP 4 (bf16): loss {m8['loss']:.6f} vs "
          f"{m4['loss']:.6f} (rel {d_loss:.3g}, tol 2e-2 and "
          f"{TP8_LOSS_TOL}), grad_norm {m8['grad_norm']:.6f} vs "
          f"{m4['grad_norm']:.6f} (rel {d_norm:.3g}, tol 5e-2 and "
          f"{TP8_NORM_TOL})", flush=True)
    if not (d_loss <= 2e-2 and d_norm <= 5e-2):
        fail("tp8 and tp4 disagree at step 0")
    # the limits set from the readings (PERF.md §6): a vocab shard lost or
    # misplaced at TP 8 moves the step-0 loss by ~1.2%, inside 2e-2
    if not (d_loss <= TP8_LOSS_TOL and d_norm <= TP8_NORM_TOL):
        fail(f"tp8 and tp4 differ at step 0 beyond the readings' limits "
             f"(loss {TP8_LOSS_TOL}, grad_norm {TP8_NORM_TOL})")
    me = runs["tp4-emulated"][0]["metrics"][0]
    mf = families["fused"][0]["metrics"][0]
    d_loss, d_norm = rel(me, mf, "loss"), rel(me, mf, "grad_norm")
    print(f"[tp] step 0 at TP 4 and {TP_FAMILY_LAYERS} layers, emulated "
          f"schedule vs in-kernel ring: loss "
          f"{me['loss']:.6f} vs {mf['loss']:.6f} (rel {d_loss:.3g}), "
          f"grad_norm {me['grad_norm']:.6f} vs {mf['grad_norm']:.6f} (rel "
          f"{d_norm:.3g}); tol 1e-6", flush=True)
    if not (d_loss <= 1e-6 and d_norm <= 1e-6):
        fail("the emulated schedule and the in-kernel ring disagree")

    def total(tag):
        return {name: sum(sum(step[name] for step in r["launches"])
                          for r in runs[tag])
                for name in runs[tag][0]["launches"][0]}

    ring, ring8, emulated = total("tp4"), total("tp8"), total("tp4-emulated")
    out = {name: ring[name] + ring8[name] if name.endswith("_ring")
           else emulated[name] for name in ring}
    out.update({f"tp8_{name}": ring8[name] for name in ring
                if name.endswith("_ring")})
    return out, quick


def params_rule(tag, rank, card_params, cpu_params, worst, t=1e-4):
    """Phase 9's parameter rule on one rank's leaves, card against CPU:
    mean |Δ| ≤ t × the leaf's mean magnitude, max |Δ| ≤ 2·peak_lr + t ×
    its max; ``worst`` gathers the largest mean ratio and the elements
    beyond t × max."""
    import numpy as np

    from repro_torch.dist.steps import StepConfig

    peak_lr = StepConfig().peak_lr
    for name, want in cpu_params.items():
        d = np.abs(card_params[name] - want)
        scale = np.abs(want).max()
        worst["mean"] = max(worst["mean"], float(
            d.mean() / max(np.abs(want).mean(), 1e-30)))
        worst["beyond"] += int((d > t * scale).sum())
        if not (d.mean() <= t * np.abs(want).mean()
                and d.max() <= 2 * peak_lr + t * scale):
            fail(f"{tag} rank {rank} {name}: card vs CPU mean |d| "
                 f"{d.mean()}, max |d| {d.max()}")


def reduced_tp_runs(tp):
    """Phase 9's card-against-CPU runs on a pool of ``tp``: (tag, arch,
    the run's overrides, whether ``embed`` and ``lm_head`` stay
    replicated), reduced h2o-danube-1.8b on the fused rings; at TP 2 also
    reduced minicpm3-4b (MLA) and internvl2-2b (its patch rows, seeded,
    first in the split sequence) under ``xla``, the reference's GSPMD
    layout; at TP 4 also a vocab of 250, which the line does not divide
    (the placement rule's fallback), the ``bidir`` overlap schedules in
    place of the fused rings, and ``xla`` with 6 query heads and 3 KV
    heads of 16, which 4 divides in neither (each rank attends the whole
    heads its rows of ``wo`` cut, ``wq``/``wk``/``wv`` gathered)."""
    import numpy as np

    from repro_torch.configs import get_config

    h2o = "h2o-danube-1.8b"
    runs = [(f"tp{tp}", h2o, {}, False)]
    if tp == 2:
        for arch in ("minicpm3-4b", "internvl2-2b"):
            over = dict(tp_transport="xla")
            cfg = get_config(arch).reduced()
            if cfg.frontend:
                rng = np.random.default_rng(tp)
                toks = rng.integers(0, cfg.vocab_size, size=(2, 2, 17))
                over["batches"] = [dict(
                    tokens=t[:, :-1], labels=t[:, 1:],
                    frontend_embeds=rng.standard_normal(
                        (2, cfg.frontend_tokens, cfg.frontend_dim)
                    ).astype(np.float32)) for t in toks]
            runs.append((f"tp{tp} xla", arch, over, False))
    if tp == 4:
        runs.append((f"tp{tp} vocab 250", h2o,
                     dict(cfg_overrides=dict(vocab_size=250)), True))
        runs.append((f"tp{tp} bidir", h2o, dict(tp_transport="bidir"),
                     False))
        runs.append((f"tp{tp} 6 heads xla", h2o, dict(
            tp_transport="xla",
            cfg_overrides=dict(n_heads=6, n_kv_heads=3)), False))
    return runs


def reduced_tp_check(tag, arch, card, cpu, vocab_rep, t):
    """Phase 9's checks of one reduced run, card against CPU: ring kernels
    launched (none, and every edge on the overlap schedules, for a
    ``bidir`` run), (loss, grad_norm) within ``t`` relative each step,
    every leaf by the parameter rule, and ``embed`` and ``lm_head`` among
    the replicated leaves on every rank if ``vocab_rep``, else among the
    sharded."""
    worst = {"metric": 0.0, "mean": 0.0, "beyond": 0}
    vocab = {"embed", "lm_head"}
    for rank, (a, b) in enumerate(zip(card, cpu)):
        rings = sum(s["ag_matmul_ring"] + s["rs_matmul_ring"]
                    for s in a["launches"])
        families = {key[3] for step in a["edges"] for key, _ in step}
        if tag.endswith("bidir"):
            if rings or families != {"bidir"}:
                fail(f"reduced {tag}: {rings} ring kernels, edge families "
                     f"{families}: expected none and {{'bidir'}}")
        elif tag.endswith("xla"):
            if rings or families or a["scheme"] != "xla":
                fail(f"reduced {tag}: {rings} ring kernels, edge families "
                     f"{families}, the {a['scheme']} path: expected none, "
                     f"none and xla")
        elif not rings:
            fail(f"reduced {tag}: the card run launched no ring kernel")
        for ma, mb in zip(a["metrics"], b["metrics"]):
            for key in ("loss", "grad_norm"):
                rel = abs(ma[key] - mb[key]) / abs(mb[key])
                worst["metric"] = max(worst["metric"], rel)
        params_rule(f"reduced {tag}", rank, a["params"], b["params"],
                    worst, t)
        placed = (vocab <= set(a["replicated"]), vocab <= set(a["sharded"]))
        if placed != (vocab_rep, not vocab_rep):
            fail(f"reduced {tag} rank {rank}: embed and lm_head replicated, "
                 f"sharded: {placed}, expected {vocab_rep}, {not vocab_rep}")
    print(f"[tp-reduced] {arch} fp32 {tag}, 2 steps, card vs "
          f"CPU: loss/grad_norm max rel {worst['metric']:.3g} (tol "
          f"{t}); params mean |d|/mean |p| max {worst['mean']:.3g} "
          f"(tol {t}), {worst['beyond']} elements beyond {t} x max|p|; "
          f"embed and lm_head "
          f"{'replicated' if vocab_rep else 'split over the vocab'}; "
          f"losses {[round(m['loss'], 6) for m in card[0]['metrics']]}",
          flush=True)
    if worst["metric"] > t:
        fail(f"reduced {tag}: card vs CPU metrics differ by "
             f"{worst['metric']}")


def phase_tp_reduced():
    """Phase 9, reduced configs in fp32 at TP 2 and 4
    (``reduced_tp_runs``): the card against the
    CPU, same parameters (drawn on the CPU) and batches; and
    on the same two pools phase 9b, expert parallelism (``phase_ep_*``),
    each dense reference computed in this process while the ranks hold
    nothing large (the served model's before the pools start); then, on
    the four-rank pool, phase 9c, the data axis (:func:`phase_grid`).
    Returns 9c's ring launches, all ranks and steps."""
    from repro_torch.dist import rank_tasks
    from repro_torch.dist.group import RankPool

    t = 1e-4
    kw = dict(steps=2, reduced=True, seed=0, init_device="cpu",
              step_overrides=dict(seq_chunk=8, warmup_steps=1),
              data=dict(seq_len=17, global_batch=2), return_params=True)
    smi = card_name_and_limit()
    t0 = time.perf_counter()
    serve_ref = ep_serve_dense(smi)
    ep_s = time.perf_counter() - t0
    for tp in (2, 4):
        with RankPool(tp, device="cuda") as pool:
            runs = [(tag, arch, *(pool.run(rank_tasks.train, arch,
                                           device=dev, **over, **kw)
                                  for dev in ("cuda", "cpu")), vocab_rep)
                    for tag, arch, over, vocab_rep in reduced_tp_runs(tp)]
            t0 = time.perf_counter()
            if tp == 4:
                # first: a profile taken in these ranks after the EP
                # training runs recorded no device event in two runs
                # (CUPTI did not initialize; cause not found)
                phase_ep_serve(pool, serve_ref, smi)
            phase_ep_train(pool, smi)
            if tp == 4:
                phase_ep_layer(pool, ep_layer_dense(smi), smi)
                release_shared(pool)
            ep_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            if tp == 2:
                phase_xla_families(pool, smi)
                xla_s = time.perf_counter() - t0
            else:
                grid_launches = phase_grid(pool, smi)
                grid_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                phase_launch_job(pool, smi)
                job_s = time.perf_counter() - t0
        for tag, arch, card, cpu, vocab_rep in runs:
            reduced_tp_check(tag, arch, card, cpu, vocab_rep, t)
    print(f"[smoke] phase 9b expert parallelism: {ep_s:.1f}s (the dense "
          f"references in this process and the EP runs on phase 9's "
          f"pools; {smi})", flush=True)
    print(f"[smoke] phase 9c the data axis: {grid_s:.1f}s on phase 9's "
          f"four-rank pool ({smi})", flush=True)
    print(f"[smoke] phase 9d the reference launcher's default job: "
          f"{job_s:.1f}s on phase 9's four-rank pool ({smi})", flush=True)
    print(f"[smoke] phase 9e xla TP on the MLA and VLM blocks: {xla_s:.1f}s "
          f"on phase 9's two-rank pool ({smi})", flush=True)
    return grid_launches


#: phase 9c: the data axis.  h2o-danube-1.8b at full width, its depth cut
#: to 2 of 24 layers (~158 M parameters a rank at model 2 with the vocab
#: split; the full depth, ~19 GB of training state a rank, does not fit
#: four ranks on one card; 8 layers, ~373 M a rank, spent 58.5 s of the
#: smoke's time limit writing its two checkpoints on an H100, 4 layers,
#: ~227 M, 34.1 s), on a data 2 × model 2 grid, one 2049-token sequence a
#: data rank
GRID_ARCH, GRID_LAYERS, GRID_SEQ = "h2o-danube-1.8b", 2, 2049
GRID_SHAPE = dict(data=2, model=2)
GRID_BUCKET_KB = 64 << 10           # the data sync's buckets: 64 MiB
GRID_REDUCED = (("h2o-danube-1.8b", dict(data=2, model=2), {}),
                ("h2o-danube-1.8b", dict(data=4, model=1), {}),
                ("llama4-scout-17b-a16e", dict(data=2, expert=2),
                 dict(moe_transport="ring", global_batch=8,
                      microbatches=2)))


def phase_grid(pool, smi):
    """9c: the data axis on the four-rank pool.  (a) full-width
    h2o-danube-1.8b (4 layers, bf16, the fused ring in each model line)
    at data 2 × model 2 through the Trainer: 2 steps with a checkpoint at
    step 2, the uninterrupted step 3 (profiled), then a fresh Trainer
    that restores step 2, takes step 3 bit for bit and checkpoints it;
    (b) the data
    line's int8 sync of (a)'s step-0 gradients; (c) reduced configs, card
    against CPU in fp32.  Returns the ring launches of (a)'s steps."""
    import math
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.dist import rank_tasks

    cfg = get_config(GRID_ARCH)
    held = pool.run(rank_tasks.free_memory)
    print(f"[grid] before 9c the ranks hold "
          f"{', '.join('%.2f' % (h['reserved'] / 2**30) for h in held)} GiB "
          f"reserved ({smi})", flush=True)
    ckpt_dir = ROOT / "build" / "smoke_grid_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    # the fused rings, as before the grid's default became the
    # reference's ``xla`` (phase 9d runs that)
    kw = dict(cfg_overrides=dict(n_layers=GRID_LAYERS), tp_transport="fused",
              step_overrides=dict(seq_chunk=512, warmup_steps=1),
              dataset=dict(seq_len=GRID_SEQ, global_batch=2))
    t0 = time.perf_counter()
    # no interval save: each Trainer's checkpoint is its final save, the
    # first's at step 2, the restored one's at step 3
    res = pool.run(rank_tasks.train_grid, GRID_ARCH, steps=3,
                   ckpt_dir=str(ckpt_dir), ckpt_interval=100,
                   grad_bucket_kb=GRID_BUCKET_KB, resume_check=True,
                   profile=True, log=False, cleanup=True,
                   **GRID_SHAPE, **kw)
    tag = (f"[grid] {GRID_ARCH} full width at {GRID_LAYERS} layers, data 2 "
           f"x model 2")
    print(f"{tag}: Trainer run {time.perf_counter() - t0:.1f}s ({smi})",
          flush=True)
    want = tp_launches(GRID_LAYERS, 2, cfg.remat, True,
                       head_chunks(GRID_SEQ - 1, 2, 512))
    for r in res:
        if not r["resumed"]:
            fail(f"{tag} rank {r['coords']}: the restored step 3 differs "
                 f"from the uninterrupted one")
        if [s for s, _ in r["ckpt_seconds"]] != [2, 3]:
            fail(f"{tag} rank {r['coords']}: checkpoints at steps "
                 f"{[s for s, _ in r['ckpt_seconds']]}, expected [2, 3]")
        for k, got in enumerate(r["launches"] + [r["next_launches"]]):
            if got != want:
                fail(f"{tag} rank {r['coords']} step {k}: cc_matmul "
                     f"launches {got}, expected {want}")
    for m in (0, 1):
        line = [r["digests"] for r in res if r["coords"][1] == m]
        if any(d != line[0] for d in line[1:]):
            fail(f"{tag}: parameters differ across the data ranks of "
                 f"model rank {m}")
    hist = res[0]["history"]
    if not all(math.isfinite(h["loss"]) for h in hist) or abs(
            hist[0]["loss"] - math.log(cfg.vocab_size)) > 0.5:
        fail(f"{tag}: losses {[h['loss'] for h in hist]}")
    for k, h in enumerate(hist):
        lines = [r["line_stats"][k] for r in res]
        parts = []
        for axis in ("data", "model"):
            wire = max(ls[axis]["wire_s"] for ls in lines)
            staged = sum(ls[axis]["staged_bytes"] for ls in lines)
            parts.append(f"{axis} line wire {wire:.3f}s, staged "
                         f"{staged / 2**30:.3f} GiB")
        rep = sum(r["rep_wire"][k]["staged_bytes"] for r in res)
        parts[-1] += (f" (the replicated leaves' gradient all-reduce "
                      f"{rep / 2**30:.3f} GiB, everything else "
                      f"{(staged - rep) / 2**30:.3f} GiB)")
        print(f"{tag} step {k + 1}{' (restored run)' if k == 2 else ''}: "
              f"{h['step_time_s']:.3f}s (the slowest rank), loss "
              f"{h['loss']:.6f}, grad_norm {h['grad_norm']:.6f}; "
              f"{'; '.join(parts)} (the slowest rank's wire, all ranks' "
              f"bytes)", flush=True)
    r0 = res[0]
    nxt = "; ".join(
        f"{axis} line wire {max(r['next_line_stats'][axis]['wire_s'] for r in res):.3f}s"
        for axis in ("data", "model"))
    print(f"{tag}: uninterrupted step 3 {max(r['next_seconds'] for r in res):.3f}s"
          f" under torch.profiler ({nxt}); checkpoint writes (gather + write + "
          f"barrier, rank 0) {[(s, round(t, 3)) for s, t in r0['ckpt_seconds']]}"
          f" s; restore {max(r['restore_seconds'] for r in res):.3f}s (the "
          f"slowest rank, a warm read); peak memory a rank "
          f"{', '.join('%.2f' % (r['peak_bytes'] / 2**30) for r in res)} GiB; "
          f"restored step 3 == uninterrupted bit for bit on every rank; "
          f"{len(r0['digests'])} leaves bitwise equal across data ranks",
          flush=True)
    prof = [r.get("profile") for r in res]
    wall = max(r["next_seconds"] for r in res)
    if all(p and p["kernel_ms"] > 0 for p in prof):
        union = rank_tasks.union_spans(
            [sp for p in prof for sp in p["kernel_spans"]])
        extent = ((union[-1][1] - union[0][0]) / 1e9 if union
                  else float("inf"))
        if extent <= 1.05 * wall:
            busy = sum(e - s for s, e in union) / 1e9
            print(f"{tag} step 3: the union of the ranks' kernel spans is "
                  f"{busy:.4f}s of the {wall:.3f}s wall "
                  f"({100 * (1 - busy / wall):.2f}% of the wall with no "
                  f"kernel of any rank in flight); cc_matmul hop products "
                  f"{sum(p['cc_ms'] for p in prof) / 1e3:.3f}s, all kernels "
                  f"{sum(p['kernel_ms'] for p in prof) / 1e3:.3f}s, copies "
                  f"{sum(p['copy_ms'] for p in prof) / 1e3:.3f}s (summed "
                  f"over the ranks)", flush=True)
        else:
            print(f"{tag} step 3: the ranks' kernel spans lie {extent:.2f}s "
                  f"apart against {wall:.2f}s wall: the union not measured",
                  flush=True)
    else:
        print(f"{tag}: torch.profiler saw no device time: the idle share "
              f"not measured", flush=True)
    launches = {n: sum(sum(step[n] for step in r["launches"])
                       + r["next_launches"][n] for r in res) for n in want}

    # (b) the data line's sync of the step-0 gradients, int8 and exact
    t0 = time.perf_counter()
    sync = pool.run(rank_tasks.grid_sync, GRID_ARCH,
                    bucket_bytes=GRID_BUCKET_KB << 10, **GRID_SHAPE, **kw)
    for r in sync:
        runs = r["runs"]
        exact, bulk, stream = (runs["exact"], runs["int8 bulk"],
                               runs["int8 streamed"])
        if bulk["digest"] != stream["digest"]:
            fail(f"[grid-sync] rank {r['coords']}: int8 streamed != bulk")
        if not (bulk["max_err"] <= 2 * r["scale"] + 1e-6
                and bulk["max_residual"] <= r["scale"] + 1e-6):
            fail(f"[grid-sync] rank {r['coords']}: mean error "
                 f"{bulk['max_err']} or residual {bulk['max_residual']} "
                 f"beyond the bound (scale {r['scale']})")
        reckoned = r["wire_int8"] / r["wire_fp32"]
        for kind in ("staged_bytes", "sent_bytes"):
            ratio = bulk[kind] / exact[kind]
            if abs(ratio / reckoned - 1) > 1e-3:
                fail(f"[grid-sync] rank {r['coords']}: {kind} int8 / fp32 "
                     f"{ratio}, bucket_wire_bytes {reckoned}")
    r = sync[0]
    runs = r["runs"]

    def ratio(kind):
        fp32 = runs["exact"][kind]
        return "%.4f" % (runs["int8 bulk"][kind] / fp32) if fp32 else "-"

    print(f"[grid-sync] step-0 gradients, {r['elements'] / 1e6:.1f}M fp32 a "
          f"rank in {GRID_BUCKET_KB >> 10} MiB buckets over each data line "
          f"of 2 (exact: the step's own mean_buckets): " + "; ".join(
              f"{name} {run['seconds']:.3f}s, wire {run['wire_s']:.3f}s, "
              f"staged {run['staged_bytes'] / 2**30:.3f} GiB, sent "
              f"{run['sent_bytes'] / 2**30:.3f} GiB"
              for name, run in runs.items())
          + f"; int8/fp32 sent {ratio('sent_bytes')}, staged "
          f"{ratio('staged_bytes')} (bucket_wire_bytes "
          f"{r['wire_int8'] / r['wire_fp32']:.4f}); "
          f"int8 mean max |err| {max(x['runs']['int8 bulk']['max_err'] for x in sync):.3g}"
          f" within 2 x scale {2 * max(x['scale'] for x in sync):.3g}, "
          f"residual max {max(x['runs']['int8 bulk']['max_residual'] for x in sync):.3g};"
          f" streamed == bulk bit for bit; "
          f"{time.perf_counter() - t0:.1f}s ({smi})", flush=True)

    # (c) reduced configs in fp32, card against CPU
    t = 1e-4
    for arch, grid, extra in GRID_REDUCED:
        extra = dict(extra)
        batch = extra.pop("global_batch", 4)
        micro = extra.pop("microbatches", 1)
        rkw = dict(steps=2, reduced=True, seed=0, init_device="cpu",
                   step_overrides=dict(seq_chunk=8, warmup_steps=1,
                                       microbatches=micro),
                   data=dict(seq_len=17, global_batch=batch),
                   return_params=True, grid=grid, **extra)
        t0 = time.perf_counter()
        card = pool.run(rank_tasks.train, arch, device="cuda", **rkw)
        cpu = pool.run(rank_tasks.train, arch, device="cpu", **rkw)
        name = f"[grid-reduced] {arch} " + " x ".join(
            f"{a} {n}" for a, n in grid.items())
        worst = {"metric": 0.0, "mean": 0.0, "beyond": 0}
        for rank, (a, b) in enumerate(zip(card, cpu)):
            for ma, mb in zip(a["metrics"], b["metrics"]):
                for key in ("loss", "grad_norm", "moe_aux"):
                    if mb.get(key):
                        rel = abs(ma[key] - mb[key]) / abs(mb[key])
                        worst["metric"] = max(worst["metric"], rel)
            params_rule(name, rank, a["params"], b["params"], worst, t)
        if worst["metric"] > t:
            fail(f"{name}: card vs CPU metrics differ by {worst['metric']}")
        inner = {}
        for a in card:
            inner.setdefault(a["coords"][1], []).append(a["digests"])
        if any(d != v[0] for v in inner.values() for d in v[1:]):
            fail(f"{name}: parameters differ across data ranks")
        print(f"{name} fp32, 2 steps, card vs CPU: metrics max rel "
              f"{worst['metric']:.3g} (tol {t}); params mean |d|/mean |p| "
              f"max {worst['mean']:.3g}; losses "
              f"{[round(m['loss'], 6) for m in card[0]['metrics']]}; "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    return launches


#: phase 9d: the reference launcher's default job (``python -m
#: repro.launch.train``: smollm-360m, data 2 × model 2, ``tp="xla"``) at
#: full width and depth through the launcher's Trainer grid task with the
#: launcher's step settings for 2 steps: ~181 M parameters a rank, ~3.6 GB
#: of training state a rank; sequences of 1024 tokens, 4 a step
JOB_ARCH, JOB_SEQ, JOB_BATCH, JOB_STEPS = "smollm-360m", 1025, 4, 2


def phase_launch_job(pool, smi):
    """9d: the reference launcher's default job on the four-rank pool
    (``launch/train.py --full --data-axis 2 --model-axis 2``'s rank task,
    its checkpoint under ``build/`` and removed).  Held: every rank on the
    ``xla`` path, no cc_matmul kernel launched, finite losses, the step-0
    loss within 0.5 of ln V, the parameters bitwise equal across the data
    ranks of each model rank.  Printed a step: the step time (the slowest
    rank's), each line's wire seconds (the slowest rank) and staged bytes
    (all ranks), the replicated leaves' all-reduce apart; the peak memory
    a rank; the final checkpoint's write time."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.dist import rank_tasks
    from repro_torch.launch import train as launch_train

    cfg = get_config(JOB_ARCH)
    state = launch_train.optimizer_state(cfg)
    per_rank = launch_train.rank_params(cfg, "model", 2)
    state_gb = launch_train.train_state_bytes(cfg, **state,
                                              params=per_rank) / 1e9
    held = pool.run(rank_tasks.free_memory)
    ckpt_dir = ROOT / "build" / "smoke_job_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    step_kw = dict(microbatches=1, peak_lr=3e-4,
                   warmup_steps=max(JOB_STEPS // 20, 5),
                   total_steps=JOB_STEPS,
                   seq_chunk=min(2048, JOB_SEQ - 1), **state)
    t0 = time.perf_counter()
    res = pool.run(rank_tasks.train_grid, JOB_ARCH, steps=JOB_STEPS,
                   ckpt_dir=str(ckpt_dir), ckpt_interval=50, data=2,
                   model=2, step_overrides=step_kw, log=False, cleanup=True,
                   dataset=dict(seq_len=JOB_SEQ, global_batch=JOB_BATCH))
    tag = (f"[job] {JOB_ARCH} full width at {cfg.n_layers} of "
           f"{cfg.n_layers} layers, data 2 x model 2, tp=xla")
    print(f"{tag}: {per_rank / 1e6:.1f}M params a rank in "
          f"{cfg.param_dtype}, {state_gb:.2f} GB of training state a rank "
          f"before activations (the launcher's reckoning), "
          f"{JOB_BATCH} x {JOB_SEQ - 1} tokens a step; the ranks held "
          f"{', '.join('%.2f' % (h['reserved'] / 2**30) for h in held)} "
          f"GiB reserved before; Trainer run "
          f"{time.perf_counter() - t0:.1f}s ({smi})", flush=True)
    for r in res:
        if r["scheme"] != "xla":
            fail(f"{tag} rank {r['coords']}: the {r['scheme']} TP path")
        if any(v for step in r["launches"] for v in step.values()):
            fail(f"{tag} rank {r['coords']}: cc_matmul launches "
                 f"{r['launches']}")
    for m in (0, 1):
        line = [r["digests"] for r in res if r["coords"][1] == m]
        if any(d != line[0] for d in line[1:]):
            fail(f"{tag}: parameters differ across the data ranks of "
                 f"model rank {m}")
    hist = res[0]["history"]
    if len(hist) != JOB_STEPS or not all(
            math.isfinite(h["loss"]) for h in hist) or abs(
            hist[0]["loss"] - math.log(cfg.vocab_size)) > 0.5:
        fail(f"{tag}: losses {[h['loss'] for h in hist]}")
    for k, h in enumerate(hist):
        lines = [r["line_stats"][k] for r in res]
        parts = []
        for axis in ("data", "model"):
            wire = max(ls[axis]["wire_s"] for ls in lines)
            staged = sum(ls[axis]["staged_bytes"] for ls in lines)
            parts.append(f"{axis} line wire {wire:.3f}s, staged "
                         f"{staged / 2**30:.3f} GiB")
        rep = sum(r["rep_wire"][k]["staged_bytes"] for r in res)
        parts[-1] += (f" (the replicated leaves' gradient all-reduce "
                      f"{rep / 2**30:.3f} GiB, everything else "
                      f"{(staged - rep) / 2**30:.3f} GiB)")
        print(f"{tag} step {k + 1}: {h['step_time_s']:.3f}s (the slowest "
              f"rank), loss {h['loss']:.6f}, grad_norm "
              f"{h['grad_norm']:.6f}, lr {h['lr']:.3g}; {'; '.join(parts)} "
              f"(the slowest rank's wire, all ranks' bytes) ({smi})",
              flush=True)
    print(f"{tag}: peak memory a rank "
          f"{', '.join('%.2f' % (r['peak_bytes'] / 2**30) for r in res)} "
          f"GiB; final checkpoint (gather + write + barrier, rank 0) "
          f"{[(s, round(t, 3)) for s, t in res[0]['ckpt_seconds']]} s; "
          f"parameters bitwise equal across data ranks ({smi})", flush=True)
    pool.run(rank_tasks.free_memory)


#: phase 9e: the reference's GSPMD TP on the MLA and VLM blocks at full
#: width, depth cut to 8 layers (~8–9 GB of training state a rank; the
#: published 62 and 24 do not fit two ranks beside the smoke's other
#: pools), tp 2, step 0 of one sequence of 1024 tokens a row, 2 rows
XLA_FAMILY_ARCHS = ("minicpm3-4b", "internvl2-2b")
XLA_FAMILY_LAYERS, XLA_FAMILY_SEQ, XLA_FAMILY_BATCH = 8, 1024, 2


def phase_xla_families(pool, smi):
    """9e: minicpm3-4b (MLA: ``w_dq`` and ``w_dkv`` gathered whole for
    the latents' norms) and internvl2-2b (its 256 patch rows first in
    the sequence that is split; its vocab of 92553, odd, whole on every
    rank) at tp 2 under ``xla``, bf16 from seed 0, random token ids and
    patch embeddings from a seeded generator.  Held: the ``xla`` path,
    no cc_matmul kernel launched, the same finite loss on both ranks
    within 0.5 of ln V, replicated leaves bitwise equal.  Printed: the
    step time, the line's wire seconds and staged bytes, peak memory a
    rank."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.dist import rank_tasks

    rng = np.random.default_rng(0)
    for arch in XLA_FAMILY_ARCHS:
        cfg = get_config(arch)
        toks = rng.integers(0, cfg.vocab_size,
                            size=(XLA_FAMILY_BATCH, XLA_FAMILY_SEQ + 1))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.frontend:
            batch["frontend_embeds"] = rng.standard_normal(
                (XLA_FAMILY_BATCH, cfg.frontend_tokens, cfg.frontend_dim)
            ).astype(np.float32)
        t0 = time.perf_counter()
        res = pool.run(rank_tasks.train, arch, steps=1, tp_transport="xla",
                       seed=0, batches=[batch],
                       cfg_overrides=dict(n_layers=XLA_FAMILY_LAYERS),
                       step_overrides=dict(seq_chunk=512, warmup_steps=1))
        r0 = res[0]
        m = r0["metrics"][0]
        tag = (f"[xla-tp2] {arch} full width at {XLA_FAMILY_LAYERS} of "
               f"{cfg.n_layers} layers")
        vocab = ("split over the vocab" if "embed" in r0["sharded"]
                 else "whole (the vocab does not split)")
        print(f"{tag}, 2 ranks, step 0: "
              f"{max(r['seconds'][0] for r in res):.2f}s (the slowest "
              f"rank), loss {m['loss']:.6f}, grad_norm "
              f"{m['grad_norm']:.6f}; {r0['n_params'] / 1e6:.1f}M params a "
              f"rank in {cfg.param_dtype}, embed and lm_head {vocab}; "
              f"staged "
              f"{sum(r['stats'][0]['staged_bytes'] for r in res) / 2**30:.3f}"
              f" GiB through the host (all ranks), wire "
              f"{max(r['stats'][0]['wire_s'] for r in res):.2f}s (the "
              f"slowest rank); peak "
              f"{', '.join('%.2f' % (r['peak_bytes'] / 2**30) for r in res)}"
              f" GiB a rank; {len(r0['replicated'])} replicated leaves "
              f"bitwise equal; {time.perf_counter() - t0:.1f}s ({smi})",
              flush=True)
        for r in res:
            if r["scheme"] != "xla" or any(r["launches"][0].values()):
                fail(f"{tag}: the {r['scheme']} path, cc_matmul launches "
                     f"{r['launches'][0]}")
            if r["metrics"][0]["loss"] != m["loss"] or \
                    r["replicated"] != r0["replicated"]:
                fail(f"{tag}: the ranks disagree")
        if not (math.isfinite(m["loss"]) and abs(
                m["loss"] - math.log(cfg.vocab_size)) <= 0.5):
            fail(f"{tag}: step-0 loss {m['loss']} not within 0.5 of "
                 f"ln {cfg.vocab_size}")
        pool.run(rank_tasks.free_memory)


#: phase 9b: expert parallelism, llama4-scout at full width
EP_ARCH = "llama4-scout-17b-a16e"
EP_TRAIN_ARCHS = ("llama4-scout-17b-a16e", "grok-1-314b")
EP_RANKS = 4
EP_LAYER_SEQ = 2048                 # one row a rank
EP_SERVE_LAYERS, EP_SERVE_PROMPT, EP_SERVE_STEPS = 4, 128, 16
EP_SERVE_PROFILE_STEP = 8
#: the bf16 tolerances of 9b.  bf16's unit roundoff is 2^-9 (1.95e-3);
#: EP and the dense layer compute the same products, in other shapes
#: (the shared expert over a rank's rows, the experts over the arriving
#: buckets), so an output may round the other way a few times.  Relative
#: Frobenius error of y and of each gradient:
EP_LAYER_TOL = 1e-2
#: a gradient that is zero in exact arithmetic (the router's at top-1,
#: whose one renormalised weight is 1 whatever the logits), EP's and the
#: dense layer's, against the layer's largest parameter gradient
EP_ZERO_TOL = 1e-3
#: max |Δ logit| / max |logit| of a row, prefill and every decode step,
#: after 4 layers of such roundings and the head's bf16 product
EP_SERVE_TOL = 3e-2


def ep_train_runs(n):
    """9b (a)'s runs on a pool of ``n``: (arch, the run's transport
    arguments and data, tag) — ``ring`` and ``xla`` for each arch, and at
    the grok-1 preset's own extent its own policy (``moe="auto"``,
    streamed), four rows a rank so the exchange splits into its 4
    chunks."""
    from repro_torch.configs import get_ep_preset

    runs = [(arch, dict(moe_transport=transport,
                        data=dict(seq_len=17, global_batch=8)), transport)
            for arch in EP_TRAIN_ARCHS for transport in ("ring", "xla")]
    preset = get_ep_preset("grok-1-314b-ep")
    if n == preset.expert_axis:
        policy = preset.step.resolved_transport()
        runs.append((preset.arch, dict(
            moe_transport=policy.moe,
            moe_stream_chunks=policy.moe_stream_chunks,
            step_overrides=dict(seq_chunk=8, warmup_steps=1),
            data=dict(seq_len=17, global_batch=4 * n)),
            f"preset {policy.moe} x{policy.moe_stream_chunks}"))
    return runs


def phase_ep_train(pool, smi):
    """9b (a): reduced llama4-scout and grok-1 in fp32 trained by EP over
    the pool, ``ring`` and ``xla``, and grok-1 under its preset's own
    policy at its extent, on the card and on the CPU."""
    from repro_torch.dist import rank_tasks

    n, t = pool.size, 1e-4
    kw = dict(steps=2, reduced=True, seed=0, init_device="cpu",
              step_overrides=dict(seq_chunk=8, warmup_steps=1,
                                  microbatches=2), return_params=True)
    for arch, over, label in ep_train_runs(n):
        t0 = time.perf_counter()
        card = pool.run(rank_tasks.train, arch, device="cuda",
                        **dict(kw, **over))
        cpu = pool.run(rank_tasks.train, arch, device="cpu",
                       **dict(kw, **over))
        tag = f"ep-reduced {arch} ep{n} {label}"
        worst = {"metric": 0.0, "mean": 0.0, "beyond": 0}
        for rank, (a, b) in enumerate(zip(card, cpu)):
            for ma, mb in zip(a["metrics"], b["metrics"]):
                for key in ("loss", "grad_norm", "moe_aux"):
                    rel = abs(ma[key] - mb[key]) / abs(mb[key])
                    worst["metric"] = max(worst["metric"], rel)
            params_rule(tag, rank, a["params"], b["params"], worst, t)
        if worst["metric"] > t:
            fail(f"{tag}: card vs CPU metrics differ by "
                 f"{worst['metric']}")
        if any(r["replicated"] != card[0]["replicated"] for r in card):
            fail(f"{tag}: replicated leaves differ across ranks")
        m = card[0]["metrics"]
        steps_s = ", ".join(
            "%.3f" % max(r["seconds"][k] for r in card)
            for k in range(len(m)))
        wire_s = max(sum(st["wire_s"] for st in r["stats"])
                     for r in card)
        print(f"[{tag}] fp32, 2 steps, card vs CPU: loss/grad_norm/"
              f"moe_aux max rel {worst['metric']:.3g} (tol {t}); "
              f"params mean |d|/mean |p| max {worst['mean']:.3g} (tol "
              f"{t}); {len(card[0]['replicated'])} replicated leaves "
              f"bitwise equal on {n} ranks; losses "
              f"{[round(x['loss'], 6) for x in m]}, moe_aux "
              f"{[round(x['moe_aux'], 6) for x in m]}; card steps "
              f"{steps_s}s, wire {wire_s:.3f}s; "
              f"{time.perf_counter() - t0:.1f}s ({smi})", flush=True)


def release_shared(pool):
    """Free this process's cached device memory, that shared with the
    pool's ranks through CUDA IPC too: a rank drops a task's arguments
    before it takes the next task, so a task that every rank runs (a
    barrier) fences their release, then ``ipc_collect`` frees the
    blocks."""
    import torch

    from repro_torch.dist import rank_tasks

    pool.run(rank_tasks.collective_op, "xla", "barrier", None)
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()


def ep_layer_dense(smi):
    """9b (b)'s dense side: one full-width llama4-scout MoE layer (bf16,
    seeded on the card), ``layers.moe`` over the 4 rows and its autograd
    against a seeded cotangent.  Returns (cfg, params, x, cotangent, the
    dense results, its seconds), every tensor on the card."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist import sharding
    from repro_torch.models import layers as L
    from repro_torch.models import model

    cfg = get_config(EP_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model._init_moe(cfg, gen, "cuda")
    shape = (EP_RANKS, EP_LAYER_SEQ, cfg.d_model)
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    ct = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    p = sharding.map_leaves(lambda _, t: t.detach().requires_grad_(True),
                            params)
    xg = x.clone().requires_grad_(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = L.moe(cfg, p, xg)
    (y.float() * ct.float()).sum().backward()
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t0
    with torch.no_grad():
        _, idx, keep, _, cap = L.moe_route(cfg, params["router"], x)
    want = {"y": y.detach(), "x_grad": xg.grad, "idx": idx, "keep": keep,
            "grads": {"/".join(map(str, path)): t.grad
                      for path, t in sharding.leaves(p)}}
    print(f"[ep-layer] dense layers.moe, {EP_ARCH} full width (D "
          f"{cfg.d_model}, {cfg.n_experts} experts, F {cfg.d_ff}, top-"
          f"{cfg.experts_per_token}, capacity {cap} a row at S "
          f"{EP_LAYER_SEQ}), {EP_RANKS} rows, bf16, forward + backward on "
          f"all experts: {dense_s:.3f}s; {int(keep.sum())} of "
          f"{keep.numel()} choices kept; {smi}", flush=True)
    return cfg, params, x, ct, want, dense_s


def phase_ep_layer(pool, ref, smi):
    """9b (b): the layer at EP 4 against the dense results."""
    from repro_torch.dist import rank_tasks

    cfg, params, x, ct, want, dense_s = ref
    res = pool.run(rank_tasks.moe_ep_layer_check, cfg, params, x, ct, want,
                   transport="ring")
    for rank, r in enumerate(res):
        if not (r["same_idx"] and r["same_keep"]):
            fail(f"ep-layer rank {rank}: routing differs from the dense "
                 f"layer's (idx {r['same_idx']}, keep {r['same_keep']})")
        scale = max(e["ref_max"] for name, e in r["errors"].items()
                    if name not in ("y", "x_grad"))
        for name, e in r["errors"].items():
            if name == "router" and cfg.experts_per_token == 1:
                ok = max(e["max_abs"], e["ref_max"]) <= EP_ZERO_TOL * scale
            else:
                ok = e["rel_fro"] <= EP_LAYER_TOL
            if not ok:
                fail(f"ep-layer rank {rank} {name}: rel Frobenius "
                     f"{e['rel_fro']:.3g}, max |d| {e['max_abs']:.3g} of "
                     f"max {e['ref_max']:.3g} (the layer's largest "
                     f"gradient {scale:.3g})")
    worst = {name: max(r["errors"][name]["rel_fro"] for r in res)
             for name in res[0]["errors"]}
    router = max(max(r["errors"]["router"]["max_abs"],
                     r["errors"]["router"]["ref_max"]) for r in res)
    peak = ", ".join("%.2f" % (r["peak_bytes"] / 2**30) for r in res)
    print(f"[ep-layer] {EP_ARCH} MoE layer at EP {pool.size} (ring "
          f"exchange over gloo), a row of {EP_LAYER_SEQ} a rank, bf16: "
          f"routing equal to dense on every rank ({res[0]['kept']} of "
          f"{res[0]['choices']} choices kept on rank 0); worst rel "
          f"Frobenius error against dense (tol {EP_LAYER_TOL}): "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + f" (the router's gradient, zero in exact arithmetic at top-"
          f"{cfg.experts_per_token}: max |g| {router:.3g}); forward "
          f"{max(r['forward_s'] for r in res):.3f}s, backward "
          f"{max(r['backward_s'] for r in res):.3f}s (the slowest rank), "
          f"wire {max(r['wire_s'] for r in res):.3f}s (Group.stats "
          f"wire_s of the 2 exchanges forward and the 2 backward), dense "
          f"in one process {dense_s:.3f}s; peak "
          f"{peak} GiB a rank; {smi}", flush=True)


def ep_serve_dense(smi):
    """9b (c)'s dense side: full-width llama4-scout cut to 4 layers, every
    expert in this process, bulk prefill of the 4 prompts and 16
    dense-combine decode steps, greedy.  Returns the prompts, the logits
    (prefill, then each step) and the fed tokens."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.decode import decode_step
    from repro_torch.models.model import count_params, init_params
    from repro_torch.models.prefill import prefill

    cfg = dataclasses.replace(get_config(EP_ARCH), n_layers=EP_SERVE_LAYERS)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, size=(EP_RANKS,
                                                    EP_SERVE_PROMPT))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    n_params = count_params(params)
    logits_all, feed, step_s = [], [], []
    with torch.no_grad():
        cache, logits = prefill(
            cfg, params, torch.as_tensor(prompts, device="cuda"),
            cache_len=EP_SERVE_PROMPT + EP_SERVE_STEPS)
        logits_all.append(logits.cpu().numpy())
        for _ in range(EP_SERVE_STEPS):
            nxt = torch.argmax(logits, dim=-1)
            feed.append(nxt.cpu().numpy())
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            cache, logits = decode_step(cfg, params, cache, nxt)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
            logits_all.append(logits.cpu().numpy())
    peak = torch.cuda.max_memory_allocated() / 2**30
    del params, cache, logits
    torch.cuda.empty_cache()
    print(f"[ep-serve] dense-combine reference: {EP_ARCH} full width cut "
          f"to {cfg.n_layers} layers, {n_params} params in "
          f"{cfg.param_dtype} in one process, batch {EP_RANKS}, prompt "
          f"{EP_SERVE_PROMPT}, {EP_SERVE_STEPS} steps; decode "
          f"{1e3 * float(np.median(step_s)):.2f} ms a step (median); peak "
          f"{peak:.2f} GiB; {time.perf_counter() - t0:.1f}s; {smi}",
          flush=True)
    return dict(prompts=prompts, logits=logits_all, feed=np.stack(feed),
                n_params=n_params)


def phase_ep_serve(pool, ref, smi):
    """9b (c): the 4-layer model served at EP 4, a row a rank, against the
    dense-combine run, the exchange on ``ring`` (one decode step
    profiled) and on ``xla``."""
    import torch

    print(f"[ep-serve] this process holds "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB of the card "
          f"before the ranks draw; {smi}", flush=True)
    for transport in ("ring", "xla"):
        ep_serve_run(pool, ref, smi, transport,
                     EP_SERVE_PROFILE_STEP if transport == "ring" else None)


def ep_serve_run(pool, ref, smi, transport, profile_step):
    import numpy as np

    from repro_torch.dist import rank_tasks

    t0 = time.perf_counter()
    res = pool.run(rank_tasks.ep_serve, EP_ARCH, ref["prompts"],
                   steps=EP_SERVE_STEPS, transport=transport,
                   cfg_overrides={"n_layers": EP_SERVE_LAYERS}, seed=0,
                   feed=ref["feed"], profile_step=profile_step)
    pool_s = time.perf_counter() - t0
    tag = f"ep-serve {transport}"
    worst, agree = 0.0, 0
    for rank, r in enumerate(res):
        if r["prefill_flash_launches"] != EP_SERVE_LAYERS:
            fail(f"{tag} rank {rank}: prefill launched flash "
                 f"{r['prefill_flash_launches']} times, expected "
                 f"{EP_SERVE_LAYERS}")
        got = [r["prefill_logits"]] + r["logits"]
        for k, (g, w) in enumerate(zip(got, ref["logits"])):
            w = w[rank:rank + 1]
            if not np.isfinite(g).all():
                fail(f"{tag} rank {rank} step {k}: non-finite logits")
            err = float(np.abs(g - w).max() / np.abs(w).max())
            worst = max(worst, err)
            if err > EP_SERVE_TOL:
                fail(f"{tag} rank {rank} step {k}: logits max |d|/max "
                     f"{err:.3g}, tol {EP_SERVE_TOL}")
        agree += sum(int(r["ids"][k][0] == np.argmax(ref["logits"][k + 1]
                                                     [rank]))
                     for k in range(EP_SERVE_STEPS))
    timed_steps = [k for k in range(1, EP_SERVE_STEPS) if k != profile_step]
    wall = [max(r["seconds"][k] for r in res) for k in timed_steps]
    wire = [max(r["wire_s"][k] for r in res) for k in timed_steps]
    step0 = float(np.abs(res[0]["logits"][0] - ref["logits"][1][:1]).max()
                  / np.abs(ref["logits"][1][:1]).max())
    peak = ", ".join("%.2f" % (r["peak_bytes"] / 2**30) for r in res)
    print(f"[{tag}] {EP_ARCH} full width cut to {EP_SERVE_LAYERS} "
          f"layers at EP {pool.size} ({transport} exchange over gloo), one "
          f"row a rank, {res[0]['n_params']} params a rank (of "
          f"{ref['n_params']}): prefill {EP_SERVE_PROMPT} tokens (flash "
          f"{EP_SERVE_LAYERS} launches a rank), {EP_SERVE_STEPS} decode "
          f"steps fed the dense run's tokens; logits max |d|/max against "
          f"dense-combine: step 0 {step0:.3g}, worst {worst:.3g} (tol "
          f"{EP_SERVE_TOL}); greedy tokens agree {agree}/"
          f"{EP_SERVE_STEPS * pool.size}; decode "
          f"{1e3 * float(np.median(wall)):.2f} ms a step (median over "
          f"{len(wall)} steps, the slowest rank; min "
          f"{1e3 * min(wall):.2f}), wire {1e3 * float(np.median(wire)):.2f}"
          f" ms a step; peak {peak} GiB a rank; pool {pool_s:.1f}s; {smi}",
          flush=True)
    if profile_step is None:
        return
    prof = [r.get("profile") for r in res]
    step_wall = max(r["seconds"][profile_step] for r in res)
    if all(p and p["kernel_spans"] for p in prof):
        union = rank_tasks.union_spans(
            [sp for p in prof for sp in p["kernel_spans"]])
        busy = sum(e - b for b, e in union) / 1e9
        extent = (union[-1][1] - union[0][0]) / 1e9
        print(f"[{tag}] decode step {profile_step} under torch.profiler: "
              f"the union of the ranks' kernel spans is {1e3 * busy:.3f} ms "
              f"of the {1e3 * step_wall:.2f} ms wall (the slowest rank): "
              f"{100 * (1 - busy / step_wall):.2f}% of the wall with no "
              f"kernel of any rank in flight (spans within "
              f"{1e3 * extent:.2f} ms; against the median unprofiled step, "
              f"{100 * (1 - busy / float(np.median(wall))):.2f}%); rank 0's "
              f"top device ops: "
              + "; ".join(f"{name[:60]} {ms:.3f} ms x{n}"
                          for name, ms, n in prof[0]["top"][:5]),
              flush=True)
    else:
        print(f"[{tag}] torch.profiler saw no kernel spans: the idle share "
              f"not measured", flush=True)


#: the one-GPU training phase: full-width smollm-360m at 16 of its 32
#: layers (204.5 M parameters; the smoke's time limit cannot spare the
#: three ~5 GB checkpoints of all 32)
TRAIN_ARCH, TRAIN_LAYERS = "smollm-360m", 16
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_CHUNK = 8, 2048, 2, 512
TRAIN_STEPS, TRAIN_CKPT_AT = 4, 2
# a resumed step against the uninterrupted one when the two are not
# bitwise equal (the step runs under torch's deterministic algorithms, so
# they should be): relative
RESUME_TOL = {"loss": 1e-4, "grad_norm": 1e-3}
#: device kernels of the port that a training step may show, by family:
#: flash attention, the SSD forward (three kernels a call of more than one
#: chunk) and the SSD backward (four a call)
PORT_EVENTS = {"flash": re.compile(r"flash_fwd|flash_merge"),
               "ssd": re.compile(r"ssd_chunks|ssd_pass"),
               "ssd_bwd": re.compile(r"ssd_bwd_")}


def kernel_counts():
    """Launch counts of every kernel family of the port."""
    from repro_torch.kernels.cc_matmul import ops as cc_ops
    from repro_torch.kernels.flash_attention import FLASH
    from repro_torch.kernels.matmul import MATMUL
    from repro_torch.kernels.ssd import SSD, SSD_BWD

    return dict(cc_ops.launches(), flash_attention=FLASH.launches,
                ssd=SSD.launches, ssd_bwd=SSD_BWD.launches,
                matmul=MATMUL.launches)


def reset_kernel_counts():
    from repro_torch.kernels.cc_matmul import ops as cc_ops
    from repro_torch.kernels.flash_attention import FLASH
    from repro_torch.kernels.matmul import MATMUL
    from repro_torch.kernels.ssd import SSD, SSD_BWD

    cc_ops.reset_counts()
    FLASH.launches = SSD.launches = SSD_BWD.launches = MATMUL.launches = 0


def profile_call(fn, patterns=None):
    """One call of ``fn`` (a train step, a serving step) under
    torch.profiler: (top ten device ops by self device time [(name, ms,
    count)], the device's idle share of the call's window, the call's
    wall ms, device events by the name patterns ``patterns``, by default
    the port's kernels by family, ``PORT_EVENTS``).  The window runs from the call's start on the host
    to the later of its end and the last device event; busy is the union
    of the device events inside it (kernels, copies, fills)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        with record_function("smoke_profiled_call"):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILE_PAD_S)
    events = prof.events()
    win = [e for e in events if e.name == "smoke_profiled_call"
           and e.device_type == torch.autograd.DeviceType.CPU]
    # the annotation's own range is filed under the card too: not work
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.name != "smoke_profiled_call"]
    port = {k: sum(1 for e in dev if pat.search(e.name))
            for k, pat in (patterns or PORT_EVENTS).items()}
    if not win or not dev:
        return [], None, wall_ms, port
    lo = win[0].time_range.start
    spans = sorted((max(e.time_range.start, lo), e.time_range.end)
                   for e in dev if e.time_range.end > lo)
    hi = max(win[0].time_range.end, spans[-1][1])
    busy, cur_lo, cur_hi = 0.0, None, None
    for a, b in spans:
        if cur_hi is None or a > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
            cur_lo, cur_hi = a, b
        else:
            cur_hi = max(cur_hi, b)
    busy += cur_hi - cur_lo
    rows = {}
    for e in dev:
        ms, n = rows.get(e.name, (0.0, 0))
        rows[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(((k, ms, n) for k, (ms, n) in rows.items()),
                 key=lambda r: -r[1])[:10]
    return top, 1.0 - busy / (hi - lo), wall_ms, port


def phase_train_1gpu(smi_line):
    """Full-width smollm-360m trained on one card through the Trainer:
    4 steps with a checkpoint at step 2, then a fresh Trainer restores
    step 2 and runs steps 2-3 again; one more step under torch.profiler;
    then reduced smollm in fp32, 2 tp-1 steps on the card and on the CPU."""
    import math
    import shutil
    import warnings

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.dist import sharding
    from repro_torch.dist.steps import StepConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    scfg = StepConfig(microbatches=TRAIN_MICRO, seq_chunk=TRAIN_CHUNK,
                      warmup_steps=1, total_steps=100)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN_SEQ + 1,
                                  global_batch=TRAIN_BATCH))
    ckpt_dir = ROOT / "build" / "smoke_train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    tag = f"[train-1gpu] ({smi_line})"
    print(f"{tag} at entry: {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
          f"allocated, {torch.cuda.memory_reserved() / 2**30:.3f} GiB "
          f"reserved by the caching allocator", flush=True)

    def on_step(step, m):
        peak = torch.cuda.max_memory_allocated() / 2**30
        # the bytes the program asked for, without the allocator's rounding
        # and its unsplit cached blocks
        asked = torch.cuda.memory_stats().get(
            "requested_bytes.all.peak", 0) / 2**30
        torch.cuda.reset_peak_memory_stats()
        print(f"{tag} step {step - 1}: {m['step_time_s']:.3f} s, "
              f"{m['tokens'] / m['step_time_s']:.1f} tokens/s, loss "
              f"{m['loss']:.6f}, grad_norm {m['grad_norm']:.6f}, lr "
              f"{m['lr']:.3g}; peak memory {peak:.2f} GiB (requested "
              f"{asked:.2f})", flush=True)

    def trainer(total):
        return Trainer(cfg, scfg, TrainerConfig(
            total_steps=total, ckpt_dir=str(ckpt_dir),
            ckpt_interval=TRAIN_CKPT_AT, keep_last=10, log_interval=1000),
            data, device="cuda", log_fn=lambda line: print(
                f"{tag} {line}", flush=True))

    torch.backends.cuda.matmul.allow_tf32 = False
    # deterministic kernels (the embedding's gradient sums in a fixed
    # order), without the NaN fill of every torch.empty that the mode
    # turns on by default: nothing on this path reads memory it did not
    # write, and the fill took ~12% of a step on an H100
    torch.use_deterministic_algorithms(True, warn_only=True)
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            reset_kernel_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            run = trainer(TRAIN_STEPS)
            params, opt, _ = run.train(on_step=on_step)
            counts = kernel_counts()
            print(f"{tag} {cfg.name} full width ({cfg.n_layers} of "
                  f"{get_config(TRAIN_ARCH).n_layers} layers, "
                  f"{sum(t.numel() for _, t in sharding.leaves(params)) / 1e6:.1f}"
                  f"M parameters in {cfg.param_dtype}, fp32 AdamW masters "
                  f"and moments, remat {cfg.remat}), batches of "
                  f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens in {TRAIN_MICRO} "
                  f"microbatches, seq_chunk {TRAIN_CHUNK}: {TRAIN_STEPS} "
                  f"steps with checkpoints in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            if any(counts.values()):
                fail(f"train-1gpu: kernels launched during training: "
                     f"{counts}")
            # the run stops after its step-2 checkpoint: drop the final one
            shutil.rmtree(ckpt_dir / f"step_{TRAIN_STEPS:08d}")
            resumed = trainer(TRAIN_STEPS)
            p_res, o_res, _ = resumed.train(on_step=on_step)
            if [h["step"] for h in resumed.history] != list(
                    range(TRAIN_CKPT_AT + 1, TRAIN_STEPS + 1)):
                fail(f"train-1gpu: the resumed run took steps "
                     f"{[h['step'] for h in resumed.history]}")
            same_params = all(torch.equal(a, b) for (_, a), (_, b) in zip(
                sharding.leaves((params, opt["master"], opt["mu"],
                                 opt["nu"])),
                sharding.leaves((p_res, o_res["master"], o_res["mu"],
                                 o_res["nu"]))))
            del p_res, o_res, resumed.step_fn
            batch = data.global_batch(TRAIN_STEPS)
            top, idle, wall_ms, events = profile_call(
                lambda: run.step_fn(params, opt, batch, TRAIN_STEPS))
            counts = kernel_counts()
        notes = sorted({str(w.message).split(".")[0] for w in caught})
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    for line in notes:
        print(f"{tag} warning under deterministic algorithms: "
              f"{line[:160]}", flush=True)

    hist = run.history
    loss0 = hist[0]["loss"]
    print(f"{tag} step-0 loss {loss0:.6f} vs ln {cfg.vocab_size} = "
          f"{math.log(cfg.vocab_size):.6f} (tol 0.5)", flush=True)
    if not (math.isfinite(loss0)
            and abs(loss0 - math.log(cfg.vocab_size)) <= 0.5):
        fail(f"train-1gpu: step-0 loss {loss0} not within 0.5 of "
             f"ln {cfg.vocab_size}")
    for h in hist:
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])):
            fail(f"train-1gpu: step {h['step'] - 1} not finite: {h}")
    bitwise = True
    for a, b in zip(resumed.history, hist[TRAIN_CKPT_AT:]):
        for key, tol in RESUME_TOL.items():
            rel = abs(a[key] - b[key]) / abs(b[key])
            bitwise = bitwise and a[key] == b[key]
            print(f"{tag} step {a['step'] - 1} resumed vs uninterrupted "
                  f"{key}: {a[key]!r} vs {b[key]!r} (rel {rel:.3g}; tol "
                  f"bitwise, else {tol})", flush=True)
            if not (math.isfinite(a[key]) and rel <= tol):
                fail(f"train-1gpu: resumed step {a['step'] - 1} {key} "
                     f"{a[key]} vs {b[key]}")
    print(f"{tag} resumed run bitwise equal to the uninterrupted one: "
          f"metrics {bitwise}, final parameters and AdamW state "
          f"{same_params}", flush=True)
    if any(events.values()) or any(counts.values()):
        fail(f"train-1gpu: a training step ran kernels of the port "
             f"(device events {events}, counts {counts})")
    print(f"{tag} profiled step {TRAIN_STEPS}: {wall_ms:.1f} ms wall, "
          f"device idle share "
          f"{'not measured' if idle is None else f'{idle:.4f}'}; "
          f"flash/SSD device events 0, kernel counts {counts}", flush=True)
    for name, ms, n in top:
        print(f"{tag}   {ms:9.3f} ms  x{n:<5} {name[:100]}", flush=True)
    if not top:
        print(f"{tag} torch.profiler saw no device time: top ops and idle "
              f"share not measured", flush=True)
    del params, opt, run
    torch.cuda.empty_cache()

    tp1_card_vs_cpu(cfg, "[train-1gpu]")


def tp1_card_vs_cpu(cfg, tag, remat=None):
    """The reduced ``cfg`` in fp32 (its ``remat`` replaced by ``remat``
    when given), 2 tp-1 steps (microbatches 2) on the card and on the CPU
    from the same parameters and batches (a frontend arch's with
    ``frontend_embeds`` drawn from a seed): loss and grad norm within 1e-4
    relative, every parameter leaf by the parameter rule at 1e-4 (mean
    |d| <= 1e-4 x the leaf's mean magnitude, max |d| <= 2 peak_lr + 1e-4
    x its max)."""
    import numpy as np
    import torch

    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.dist import sharding
    from repro_torch.dist.group import Group
    from repro_torch.dist.steps import (
        StepConfig,
        build_init,
        build_train_step,
        init_opt,
    )
    from repro_torch.models.model import params_to

    rcfg = cfg.reduced()
    if remat:
        rcfg = dataclasses.replace(rcfg, remat=remat)
    rscfg = StepConfig(microbatches=2, seq_chunk=8, warmup_steps=1)
    # the encoder-decoder's decoder takes decoder_max_seq rows
    seq = rcfg.decoder_max_seq if rcfg.family == "encdec" else 64
    rdata = SyntheticLM(DataConfig(vocab_size=rcfg.vocab_size,
                                   seq_len=seq + 1, global_batch=4))
    rng = np.random.default_rng(0)

    def batch_of(k):
        batch = rdata.global_batch(k)
        if rcfg.frontend:
            batch["frontend_embeds"] = torch.from_numpy(rng.standard_normal(
                (4, rcfg.frontend_tokens, rcfg.frontend_dim)
            ).astype(np.float32))
        return batch
    cpu = Group(rank=0, size=1, device=torch.device("cpu"))
    card = Group(rank=0, size=1, device=torch.device("cuda"))
    p_cpu, o_cpu = build_init(rcfg, cpu, rscfg)(0)
    p_gpu = params_to(p_cpu, "cuda")
    o_gpu = init_opt(p_gpu, rscfg)
    step_cpu = build_train_step(rcfg, cpu, rscfg)
    step_gpu = build_train_step(rcfg, card, rscfg)
    t = 1e-4
    worst = 0.0
    for k in range(2):
        batch = batch_of(k)
        p_cpu, o_cpu, m_cpu = step_cpu(p_cpu, o_cpu, batch, k)
        p_gpu, o_gpu, m_gpu = step_gpu(p_gpu, o_gpu, batch, k)
        for key in ("loss", "grad_norm"):
            worst = max(worst, abs(m_gpu[key] - m_cpu[key])
                        / abs(m_cpu[key]))
    worst_mean = 0.0
    for (path, a), (_, b) in zip(sharding.leaves(p_gpu),
                                 sharding.leaves(p_cpu)):
        a, b = a.cpu().numpy(), b.numpy()
        d = np.abs(a - b)
        worst_mean = max(worst_mean, float(d.mean()
                                           / max(np.abs(b).mean(), 1e-30)))
        if not (d.mean() <= t * np.abs(b).mean()
                and d.max() <= 2 * rscfg.peak_lr + t * np.abs(b).max()):
            fail(f"{tag} reduced {path}: card vs CPU mean |d| "
                 f"{d.mean()}, max |d| {d.max()}")
    print(f"{tag} reduced {rcfg.name} fp32 (remat {rcfg.remat}), 2 tp-1 "
          f"steps (microbatches 2), card vs CPU: loss/grad_norm max rel "
          f"{worst:.3g} (tol {t}); params mean |d|/mean |p| max "
          f"{worst_mean:.3g} (tol {t})", flush=True)
    if worst > t:
        fail(f"{tag} reduced: card vs CPU metrics differ by {worst}")


#: the one-GPU mamba2 training phase: full-width mamba2-2.7b
M2_ARCH = "mamba2-2.7b"
M2_BATCH, M2_SEQ, M2_MICRO, M2_CHUNK, M2_STEPS = 8, 2048, 2, 512, 3


class NoCheckpoints:
    """The mamba2 phase's checkpoint manager: restores nothing and saves
    nothing (a 2.7B model's checkpoint, ~38 GB, would outlast the steps;
    phase 10 holds the format and the resume)."""

    directory = None

    def should_save(self, step):
        return False

    def save(self, step, tree, *, extra=None):
        return "(not written)"

    def restore_or_none(self, template, device=None, **kw):
        return None


def phase_train_mamba2(smi_line):
    """Full-width mamba2-2.7b trained on one card through the Trainer: 3
    steps, then one more under torch.profiler; every step's SSD launches
    exact (forward 2 x layers x microbatches under remat full, backward
    layers x microbatches, every other kernel 0); then reduced mamba2 in
    fp32, 2 tp-1 steps on the card and on the CPU.  Returns the numbers of
    the kernels line."""
    import math
    import warnings

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.dist import sharding
    from repro_torch.dist.steps import StepConfig
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = get_config(M2_ARCH)
    scfg = StepConfig(microbatches=M2_MICRO, seq_chunk=M2_CHUNK,
                      warmup_steps=1, total_steps=100)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=M2_SEQ + 1, global_batch=M2_BATCH))
    tag = f"[train-mamba2] ({smi_line})"
    want = dict.fromkeys(kernel_counts(), 0)
    want.update(ssd=2 * cfg.n_layers * M2_MICRO,
                ssd_bwd=cfg.n_layers * M2_MICRO)
    steps = []

    alloc = {"num_device_alloc": 0, "num_alloc_retries": 0}

    def on_step(step, m):
        counts = kernel_counts()
        reset_kernel_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        # the caching allocator's cudaMallocs and its retries after freeing
        # its cache (a full pool) during the step
        mem = torch.cuda.memory_stats()
        grew = {k: mem.get(k, 0) - v for k, v in alloc.items()}
        alloc.update({k: mem.get(k, 0) for k in alloc})
        steps.append(dict(m, peak_gib=peak, counts=counts))
        print(f"{tag} step {step - 1}: {m['step_time_s']:.3f} s, "
              f"{m['tokens'] / m['step_time_s']:.1f} tokens/s, loss "
              f"{m['loss']:.6f}, grad_norm {m['grad_norm']:.6f}, lr "
              f"{m['lr']:.3g}; peak memory {peak:.2f} GiB; launches ssd "
              f"{counts['ssd']}, ssd_bwd {counts['ssd_bwd']}; allocator "
              f"cudaMallocs {grew['num_device_alloc']}, retries "
              f"{grew['num_alloc_retries']}", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    # as phase 10: deterministic kernels, without the fill of empty memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            reset_kernel_counts()
            torch.cuda.reset_peak_memory_stats()
            mem = torch.cuda.memory_stats()
            alloc.update({k: mem.get(k, 0) for k in alloc})
            t0 = time.perf_counter()
            run = Trainer(cfg, scfg, TrainerConfig(
                total_steps=M2_STEPS, log_interval=1000,
                ckpt_dir=str(ROOT / "build" / "smoke_mamba2_ckpt")), data,
                device="cuda", log_fn=lambda line: print(f"{tag} {line}",
                                                         flush=True))
            run.ckpt = NoCheckpoints()
            params, opt, _ = run.train(on_step=on_step)
            n_params = sum(t.numel() for _, t in sharding.leaves(params))
            print(f"{tag} {cfg.name} full width ({cfg.n_layers} of "
                  f"{get_config(TRAIN_ARCH).n_layers} layers, "
                  f"{n_params / 1e6:.1f}M parameters in {cfg.param_dtype}, "
                  f"fp32 AdamW masters and moments, remat {cfg.remat}), "
                  f"batches of {M2_BATCH} x {M2_SEQ} tokens in {M2_MICRO} "
                  f"microbatches, seq_chunk {M2_CHUNK}: {M2_STEPS} steps in "
                  f"{time.perf_counter() - t0:.1f} s with init", flush=True)
            reset_kernel_counts()
            batch = data.global_batch(M2_STEPS)
            top, idle, wall_ms, events = profile_call(
                lambda: run.step_fn(params, opt, batch, M2_STEPS))
            prof_counts = kernel_counts()
            reset_kernel_counts()
        notes = sorted({str(w.message).split(".")[0] for w in caught})
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill
    for line in notes:
        print(f"{tag} warning under deterministic algorithms: "
              f"{line[:160]}", flush=True)
    loss0 = steps[0]["loss"]
    print(f"{tag} step-0 loss {loss0:.6f} vs ln {cfg.vocab_size} = "
          f"{math.log(cfg.vocab_size):.6f} (tol 0.5)", flush=True)
    if not (math.isfinite(loss0)
            and abs(loss0 - math.log(cfg.vocab_size)) <= 0.5):
        fail(f"train-mamba2: step-0 loss {loss0} not within 0.5 of "
             f"ln {cfg.vocab_size}")
    for k, st in enumerate(steps):
        if not (math.isfinite(st["loss"]) and math.isfinite(
                st["grad_norm"])):
            fail(f"train-mamba2: step {k} not finite: {st}")
        if st["counts"] != want:
            fail(f"train-mamba2: step {k} launches {st['counts']}, "
                 f"expected {want}")
    if prof_counts != want:
        fail(f"train-mamba2: profiled step launches {prof_counts}, "
             f"expected {want}")
    bwd_kernels = ssd_ops.SSD_BWD_KERNELS
    if top and events != {"flash": 0, "ssd": 3 * want["ssd"],
                          "ssd_bwd": bwd_kernels * want["ssd_bwd"]}:
        fail(f"train-mamba2: profiled step's device events {events}, "
             f"expected ssd {3 * want['ssd']} and ssd_bwd "
             f"{bwd_kernels * want['ssd_bwd']} (3 and {bwd_kernels} CUDA "
             f"kernels a launch)")
    print(f"{tag} every step's launches {want} (SSD forward 2 x "
          f"{cfg.n_layers} layers x {M2_MICRO} microbatches: the forward "
          f"and the remat recompute; backward {cfg.n_layers} x {M2_MICRO})",
          flush=True)
    print(f"{tag} profiled step {M2_STEPS}: {wall_ms:.1f} ms wall, device "
          f"idle share {'not measured' if idle is None else f'{idle:.4f}'}"
          f"; port device events {events}", flush=True)
    for name, ms, n in top:
        print(f"{tag}   {ms:9.3f} ms  x{n:<5} {name[:100]}", flush=True)
    if not top:
        print(f"{tag} torch.profiler saw no device time: top ops and idle "
              f"share not measured", flush=True)
    times = [st["step_time_s"] for st in steps]
    toks = [st["tokens"] / st["step_time_s"] for st in steps]
    peak = max(st["peak_gib"] for st in steps)
    print(f"{tag} steps {min(times):.3f}–{max(times):.3f} s, "
          f"{min(toks):.1f}–{max(toks):.1f} tokens/s, peak {peak:.2f} GiB, "
          f"idle {'not measured' if idle is None else f'{idle:.4f}'}",
          flush=True)
    out = dict(bwd_launches=steps[0]["counts"]["ssd_bwd"],
               train_launches=steps[0]["counts"]["ssd"],
               step_s=[st["step_time_s"] for st in steps],
               peak_gib=max(st["peak_gib"] for st in steps), idle=idle)
    del params, opt, run
    torch.cuda.empty_cache()
    tp1_card_vs_cpu(cfg, "[train-mamba2]")
    return out


def phase_train_mamba2_alone():
    """``phase_train_mamba2`` in a process of its own, which this one
    waits for.  After a profile of tens of thousands of device events
    (phase 10's step) torch.profiler loses some events of every later
    profile in that process: 3 of the mamba2 step's 768 SSD events, in
    each of three profiles; a fresh process recorded all.  The phase holds
    its profiled step's events to its launches exactly, so it runs where
    no profile came before it.  Returns the phase's numbers."""
    import torch

    torch.cuda.empty_cache()
    out_path = ROOT / "build" / "smoke_train_mamba2.json"
    out_path.unlink(missing_ok=True)
    sys.stdout.flush()
    sys.stderr.flush()
    try:
        rc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                             "--train-mamba2", str(out_path)],
                            cwd=ROOT, timeout=900).returncode
    except subprocess.TimeoutExpired:
        fail("train-mamba2: its process outlasted 900 s")
    if rc != 0:
        fail(f"train-mamba2: its process exited with code {rc}")
    return json.loads(out_path.read_text())


def train_mamba2_process(out_path) -> int:
    """The process ``phase_train_mamba2_alone`` starts: the kernels (built
    already, so loaded), the phase, and its numbers written to
    ``out_path``."""
    phase_build()
    out = phase_train_mamba2(card_name_and_limit())
    Path(out_path).write_text(json.dumps(out))
    return 0


#: phase 14: every family the port serves, trained at full width on the
#: card: (depth trained or None for the published depth, rows, text
#: tokens a row); 2 microbatches, seq_chunk 512, 3 steps from seed 0.
#: zamba2 and minicpm3 at half the depths that fit the card (24, 32), for
#: the smoke's time limit
FAMILY_RUNS = {
    "zamba2-7b": (12, 4, 2048),
    "llama4-scout-17b-a16e": (1, 4, 2048),
    "minicpm3-4b": (16, 4, 2048),
    "internvl2-2b": (None, 4, 1792),       # after 256 patch rows a row
    "whisper-tiny": (None, 8, 448),         # over 1500 frames a row
}
FAMILY_MICRO, FAMILY_CHUNK, FAMILY_STEPS = 2, 512, 3
#: the remat policies' product count takes one row of this many tokens
COUNT_SEQ = 512
#: GEMM kernels by name in a device profile (cuBLAS, cuBLASLt)
GEMM_EVENT = re.compile(r"gemm|nvjet|xmma|cutlass", re.I)
#: products with no batch dimension (kept by remat "dots") and batched
PRODUCT_KINDS = ("unbatched", "batched")


def count_products(fn):
    """``fn()`` under a dispatch mode that counts the products that run:
    with no batch dimension (``models.model._is_saved_product``) and
    batched ``bmm``s.  Entered outside the checkpoints, it sits below
    selective checkpointing's own modes: a product that ``"dots"`` serves
    from its cache in the recompute never reaches it."""
    import collections

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models.model import _is_saved_product

    seen = collections.Counter()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if _is_saved_product(func, args):
                seen["unbatched"] += 1
            elif func is torch.ops.aten.bmm.default:
                seen["batched"] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    torch.cuda.synchronize()
    return {k: seen[k] for k in PRODUCT_KINDS}


def weight_copies(fn, weights):
    """The ops of one call of ``fn`` (forward, backward and the AdamW
    update) that read one of ``weights`` and write a tensor of at least
    its size outside it, products excepted: a copy or a cast of a whole
    weight.  [(op, shape, dtype)]."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    aten = torch.ops.aten
    products = {aten.mm.default, aten.addmm.default, aten.bmm.default,
                aten.baddbmm.default}
    stores = {w.untyped_storage().data_ptr() for w in weights}
    numel = min(w.numel() for w in weights)
    hits = []

    def tensors(tree):
        return [t for t in tree_flatten(tree)[0]
                if isinstance(t, torch.Tensor)]

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func not in products and any(
                    t.untyped_storage().data_ptr() in stores
                    for t in tensors((args, kwargs))):
                hits.extend((str(func), tuple(t.shape), str(t.dtype))
                            for t in tensors(out) if t.numel() >= numel
                            and t.untyped_storage().data_ptr() not in stores)
            return out

    with Watch():
        fn()
    torch.cuda.synchronize()
    return hits


def phase_train_family(name, smi_line):
    """``name`` at full width (its depth cut by ``FAMILY_RUNS``) trained
    on the card: 3 tp-1 steps from seed 0 in bf16, the optimizer state by
    the reference's step_config rule (``launch.train.optimizer_state``),
    the text families through the Trainer, the frontend ones through
    ``build_train_step`` with embeddings from a seed; every step's kernel
    launches exact; one profiled step.  zamba2 (``remat="dots"``) also
    counts the products each remat policy runs and takes a step under
    ``"full"`` for its peak; llama4-scout checks that no op copies or
    casts an expert weight.  Returns the numbers PERF.md keeps."""
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.dist import sharding
    from repro_torch.dist.group import Group
    from repro_torch.dist.steps import StepConfig, build_init, build_train_step
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch.train import optimizer_state
    from repro_torch.models.model import count_params_analytic
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    layers, rows, seq = FAMILY_RUNS[name]
    published = get_config(name)
    cfg = (dataclasses.replace(published, n_layers=layers) if layers
           else published)
    opt_kw = optimizer_state(published)
    scfg = StepConfig(microbatches=FAMILY_MICRO, seq_chunk=FAMILY_CHUNK,
                      warmup_steps=1, total_steps=100, **opt_kw)
    tag = f"[train-family] {name} ({smi_line})"
    card = Group(rank=0, size=1, device=torch.device("cuda"))
    want = dict.fromkeys(kernel_counts(), 0)
    if cfg.family in ("ssm", "hybrid"):
        # the forward and the recompute ("dots" and "full" both rerun the
        # scan) of every Mamba-2 layer a microbatch; one backward each
        want.update(ssd=2 * cfg.n_layers * FAMILY_MICRO,
                    ssd_bwd=cfg.n_layers * FAMILY_MICRO)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def frontend_batch(k):
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=seq + 1, global_batch=rows))
        batch = {key: v.cuda() for key, v in data.global_batch(k).items()}
        batch["frontend_embeds"] = torch.randn(
            (rows, cfg.frontend_tokens, cfg.frontend_dim),
            generator=gen, device="cuda")
        return batch

    steps = []

    def on_step(step, m):
        counts = kernel_counts()
        reset_kernel_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        steps.append(dict(m, peak_gib=peak, counts=counts))
        print(f"{tag} step {step - 1}: {m['step_time_s']:.3f} s, "
              f"{m['tokens'] / m['step_time_s']:.1f} tokens/s, loss "
              f"{m['loss']:.6f} (moe_aux {m['moe_aux']:.6f}), grad_norm "
              f"{m['grad_norm']:.6f}; peak memory {peak:.2f} GiB; "
              f"launches {counts}", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    reset_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if cfg.frontend:
        params, opt = build_init(cfg, card, scfg)(0)
        step_fn = build_train_step(cfg, card, scfg)
        for k in range(FAMILY_STEPS):
            batch = frontend_batch(k)
            torch.cuda.synchronize()
            ts = time.perf_counter()
            params, opt, m = step_fn(params, opt, batch, k)
            torch.cuda.synchronize()
            m = {key: float(v) for key, v in m.items()}
            on_step(k + 1, dict(m, step_time_s=time.perf_counter() - ts))
        next_batch = frontend_batch(FAMILY_STEPS)
    else:
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=seq + 1, global_batch=rows))
        run = Trainer(cfg, scfg, TrainerConfig(
            total_steps=FAMILY_STEPS, log_interval=1000,
            ckpt_dir=str(ROOT / "build" / "smoke_family_ckpt")), data,
            device="cuda", log_fn=lambda line: print(f"{tag} {line}",
                                                     flush=True))
        run.ckpt = NoCheckpoints()
        params, opt, _ = run.train(on_step=on_step)
        step_fn = run.step_fn
        next_batch = data.global_batch(FAMILY_STEPS)
    wall = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in sharding.leaves(params))
    n_want = count_params_analytic(cfg)
    moments = str(opt["mu"][0].dtype).replace("torch.", "")
    master = "master" in opt
    cut = (f"{layers} of {published.n_layers} layers" if layers
           else f"all {published.n_layers} layers")
    extra = (f" + {cfg.frontend_tokens} x {cfg.frontend_dim} embeddings"
             if cfg.frontend else "")
    print(f"{tag} full width, {cut} ({n_params} parameters in "
          f"{cfg.param_dtype}; count_params_analytic {n_want}), AdamW "
          f"moments {moments}, fp32 master {master}, remat {cfg.remat}: "
          f"{rows} x {seq} tokens{extra} a step in {FAMILY_MICRO} "
          f"microbatches, {FAMILY_STEPS} steps in {wall:.1f} s with init",
          flush=True)
    if n_params != n_want:
        fail(f"train-family {name}: {n_params} parameters, "
             f"count_params_analytic {n_want}")
    if moments != opt_kw["moment_dtype"] or master != opt_kw["master_fp32"]:
        fail(f"train-family {name}: optimizer state {moments}, master "
             f"{master}; the rule gives {opt_kw}")
    for k, st in enumerate(steps):
        if not (math.isfinite(st["loss"]) and math.isfinite(
                st["grad_norm"])):
            fail(f"train-family {name}: step {k} not finite: {st}")
        if st["counts"] != want:
            fail(f"train-family {name}: step {k} launches {st['counts']}, "
                 f"expected {want}")
        if cfg.family == "moe" and not st["moe_aux"] > 0:
            fail(f"train-family {name}: step {k} moe_aux {st['moe_aux']}")
    print(f"{tag} step-0 loss {steps[0]['loss']:.6f} vs ln "
          f"{cfg.vocab_size} = {math.log(cfg.vocab_size):.6f} (printed, "
          f"not held); every step's launches {want}", flush=True)

    out = dict(name=name, layers=cfg.n_layers, params=n_params,
               moments=moments, master=master, remat=cfg.remat,
               tokens=steps[0]["tokens"],
               step_s=[st["step_time_s"] for st in steps],
               tokens_s=[st["tokens"] / st["step_time_s"] for st in steps],
               peak_gib=max(st["peak_gib"] for st in steps),
               loss=[st["loss"] for st in steps],
               moe_aux=[st["moe_aux"] for st in steps],
               launches=steps[0]["counts"])

    if name == "llama4-scout-17b-a16e":
        experts = [t for path, t in sharding.leaves(params)
                   if path[-2:-1] == ("moe",) and path[-1] in (
                       "w_up", "w_gate", "w_down")]
        hits = weight_copies(lambda: step_fn(params, opt, next_batch,
                                             FAMILY_STEPS), experts)
        reset_kernel_counts()
        print(f"{tag} one step under a dispatch watch: {len(hits)} ops "
              f"copy or cast an expert weight ({experts[0].numel()} "
              f"elements, {experts[0].numel() * 2 / 1e9:.2f} GB each): "
              f"{hits[:4]}", flush=True)
        if hits:
            fail(f"train-family {name}: ops copy or cast an expert "
                 f"weight: {hits[:4]}")
        out["expert_copies"] = len(hits)

    if cfg.remat == "dots":
        counts = {}
        one = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                     seq_len=COUNT_SEQ + 1, global_batch=1))
        cscfg = dataclasses.replace(scfg, microbatches=1)
        for remat in ("full", "none", "dots"):
            fn = build_train_step(dataclasses.replace(cfg, remat=remat),
                                  card, cscfg)
            counts[remat] = count_products(
                lambda: fn(params, opt, one.global_batch(0), FAMILY_STEPS))
        reset_kernel_counts()
        print(f"{tag} products run in one step of 1 x {COUNT_SEQ} tokens "
              f"(unbatched: mm, addmm, bmm of batch 1; batched: bmm): "
              f"{counts}", flush=True)
        c = {r: counts[r]["unbatched"] for r in counts}
        if not (c["dots"] == c["none"] < c["full"]):
            fail(f"train-family {name}: unbatched products dots "
                 f"{c['dots']}, none {c['none']}, full {c['full']}: "
                 f"expected dots == none < full")
        fn = build_train_step(dataclasses.replace(cfg, remat="full"), card,
                              scfg)
        torch.cuda.reset_peak_memory_stats()
        ts = time.perf_counter()
        _, _, m = fn(params, opt, next_batch, FAMILY_STEPS)
        torch.cuda.synchronize()
        full_s = time.perf_counter() - ts
        full_peak = torch.cuda.max_memory_allocated() / 2**30
        reset_kernel_counts()
        print(f"{tag} the same step under remat full: {full_s:.3f} s, peak "
              f"{full_peak:.2f} GiB, against dots' {out['peak_gib']:.2f} "
              f"GiB and {max(out['step_s'][1:]):.3f} s", flush=True)
        out.update(products=counts, full_peak_gib=full_peak,
                   full_step_s=full_s)

    top, idle, wall_ms, events = profile_call(
        lambda: step_fn(params, opt, next_batch, FAMILY_STEPS),
        dict(PORT_EVENTS, gemm=GEMM_EVENT))
    prof_counts = kernel_counts()
    reset_kernel_counts()
    print(f"{tag} profiled step: {wall_ms:.1f} ms wall, device idle share "
          f"{'not measured' if idle is None else f'{idle:.4f}'}; port "
          f"device events {events}; launches {prof_counts}", flush=True)
    if prof_counts != want:
        fail(f"train-family {name}: profiled step launches {prof_counts}, "
             f"expected {want}")
    bwd_kernels = ssd_ops.SSD_BWD_KERNELS
    if top and name == next(iter(FAMILY_RUNS)) and (
            events["ssd"], events["ssd_bwd"]) != (
            3 * want["ssd"], bwd_kernels * want["ssd_bwd"]):
        fail(f"train-family {name}: profiled step's SSD device events "
             f"{events}, expected {3 * want['ssd']} and "
             f"{bwd_kernels * want['ssd_bwd']} (3 and {bwd_kernels} CUDA "
             f"kernels a launch)")
    for ev, ms, n in top:
        print(f"{tag}   {ms:9.3f} ms  x{n:<5} {ev[:100]}", flush=True)
    if not top:
        print(f"{tag} torch.profiler saw no device time: top ops and idle "
              f"share not measured", flush=True)
    times = out["step_s"][1:]
    toks = out["tokens_s"][1:]
    print(f"{tag} steps 2-3: {min(times):.3f}-{max(times):.3f} s, "
          f"{min(toks):.1f}-{max(toks):.1f} tokens/s, peak "
          f"{out['peak_gib']:.2f} GiB", flush=True)
    out.update(idle=idle, profiled_ms=wall_ms, top=top, events=events)
    del params, opt, step_fn
    return out


def phase_train_families():
    """Phase 14 in a process of its own (``--train-families``): the runs
    of ``FAMILY_RUNS`` (zamba2 first, where no profile came before its
    own, so its profiled step's SSD events are held to its launches: a
    profile of a whole step spoils the later ones in its process), then
    the new families' reduced tp-1 steps, card against CPU.  Returns each
    family's numbers by name."""
    import torch

    torch.cuda.empty_cache()
    path = ROOT / "build" / "smoke_train_families.json"
    path.unlink(missing_ok=True)
    sys.stdout.flush()
    sys.stderr.flush()
    try:
        rc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                             "--train-families", str(path)], cwd=ROOT,
                            timeout=900).returncode
    except subprocess.TimeoutExpired:
        fail("train-family: its process outlasted 900 s")
    if rc != 0:
        fail(f"train-family: its process exited with code {rc}")
    return json.loads(path.read_text())


def train_families_process(out_path) -> int:
    """The process ``phase_train_families`` starts: the kernels (built
    already, so loaded), each family's run in ``FAMILY_RUNS``' order, the
    reduced card-vs-CPU steps, the numbers written to ``out_path``."""
    import torch

    from repro_torch.configs import get_config

    phase_build()
    smi = card_name_and_limit()
    out = {}
    for name in FAMILY_RUNS:
        t0 = time.perf_counter()
        out[name] = phase_train_family(name, smi)
        torch.cuda.empty_cache()
        print(f"[smoke] phase 14 {name}: {time.perf_counter() - t0:.1f}s",
              flush=True)
    t0 = time.perf_counter()
    for name in ("llama4-scout-17b-a16e", "grok-1-314b", "minicpm3-4b",
                 "internvl2-2b", "whisper-tiny"):
        tp1_card_vs_cpu(get_config(name), "[train-family]")
    tp1_card_vs_cpu(get_config("zamba2-7b"), "[train-family]", remat="dots")
    print(f"[smoke] phase 14 reduced card vs cpu: "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    Path(out_path).write_text(json.dumps(out))
    return 0


DLA_CASE_SIZES = (256, 512, 1024)
MLP_EDGE = (4096, 2560, 6912)   # h2o-danube-1.8b: tokens x d_model @ d_ff


def dla_tol(din, dout) -> float:
    if dout == "bfloat16":
        return 1e-2
    return 1e-4 if din == "bfloat16" else 1e-5


def dla_bound_ms(m, k, n, din, dout, bias):
    """Least time for one DLA call: its 2·M·K·N operations at the peak of
    the operand type (tensor cores for bf16, the CUDA cores for fp32, no
    TF32), or its bytes (x, w and the bias read once, the output written
    once) at the memory rate, whichever is larger."""
    ein = 2 if din == "bfloat16" else 4
    eout = 2 if dout == "bfloat16" else 4
    flops = 2.0 * m * k * n
    nbytes = (m * k + k * n + (n if bias else 0)) * ein + m * n * eout
    peak = PEAK_BF16_FLOPS if din == "bfloat16" else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def dla_library_call(x, w, b, act):
    """One PyTorch call computing ``act(x @ w + b)``, or None."""
    import torch

    call, name = None, None
    if b is not None and act == "none":
        call, name = (lambda: torch.addmm(b, x, w)), "torch.addmm"
    fn = getattr(torch, "_addmm_activation", None)
    if b is not None and act in ("relu", "gelu") and fn is not None:
        gelu = act == "gelu"
        call = lambda: fn(b, x, w, use_gelu=gelu)
        name = f"torch._addmm_activation(use_gelu={gelu})"
    if call is not None:
        try:
            call()
        except (RuntimeError, TypeError) as e:   # not in this build
            print(f"[dla] {name} unavailable: {e}", flush=True)
            return None, None
    return call, name


def phase_dla():
    """The DLA matmul kernel: its entry point driven as the DLA
    instruction, then every case against the plain version; returns the
    ``kernels`` entry's numbers."""
    import torch

    from repro_torch.kernels.matmul import MATMUL, matmul, matmul_plain

    for line in MATMUL.ptxas_report().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[ptxas] {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype="float32"):
        return torch.randn(shape, generator=gen, device=dev).to(
            getattr(torch, dtype))

    # the path: the DLA instruction as a user calls it
    path_inputs = [(randn(s, s), randn(s, s), randn(s), "gelu", None)
                   for s in DLA_CASE_SIZES]
    m, k, n = MLP_EDGE
    path_inputs.append((randn(m, k, dtype="bfloat16"),
                        randn(k, n, dtype="bfloat16"), None, "silu", None))
    torch.cuda.synchronize()
    MATMUL.launches = 0
    for x, w, b, act, od in path_inputs:
        matmul(x, w, b, activation=act, out_dtype=od)
    torch.cuda.synchronize()
    path_launches = MATMUL.launches
    print(f"[dla] the DLA instruction at {list(DLA_CASE_SIZES)} fp32 gelu + "
          f"bias and the MLP edge {m}x{k} @ {k}x{n} bf16 silu: "
          f"{path_launches} kernel launches", flush=True)
    if path_launches != len(path_inputs):
        fail(f"dla: {path_launches} launches for {len(path_inputs)} calls")
    del path_inputs

    # (label, batch, M, K, N, dtype in, dtype out, activation, bias)
    cases = [(f"ref {mm}x{kk}x{nn}", (), mm, kk, nn, "float32", "float32",
              "none", False)
             for mm, kk, nn in [(128, 128, 128), (100, 200, 150),
                                (256, 64, 512), (1, 7, 3), (384, 128, 128)]]
    cases += [("ref acts 64x96x80", (), 64, 96, 80, "float32", "float32",
               act, True) for act in ("none", "relu", "relu2", "silu",
                                      "gelu")]
    cases += [("ref dtypes 64x64x64", (), 64, 64, 64, d, "float32", "none",
               False) for d in ("float32", "bfloat16")]
    cases += [(f"case study {s}", (), s, s, s, "float32", "float32", act,
               True) for s in DLA_CASE_SIZES
              for act in ("none", "relu", "relu2", "silu", "gelu")]
    cases += [("ragged", (), 77, 130, 45, d, od, "relu2", True)
              for d, od in (("float32", "float32"), ("bfloat16", "float32"),
                            ("bfloat16", "bfloat16"))]
    cases += [("batched", (3,), 40, 64, 32, "float32", "float32", "silu",
               True),
              ("MLP edge", (), m, k, n, "bfloat16", "bfloat16", "silu",
               False)]
    timed = {("case study 1024", a) for a in ("none", "relu", "gelu")}
    timed.add(("MLP edge", "silu"))
    out = {}
    for label, batch, mm, kk, nn, din, dout, act, bias in cases:
        x = randn(*batch, mm, kk, dtype=din)
        w = randn(kk, nn, dtype=din)
        b = randn(nn, dtype=din) if bias else None
        od = getattr(torch, dout)
        got = matmul(x, w, b, activation=act, out_dtype=od)
        torch.cuda.synchronize()
        want = matmul_plain(x, w, b, activation=act, out_dtype=od)
        if not torch.isfinite(got).all():
            fail(f"dla {label} {act}: non-finite output")
        err_abs = (got.float() - want.float()).abs().max().item()
        err = err_abs / want.float().abs().max().item()
        tol = dla_tol(din, dout)
        line = (f"[dla] {label} {act}{' + bias' if bias else ''} {din} -> "
                f"{dout}: max_err/max {err:.3g} (tol {tol})")
        if (label, act) in timed:
            rows = mm * (batch[0] if batch else 1)
            ms = time_ms(lambda: matmul(x, w, b, activation=act,
                                        out_dtype=od))
            plain_ms = time_ms(lambda: matmul_plain(
                x, w, b, activation=act, out_dtype=od))
            bound_ms, bound_by = dla_bound_ms(rows, kk, nn, din, dout, bias)
            lib_fn, lib_name = dla_library_call(x, w, b, act)
            lib_ms = time_ms(lib_fn) if lib_fn is not None else None
            dev_ms = queued_ms(lambda: matmul(x, w, b, activation=act,
                                              out_dtype=od))
            lib_dev_ms = queued_ms(lib_fn) if lib_fn is not None else None
            line += (f", kernel {ms:.4f} ms ({2.0 * rows * kk * nn / ms / 1e9:.1f}"
                     f" TFLOP/s), plain {plain_ms:.4f} ms, "
                     + (f"{lib_name} {lib_ms:.4f} ms" if lib_fn is not None
                        else "no single PyTorch call")
                     + f", bound {bound_ms:.5f} ms ({bound_by}); on the "
                     f"device (queued CUDA events) kernel {fmt_ms(dev_ms)}, "
                     f"library {fmt_ms(lib_dev_ms)}")
            out[(label, act)] = dict(max_abs_err=err_abs, ms=ms,
                                     plain_ms=plain_ms, bound_ms=bound_ms,
                                     bound_by=bound_by, library_ms=lib_ms,
                                     library_call=lib_name,
                                     device_ms=dev_ms,
                                     library_device_ms=lib_dev_ms)
            if label == "MLP edge":
                # a floor, not the same function: torch.mm in bf16 computes
                # the product alone (no bias, no silu)
                floor = lambda: torch.mm(x, w)
                out["floor"] = dict(ms=time_ms(floor),
                                    device_ms=queued_ms(floor))
                line += (f"; torch.mm(x, w) in bf16, a floor that computes "
                         f"less (no bias, no silu): "
                         f"{out['floor']['ms']:.4f} ms, on the device "
                         f"{fmt_ms(out['floor']['device_ms'])}")
        print(line, flush=True)
        if not err <= tol:
            fail(f"dla {label} {act} {din} -> {dout}: err {err} > {tol}")
        del x, w, b, got, want
    main_entry = dict(out[("MLP edge", "silu")])
    main_entry["shape"] = (f"{m}x{k} @ {k}x{n} bf16 -> bf16, silu "
                           f"(h2o-danube-1.8b w_up)")
    main_entry["bf16_mm_floor_ms"] = out["floor"]["ms"]
    main_entry["bf16_mm_floor_device_ms"] = out["floor"]["device_ms"]
    for act in ("none", "relu", "gelu"):
        e = out[("case study 1024", act)]
        for key in ("ms", "plain_ms", "bound_ms", "library_ms", "device_ms",
                    "library_device_ms"):
            main_entry[f"fp32_1024_{act}_{key}"] = e[key]
    return path_launches, main_entry


SWEEP_WORDS = [1 << i for i in range(20)] + [1 << 24]   # 4 B .. 2 MB, 64 MB
SWEEP_HEAP_WORDS = 1 << 24                              # 64 MiB of fp32


def phase_pgas(quick):
    """The quickstart on peer-mapped and wire groups (run on phase 8's
    fresh four-rank pools: ``quick``, each tag's results and the peer
    pool's heap churn) and on a CPU group, then the PUT/GET sweep over
    peer memory and over the wire; returns the 2-rank peer pool for the
    case study."""
    import numpy as np

    from repro_torch.dist import rank_tasks
    from repro_torch.dist.group import RankPool

    runs = {tag: quick[tag][0] for tag in ("peer", "wire")}
    churn = quick["peer"][1]
    t0 = time.perf_counter()
    with RankPool(4, device="cpu") as pool:
        runs["cpu"] = pool.run(rank_tasks.quickstart)
    cpu_s = time.perf_counter() - t0
    for tag in ("peer", "wire", "cpu"):
        print(f"[pgas] quickstart, 4 ranks, {tag}: ART max |err| "
              f"{max(r['art_err'] for r in runs[tag]):.3g} (tol 2e-4), "
              f"{sum(r['peer_bytes'] for r in runs[tag])} bytes through peer "
              f"memory, "
              + (f"pool {cpu_s:.1f}s" if tag == "cpu" else
                 "on phase 8's fresh four-rank pool"), flush=True)
        if not all(r["art_err"] < 2e-4 for r in runs[tag]):
            fail(f"pgas quickstart {tag}: ART error")
    if not (all(r["peer"] for r in runs["peer"])
            and sum(r["peer_bytes"] for r in runs["peer"]) > 0):
        fail("pgas quickstart: the peer run did not store through peer "
             "memory")
    for tag in ("peer", "wire"):
        for rank, (a, b) in enumerate(zip(runs[tag], runs["cpu"])):
            if not (np.array_equal(a["heap"], b["heap"]) and np.array_equal(
                    a["heap_after_put"], b["heap_after_put"])):
                fail(f"pgas quickstart: {tag} heap of rank {rank} differs "
                     f"from the CPU run's")
    if not np.all(runs["peer"][2]["heap"][16:32] == 20.0):
        fail("pgas quickstart: SCALE result on rank 2")
    if any(r != {"partitions": [1] * 4, "read_back": True} for r in churn):
        fail(f"pgas: four heaps one after another on a peer pool: {churn} "
             f"(each dropped heap's partition must be freed by the next "
             f"mapping)")
    print("[pgas] four 4 MiB heaps one after another on the peer pool: "
          "one partition held at each mapping, every ring PUT read back",
          flush=True)
    print("[pgas] quickstart heaps bit-identical: peer-mapped == card wire "
          "== CPU", flush=True)

    sweeps = {}
    pools = {}
    for tag, peer in (("peer", True), ("wire", False)):
        pools[tag] = RankPool(2, device="cuda", peer_memory=peer)
        sweeps[tag] = pools[tag].run(rank_tasks.put_get_sweep, SWEEP_WORDS,
                                     SWEEP_HEAP_WORDS)[0]
    pools["wire"].close()
    print("[pgas] PUT/GET rank 0 <-> rank 1 of 2, fp32 heap of 2^24 words; "
          "alone = the transfer (peer: one copy, CUDA events on rank 0; "
          "wire: one Group.permute, staging included, host clock); call = "
          "the collective put/get with its barriers (host clock)", flush=True)
    for tag in ("peer", "wire"):
        for r in sweeps[tag]:
            if not r["read_back"]:
                fail(f"pgas sweep {tag} {r['bytes']} B: read-back differs")
            b = r["bytes"]
            print(f"[pgas] {tag:4} {b:>9} B: PUT alone "
                  f"{r['put_alone_s'] * 1e6:10.2f} us "
                  f"{b / r['put_alone_s'] / 1e9:9.4g} GB/s, call "
                  f"{r['put_s'] * 1e6:10.2f} us {b / r['put_s'] / 1e9:9.4g} "
                  f"GB/s | GET alone {r['get_alone_s'] * 1e6:10.2f} us "
                  f"{b / r['get_alone_s'] / 1e9:9.4g} GB/s, call "
                  f"{r['get_s'] * 1e6:10.2f} us {b / r['get_s'] / 1e9:9.4g} "
                  f"GB/s | GET/PUT alone "
                  f"{r['get_alone_s'] / r['put_alone_s']:.3f}, call "
                  f"{r['get_s'] / r['put_s']:.3f}", flush=True)
    Path(ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "pgas_sweep.json").write_text(json.dumps(sweeps))
    return pools["peer"]


CASE_SIZES = (256, 512, 1024, 8192)
CONV_SETS = ((256, 3), (192, 5), (128, 7))


def phase_case_study(pool):
    """The paper's Sec. V on the 2-rank peer group (fp32, TF32 off)."""
    from repro_torch.dist import rank_tasks

    with pool:
        res = pool.run(rank_tasks.case_study, CASE_SIZES, 8, CONV_SETS, 64,
                       (1, 64))
    for rows in zip(*(r["matmul"] for r in res)):
        art = max(r["art_err"] for r in rows)
        bulk = max(r["bulk_err"] for r in rows)
        print(f"[case] matmul {rows[0]['size']} fp32, 2 ranks: ART (8 chunks)"
              f" {rows[0]['art_ms']:.3f} ms, bulk {rows[0]['bulk_ms']:.3f} ms"
              f" (the group's wall time a call); max_err/max ART {art:.3g}, "
              f"bulk {bulk:.3g} (tol 2e-4)", flush=True)
        if not (art <= 2e-4 and bulk <= 2e-4 and all(
                r["art_finite"] and r["bulk_finite"] for r in rows)):
            fail(f"case study matmul {rows[0]['size']}: errors {art}, {bulk}")
    for rows in zip(*(r["conv"] for r in res)):
        err = max(r["err"] for r in rows)
        r0 = rows[0]
        print(f"[case] conv {r0['cout']} kernels {r0['k']}x{r0['k']} on "
              f"64x64, batch {r0['batch']}, 2 ranks: {r0['ms']:.3f} ms; "
              f"max_err/max {err:.3g} (tol 2e-4)", flush=True)
        if not (err <= 2e-4 and all(r["finite"] for r in rows)):
            fail(f"case study conv {r0['cout']}x{r0['k']} batch "
                 f"{r0['batch']}: err {err}")


def timed(label, fn, *args):
    """``fn(*args)``, then the caching allocator's free blocks released
    and the phase's wall time printed."""
    import torch

    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.empty_cache()
    print(f"[smoke] phase {label}: {time.perf_counter() - t0:.1f}s",
          flush=True)
    return out


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch unavailable ({e})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from repro_torch.configs import get_config
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from the "
              f"root of the checkout", file=sys.stderr)
        return 2
    print(f"[device] {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t_start = time.perf_counter()
    timed("build", phase_build)
    flash_main = timed("2 flash", phase_kernels)
    ssd_cases = timed("2 ssd", phase_ssd_kernels)
    ssd_bwd_cases = timed("2b ssd backward", phase_ssd_bwd)
    flash_launches = timed("3 smollm serving", phase_serve)
    internvl2_launches = timed("3b internvl2 serving", phase_serve_runs,
                               "internvl2-2b")
    whisper_launches = timed("3c whisper serving", phase_serve_runs,
                             "whisper-tiny")
    minicpm3_launches = timed("3d minicpm3 serving", phase_serve_runs,
                              "minicpm3-4b")
    llama4_launches = timed("3e llama4-scout serving", phase_serve_moe)
    ssd_launches = timed("4 mamba2 serving", phase_serve_state,
                         "mamba2-2.7b")["ssd"]
    zamba2_launches = timed("4b zamba2 serving", phase_serve_state,
                            "zamba2-7b")
    timed("5 reduced card vs cpu", phase_reduced_vs_cpu)
    cc_main = timed("6 hop kernels", phase_cc_kernels)
    cc_main.update(timed("7 ring kernels", phase_ring_kernels))
    cc_launches, quick = timed("8 tp training", phase_tp_train)
    grid_launches = timed("9 reduced tp, 9b expert parallelism, 9c data "
                          "axis", phase_tp_reduced)
    timed("10 smollm training", phase_train_1gpu, card_name_and_limit())
    m2_train = timed("10b mamba2 training", phase_train_mamba2_alone)
    timed("10b reduced zamba2 tp-1", tp1_card_vs_cpu,
          get_config("zamba2-7b"), "[train-zamba2]")
    families = timed("14 family training", phase_train_families)
    dla_launches, dla_main = timed("11 dla matmul", phase_dla)
    timed("12-13 pgas and case study",
          lambda: phase_case_study(phase_pgas(quick)))
    print(f"[smoke] all phases {time.perf_counter() - t_start:.1f}s",
          flush=True)

    ssd_bulk = ssd_cases[("mamba2 S2048", "bfloat16")]
    ssd_chunk = ssd_cases[("mamba2 chunk128+state", "bfloat16")]
    ssd_f32 = ssd_cases[("mamba2 S2048", "float32")]
    ssd_z = ssd_cases[("zamba2 S512", "bfloat16")]
    bwd = ssd_bwd_cases[(SSD_TRAIN_CASE[0], "bfloat16")]
    bwd_f32 = ssd_bwd_cases[("mamba2 S2048", "float32")]
    kernels = [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/flash_attention/csrc/"
                    "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:93",
             launches=flash_launches,
             zamba2_launches=zamba2_launches["flash"],
             internvl2_launches=internvl2_launches,
             whisper_launches=whisper_launches,
             minicpm3_launches=minicpm3_launches,
             llama4_launches=sum(llama4_launches.values()),
             llama4_chunked_launches=llama4_launches["contiguous"]
             + llama4_launches["paged"],
             llama4_bulk_launches=llama4_launches["bulk"], **flash_main),
        dict(name="ssd", route="cuda",
             source="src/repro_torch/kernels/ssd/csrc/ssd.cu",
             replaces="src/repro/kernels/ssd/kernel.py:96",
             launches=ssd_launches, max_abs_err=ssd_bulk["max_abs_err"],
             ms=ssd_bulk["ms"], plain_ms=ssd_bulk["plain_ms"],
             bound_ms=ssd_bulk["bound_ms"], bound_by=ssd_bulk["bound_by"],
             library_ms=None, device_ms=ssd_bulk["device_ms"],
             cuda_kernels_a_call=ssd_bulk["cuda_kernels_a_call"],
             kernel_device_ms=ssd_bulk["kernel_device_ms"],
             chunk128_ms=ssd_chunk["ms"],
             chunk128_plain_ms=ssd_chunk["plain_ms"],
             chunk128_bound_ms=ssd_chunk["bound_ms"],
             chunk128_device_ms=ssd_chunk["device_ms"],
             chunk128_cuda_kernels_a_call=ssd_chunk["cuda_kernels_a_call"],
             fp32_ms=ssd_f32["ms"], fp32_device_ms=ssd_f32["device_ms"],
             fp32_bound_ms=ssd_f32["bound_ms"],
             zamba2_ms=ssd_z["ms"], zamba2_device_ms=ssd_z["device_ms"],
             zamba2_bound_ms=ssd_z["bound_ms"],
             zamba2_serve_launches=zamba2_launches["ssd"],
             train_launches=m2_train["train_launches"],
             zamba2_train_launches=families["zamba2-7b"]["launches"]["ssd"],
             zamba2_train_bwd_launches=families["zamba2-7b"]["launches"][
                 "ssd_bwd"],
             bwd_source="src/repro_torch/kernels/ssd/csrc/ssd_bwd.cu",
             bwd_replaces="XLA's gradient of src/repro/models/layers.py:640 "
                          "ssd_jnp (no Pallas counterpart)",
             bwd_shape="B4 S2048 H80 P64 N128 bf16",
             bwd_launches=m2_train["bwd_launches"],
             bwd_max_err=bwd["max_abs_err"], bwd_max_rel_err=bwd["max_err"],
             bwd_ms=bwd["ms"], bwd_device_ms=bwd["device_ms"],
             bwd_plain_ms=bwd["plain_ms"], bwd_bound_ms=bwd["bound_ms"],
             bwd_bound_by=bwd["bound_by"],
             bwd_kernel_device_ms=bwd["kernel_device_ms"],
             bwd_fp32_s2048_ms=bwd_f32["ms"],
             bwd_fp32_s2048_device_ms=bwd_f32["device_ms"],
             bwd_fp32_s2048_bound_ms=bwd_f32["bound_ms"],
             bwd_scratch_bytes=bwd["scratch_bytes"]),
    ]
    for entry, line in (("matmul_tile", 65), ("consume_matmul", 84),
                        ("consume_matmul_acc", 106),
                        ("ag_matmul_ring", 170), ("rs_matmul_ring", 223)):
        kernels.append(dict(
            name=f"cc_matmul.{entry}", route="cuda",
            source="src/repro_torch/kernels/cc_matmul/csrc/cc_matmul.cu",
            replaces=f"src/repro/kernels/cc_matmul/kernel.py:{line}",
            launches=cc_launches[entry], **cc_main[entry],
            **({"grid_launches": grid_launches[entry],
                "tp8_launches": cc_launches[f"tp8_{entry}"]}
               if entry.endswith("_ring") else {})))
    kernels.append(dict(
        name="matmul", route="cuda",
        source="src/repro_torch/kernels/matmul/csrc/matmul.cu",
        replaces="src/repro/kernels/matmul/kernel.py:69",
        launches=dla_launches, **dla_main))
    print(json.dumps({"kernels": kernels}))
    print(card_name_and_limit())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--train-mamba2"]:
        sys.exit(train_mamba2_process(sys.argv[2]))
    if sys.argv[1:2] == ["--train-families"]:
        sys.exit(train_families_process(sys.argv[2]))
    sys.exit(main())
