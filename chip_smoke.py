#!/usr/bin/env python3
"""Drive the repro_torch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout (it puts ``src/`` on the path itself).  It
imports nothing of jax or of the JAX package ``repro``.  Phases, each of
which fails the run (non-zero exit, no final ``ok`` line) on any error:

1. device — the card's name and power limit from ``nvidia-smi``;
2. build — the five CUDA sources from ``src/repro_torch/csrc`` (GEMM,
   flash attention and its backward, the SSD and its backward; one
   ``nvcc`` per source, in parallel), with the compiler's
   register/shared-memory report; meanwhile a thread makes every
   ``flex_attention`` compile the yardsticks use (:func:`flex_warm`);
3. kernels — each kernel against its plain PyTorch version on the card at
   ragged shapes, every mask option and the main paths' shapes (fp32 with
   TF32 off: rtol = atol = 1e-3; bf16: 2e-2, as ``tests/test_kernels.py``),
   each case asserting the kernel path it took (GEMM: ``wgmma`` for bf16
   that TMA can describe, ``wmma`` for other bf16, ``simt`` for fp32;
   flash: ``mma`` for bf16, ``simt`` for fp32), and device timings of the
   kernel, its plain version and, where one exists, one PyTorch library
   call computing the same function (a yardstick the port never calls):
   the GEMM and flash attention at deepseek-7b's prefill shapes, the GEMM
   at the SSM paths', flash attention at zamba2-2.7b's (D = 80), the SSD
   intra-chunk pass at mamba2-780m's and zamba2-2.7b's (one path,
   ``mma_3xtf32``: fp32-accurate products on the TF32 tensor cores; its
   bound takes the operations at 495 / 3 TFLOP/s, the fp32 CUDA-core
   bound beside it); then the GEMM in all four operand layouts (forward,
   dgrad ``dy @ w.T``, wgrad ``x.T @ dy``, both transposed) on every path,
   timed in the dgrad and wgrad layouts at one deepseek-7b train layer's
   shapes beside ``torch.matmul`` on the same views; deepseek-7b's train
   lm head (width 102400), its three products and whole backward timed;
   and flash
   attention's backward kernel against autograd through the plain
   version (fp32 and bf16; causal, window, cap, GQA, ragged and fully
   masked rows; D 64, 80, 128, 256 and 196), two launches at deepseek-7b's
   train shape bitwise equal, timed there and at zamba2-2.7b's (D 80)
   beside SDPA's backward; and the SSD backward kernel (``mma_3xtf32``)
   against the plain backward (fp32: ragged, the train step's shapes
   contiguous and strided, large decays; each gradient within 1e-3 of its
   largest magnitude, and finite; two launches at each train shape
   bitwise equal), timed at both SSM train shapes beside its bound and
   the plain backward's; flash attention at the new architectures'
   shapes, timed only (gemma2-9b's windowed, soft-capped [1, 16, 8192,
   256] kv 8 beside a compiled ``flex_attention``, as SDPA takes no
   soft-cap; gemma-7b's D 256 prefill; seamless-m4t-large-v2's bidirectional
   encoder and its cross attention of 128 queries to 1024 frames) and its
   backward on ``mma`` at D 256, gemma-7b's train shape (beside SDPA's
   backward) and gemma2-9b's windowed, soft-capped one (two launches
   bitwise equal); and every GEMM and
   flash shape of the main paths, derived from each architecture's
   config (``PATHS``, ``TRAIN_RUNS``, ``TRAIN_SHAPES_ONLY``): the GEMM on
   ``wgmma`` at each prefill linear (an encoder's and the cross blocks'
   wk and wv over the frames), each train linear's forward, dgrad and
   wgrad and the lm head's three products at their layouts and output
   dtypes, flash on ``mma`` at each prefill's attention and each train
   shape's forward, and its backward on ``mma``, flash outputs with each
   row's ``atol`` scaled by that row's
   RMS in the reference where it is below 1 (an output averaged over
   thousands of keys is ~0.02).  Every soft-capped flash check scales q
   by twice the cap (``cap_scale``), so most scores lie beyond it and the
   cap changes the result; a capped backward, at a model's cap too, is
   held against autograd through the plain version with ``atol`` scaled
   by the gradient's RMS (the backward's own cases take caps of 1, 0.5
   and 30);
4. parity — at full width in fp32, deepseek-7b (2 layers), mamba2-780m
   (2 layers), zamba2-2.7b (6 layers, one ``MMMMMS`` unit), olmoe-1b-7b
   (2 layers), gemma2-9b (an ``L`` and a ``G`` layer, batch 1 x prompt
   4608, past the 4096 window), internvl2-1b (2 layers, its 256 prefix
   positions) and seamless-m4t-large-v2 (2 encoder and 2 decoder layers
   over 1024 frames): prefill and 4 greedy decode steps through the
   kernels (all on their fp32 ``simt`` paths) and again with every kernel
   call replaced by its plain version; last-position logits within
   rtol = atol = 1e-3 and identical tokens; then the train step (fp32,
   remat) of deepseek-7b (2 layers, 2 x 256 tokens), mamba2-780m (2
   layers), zamba2-2.7b (6 layers), olmoe-1b-7b (2 layers, 2 x 256),
   gemma2-9b (2 layers, 1 x 4608), internvl2-1b (2 layers, 2 x 512) and
   seamless-m4t-large-v2 (2 + 2 layers, 2 x 256 tokens over 1024
   frames), the SSM models at 2 x 512 tokens so the recurrence's
   gradient runs:
   the loss, every gradient leaf (relative L2 error <= 1e-4) and the
   parameters after 2 AdamW steps (atol = 2 * sum(lr_t)), kernels against
   plain versions.  For olmoe every MoE call's expert ids and keep mask
   must be identical between the two runs (a differing token is reported
   with its layer and probability margin, and fails the phase unless the
   margin is below ``NEAR_TIE``);
5. main paths — ``repro_torch.launch.serve`` one-shot, bf16, batch 4,
   8 generated tokens (32 until phase 14 needed the time, 16 until phase
   15 did): deepseek-7b (30 layers, prompt 128), mamba2-780m
   (48 layers, prompt 512 = two SSD chunks), zamba2-2.7b (54 layers,
   prompt 512), olmoe-1b-7b (16 layers, prompt 128), gemma2-9b (42
   layers, batch 1 x prompt 8192), gemma-7b (28 layers, prompt 128),
   qwen2-72b (16 of its 80 layers, ``--layers 16``, prompt 128),
   internvl2-1b (24 layers, prompt 512) and seamless-m4t-large-v2 (24 +
   24 layers, prompt 128 over 1024 frames).  Before each path every
   launch count is zeroed; just after it the counts must be exactly the
   path's (GEMM, flash, SSD, flash backward, SSD backward):
   210/30/0/0/0, 96/0/48/0/0, 144/9/45/0/0, 64/16/0/0/0, 294/42,
   196/28, 112/16, 168/24 and 384/72 (one prefill each; decode runs no
   kernel), every GEMM launch on ``wgmma`` and every flash launch on
   ``mma``.  Outputs finite and tokens in range; prefill time
   (median of 3), decode ms/token, peak memory and a profiler breakdown
   of each path; for olmoe also the device time of one layer's expert
   up product at the decode, prefill and train capacities, the port's
   form (bf16 operands, fp32 output) against fp32 upcasts (within 1e-5
   of the largest magnitude) and beside its bound.  Then the train paths at full width, bf16, batch 4 x
   seq 512, the reference's defaults (remat, ``AdamWConfig()``), through
   ``make_train_step`` and ``SyntheticDataset``, 3 steps each:
   deepseek-7b with 4 layers (each step exactly 115 GEMMs: 57 forward
   with remat's recompute, 29 dgrad, 29 wgrad, the lm head's three
   included; 8 flash forwards and 4 flash backwards), mamba2-780m cut
   to 24 layers (195 GEMMs, 48 SSD forwards, 24 SSD backwards) and
   zamba2-2.7b to 24 (259 GEMMs, 8 flash forwards, 4 flash backwards, 40
   SSD forwards, 20 SSD backwards) and olmoe-1b-7b with 4
   layers (33 forward GEMMs, 17 dgrad, 17 wgrad, 8 flash forwards, 4
   backwards; the router and expert products are torch), gemma2-9b with
   4 layers (115 GEMMs, 8 / 4 flash, the backward on ``mma`` at D 256),
   internvl2-1b cut to 12 (339 GEMMs, 24 / 12 flash) and
   seamless-m4t-large-v2 to 24 + 12 (1059 GEMMs, 96 / 48 flash: the
   encoder is recomputed under remat; their published depths until
   phase 15 needed the time); every GEMM on ``wgmma``,
   every flash forward and backward on ``mma``; finite losses and grad norms; 3
   steps on one fixed batch lower its loss; step time, tokens/s, MFU (a
   MoE model counts its active parameters), peak memory, the device time
   of the gradients and of the AdamW update, and a profiler window with
   device time by kernel family;
6. tatp_outputs — deepseek-7b, 4 layers at full width, bf16, batch 4 x
   seq 512: one step under ``remat_policy="tatp_outputs"`` against full
   remat on the same weights and batch: loss and every gradient leaf
   bitwise equal, launches exactly 29/29/29 GEMMs (forward, dgrad,
   wgrad: the recompute runs none) and 4/4 flash, and the gradients'
   device busy time under each; then 2 steps under each with step ms and
   peak GB;
7. restart — ``repro_torch.launch.train`` on the card, reduced
   deepseek-7b: a run failed at step 4 by ``--fail-at-step`` and
   restarted from its checkpoint ends bitwise equal to a straight run;
   the restore lies on the card in the template's dtypes, and a bf16 tree
   round-trips bitwise;
8. plan launch — the plan-driven entry points at full width, bf16, each
   with a temporary plan cache: ``repro_torch.launch.serve --auto-plan``
   for deepseek-7b and gemma-7b (batch 4, prompt 128, 8 tokens, 32
   until phase 16 needed the time; gemma's
   plan prescribes ``megatron``, run at model degree 1) twice, the first
   logging ``[plan] solved fresh`` and the second a cache hit, both with
   tokens identical to the legacy flags' on the same weights and exactly
   their launches (210/30 and 196/28); then ``repro_torch.launch.train
   --arch deepseek-7b --wafers 8 --stage 7 --batch 4 --seq 512 --steps 3
   --ckpt-dir``: the stage's 3 layers, 3 steps' launches, each loss
   bitwise equal to ``make_train_step`` on ``solver.stage_config(cfg,
   3)`` from the same seed, the plan hash and stage in the manifest; and a
   relaunch with ``--failed-dies 3,9 --fail-wafer 1`` that re-solves only
   wafer 1's stage and prints the reference's plan-drift warning.  The
   ``[plan]`` lines give the serve runs' ms/token and the train run's
   step ms, tokens/s, MFU and peak GB;
9. engine — engine-mode serving (``repro_torch.launch.serve --serve
   --auto-plan``, ``serve_engine``) of deepseek-7b at its 30 layers,
   bf16, on ``TorchServeExecutor`` and a wall clock, 4 decode slots, 128
   prompt and 32 new tokens a request, each run with a fresh plan cache
   (``ENGINE_RUNS``).  (a) Fault-free: 8 Poisson requests at 1.25 a
   second (below the ~1.8 a second the slots serve; 100 until phase 14
   needed the time, 40 until phase 15 did, 24 until phase 16 did, 16
   and 12 since, so no TTFT p99 now), every
   request
   finished with its 32 tokens, and exactly 210 GEMM and 30 flash
   launches per prefill group the engine ran (decode runs no kernel), all
   ``wgmma`` / ``mma``.  (b) 8 requests at that rate (20 until phase 15
   needed the time, 12 until phase 16 did) with
   ``--fault-at 2.0``: exactly one replan, whose plan hash equals ``replan_serve``'s offline
   solve for the same fault, and every request finished or rejected with
   a reason.  (c) A labelled stress run: 8 requests at 4 a second, twice
   what the slots serve.  Each run logs TTFT and TPOT p50 (p99 only over
   100 samples or more) and max, tokens/s, makespan, mean occupancy, peak
   GB and the executor's call times; (b) its recovery event.  (c) fp32, TF32
   off, at full width: deepseek-7b (2 layers, prompts of 128 and 96) and
   zamba2-2.7b (6 layers, prompts of 256 and 512) through ``ServeEngine``
   on a virtual clock, each executor call charged 1.0 s, with a die fault
   at 1e-9 s so ``migrate`` runs; kernels against every hook's plain
   version: identical token streams and reports, the SSD on its kernel
   in zamba2's run;
10. cost engine — the wafer cost engine's ``"torch"`` tier on the card
   (float64, ``repro_torch.wafer.simulator``) against its numpy tier:
   ``simulate_batch`` (search-time through the fused Tier B, final
   through stage 1) and ``simulate_decode_batch`` over the temp space for
   deepseek-7b, qwen2-72b and olmoe-1b-7b (its decode candidates with
   ``ep > 1``), on the 4 x 8 wafer and a seeded degraded one, every
   ``SimResult`` field bitwise; ``dlws_solve`` and ``compile_serve_plan``
   under both tiers with the same degrees, evaluations and plan; the
   tier's calls by stage (zeroed before, read after) above 0.  Then
   ``dlws_solve`` cold (a fresh wafer) and warm (its caches warm, the
   result memo dropped) and ``ilp_search`` (50,000 evaluations, the tier
   through ``REPRO_TIERB``) for gpt3-6.7b, llama2-7b and gpt3-76b, numpy
   and torch in turns, evaluations a second, the same answers; and the
   DNN surrogate on ``benchmarks/fig21_costmodel.py``'s protocol, trained
   on the card (500 cases, 80/20, 500 epochs): log_step's corr > 0.97 and
   rel_err below 1.1 x the linear fit's, every target beside the recorded
   CPU run, the training time and a lookup against ``simulate_step``;
11. ring — deepseek-7b through the TATP ring at model degree 4: the GEMM
   at the ring's per-round tiles ([128, 4096] x [4096, 1024], [4096,
   2752], [128, 11008] x [11008, 1024]) and flash at a round's [4, 32,
   32, 128] (causal on the own block, unmasked with its row LSE on an
   earlier one) against their plain versions and timed in this process
   alone; then :func:`run_ranks` starts four ranks of this script
   (``--ring-rank``) sharing the card over gloo, each within RING's
   wall-clock limit (a failure or timeout fails the phase): the
   host-staged ppermute, psum, pmax, pmin and all-gather of CUDA tensors
   bit for bit against the source ranks' values; fp32 at full width, 2
   layers, batch 4, prompt 128, 4 new tokens, mesh (1, 4), against the
   degree-1 fp32 run on the same card and the same weights (the shards
   of one tree): prefill logits and caches within rtol = atol = 1e-3 (the
   parity phase's), identical tokens, and the fp8 and bf16 wires on the
   prefill within RING_WIRE_TOL; then the 30-layer bf16 serve through
   ``launch.serve``'s ``serve`` under ``--auto-plan`` (prompt 128, 2 new
   tokens, the first 3 compared with phase 5's): mesh (1, 4), exactly
   840 GEMM launches (``wgmma``) and 30 /
   60 / 90 / 120 flash launches (``mma``) a rank, the prefill's last
   logits within RING_BF16_TOL of phase 5's degree-1 run of the same
   weights and its first tokens identical (but at a near tie), with
   each rank's prefill ms, ms/token, peak GB and the host-staged
   transport's share, and the token agreement with degree 1 reported;
   then phase 16 in the same ranks;
12. train ring — deepseek-7b trains through the TATP ring: the flash
   backward with an outside delta (``delta_in``) at one round of the
   (1, 4) train ([4, 32, 128, 128] bf16, the ring's global row LSE,
   causal on the own block and unmasked on an earlier one) against its
   plain version with the same delta, timed beside the own-delta mode and
   SDPA's backward, and the dgrad and wgrad per-round GEMM tiles at 512
   rows a rank against their plain versions and ``torch.matmul``, in this
   process alone; the degree-1 fp32 run (2 layers, batch 4 x seq 128,
   one step, TF32 off); then :func:`run_ranks` starts four ranks of
   this script (``--train-rank``) sharing the card over gloo, every step
   within RING_TRAIN's wall-clock limit: the fp32 run on meshes (1, 4)
   and (2, 2) (ZeRO-1 over data) from the shards of the same tree, each
   step's loss within 1e-4 of degree 1's, each rank's grad norm within
   1e-4 of the degree-1 gradient's norm over that rank's shards (the
   reference clips by it; the clip is off in these runs), each leaf's
   final parameters within 1e-4 relative L2 or four times the leaf's
   fp32 floor where larger (the degree-1 run again with every kernel
   replaced by its plain version; the zero-initialised norm scales),
   exact launches on ``simt``; then ``launch.train --mesh 1
   4 --layers 4`` in bf16 (batch 4 x seq 512, remat, one step, 2 until
   phase 15 needed the time; the fp32 runs one step, 3 until phase 14
   needed the time, 2 until phase 16 did): exact
   GEMM launches a rank by layout, flash forwards and backwards (every
   backward with an outside delta), every one on ``wgmma`` / ``mma``, the
   first loss within 1e-2 of phase 5's degree-1 run on the same weights
   and batch, and each rank's step ms, staged share, GB sent and peak GB;
13. the rest of the train ring — the zigzag launch (c x c, [4, 32, 64,
   128] bf16, causal and unmasked) forward and backward (outside delta)
   against their plain versions, timed beside them and SDPA; the flash
   backward at query offsets with an outside delta on every variant
   (``simt`` fp32, ``mma.sync`` at D 64, ``wgmma`` at D 128 and 256)
   against ``attention_bwd_ref`` over WINDOW_SWEEP's shapes, every unseen
   row's dQ and every unseen key's dK and dV exactly 0, and gemma2-9b's
   ring backward launches timed beside their bound, plain version and
   flex_attention's backward; the degree-1 fp32 steps of internvl2-1b and
   seamless-m4t-large-v2 (2 layers, 2 + 2, at full width) and gemma2-9b's
   bf16 loss and gradients (4 layers, 1 x 8192) in this process; then
   four ranks of
   this script (``--ring-more-rank``) sharing the card over gloo: (a)
   ``launch.train --mesh 1 4`` on the reduced deepseek-7b in fp32 with a
   checkpoint every 2 steps, failing at step 4 and restarted: the final
   checkpoint bitwise the straight run's, a restart of the step-4
   checkpoint at ``--mesh 2 2`` within 2e-4 of its losses, and that
   checkpoint restored at (2, 2) and saved again bitwise; (b) deepseek-7b
   at full width, 4 layers, bf16, batch 4 x seq 512, mesh (1, 4): one
   step's loss and every gradient under ``tatp_outputs`` bitwise full
   remat's, with exact launches (forward GEMM tiles 228 under full remat,
   116 under ``tatp_outputs``; no flash forward in its recompute), the
   bytes each rank sent and its peak GB; (c) zigzag: the fp32 loss (2
   layers, batch 4 x seq 128) on ``zigzag_permutation``-ed data within
   1e-5 of the contiguous loss, and one bf16 step of (b)'s model with
   2R + 1 = 9 flash forwards and 9 backwards a layer on every rank; (d)
   one fp32 step of internvl2-1b (its image prefix) and of
   seamless-m4t-large-v2 (its encoder on the ring) at (1, 4), each loss
   within 1e-5 of its degree-1 step; (e) gemma2-9b's sliding-window
   layers trained on the ring at (1, 4), 1 x 8192: (i) fp32 windowed
   ``ring_attention`` and ``zigzag_ring_attention`` on the hook against
   degree 1's ``attention`` under autograd, (ii) ``launch.train --mesh 1
   4 --layers 4`` in bf16, one step, (iii) that step with zigzag on the
   permuted batch: exact launches, the losses and each rank's grad norm
   against degree 1's, and (iii)'s every gradient leaf within
   WINDOW_GRAD_REL_TOL of degree 1's;
14. SSM ring — the Mamba-2 block over the TATP ring (the sequence-sharded
   SSD scan, the conv halo, the head-sharded decode state): the SSD
   forward and backward kernels at a rank's local shape of the (1, 4)
   runs (mamba2-780m's [4, 256, 48, 64] N 128, zamba2-2.7b's [4, 256,
   80, 64] N 64, strided) and mamba2-780m's per-round GEMM tiles at 1024
   rows (in_proj's [1536, 1612] block on ``wmma``, the same from a
   buffer of pitch 1616 on ``wgmma``, out_proj's on ``wgmma``) against
   their plain versions and timed beside them, and every degree-1 run
   the ranks are held to, in this process;
   then four ranks of this script (``--ssm-ring-rank``) sharing the card
   over gloo, every prompt and sequence two 256-token chunks a rank: (a)
   fp32 at full width, batch 2 x prompt 2048, 4 new tokens (8 until phase
   15 needed the time), mesh (1, 4):
   mamba2-780m (2 layers) and zamba2-2.7b (6 layers, one unit) against
   the degree-1 run of the same tree, prefill logits and each rank's
   caches (its heads of the state, the conv tail, zamba2's K/V block)
   within rtol = atol = 1e-3 and identical tokens, exact launches on
   ``simt``; the ``log`` scan within SSM_SCAN_TOL and the bf16 state
   wire within SSM_STATE_WIRE_TOL of the ``seq`` scan's prefill logits;
   (b) mamba2-780m cut to 24 layers (48 until phase 15 needed the time)
   and (c) zamba2-2.7b cut to 12 through
   ``launch.serve``'s ``serve --mesh 1 4`` in bf16 (batch 2 x prompt
   2048, 4 new tokens): exact launches a rank by kernel and path (192
   GEMM tiles and 24 SSD passes; 128 GEMM tiles, 10 SSD passes and 2 (i
   + 1) flash rounds on ``mma`` on rank i; every in_proj tile on
   ``wmma``, 96 and 40, since TMA cannot take its block's pitch of 1612
   or 2612 bf16 columns, the other tiles on ``wgmma``), the prefill's last
   logits within RING_BF16_TOL of the degree-1 bf16 run of the same
   weights and its first tokens identical (but at a near tie), each
   rank's prefill ms, ms/token, peak GB, staged share and GB sent, and
   the state scan's hops' share of the prefill's bytes; (d) fp32 train
   parity of mamba2-780m (2 layers, one step, the clip off) at (1, 4) on
   batch 2 x 2048 and at (2, 2) on 2 x 1024, by phase 12's rules; then
   one bf16 step of mamba2-780m at 4 layers (batch 2 x 2048, (1, 4))
   under full remat, then ``tatp_outputs``: loss and
   every gradient bitwise equal, exact launches by layout, every GEMM on
   ``wgmma`` or ``wmma``, 8 SSD forwards and 4 SSD backwards a rank
   under either policy, the loss (the ranks' shares summed) within 1e-2
   of degree 1's, and each rank's step ms, GB sent and peak GB;
15. the other strategies and the expert all-to-all — the GEMM at
   ``megatron``'s local shapes of deepseek-7b on a rank of (1, 4) (M 512
   and 2048: [M, 4096] x [4096, 1024] / [4096, 2752], [M, 1024] x [1024,
   4096], [M, 2752] x [2752, 4096]) and olmoe-1b-7b's ring tile ([512,
   2048] x [2048, 512]), flash at ``megatron``'s local heads ([4, 8, 128,
   128] and [4, 8, 512, 128] causal, the backward at the latter) and at
   olmoe's ring round with its row LSE ([4, 16, 128, 128]), each against
   its plain version and timed beside it and the library call; (d) each
   path the reference cannot run (``fsdp`` above degree 1, ``megatron``'s
   decode, ``megatron`` with fewer kv heads than ranks, with MoE or with
   Mamba-2 layers) raising ``NotImplementedError`` naming ROADMAP.md C5
   on a (1, 4) Dist with no process group, so before any collective; and
   every degree-1 run the ranks are held to, in this process; then four
   ranks of this script (``--other-rank``) sharing the card over gloo:
   (a) olmoe-1b-7b, fp32, 2 layers at full width, batch 2 x prompt 64, 4
   new tokens, (1, 4), with the capacity factor the number of experts
   and no aux loss (nothing drops): prefill logits and each rank's caches
   within rtol = atol = 1e-3 of the degree-1 run, identical tokens, exact
   launches on ``simt``; at the published capacity 1.25 the kernels
   against the plain hooks on the ring, routing matched call by call
   (but at near ties); then olmoe's bf16 serve at its 16 layers through
   ``launch.serve --mesh 1 4`` (batch 4 x prompt 512, 4 new tokens):
   exactly 256 GEMM tiles (``wgmma``) and 16 (i + 1) flash (``mma``) on
   rank i, 32 expert all-to-alls a prefill and 32 a token, finite
   logits, the same tokens on every rank, with the all-to-alls' bytes
   and seconds; fp32 train parity at (2, 2) (1 layer, nothing dropped,
   batch 2 x seq 64, one step, the clip off) by phase 12's rules; one
   bf16 step of olmoe cut to 4 layers through ``launch.train --mesh 1
   4`` (batch 4 x seq 512, remat), exact launches by layout; (b)
   ``megatron`` on deepseek-7b: fp32 train parity (2 layers, batch 4 x
   seq 128, one step, the clip off) at (1, 4) and (2, 2) by phase 12's
   rules, with degree 1's launches, and every gradient leaf of the step
   within MEG_GRAD_TOL relative L2 of degree 1's; the bf16 prefill
   of its 30 layers (batch 4 x prompt 128) through ``prefill_fn``: 210
   GEMM and 30 flash launches a rank, the last logits within
   RING_BF16_TOL of phase 5's degree-1 run and its first tokens
   identical (but at a near tie), with the staged transport; one bf16
   step of 4 layers (batch 4 x seq 512) under full remat, then
   ``tatp_outputs``: loss and every gradient bitwise
   equal, 115 GEMM launches a rank under each policy, 8 flash forwards
   under full remat and 4 under ``tatp_outputs``, the loss within 1e-2
   of phase 5's degree-1 run; (c) int8 gradient compression on (b)'s fp32
   model under ``megatron`` at (2, 2): 2 steps' losses within 1e-2 of the
   degree-1 run's uncompressed ones, a nonzero residual, ZeRO-1 over
   ``data``;
16. engine on the ring — in phase 11's four ranks, after its serve:
   ``launch.serve --serve --auto-plan --layers 4`` through
   ``serve_engine`` on every rank, rank 0 leading (deepseek-7b at full
   width cut to 4 layers, bf16, the full model's ServePlan: (1, 4), 4
   slots, prompts of 128, 8 new tokens; ``RING_ENGINE``): (a) 3 Poisson
   requests at 0.5 a second (at most 60 % of what the slots serve at
   the measured call times), every request finished with its 8 tokens,
   on every rank exactly one ring prefill's launches per prefill group
   (112 GEMM tiles on ``wgmma``, 4 (i + 1) flash on ``mma`` on rank i)
   and none in a decode, and every call made on every rank; (b) 4
   requests with ``--fault-at 7.0 --fault-frac 0.125``: one replan, to
   the plan ``replan_serve`` solves offline, the mesh kept at (1, 4),
   the survivors grafted in place; (c) the same with ``--fault-frac
   0.25``: one replan to (2, 2), the caches and weights resharded on the
   card; (b, c) the survivors' global cache rows gathered before and
   after the migration bit for bit, every request finished or rejected
   with a reason; (d) fp32 (TF32 off), 2 layers, the engine at (1, 4) on
   the kernels against the plain hooks on a virtual clock (1.0 s a
   call): identical token streams and reports, every prefill's logits
   within rtol = atol = 1e-3.  ``[engine ring]`` lines give TTFT, TPOT,
   tokens/s, makespan, occupancy, each rank's staged seconds, GB and
   calls and the command bytes, the recovery pause and the reshard's
   seconds and bytes, the capacity the call times give and the phase's
   time, each beside the card's name and power limit.  Alone (~4 min
   with the build): ``phase_device``, ``phase_build`` and
   ``phase_ring_engine_alone(torch)`` of ``chip_smoke`` with ``.`` and
   ``src`` on ``sys.path`` and TF32 off.
17. windows on the ring — in this process, before phase 11's ranks
   start: the flash forward kernel at query offsets (``q_offset``) on
   both paths against ``attention_ref`` at the same offset over small
   shapes across the tiles' edges (WINDOW_SWEEP: offsets 0 to 300,
   causal and not, windows), rows that see no key exactly 0 with an LSE
   at or below -1e29; gemma2-9b's distinct ring launches at (1, 4) on 1 x
   8192 tokens as ``_Ring.launches`` makes them (cap 50, window 4096: the
   contiguous rounds' [1, 16, 2048, 256] over 8 kv heads, causal, unmasked
   and at offset 4096, and zigzag's c x c the same at c 1024) checked and
   timed beside their bounds over the visible pairs and a compiled
   ``flex_attention``; the degree-1 runs; then in phase 11's
   ranks after phase 16: (a) fp32 parity of gemma2-9b at full width, 2
   layers (LG), 1 x 8192, 4 new tokens: logits and each rank's caches
   within rtol = atol = 1e-3, identical tokens, exact launches on
   ``simt``; (b) the bf16 serve of 4 layers through ``launch.serve
   --mesh 1 4`` (1 x 8192, 4 new tokens): 112 GEMM tiles on ``wgmma``
   and 4 / 8 / 12 / 14 flash on ``mma`` on ranks 0-3 (the window drops
   rank 3's round on block 0 in each ``L`` layer), the last logits
   within RING_BF16_TOL of degree 1 and the first token identical; (c)
   engine mode through ``launch.serve --serve --auto-plan --layers 4``
   (3 requests of 4608 prompt tokens, past the window, and 4 new ones,
   at WINDOW_ENGINE_RATE), every request finished, exact launches a
   call.  ``[window]`` lines give the rows, the serves' staged bytes and
   times, the slots' capacity and the phase's time.  Alone (~4 min with
   the build): ``phase_device``, ``phase_build`` and
   ``phase_window_alone(torch)`` of ``chip_smoke`` with ``.`` and
   ``src`` on ``sys.path`` and TF32 off.
18. the dry-run on the card's host — two CPU processes started beside the
   build (the card hidden from them) and joined after phase 5: (a)
   ``python -m repro_torch.launch.dryrun --arch deepseek-7b --shape
   train_4k --mesh pod`` exits 0 with an ``ok`` record of 256 devices,
   FLOPs and collective-permute bytes above 0; (b) ``trace_cell`` of
   phase 5's deepseek-7b train step (4 layers, 4 x 512, remat,
   ``AdamWConfig()``, mesh (1, 1)) predicts a peak within
   DRYRUN_PEAK_RATIO of phase 5's measured ``max_memory_allocated`` (the
   trace runs the plain versions, whose transients are larger: it must
   not under-predict); neither builds a kernel.  ``[dryrun]`` lines give
   both peaks, the trace's FLOPs beside phase 5's MFU numerator, and the
   wall clock the join waited.

It then prints one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line,
and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from argparse import Namespace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published peaks of one H100 SXM (dense): bf16 tensor cores, fp32 CUDA
# cores, fp32-accurate products on the TF32 tensor cores (495 TFLOP/s over
# the three products of a 3xTF32 split), HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32x3": 495e12 / 3}
PEAK_BYTES = 3.35e12
# cycles a second of torch.cuda._sleep's spin: the H100's top SM clock, so
# the spin lasts at least as long as asked
SPIN_HZ = 1.98e9

GEMM_TOL = {"float32": (1e-3, 1e-3), "bfloat16": (2e-2, 2e-2)}
ATTN_TOL = GEMM_TOL

SSD_TOL = (1e-3, 1e-3)  # fp32, TF32 off
# the SSD kernel's one path: mma.sync m16n8k8 TF32 with the 3xTF32 split
SSD_PATH = "mma_3xtf32"

# the main paths: one-shot serve at batch 4 (or ``batch``) with 32
# generated tokens, the published depth ``n_layers``, served whole unless
# ``cut`` names the layers served (its reason beside it), and the exact
# kernel launches of each (one prefill; decode runs no kernel)
PATHS = {
    "deepseek-7b": dict(prompt_len=128, n_layers=30, launches=dict(
        tatp_matmul=210, flash_attention=30, ssd=0, flash_attention_bwd=0,
        ssd_bwd=0)),
    "mamba2-780m": dict(prompt_len=512, n_layers=48, launches=dict(
        tatp_matmul=96, flash_attention=0, ssd=48, flash_attention_bwd=0,
        ssd_bwd=0)),
    "zamba2-2.7b": dict(prompt_len=512, n_layers=54, launches=dict(
        tatp_matmul=144, flash_attention=9, ssd=45, flash_attention_bwd=0,
        ssd_bwd=0)),
    # MoE: the four attention linears a layer (the router and the expert
    # products are torch, as the reference's einsums)
    "olmoe-1b-7b": dict(prompt_len=128, n_layers=16, launches=dict(
        tatp_matmul=64, flash_attention=16, ssd=0, flash_attention_bwd=0,
        ssd_bwd=0)),
    # 42 layers alternating L (window 4096) and G; one prompt of 8192, so
    # the window masks keys for the positions from 4096 on
    "gemma2-9b": dict(batch=1, prompt_len=8192, n_layers=42, launches=dict(
        tatp_matmul=294, flash_attention=42, ssd=0, flash_attention_bwd=0,
        ssd_bwd=0)),
    "gemma-7b": dict(prompt_len=128, n_layers=28, launches=dict(
        tatp_matmul=196, flash_attention=28, ssd=0, flash_attention_bwd=0,
        ssd_bwd=0)),
    # served cut to its first 16 of 80 layers (``cut``, widths unchanged):
    # 80 layers of bf16 weights (~145 GB) do not fit one card
    "qwen2-72b": dict(prompt_len=128, n_layers=80, cut=16, launches=dict(
        tatp_matmul=112, flash_attention=16, ssd=0, flash_attention_bwd=0,
        ssd_bwd=0)),
    # the first 256 of the 512 positions take the stub image embeddings
    "internvl2-1b": dict(prompt_len=512, n_layers=24, launches=dict(
        tatp_matmul=168, flash_attention=24, ssd=0, flash_attention_bwd=0,
        ssd_bwd=0)),
    # the encoder's 24 layers over 1024 stub speech frames (6 GEMMs and a
    # bidirectional flash each), then 24 decoder layers (6 GEMMs and a
    # causal flash, and a cross block's 4 GEMMs and flash over the frames)
    "seamless-m4t-large-v2": dict(prompt_len=128, n_layers=24,
                                  launches=dict(
        tatp_matmul=384, flash_attention=72, ssd=0, flash_attention_bwd=0,
        ssd_bwd=0)),
}
BATCH, GEN = 4, 32
# phase 5's serves decode SERVE_GEN tokens (GEN, 32, until phase 14 needed
# the time, 16 until phase 15 did; ms/token is an average either way, and
# phase 11 compares the first 5); phase 8's too since phase 16 needed the
# time (GEN until then: its plans, solved for prompt + SERVE_GEN tokens,
# keep their degrees)
SERVE_GEN = 8
# the kernel path every bf16 main-path launch must take (every width here
# is a multiple of 8, so TMA describes each GEMM operand)
MAIN_PATH_KERNEL = {"tatp_matmul": "wgmma", "flash_attention": "mma",
                    "flash_attention_bwd": "mma"}

# the GEMM's kernels-line records and the operand layout each counts
GEMM_RECORD_LAYOUT = {"tatp_matmul": "fwd", "tatp_matmul_dgrad": "dgrad",
                      "tatp_matmul_wgrad": "wgrad"}

# deepseek-7b's prefill at batch 4 x prompt 128: the GEMM and flash rows
MAIN = dict(batch=BATCH, prompt_len=PATHS["deepseek-7b"]["prompt_len"],
            gen=GEN)
M_MAIN = MAIN["batch"] * MAIN["prompt_len"]
D_MODEL, D_FF, HEADS, HEAD_DIM = 4096, 11008, 32, 128
# (N, K, launches per layer) of the prefill linears: wq wk wv wo / w_up
# w_gate / w_down
LAYER_GEMMS = ((D_MODEL, D_MODEL, 4), (D_MODEL, D_FF, 2), (D_FF, D_MODEL, 1))
# the SSM paths' prefill linears at batch 4 x prompt 512: (arch, N, K,
# launches per prefill): in_proj / out_proj of every Mamba-2 layer, and
# zamba2's shared block (wq wk wv wo, w_up, w_down; gelu is not gated)
M_SSM = BATCH * 512
SSM_GEMMS = (("mamba2-780m", 1536, 6448, 48), ("mamba2-780m", 3072, 1536, 48),
             ("zamba2-2.7b", 2560, 10448, 45), ("zamba2-2.7b", 5120, 2560, 45),
             ("zamba2-2.7b", 2560, 2560, 36), ("zamba2-2.7b", 2560, 10240, 9),
             ("zamba2-2.7b", 10240, 2560, 9))
# flash checks: (name, Hq, Hkv, Sq, Skv, causal, window, cap)
ATTN_CASES = (
    ("causal", 4, 4, 100, 100, True, None, None),
    ("non-causal", 4, 4, 100, 100, False, None, None),
    ("window16", 4, 4, 100, 100, True, 16, None),
    ("cap50", 4, 4, 100, 100, True, None, 50.0),
    ("gqa8/2", 8, 2, 100, 100, True, None, None),
    ("rect100x160", 4, 2, 100, 160, False, 16, 50.0),
)


def cap_scale(cap):
    """The factor on q in a flash check with soft-cap ``cap``.  q and k are
    N(0, 1) and the scores scaled by D^-1/2, so the scores become about
    N(0, (2 cap)^2): 62 % of them lie beyond the cap, where a kernel that
    ignores the cap, or its derivative, disagrees by O(1)."""
    return 1.0 if cap is None else 2.0 * cap


# zamba2-2.7b's shared attention at batch 4 x prompt 512: [B, H, S, D]
ZAMBA_ATTN = (BATCH, 32, 512, 80)
# the SSD intra-chunk pass of one prefill layer at batch 4 x prompt 512:
# (B * nc chunks, Q, H, P, N)
SSD_SHAPES = {"mamba2-780m": (8, 256, 48, 64, 128),
              "zamba2-2.7b": (8, 256, 80, 64, 64)}
# the SSD backward (fp32, TF32 off): each gradient's largest error within
# this share of its largest magnitude.  da sums, over the chunk rows and
# positions, terms that cancel: ~1e-4 of its size at a = -16.
SSD_BWD_TOL = 1e-3
# the backward kernel's one path: mma.sync m16n8k8 TF32 with the 3xTF32
# split, as the forward's
SSD_BWD_PATH = "mma_3xtf32"


# the port's kernels by the names of their __global__ functions, for the
# profiler's device time by family (they live in anonymous namespaces;
# library kernels such as cuBLAS's "..._gemm_f32..." fall under "other")
KERNEL_FAMILIES = {"gemm": ("namespace)::gemm_",),
                   "flash_fwd": ("namespace)::flash_fwd",
                                 "namespace)::flash_mma"),
                   "flash_bwd": ("namespace)::flash_bwd_",),
                   "ssd_fwd": ("namespace)::ssd_chunk_fwd",),
                   "ssd_bwd": ("namespace)::ssd_bwd_",),
                   # other GEMMs (cuBLAS: the MoE router and expert
                   # products, the serve lm head)
                   "library_gemm": ("gemm",)}


class SmokeFailure(RuntimeError):
    pass


# the card's name and power limit as nvidia-smi gives them (phase_device),
# for the lines that give a time
CARD = {"smi": "not read"}


def need(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*parts):
    print(*parts, flush=True)


def adopt_orphans():
    """Make this process the reaper of every process it starts, so a
    grandchild whose parent ends before it (a rank's helper, a compile
    worker) is reparented here and ``stop_children`` still finds it."""
    import ctypes
    pr_set_child_subreaper = 36
    libc = ctypes.CDLL(None, use_errno=True)
    need(libc.prctl(pr_set_child_subreaper, 1, 0, 0, 0) == 0,
         f"prctl(PR_SET_CHILD_SUBREAPER) failed: errno {ctypes.get_errno()}")


def descendants():
    """{pid: command line} of the live processes below this one."""
    import os
    kids = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            stat = Path(f"/proc/{d}/stat").read_text()
        except OSError:  # ended since the listing
            continue
        state, ppid = stat[stat.rindex(")") + 2:].split()[:2]
        if state not in "ZX":
            kids.setdefault(int(ppid), []).append(int(d))
    found, todo = {}, [os.getpid()]
    while todo:
        for pid in kids.get(todo.pop(), []):
            try:
                cmd = Path(f"/proc/{pid}/cmdline").read_bytes()
            except OSError:
                continue
            found[pid] = cmd.replace(b"\0", b" ").decode(errors="replace")
            todo.append(pid)
    return found


def stop_children():
    """Stop every process this one started that still runs, before it
    exits: inductor's compile workers where a compile started them, then
    whatever is left below this process (SIGTERM, SIGKILL after 5 s),
    each named on stderr; then reap the ended ones."""
    import os
    import signal
    pools = sys.modules.get("torch._inductor.async_compile")
    if pools is not None:
        try:
            pools.shutdown_compile_workers()
        except Exception as e:  # the workers are stopped below all the same
            print(f"chip_smoke: inductor's workers did not shut down: {e!r}",
                  file=sys.stderr, flush=True)
    left = descendants()
    for pid, cmd in left.items():
        print(f"chip_smoke: stopping process {pid} left running: {cmd}",
              file=sys.stderr, flush=True)
    for sig, wait_s in ((signal.SIGTERM, 5.0), (signal.SIGKILL, 5.0)):
        for pid in left:
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
        t_end = time.monotonic() + wait_s
        while left and time.monotonic() < t_end:
            time.sleep(0.05)
            left = {p: c for p, c in left.items() if p in descendants()}
    while True:  # reap: ended children and adopted orphans
        try:
            if os.waitpid(-1, os.WNOHANG)[0] == 0:
                break
        except ChildProcessError:
            break
    if left:
        print(f"chip_smoke: processes still running: {sorted(left)}",
              file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def time_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back launches
    (CUDA events).  A device-side spin queued first outlasts the host's
    enqueueing of the launches, so the events time the device alone even
    where the host takes longer to issue a call than the device to run
    it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * SPIN_HZ) + 100_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(name, got, ref, rtol, atol, rms=None):
    """assert_allclose semantics: |got - ref| <= atol + rtol * |ref|.
    ``rms="row"`` scales each row's ``atol`` (a row: the last axis, one
    query's head vector) by that row's RMS in the reference where it is
    below 1: an attention output that averages thousands of keys is far
    below 1, while the first rows of a causal output, over a few keys,
    are not.  ``rms="tensor"`` scales it by the whole reference's RMS
    below 1: a soft-capped score's gradient is far below 1, and some of
    its rows are ~0 (one key takes the whole softmax), where only
    rounding is left to compare."""
    g, r = got.float(), ref.float()
    need(bool(g.isfinite().all()), f"{name}: non-finite kernel output")
    tol = f"atol={atol}" + (f" x min(1, {rms} RMS)" if rms else "")
    if rms:
        sq = r.pow(2)
        atol = atol * (sq.mean(-1, keepdim=True) if rms == "row"
                       else sq.mean()).sqrt().clamp(max=1.0)
    err = (g - r).abs()
    max_err = err.max().item() if err.numel() else 0.0
    over = err - (atol + rtol * r.abs())
    excess = over.max().item() if err.numel() else -1.0
    ok = excess <= 0
    log(f"  check {name}: max_abs_err={max_err:.3e} rtol={rtol} {tol} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        at = tuple(int(i) for i in torch_unravel(over.argmax().item(),
                                                  over.shape))
        log(f"    worst at {list(at)}: kernel {g[at].item():.6g}, plain "
            f"{r[at].item():.6g}, by {excess:.3g} over the tolerance")
    need(ok, f"{name}: kernel disagrees with its plain version")
    return max_err


def torch_unravel(i, shape):
    """The index tuple of flat index ``i`` into ``shape``."""
    out = []
    for n in reversed(shape):
        out.append(i % n)
        i //= n
    return tuple(reversed(out))


def profile_window(torch, fn, top=8):
    """One call of ``fn`` under ``torch.profiler``: host wall time, device
    busy time (the summed durations of the device's kernels and copies,
    which run one at a time on the one stream), the device's idle share,
    host op count and the heaviest kernels, and what the window cost this
    script in all (``cost_s``: the profiler's start, the call and the
    events' processing).  Profiling slows the host, so the wall time here
    is above the unprofiled one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t_cost = time.perf_counter()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    by_name = {}
    for e in dev:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    heaviest = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    groups = {}
    for name, (ms, n) in by_name.items():
        fam = next((f for f, keys in KERNEL_FAMILIES.items()
                    if any(k in name for k in keys)), "other")
        gms, gn = groups.get(fam, (0.0, 0))
        groups[fam] = (gms + ms, gn + n)
    return dict(
        wall_ms=wall,
        device_busy_ms=busy if dev else "not measured",
        idle_share=1 - busy / wall if dev else "not measured",
        device_events=len(dev),
        host_ops=sum(1 for e in events if e.device_type == DeviceType.CPU),
        top=[[name[:80], ms, n] for name, (ms, n) in heaviest],
        by_family={f: [ms, n] for f, (ms, n) in sorted(groups.items())},
        cost_s=time.perf_counter() - t_cost,
    )


def bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / PEAK_BYTES
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem
                                     else "bytes")


_FLEX = {}  # flex_attention compiled once a process for each use
# flex_attention's backward against the plain fp32 gradients, relative
# L2: its bf16 products and its delta from its bf16 output left 0.25-0.28 %
# on gemma2-9b's ring shapes on the H100 (their largest element errors
# several times ATTN_TOL's, so it is not held element by element);
# a mask, offset or window that hid or showed a few percent of the pairs
# would move the gradients by more
FLEX_BWD_REL_L2 = 0.02
# the one shape flex's backward is compiled for: a batch folded into
# 2,048 rows (gemma2-9b's 4 x 512 train shape, its 2,048-row ring rounds,
# two of zigzag's 1,024-row blocks), 16 heads over 8 K/V heads of 256
FLEX_BWD_ROWS = 2048
FLEX_BWD_SHAPE = (16, 8, 256)
# the forward shapes in the order the forward rows first reach them:
# gemma2-9b's 8,192-token prefill, its ring rounds, zigzag's blocks
FLEX_FWD_ROWS = (8192, 2048, 1024)


def flex_fn(torch, kind):
    """``torch.nn.attention.flex_attention`` compiled once a process for
    ``kind``, with the 0-d tensors its mask and score terms read, so a new
    offset, window or cap compiles nothing.  ``"fwd"``, the forward rows:
    compiled as ``torch.compile`` compiles by default (the second shape
    recompiles it for dynamic shapes, which serve every later one), its
    mask on one sequence.  ``"bwd"``, the backward rows: compiled for one
    static shape (FLEX_BWD_ROWS; on the card's host flex's backward
    compiled anew, ~30 s, at each new shape), its mask on a batch folded
    into documents (:func:`flex_fold`), each attending within its own.
    Inductor compiles in this process, without its pool of compile
    workers, whose start took longer on the card's host than the compile
    itself."""
    if kind in _FLEX:
        return _FLEX[kind]
    import torch._inductor.config as inductor_config
    from torch.nn.attention.flex_attention import flex_attention
    inductor_config.compile_threads = 1
    t = {name: torch.zeros((), dtype=dtype, device="cuda")
         for name, dtype in (("off", torch.int32), ("window", torch.int32),
                             ("causal", torch.bool), ("cap", torch.float32),
                             ("sq", torch.int32), ("skv", torch.int32))}
    if kind == "fwd":
        def mask_mod(b, h, qi, ki):
            qpos = qi + t["off"]
            return ((ki <= qpos) | ~t["causal"]) & (qpos - ki < t["window"])
    else:
        def mask_mod(b, h, qi, ki):
            qpos, kpos = qi % t["sq"] + t["off"], ki % t["skv"]
            return ((qi // t["sq"] == ki // t["skv"])
                    & ((kpos <= qpos) | ~t["causal"])
                    & (qpos - kpos < t["window"]))

    def score_mod(s, b, h, qi, ki):
        return torch.tanh(s / t["cap"]) * t["cap"]

    _FLEX[kind] = dict(terms=t, mask_mod=mask_mod, score_mod=score_mod,
                       fn=torch.compile(flex_attention, dynamic=(
                           False if kind == "bwd" else None)))
    return _FLEX[kind]


def flex_fold(x):
    """A [B, H, S, ...] tensor as the [1, H, B S, ...] batch of documents
    flex's backward runs on."""
    return x.transpose(0, 1).reshape(1, x.shape[1], -1, *x.shape[3:])


def flex_call(torch, kind, q, k, v, kw):
    """:func:`flex_fn`'s ``kind`` at the flash arguments ``kw`` (GQA, the
    cap as its ``score_mod``, the causal and window terms at the query
    offset as its block mask, built here, outside any timing; the row LSE
    returned as the kernel returns it) on contiguous copies of q/k/v,
    folded into documents for ``"bwd"`` (:func:`flex_fold`), where they
    are leaves that require grad: ``(call, copies)``."""
    from torch.nn.attention.flex_attention import (AuxRequest,
                                                   create_block_mask)
    f = flex_fn(torch, kind)
    t, cap = f["terms"], kw["cap"]
    t["off"].fill_(kw.get("q_offset", 0))
    t["window"].fill_(kw["window"] or 2 ** 30)
    t["causal"].fill_(bool(kw["causal"]))
    t["cap"].fill_(cap or 1.0)
    t["sq"].fill_(q.shape[2])
    t["skv"].fill_(k.shape[2])
    if kind == "fwd":
        copies = tuple(x.contiguous() for x in (q, k, v))
    else:
        copies = tuple(flex_fold(x.detach()).requires_grad_(True)
                       for x in (q, k, v))
    mask = create_block_mask(f["mask_mod"], None, None, copies[0].shape[2],
                             copies[1].shape[2], device="cuda")
    fkw = dict(score_mod=f["score_mod"] if cap else None, block_mask=mask,
               enable_gqa=k.shape[1] != q.shape[1],
               return_aux=AuxRequest(lse=True))

    def call():
        return f["fn"](*copies, **fkw)

    return call, copies


def flex_warm(torch):
    """Every flex_attention compile the yardsticks will make, on random
    inputs at their shapes and arguments (gemma2-9b's ``L`` slot: causal,
    window 4096, cap 50): the forward at FLEX_FWD_ROWS in order, then the
    backward at its one shape.  Run in a thread while the kernels build,
    so the yardsticks later find them compiled; returns the seconds each
    took."""
    torch.cuda.set_device(0)
    g = torch.Generator(device="cuda").manual_seed(0)
    hq, hkv, d = FLEX_BWD_SHAPE
    kw = dict(causal=True, window=4096, cap=50.0)

    def qkv(s):
        return (torch.randn(1, h, s, d, generator=g, device="cuda",
                            dtype=torch.bfloat16) for h in (hq, hkv, hkv))

    secs = {}
    for s in FLEX_FWD_ROWS:
        t0 = time.perf_counter()
        flex_call(torch, "fwd", *qkv(s), kw)[0]()
        torch.cuda.synchronize()
        secs[f"forward {s}"] = time.perf_counter() - t0
    s = FLEX_BWD_ROWS
    call, leaves = flex_call(torch, "bwd", *qkv(s), kw)
    do = torch.randn(1, hq, s, d, generator=g, device="cuda",
                     dtype=torch.bfloat16)
    t0 = time.perf_counter()
    torch.autograd.grad(call()[0], leaves, flex_fold(do))
    torch.cuda.synchronize()
    secs[f"backward {s}"] = time.perf_counter() - t0
    return secs


def start_flex_warm(torch):
    """:func:`flex_warm` in a thread of this process: ``join()`` returns
    its seconds, or raises what it raised."""
    import threading
    box = {}

    def run():
        try:
            box["secs"] = flex_warm(torch)
        except Exception as e:  # the yardsticks then compile themselves
            box["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()

    def join():
        th.join()
        if "error" in box:
            raise box["error"]
        return box["secs"]

    return join


def flex_yardstick(torch, name, q, k, v, kw, o_ref, live=None):
    """The library yardstick of a soft-capped or offset bf16 flash forward
    at its arguments ``kw``: :func:`flex_call`'s ``"fwd"`` on contiguous
    copies of q/k/v (no autograd: they require no grad), its output held
    against the plain one ``o_ref`` (on the ``live`` rows, the ones that
    see a key, where given) within ATTN_TOL with each row's atol scaled by
    its RMS, then timed: ``(library_ms, library)``."""
    call, _ = flex_call(torch, "fwd", q, k, v, kw)
    t0 = time.perf_counter()
    o, _ = call()
    torch.cuda.synchronize()
    log(f"  library {name}: flex_attention's first call "
        f"{time.perf_counter() - t0:.1f} s")
    if live is not None:
        o, o_ref = o[live], o_ref[live]
    compare(f"{name} flex_attention", o, o_ref, *ATTN_TOL["bfloat16"],
            rms="row")
    return (time_ms(torch, call, 20),
            "flex_attention (compiled; its block mask built beforehand)")


def flex_bwd_yardstick(torch, name, q, k, v, do, kw):
    """The library yardstick of a soft-capped or offset bf16 flash
    backward at its arguments ``kw``: :func:`flex_call`'s ``"bwd"``
    through autograd (its own forward's LSE) on the batch repeated to
    FLEX_BWD_ROWS folded rows, its dq, dk and dv held against the plain
    gradients of the same attention (its own LSE and delta; dq on the
    rows that see a key) within FLEX_BWD_REL_L2 (relative L2); then timed
    as SDPA's backward is, its forward and backward less its forward (each
    under autograd: the compiled graphs free their buffers after one
    backward), over the repeats: ``(library_ms, library)``.  ``q`` is
    unscaled: under a q scaled so the cap bites (:func:`cap_scale`) the
    softmax is nearly one-hot, dS = P (dP - delta) cancels, and flex's
    delta from its bf16 output leaves dQ off by more than its RMS (on the
    H100: 4.4e-3 at an RMS of ~3e-3), which the kernel's fp32 delta and
    two-term products avoid; the time does not depend on the values."""
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_ref)

    rows = q.shape[0] * q.shape[2]
    need(FLEX_BWD_ROWS % rows == 0 and k.shape[2] == q.shape[2]
         and tuple(q.shape[1:2]) + tuple(k.shape[1:2]) + tuple(q.shape[3:])
         == FLEX_BWD_SHAPE,
         f"{name}: {list(q.shape)} folds into no batch of flex's "
         f"backward shape")
    rep = FLEX_BWD_ROWS // rows
    q, k, v, do = (x.repeat(rep, 1, 1, 1) for x in (q, k, v, do))
    o_ref, lse_ref = attention_ref(q, k, v, return_lse=True, **kw)
    ref = attention_bwd_ref(q, k, v, o_ref, lse_ref, do, **kw)
    del o_ref
    call, leaves = flex_call(torch, "bwd", q, k, v, kw)
    live = flex_fold(lse_ref > -1e29)
    ref = tuple(flex_fold(r) for r in ref)
    dout = flex_fold(do)

    def fwd_bwd():
        return torch.autograd.grad(call()[0], leaves, dout)

    t0 = time.perf_counter()
    got = fwd_bwd()
    torch.cuda.synchronize()
    log(f"  library {name}: flex_attention's first forward and backward "
        f"under autograd {time.perf_counter() - t0:.1f} s")
    errs = {}
    for part, g, r in zip(("dq", "dk", "dv"), got, ref):
        if part == "dq":
            g, r = g[live], r[live]
        errs[part] = rel_l2(g, r)
    log(f"  check {name} flex_attention backward: relative L2 "
        f"{json.dumps(errs)} (limit {FLEX_BWD_REL_L2})")
    need(max(errs.values()) <= FLEX_BWD_REL_L2,
         f"{name}: flex_attention's backward disagrees with the plain one")
    ms = (time_ms(torch, fwd_bwd, 20) - time_ms(torch, call, 20)) / rep
    return (ms, "flex_attention's backward (compiled, under autograd, less "
                "its forward; its block mask built beforehand)"
                + (f"; {rep} copies folded into one call, its time over "
                   f"{rep}" if rep > 1 else ""))


def flash_bwd_bytes(b, hq, hkv, sq, skv, d):
    """Bytes the bf16 flash backward must move: q, dO and dQ (Hq heads, Sq
    rows), k, v, dK and dV (Hkv heads, Skv rows) once each, and the fp32
    row lse.  O is not read (the kernels form delta from P and dP), and
    delta passes between the two kernels, so neither counts."""
    return 2 * b * d * (3 * hq * sq + 4 * hkv * skv) + 4 * b * hq * sq


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


# phase 18: the dry-run's cell on the production mesh, and the bounds on
# its trace's peak over phase 5's measured one
DRYRUN_CELL = ("deepseek-7b", "train_4k", "pod")
DRYRUN_PEAK_RATIO = (0.9, 1.5)


def start_dryrun(out_dir):
    """Phase 18's two CPU processes, started beside the build with the card
    hidden from them: (a) the dry-run's CLI on :data:`DRYRUN_CELL`, (b)
    ``chip_smoke.py --dryrun-trace`` (:func:`dryrun_trace_main`).
    ``join()`` waits for both and returns (the cell's record, the trace,
    the seconds it waited)."""
    out_dir = Path(out_dir)
    arch, shape, mesh = DRYRUN_CELL
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--out", str(out_dir)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    trace = subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--dryrun-trace",
         str(out_dir / "trace.json")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def join():
        t0 = time.perf_counter()
        outs = {}
        for what, p in (("dryrun CLI", cli), ("dryrun trace", trace)):
            out, _ = p.communicate(timeout=900)
            outs[what] = out
            need(p.returncode == 0, f"{what} exited {p.returncode}:\n"
                 f"{out[-3000:]}")
        rec = json.loads((out_dir / f"{arch}__{shape}__{mesh}.json")
                         .read_text())
        got = json.loads((out_dir / "trace.json").read_text())
        log(f"[dryrun] CLI: {outs['dryrun CLI'].strip().splitlines()[-1]}")
        return rec, got, time.perf_counter() - t0

    return join


def dryrun_trace_main(out_path) -> int:
    """Phase 18 (b) in a CPU process: ``trace_cell`` of phase 5's
    deepseek-7b train step, written to ``out_path``; no kernel built."""
    from dataclasses import replace

    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import _build
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.train.optimizer import AdamWConfig

    cfg = replace(get_config("deepseek-7b"), n_layers=TRAIN["n_layers"])
    shape = ShapeConfig("train", "train", TRAIN["seq"], TRAIN["batch"])
    got = trace_cell(cfg, shape, (1, 1), opt_cfg=AdamWConfig())
    need(_build._LIBS == {}, "the dry-run's trace built a kernel")
    Path(out_path).write_text(json.dumps(got))
    return 0


def phase_dryrun(join, train_out):
    """Phase 18's checks once phase 5 has run (:func:`start_dryrun`)."""
    rec, got, waited = join()
    cp = rec["collectives"]["collective-permute"]["bytes"]
    need(rec["status"] == "ok" and rec["n_devices"] == 256
         and rec["flops"] > 0 and cp > 0,
         f"dry-run record: {json.dumps(rec)[:2000]}")
    measured = train_out["peak_mem_gb"] * 1e9
    predicted = got["memory"]["peak_bytes"]
    ratio = predicted / measured
    out = dict(
        cell=dict(arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
                  n_devices=rec["n_devices"], rank=rec["rank"],
                  flops=rec["flops"], collective_permute_bytes=cp,
                  total_collective_bytes=rec["collectives"]["total_bytes"],
                  peak_bytes=rec["memory"]["peak_bytes"],
                  trace_s=rec["trace_s"]),
        train_step=dict(
            predicted_peak_bytes=predicted, measured_peak_bytes=measured,
            ratio=ratio, bounds=DRYRUN_PEAK_RATIO,
            argument_bytes=got["memory"]["argument_bytes"],
            trace_flops=got["flops"],
            mfu_numerator_flops=train_out["model_flops_per_step"],
            trace_s=got["trace_s"]),
        join_wait_s=waited, card=CARD["smi"])
    log(f"[dryrun] {json.dumps(out)}")
    lo, hi = DRYRUN_PEAK_RATIO
    need(lo <= ratio <= hi,
         f"the trace's peak {predicted} over phase 5's {measured}: "
         f"{ratio:.3f}, outside {DRYRUN_PEAK_RATIO}")


def phase_device(torch):
    need(torch.cuda.is_available(), "no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    need(bool(smi), "nvidia-smi printed no card")
    name = torch.cuda.get_device_name(0)
    CARD["smi"] = smi[0]
    log(f"[device] {name}; nvidia-smi: {smi[0]}; torch {torch.__version__}"
        f" cuda {torch.version.cuda}; count {torch.cuda.device_count()}")
    return name, smi[0]


def phase_build():
    from repro_torch.kernels import _build
    secs = _build.build_all()
    log(f"[build] {len(_build.SOURCES)} kernels built in {secs:.1f} s "
        f"(nvcc {_build.nvcc_path()}; by source, run together: "
        f"{json.dumps({n: round(t, 1) for n, t in _build.BUILD_SECONDS.items()})})")
    for name, text in _build.BUILD_LOG.items():
        fn = ""  # the kernel the next lines report, its mangled name cut
        for line in text.splitlines():
            if "Function properties for" in line:
                fn = line.rsplit(" ", 1)[-1].split("_cu_")[-1][8:56]
            elif "Used" in line and "registers," in line \
                    or "spill stores" in line:
                log(f"  ptxas {name} {fn}: {line.strip()}")
    for name in _build.SOURCES:
        _build.load(name)
    return secs


def gemm_path(a, b):
    """The path ``tatp_dot(a, b)`` takes (2-D operands, either layout)."""
    from repro_torch.kernels.tatp_matmul import ops
    _, lda = ops._operand(a.shape, a.stride())
    _, ldb = ops._operand(b.shape, b.stride())
    return ops._path(a.dtype, b.shape[0], lda, ldb, a.data_ptr(),
                     b.data_ptr())


def gemm_tile_n(torch, m, k):
    from repro_torch.kernels.tatp_matmul import ops
    return ops._tile_n(m, k, ops._sm_count(torch.cuda.current_device()))


def phase_kernels(torch):
    """Each kernel vs its plain version; timings at the main path's
    shapes.  Returns the per-kernel records for the kernels line."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.tatp_matmul.ops import tatp_dot
    from repro_torch.kernels.tatp_matmul.ref import matmul_ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        x = torch.randn(shape, generator=g, device=dev) * scale
        return x.to(dtype)

    log("[kernels] tatp_matmul vs matmul_ref")
    # ragged fp32 (SIMT path), ragged bf16 rows not 16-byte aligned (wmma
    # with masked scalar loads), ragged bf16 that TMA can describe (wgmma:
    # zero-filled boxes, masked stores), both output dtypes, then the main
    # path's shapes
    cases = [
        ("f32 100x200x300", 100, 200, 300, torch.float32, None, "simt"),
        ("f32->bf16 64x96x80", 64, 96, 80, torch.float32, torch.bfloat16,
         "simt"),
        ("bf16 100x203x301", 100, 203, 301, torch.bfloat16, None, "wmma"),
        ("bf16->f32 100x203x301", 100, 203, 301, torch.bfloat16,
         torch.float32, "wmma"),
        ("bf16->f32 77x256x11008", 77, 256, 11008, torch.bfloat16,
         torch.float32, "wgmma"),
        ("bf16 77x256x11008", 77, 256, 11008, torch.bfloat16, None,
         "wgmma"),
        ("bf16 100x208x304", 100, 208, 304, torch.bfloat16, None, "wgmma"),
        ("bf16 1x8x8", 1, 8, 8, torch.bfloat16, None, "wgmma"),
        ("bf16 300x1000x1000", 300, 1000, 1000, torch.bfloat16, None,
         "wgmma"),
        ("bf16->f32 2048x2560x10448", M_SSM, 2560, 10448, torch.bfloat16,
         torch.float32, "wgmma"),
    ]
    gemm_err = 0.0
    for name, m, n, k, dt, odt, path in cases:
        a = randn(m, n, dtype=dt)
        b = randn(n, k, dtype=dt, scale=n ** -0.5)
        before = dict(tatp_dot.launches_by_path)
        got = tatp_dot(a, b, out_dtype=odt)
        torch.cuda.synchronize()
        need(tatp_dot.launches_by_path[path] == before[path] + 1,
             f"{name}: did not take the {path} path")
        tol = GEMM_TOL["bfloat16" if torch.bfloat16 in (dt, odt)
                       else "float32"]
        compare(f"{name} ({path})", got, matmul_ref(a, b, out_dtype=odt),
                *tol)

    shapes, tot = [], dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0,
                           nbytes=0)
    for n, k, per_layer in LAYER_GEMMS:
        a = randn(M_MAIN, n, dtype=torch.bfloat16)
        b = randn(n, k, dtype=torch.bfloat16, scale=n ** -0.5)
        row = dict(
            shape=[M_MAIN, n, k], per_layer=per_layer,
            path=gemm_path(a, b), tile_n=gemm_tile_n(torch, M_MAIN, k),
            ms=time_ms(torch, lambda: tatp_dot(a, b)),
            plain_ms=time_ms(torch, lambda: matmul_ref(a, b)),
            library_ms=time_ms(torch, lambda: torch.matmul(a, b)),
        )
        flops = 2 * M_MAIN * n * k
        nbytes = 2 * (M_MAIN * n + n * k + M_MAIN * k)
        row["bound_ms"], _ = bound(flops, nbytes, "bfloat16")
        row["tflops"] = flops / row["ms"] / 1e9
        shapes.append(row)
        for key in ("ms", "plain_ms", "library_ms"):
            tot[key] += per_layer * row[key]
        tot["flops"] += per_layer * flops
        tot["nbytes"] += per_layer * nbytes
    gemm_bound, gemm_by = bound(tot["flops"], tot["nbytes"], "bfloat16")
    log(f"  timings per layer of prefill (7 GEMMs, bf16): "
        f"{json.dumps(shapes)}")
    ssm_shapes = []
    for arch, n, k, per_prefill in SSM_GEMMS:
        a = randn(M_SSM, n, dtype=torch.bfloat16)
        b = randn(n, k, dtype=torch.bfloat16, scale=n ** -0.5)
        got = tatp_dot(a, b)
        torch.cuda.synchronize()
        gemm_err = max(gemm_err, compare(
            f"bf16 {arch} {M_SSM}x{n}x{k}", got, matmul_ref(a, b),
            *GEMM_TOL["bfloat16"]))
        flops = 2 * M_SSM * n * k
        row = dict(arch=arch, shape=[M_SSM, n, k], per_prefill=per_prefill,
                   path=gemm_path(a, b), tile_n=gemm_tile_n(torch, M_SSM, k),
                   ms=time_ms(torch, lambda: tatp_dot(a, b)),
                   plain_ms=time_ms(torch, lambda: matmul_ref(a, b)),
                   library_ms=time_ms(torch, lambda: torch.matmul(a, b)))
        row["bound_ms"], _ = bound(flops, 2 * (M_SSM * n + n * k + M_SSM * k),
                                   "bfloat16")
        row["tflops"] = flops / row["ms"] / 1e9
        row["library_ratio"] = row["ms"] / row["library_ms"]
        ssm_shapes.append(row)
    log(f"  timings of the SSM paths' prefill GEMMs (bf16): "
        f"{json.dumps(ssm_shapes)}")

    log("[kernels] flash_attention vs attention_ref")
    # every mask option at every instantiated head size, fp32 (SIMT, true
    # fp32 products) and bf16 (tensor cores, P rounded to bf16 for P.V)
    for dt, path in ((torch.float32, "simt"), (torch.bfloat16, "mma")):
        tol = ATTN_TOL["bfloat16" if dt == torch.bfloat16 else "float32"]
        for d in (64, 80, 128, 256):
            for name, hq, hkv, sq, skv, causal, window, cap in ATTN_CASES:
                q = randn(2, hq, sq, d, dtype=dt, scale=cap_scale(cap))
                k = randn(2, hkv, skv, d, dtype=dt)
                v = randn(2, hkv, skv, d, dtype=dt)
                kw = dict(causal=causal, window=window, cap=cap)
                before = attention.launches_by_path[path]
                got = attention(q, k, v, **kw)
                torch.cuda.synchronize()
                need(attention.launches_by_path[path] == before + 1,
                     f"flash D={d} {name}: did not take the {path} path")
                compare(f"{str(dt)[6:]} D={d} {name} ({path})", got,
                        attention_ref(q, k, v, **kw), *tol,
                        rms="row" if cap else None)
    # the main path's shape and layout: [B, S, H, D] activations viewed as
    # [B, H, S, D] (strided, no copy), bf16, causal
    b, s = MAIN["batch"], MAIN["prompt_len"]
    q, k, v = (randn(b, s, HEADS, HEAD_DIM, dtype=torch.bfloat16)
               .transpose(1, 2) for _ in range(3))
    before = attention.launches_by_path["mma"]
    got = attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    need(attention.launches_by_path["mma"] == before + 1,
         "flash at the main shape did not take the mma path")
    need(got.stride() == q.stride(), "flash output lost the input layout")
    attn_err = compare(f"bf16 [{b},{HEADS},{s},{HEAD_DIM}] causal strided",
                       got, attention_ref(q, k, v, causal=True),
                       *ATTN_TOL["bfloat16"])
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    compare("bf16 contiguous == strided", attention(qc, kc, vc), got, 0, 0)
    attn = dict(
        ms=time_ms(torch, lambda: attention(q, k, v, causal=True), 50),
        plain_ms=time_ms(torch,
                         lambda: attention_ref(q, k, v, causal=True), 50),
        library_ms=time_ms(
            torch,
            lambda: F.scaled_dot_product_attention(qc, kc, vc,
                                                   is_causal=True), 50),
    )
    pairs = b * HEADS * s * (s + 1) // 2  # unmasked (q, k) pairs, causal
    attn_flops = 4 * pairs * HEAD_DIM
    attn_bytes = 4 * b * HEADS * s * HEAD_DIM * 2  # q, k, v in; o out
    attn["bound_ms"], attn_by = bound(attn_flops, attn_bytes, "bfloat16")
    attn["share_of_bound"] = attn["bound_ms"] / attn["ms"]
    attn["library_ratio"] = attn["ms"] / attn["library_ms"]
    log(f"  timing [4,32,128,128] bf16 causal: {json.dumps(attn)}")
    attn["d80"] = flash_d80(torch, randn)
    ssd = ssd_checks_and_timing(torch, randn, g)

    return [
        dict(name="tatp_matmul", route="cuda", path="wgmma",
             source="src/repro_torch/csrc/tatp_matmul.cu",
             replaces="src/repro/kernels/tatp_matmul/kernel.py:24",
             max_abs_err=gemm_err, rtol=GEMM_TOL["bfloat16"][0],
             atol=GEMM_TOL["bfloat16"][1],
             ms=tot["ms"], kernel_ms=tot["ms"], plain_ms=tot["plain_ms"],
             bound_ms=gemm_bound, bound_by=gemm_by,
             library_ms=tot["library_ms"],
             share_of_bound=gemm_bound / tot["ms"],
             library_ratio=tot["ms"] / tot["library_ms"],
             timed="the 7 GEMMs of one deepseek-7b layer's prefill, "
                   "M=512, bf16",
             shapes=shapes, ssm_shapes=ssm_shapes),
        dict(name="flash_attention", route="cuda", path="mma",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:26",
             max_abs_err=attn_err, rtol=ATTN_TOL["bfloat16"][0],
             atol=ATTN_TOL["bfloat16"][1],
             ms=attn["ms"], kernel_ms=attn["ms"],
             plain_ms=attn["plain_ms"], bound_ms=attn["bound_ms"],
             bound_by=attn_by, library_ms=attn["library_ms"],
             share_of_bound=attn["share_of_bound"],
             library_ratio=attn["library_ratio"],
             timed="one layer's prefill attention, [4,32,128,128] bf16 "
                   "causal",
             d80=attn["d80"]),
        ssd,
    ]


def flash_d80(torch, randn):
    """The flash kernel at zamba2-2.7b's shared attention: D = 80, the
    model's [B, S, H, D] layout viewed as [B, H, S, D], bf16, causal."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    b, h, s, d = ZAMBA_ATTN
    q, k, v = (randn(b, s, h, d, dtype=torch.bfloat16).transpose(1, 2)
               for _ in range(3))
    before = attention.launches_by_path["mma"]
    got = attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    need(attention.launches_by_path["mma"] == before + 1,
         "flash at zamba2's shape did not take the mma path")
    err = compare(f"bf16 [{b},{h},{s},{d}] causal strided", got,
                  attention_ref(q, k, v, causal=True),
                  *ATTN_TOL["bfloat16"])
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    compare(f"bf16 [{b},{h},{s},{d}] contiguous == strided",
            attention(qc, kc, vc), got, 0, 0)
    row = dict(
        shape=[b, h, s, d], path="mma", max_abs_err=err,
        ms=time_ms(torch, lambda: attention(q, k, v, causal=True), 50),
        plain_ms=time_ms(torch,
                         lambda: attention_ref(q, k, v, causal=True), 50),
        library_ms=time_ms(
            torch,
            lambda: F.scaled_dot_product_attention(qc, kc, vc,
                                                   is_causal=True), 50),
    )
    pairs = b * h * s * (s + 1) // 2
    row["bound_ms"], row["bound_by"] = bound(4 * pairs * d,
                                             4 * b * h * s * d * 2,
                                             "bfloat16")
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    row["library_ratio"] = row["ms"] / row["library_ms"]
    log(f"  timing {row['shape']} bf16 causal: {json.dumps(row)}")
    return row


def ssd_bound(bc, q, h, p, n):
    """The SSD intra-chunk pass's least work: the multiply-adds of C.B^T
    (once per chunk), M @ x and the state, counting only the causal
    (s <= q) pairs; and its bytes, each input read once and each output
    written once.  The bound takes the operations at the card's fastest
    fp32-accurate rate (3xTF32 on the tensor cores); the fp32 CUDA-core
    bound is kept beside it."""
    pairs = q * (q + 1) // 2
    flops = bc * (2 * n * pairs + h * (2 * p * pairs + 2 * q * p * n))
    nbytes = 4 * (2 * bc * q * h * p + bc * h * p * n + bc * h
                  + 2 * bc * q * n + bc * q * h + h)
    ms, by = bound(flops, nbytes, "tf32x3")
    return ms, by, flops, nbytes, bound(flops, nbytes, "float32")[0]


def ssd_inputs(torch, randn, g, bc, q, h, p, n, strided=False,
               dt_value=None, pad=0):
    """(x, dt, a, B, C) of the SSD intra-chunk pass on the card; strided:
    x, B and C column slices of one buffer of row pitch h p + 2 n + pad,
    as mamba_block passes the conv output."""
    dev = torch.device("cuda")
    if strided:
        buf = randn(bc, q, h * p + 2 * n + pad)
        x = buf[..., :h * p].reshape(bc, q, h, p)
        bm = buf[..., h * p:h * p + n]
        cm = buf[..., h * p + n:h * p + 2 * n]
    else:
        x, bm, cm = randn(bc, q, h, p), randn(bc, q, n), randn(bc, q, n)
    if dt_value is None:  # the range of softplus(dt_bias) at init
        dt = torch.rand(bc, q, h, generator=g, device=dev) * 0.1
    else:
        dt = torch.full((bc, q, h), dt_value, device=dev)
    a = -torch.linspace(1.0, 16.0, h, device=dev)  # -exp(a_log) at init
    return x, dt, a, bm, cm


def ssd_checks_and_timing(torch, randn, g):
    """The SSD kernel against its plain version (fp32, TF32 off) at the
    reduced configs' shape, a ragged one and both models' full shapes,
    contiguous and strided as mamba_block passes them; timings at the full
    shapes.  Returns the kernels-line record."""
    from repro_torch.kernels.ssd.ops import ssd_intra_chunk
    from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref

    def inputs(*shape, **kw):
        return ssd_inputs(torch, randn, g, *shape, **kw)

    log("[kernels] ssd vs ssd_intra_chunk_ref")
    cases = [("reduced", (6, 8, 8, 16, 16), {}),
             ("ragged", (3, 100, 5, 20, 40), {})]
    cases += [(arch, shape, {}) for arch, shape in SSD_SHAPES.items()]
    cases += [(arch + " strided", shape, dict(strided=True))
              for arch, shape in SSD_SHAPES.items()]
    # cum falls to ~-410 over the chunk: the masked decay must select
    cases += [("mamba2-780m dt=0.1", SSD_SHAPES["mamba2-780m"],
               dict(dt_value=0.1))]
    # H not a multiple of the head block, and rows whose pitch is not a
    # multiple of 4 floats (no 16-byte cp.async: scalar loads)
    cases += [("H=7", (2, 256, 7, 64, 128), {}),
              ("H=7 pitch%4=1", (2, 256, 7, 64, 128),
               dict(strided=True, pad=1)),
              ("ragged pitch%4=3", (3, 100, 5, 20, 40),
               dict(strided=True, pad=3)),
              ("N=64 H=7 pitch%4=2", (2, 200, 7, 64, 64),
               dict(strided=True, pad=2))]
    max_err, arch_err = 0.0, {arch: 0.0 for arch in SSD_SHAPES}
    for name, shape, kw in cases:
        ins = inputs(*shape, **kw)
        before = ssd_intra_chunk.launches
        got = ssd_intra_chunk(*ins)
        torch.cuda.synchronize()
        need(ssd_intra_chunk.launches == before + 1,
             f"ssd {name}: did not launch the kernel")
        for part, gt, rf in zip(("y", "state", "decay"), got,
                                ssd_intra_chunk_ref(*ins)):
            err = compare(f"f32 {name} {list(shape)} {part} ({SSD_PATH})",
                          gt, rf, *SSD_TOL)
            for arch, full in SSD_SHAPES.items():
                if shape == full:
                    arch_err[arch] = max(arch_err[arch], err)
                    max_err = max(max_err, err)
    log(f"  ssd max_abs_err at the full shapes: {json.dumps(arch_err)}")

    rows = {}
    for arch, shape in SSD_SHAPES.items():
        ins = inputs(*shape)
        row = dict(
            shape=list(shape), path=SSD_PATH, max_abs_err=arch_err[arch],
            ms=time_ms(torch, lambda: ssd_intra_chunk(*ins)),
            plain_ms=time_ms(torch, lambda: ssd_intra_chunk_ref(*ins)),
        )
        (row["bound_ms"], row["bound_by"], flops, nbytes,
         row["bound_fp32_cuda_ms"]) = ssd_bound(*shape)
        row["gflop"], row["mbytes"] = flops / 1e9, nbytes / 1e6
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        rows[arch] = row
    log(f"  timings [B*nc, Q, H, P, N] fp32: {json.dumps(rows)}")
    main = rows["mamba2-780m"]
    return dict(name="ssd", route="cuda", path=SSD_PATH,
                source="src/repro_torch/csrc/ssd.cu",
                replaces="src/repro/kernels/ssd/kernel.py:20",
                max_abs_err=max_err, rtol=SSD_TOL[0], atol=SSD_TOL[1],
                ms=main["ms"], kernel_ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"],
                bound_fp32_cuda_ms=main["bound_fp32_cuda_ms"],
                share_of_bound=main["share_of_bound"], library_ms=None,
                timed="one mamba2-780m prefill layer's SSD intra-chunk "
                      "pass, [8,256,48,64] N=128 fp32",
                per_arch=rows)


def ssd_bwd_work(bc, q, h, p, n):
    """The SSD backward's least work: the multiply-adds of C.B^T, dCB B
    and dCB^T C (once per chunk: B and C are shared by the heads), and per
    head dM = dy x^T and M^T dy over the causal (s <= q) pairs and the
    state's B dst^T and (w x)^T dst; and its bytes, each input (x, dt, a,
    B, C, dy, dst, dg) read once and each output (dx, ddt, da, dB, dC)
    written once.  Returns (flops, bytes)."""
    pairs = q * (q + 1) // 2
    flops = bc * (6 * n * pairs + h * (4 * p * pairs + 4 * q * p * n))
    nbytes = 4 * (3 * bc * q * h * p + bc * h * p * n + bc * h
                  + 2 * bc * q * h + 2 * h + 4 * bc * q * n)
    return flops, nbytes


def phase_ssd_backward(torch, randn):
    """The SSD backward kernel against the plain backward
    (ssd_intra_chunk_bwd_ref, fp32, TF32 off) at ragged shapes, the train
    step's shapes (contiguous and strided as mamba_block passes them) and
    large decays (a = -16 over the 256-token chunk, where the gradients
    must stay finite), two launches at each train shape bitwise equal;
    then its time at both train shapes beside its bound and the plain
    backward's (no library call computes it).
    Returns the kernels-line record."""
    from repro_torch.kernels.ssd.ops import ssd_intra_chunk_bwd
    from repro_torch.kernels.ssd.ref import ssd_intra_chunk_bwd_ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)

    def inputs(bc, q, h, p, n, strided=False, large=False):
        x, dt, a, bm, cm = ssd_inputs(torch, randn, g, bc, q, h, p, n,
                                      strided=strided, pad=1)
        if large:  # cum falls to ~-3000 over the chunk
            dt = torch.rand(bc, q, h, generator=g, device=dev) * 0.5 + 0.5
            a = torch.full((h,), -16.0, device=dev)
        cots = (randn(bc, q, h, p), randn(bc, h, p, n), randn(bc, h))
        return (x, dt, a, bm, cm), cots

    log("[kernels] ssd backward vs ssd_intra_chunk_bwd_ref")
    cases = [("ragged", (3, 100, 3, 48, 40), {}),
             ("ragged strided", (2, 130, 5, 33, 70), dict(strided=True))]
    cases += [(arch, shape, {}) for arch, shape in SSD_SHAPES.items()]
    cases += [(arch + " strided", shape, dict(strided=True))
              for arch, shape in SSD_SHAPES.items()]
    cases += [("large decay a=-16", SSD_SHAPES["mamba2-780m"],
               dict(large=True))]
    max_abs, max_rel = 0.0, 0.0
    for name, shape, kw in cases:
        ins, cots = inputs(*shape, **kw)
        before = ssd_intra_chunk_bwd.launches
        got = ssd_intra_chunk_bwd(*ins, *cots)
        torch.cuda.synchronize()
        need(ssd_intra_chunk_bwd.launches == before + 1,
             f"ssd backward {name}: did not launch the kernel")
        rel = {}
        for part, gt, rf in zip(("dx", "ddt", "da", "dB", "dC"), got,
                                ssd_intra_chunk_bwd_ref(*ins, *cots)):
            need(bool(gt.isfinite().all()),
                 f"ssd backward {name} {part}: non-finite kernel output")
            need(bool(rf.isfinite().all()),
                 f"ssd backward {name} {part}: non-finite plain output")
            err = (gt - rf).abs().max().item()
            rel[part] = err / max(rf.abs().max().item(), 1e-30)
            if shape in SSD_SHAPES.values():
                max_abs = max(max_abs, err)
        worst = max(rel.values())
        max_rel = max(max_rel, worst)
        ok = worst <= SSD_BWD_TOL
        log(f"  check f32 {name} {list(shape)} ({SSD_BWD_PATH}): max "
            f"relative error {worst:.3e} (each gradient's max |error| / "
            f"max |plain|: {json.dumps(rel)}) tol {SSD_BWD_TOL} "
            f"{'ok' if ok else 'FAIL'}")
        need(ok, f"ssd backward {name}: kernel disagrees with the plain "
             f"backward")
        if shape in SSD_SHAPES.values():  # the train shapes: run it again
            again = ssd_intra_chunk_bwd(*ins, *cots)
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            log(f"  determinism {name}: two launches bitwise equal on every "
                f"gradient: {same}")
            need(same, f"ssd backward {name}: gradients differ between two "
                 f"launches on the same inputs")

    rows = {}
    for arch, shape in SSD_SHAPES.items():
        ins, cots = inputs(*shape)
        flops, nbytes = ssd_bwd_work(*shape)
        row = dict(
            shape=list(shape), path=SSD_BWD_PATH,
            ms=time_ms(torch, lambda: ssd_intra_chunk_bwd(*ins, *cots)),
            plain_ms=time_ms(torch, lambda: ssd_intra_chunk_bwd_ref(
                *ins, *cots), 5, 1),
            gflop=flops / 1e9, mbytes=nbytes / 1e6)
        # the least time at the card's fastest fp32-accurate rate (3xTF32
        # on the tensor cores), the fp32 CUDA-core bound beside it
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes, "tf32x3")
        row["bound_fp32_cuda_ms"] = bound(flops, nbytes, "float32")[0]
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        rows[arch] = row
    log(f"  timings of the backward [B*nc, Q, H, P, N] fp32: "
        f"{json.dumps(rows)}")
    main = rows["mamba2-780m"]
    return dict(name="ssd_bwd", route="cuda", path=SSD_BWD_PATH,
                source="src/repro_torch/csrc/ssd_bwd.cu",
                replaces="none: JAX differentiates its jnp SSD path "
                         "(src/repro/models/ssm.py:ssd_chunked); the Pallas "
                         "kernel src/repro/kernels/ssd/kernel.py:20 has no "
                         "backward",
                max_abs_err=max_abs, max_rel_err=max_rel,
                rel_tol=SSD_BWD_TOL, ms=main["ms"], kernel_ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"],
                bound_fp32_cuda_ms=main["bound_fp32_cuda_ms"],
                share_of_bound=main["share_of_bound"], library_ms=None,
                timed="one mamba2-780m train layer's SSD backward, "
                      "[8,256,48,64] N=128 fp32",
                per_arch=rows)


# the GEMM's four operand layout pairs: (A transposed, B transposed) —
# the forward, dgrad (dy @ w.T), wgrad (x.T @ dy), both
LAYOUTS = ((False, False), (False, True), (True, False), (True, True))
LAYOUT_NAMES = {(False, False): "fwd", (False, True): "dgrad",
                (True, False): "wgrad", (True, True): "both"}

# deepseek-7b's train step at batch 4 x seq 512, 4 layers
# 3 steps a run (5 until phase 13's part (e) needed the time): step ms is
# the median of the steps after the first
TRAIN = dict(batch=4, seq=512, n_layers=4, steps=3)
M_TRAIN = TRAIN["batch"] * TRAIN["seq"]
# the bf16 train main paths at batch 4 x seq 512: (arch, layers).
# deepseek-7b's 30 layers need ~110 GB with AdamW's state (16 B a
# parameter); mamba2-780m (0.781 B parameters, ~12.5 GB) and zamba2-2.7b
# (1.956 B in this config, ~31 GB) fit one card at full depth;
# olmoe-1b-7b's 16 layers (6.9 B, ~111 GB) do not, its 4 layers (1.88 B,
# ~30 GB) do; gemma2-9b's 4 layers (two LG units, 1.71 B, ~27 GB) do, as
# do internvl2-1b (0.49 B) and seamless-m4t-large-v2 (24 + 24 layers,
# 1.37 B) at full depth.  Since phase 15 needed the time, the deep runs
# are cut to half their depth or less (mamba2-780m 48 -> 24, zamba2-2.7b
# 54 -> 24, four units; internvl2-1b 24 -> 12; seamless-m4t-large-v2's
# decoder 24 -> 12, its encoder's 24 kept), and since phase 13's part (e)
# did, further (mamba2-780m -> 8, zamba2-2.7b -> 12, two units,
# internvl2-1b -> 4): a step's work and its profiled host ops scale with
# the layers, the kernels' shapes do not
TRAIN_RUNS = (("deepseek-7b", TRAIN["n_layers"]), ("mamba2-780m", 8),
              ("zamba2-2.7b", 12), ("olmoe-1b-7b", TRAIN["n_layers"]),
              ("gemma2-9b", TRAIN["n_layers"]), ("internvl2-1b", 4),
              ("seamless-m4t-large-v2", 12))
# architectures whose train step is not run here but whose train GEMM and
# flash shapes phase_path_shapes holds against the plain versions
TRAIN_SHAPES_ONLY = ("gemma-7b", "qwen2-72b")


def _operand(torch, randn, rows, cols, transposed, dtype, scale=1.0,
             pad=0):
    """A [rows, cols] operand: row-major (row pitch cols + pad), or the
    transposed view of a [cols, rows] one (pitch rows + pad)."""
    if transposed:
        return randn(cols, rows + pad, dtype=dtype, scale=scale)[:, :rows].t()
    return randn(rows, cols + pad, dtype=dtype, scale=scale)[:, :cols]


def make_randn(torch, seed):
    """randn(*shape, dtype, scale) on the card from a seeded generator."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        x = torch.randn(shape, generator=g, device="cuda") * scale
        return x.to(dtype)

    return randn


def phase_gemm_layouts(torch, randn):
    """The GEMM in all four layout pairs on every path against matmul_ref,
    ragged shapes included, each case asserting its path; then the
    backward's products of one deepseek-7b train layer (M = 2048, bf16)
    timed in the dgrad and wgrad layouts beside their bound, the plain
    version and torch.matmul on the same transposed views.  Returns the
    kernels-line records of the two layouts."""
    from repro_torch.kernels.tatp_matmul.ops import tatp_dot
    from repro_torch.kernels.tatp_matmul.ref import matmul_ref

    log("[kernels] tatp_matmul layouts vs matmul_ref")
    # (name, m, n, k, dtype, out dtype, pad, path): pad > 0 makes pitches
    # that TMA cannot describe (the wmma path)
    cases = [
        ("f32 100x200x300", 100, 200, 300, torch.float32, None, 0, "simt"),
        ("f32 64x96x80 ->bf16", 64, 96, 80, torch.float32, torch.bfloat16,
         0, "simt"),
        ("bf16 100x203x301", 100, 203, 301, torch.bfloat16, None, 1,
         "wmma"),
        ("bf16 130x40x72 ->f32", 130, 40, 72, torch.bfloat16, torch.float32,
         3, "wmma"),
        ("bf16 100x208x304", 100, 208, 304, torch.bfloat16, None, 0,
         "wgmma"),
        ("bf16 77x256x1000 ->f32", 77, 256, 1000, torch.bfloat16,
         torch.float32, 0, "wgmma"),
        ("bf16 1x8x8", 1, 8, 8, torch.bfloat16, None, 0, "wgmma"),
        ("bf16 300x1000x1000", 300, 1000, 1000, torch.bfloat16, None, 0,
         "wgmma"),
    ]
    err_by_layout = {name: 0.0 for name in LAYOUT_NAMES.values()}
    for name, m, n, k, dt, odt, pad, path in cases:
        for ta, tb in LAYOUTS:
            if pad == 0 and path == "wgmma" and m % 8 and ta:
                continue  # a transposed A's pitch is m: TMA needs m % 8
            a = _operand(torch, randn, m, n, ta, dt, pad=pad)
            b = _operand(torch, randn, n, k, tb, dt, scale=n ** -0.5,
                         pad=pad)
            before = dict(tatp_dot.launches_by_path)
            got = tatp_dot(a, b, out_dtype=odt)
            torch.cuda.synchronize()
            need(tatp_dot.launches_by_path[path] == before[path] + 1,
                 f"{name} {LAYOUT_NAMES[ta, tb]}: did not take {path}")
            tol = GEMM_TOL["bfloat16" if torch.bfloat16 in (dt, odt)
                           else "float32"]
            err = compare(f"{name} {LAYOUT_NAMES[ta, tb]} ({path})", got,
                          matmul_ref(a, b, out_dtype=odt), *tol)
            if dt == torch.bfloat16:
                lay = LAYOUT_NAMES[ta, tb]
                err_by_layout[lay] = max(err_by_layout[lay], err)

    head = lm_head_timing(torch, randn)
    # one train layer's backward products, bf16, M = 2048: dgrad dy @ w.T
    # and wgrad x.T @ dy for wq wk wv wo / w_up w_gate / w_down
    records = []
    for lay in ("dgrad", "wgrad"):
        rows, tot = [], dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0,
                             nbytes=0)
        for n, k, per_layer in LAYER_GEMMS:
            w = randn(n, k, dtype=torch.bfloat16, scale=n ** -0.5)
            if lay == "dgrad":  # [M, K] @ [K, N]: w.T is B, transposed
                a, b = randn(M_TRAIN, k, dtype=torch.bfloat16), w.t()
            else:  # [N, M] @ [M, K]: x.T is A, transposed
                a = randn(M_TRAIN, n, dtype=torch.bfloat16).t()
                b = randn(M_TRAIN, k, dtype=torch.bfloat16,
                          scale=M_TRAIN ** -0.5)
            got = tatp_dot(a, b)
            torch.cuda.synchronize()
            err_by_layout[lay] = max(err_by_layout[lay], compare(
                f"bf16 {lay} {list(a.shape)}@{list(b.shape)}", got,
                matmul_ref(a, b), *GEMM_TOL["bfloat16"]))
            mm, nn = a.shape
            kk = b.shape[1]
            row = dict(shape=[mm, nn, kk], per_layer=per_layer,
                       path=gemm_path(a, b),
                       tile_n=gemm_tile_n(torch, mm, kk),
                       ms=time_ms(torch, lambda: tatp_dot(a, b)),
                       plain_ms=time_ms(torch, lambda: matmul_ref(a, b)),
                       library_ms=time_ms(torch,
                                          lambda: torch.matmul(a, b)))
            need(row["path"] == "wgmma", f"{lay} {row['shape']} took "
                 f"{row['path']}")
            flops = 2 * mm * nn * kk
            nbytes = 2 * (mm * nn + nn * kk + mm * kk)
            row["bound_ms"], _ = bound(flops, nbytes, "bfloat16")
            row["tflops"] = flops / row["ms"] / 1e9
            rows.append(row)
            for key in ("ms", "plain_ms", "library_ms"):
                tot[key] += per_layer * row[key]
            tot["flops"] += per_layer * flops
            tot["nbytes"] += per_layer * nbytes
        b_ms, b_by = bound(tot["flops"], tot["nbytes"], "bfloat16")
        log(f"  timings of one train layer's {lay} GEMMs (7, bf16, M "
            f"{M_TRAIN}): {json.dumps(rows)}")
        records.append(dict(
            name=f"tatp_matmul_{lay}", route="cuda", path="wgmma",
            source="src/repro_torch/csrc/tatp_matmul.cu",
            replaces="src/repro/kernels/tatp_matmul/kernel.py:24",
            max_abs_err=err_by_layout[lay], rtol=GEMM_TOL["bfloat16"][0],
            atol=GEMM_TOL["bfloat16"][1], ms=tot["ms"], kernel_ms=tot["ms"],
            plain_ms=tot["plain_ms"], bound_ms=b_ms, bound_by=b_by,
            library_ms=tot["library_ms"], share_of_bound=b_ms / tot["ms"],
            library_ratio=tot["ms"] / tot["library_ms"],
            timed=f"the 7 {lay} GEMMs of one deepseek-7b train layer, "
                  f"M={M_TRAIN}, bf16", shapes=rows, lm_head=head[lay]))
    log(f"  max_abs_err by layout (bf16): {json.dumps(err_by_layout)}")
    return records


def lm_head_timing(torch, randn):
    """deepseek-7b's lm head in the train step (models/lm.py:_HeadMatmul;
    each product is checked by :func:`phase_path_shapes`): its three
    products timed beside their bound, the plain version and the library
    call: forward x @ w -> fp32, dgrad on the stacked three-term
    cotangent [3M, Vp] @ w.T -> fp32, wgrad [x; x; x].T @ [3M, Vp] ->
    bf16; then its whole backward (the cotangent's split included)
    through autograd.  Returns the head's rows by layout."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.tatp_matmul.ops import tatp_dot
    from repro_torch.kernels.tatp_matmul.ref import matmul_ref
    from repro_torch.models.lm import _HeadMatmul
    from repro_torch.models.transformer import padded_vocab

    bf, f32 = torch.bfloat16, torch.float32

    log(f"[kernels] tatp_matmul: deepseek-7b's train lm head, M {M_TRAIN}")
    d, vp = D_MODEL, padded_vocab(get_config("deepseek-7b"))
    x = randn(M_TRAIN, d, dtype=bf)
    w = randn(d, vp, dtype=bf, scale=d ** -0.5)
    gs = randn(3 * M_TRAIN, vp, dtype=bf)
    products = {"fwd": (x, w, f32), "dgrad": (gs, w.t(), f32),
                "wgrad": (torch.cat([x, x, x]).t(), gs, bf)}
    head = {}
    for lay, (a, b, odt) in products.items():
        mm, nn = a.shape
        kk = b.shape[1]
        flops = 2 * mm * nn * kk
        nbytes = 2 * (mm * nn + nn * kk) + mm * kk * odt.itemsize
        row = dict(shape=[mm, nn, kk], out=str(odt)[6:],
                   ms=time_ms(torch, lambda: tatp_dot(a, b, out_dtype=odt),
                              5, 1),
                   plain_ms=time_ms(torch, lambda: matmul_ref(
                       a, b, out_dtype=odt), 3, 1),
                   library_ms=time_ms(torch, lambda: torch.mm(
                       a, b, out_dtype=odt) if odt == f32 else
                       torch.mm(a, b), 5, 1))
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes, "bfloat16")
        row["tflops"] = flops / row["ms"] / 1e9
        head[lay] = row
    del products, gs

    # the head's whole backward as the train step runs it
    xr, wr = x.requires_grad_(True), w.requires_grad_(True)
    logits = _HeadMatmul.apply(xr, wr, tatp_dot)
    g = randn(M_TRAIN, vp, scale=1.0 / M_TRAIN)

    def head_backward():
        torch.autograd.grad(logits, (xr, wr), g, retain_graph=True)

    head["backward_ms"] = time_ms(torch, head_backward, 5, 1)
    log(f"  lm head's train products (bf16 operands; ms, plain, "
        f"torch.mm, bound) and its whole backward: {json.dumps(head)}")
    del logits, xr, wr, x, w, g
    return head


# flash backward checks: (name, Hq, Hkv, Sq, Skv, causal, window, cap).
# With q scaled by ``cap_scale`` most scores lie beyond the cap.  At caps 1
# and 0.5 the softmax stays spread; at cap 30 (a model's) it is nearly
# one-hot, so dS = P (dP - rowsum(dO O)) cancels: only an fp32-accurate
# delta, and P and dS taken as two bf16 terms, keep the gradients at
# autograd's fp32 values.  A capped case's gradients take atol scaled by
# the gradient's RMS (``rms="tensor"``).
ATTN_BWD_CASES = (
    ("causal", 4, 4, 100, 100, True, None, None),
    ("non-causal", 4, 4, 100, 100, False, None, None),
    ("window16", 4, 4, 100, 100, True, 16, None),
    ("cap1", 4, 4, 100, 100, True, None, 1.0),
    ("gqa8/2", 8, 2, 100, 100, True, None, None),
    ("gqa8/2 window cap", 8, 2, 130, 130, True, 32, 0.5),
    ("rect100x160", 4, 2, 100, 160, False, 16, 1.0),
    ("masked rows 100x40", 4, 2, 100, 40, True, 16, None),
    ("cap30 gqa4/2", 4, 2, 100, 100, True, None, 30.0),
)
# deepseek-7b's train attention at batch 4 x seq 512: [B, H, S, D]
TRAIN_ATTN = (TRAIN["batch"], HEADS, TRAIN["seq"], HEAD_DIM)


def flash_grads(torch, fn, q, k, v, do, **kw):
    """(o, dq, dk, dv) of ``fn`` by autograd."""
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    o = fn(q, k, v, **kw)
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
    return o.detach(), dq, dk, dv


def phase_flash_backward(torch, randn):
    """The flash backward kernel (through ``attention``'s autograd
    Function) against autograd through attention_ref: fp32 and bf16, every
    mask option, GQA, ragged and fully masked rows, D 64, 80, 128, 256
    and 196 (rows not 16-byte aligned; bf16 on ``mma`` at every D), and
    deepseek-7b's train shape, where two launches must give bitwise equal
    gradients; then its time at deepseek-7b's and zamba2-2.7b's train
    shapes beside its bound, the plain version's backward and SDPA's.
    Returns the kernels-line record."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import (_forward, attention,
                                                         attention_bwd)
    from repro_torch.kernels.flash_attention.ref import attention_ref

    log("[kernels] flash_attention backward vs autograd of attention_ref")
    max_err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        tol = ATTN_TOL["bfloat16" if dt == torch.bfloat16 else "float32"]
        path = "mma" if dt == torch.bfloat16 else "simt"
        for d in (64, 80, 128, 256, 196):
            # D 196: padded to 256, rows not 16-byte aligned (scalar
            # loads into the same layout); it and fp32 at D 256 (off the
            # main paths) take a few cases
            few = d == 196 or (d == 256 and path == "simt")
            cases = ATTN_BWD_CASES[-3:] if few else ATTN_BWD_CASES
            for name, hq, hkv, sq, skv, causal, window, cap in cases:
                q = randn(2, hq, sq, d, dtype=dt, scale=cap_scale(cap))
                k = randn(2, hkv, skv, d, dtype=dt)
                v = randn(2, hkv, skv, d, dtype=dt)
                do = randn(2, hq, sq, d, dtype=dt)
                kw = dict(causal=causal, window=window, cap=cap)
                before = (attention.launches,
                          attention_bwd.launches_by_path[path])
                got = flash_grads(torch, attention, q, k, v, do, **kw)
                torch.cuda.synchronize()
                need((attention.launches,
                      attention_bwd.launches_by_path[path])
                     == (before[0] + 1, before[1] + 1),
                     f"flash bwd D={d} {name}: did not take {path}")
                ref = flash_grads(torch, attention_ref, q, k, v, do, **kw)
                for part, g, r in zip(("dq", "dk", "dv"), got[1:], ref[1:]):
                    err = compare(f"{str(dt)[6:]} D={d} {name} {part} "
                                  f"({path})", g, r, *tol,
                                  rms="tensor" if cap else None)
                    if dt == torch.bfloat16 and path == "mma":
                        max_err = max(max_err, err)

    # the train shapes, [B, S, H, D] activations viewed as [B, H, S, D],
    # bf16, causal: deepseek-7b's (checked, run twice for bitwise
    # repeatable gradients, timed) and zamba2-2.7b's shared attention
    # (timed)
    def fwd_bwd(fn, q, k, v, do, **kw):
        def run():
            qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
            torch.autograd.grad(fn(qq, kk, vv, **kw), (qq, kk, vv), do)
        return run

    def fwd(fn, q, k, v, **kw):
        return lambda: fn(q, k, v, **kw)

    rows = {}
    for arch, shape in (("deepseek-7b", TRAIN_ATTN),
                        ("zamba2-2.7b", ZAMBA_ATTN)):
        b, h, s, d = shape
        q, k, v, do = (randn(b, s, h, d, dtype=torch.bfloat16)
                       .transpose(1, 2) for _ in range(4))
        if arch == "deepseek-7b":
            got = flash_grads(torch, attention, q, k, v, do, causal=True)
            ref = flash_grads(torch, attention_ref, q, k, v, do, causal=True)
            for part, g, r in zip(("dq", "dk", "dv"), got[1:], ref[1:]):
                max_err = max(max_err, compare(
                    f"bf16 {list(shape)} causal strided {part}", g, r,
                    *ATTN_TOL["bfloat16"]))
                need(g.stride() == q.stride(),
                     f"{part} lost the input layout")
        o, lse = _forward(q, k, v, True, None, None, None, want_lse=True)
        before = attention_bwd.launches_by_path["mma"]
        first = attention_bwd(q, k, v, o, lse, do, causal=True)
        need(attention_bwd.launches_by_path["mma"] == before + 1,
             f"flash backward at {arch}'s train shape did not take mma")
        if arch == "deepseek-7b":
            again = attention_bwd(q, k, v, o, lse, do, causal=True)
            same = all(torch.equal(x, y) for x, y in zip(first, again))
            log(f"  determinism {list(shape)}: two launches bitwise equal "
                f"on dq, dk, dv: {same}")
            need(same, "flash backward: gradients differ between two "
                 "launches on the same inputs")
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        row = dict(
            shape=list(shape), path="mma",
            ms=time_ms(torch, lambda: attention_bwd(q, k, v, o, lse, do,
                                                    causal=True), 10),
            plain_ms=(time_ms(torch, fwd_bwd(attention_ref, q, k, v, do,
                                             causal=True), 5)
                      - time_ms(torch, fwd(attention_ref, q, k, v,
                                           causal=True), 5)),
            library_ms=(time_ms(torch, fwd_bwd(
                            F.scaled_dot_product_attention, qc, kc, vc, do,
                            is_causal=True), 10)
                        - time_ms(torch, fwd(F.scaled_dot_product_attention,
                                             qc, kc, vc, is_causal=True),
                                  10)),
        )
        pairs = b * h * s * (s + 1) // 2
        # recompute S, then dP, dV, dK, dQ: five products over the causal
        # pairs, and the bytes of flash_bwd_bytes
        row["bound_ms"], row["bound_by"] = bound(
            10 * pairs * d, flash_bwd_bytes(b, h, h, s, s, d), "bfloat16")
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["library_ratio"] = row["ms"] / row["library_ms"]
        log(f"  timing backward {row['shape']} bf16 causal: "
            f"{json.dumps(row)}")
        rows[arch] = row
    row = rows["deepseek-7b"]
    return dict(
        name="flash_attention_bwd", route="cuda", path="mma",
        design="two launches (dQ, whose first sweep forms delta, then "
               "dK/dV); wgmma at D 256 (dK/dV on two warpgroups) and at D "
               "80 and 128 with aligned rows, mma.sync otherwise",
        source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="none: the Pallas kernel "
                 "src/repro/kernels/flash_attention/kernel.py:26 has no "
                 "backward (JAX differentiates its jnp path)",
        max_abs_err=max_err, rtol=ATTN_TOL["bfloat16"][0],
        atol=ATTN_TOL["bfloat16"][1], ms=row["ms"], kernel_ms=row["ms"],
        plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=row["library_ms"],
        share_of_bound=row["share_of_bound"],
        library_ratio=row["library_ratio"],
        timed="one deepseek-7b train layer's attention backward, "
              "[4,32,512,128] bf16 causal", shape=row["shape"],
        per_arch=rows)


# flash attention timed at the new architectures' shapes: (arch, block
# part, layer kind) of one prefill attention call (:func:`attention_shape`
# at the serve path's batch and prompt, the encoder's frames), and of the
# backward at one train attention call: at D 256 (gemma2's the windowed,
# soft-capped slot: its forward and its backward against flex_attention)
# and seamless's three at D 64 (on mma.sync)
FLASH_ARCH_ROWS = (("gemma2-9b", "dec", "L"), ("gemma-7b", "dec", "G"),
                   ("seamless-m4t-large-v2", "enc", "G"),
                   ("seamless-m4t-large-v2", "cross", "X"))
FLASH_BWD_ARCH = (("gemma-7b", "dec", "G"), ("gemma2-9b", "dec", "L"),
                  ("seamless-m4t-large-v2", "enc", "G"),
                  ("seamless-m4t-large-v2", "dec", "G"),
                  ("seamless-m4t-large-v2", "cross", "X"))


def phase_flash_arch_rows(torch, randn):
    """Flash attention timed at the new architectures' shapes, bf16, in
    the model's ``[B, S, H, D]`` layout viewed as ``[B, H, S, D]``: the
    forward at gemma2-9b's windowed, soft-capped prefill (against
    :func:`flex_yardstick`: SDPA takes no soft-cap), gemma-7b's prefill
    (D 256), seamless's bidirectional encoder and its cross attention of the
    prompt's queries to the frames (against SDPA), and the backward on
    ``mma`` at D 256: gemma-7b's train shape (against SDPA's backward) and
    gemma2-9b's windowed, soft-capped one (q scaled by
    :func:`cap_scale`; against :func:`flex_bwd_yardstick`), where two
    launches must give bitwise equal gradients, and at D 64: seamless's
    encoder, decoder and cross attention (against SDPA's backward).  Each asserts its path and is timed beside its bound over
    the pairs its masks leave (:func:`attn_pairs`);
    :func:`phase_path_shapes` checks every one of these shapes against the
    plain version.  Returns (forward rows, backward rows)."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import (_path,
                                                         _forward, attention,
                                                         attention_bwd)
    from repro_torch.kernels.flash_attention.ref import attention_ref

    bf = torch.bfloat16
    log("[kernels] flash_attention timed at the new architectures' shapes")

    def layout(b, h, s, d, scale=1.0):
        return randn(b, s, h, d, dtype=bf, scale=scale).transpose(1, 2)

    fwd_rows = []
    for arch, part, kind in FLASH_ARCH_ROWS:
        cfg, spec = get_config(arch), PATHS[arch]
        b = spec.get("batch", BATCH)
        hq, hkv, d, sq, skv, causal, window, cap = attention_shape(
            cfg, part, kind, spec["prompt_len"], cfg.frontend_tokens)
        q, k, v = (layout(b, hq, sq, d, cap_scale(cap)),
                   layout(b, hkv, skv, d), layout(b, hkv, skv, d))
        kw = dict(causal=causal, window=window, cap=cap)
        name = f"{arch} prefill, {part} {kind}"
        before = attention.launches_by_path["mma"]
        attention(q, k, v, **kw)
        torch.cuda.synchronize()
        need(attention.launches_by_path["mma"] == before + 1,
             f"flash {name}: did not take mma")
        pairs = b * hq * attn_pairs(sq, skv, causal, window)
        plain = cap is None and window is None
        row = dict(name=name, shape=[b, hq, sq, d], kv_heads=hkv, skv=skv,
                   causal=causal, window=window, cap=cap, path="mma",
                   ms=time_ms(torch, lambda: attention(q, k, v, **kw), 20),
                   plain_ms=time_ms(torch, lambda: attention_ref(
                       q, k, v, **kw), 3, 1),
                   library="scaled_dot_product_attention")
        if plain:
            qc, kc, vc = (t.contiguous() for t in (q, k, v))
            row["library_ms"] = time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qc, kc, vc, is_causal=causal), 20)
        else:  # SDPA takes no soft-cap
            row["library_ms"], row["library"] = flex_yardstick(
                torch, name, q, k, v, kw, attention_ref(q, k, v, **kw))
        row["library_ratio"] = row["ms"] / row["library_ms"]
        nbytes = 2 * d * (2 * b * hq * sq + 2 * b * hkv * skv)
        row["bound_ms"], row["bound_by"] = bound(4 * pairs * d, nbytes,
                                                 "bfloat16")
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        log(f"  timing {name}: {json.dumps(row)}")
        fwd_rows.append(row)

    b, s = TRAIN["batch"], TRAIN["seq"]
    bwd_rows = []
    for arch, part, kind in FLASH_BWD_ARCH:
        cfg = get_config(arch)
        h, hkv, d, sq, skv, causal, window, cap = attention_shape(
            cfg, part, kind, s, cfg.frontend_tokens)
        kw = dict(causal=causal, window=window, cap=cap)
        name = f"{arch} train, {part} {kind}"
        path = _path(bf, d)
        q = layout(b, h, sq, d, cap_scale(cap))
        k, v = layout(b, hkv, skv, d), layout(b, hkv, skv, d)
        do = layout(b, h, sq, d)
        o, lse = _forward(q, k, v, causal, window, cap, None, want_lse=True)
        before = attention_bwd.launches_by_path["mma"]
        first = attention_bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        need(path == "mma" and
             attention_bwd.launches_by_path["mma"] == before + 1,
             f"flash backward {name}: did not take mma")
        if cap is not None:
            again = attention_bwd(q, k, v, o, lse, do, **kw)
            same = all(torch.equal(x, y) for x, y in zip(first, again))
            log(f"  determinism {name} {[b, h, sq, d]}: two launches "
                f"bitwise equal on dq, dk, dv: {same}")
            need(same, f"flash backward {name}: gradients differ between "
                 f"two launches on the same inputs")

        def ref_fwd_bwd():
            qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
            torch.autograd.grad(attention_ref(qq, kk, vv, **kw),
                                (qq, kk, vv), do)

        bwd = dict(
            name=name, shape=[b, h, sq, d], kv_heads=hkv, skv=skv,
            causal=causal, window=window, cap=cap, path=path,
            ms=time_ms(torch, lambda: attention_bwd(q, k, v, o, lse, do,
                                                    **kw), 10),
            plain_ms=(time_ms(torch, ref_fwd_bwd, 3, 1)
                      - time_ms(torch, lambda: attention_ref(q, k, v, **kw),
                                3, 1)),
            library_ms=None)
        if cap is None and window is None and hkv == h:
            qc, kc, vc = (t.contiguous() for t in (q, k, v))

            def sdpa_fwd_bwd():
                qq, kk, vv = (t.detach().requires_grad_(True)
                              for t in (qc, kc, vc))
                torch.autograd.grad(F.scaled_dot_product_attention(
                    qq, kk, vv, is_causal=causal), (qq, kk, vv), do)

            bwd["library"] = "scaled_dot_product_attention"
            bwd["library_ms"] = (
                time_ms(torch, sdpa_fwd_bwd, 10)
                - time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qc, kc, vc, is_causal=causal), 10))
        else:  # SDPA takes no soft-cap
            bwd["library_ms"], bwd["library"] = flex_bwd_yardstick(
                torch, name, layout(b, h, sq, d), k, v, do, kw)
        bwd["library_ratio"] = bwd["ms"] / bwd["library_ms"]
        # five products over the attended pairs, and the bytes of
        # flash_bwd_bytes
        pairs = b * h * attn_pairs(sq, skv, causal, window)
        bwd["bound_ms"], bwd["bound_by"] = bound(
            10 * pairs * d, flash_bwd_bytes(b, h, hkv, sq, skv, d),
            "bfloat16")
        bwd["share_of_bound"] = bwd["bound_ms"] / bwd["ms"]
        log(f"  timing backward {name}: {json.dumps(bwd)}")
        bwd_rows.append(bwd)
    return fwd_rows, bwd_rows


def phase_path_shapes(torch, randn):
    """Each kernel at every shape the main paths give it, derived from the
    configs of ``PATHS``, ``TRAIN_RUNS`` and ``TRAIN_SHAPES_ONLY``
    (:func:`linear_shapes`, :func:`attention_shapes`), bf16, against its
    plain version on the path the main paths take: the GEMM on ``wgmma``
    at every prefill linear (M = batch x prompt, an encoder's and the
    cross blocks' wk and wv batch x frames) and, in training (M = batch
    x seq, or x frames), at every linear's forward ``x @ w``, dgrad
    ``dy @ w.T`` and wgrad ``x.T @ dy`` and the lm head's three products
    at their layouts and output dtypes (``models/lm.py:_HeadMatmul``; a
    tied head reads the embedding transposed); flash forward on ``mma``
    at every prefill's attention shape (causal, windowed, soft-capped,
    bidirectional over the frames, or cross over them) and, through
    autograd against autograd through attention_ref, forward and backward
    (both ``mma``) at every train shape, in the model's ``[B, S, H, D]``
    layout viewed as ``[B, H, S, D]``.  A soft-capped shape scales q so most
    scores lie beyond the cap (:func:`cap_scale`), so its softmax is nearly
    one-hot and its backward needs an fp32-accurate delta.  Flash outputs take
    ``atol`` scaled by each row's RMS below 1, a soft-capped shape's
    gradients by the tensor's (:func:`compare`).  A shape two paths share is
    checked once.
    Returns the largest error by kernels-line record."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import (_path, attention,
                                                         attention_bwd)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.tatp_matmul.ops import tatp_dot
    from repro_torch.kernels.tatp_matmul.ref import matmul_ref
    from repro_torch.models.transformer import padded_vocab

    bf, f32 = torch.bfloat16, torch.float32
    errs = dict.fromkeys(("tatp_matmul", "tatp_matmul_dgrad",
                          "tatp_matmul_wgrad", "flash_attention",
                          "flash_attention_bwd"), 0.0)
    seen = set()

    def gemm(what, record, m, n, k, ta=False, tb=False, odt=None):
        if (m, n, k, ta, tb, odt) in seen:
            return
        seen.add((m, n, k, ta, tb, odt))
        a = _operand(torch, randn, m, n, ta, bf)
        b = _operand(torch, randn, n, k, tb, bf, scale=n ** -0.5)
        before = tatp_dot.launches_by_path["wgmma"]
        got = tatp_dot(a, b, out_dtype=odt)
        torch.cuda.synchronize()
        need(tatp_dot.launches_by_path["wgmma"] == before + 1,
             f"{what} [{m},{n}]@[{n},{k}]: did not take wgmma")
        errs[record] = max(errs[record], compare(
            f"bf16 {what} [{m},{n}]{'.T' if ta else ''}@[{n},{k}]"
            f"{'.T' if tb else ''} -> {str(got.dtype)[6:]} (wgmma)", got,
            matmul_ref(a, b, out_dtype=odt), *GEMM_TOL["bfloat16"]))

    def heads(b, hq, hkv, d, sq, skv, cap):
        return [randn(b, n, h, d, dtype=bf, scale=c).transpose(1, 2)
                for h, n, c in ((hq, sq, cap_scale(cap)), (hkv, skv, 1.0),
                                (hkv, skv, 1.0), (hq, sq, 1.0))]

    def flash(what, b, hq, hkv, d, sq, skv, causal, window, cap, train):
        key = (b, hq, hkv, d, sq, skv, causal, window, cap, train)
        if key in seen:
            return
        seen.add(key)
        q, k, v, do = heads(b, hq, hkv, d, sq, skv, cap)
        kw = dict(causal=causal, window=window, cap=cap)
        name = (f"bf16 {what} [{b},{hq},{sq},{d}] kv {hkv}x{skv} "
                f"{'causal' if causal else 'non-causal'} window {window} "
                f"cap {cap}")
        bwd = _path(bf, d)
        before = (attention.launches_by_path["mma"],
                  attention_bwd.launches_by_path[bwd])
        if not train:
            errs["flash_attention"] = max(errs["flash_attention"], compare(
                f"{name} (mma)", attention(q, k, v, **kw),
                attention_ref(q, k, v, **kw), *ATTN_TOL["bfloat16"],
                rms="row"))
            need(attention.launches_by_path["mma"] == before[0] + 1,
                 f"{name}: did not take mma")
            return
        got = flash_grads(torch, attention, q, k, v, do, **kw)
        ref = flash_grads(torch, attention_ref, q, k, v, do, **kw)
        torch.cuda.synchronize()
        need((attention.launches_by_path["mma"],
              attention_bwd.launches_by_path[bwd])
             == (before[0] + 1, before[1] + 1),
             f"{name}: forward did not take mma or backward {bwd}")
        for part, g, r in zip(("o", "dq", "dk", "dv"), got, ref):
            rec = "flash_attention" if part == "o" else "flash_attention_bwd"
            errs[rec] = max(errs[rec], compare(
                f"{name} {part} ({'mma' if part == 'o' else bwd})", g, r,
                *ATTN_TOL["bfloat16"],
                rms="row" if part == "o" else "tensor" if cap else None))

    log("[kernels] every kernel at the main paths' shapes, from their "
        "configs")
    for arch, spec in PATHS.items():
        cfg, s = get_config(arch), spec["prompt_len"]
        b = spec.get("batch", BATCH)
        for (m, n, k) in linear_shapes(cfg, b * s, b * cfg.frontend_tokens):
            gemm(f"{arch} prefill", "tatp_matmul", m, n, k)
        for shape in attention_shapes(cfg, s, cfg.frontend_tokens):
            flash(f"{arch} prefill", b, *shape, False)
    b, s = TRAIN["batch"], TRAIN["seq"]
    for arch in [a for a, _ in TRAIN_RUNS] + list(TRAIN_SHAPES_ONLY):
        cfg = get_config(arch)
        for (m, n, k) in linear_shapes(cfg, b * s, b * cfg.frontend_tokens):
            gemm(f"{arch} train fwd", "tatp_matmul", m, n, k)
            gemm(f"{arch} train dgrad", "tatp_matmul_dgrad", m, k, n,
                 tb=True)
            gemm(f"{arch} train wgrad", "tatp_matmul_wgrad", n, m, k,
                 ta=True)
        # the head: x [M, D] @ w [D, Vp] -> fp32; its cotangent's three
        # bf16 terms stacked [3M, Vp] @ w.T -> fp32; [x; x; x].T @ them ->
        # bf16.  A tied head's w is the embedding [Vp, D] transposed.
        m = b * s
        d, vp, tied = cfg.d_model, padded_vocab(cfg), cfg.tie_embeddings
        gemm(f"{arch} lm head fwd", "tatp_matmul", m, d, vp, tb=tied,
             odt=f32)
        gemm(f"{arch} lm head dgrad", "tatp_matmul_dgrad", 3 * m, vp, d,
             tb=not tied, odt=f32)
        gemm(f"{arch} lm head wgrad", "tatp_matmul_wgrad", d, 3 * m, vp,
             ta=True, odt=bf)
        for shape in attention_shapes(cfg, s, cfg.frontend_tokens):
            flash(f"{arch} train", b, *shape, True)
    log(f"  {len(seen)} shapes; max_abs_err by record: {json.dumps(errs)}")
    return errs


def counters():
    """The kernel wrappers, by kernel name (each counts its own launches
    in ``.launches``): the three forward kernels and the backward kernels
    of flash attention and the SSD."""
    from repro_torch.kernels.flash_attention.ops import (attention,
                                                         attention_bwd)
    from repro_torch.kernels.ssd.ops import (ssd_intra_chunk,
                                             ssd_intra_chunk_bwd)
    from repro_torch.kernels.tatp_matmul.ops import tatp_dot
    return {"tatp_matmul": tatp_dot, "flash_attention": attention,
            "ssd": ssd_intra_chunk, "flash_attention_bwd": attention_bwd,
            "ssd_bwd": ssd_intra_chunk_bwd}


def read_launches():
    return {name: fn.launches for name, fn in counters().items()}


def read_paths():
    """Launches by kernel path, for the wrappers that choose one."""
    return {name: dict(fn.launches_by_path) for name, fn in counters().items()
            if hasattr(fn, "launches_by_path")}


def read_layouts():
    """The GEMM's launches by operand layout pair."""
    return dict(counters()["tatp_matmul"].launches_by_layout)


def zero_launches():
    for fn in counters().values():
        fn.launches = 0
        if hasattr(fn, "launches_delta_in"):
            fn.launches_delta_in = 0
        for attr in ("launches_by_path", "launches_by_layout"):
            for key in getattr(fn, attr, {}):
                getattr(fn, attr)[key] = 0


def model_blocks(cfg):
    """The model's blocks in call order as (part, layer kind): an
    encoder-decoder's encoder blocks (``enc``, ``G``: bidirectional
    attention + MLP), then every decoder slot (``dec``) followed, in an
    encoder-decoder, by a cross-attention block after each ``G`` slot
    (``cross``, ``X``)."""
    out = [("enc", "G")] * cfg.n_enc_layers
    for kind in cfg.pattern_for_layers():
        out.append(("dec", kind))
        if cfg.n_enc_layers and kind == "G":
            out.append(("cross", "X"))
    return out


def slot_linears(cfg, kind):
    """The GEMM-kernel linears of one block: a Mamba-2 slot's in_proj and
    out_proj; a cross-attention block's four attention linears; an
    attention slot's four attention linears and its MLP's (three gated,
    two not), or none for a MoE FFN (torch products, as the reference's
    einsums)."""
    from repro_torch.models.common import is_gated
    if kind == "M":
        return 2
    if kind == "X" or (cfg.is_moe and kind != "S"):
        return 4
    return 4 + (3 if is_gated(cfg.act) else 2)


# the parameter leaves that a prefill or train linear multiplies on the GEMM
# kernel (a MoE FFN's expert leaves are 3-D and run in torch)
GEMM_LEAVES = ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down", "in_proj",
               "out_proj")


def linear_shapes(cfg, tokens, frames=0):
    """``{(M, N, K): launches per prefill}`` of the linears on the GEMM
    kernel, from the config's parameter shapes, with ``tokens`` (batch x
    sequence) rows and ``frames`` (batch x encoder frames) rows for the
    encoder's linears and the cross blocks' wk and wv: every attention
    slot's wq wk wv wo and its MLP's (none for a MoE FFN), every Mamba-2
    slot's in_proj and out_proj.  They sum to :func:`prefill_launches`'
    GEMM count."""
    from repro_torch.models.transformer import _block_shapes
    out = {}
    for part, kind in model_blocks(cfg):
        for name, shape in _block_shapes(cfg, kind).items():
            leaf = name.split(".")[-1]
            if leaf in GEMM_LEAVES and len(shape) == 2:
                m = frames if part == "enc" or (
                    part == "cross" and leaf in ("wk", "wv")) else tokens
                out[(m, *shape)] = out.get((m, *shape), 0) + 1
    need(sum(out.values()) == prefill_launches(cfg)["tatp_matmul"],
         f"{cfg.name}: linear shapes {out} miss a GEMM of the prefill")
    return out


def attention_shape(cfg, part, kind, seq, frames=0):
    """The flash call ``(Hq, Hkv, D, Sq, Skv, causal, window, cap)`` of one
    attention block (``models/transformer.py:attn_block``; ``part`` and
    ``kind`` as :func:`model_blocks` gives them) at a decoder sequence
    ``seq`` and ``frames`` encoder frames: the encoder's bidirectional
    self-attention, a decoder slot's causal self-attention (an ``L``
    slot's windowed) or a cross block's unmasked attention of the
    decoder's queries to the frames."""
    sq, skv = (frames, frames) if part == "enc" else (
        (seq, frames) if part == "cross" else (seq, seq))
    return (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, sq, skv,
            part == "dec", cfg.sliding_window if kind == "L" else None,
            cfg.attn_softcap)


def attention_shapes(cfg, seq, frames=0):
    """The distinct flash calls (:func:`attention_shape`) over the model's
    attention blocks."""
    return sorted({attention_shape(cfg, part, kind, seq, frames)
                   for part, kind in model_blocks(cfg) if kind != "M"},
                  key=str)


def attn_pairs(sq, skv, causal, window, q_offset=0):
    """The (query, key) pairs one head attends under the flash kernel's
    masks (query row q at position q + ``q_offset``, key k at k: causal
    ``k <= q + q_offset``, ``q + q_offset - k < window``)."""
    n = 0
    for q in range(q_offset, q_offset + sq):
        hi = min(skv - 1, q) if causal else skv - 1
        lo = max(0, q - window + 1) if window else 0
        n += max(0, hi - lo + 1)
    return n


def prefill_launches(cfg):
    """Kernel launches of one prefill: per attention block (encoder, G, L,
    S or cross) its linears (:func:`slot_linears`) and one flash; per
    Mamba-2 slot in_proj, out_proj and one SSD pass."""
    n = {"tatp_matmul": 0, "flash_attention": 0, "ssd": 0,
         "flash_attention_bwd": 0, "ssd_bwd": 0}
    for _, kind in model_blocks(cfg):
        n["tatp_matmul"] += slot_linears(cfg, kind)
        if kind == "M":
            n["ssd"] += 1
        else:
            n["flash_attention"] += 1
    return n


def serve_bundle(torch, cfg, **hooks):
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.core.dist import Dist
    from repro_torch.train.train_loop import make_serve_fns
    return make_serve_fns(cfg, ParallelConfig(strategy="tatp", remat=False),
                          Dist(torch.device("cuda")), **hooks)


# (arch, layers, batch, prompt) of the fp32 parity runs; the SSM prompts
# are two 256-token chunks, so the inter-chunk recurrence runs; gemma2-9b's
# two layers are L then G, its prompt past the 4096 window; internvl2-1b's
# prompt holds its 256 prefix positions; seamless-m4t-large-v2 has 2
# encoder and 2 decoder layers over its 1024 stub frames
PARITY = (("deepseek-7b", 2, 2, 128), ("mamba2-780m", 2, 2, 512),
          ("zamba2-2.7b", 6, 2, 512), ("olmoe-1b-7b", 2, 2, 128),
          ("gemma2-9b", 2, 1, 4608), ("internvl2-1b", 2, 2, 512),
          ("seamless-m4t-large-v2", 2, 2, 128))
# a routing choice whose k-th and (k+1)-th expert probabilities lie closer
# than this is a near-tie: fp32 rounding (~1e-6 between the kernel and
# plain paths) may flip it
NEAR_TIE = 1e-5


def check_routing(what, got, want):
    """Every MoE call's expert ids and keep mask, kernel run against plain
    run, call by call (a train step's list holds each layer's forward,
    then the backward's recompute in reverse layer order).  A differing
    token is reported with its call, its layer (recorded by the call) and
    the plain run's margin; the check fails unless every such token is a
    near-tie."""
    import torch
    need(len(got) == len(want) and got, f"{what}: {len(got)} routed MoE "
         f"calls vs {len(want)}")
    flips = []
    for i, (g, w) in enumerate(zip(got, want)):
        need((g.cap, g.layer) == (w.cap, w.layer),
             f"{what}: call {i} capacity {g.cap} vs {w.cap}, layer "
             f"{g.layer} vs {w.layer}")
        rows = (g.experts != w.experts).any(dim=1)
        rows |= (g.keep != w.keep).reshape(rows.shape[0], -1).any(dim=1)
        for t in torch.nonzero(rows).flatten().tolist():
            flips.append(dict(call=i, layer=g.layer, token=t,
                              margin=w.margin[t].item(),
                              kernel=g.experts[t].tolist(),
                              plain=w.experts[t].tolist()))
    if flips:
        log(f"  routing {what}: {len(flips)} tokens differ: "
            f"{json.dumps(flips[:8])}")
        need(all(f["margin"] < NEAR_TIE for f in flips),
             f"{what}: routing differs away from a near-tie")
    else:
        margin = min(r.margin.min().item() for r in want)
        log(f"  routing {what}: expert ids and keep masks identical in all "
            f"{len(got)} MoE calls (smallest margin {margin:.3e}; "
            f"capacities {sorted({r.cap for r in want})})")
    return flips


def parity_config(arch, n_layers, **overrides):
    """``arch`` at full width in fp32 with ``n_layers`` layers (and as
    many encoder layers, for an encoder-decoder), and ``overrides``."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    cfg = replace(get_config(arch), n_layers=n_layers, dtype="float32",
                  **overrides)
    if cfg.n_enc_layers:
        cfg = replace(cfg, n_enc_layers=n_layers)
    return cfg


def phase_parity(torch, arch, n_layers, b, s, steps=4):
    """Full width, ``n_layers`` layers, fp32: kernels vs plain versions, on
    the serve driver's prompts and stub embeddings (``prompt_batch``),
    drawn from ``RandomState(1)``."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.tatp_matmul.ref import matmul_ref
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import lm
    from repro_torch.models.ssm import ssd_chunked
    from repro_torch.models.transformer import init_params

    dev = torch.device("cuda")
    cfg = parity_config(arch, n_layers)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                         dev)
    routes = ([], [])
    kern = serve_bundle(torch, cfg, routing=routes[0])
    plain = serve_bundle(torch, cfg, dot=matmul_ref,
                         attention=attention_ref, ssd=ssd_chunked,
                         routing=routes[1])
    batch = {name: torch.as_tensor(a, device=dev)
             for name, a in prompt_batch(cfg, b, s, seed=1).items()}
    runs = []
    for sb in (kern, plain):
        zero_launches()
        caches, logits = sb.prefill_fn(params, batch)
        torch.cuda.synchronize()
        launched = read_launches()
        for name, by_path in read_paths().items():
            need(by_path["simt"] == launched[name],
                 f"fp32 {name} launches by path {by_path}: not all simt")
        big = lm.graft_cache_slots(lm.init_cache(sb.ctx, b, s + steps),
                                   caches, slots=range(b))
        tok = logits[:, -1:, :].argmax(dim=-1) % cfg.vocab_size
        out = [(logits[:, -1], tok)]
        for i in range(steps):
            cl = torch.full((b,), s + i + 1, device=dev)
            tok, lg, big = sb.decode_fn(params, tok, big, cl)
            out.append((lg[:, -1], tok))
        need(read_launches() == launched, "decode launched a kernel")
        runs.append((launched, out))
    need(runs[0][0] == prefill_launches(cfg),
         f"kernel prefill launched {runs[0][0]}, want "
         f"{prefill_launches(cfg)}")
    need(not any(runs[1][0].values()), f"plain prefill launched "
         f"{runs[1][0]}")
    log(f"[parity] {arch} full width, {cfg.n_layers} layers, fp32, "
        f"batch {b}, prompt {s}, {steps} decode steps; kernel launches "
        f"{runs[0][0]}")
    for i, ((lk, tk), (lp, tp)) in enumerate(zip(runs[0][1], runs[1][1])):
        what = "prefill" if i == 0 else f"decode step {i}"
        compare(f"{what} logits", lk, lp, 1e-3, 1e-3)
        need(torch.equal(tk, tp), f"{what}: greedy tokens differ "
             f"{tk.flatten().tolist()} vs {tp.flatten().tolist()}")
    log(f"  greedy tokens identical: "
        f"{[t.flatten().tolist() for _, t in runs[0][1]]}")
    if cfg.is_moe:
        check_routing("prefill and decode", *routes)
    del params
    torch.cuda.empty_cache()


def expert_products(torch, cfg):
    """One MoE layer's up product ``[E, cap, D] @ [E, D, F]``, bf16
    operands with fp32 accumulation, at the capacities of the serve
    path's decode (batch 4 tokens) and prefill (batch x prompt) and of
    the train path (batch x seq): the port's form
    (``models/moe.py:expert_bmm``, one cuBLAS ``bmm`` with an fp32 output)
    against a ``bmm`` of fp32 upcasts (the same function), device ms of
    each beside the bound of the bf16 product, and their largest
    difference.  Torch products both, as the reference's einsums."""
    from repro_torch.models.moe import capacity, expert_bmm

    g = torch.Generator(device="cuda").manual_seed(0)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    w = torch.randn(e, d, f, device="cuda", generator=g).bfloat16()
    tokens = {"decode": BATCH, "prefill": BATCH * PATHS[cfg.name][
        "prompt_len"], "train": M_TRAIN}
    rows = {}
    for phase, t in tokens.items():
        cap = capacity(t, cfg.top_k, e, cfg.capacity_factor)
        a = torch.randn(e, cap, d, device="cuda", generator=g).bfloat16()
        got, ref = expert_bmm(a, w), torch.bmm(a.float(), w.float())
        need(got.dtype == torch.float32, "expert_bmm's output is not fp32")
        row = dict(capacity=cap,
                   ms=time_ms(torch, lambda: expert_bmm(a, w)),
                   upcast_ms=time_ms(torch, lambda: torch.bmm(a.float(),
                                                              w.float())),
                   max_abs_diff=(got - ref).abs().max().item(),
                   max_abs=ref.abs().max().item())
        need(row["max_abs_diff"] <= 1e-5 * row["max_abs"],
             f"expert products at capacity {cap}: the two forms differ")
        row["bound_ms"], row["bound_by"] = bound(
            2 * e * cap * d * f, 2 * (e * cap * d + e * d * f)
            + 4 * e * cap * f, "bfloat16")
        rows[phase] = row
    return rows


def phase_main_path(torch, arch, keep=None):
    """One-shot serve of ``arch`` (all layers, bf16) through the entry
    point a user calls; the launch counts cover exactly this run.  A dict
    ``keep`` gets its generated ``tokens`` and its prefill's last
    ``logits`` (on the host), which phase 11's ring is held to."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import prompt_batch, serve
    from repro_torch.models import lm
    from repro_torch.models.transformer import init_params, padded_vocab

    t_path = time.perf_counter()
    dev = torch.device("cuda")
    spec = PATHS[arch]
    full = get_config(arch)
    need(full.n_layers == spec["n_layers"],
         f"{arch} has {full.n_layers} layers, not {spec['n_layers']}")
    cut = spec.get("cut")
    cfg = replace(full, n_layers=cut or full.n_layers)
    need(prefill_launches(cfg) == spec["launches"],
         f"{arch}: layer pattern gives {prefill_launches(cfg)}")
    bsz = spec.get("batch", BATCH)
    run = dict(batch=bsz, prompt_len=spec["prompt_len"], gen=SERVE_GEN)
    args = Namespace(arch=arch, reduced=False, device="cuda", layers=cut,
                     **run)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()

    zero_launches()
    t0 = time.perf_counter()
    res = serve(args, params=params, keep_tokens=keep is not None)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    paths = read_paths()
    peak = torch.cuda.max_memory_allocated()
    if keep is not None:
        keep["tokens"] = res.pop("tokens")

    need(launches == spec["launches"],
         f"{arch}: launches {launches} != {spec['launches']}")
    # every GEMM on wgmma + TMA, every flash on the tensor cores
    for name, path in MAIN_PATH_KERNEL.items():
        need(paths[name][path] == launches[name],
             f"{arch}: {name} launches by path {paths[name]}, want all "
             f"{launches[name]} on {path}")
    need(res["generated_shape"] == [bsz, SERVE_GEN + 1],
         f"generated shape {res['generated_shape']}")
    need(all(0 <= t < cfg.vocab_size for t in res["sample"]),
         f"token out of range in {res['sample']}")
    need(math.isfinite(res["tokens_per_s"]) and res["tokens_per_s"] > 0,
         "bad tokens/s")

    # prefill time and output check, after the counted run
    sb = serve_bundle(torch, cfg)
    batch = {name: torch.as_tensor(a, device=dev) for name, a in
             prompt_batch(cfg, bsz, run["prompt_len"]).items()}
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        caches, logits = sb.prefill_fn(params, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    need(tuple(logits.shape) == (bsz, 1, padded_vocab(cfg))
         and logits.dtype == torch.float32, f"logits {logits.shape}")
    need(bool(logits.isfinite().all()), "non-finite prefill logits")
    need(all(bool(t.isfinite().all()) for c in caches.values()
             for t in c.values()), "non-finite cache")
    first = (logits[:, -1].argmax(-1) % cfg.vocab_size)[0].item()
    need(first == res["sample"][0], "prefill is not deterministic")
    if keep is not None:
        keep["logits"] = logits[:, -1].float().cpu()

    # where the time goes: one prefill, then a decode step as serve runs
    # it (its token to the host; 4 steps until phase 13's part (e) needed
    # the time, 2 until the whole run did: the profiler's cost scales with
    # the host ops, 2.3-4.9 s a window of 2 steps on the card's host)
    steps = 1
    big = lm.graft_cache_slots(
        lm.init_cache(sb.ctx, bsz, run["prompt_len"] + steps),
        caches, slots=range(bsz))
    state = [logits[:, -1:].argmax(-1) % cfg.vocab_size, big]

    def decode_steps():
        for i in range(steps):
            cl = torch.full((bsz,), run["prompt_len"] + i + 1,
                            device=dev)
            tok, _, state[1] = sb.decode_fn(params, state[0], state[1], cl)
            state[0] = tok
            tok.cpu()

    prof = dict(prefill=profile_window(
                    torch, lambda: sb.prefill_fn(params, batch)),
                decode_step=profile_window(torch, decode_steps))
    need(all(bool(t.isfinite().all()) for c in state[1].values()
             for t in c.values()), "non-finite cache after decode")
    out = dict(serve=res, layers=cfg.n_layers,
               depth_cut=f"{full.n_layers} -> {cfg.n_layers} layers"
               if cut else "none", launches=launches, launches_by_path=paths,
               prefill_ms=sorted(times)[1], prefill_ms_runs=times,
               peak_mem_gb=peak / 1e9, init_s=init_s, serve_wall_s=wall_s,
               profile=prof)
    if cfg.is_moe:
        out["expert_products"] = expert_products(torch, cfg)
    out["path_s"] = time.perf_counter() - t_path
    log(f"[main path] {arch} {cfg.n_layers} layers bf16 batch {bsz} "
        f"prompt {run['prompt_len']} gen {SERVE_GEN}: {json.dumps(out)}")
    del params, caches, state, big
    release(torch)
    return launches, paths


def train_launches(cfg, remat, saved=False):
    """Kernel launches of one train step: per layer its linears' forward
    (again in the backward under remat), dgrad and wgrad; per attention
    block (G, L, S, an encoder's or a cross block: the four attention
    linears and the MLP's, three gated or two; a cross block's four) one
    flash forward (again under remat) and one flash backward; per Mamba-2
    slot (in_proj, out_proj) one SSD forward (again under remat) and one
    SSD backward; the lm head's forward, dgrad and wgrad once (with tied
    embeddings its forward reads the embedding transposed and its dgrad
    reads it row-major, so the layout counts are the same).  A MoE slot's
    linears are its four attention linears (:func:`slot_linears`).  With
    ``saved`` (the ``tatp_outputs`` remat policy) the decoder's recompute
    runs no linear and no flash forward; an encoder is recomputed in full
    under either policy.  Returns (launches by kernel, GEMM launches by
    layout pair)."""
    per = 2 if remat else 1
    dec = 1 if saved else per
    lin = {"enc": 0, "dec": 0}
    attn = {"enc": 0, "dec": 0}
    mamba = 0
    for part, kind in model_blocks(cfg):
        side = "enc" if part == "enc" else "dec"
        lin[side] += slot_linears(cfg, kind)
        if kind == "M":
            mamba += 1
        else:
            attn[side] += 1
    linears = lin["enc"] + lin["dec"]
    fwd = dec * lin["dec"] + per * lin["enc"] + 1
    n = {"tatp_matmul": fwd + 2 * (linears + 1),
         "flash_attention": dec * attn["dec"] + per * attn["enc"],
         "ssd": per * mamba, "flash_attention_bwd": attn["enc"] + attn["dec"],
         "ssd_bwd": mamba}
    return n, {"fwd": fwd, "dgrad": linears + 1, "wgrad": linears + 1,
               "both": 0}


def release(torch):
    """Free a phase's tensors before the next phase measures its peak: the
    first checkpointed step imports inside torch, and the traceback kept
    by that import holds the step's frames (and so its tensors) in a
    reference cycle that only the collector frees."""
    gc.collect()
    torch.cuda.empty_cache()


def _leaves(tree):
    from repro_torch.train.optimizer import tree_leaves
    return list(tree_leaves(tree))


def named_grads(bundle, params, batch):
    """The train step's loss and gradients (by leaf name) on ``params``,
    without the optimizer."""
    from repro_torch.train.train_loop import loss_and_grads
    nll, cnt, grads = loss_and_grads(bundle.ctx, params, batch)
    return nll / cnt, {"/".join(k): g for k, g in _leaves(grads)}


# the fp32 train parity runs at full width, 2 steps each: (arch, layers,
# batch, seq).  The SSM runs take two 256-token chunks a row, so the
# inter-chunk recurrence's gradient runs; zamba2's 6 layers are one
# MMMMMS unit; gemma2-9b's L and G layers run past the 4096 window;
# internvl2-1b's rows hold its 256 prefix positions; seamless-m4t-large-v2
# has 2 encoder layers over 1024 frames a row and 2 decoder layers.  Each
# gradient leaf within GRAD_REL_TOL relative L2 error of the plain path's.
TRAIN_PARITY = (("deepseek-7b", 2, 2, 256), ("mamba2-780m", 2, 2, 512),
                ("zamba2-2.7b", 6, 2, 512), ("olmoe-1b-7b", 2, 2, 256),
                ("gemma2-9b", 2, 1, 4608), ("internvl2-1b", 2, 2, 512),
                ("seamless-m4t-large-v2", 2, 2, 256))
TRAIN_PARITY_STEPS = 2
GRAD_REL_TOL = 1e-4


def phase_train_parity(torch, arch, n_layers, batch, seq):
    """``arch`` at full width, ``n_layers`` layers, fp32 (TF32 off), remat
    on: the train step through the kernels (every GEMM on simt, flash
    forward and backward on simt, the SSD on its forward and backward
    kernels) against the same step with the hooks swapped to the plain
    versions (the plain chunked SSD: autograd through its NaN-safe jnp
    mirror), on the same parameters and batches: the loss, every gradient
    leaf (relative L2 error), and the parameters after 2 AdamW steps
    (atol = 2 * sum(lr_t): Adam's first steps are ~lr * sign(g), so where
    g ~ 0 two right answers differ by up to 2 lr_t)."""
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.core.dist import Dist
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.tatp_matmul.ref import matmul_ref
    from repro_torch.models.ssm import ssd_chunked
    from repro_torch.models.transformer import init_params
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.optimizer import tree_map
    from repro_torch.train.train_loop import make_train_step

    dev = torch.device("cuda")
    cfg = parity_config(arch, n_layers)
    par = ParallelConfig(strategy="tatp", remat=True)
    dist = Dist(dev)
    shape = ShapeConfig("parity", "train", seq, batch)
    routes = ([], [])
    kern = make_train_step(cfg, par, dist, shape, routing=routes[0])
    plain = make_train_step(cfg, par, dist, shape, dot=matmul_ref,
                            attention=attention_ref, ssd=ssd_chunked,
                            routing=routes[1])
    data = SyntheticDataset(cfg, shape, dist, seed=1)
    batches = [data.batch(i) for i in range(TRAIN_PARITY_STEPS)]
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(1), dev)
    want, want_layouts = train_launches(cfg, remat=True)

    zero_launches()
    loss_k, grads_k = named_grads(kern, params, batches[0])
    torch.cuda.synchronize()
    need(read_launches() == want, f"fp32 kernel train step launched "
         f"{read_launches()}, want {want}")
    need(read_layouts() == want_layouts, f"fp32 GEMM layouts "
         f"{read_layouts()}, want {want_layouts}")
    for name, by_path in read_paths().items():
        need(by_path["simt"] == want[name],
             f"fp32 {name} launches by path {by_path}: not all simt")
    zero_launches()
    loss_p, grads_p = named_grads(plain, params, batches[0])
    need(not any(read_launches().values()),
         f"plain train step launched {read_launches()}")
    log(f"[train parity] {arch} full width, {cfg.n_layers} layers, "
        f"fp32, batch {batch} x seq {seq}, remat; kernel launches {want}, "
        f"by layout {want_layouts}")
    compare("train loss", loss_k, loss_p, 1e-5, 1e-5)
    rel = {}
    for name, gk in grads_k.items():
        gp = grads_p[name]
        need(bool(gk.isfinite().all()), f"grad {name}: non-finite")
        rel[name] = ((gk - gp).norm() / gp.norm().clamp_min(1e-30)).item()
    leaf = max(rel, key=rel.get)
    log(f"  gradient leaves: {len(rel)}, worst relative L2 error "
        f"{rel[leaf]:.3e} ({leaf}); all: {json.dumps(rel)}")
    need(rel[leaf] <= GRAD_REL_TOL,
         f"grad {leaf}: relative error {rel[leaf]:.3e} > {GRAD_REL_TOL}")
    del grads_k, grads_p
    if cfg.is_moe:  # the forward's and the recompute's routing
        check_routing("train step", *routes)

    # two AdamW steps each, from the same parameters
    params_k = tree_map(lambda t: t.clone(), params)
    runs = []
    for bundle, p in ((kern, params_k), (plain, params)):
        state = bundle.opt.init(p)
        lrs, losses = [], []
        for b in batches:
            p, state, m = bundle.step_fn(p, state, b)
            lrs.append(float(m["lr"]))
            losses.append(float(m["loss"]))
        runs.append((lrs, losses))
        del state
        torch.cuda.empty_cache()
    need(runs[0][0] == runs[1][0], f"lr differs {runs[0][0]} {runs[1][0]}")
    atol = 2 * sum(runs[0][0])
    worst = 0.0
    for (name, pk), (_, pp) in zip(_leaves(params_k), _leaves(params)):
        err = (pk - pp).abs().max().item()
        worst = max(worst, err)
        need(err <= atol, f"param {'/'.join(name)} after "
             f"{TRAIN_PARITY_STEPS} steps: max_abs_err {err:.3e} > "
             f"{atol:.3e}")
    log(f"  losses kernel {runs[0][1]} plain {runs[1][1]}; params after "
        f"{TRAIN_PARITY_STEPS} steps max_abs_err {worst:.3e} (atol "
        f"{atol:.3e})")
    del params, params_k
    release(torch)
    return dict(loss=loss_k.item(), worst_grad_rel=max(rel.values()),
                param_max_abs_err=worst, param_atol=atol)


def mfu(step_s, cfg, batch, seq):
    """Model FLOPs utilisation at the card's bf16 peak: 6 * rows * the
    parameters of every product (each slot's linears over the tokens,
    zamba2's shared block once per use, an encoder's linears over its
    frames, a cross block's wq and wo over the tokens and wk and wv over
    the frames, and the lm head; the embedding is a lookup), plus
    attention's products over the pairs each head attends (forward
    4 * pairs * D, backward twice that: causal pairs in a decoder slot,
    limited to the window in an ``L`` slot, all S^2 pairs in the encoder,
    Sq x Skv in a cross block), plus the SSD's intra-chunk products in
    each Mamba-2 slot (forward as ``ssd_bound`` and backward as
    ``ssd_bwd_work`` count them; the inter-chunk recurrence is not
    counted).  A MoE slot counts its active parameters: the attention
    linears, the router and the ``top_k`` experts each token runs
    (capacity padding and dropped tokens are not model work).  Remat's
    recompute is not model work.  Returns (MFU, model flops, product
    parameters)."""
    from repro_torch.models.common import is_gated
    from repro_torch.models.transformer import padded_vocab
    d, frames = cfg.d_model, cfg.frontend_tokens if cfg.n_enc_layers else 0
    tok, frm = batch * seq, batch * frames
    qo, kv = 2 * d * cfg.q_dim, 2 * d * cfg.kv_dim
    ffn = (3 if is_gated(cfg.act) else 2) * d * cfg.d_ff
    moe_slot = qo + kv + d * cfg.n_experts + cfg.top_k * ffn
    mamba_slot = (d * (2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads)
                  + cfg.d_inner * d)
    head = d * padded_vocab(cfg)
    n_params, flops, extra = head, 6 * tok * head, 0
    per_head = 3 * 4 * batch * cfg.head_dim * cfg.n_heads
    for part, kind in model_blocks(cfg):
        if kind == "M":
            n_params += mamba_slot
            flops += 6 * tok * mamba_slot
            ssd = (tok // cfg.ssm_chunk, cfg.ssm_chunk, cfg.ssm_heads,
                   cfg.ssm_head_dim, cfg.ssm_state)
            extra += ssd_bound(*ssd)[2] + ssd_bwd_work(*ssd)[0]
        elif part == "enc":
            n_params += qo + kv + ffn
            flops += 6 * frm * (qo + kv + ffn)
            extra += per_head * attn_pairs(frames, frames, False, None)
        elif part == "cross":
            n_params += qo + kv
            flops += 6 * (tok * qo + frm * kv)
            extra += per_head * attn_pairs(seq, frames, False, None)
        else:
            slot = moe_slot if cfg.is_moe and kind != "S" else qo + kv + ffn
            n_params += slot
            flops += 6 * tok * slot
            window = cfg.sliding_window if kind == "L" else None
            extra += per_head * attn_pairs(seq, seq, True, window)
    flops += extra
    return flops / step_s / PEAK_FLOPS["bfloat16"], flops, n_params


def phase_train_main(torch, arch, n_layers):
    """A bf16 main train path: ``arch`` at full width with ``n_layers``
    layers, batch 4 x seq 512, the reference's defaults (remat on,
    AdamWConfig()), through make_train_step and SyntheticDataset, 3 steps.
    Launch counts are zeroed before each step and must be exactly one
    step's after it (train_launches: every SSD backward on its kernel),
    every GEMM on wgmma and every flash forward and backward on mma;
    losses and grad norms finite; then 3 steps on one fixed batch must
    lower its loss.  Reports step ms (host clock), tokens/s, MFU, peak GB,
    the device time of the gradients and of the AdamW update, and a
    profiler window of one step with the device time by kernel family."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.core.dist import Dist
    from repro_torch.models import lm
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.train_loop import loss_and_grads, make_train_step

    t_path = time.perf_counter()
    dev = torch.device("cuda")
    full = get_config(arch)
    cfg = replace(full, n_layers=n_layers)
    need(cfg.dtype == "bfloat16", f"{arch} dtype {cfg.dtype}")
    par = ParallelConfig(strategy="tatp")  # remat on, as the reference
    need(par.remat, "the reference's default trains with remat")
    dist = Dist(dev)
    shape = ShapeConfig("train", "train", TRAIN["seq"], TRAIN["batch"])
    bundle = make_train_step(cfg, par, dist, shape)
    data = SyntheticDataset(cfg, shape, dist, seed=0)
    want, want_layouts = train_launches(cfg, remat=True)

    t0 = time.perf_counter()
    params, state = bundle.init_fn(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_state = sum(p.numel() for _, p in _leaves(params))
    torch.cuda.reset_peak_memory_stats()
    totals = {name: 0 for name in want}
    layouts = {name: 0 for name in want_layouts}
    by_path = {name: dict.fromkeys(p, 0) for name, p in read_paths().items()}
    losses, gnorms, lrs, step_ms = [], [], [], []
    for step in range(TRAIN["steps"]):
        batch = data.batch(step)
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        params, state, m = bundle.step_fn(params, state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launched, paths, lay = read_launches(), read_paths(), read_layouts()
        need(launched == want, f"train step {step}: launches {launched}, "
             f"want {want}")
        need(lay == want_layouts, f"train step {step}: GEMM layouts {lay}, "
             f"want {want_layouts}")
        for name, path in MAIN_PATH_KERNEL.items():
            need(paths[name][path] == launched[name],
                 f"train: {name} launches by path {paths[name]}, want all "
                 f"on {path}")
        need(math.isfinite(loss) and math.isfinite(gnorm),
             f"train step {step}: loss {loss} grad_norm {gnorm}")
        need(int(m["tokens"]) == TRAIN["batch"] * TRAIN["seq"],
             f"tokens {float(m['tokens'])}")
        for name in totals:
            totals[name] += launched[name]
        for name in layouts:
            layouts[name] += lay[name]
        for name, p in paths.items():
            for key in p:
                by_path[name][key] += p[key]
        losses.append(loss)
        gnorms.append(gnorm)
        lrs.append(float(m["lr"]))
    peak = torch.cuda.max_memory_allocated()
    steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]

    # three steps on one fixed batch lower its loss
    fixed = data.batch(0)
    with torch.no_grad():
        before = lm.loss_fn(bundle.ctx, params, fixed)
        before = (before[0] / before[1]).item()
    for _ in range(3):
        params, state, _ = bundle.step_fn(params, state, fixed)
    with torch.no_grad():
        after = lm.loss_fn(bundle.ctx, params, fixed)
        after = (after[0] / after[1]).item()
    need(math.isfinite(after) and after < before,
         f"3 steps on a fixed batch: loss {before} -> {after}")

    # device time of the step's two halves: the loss and its gradients
    # (forward, recomputed forward and backward), then the AdamW update,
    # each as the profiler's device busy time of one call.  (CUDA events
    # around a call would time the host where a call issues more
    # launches than the launch queue holds, as an SSM step does: the
    # host then waits behind time_ms's spin.)
    batch = data.batch(TRAIN["steps"])
    grads = {}

    def fwd_bwd():
        grads["g"] = loss_and_grads(bundle.ctx, params, batch)[2]

    def update():
        bundle.opt.update(params, grads["g"], state)

    fwd_bwd()  # warm, and the gradients the update reads
    halves = dict(
        loss_and_grads_ms=profile_window(torch, fwd_bwd)["device_busy_ms"],
        adamw_update_ms=profile_window(torch, update)["device_busy_ms"])
    del grads["g"]

    state_box = [params, state]

    def one_step():
        state_box[0], state_box[1], _ = bundle.step_fn(
            state_box[0], state_box[1], batch)

    prof = profile_window(torch, one_step, top=16)
    n_tok = TRAIN["batch"] * TRAIN["seq"]
    util, flops, n_params = mfu(steady / 1e3, cfg, TRAIN["batch"],
                                TRAIN["seq"])
    out = dict(
        layers=cfg.n_layers, published_layers=full.n_layers,
        depth_cut=f"{full.n_layers} -> {cfg.n_layers} layers"
        if cfg.n_layers != full.n_layers else "none",
        batch=TRAIN["batch"], seq=TRAIN["seq"],
        params=n_state, model_params_for_mfu=n_params,
        launches_per_step=want, layouts_per_step=want_layouts,
        losses=losses, grad_norms=gnorms, lrs=lrs,
        fixed_batch_loss=[before, after], step_ms=step_ms,
        step_ms_median_after_first=steady, tokens_per_s=n_tok / steady * 1e3,
        mfu=util, model_flops_per_step=flops, peak_mem_gb=peak / 1e9,
        init_s=init_s, device_ms=halves, profile=prof,
        path_s=time.perf_counter() - t_path)
    log(f"[train main path] {arch} {cfg.n_layers} layers bf16 batch "
        f"{TRAIN['batch']} x seq {TRAIN['seq']}, {TRAIN['steps']} steps: "
        f"{json.dumps(out)}")
    del params, state, state_box
    release(torch)
    return totals, layouts, by_path, out


def phase_tatp_outputs(torch):
    """``remat_policy="tatp_outputs"`` on deepseek-7b, 4 layers at full
    width, bf16, batch 4 x seq 512: one step's loss and gradients against
    full remat's on the same weights and batch, bitwise; each with its
    exact launches (tatp_outputs: 29 forward GEMMs, the recompute running
    none, 29 dgrad, 29 wgrad, 4 flash forwards, 4 backwards; every GEMM
    on wgmma, every flash on mma), and the profiler's device busy time of
    the loss and gradients under each; then 2 steps on one batch under
    each policy from the same parameters (losses bitwise equal), with
    step ms (host clock) and peak GB."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.core.dist import Dist
    from repro_torch.models.transformer import init_params
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.train_loop import make_train_step

    dev = torch.device("cuda")
    cfg = replace(get_config("deepseek-7b"), n_layers=TRAIN["n_layers"])
    dist = Dist(dev)
    shape = ShapeConfig("train", "train", TRAIN["seq"], TRAIN["batch"])
    policies = ("full", "tatp_outputs")
    bundles = {pol: make_train_step(cfg, ParallelConfig(
        strategy="tatp", remat_policy=pol), dist, shape) for pol in policies}
    batch = SyntheticDataset(cfg, shape, dist, seed=0).batch(0)

    def fresh():
        return init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)

    params = fresh()
    grads, counts = {}, {}
    for pol in policies:
        want, want_layouts = train_launches(cfg, remat=True,
                                            saved=pol == "tatp_outputs")
        zero_launches()
        grads[pol] = named_grads(bundles[pol], params, batch)
        torch.cuda.synchronize()
        launched, paths = read_launches(), read_paths()
        need(launched == want, f"{pol}: launches {launched}, want {want}")
        need(read_layouts() == want_layouts, f"{pol}: GEMM layouts "
             f"{read_layouts()}, want {want_layouts}")
        for name, path in MAIN_PATH_KERNEL.items():
            need(paths[name][path] == launched[name],
                 f"{pol}: {name} launches by path {paths[name]}")
        busy = profile_window(torch, lambda: named_grads(
            bundles[pol], params, batch))["device_busy_ms"]
        counts[pol] = dict(launches=launched, layouts=want_layouts,
                           loss_and_grads_device_ms=busy)
    (lf, gf), (lt, gt) = grads["full"], grads["tatp_outputs"]
    need(bool(torch.isfinite(lf)) and torch.equal(lf, lt),
         f"tatp_outputs loss {lt.item()} != full remat's {lf.item()}")
    differ = [n for n in gf if not torch.equal(gf[n], gt[n])]
    need(not differ, f"tatp_outputs gradients differ from full remat's: "
         f"{differ[:5]}")
    log(f"[tatp_outputs] deepseek-7b {cfg.n_layers} layers bf16 batch "
        f"{TRAIN['batch']} x seq {TRAIN['seq']}: loss and all {len(gf)} "
        f"gradient leaves bitwise equal to full remat's; launches "
        f"{json.dumps(counts)}")
    del grads, gf, gt, params
    release(torch)

    runs = {}
    for pol in policies:
        params = fresh()
        state = bundles[pol].opt.init(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, losses = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            params, state, m = bundles[pol].step_fn(params, state, batch)
            losses.append(m["loss"].item())
            ms.append((time.perf_counter() - t0) * 1e3)
        runs[pol] = dict(step_ms=ms, losses=losses,
                         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        del params, state
        release(torch)
    need(runs["full"]["losses"] == runs["tatp_outputs"]["losses"],
         f"2-step losses differ: {runs}")
    log(f"  2 steps on one batch from the same parameters: "
        f"{json.dumps(runs)}")
    return runs


def phase_restart(torch):
    """``repro_torch.launch.train`` on the card, reduced deepseek-7b (fp32):
    an 8-step run with a checkpoint every 2 steps, and a run that fails at
    step 4 (``--fail-at-step``) and is restarted from its checkpoint; the
    final checkpoints (parameters, masters, moments, step) bitwise equal.
    The restored tree lies on the card in the template's dtypes, and a
    bf16 tree on the card round-trips bitwise."""
    import tempfile

    import numpy as np

    from repro_torch.launch.train import main as train_main
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import tree_leaves

    common = ["--arch", "deepseek-7b", "--reduced", "--device", "cuda",
              "--steps", "8", "--batch", "2", "--seq", "32",
              "--ckpt-every", "2", "--log-every", "100"]
    with tempfile.TemporaryDirectory() as tmp:
        straight, failed = f"{tmp}/straight", f"{tmp}/failed"
        train_main(common + ["--ckpt-dir", straight])
        try:
            train_main(common + ["--ckpt-dir", failed, "--fail-at-step",
                                 "4"])
            raised = None
        except RuntimeError as e:  # the simulated failure is the test
            raised = str(e)
        need(raised is not None and "simulated node failure" in raised,
             f"--fail-at-step 4 did not fail the run ({raised})")
        need(ckpt.latest_step(failed) == 4,
             f"failed run's latest checkpoint {ckpt.latest_step(failed)}")
        train_main(common + ["--ckpt-dir", failed])
        need(ckpt.latest_step(failed) == ckpt.latest_step(straight) == 8,
             "restarted run did not reach step 8")
        files = [np.load(f"{d}/step_00000008/proc00.npz")
                 for d in (straight, failed)]
        need(files[0].files == files[1].files, "checkpoint keys differ")
        differ = [k for k in files[0].files
                  if not np.array_equal(files[0][k], files[1][k])]
        n_leaves = len(files[0].files)
        for f in files:
            f.close()
        need(not differ, f"restarted state differs from the straight "
             f"run's: {differ[:5]}")

        # the restore's device and dtypes
        from repro_torch.configs import get_reduced
        from repro_torch.configs.base import ParallelConfig, ShapeConfig
        from repro_torch.core.dist import Dist
        from repro_torch.train.train_loop import make_train_step
        b = make_train_step(get_reduced("deepseek-7b"),
                            ParallelConfig(remat=False),
                            Dist(torch.device("cuda")),
                            ShapeConfig("t", "train", 32, 2))
        template = b.init_fn(torch.Generator(device="cuda").manual_seed(9))
        (p, o), step = ckpt.restore(failed, template)
        leaves = list(tree_leaves({"p": p, "m": o.master, "v": o.v}))
        like = list(tree_leaves({"p": template[0], "m": template[1].master,
                                 "v": template[1].v}))
        need(step == 8 and o.step == 8, f"restored step {step}, {o.step}")
        need(all(t.device.type == "cuda" and t.dtype == u.dtype
                 for (_, t), (_, u) in zip(leaves, like)),
             "restored leaves not on the card in the template's dtypes")
        bf = {"w": torch.randn(64, 48, device="cuda").bfloat16(),
              "b": torch.randn(48, device="cuda").bfloat16()}
        ckpt.save(f"{tmp}/bf16", 1, bf)
        got, _ = ckpt.restore(f"{tmp}/bf16", {k: torch.zeros_like(v)
                                              for k, v in bf.items()})
        need(all(torch.equal(got[k], bf[k]) and got[k].is_cuda
                 and got[k].dtype == torch.bfloat16 for k in bf),
             "bf16 checkpoint round trip on the card is not bitwise")
    log(f"[restart] reduced deepseek-7b on the card: fail at step 4, "
        f"restart from the step-4 checkpoint, final state (all {n_leaves} "
        f"leaves) bitwise equal to a straight 8-step run's; restore on "
        f"cuda in the template's dtypes; bf16 round trip bitwise")
    release(torch)


# the plan-driven launches: one-shot serves under --auto-plan (gemma-7b's
# plan prescribes megatron, run at degree 1), and the train stage that
# --wafers 8 --stage 7 gives deepseek-7b at 4 x 512: the plan's last, 3 of
# its 30 layers before and after the degradation (stage 0's 4 layers, a
# 23 GB checkpoint, until the whole run needed the time)
PLAN_SERVES = ("deepseek-7b", "gemma-7b")
PLAN_TRAIN = dict(arch="deepseek-7b", wafers=8, stage=7, layers=3,
                  fail_wafer=1, failed_dies="3,9")
PLAN_FRESH = "[plan] solved fresh"
PLAN_HIT = "[plan] cache hit (solver skipped): hash "


def captured(fn, *a, **kw):
    """(fn's result, the lines it printed), the lines echoed to the log."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **kw)
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"  | {line}")
    return out, lines


def plan_serve(torch, arch, cache):
    """``launch.serve --arch arch --auto-plan`` twice (a fresh solve, then a
    cache hit) between two runs with the legacy flags on the same weights
    (legacy, plan, plan, legacy, so neither side has the first call):
    identical generated tokens and exactly the legacy run's launches,
    every GEMM on wgmma and every flash on mma.  The launch counts are
    those of the first plan-driven run, zeroed just before it."""
    from repro_torch.configs import get_config
    from repro_torch.core.plan import WaferPlan
    from repro_torch.launch.planning import resolve_plan
    from repro_torch.launch.serve import serve
    from repro_torch.models.transformer import init_params

    dev = torch.device("cuda")
    spec = PATHS[arch]
    cfg = get_config(arch)
    run = dict(batch=spec.get("batch", BATCH), prompt_len=spec["prompt_len"],
               gen=SERVE_GEN)
    legacy_args = Namespace(arch=arch, reduced=False, device="cuda",
                            layers=None, **run)
    plan_args = Namespace(plan=None, auto_plan=True, plan_cache=cache,
                          **vars(legacy_args))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    legacy = serve(legacy_args, params=params, keep_tokens=True)
    runs, counts = [], []
    for _ in range(2):
        zero_launches()
        res, lines = captured(serve, plan_args, params=params,
                              keep_tokens=True)
        torch.cuda.synchronize()
        counts.append((read_launches(), read_paths()))
        runs.append((res, lines))
    legacy_after = serve(legacy_args, params=params, keep_tokens=True)
    need(legacy_after["tokens"] == legacy["tokens"],
         f"{arch}: two legacy runs gave different tokens")
    (fresh, fresh_lines), (hit, hit_lines) = runs
    path, = Path(cache).glob("plan_*.json")
    plan = WaferPlan.load(str(path))
    need(fresh_lines[0].startswith(PLAN_FRESH),
         f"{arch}: first --auto-plan launch logged {fresh_lines[0]!r}")
    need(hit_lines[0] == PLAN_HIT + plan.plan_hash,
         f"{arch}: second launch logged {hit_lines[0]!r}")
    for res in (fresh, hit):
        need(res["tokens"] == legacy["tokens"],
             f"{arch}: plan-driven tokens differ from the legacy flags'")
    for launches, paths in counts:
        need(launches == spec["launches"],
             f"{arch} --auto-plan: launches {launches} != "
             f"{spec['launches']}")
        for name, kpath in MAIN_PATH_KERNEL.items():
            need(paths[name][kpath] == launches[name],
                 f"{arch} --auto-plan: {name} by path {paths[name]}")
    strategy = plan.parallel_config().strategy
    if arch == "gemma-7b":
        need(strategy == "megatron", f"gemma-7b's serve plan is {strategy}")
    # the planning layer alone: a fresh solve and a cache hit, host clock
    import tempfile
    with tempfile.TemporaryDirectory() as solo:
        plan_ms = {}
        for kind in ("fresh", "hit"):
            t0 = time.perf_counter()
            captured(resolve_plan, cfg, run["batch"],
                     run["prompt_len"] + run["gen"], cache_dir=solo,
                     remat=False)
            plan_ms[kind] = (time.perf_counter() - t0) * 1e3
    out = dict(plan_hash=plan.plan_hash, degrees=plan.degrees_tuple(),
               strategy=strategy, remat=plan.remat,
               solver_search_s=plan.solver.get("search_time_s"),
               plan_ms=plan_ms, launches=counts[0][0],
               launches_by_path=counts[0][1],
               ms_per_token={"legacy": legacy["ms_per_token"],
                             "auto_plan_fresh": fresh["ms_per_token"],
                             "auto_plan_hit": hit["ms_per_token"],
                             "legacy_after": legacy_after["ms_per_token"]},
               tokens_per_s={"legacy": legacy["tokens_per_s"],
                             "auto_plan_fresh": fresh["tokens_per_s"],
                             "auto_plan_hit": hit["tokens_per_s"],
                             "legacy_after": legacy_after["tokens_per_s"]},
               tokens_identical=True)
    log(f"[plan] serve {arch} --auto-plan, {cfg.n_layers} layers bf16 batch "
        f"{run['batch']} prompt {run['prompt_len']} gen {run['gen']}: "
        f"{json.dumps(out)}")
    log(f"[plan] serve {arch}: {fresh['ms_per_token']:.1f} and "
        f"{hit['ms_per_token']:.1f} ms/token under --auto-plan (legacy flags "
        f"{legacy['ms_per_token']:.1f} before, "
        f"{legacy_after['ms_per_token']:.1f} after), plan "
        f"{plan.degrees_tuple()} {strategy}")
    del params
    release(torch)
    return counts[0]


def plan_train(torch, cache, ckpt_dir):
    """``launch.train --arch deepseek-7b --wafers 8 --stage 7 --batch 4
    --seq 512 --steps 3 --ckpt-dir``: the MultiWaferPlan's stage 7 holds 3
    layers; each step's loss bitwise equal to ``make_train_step`` on
    ``solver.stage_config(cfg, 3)`` from the launcher's seed; the launches
    exactly 3 steps' (counted over the launch); the manifest records the
    plan hash and the stage.  Then a relaunch with ``--failed-dies`` on
    ``--fail-wafer 1``: a fresh solve in which only wafer 1's stage changes
    hash, and the reference's plan-drift warning."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.core.dist import Dist
    from repro_torch.core.plan import MultiWaferPlan
    from repro_torch.launch.train import build_parser, train
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.train_loop import make_train_step
    from repro_torch.wafer.solver import stage_config

    dev = torch.device("cuda")
    t = PLAN_TRAIN
    argv = ["--arch", t["arch"], "--wafers", str(t["wafers"]), "--stage",
            str(t["stage"]), "--batch", str(TRAIN["batch"]), "--seq",
            str(TRAIN["seq"]), "--steps", str(TRAIN["steps"]), "--device",
            "cuda", "--plan-cache", cache, "--ckpt-dir", ckpt_dir,
            "--log-every", "1"]
    cfg = stage_config(get_config(t["arch"]), t["layers"])
    want, want_layouts = train_launches(cfg, remat=True)
    steps = TRAIN["steps"]

    history = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    summary, lines = captured(train, build_parser().parse_args(argv),
                              history)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, paths, layouts = read_launches(), read_paths(), read_layouts()
    peak = torch.cuda.max_memory_allocated()
    plans = sorted(Path(cache).glob("mwplan_*.json"))
    need(len(plans) == 1, f"plan cache holds {plans}")
    plan = MultiWaferPlan.load(str(plans[0]))
    need(lines[0].startswith(PLAN_FRESH), f"train logged {lines[0]!r}")
    need(plan.pp == t["wafers"] and plan.stage_layers[t["stage"]]
         == t["layers"], f"stage layers {plan.stage_layers}")
    need(summary["plan_hash"] == plan.plan_hash and summary["steps"] == steps,
         f"train summary {summary}")
    need(launches == {k: steps * n for k, n in want.items()},
         f"plan train: launches {launches}, want {steps} x {want}")
    need(layouts == {k: steps * n for k, n in want_layouts.items()},
         f"plan train: GEMM layouts {layouts}")
    for name, kpath in MAIN_PATH_KERNEL.items():
        need(paths[name][kpath] == launches[name],
             f"plan train: {name} by path {paths[name]}")
    meta = ckpt.read_meta(ckpt_dir)
    need(meta == {"plan_hash": plan.plan_hash, "stage": t["stage"],
                  "pp": plan.pp, "stage_layers": list(plan.stage_layers)},
         f"checkpoint manifest meta {meta}")
    losses = [h["loss"] for h in history]
    need(all(math.isfinite(x) for x in losses), f"losses {losses}")
    release(torch)

    # the same stage through make_train_step by hand
    dist = Dist(dev)
    shape = ShapeConfig("train", "train", TRAIN["seq"], TRAIN["batch"])
    bundle = make_train_step(cfg, ParallelConfig(strategy="tatp"), dist,
                             shape)
    data = SyntheticDataset(cfg, shape, dist)
    params, state = bundle.init_fn(torch.Generator(device=dev).manual_seed(0))
    by_hand = []
    for step in range(steps):
        params, state, m = bundle.step_fn(params, state, data.batch(step))
        by_hand.append(float(m["loss"]))
    del params, state, bundle
    release(torch)
    need(losses == by_hand, f"plan-driven losses {losses} != "
         f"make_train_step's {by_hand}")

    # the degraded relaunch: only wafer 1's stage re-solves
    again, relaunch = captured(train, build_parser().parse_args(
        argv + ["--failed-dies", t["failed_dies"], "--fail-wafer",
                str(t["fail_wafer"])]))
    release(torch)
    new, = [MultiWaferPlan.load(str(p)) for p in
            Path(cache).glob("mwplan_*.json") if p != plans[0]]
    changed = [i for i, (a, b) in enumerate(zip(plan.stages, new.stages))
               if a.plan_hash != b.plan_hash]
    need(relaunch[0].startswith(PLAN_FRESH), f"relaunch {relaunch[0]!r}")
    need(changed == new.stages_of_wafer(t["fail_wafer"]) == [1],
         f"stages re-solved: {changed}")
    need(new.stage_layers[t["stage"]] == t["layers"],
         f"degraded stage layers {new.stage_layers}")
    warning = (f"[plan] WARNING: checkpoint was trained under plan "
               f"{plan.plan_hash} but this launch runs plan {new.plan_hash} "
               f"(wafer degraded or re-solved); state restores elastically "
               f"onto the new mesh")
    need(warning in relaunch, "the relaunch printed no plan-drift warning")
    need(again["plan_hash"] == new.plan_hash, f"relaunch {again}")

    step_ms = [h["ms"] for h in history]
    steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    util, flops, _ = mfu(steady / 1e3, cfg, TRAIN["batch"], TRAIN["seq"])
    out = dict(plan_hash=plan.plan_hash, pp=plan.pp, n_micro=plan.n_micro,
               family=plan.family, stage_layers=list(plan.stage_layers),
               stage_degrees=plan.stages[t["stage"]].degrees_tuple(),
               strategy=plan.stages[t["stage"]].parallel_config().strategy,
               degraded_plan_hash=new.plan_hash,
               degraded_stage_layers=list(new.stage_layers),
               stages_resolved=changed, losses=losses,
               losses_equal_make_train_step=True, step_ms=step_ms,
               step_ms_median_after_first=steady,
               tokens_per_s=TRAIN["batch"] * TRAIN["seq"] / steady * 1e3,
               mfu=util, peak_mem_gb=peak / 1e9, launch_wall_s=wall_s,
               launches=launches, layouts=layouts)
    log(f"[plan] train {t['arch']} --wafers {t['wafers']} --stage "
        f"{t['stage']}: {json.dumps(out)}")
    log(f"[plan] train step {steady:.1f} ms, "
        f"{out['tokens_per_s']:.0f} tokens/s, MFU {100 * util:.2f} %, "
        f"peak {peak / 1e9:.2f} GB")
    return launches, layouts, paths


def phase_plan_launch(torch):
    """The plan-driven entry points on the card at full width, bf16, each
    with a temporary plan cache: ``launch.serve --auto-plan`` for
    deepseek-7b and gemma-7b (:func:`plan_serve`) and ``launch.train
    --wafers 8 --stage 7`` for deepseek-7b (:func:`plan_train`).  Returns
    each run's (launches, launches by path) and the train run's GEMM
    layouts."""
    import os
    import tempfile
    serves = {}
    for arch in PLAN_SERVES:
        with tempfile.TemporaryDirectory() as cache:
            serves[f"{arch} --auto-plan"] = plan_serve(torch, arch, cache)
    # the stage's ~20 GB checkpoint in memory where the machine has it
    # (written and read back at memory speed, not the disk's; since phase
    # 15 needed the time)
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    with tempfile.TemporaryDirectory() as cache, \
            tempfile.TemporaryDirectory(dir=shm) as ck:
        trained = plan_train(torch, cache, ck)
    return serves, trained


# engine-mode serving (``launch.serve --serve``): deepseek-7b at its 30
# layers, bf16, 4 decode slots, 128 prompt tokens and 32 new tokens each.
# The measured load: 8 open-loop requests at 1.25 a second, below the
# ~1.8 a second that 4 slots of ~2 s serve, so the queue has a steady
# state (100 until phase 14 needed the time, 40 until phase 15 did, 24
# until phase 16 did, 16 until phase 13's part (e) did, 12 until the
# whole run needed the time; 8 samples back no TTFT p99,
# P99_MIN_SAMPLES, only the p50 and the max); then the same
# rate with a
# die fault at 2.0 s on the engine's clock (``--fault-at``, 1/8 of the
# dies, seeded) over 8 requests (20 until phase 15 needed the time, 12
# until phase 16 did): the
# replan and the migration land in the first seconds, and the run's wall
# clock (~10 s, not ~80) keeps the whole script inside its time limit.
# The stress load: 8 requests at 4 a second (12 until phase 16 needed the
# time), twice what the slots serve, so TTFT grows with each request
# (queueing, not the server)
ENGINE = dict(arch="deepseek-7b", max_batch=4, prompt_len=128, max_new=32,
              fault_at=2.0)
ENGINE_LOAD = dict(requests=8, rate=1.25)
ENGINE_FAULT_LOAD = dict(ENGINE_LOAD, requests=8)
ENGINE_RUNS = (("engine", ENGINE_LOAD, False),
               ("engine fault", ENGINE_FAULT_LOAD, True),
               ("engine stress", dict(requests=8, rate=4.0), False))
# the fp32 engine parity runs (TF32 off): (arch, layers, prompt lengths);
# the PARITY depths at full width, zamba2's prompts whole ssm_chunks
ENGINE_PARITY = (("deepseek-7b", 2, (128, 96)),
                 ("zamba2-2.7b", 6, (256, 512)))
ENGINE_PARITY_NEW = 8


class EngineCalls:
    """A ServeEngine executor that passes each call to ``inner`` and
    records its host time (the executor returns with the device
    synchronised) and, for a prefill, its number of prompt-length groups:
    ``TorchServeExecutor`` runs one prefill of the model per group.
    With ``fixed`` set every call reports that duration (a virtual clock's
    logical time, so a fault lands at the same point in every run)."""

    def __init__(self, inner, fixed=None):
        self.inner, self.fixed = inner, fixed
        self.calls = []  # (kind, ms, prefill groups)
        self.states = {}  # every request state prefilled, by id

    def _timed(self, kind, fn, groups=0):
        t0 = time.perf_counter()
        fn()
        self.calls.append((kind, (time.perf_counter() - t0) * 1e3, groups))
        return self.fixed

    def prefill(self, states):
        self.states.update((id(st), st) for st in states)
        groups = len({st.req.prompt_len for st in states})
        return self._timed("prefill", lambda: self.inner.prefill(states),
                           groups)

    def decode(self, states):
        return self._timed("decode", lambda: self.inner.decode(states))

    def migrate(self, new_plan, mig, wafer=None):
        return self._timed(
            "migrate", lambda: self.inner.migrate(new_plan, mig, wafer))

    def finished(self):
        """The finished requests' states: the samples of the report's
        TTFT and TPOT percentiles."""
        return [st for st in self.states.values()
                if math.isfinite(st.finished_at)]

    def summary(self):
        out = {}
        for kind in ("prefill", "decode", "migrate"):
            ms = sorted(m for k, m, _ in self.calls if k == kind)
            out[kind] = dict(n=len(ms), ms_p50=ms[len(ms) // 2] if ms
                             else None, ms_max=ms[-1] if ms else None)
        out["prefill"]["groups"] = sum(g for k, _, g in self.calls
                                       if k == "prefill")
        return out


def engine_run(torch, params, cache, load, fault):
    """``launch.serve --serve --auto-plan`` (``serve_engine``) on the card
    at ``load`` (requests and rate), the launch counts zeroed just before
    it and read just after."""
    from repro_torch.launch.serve import build_parser, serve_engine
    e = dict(ENGINE, **load)
    argv = ["--arch", e["arch"], "--serve", "--auto-plan", "--device",
            "cuda", "--plan-cache", cache]
    for key in ("requests", "rate", "max_batch", "prompt_len", "max_new"):
        argv += [f"--{key.replace('_', '-')}", str(e[key])]
    if fault:
        argv += ["--fault-at", str(e["fault_at"])]
    wrapped = []

    def wrap(ex):
        wrapped.append(EngineCalls(ex))
        return wrapped[0]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    rep, lines = captured(serve_engine, build_parser().parse_args(argv),
                          params=params, executor=wrap)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, paths = read_launches(), read_paths()
    peak = torch.cuda.max_memory_allocated()
    return rep, lines, wrapped[0], launches, paths, peak, wall_s


def check_engine_launches(what, calls, launches, paths):
    """Exactly one prefill's launches per prompt-length group the engine
    prefilled (210 GEMMs and 30 flash for deepseek-7b; decode and
    migration run no kernel), every GEMM on wgmma and flash on mma."""
    groups = calls.summary()["prefill"]["groups"]
    one = PATHS[ENGINE["arch"]]["launches"]
    need(groups > 0, f"{what}: no prefill ran")
    want = {k: n * groups for k, n in one.items()}
    need(launches == want, f"{what}: launches {launches} != {groups} "
         f"prefill groups x {one}")
    for name, kpath in MAIN_PATH_KERNEL.items():
        need(paths[name][kpath] == launches[name],
             f"{what}: {name} by path {paths[name]}")
    return groups


# the least number of samples that a nearest-rank p99 is reported over:
# below it the p99 is the slowest request, and the max says so plainly
P99_MIN_SAMPLES = 100


def engine_metrics(rep, calls, launches, peak, wall_s, sent):
    """The run's report, with the requests sent and TTFT as median and
    max (p99 only where ``P99_MIN_SAMPLES`` back it).  The TTFT samples
    are recomputed from the executor's states and must give the report's
    own percentiles (``ServeReport``'s nearest-rank rule)."""
    from repro_torch.serve.engine import _percentile
    keys = ("n_finished", "n_rejected", "generated_tokens", "makespan",
            "tokens_per_s", "ttft_p50", "tpot_p50", "tpot_p99",
            "mean_occupancy", "iterations", "n_replans", "n_evicted",
            "n_readmitted", "plan_hash", "mode")
    fin = calls.finished()
    ttfts = sorted(st.ttft for st in fin)
    need(len(ttfts) == rep["n_finished"]
         and _percentile(ttfts, 50) == rep["ttft_p50"]
         and _percentile(ttfts, 99) == rep["ttft_p99"],
         f"engine: {len(ttfts)} TTFT samples do not give the report's "
         f"percentiles {rep['ttft_p50']}, {rep['ttft_p99']}")
    tpot_n = sum(len(st.tpots) for st in fin)
    return dict({k: rep[k] for k in keys}, requests_sent=sent,
                ttft_max=ttfts[-1], ttft_n=len(ttfts),
                ttft_p99=rep["ttft_p99"] if len(ttfts) >= P99_MIN_SAMPLES
                else None, tpot_n=tpot_n, calls=calls.summary(),
                launches=launches, peak_mem_gb=peak / 1e9, wall_s=wall_s)


def engine_parity(torch, arch, n_layers, plens):
    """fp32 (TF32 off) engine parity at full width: the same requests
    through ``ServeEngine`` on a virtual clock (each executor call 1.0 s)
    with a die fault at 1e-9 s, so ``migrate`` runs after the first
    admission wave; once with the kernels and once with every kernel hook
    replaced by its plain version.  Every request's token stream and the
    whole report must be identical; the kernel run must have launched
    each kernel the model's prefill runs (the plain run none)."""
    import tempfile

    from repro_torch.core.plan import compile_serve_plan
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.tatp_matmul.ref import matmul_ref
    from repro_torch.launch.serve import TorchServeExecutor
    from repro_torch.models.ssm import ssd_chunked
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import Request, ServeEngine, VirtualClock
    from repro_torch.wafer.fault import sample_die_faults
    from repro_torch.wafer.topology import Wafer, WaferSpec

    dev = torch.device("cuda")
    cfg = parity_config(arch, n_layers)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                         dev)
    reqs = [Request(rid=i, arrival=0.0 if i < 4 else 4.5,
                    prompt_len=plens[i % len(plens)],
                    max_new_tokens=ENGINE_PARITY_NEW) for i in range(6)]
    plain = dict(dot=matmul_ref, attention=attention_ref, ssd=ssd_chunked)
    runs = {}
    with tempfile.TemporaryDirectory() as cache:
        wafer = Wafer(WaferSpec())
        plan = compile_serve_plan(wafer, cfg, 4,
                                  max(plens) + ENGINE_PARITY_NEW,
                                  cache_dir=cache)
        fault = sample_die_faults(wafer, 0.1, seed=2).as_event(1e-9)
        for name, hooks in (("kernels", {}), ("plain", plain)):
            ex = EngineCalls(TorchServeExecutor(plan, cfg, params=params,
                                                **hooks), fixed=1.0)
            eng = ServeEngine(plan, ex, clock=VirtualClock(), cfg=cfg,
                              wafer=wafer, faults=[fault],
                              plan_cache_dir=cache)
            zero_launches()
            rep = eng.run([Request(**vars(r)) for r in reqs])
            torch.cuda.synchronize()
            streams = sorted((st.req.rid, st.req.prior_tokens,
                              tuple(st.tokens)) for st in eng.sched.finished)
            runs[name] = (rep.to_dict(), streams, read_launches(),
                          ex.summary())
            del ex, eng
            release(torch)
    (rep, streams, launches, calls), (prep, pstreams, plaunches, _) = \
        runs["kernels"], runs["plain"]
    need(rep["n_finished"] == len(reqs) and rep["n_replans"] == 1,
         f"engine parity {arch}: {rep['n_finished']} finished, "
         f"{rep['n_replans']} replans")
    need(calls["migrate"]["n"] == 1, f"engine parity {arch}: migrate ran "
         f"{calls['migrate']['n']} times")
    need(streams == pstreams, f"engine parity {arch}: token streams differ "
         f"between the kernels and the plain versions")
    need(rep == prep, f"engine parity {arch}: reports differ")
    want = prefill_launches(cfg)
    for k, n in want.items():
        need((launches[k] > 0) == (n > 0),
             f"engine parity {arch}: kernel run launched {launches}")
    need(not any(plaunches.values()),
         f"engine parity {arch}: the plain run launched {plaunches}")
    out = dict(layers=n_layers, prompt_lens=list(plens),
               requests=len(reqs), streams_identical=True,
               reports_identical=True, replans=rep["n_replans"],
               recovery=rep["recovery"][0], tokens=rep["generated_tokens"],
               kernel_launches=launches, plain_launches=plaunches,
               calls=calls)
    log(f"[engine] parity {arch} fp32: {json.dumps(out)}")
    del params
    release(torch)


def phase_engine(torch):
    """Engine-mode serving on the card (``launch.serve --serve``),
    deepseek-7b at its 30 layers, bf16, through ``serve_engine``: (a) at
    the measured load, fault-free (every request finished with all its
    tokens, exactly one prefill's launches per prefill group); (b) the
    same with ``--fault-at 2.0``: one replan, to the plan that
    ``replan_serve`` solves offline for the same fault, and every request
    finished or rejected with a reason; (a') the stress load, fault-free,
    as (a); (c) fp32 parity of the engine, kernels against plain versions
    (:func:`engine_parity`).  Returns the launch counts of (a), (b) and
    (a')."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.core.plan import ServePlan, replan_serve
    from repro_torch.models.transformer import init_params
    from repro_torch.wafer.fault import sample_die_faults

    dev = torch.device("cuda")
    e = ENGINE
    cfg = get_config(e["arch"])
    need(cfg.n_layers == PATHS[e["arch"]]["n_layers"],
         f"{e['arch']} has {cfg.n_layers} layers")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    counted = {}
    for label, load, fault in ENGINE_RUNS:
        what = f"{e['arch']} {label}"
        sent = load["requests"]
        with tempfile.TemporaryDirectory() as cache:
            rep, lines, calls, launches, paths, peak, wall_s = engine_run(
                torch, params, cache, load, fault)
            # the launch's plan and, after a fault, the adopted one
            plans = {p.plan_hash: p for p in (
                ServePlan.load(str(f))
                for f in Path(cache).glob("splan_*.json"))}
            need(len(plans) == 1 + fault and rep["plan_hash"] in plans,
                 f"{what}: ran {rep['plan_hash']}, cache holds "
                 f"{sorted(plans)}")
            plan = plans[rep["plan_hash"]]
            need(lines[0].startswith(PLAN_FRESH),
                 f"{what}: logged {lines[0]!r}")
            need(rep["mode"] == "torch", f"{what}: mode {rep['mode']}")
            need(rep["n_requests"] == sent,
                 f"{what}: {rep['n_requests']} of {sent} requests seen")
            groups = check_engine_launches(what, calls, launches, paths)
            out = engine_metrics(rep, calls, launches, peak, wall_s, sent)
            out.update(load, prefill_groups=groups)
            if not fault:
                need(rep["n_finished"] == sent
                     and rep["generated_tokens"] == sent * e["max_new"],
                     f"{what}: {rep['n_finished']} finished, "
                     f"{rep['generated_tokens']} tokens")
                need(rep["n_replans"] == 0, f"{what}: replanned")
            else:
                need(rep["n_replans"] == 1 and len(rep["recovery"]) == 1,
                     f"{what}: {rep['n_replans']} replans")
                rec = rep["recovery"][0]
                wafer = plan.plan.wafer()
                dies = sample_die_faults(wafer, 0.125, seed=0).failed_dies
                need(tuple(rec["failed_dies"]) == tuple(dies),
                     f"{what}: fault killed {rec['failed_dies']}, the "
                     f"sampler gives {dies}")
                offline = replan_serve(plan, cfg, wafer.with_faults(
                    dies, ()), use_cache=False)
                need(rec["new_plan_hash"] == offline.plan_hash,
                     f"{what}: adopted {rec['new_plan_hash']}, offline "
                     f"replan_serve gives {offline.plan_hash}")
                need(rep["n_finished"] + rep["n_rejected"] == sent
                     and all(reason for _, reason in rep["rejected"]),
                     f"{what}: {rep['n_finished']} finished, rejected "
                     f"{rep['rejected']}")
                need(calls.summary()["migrate"]["n"] == 1,
                     f"{what}: migrate ran {calls.summary()['migrate']}")
                out["recovery"] = {k: rec[k] for k in (
                    "old_plan_hash", "new_plan_hash", "pause_s",
                    "n_active", "n_survivors", "n_evicted",
                    "old_max_batch", "new_max_batch", "failed_dies",
                    "dip_depth", "time_to_recover", "recovered")}
                out["offline_replan_hash"] = offline.plan_hash
            need(all(math.isfinite(rep[k]) for k in (
                "ttft_p50", "ttft_p99", "tpot_p50", "tpot_p99",
                "tokens_per_s", "makespan")), f"{what}: {rep}")
            log(f"[engine] {what} {cfg.n_layers} layers bf16: "
                f"{json.dumps(out)}")
            p99 = "" if out["ttft_p99"] is None else \
                f" / p99 {1e3 * out['ttft_p99']:.1f}"
            log(f"[engine] {what}: {sent} requests at {load['rate']}/s "
                f"sent, {rep['n_finished']} finished, {rep['n_rejected']} "
                f"rejected; TTFT p50 {1e3 * rep['ttft_p50']:.1f}{p99} / "
                f"max {1e3 * out['ttft_max']:.1f} ms ({out['ttft_n']} "
                f"samples), TPOT p50 {1e3 * rep['tpot_p50']:.1f} / p99 "
                f"{1e3 * rep['tpot_p99']:.1f} ms ({out['tpot_n']} samples), "
                f"{rep['tokens_per_s']:.1f} tokens/s, occupancy "
                f"{rep['mean_occupancy']:.2f}, peak {peak / 1e9:.2f} GB")
            counted[what] = (launches, paths)
        # the executor holds its KV cache: free it before the next run
        # measures its peak
        del calls
        release(torch)
    del params
    release(torch)
    for arch, n_layers, plens in ENGINE_PARITY:
        engine_parity(torch, arch, n_layers, plens)
    return counted


# ---------------------------------------------------------------------------
# phase 10: the cost engine's torch tier and the DNN cost surrogate
# ---------------------------------------------------------------------------

# (arch, objectives) held tier against tier over the temp space: the train
# step (simulate_batch) and the decode iteration (simulate_decode_batch;
# olmoe's candidates grow the EP axis)
COST_PARITY = (("deepseek-7b", ("train", "decode")),
               ("qwen2-72b", ("train", "decode")),
               ("olmoe-1b-7b", ("train", "decode")))
COST_TRAIN = dict(batch=32, seq=2048)  # tests/test_solver_fast.py's shape
COST_DECODE = dict(batch=64, seq=4096)  # its decode parity shape
COST_DEGRADED_SEED = 3  # benchmarks/search_time.py's degraded gpt3 row
# the search-time models and shapes of benchmarks/search_time.py
COST_SEARCH = ("gpt3-6.7b", "llama2-7b", "gpt3-76b")
COST_WARM_REPEATS = 3
ILP_EVALS = 50_000  # ilp_search's cap
# benchmarks/fig21_costmodel.py's protocol
FIG21 = dict(models=("gpt3-6.7b", "llama2-7b", "gpt3-175b"), n=500,
             train_frac=0.8, epochs=500)
FIG21_CPU = ROOT / "results" / "bench" / "fig21_costmodel.json"


def sim_bits(results):
    """Every field of a list of ``SimResult``s, floats as their hex bits
    (so ``inf`` and ``nan`` compare), the breakdown's too."""
    def bits(x):
        if isinstance(x, float):
            return x.hex()
        if isinstance(x, dict):
            return tuple(sorted((k, bits(v)) for k, v in x.items()))
        if isinstance(x, (list, tuple)):
            return tuple(bits(v) for v in x)
        return x
    return [(r.degrees.key if r.degrees else None, r.engine, bits(
        [r.step_time, r.throughput, r.mem_per_die, r.oom, r.power,
         r.power_eff, r.bw_util, r.breakdown])) for r in results]


def untimed(record):
    """A plan record without its solves' wall-clock times."""
    if isinstance(record, dict):
        return {k: untimed(v) for k, v in record.items()
                if k != "search_time_s"}
    if isinstance(record, list):
        return [untimed(v) for v in record]
    return record


def cost_grid(cfg, n_dies, objective):
    import dataclasses

    from repro_torch.wafer.simulator import STRATEGY_SPACES, candidate_degrees
    spec = STRATEGY_SPACES["temp"]
    cands = candidate_degrees(n_dies, spec["allow"], spec["seq_par"])
    if objective == "decode" and cfg.is_moe:
        cands = cands + [dataclasses.replace(d, ep=e) for d in cands
                         for e in (2, 4, 8) if d.dp % e == 0]
    return cands


def cost_parity(arch, objective, wafer, dies, label):
    """``simulate_batch`` (search-time: the fused Tier B; final: stage 1
    alone) or ``simulate_decode_batch`` over the temp space under
    ``"torch"`` against ``"numpy"``, every field bitwise."""
    from repro_torch.configs import get_config
    from repro_torch.wafer.simulator import (StepCostContext,
                                             simulate_batch,
                                             simulate_decode_batch)
    cfg = get_config(arch)
    n = len(dies) if dies is not None else len(wafer.alive_dies())
    cands = cost_grid(cfg, n, objective)
    if objective == "decode":
        shape = COST_DECODE

        def run(tier):
            ctx = StepCostContext(wafer, cfg, shape["batch"], shape["seq"],
                                  dies=dies, objective="decode", tierb=tier)
            return sim_bits(simulate_decode_batch(ctx, cands))
        runs = {t: run(t) for t in ("numpy", "torch")}
    else:
        shape = COST_TRAIN

        def run(tier, final):
            ctx = StepCostContext(wafer, cfg, shape["batch"], shape["seq"],
                                  dies=dies, stage1=tier, tierb=tier)
            return sim_bits(simulate_batch(ctx, cands,
                                           run_tcme_optimizer=final,
                                           prune_oom=not final))
        runs = {t: run(t, False) + run(t, True) for t in ("numpy", "torch")}
    same = runs["numpy"] == runs["torch"]
    if not same:
        bad = next(i for i, (a, b) in enumerate(zip(runs["numpy"],
                                                      runs["torch"]))
                   if a != b)
        log(f"    first difference at {bad}: numpy {runs['numpy'][bad]}, "
            f"torch {runs['torch'][bad]}")
    log(f"  check cost {arch} {objective} on {label}: {len(cands)} "
        f"candidates, torch == numpy bitwise {'ok' if same else 'FAIL'}")
    need(same, f"cost engine: {arch} {objective} on {label}: the torch "
         f"tier differs from numpy")
    return len(cands)


def timed_solves(cfg, shape, tier):
    """DLWS on a fresh wafer (cold: the wafer's group, template and batch
    caches empty), then warm solves on it with its resident contexts
    dropped (so every evaluation runs again, on warm caches): seconds,
    the solve and its evaluations."""
    from repro_torch.wafer.solver import dlws_solve
    from repro_torch.wafer.topology import Wafer, WaferSpec
    wafer = Wafer(WaferSpec())
    t0 = time.perf_counter()
    sol = dlws_solve(wafer, cfg, shape.global_batch, shape.seq_len,
                     space="temp", tierb=tier)
    cold = time.perf_counter() - t0
    warm = []
    for _ in range(COST_WARM_REPEATS):
        wafer._ctx_cache.clear()
        t0 = time.perf_counter()
        again = dlws_solve(wafer, cfg, shape.global_batch, shape.seq_len,
                           space="temp", tierb=tier)
        warm.append(time.perf_counter() - t0)
        need(again.evaluated == sol.evaluated
             and again.config.key == sol.config.key,
             f"warm {cfg.name} solve under {tier} walked another path")
    return cold, min(warm), sol


def timed_ilp(cfg, shape, tier):
    """``ilp_search`` (its 50,000-evaluation cap, 1024-candidate chunks)
    with ``REPRO_TIERB`` set to ``tier``, on a fresh wafer."""
    import os

    from repro_torch.wafer.solver import ilp_search
    from repro_torch.wafer.topology import Wafer, WaferSpec
    old = os.environ.get("REPRO_TIERB")
    os.environ["REPRO_TIERB"] = tier
    try:
        t0 = time.perf_counter()
        res = ilp_search(Wafer(WaferSpec()), cfg, shape.global_batch,
                         shape.seq_len, space="temp")
        secs = time.perf_counter() - t0
    finally:
        if old is None:
            del os.environ["REPRO_TIERB"]
        else:
            os.environ["REPRO_TIERB"] = old
    need(res.evaluated == ILP_EVALS, f"ilp_search ran {res.evaluated}")
    return secs, res


def phase_fig21(torch, dev):
    """benchmarks/fig21_costmodel.py's protocol with the surrogate on the
    card: 500 cases of the three models, the first 80 % to train (500
    epochs), the rest held out; the reference test's bar on log_step
    (corr > 0.97, rel_err below 1.1 x the linear fit's); each target
    beside the recorded CPU run; training time and one lookup against one
    simulate_step."""
    import numpy as np

    from repro_torch.configs.paper_models import TABLE_II
    from repro_torch.wafer.dnn_cost import (TARGETS, evaluate, featurize,
                                            fit_linear, make_dataset,
                                            train_dnn)
    from repro_torch.wafer.simulator import ParallelDegrees, simulate_step
    from repro_torch.wafer.topology import Wafer, WaferSpec
    wafer = Wafer(WaferSpec())
    cfgs = [TABLE_II[m][0] for m in FIG21["models"]]
    t0 = time.perf_counter()
    xs, ys = make_dataset(wafer, cfgs, n=FIG21["n"], seed=0)
    data_s = time.perf_counter() - t0
    n_tr = int(FIG21["train_frac"] * len(xs))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dnn = train_dnn(xs[:n_tr], ys[:n_tr], epochs=FIG21["epochs"],
                    device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    need(all(p.device.type == dev.type for p in dnn.params.values()),
         "fig21: the surrogate's weights are not on the card")
    lin = fit_linear(xs[:n_tr], ys[:n_tr])
    pred = dnn.predict(xs[n_tr:])
    need(bool(np.isfinite(pred).all()) and pred.shape == ys[n_tr:].shape,
         f"fig21: predictions {pred.shape}, finite "
         f"{bool(np.isfinite(pred).all())}")
    dnn_m = evaluate(pred, ys[n_tr:])
    lin_m = evaluate(lin(xs[n_tr:]), ys[n_tr:])
    cpu = json.loads(FIG21_CPU.read_text())
    for t in TARGETS:
        d, li, c = dnn_m[t], lin_m[t], cpu["dnn"][t]
        log(f"  [fig21] {t}: dnn corr {d['corr']:.4f} rel_err "
            f"{d['rel_err']:.4f} (CPU run: {c['corr']:.4f} / "
            f"{c['rel_err']:.4f}); linear {li['corr']:.4f} / "
            f"{li['rel_err']:.4f} (n {d['n']})")
    step = dnn_m["log_step"]
    ok = step["corr"] > 0.97 \
        and step["rel_err"] < lin_m["log_step"]["rel_err"] * 1.1
    cfg, deg = cfgs[0], ParallelDegrees(dp=2, tatp=16)
    t0 = time.perf_counter()
    for _ in range(20):
        simulate_step(wafer, cfg, 64, 2048, deg, "tcme")
    t_sim = (time.perf_counter() - t0) / 20
    x = featurize(cfg, 64, 2048, deg, "tcme")[None]
    dnn.predict(x)
    t0 = time.perf_counter()
    for _ in range(200):
        dnn.predict(x)  # each ends in a read-back of its numpy result
    t_dnn = (time.perf_counter() - t0) / 200
    out = dict(cases=len(xs), train=n_tr, epochs=FIG21["epochs"],
               dataset_s=data_s, train_s=train_s,
               train_ms_per_epoch=1e3 * train_s / FIG21["epochs"],
               t_simulate_s=t_sim, t_lookup_s=t_dnn,
               lookup_speedup=t_sim / t_dnn, dnn=dnn_m, linear=lin_m,
               cpu_run=dict(dnn=cpu["dnn"], linear=cpu["linear"],
                            t_lookup_s=cpu["t_lookup_s"],
                            t_simulate_s=cpu["t_simulate_s"]))
    log(f"[cost] fig21 on {dev}: {json.dumps(out)}")
    log(f"  check fig21 log_step: corr {step['corr']:.4f} > 0.97, rel_err "
        f"{step['rel_err']:.4f} < 1.1 x {lin_m['log_step']['rel_err']:.4f}"
        f" {'ok' if ok else 'FAIL'}; train {train_s:.2f} s, lookup "
        f"{1e6 * t_dnn:.1f} us vs simulate_step {1e6 * t_sim:.1f} us")
    need(ok, "fig21: the surrogate misses the reference test's bar")
    return out


def phase_cost_engine(torch):
    """The cost engine's torch tier on the card against the numpy tier,
    bit for bit, with its calls counted (zeroed just before, read just
    after); DLWS and ``compile_serve_plan`` under both tiers; the tiers'
    search times; then the surrogate on fig21's protocol."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.configs.paper_models import TABLE_II
    from repro_torch.core.plan import compile_serve_plan
    from repro_torch.wafer import simulator
    from repro_torch.wafer.fault import random_degraded_wafer
    from repro_torch.wafer.solver import dlws_solve
    from repro_torch.wafer.topology import Wafer, WaferSpec

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    for k in simulator.TIER_CALLS:
        simulator.TIER_CALLS[k] = 0
    checked = 0
    dw, dies = random_degraded_wafer(COST_DEGRADED_SEED)
    for arch, objectives in COST_PARITY:
        for objective in objectives:
            checked += cost_parity(arch, objective, Wafer(WaferSpec()),
                                   None, "the 4 x 8 wafer")
            checked += cost_parity(arch, objective, dw, dies,
                                   f"degraded seed {COST_DEGRADED_SEED} "
                                   f"({len(dies)} dies)")
    # a solve and a serve plan under both tiers: same degrees, same
    # evaluations, same plan hash
    cfg = get_config("deepseek-7b")
    sols = {t: dlws_solve(Wafer(WaferSpec()), cfg, 4, 512, tierb=t)
            for t in ("numpy", "torch")}
    need(sols["numpy"].config.key == sols["torch"].config.key
         and sols["numpy"].evaluated == sols["torch"].evaluated
         and sols["numpy"].best.throughput == sols["torch"].best.throughput,
         f"dlws_solve: {sols['numpy'].config} vs {sols['torch'].config}")
    plans = {}
    for t in ("numpy", "torch"):
        with tempfile.TemporaryDirectory() as cache:
            plans[t] = compile_serve_plan(Wafer(WaferSpec()), cfg, 4, 160,
                                          tierb=t, cache_dir=cache)
    need(plans["numpy"].plan_hash == plans["torch"].plan_hash
         and untimed(plans["numpy"].to_dict())
         == untimed(plans["torch"].to_dict()),
         f"compile_serve_plan: {plans['numpy'].plan_hash} vs "
         f"{plans['torch'].plan_hash}")
    log(f"  check cost dlws_solve and compile_serve_plan (deepseek-7b) "
        f"under both tiers: {sols['torch'].config.as_tuple()}, "
        f"{sols['torch'].evaluated} evaluations, plan "
        f"{plans['torch'].plan_hash} ok")
    calls = dict(simulator.TIER_CALLS)
    log(f"[cost] tier calls on the card while checking: {json.dumps(calls)}")
    need(all(calls[k] > 0 for k in calls),
         f"the torch tier did not run on every stage: {calls}")

    # search times, tier against tier in turns (numpy, torch, torch, numpy)
    search = {}
    for model in COST_SEARCH:
        mcfg, shape = TABLE_II[model]
        row = {}
        for tier in ("numpy", "torch", "torch", "numpy"):
            for k in simulator.TIER_CALLS:
                simulator.TIER_CALLS[k] = 0
            cold, warm, sol = timed_solves(mcfg, shape, tier)
            ilp_s, ilp = timed_ilp(mcfg, shape, tier)
            got = dict(cold_s=cold, warm_s=warm, evals=sol.evaluated,
                       cold_evals_per_s=sol.evaluated / cold,
                       warm_evals_per_s=sol.evaluated / warm,
                       config=sol.config.as_tuple(),
                       throughput=sol.best.throughput, ilp_s=ilp_s,
                       ilp_evals_per_s=ILP_EVALS / ilp_s,
                       ilp_config=ilp.config.as_tuple(),
                       tier_calls=dict(simulator.TIER_CALLS))
            if tier == "torch":
                need(got["tier_calls"]["tierb"] > 0,
                     f"{model}: the torch tier never ran")
            row.setdefault(tier, []).append(got)
        first = row["numpy"][0]
        for tier, runs in row.items():
            for r in runs:
                need(r["config"] == first["config"]
                     and r["throughput"] == first["throughput"]
                     and r["evals"] == first["evals"]
                     and r["ilp_config"] == first["ilp_config"],
                     f"{model}: {tier} found {r['config']} / "
                     f"{r['ilp_config']}, numpy {first['config']} / "
                     f"{first['ilp_config']}")
        search[model] = row
        for tier, runs in row.items():
            log(f"  [search] {model} {tier}: dlws {runs[0]['evals']} evals,"
                f" cold " + " / ".join(f"{1e3 * r['cold_s']:.1f}"
                                       for r in runs)
                + " ms, warm " + " / ".join(f"{1e3 * r['warm_s']:.2f}"
                                            for r in runs)
                + " ms (" + " / ".join(f"{r['warm_evals_per_s']:.0f}"
                                       for r in runs)
                + " evals/s); ilp 50k " + " / ".join(
                    f"{r['ilp_s']:.3f}" for r in runs) + " s ("
                + " / ".join(f"{r['ilp_evals_per_s']:.0f}" for r in runs)
                + " evals/s)")
    log(f"[cost] search: {json.dumps(search)}")
    fig21 = phase_fig21(torch, dev)
    log(f"[cost] phase {time.perf_counter() - t_phase:.1f} s, "
        f"{checked} candidate evaluations checked bitwise")
    return dict(search=search, fig21=fig21, tier_calls=calls)


# ---------------------------------------------------------------------------
# phase 11: the TATP ring serves deepseek-7b over four ranks on the card
# ---------------------------------------------------------------------------

# the ring: four ranks (processes) joined by gloo, all on the one card, on
# the (data, model) mesh (1, 4); the phase's wall-clock limit
RING = dict(ranks=4, mesh=(1, 4), backend="gloo", timeout_s=600)
# fp32 parity: deepseek-7b at full width, 2 layers, against the degree-1
# run on the same card and the same weights (the shards of one tree); 4
# greedy tokens (8 until phase 15 needed the time)
RING_PARITY = dict(arch="deepseek-7b", n_layers=2, batch=4, prompt_len=128,
                   gen=4, seed=1)
# the fp8 and bf16 wires on that prefill against the degree-1 fp32 run: the
# largest difference of the logits over their largest magnitude, below
# the reference's own limit for its fp8 wire ("lossy wire: close, not
# severed", tests/multidevice/check_wire_grads.py:59), and for bf16 its
# 1/16 (e4m3 rounds a streamed weight by up to 1/16 of its value, bf16 by
# 1/256 of it)
RING_WIRE_TOL = {"bf16": 0.30 / 16, "fp8": 0.30}
# the bf16 serve through the entry point: 30 layers, --auto-plan; 2 new
# tokens (32 until the train ring's phase 12 needed the time, 8 until
# phase 14 did, 4 until phase 16 did: each ring decode token is ~1.2-2 s
# of host-staged collectives, and ms/token is an average either way; the
# plan is the same (1, 1, 1, 4) for 130 tokens)
RING_SERVE = dict(arch="deepseek-7b", batch=4, prompt_len=128, gen=2)
# the 30-layer bf16 prefill's last logits against the degree-1 run's
# (relative L2): the GEMM tiles are the degree-1 products' columns, but
# each ring round's flash output is rounded to bf16 before the fp32 merge
RING_BF16_TOL = 0.05
# (N, kb, launches per layer) of one deepseek layer's per-round tiles at M
# = batch x prompt / 4 = 128 rows: wq wk wv wo, w_up w_gate, w_down
RING_GEMMS = ((D_MODEL, D_MODEL // 4, 4), (D_MODEL, D_FF // 4, 2),
              (D_FF, D_MODEL // 4, 1))
RING_M = RING_SERVE["batch"] * RING_SERVE["prompt_len"] // RING["ranks"]
# one round of ring attention: [B, H, S/4, D], causal on the own block,
# unmasked (with its row LSE) on an earlier one
RING_ATTN = (RING_SERVE["batch"], HEADS,
             RING_SERVE["prompt_len"] // RING["ranks"], HEAD_DIM)


def ring_launches(cfg, r, i, seq=None):
    """Kernel launches of one ring prefill on rank ``i`` of ``r`` (a
    causal decoder): every linear's ``r`` per-round tiles, and one flash
    per round with a visible key in each attention block: the own block
    and the ``i`` earlier ones, and in an ``L`` slot (a prompt of ``seq``
    tokens, ``seq / r`` a rank) only the blocks whose nearest pair lies
    inside the window (:func:`window_rounds`)."""
    n = prefill_launches(cfg)
    n["tatp_matmul"] *= r
    n["flash_attention"] = sum(
        window_rounds(cfg.sliding_window if kind == "L" else None, r, i,
                      seq) for _, kind in model_blocks(cfg) if kind != "M")
    return n


def window_rounds(window, r, i, seq):
    """Rank ``i``'s rounds with a visible pair in a causal contiguous ring
    of ``r`` blocks of ``seq / r`` positions under ``window`` (None: all
    ``i + 1``), counted from the positions: block ``j <= i``'s nearest
    pair is ``(i - j) s - (s - 1)`` apart."""
    if window is None:
        return i + 1
    s = seq // r
    return sum(1 for j in range(i + 1) if (i - j) * s - (s - 1) < window)


def phase_ring_rows(torch, randn):
    """The GEMM and flash rows at the ring's per-round shapes, timed in
    this process alone (four ranks time-slicing the card would blur
    them); each against its plain version first."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.tatp_matmul.ops import tatp_dot
    from repro_torch.kernels.tatp_matmul.ref import matmul_ref

    r, layers = RING["ranks"], PATHS["deepseek-7b"]["n_layers"]
    gemms = []
    for n, kb, per_layer in RING_GEMMS:
        a = randn(RING_M, n, dtype=torch.bfloat16)
        b = randn(n, kb, dtype=torch.bfloat16, scale=n ** -0.5)
        path = gemm_path(a, b)
        need(path == "wgmma", f"ring tile {n}x{kb} takes {path}")
        err = compare(f"ring tile bf16 {RING_M}x{n}x{kb}", tatp_dot(a, b),
                      matmul_ref(a, b), *GEMM_TOL["bfloat16"])
        flops = 2 * RING_M * n * kb
        row = dict(shape=[RING_M, n, kb], path=path, max_abs_err=err,
                   launches_per_rank=per_layer * r * layers,
                   ms=time_ms(torch, lambda: tatp_dot(a, b)),
                   plain_ms=time_ms(torch, lambda: matmul_ref(a, b)),
                   library_ms=time_ms(torch, lambda: torch.matmul(a, b)))
        row["bound_ms"], row["bound_by"] = bound(
            flops, 2 * (RING_M * n + n * kb + RING_M * kb), "bfloat16")
        gemms.append(row)
    b, h, s, d = RING_ATTN
    flashes = []
    for causal, per_rank in ((True, f"{layers} on every rank"),
                             (False, f"{layers} x i on rank i")):
        q, k, v = (randn(b, s, h, d, dtype=torch.bfloat16).transpose(1, 2)
                   for _ in range(3))
        kw = dict(causal=causal, return_lse=True)
        before = attention.launches_by_path["mma"]
        o, lse = attention(q, k, v, **kw)
        torch.cuda.synchronize()
        need(attention.launches_by_path["mma"] == before + 1,
             "a ring round's flash did not take the mma path")
        o_ref, lse_ref = attention_ref(q, k, v, **kw)
        what = "causal own block" if causal else "unmasked earlier block"
        err = max(compare(f"ring round {what} [{b},{h},{s},{d}]", o, o_ref,
                          *ATTN_TOL["bfloat16"]),
                  compare(f"ring round {what} row LSE", lse, lse_ref,
                          *ATTN_TOL["bfloat16"]))
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
        row = dict(shape=[b, h, s, d], causal=causal, max_abs_err=err,
                   launches_per_rank=per_rank,
                   ms=time_ms(torch, lambda: attention(q, k, v, **kw), 50),
                   plain_ms=time_ms(torch,
                                    lambda: attention_ref(q, k, v, **kw), 50),
                   library_ms=time_ms(torch, lambda: (
                       F.scaled_dot_product_attention(qc, kc, vc,
                                                      is_causal=causal)),
                       50),
                   library="SDPA (no LSE out)")
        # q, k, v in and o out in bf16, the row LSE out in fp32
        row["bound_ms"], row["bound_by"] = bound(
            4 * pairs * d, 8 * b * h * s * d + 4 * b * h * s, "bfloat16")
        flashes.append(row)
    log(f"[ring rows] GEMM tiles {json.dumps(gemms)}; flash rounds "
        f"{json.dumps(flashes)}")
    return gemms, flashes


def _ring_contrib(torch, g, shape=(64, 1024)):
    """Rank ``g``'s values for the transport check: small integers as
    fp32, so every order of summing them is exact."""
    gen = torch.Generator().manual_seed(500 + g)
    return torch.randint(-20, 20, shape, generator=gen).float()


def ring_transport(torch, dist):
    """The host-staged collectives on CUDA tensors, bit for bit against
    the source ranks' values; then the time to move one w_up block
    (22.5 MB bf16) one hop."""
    dev, axis = dist.device, dist.model_axis
    r, i = dist.model_degree, dist.axis_index(axis)
    ranks = dist.groups[axis].ranks
    src = [_ring_contrib(torch, g) for g in ranks]
    x = src[i].to(dev)
    right = [((p + 1) % r, p) for p in range(r)]
    left = [((p - 1) % r, p) for p in range(r)]
    up, dn = dist.ppermute_many([(x, right), (x.to(torch.bfloat16), left)],
                                axis)
    checks = dict(
        ppermute=torch.equal(up.cpu(), src[(i + 1) % r]),
        ppermute_bf16=torch.equal(dn.cpu(),
                                  src[(i - 1) % r].to(torch.bfloat16)),
        psum=torch.equal(dist.psum(x, axis).cpu(), sum(src)),
        psum_bf16=torch.equal(dist.psum(x.to(torch.bfloat16), axis).cpu(),
                              sum(src).to(torch.bfloat16)),
        pmax=torch.equal(dist.pmax(x, axis).cpu(),
                         torch.stack(src).amax(0)),
        pmin_int64=torch.equal(dist.pmin(x.long(), axis).cpu(),
                               torch.stack(src).long().amin(0)),
        all_gather=torch.equal(dist.all_gather(x, axis, dim=-1).cpu(),
                               torch.cat(src, dim=-1)))
    need(all(checks.values()), f"rank {i}: transport {checks}")
    blk = torch.randn(D_MODEL, D_FF // 4, device=dev).to(torch.bfloat16)
    dist.ppermute(blk, axis, right)  # grow the staging buffers first
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        dist.ppermute(blk, axis, right)
    hop_ms = (time.perf_counter() - t0) / 5 * 1e3
    return dict(checks=checks, hop_ms=hop_ms,
                hop_gb_s=blk.numel() * 2 / hop_ms / 1e6)


def ring_parity(torch, dist, out_dir, spec=None,
                wires=("native", "bf16", "fp8"), tag="parity"):
    """fp32 at full width, 2 layers: the ring's prefill (launches,
    logits, this rank's cache block) and greedy tokens on the weights
    ``init_sharded_params`` draws from ``spec``'s seed (RING_PARITY by
    default); then the prefill on the other ``wires``.  The tensors go to
    ``<tag><rank>.pt`` for the parent to compare."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import lm
    from repro_torch.train.train_loop import make_serve_fns
    from repro_torch.weights import init_sharded_params

    spec = spec or RING_PARITY
    dev, i = dist.device, dist.axis_index(dist.model_axis)
    cfg = parity_config(spec["arch"], spec["n_layers"])
    params = init_sharded_params(
        cfg, torch.Generator(device=dev).manual_seed(spec["seed"]), dist)
    b, s = spec["batch"], spec["prompt_len"]
    batch = {name: torch.as_tensor(a, device=dev) for name, a in
             prompt_batch(cfg, b, s, seed=spec["seed"]).items()}
    out, rec = {}, {}
    for wire in wires:
        sb = make_serve_fns(cfg, ParallelConfig(strategy="tatp", remat=False,
                                                stream_dtype=wire), dist)
        zero_launches()
        caches, logits = sb.prefill_fn(params, batch)
        torch.cuda.synchronize()
        out[f"logits_{wire}"] = logits[:, -1].cpu()
        if wire != "native":
            continue
        launches, paths = read_launches(), read_paths()
        want = ring_launches(cfg, dist.model_degree, i, s)
        need(launches == want, f"rank {i}: fp32 ring prefill launched "
             f"{launches}, want {want}")
        for name, by_path in paths.items():
            need(by_path["simt"] == launches[name],
                 f"rank {i}: fp32 {name} by path {by_path}: not all simt")
        rec["launches"] = launches
        out["caches"] = {u: {n: t.cpu() for n, t in leaves.items()}
                         for u, leaves in caches.items()}
        big = lm.graft_cache_slots(
            lm.init_cache(sb.ctx, b, s + spec["gen"]),
            lm.shard_prompt_cache(sb.ctx, caches, s + spec["gen"]),
            slots=range(b))
        tok = logits[:, -1:].argmax(-1) % cfg.vocab_size
        toks = [tok]
        for t in range(spec["gen"]):
            cl = torch.full((b,), s + t + 1, device=dev)
            tok, _, big = sb.decode_fn(params, tok, big, cl)
            toks.append(tok)
        out["tokens"] = torch.cat(toks, dim=1).cpu()
    torch.save(out, Path(out_dir) / f"{tag}{i}.pt")
    del params
    release(torch)
    return rec


def ring_serve(torch, out_dir, rank, argv=None, gen=None, tag="serve"):
    """The bf16 serve through the entry point's ``serve`` with the CLI's
    arguments (``argv``; by default RING_SERVE's: ``--auto-plan``, 30
    layers; ``gen`` its new tokens): launches by path from zero, prefill
    ms, ms/token, peak GB and the host-staged transport's share; the
    tokens and the prefill's last logits to ``<tag><rank>.pt``."""
    from repro_torch.launch.serve import build_parser, serve

    spec = RING_SERVE
    if argv is None:
        argv = ["--arch", spec["arch"], "--auto-plan", "--batch",
                str(spec["batch"]), "--prompt-len", str(spec["prompt_len"]),
                "--gen", str(spec["gen"]),
                "--plan-cache", str(Path(out_dir) / f"plans{rank}")]
        gen = spec["gen"]
    args = build_parser().parse_args(
        argv + ["--dist-backend", RING["backend"]])
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    zero_launches()
    t0 = time.perf_counter()
    res = serve(args, keep_tokens=True, stats=stats)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, paths = read_launches(), read_paths()
    dist = stats["dist"]
    stage = dist.stage
    decode_s = res["ms_per_token"] * gen / 1e3
    torch.save(dict(tokens=torch.tensor(res.pop("tokens")),
                    logits=stats["prefill_logits"][:, -1].float().cpu()),
               Path(out_dir) / f"{tag}{rank}.pt")
    return dict(
        serve=res, mesh=list(dist.mesh_shape), coords=list(dist.coords),
        launches=launches, launches_by_path=paths,
        prefill_ms=stats["prefill_ms"], ms_per_token=res["ms_per_token"],
        peak_gb=torch.cuda.max_memory_allocated() / 1e9, wall_s=wall_s,
        transport_s=stage.seconds, transport_calls=stage.calls,
        transport_gb=stage.bytes / 1e9,
        prefill_transport_share=stats["prefill_transport_s"]
        / (stats["prefill_ms"] / 1e3),
        decode_transport_share=(stage.seconds - stats["prefill_transport_s"])
        / decode_s)


def ring_rank_main(out_dir) -> int:
    """One rank of phase 11, started by :func:`run_ranks`: the
    transport check, fp32 parity and the bf16 serve, its record to
    ``rank<rank>.json``; then phases 16 and 17."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as tdist
    from repro_torch.core.dist import (init_world, make_mesh_dist,
                                       world_from_env)

    rank, world, local = world_from_env()
    dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_world(RING["backend"])
    try:
        dist = make_mesh_dist(RING["mesh"], dev)
        t0 = time.perf_counter()
        rec = dict(rank=rank, transport=ring_transport(torch, dist))
        rec["parity"] = ring_parity(torch, dist, out_dir)
        rec["parity_s"] = time.perf_counter() - t0
        rec.update(ring_serve(torch, out_dir, rank))
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(rec))
        ring_engine(torch, out_dir, rank)  # phase 16
        ring_window(torch, dist, out_dir, rank)  # phase 17
    finally:
        tdist.destroy_process_group()
    return 0


def run_ranks(torch, out_dir, entry="--ring-rank", timeout_s=None):
    """RING["ranks"] processes of this script's rank ``entry`` (phase
    11's ``--ring-rank``, phase 12's ``--train-rank``, ...), each given its
    rank, the world size and the group's address on this host as
    ``torch.distributed.run`` gives them (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``: a free port), each
    in a session of its own, its output to ``rank<i>.log`` in
    ``out_dir``.  (The launcher itself cost each pool ~12 s on the card's
    host: ~8 s before the first rank started, ~4 s after the last one
    ended.)  A rank that fails stops the others; a failure or a timeout
    (RING's by default) raises with the ranks' output."""
    import os
    import signal
    import socket

    timeout_s = timeout_s or RING["timeout_s"]
    n = RING["ranks"]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), WORLD_SIZE=str(n),
               LOCAL_WORLD_SIZE=str(n),
               PYTHONPATH=os.pathsep.join(
                   [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
    logs = [Path(out_dir) / f"rank{i}.log" for i in range(n)]
    procs = []
    for i, path in enumerate(logs):
        with open(path, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), entry,
                 str(out_dir)], env=dict(env, RANK=str(i), LOCAL_RANK=str(i)),
                stdout=f, stderr=subprocess.STDOUT, start_new_session=True))
    deadline, failed = time.monotonic() + timeout_s, None
    while failed is None:
        codes = [p.poll() for p in procs]
        if all(c == 0 for c in codes):
            break
        bad = [i for i, c in enumerate(codes) if c not in (None, 0)]
        if bad:
            failed = f"rank {bad[0]} exited {codes[bad[0]]}"
        elif time.monotonic() > deadline:
            failed = f"the ring's ranks passed {timeout_s} s"
        else:
            time.sleep(0.05)
    for p in procs:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
        p.wait()
    out = "".join(f"--- rank {i}\n{path.read_text(errors='replace')}"
                  for i, path in enumerate(logs))
    for line in out.splitlines():
        if "[plan]" in line or "WaferPlan" in line or "Traceback" in line:
            log(f"  rank output: {line}")
    need(failed is None, f"the ring's ranks failed ({failed}):\n"
         f"{out[-8000:]}")


def degree1_parity(torch, spec=None):
    """The degree-1 fp32 run a ring's fp32 parity ranks are held to
    (``spec``: arch, n_layers, batch, prompt_len, gen, seed; RING_PARITY
    by default): the same tree whole on the card (``init_params``, same
    seed), through the serve bundle: last prefill logits, caches and
    greedy tokens."""
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import lm
    from repro_torch.models.transformer import init_params

    spec = spec or RING_PARITY
    dev = torch.device("cuda")
    cfg = parity_config(spec["arch"], spec["n_layers"],
                        **spec.get("overrides", {}))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        spec["seed"]), dev)
    b, s = spec["batch"], spec["prompt_len"]
    batch = {name: torch.as_tensor(a, device=dev) for name, a in
             prompt_batch(cfg, b, s, seed=spec["seed"]).items()}
    sb = serve_bundle(torch, cfg)
    caches, logits = sb.prefill_fn(params, batch)
    out = dict(logits=logits[:, -1].cpu(),
               caches={u: {n: t.cpu() for n, t in leaves.items()}
                       for u, leaves in caches.items()})
    big = lm.graft_cache_slots(lm.init_cache(sb.ctx, b, s + spec["gen"]),
                               caches, slots=range(b))
    tok = logits[:, -1:].argmax(-1) % cfg.vocab_size
    toks = [tok]
    for t in range(spec["gen"]):
        cl = torch.full((b,), s + t + 1, device=dev)
        tok, _, big = sb.decode_fn(params, tok, big, cl)
        toks.append(tok)
    out["tokens"] = torch.cat(toks, dim=1).cpu()
    del params, caches, big
    release(torch)
    return out


def rel_l2(got, ref):
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


def phase_ring(torch, randn, degree1):
    """Phase 11: deepseek-7b through the TATP ring at model degree 4 on
    four ranks sharing the card (gloo, host-staged).  ``degree1`` holds
    phase 5's degree-1 bf16 run of the same weights (its prefill's last
    logits and tokens).  Phases 16 and 17 run in the same ranks.  Returns
    the ring rows, each rank's run for the kernels line and phase 17's
    additions to it."""
    import tempfile

    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    rows = phase_ring_rows(torch, randn)
    ref = degree1_parity(torch)
    window_pre = window_before_ranks(torch, randn)  # phase 17's first part
    r = RING["ranks"]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        run_ranks(torch, tmp)
        ranks_s = time.perf_counter() - t0
        recs = [json.loads((Path(tmp) / f"rank{i}.json").read_text())
                for i in range(r)]
        par = [torch.load(Path(tmp) / f"parity{i}.pt") for i in range(r)]
        srv = [torch.load(Path(tmp) / f"serve{i}.pt") for i in range(r)]
        engine_runs = phase_ring_engine(torch, tmp)  # phase 16
        window, window_runs = phase_window(torch, tmp, window_pre)
    for rec in recs:
        log(f"[ring] rank {rec['rank']} transport "
            f"{json.dumps(rec['transport'])}")
    # fp32 parity: mesh (1, 4) against degree 1 on the same tree
    cfg = parity_config(RING_PARITY["arch"], RING_PARITY["n_layers"])
    tol = GEMM_TOL["float32"]
    compare("ring fp32 prefill logits vs degree 1", par[0]["logits_native"],
            ref["logits"], *tol)
    sl = RING_PARITY["prompt_len"] // r
    for i, p in enumerate(par):
        need(torch.equal(p["logits_native"], par[0]["logits_native"]),
             f"rank {i}'s gathered logits differ from rank 0's")
        for u, leaves in p["caches"].items():
            for n, t in leaves.items():
                compare(f"ring fp32 rank {i} prefill cache {u}.{n}", t,
                        ref["caches"][u][n][:, :, i * sl:(i + 1) * sl], *tol)
        need(torch.equal(p["tokens"], ref["tokens"]),
             f"rank {i}: ring tokens {p['tokens'].tolist()} != degree 1 "
             f"{ref['tokens'].tolist()}")
    log(f"  fp32 greedy tokens identical to degree 1: "
        f"{ref['tokens'].tolist()}")
    wires = {}
    for wire in RING_WIRE_TOL:
        got = par[0][f"logits_{wire}"]
        wires[wire] = dict(
            max_rel=((got - ref["logits"]).abs().max()
                     / ref["logits"].abs().max()).item(),
            rel_l2=rel_l2(got, ref["logits"]))
    log(f"[ring] wires: prefill logits vs degree 1 fp32 {json.dumps(wires)}"
        f" (max_rel limits {json.dumps(RING_WIRE_TOL)})")
    for wire, wtol in RING_WIRE_TOL.items():
        need(wires[wire]["max_rel"] <= wtol, f"{wire} wire: prefill logits "
             f"max_rel {wires[wire]['max_rel']:.3e} > {wtol}")
    # the bf16 serve: its numbers first, then the gates
    full = get_config(RING_SERVE["arch"])
    got, want = srv[0]["logits"], degree1["logits"]
    err = rel_l2(got, want)
    maxerr = (got - want).abs().max().item()
    # phase 5's degree-1 serve decoded GEN tokens; greedy decoding is
    # causal, so its first RING_SERVE["gen"] + 1 compare
    tokens1 = torch.tensor(degree1["tokens"])[:, :RING_SERVE["gen"] + 1]
    first, first1 = srv[0]["tokens"][:, 0], tokens1[:, 0]
    top2 = want.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    agree = (srv[0]["tokens"] == tokens1).float()
    summary = dict(
        prefill_logits_rel_l2=err, prefill_logits_max_abs=maxerr,
        first_tokens=first.tolist(), degree1_first_tokens=first1.tolist(),
        degree1_top2_margin=margin.tolist(),
        token_agreement=agree.mean().item(),
        rows_identical=[bool(a.all()) for a in agree],
        ranks_wall_s=ranks_s, phase_s=time.perf_counter() - t_phase,
        per_rank=[{k: rec[k] for k in (
            "prefill_ms", "ms_per_token", "peak_gb", "transport_s",
            "transport_calls", "transport_gb", "prefill_transport_share",
            "decode_transport_share", "wall_s", "parity_s", "mesh",
            "launches", "launches_by_path")} for rec in recs])
    log(f"[ring] deepseek-7b 30 layers bf16 over {r} ranks, mesh "
        f"{RING['mesh']}, {RING['backend']}: {json.dumps(summary)}")
    runs = {}
    for i, rec in enumerate(recs):
        need(rec["mesh"] == list(RING["mesh"]),
             f"--auto-plan gave mesh {rec['mesh']}, not {RING['mesh']}")
        want_n = ring_launches(full, r, rec["coords"][1])
        need(rec["launches"] == want_n,
             f"rank {i}: launches {rec['launches']} != {want_n}")
        for name, path in MAIN_PATH_KERNEL.items():
            need(rec["launches_by_path"][name][path] == want_n[name],
                 f"rank {i}: {name} by path {rec['launches_by_path'][name]}")
        need(torch.equal(srv[i]["tokens"], srv[0]["tokens"]),
             f"rank {i}'s tokens differ from rank 0's")
        runs[f"deepseek-7b ring {tuple(RING['mesh'])} rank {i}"] = (
            rec["launches"], rec["launches_by_path"])
    runs.update(engine_runs)
    runs.update(window_runs)
    need(err <= RING_BF16_TOL, f"bf16 ring prefill logits rel L2 {err:.3e} "
         f"> {RING_BF16_TOL}")
    for row in range(len(first)):
        # a flip is possible only where the degree-1 margin is within
        # twice the logits' largest difference
        need(first[row] == first1[row] or margin[row] <= 2 * maxerr,
             f"row {row}: first token {first[row]} != degree 1's "
             f"{first1[row]} at margin {margin[row]:.3e}")
    return rows, runs, window


# ---------------------------------------------------------------------------
# phase 16: engine mode on the ring, in phase 11's ranks
# ---------------------------------------------------------------------------

# deepseek-7b at full width cut to 4 layers, bf16, under the full model's
# --auto-plan ServePlan (4 slots x 136 tokens: (1, 4) on four ranks);
# prompts of 128 tokens, 8 new tokens a request
RING_ENGINE = dict(arch="deepseek-7b", layers=4, max_batch=4, prompt_len=128,
                   max_new=8)
# the offered load: Poisson arrivals at RING_ENGINE_RATE a second (seed 0),
# at most 60 % of what 4 slots serve at the measured call times: a
# prefill group 1.94-1.99 s and a decode call 0.29-0.35 s give 0.90-1.005
# requests a second (PERF.md section 5; 0.8 a second, 80 %, queued); the
# faults land at RING_ENGINE_FAULT_AT s of the engine's clock, two
# requests in flight
RING_ENGINE_RATE = 0.5
RING_ENGINE_FAULT_AT = 7.0
# (label, requests, --fault-frac or None, the mesh the run ends on); the
# fault-free run 3 requests since the whole run needed the time (6 until
# phase 13's part (e) did, 4 until then)
RING_ENGINE_RUNS = (("fault-free", 3, None, (1, 4)),
                    ("fault 1/8", 4, 0.125, (1, 4)),
                    ("fault 1/4", 4, 0.25, (2, 2)))
# fp32 parity (TF32 off): 2 layers at full width under the same plan, the
# kernels against the plain hooks, one wave of 4 requests on a virtual
# clock (1.0 s a call)
RING_ENGINE_PARITY = dict(n_layers=2, prompt_lens=(128, 64), max_new=4)
RING_ENGINE_S = 60  # the phase's budget of wall clock


class RankCalls:
    """A rank's executor wrapper in phase 16 (every rank makes the same
    calls): each call's kind, host ms, prompt-length groups, mesh and
    ring index, its kernel launches (the counters read before and after
    it) and the staged transport it added (seconds, bytes, calls; across
    a migration the old mesh's stage and the new one's); each migration's
    survivors' global cache rows gathered before and after it (a
    collective, on every rank) and compared bit for bit.  Returns None:
    the wall clock stands."""

    def __init__(self, inner):
        self.inner = inner
        self.calls, self.moves = [], []

    def _staged(self, fn):
        old = self.inner.dist.stage
        s0 = (old.seconds, old.bytes, old.calls) if old else (0.0, 0, 0)
        fn()
        d = [getattr(old, k) - v if old else 0 for k, v in
             zip(("seconds", "bytes", "calls"), s0)]
        new = self.inner.dist.stage
        if new is not old and new is not None:
            d = [d[0] + new.seconds, d[1] + new.bytes, d[2] + new.calls]
        return d

    def _call(self, kind, fn, groups=0):
        dist = self.inner.dist
        rec = dict(kind=kind, groups=groups, mesh=list(dist.mesh_shape),
                   ring_index=dist.coords[1])
        before = read_launches()
        t0 = time.perf_counter()
        rec["staged_s"], rec["staged_bytes"], rec["staged_calls"] = \
            self._staged(fn)
        rec["ms"] = (time.perf_counter() - t0) * 1e3
        after = read_launches()
        rec["launches"] = {k: after[k] - before[k] for k in after}
        self.calls.append(rec)

    def prefill(self, states):
        groups = len({st.req.prompt_len for st in states})
        self._call("prefill", lambda: self.inner.prefill(states), groups)

    def decode(self, states):
        self._call("decode", lambda: self.inner.decode(states))

    def migrate(self, new_plan, mig, wafer=None):
        import torch
        olds = [o for _, o, _ in mig.survivors]
        news = [n for _, _, n in mig.survivors]
        before = self.inner.global_cache(olds)
        self._call("migrate",
                   lambda: self.inner.migrate(new_plan, mig, wafer))
        after = self.inner.global_cache(news)
        self.moves.append(dict(
            self.inner.last_migration, survivors=len(olds),
            mesh=list(self.inner.dist.mesh_shape),
            exact=all(torch.equal(before[u][n], after[u][n])
                      for u in before for n in before[u])))


def ring_engine_run(torch, out_dir, label, requests, frac, spec=None,
                    rate=None, plans="engine_plans"):
    """``serve_engine`` (``launch.serve --serve --auto-plan --layers 4``,
    ``spec`` and ``rate``: RING_ENGINE's by default; the plans cached
    under ``plans``) on every rank of the world, each rank's executor in
    a :class:`RankCalls`: the launch counts zeroed just before it and read
    just after."""
    from repro_torch.launch.serve import build_parser, serve_engine

    e = spec or RING_ENGINE
    argv = ["--arch", e["arch"], "--serve", "--auto-plan", "--layers",
            str(e["layers"]), "--max-batch", str(e["max_batch"]),
            "--prompt-len", str(e["prompt_len"]), "--max-new",
            str(e["max_new"]), "--requests", str(requests), "--rate",
            str(rate or RING_ENGINE_RATE), "--dist-backend",
            RING["backend"], "--plan-cache", str(Path(out_dir) / plans)]
    if frac is not None:
        argv += ["--fault-at", str(RING_ENGINE_FAULT_AT), "--fault-frac",
                 str(frac)]
    wrapped = []

    def wrap(ex):
        wrapped.append(RankCalls(ex))
        return wrapped[0]

    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    rep = serve_engine(build_parser().parse_args(argv), executor=wrap)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    calls = wrapped[0]
    link = calls.inner.link
    return dict(label=label, report=rep, calls=calls.calls,
                moves=calls.moves, launches=read_launches(),
                launches_by_path=read_paths(), wall_s=wall_s,
                link_calls=link.calls, link_bytes=link.bytes,
                mesh_after=list(calls.inner.dist.mesh_shape))


def ring_engine_parity(torch, out_dir, rank):
    """fp32 (TF32 off), 2 layers at full width under the (1, 4) plan of
    the runs before: the engine on the kernels, then on the plain hooks,
    each on a virtual clock (1.0 s a call), rank 0 leading; every
    prefill's last logits and, on rank 0, the token streams and report."""
    import dataclasses

    from repro_torch.core.plan import ServePlan
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.tatp_matmul.ref import matmul_ref
    from repro_torch.launch.serve import (CommandLink, LeaderExecutor,
                                          TorchServeExecutor, follow)
    from repro_torch.serve.engine import Request, ServeEngine, VirtualClock

    spec = RING_ENGINE_PARITY
    plans = [ServePlan.load(str(f)) for f in
             sorted((Path(out_dir) / "engine_plans").glob("splan_*.json"))]
    plan = next(p for p in plans if p.plan.tatp == 4
                and not p.plan.failed_dies)
    cfg = parity_config(RING_ENGINE["arch"], spec["n_layers"])
    plens = spec["prompt_lens"]
    reqs = [Request(rid=i, arrival=0.0, prompt_len=plens[i % len(plens)],
                    max_new_tokens=spec["max_new"]) for i in range(4)]
    plain = dict(dot=matmul_ref, attention=attention_ref)
    link = CommandLink()
    out = {}
    for name, hooks in (("kernels", {}), ("plain", plain)):
        ex = TorchServeExecutor(plan, cfg, device=torch.device(
            "cuda", torch.cuda.current_device()), **hooks)
        logits = []
        inner = ex.sb.prefill_fn

        def recorded(params, batch, inner=inner, logits=logits):
            caches, lg = inner(params, batch)
            logits.append(lg[:, -1].float().cpu())
            return caches, lg

        ex.sb = dataclasses.replace(ex.sb, prefill_fn=recorded)
        calls = RankCalls(ex)
        zero_launches()
        if rank == 0:
            lead = LeaderExecutor(calls, link)

            class Fixed:
                def prefill(self, states):
                    lead.prefill(states)
                    return 1.0

                def decode(self, states):
                    lead.decode(states)
                    return 1.0

            err = None
            try:
                eng = ServeEngine(plan, Fixed(), clock=VirtualClock(),
                                  cfg=cfg)
                rep = eng.run([Request(**vars(r)) for r in reqs])
            except BaseException as e:
                err = e
                raise
            finally:
                lead.stop(err)
            out[name] = dict(report=rep.to_dict(), streams=sorted(
                (st.req.rid, tuple(st.tokens))
                for st in eng.sched.finished))
        else:
            follow(calls, link)
            out[name] = {}
        torch.cuda.synchronize()
        out[name].update(launches=read_launches(), calls=len(calls.calls))
        torch.save(logits, Path(out_dir) / f"engine_parity_{name}{rank}.pt")
        del ex, calls
        release(torch)
    return out


def ring_engine(torch, out_dir, rank):
    """Phase 16 on one rank: the fault-free run, the two faults, the fp32
    parity; the records to ``engine<rank>.json``."""
    t0 = time.perf_counter()
    rec = dict(rank=rank, runs=[ring_engine_run(torch, out_dir, label, n,
                                                frac)
                                for label, n, frac, _ in RING_ENGINE_RUNS])
    rec["runs_s"] = time.perf_counter() - t0
    rec["parity"] = ring_engine_parity(torch, out_dir, rank)
    rec["phase_s"] = time.perf_counter() - t0
    (Path(out_dir) / f"engine{rank}.json").write_text(json.dumps(rec))


def ring_engine_rank_main(out_dir) -> int:
    """One rank of phase 16 alone (``--ring-engine-rank``)."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as tdist
    from repro_torch.core.dist import init_world, world_from_env

    rank, _, local = world_from_env()
    dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_world(RING["backend"])
    try:
        ring_engine(torch, out_dir, rank)
    finally:
        tdist.destroy_process_group()
    return 0


def ring_engine_capacity(calls, spec=None):
    """Requests a second that 4 slots serve at a run's call times: one
    prefill of a full group (its median) and ``max_new - 1`` decode calls
    (their median) for every ``max_batch`` requests (``spec``:
    RING_ENGINE's by default)."""
    e = spec or RING_ENGINE
    med = {}
    for kind in ("prefill", "decode"):
        ms = sorted(c["ms"] for c in calls if c["kind"] == kind)
        med[kind] = ms[len(ms) // 2]
    return med, e["max_batch"] / (
        (med["prefill"] + (e["max_new"] - 1) * med["decode"]) / 1e3)


def calls_by_kind(calls):
    """A rank's :class:`RankCalls` records summed by kind: the count, the
    median and largest host ms, the staged share of the time and the GB
    staged."""
    out = {}
    for kind in ("prefill", "decode", "migrate"):
        cs = [c for c in calls if c["kind"] == kind]
        if cs:
            ms = sorted(c["ms"] for c in cs)
            out[kind] = dict(
                n=len(cs), ms_p50=ms[len(ms) // 2], ms_max=ms[-1],
                staged_share=sum(c["staged_s"] for c in cs) / (sum(ms) / 1e3),
                staged_gb=sum(c["staged_bytes"] for c in cs) / 1e9)
    return out


def phase_ring_engine(torch, out_dir):
    """Phase 16's checks on the ranks' records (``engine<rank>.json``):
    (a) fault-free: every request finished with its 8 tokens, on every
    rank exactly one ring prefill's launches per prefill group (28 GEMM
    tiles a layer on ``wgmma``, i + 1 flash rounds a layer on rank i on
    ``mma``) and none in a decode, every call on every rank; (b) one
    replan at the 1/8 fault, to the plan ``replan_serve`` solves offline,
    the mesh kept at (1, 4) and the survivors grafted in place bit for
    bit; (c) one replan at the 1/4 fault to (2, 2), caches and weights
    resharded, the survivors' rows moved bit for bit; (b, c) every
    request finished or rejected with a reason; (d) fp32 parity of the
    engine on the kernels against the plain hooks: identical token
    streams and reports, every prefill's logits within phase 11's
    tolerance.  Returns each rank's runs for the kernels line."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.core.plan import ServePlan, replan_serve
    from repro_torch.wafer.fault import sample_die_faults

    r = RING["ranks"]
    recs = [json.loads((Path(out_dir) / f"engine{i}.json").read_text())
            for i in range(r)]
    e = RING_ENGINE
    cfg = replace(get_config(e["arch"]), n_layers=e["layers"])
    full = get_config(e["arch"])
    plans = {p.plan_hash: p for p in (
        ServePlan.load(str(f))
        for f in (Path(out_dir) / "engine_plans").glob("splan_*.json"))}
    card = CARD["smi"]
    runs = {}
    for k, (label, sent, frac, mesh) in enumerate(RING_ENGINE_RUNS):
        what = f"ring engine {label}"
        rep = recs[0]["runs"][k]["report"]
        rank_runs = [rec["runs"][k] for rec in recs]
        for i, run in enumerate(rank_runs):
            n_calls = [c["kind"] for c in run["calls"]]
            need(n_calls == [c["kind"] for c in rank_runs[0]["calls"]],
                 f"{what}: rank {i} made calls {n_calls}, rank 0 "
                 f"{[c['kind'] for c in rank_runs[0]['calls']]}")
            need(run["link_calls"] == rank_runs[0]["link_calls"],
                 f"{what}: rank {i} took {run['link_calls']} commands")
            need(run["mesh_after"] == list(mesh),
                 f"{what}: rank {i} ended on {run['mesh_after']}")
            total = {}
            for c in run["calls"]:
                if c["kind"] == "prefill":
                    one = ring_launches(cfg, c["mesh"][1], c["ring_index"])
                    want = {n: v * c["groups"] for n, v in one.items()}
                else:
                    want = {n: 0 for n in c["launches"]}
                need(c["launches"] == want, f"{what}: rank {i} {c['kind']} "
                     f"on {c['mesh']} launched {c['launches']}, want {want}")
                for n, v in c["launches"].items():
                    total[n] = total.get(n, 0) + v
            need(total == run["launches"], f"{what}: rank {i} launched "
                 f"{run['launches']} in all, its calls {total}")
            for name, kpath in MAIN_PATH_KERNEL.items():
                need(run["launches_by_path"][name][kpath]
                     == run["launches"][name],
                     f"{what}: rank {i} {name} by path "
                     f"{run['launches_by_path'][name]}")
            runs[f"deepseek-7b engine ring {label} rank {i}"] = (
                run["launches"], run["launches_by_path"])
        need(rep["mode"] == "torch" and rep["n_requests"] == sent,
             f"{what}: {rep['mode']}, {rep['n_requests']} of {sent}")
        if frac is None:
            need(rep["n_finished"] == sent and rep["generated_tokens"]
                 == sent * e["max_new"] and rep["n_replans"] == 0,
                 f"{what}: {rep['n_finished']} finished, "
                 f"{rep['generated_tokens']} tokens, {rep['n_replans']} "
                 f"replans")
            med, cap = ring_engine_capacity(rank_runs[0]["calls"])
            log(f"[engine ring] capacity: prefill group {med['prefill']:.1f}"
                f" ms, decode call {med['decode']:.1f} ms (medians) -> "
                f"{cap:.3f} requests/s; offered {RING_ENGINE_RATE}/s = "
                f"{RING_ENGINE_RATE / cap:.1%} ({card})")
        else:
            need(rep["n_replans"] == 1 and len(rep["recovery"]) == 1,
                 f"{what}: {rep['n_replans']} replans")
            ev = rep["recovery"][0]
            plan = plans[ev["old_plan_hash"]]
            wafer = plan.plan.wafer()
            dies = sample_die_faults(wafer, frac, seed=0).failed_dies
            need(tuple(ev["failed_dies"]) == tuple(dies),
                 f"{what}: the fault killed {ev['failed_dies']}, the "
                 f"sampler gives {dies}")
            offline = replan_serve(plan, full, wafer.with_faults(dies, ()),
                                   use_cache=False)
            need(ev["new_plan_hash"] == offline.plan_hash,
                 f"{what}: adopted {ev['new_plan_hash']}, offline "
                 f"replan_serve gives {offline.plan_hash}")
            need(rep["n_finished"] + rep["n_rejected"] == sent
                 and all(reason for _, reason in rep["rejected"]),
                 f"{what}: {rep['n_finished']} finished, rejected "
                 f"{rep['rejected']}")
            for i, run in enumerate(rank_runs):
                need(len(run["moves"]) == 1, f"{what}: rank {i} migrated "
                     f"{len(run['moves'])} times")
                mv = run["moves"][0]
                want = ("graft", "kept") if mesh == (1, 4) \
                    else ("reshard", "recut")
                need((mv["path"], mv["weights"]) == want
                     and mv["mesh"] == list(mesh),
                     f"{what}: rank {i} migration {mv}")
                need(mv["survivors"] > 0 and mv["exact"],
                     f"{what}: rank {i} moved {mv['survivors']} survivors, "
                     f"bit for bit {mv['exact']}")
        staged = [dict(rank=i, s=sum(c["staged_s"] for c in run["calls"]),
                       gb=sum(c["staged_bytes"] for c in run["calls"]) / 1e9,
                       calls=sum(c["staged_calls"] for c in run["calls"]),
                       command_bytes=run["link_bytes"],
                       commands=run["link_calls"])
                  for i, run in enumerate(rank_runs)]
        keys = ("n_finished", "n_rejected", "generated_tokens", "ttft_p50",
                "ttft_p99", "tpot_p50", "tpot_p99", "tokens_per_s",
                "makespan", "mean_occupancy", "n_replans")
        out = {k: rep[k] for k in keys}
        calls0 = rank_runs[0]["calls"]
        by_kind = calls_by_kind(calls0)
        out.update(requests_sent=sent, rate=RING_ENGINE_RATE,
                   prefill_groups=sum(c["groups"] for c in calls0
                                      if c["kind"] == "prefill"),
                   calls=by_kind, wall_s=rank_runs[0]["wall_s"],
                   staged=staged)
        if frac is not None:
            ev = rep["recovery"][0]
            out["recovery"] = dict(
                {key: ev[key] for key in (
                    "old_plan_hash", "new_plan_hash", "pause_s", "n_active",
                    "n_survivors", "n_evicted", "old_max_batch",
                    "new_max_batch")},
                migrate=[dict(rank=i, **run["moves"][0])
                         for i, run in enumerate(rank_runs)],
                migrate_ms=[c["ms"] for c in calls0
                            if c["kind"] == "migrate"])
        log(f"[engine ring] deepseek-7b {e['layers']} layers bf16, {label}: "
            f"{json.dumps(out)} ({card})")
    # (d) fp32 parity, kernels against plain hooks
    par = recs[0]["parity"]
    need(par["kernels"]["streams"] == par["plain"]["streams"],
         "ring engine parity: token streams differ between the kernels "
         "and the plain hooks")
    need(par["kernels"]["report"] == par["plain"]["report"],
         "ring engine parity: reports differ")
    need(par["kernels"]["report"]["n_finished"] == 4,
         f"ring engine parity: {par['kernels']['report']['n_finished']} "
         f"finished")
    tol = GEMM_TOL["float32"]
    for i in range(r):
        kern = torch.load(Path(out_dir) / f"engine_parity_kernels{i}.pt")
        ref = torch.load(Path(out_dir) / f"engine_parity_plain{i}.pt")
        need(len(kern) == len(ref) > 0, f"ring engine parity rank {i}: "
             f"{len(kern)} and {len(ref)} prefills")
        for j, (a, b) in enumerate(zip(kern, ref)):
            compare(f"ring engine fp32 rank {i} prefill {j} logits", a, b,
                    *tol)
        p = recs[i]["parity"]
        need(p["kernels"]["launches"]["tatp_matmul"] > 0
             and p["kernels"]["launches"]["flash_attention"] > 0
             and not any(p["plain"]["launches"].values()),
             f"ring engine parity rank {i}: kernels launched "
             f"{p['kernels']['launches']}, plain {p['plain']['launches']}")
    log(f"[engine ring] fp32 parity, 2 layers, (1, 4): streams and report "
        f"identical, {len(kern)} prefills' logits within {tol} "
        f"({json.dumps(par['kernels']['streams'])})")
    phase_s = recs[0]["phase_s"]
    log(f"[engine ring] phase 16 on the ranks: {phase_s:.1f} s (runs "
        f"{recs[0]['runs_s']:.1f} s; budget {RING_ENGINE_S} s) ({card})")
    return runs


def phase_ring_engine_alone(torch):
    """Phase 16 without phase 11 (its own four ranks): for a quick check
    of the phase on the card after ``phase_device`` and ``phase_build``."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        run_ranks(torch, tmp, entry="--ring-engine-rank")
        return phase_ring_engine(torch, tmp)


# ---------------------------------------------------------------------------
# phase 17: gemma2-9b's windowed layers on the ring, in phase 11's ranks
# ---------------------------------------------------------------------------

# the offset sweep on both paths: small shapes across the tiles' edges
# (mma: 64 query rows and 64 keys a tile, 32 keys at D 256; simt: 32 and
# 32), (causal, window) pairs; at offset 300 every key lies outside the
# window
WINDOW_SWEEP = dict(batch=2, heads=8, kv_heads=2, sq=130, skv=200, cap=30.0,
                    offsets=(0, 1, 63, 64, 100, 200, 300), dims=(64, 256),
                    masks=((True, None), (True, 96), (False, 96)))
# (a) fp32 parity: 2 layers (LG) at full width, 1 x 8192, 4 new tokens,
# against the same tree whole at degree 1
WINDOW_PARITY = dict(arch="gemma2-9b", n_layers=2, batch=1, prompt_len=8192,
                     gen=4, seed=3)
# (b) the bf16 serve, 4 layers (LGLG), 1 x 8192, 4 new tokens, through
# launch.serve --mesh 1 4: --auto-plan gives gemma2-9b's 1 x 8196 tokens
# a megatron WaferPlan on (4, 1), whose data degree one row cannot fill
WINDOW_SERVE = dict(arch="gemma2-9b", layers=4, batch=1, prompt_len=8192,
                    gen=4)
# its flash launches a prefill on ranks 0-3: G slots i + 1, L slots i + 1
# but rank 3's round on block 0, whose nearest pair is 4097 apart
WINDOW_SERVE_FLASH = [4, 8, 12, 14]
# (c) engine mode through launch.serve --serve --auto-plan (the full
# model's ServePlan for 4 slots x 4612 tokens is tatp on (1, 4)), 4
# layers, bf16, 3 requests (4 until the whole run needed the time) of
# 4608 prompt tokens (past the window), 4 new tokens each, at a fixed 0.5
# requests a second.  Set from a first run's call times (a
# prefill group, padded to 4 x 4608, 3.37 s; a decode call 0.30 s): the
# slots served 0.936/s, 0.8/s queued (85 %) and 0.5/s was 53 %.  The share
# moves with the host: 49-57 % of the 0.87-1.03/s of later runs, 32 % of
# a faster host's 1.546/s (PERF.md section 5).  check_window_engine logs
# it as offered_share and holds it to nothing
WINDOW_ENGINE = dict(arch="gemma2-9b", layers=4, max_batch=4,
                     prompt_len=4608, max_new=4)
WINDOW_ENGINE_REQUESTS = 3
WINDOW_ENGINE_RATE = 0.5
WINDOW_S = 45  # the phase's budget of wall clock


def window_cfg(layers):
    """gemma2-9b at full width cut to ``layers`` layers."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    return replace(get_config(WINDOW_SERVE["arch"]), n_layers=layers)


def window_sweep(torch, randn):
    """The forward kernel at query offsets (WINDOW_SWEEP) on both paths
    against :func:`attention_ref` at the same offset: one launch each on
    its path, the output and the live rows' LSE within ATTN_TOL, and the
    rows that see no key exactly 0 with an LSE at or below -1e29 (the
    plain version's -1e30).  Returns the largest error by path."""
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    w = WINDOW_SWEEP
    errs, empty_rows, checks = {}, 0, 0
    for dtype, path in ((torch.float32, "simt"), (torch.bfloat16, "mma")):
        rtol, atol = ATTN_TOL[str(dtype).split(".")[-1]]
        err = 0.0
        for d in w["dims"]:
            q = randn(w["batch"], w["heads"], w["sq"], d, dtype=dtype)
            k, v = (randn(w["batch"], w["kv_heads"], w["skv"], d,
                          dtype=dtype) for _ in range(2))
            for off in w["offsets"]:
                for causal, window in w["masks"]:
                    kw = dict(causal=causal, window=window, cap=w["cap"],
                              q_offset=off, return_lse=True)
                    what = (f"offset sweep {path} D {d} offset {off} "
                            f"causal {causal} window {window}")
                    before = attention.launches_by_path[path]
                    o, lse = attention(q, k, v, **kw)
                    torch.cuda.synchronize()
                    need(attention.launches_by_path[path] == before + 1,
                         f"{what}: not one {path} launch")
                    o_ref, lse_ref = attention_ref(q, k, v, **kw)
                    empty = lse_ref <= -1e29
                    need(torch.equal(empty, lse <= -1e29),
                         f"{what}: the rows with no key differ")
                    need(not o[empty].any(),
                         f"{what}: a row with no key is not 0")
                    err = max(err, compare(what, o, o_ref, rtol, atol),
                              compare(what + " LSE", lse[~empty],
                                      lse_ref[~empty], rtol, atol))
                    empty_rows += int(empty.sum())
                    checks += 1
        errs[path] = err
    log(f"[window] offset sweep, {checks} launches ({w['sq']} queries x "
        f"{w['skv']} keys, D {list(w['dims'])}, offsets "
        f"{list(w['offsets'])}): max_abs_err {json.dumps(errs)}; "
        f"{empty_rows} rows with no key, each 0 with LSE <= -1e29")
    return errs


def window_launches(cfg, r, tokens):
    """gemma2-9b's distinct ``L``-slot flash launches on a causal ring of
    ``r`` ranks over ``tokens`` positions, contiguous (the serve path's)
    and zigzag (training's), as :meth:`_Ring.launches` makes them for rank
    ``i``'s round on block ``j``: ``{(zigzag, sq, sk, causal, q_offset,
    window): launches a layer over the r ranks}``.  At (1, 4) on 8192
    tokens under window 4096: the own block causal, a block 2048 back
    unmasked at offset 0 (neither mask hides a pair), 4096 back windowed at
    offset 4096, 6144 back none; zigzag's 1024-row chunks the same."""
    from repro_torch.models.attention import _Ring

    s_loc, out = tokens // r, {}
    for zigzag in (False, True):
        ring = _Ring("model", r, True, cfg.attn_softcap, False, None, None,
                     None, None, zigzag=zigzag, window=cfg.sliding_window)
        for i in range(r):
            for j in range(r):
                for qs, ks, causal, off, window in ring.launches(i, j,
                                                                 s_loc):
                    key = (zigzag, len(range(s_loc)[qs]),
                           len(range(s_loc)[ks]), causal, off, window)
                    out[key] = out.get(key, 0) + 1
    return dict(sorted(out.items(), key=lambda kv: (kv[0][0], not kv[0][3],
                                                    kv[0][4])))


def window_rows(torch, randn):
    """gemma2-9b's distinct ring launches (:func:`window_launches` at (1,
    4) on WINDOW_SERVE's 8192 tokens), bf16 on ``mma``, in the model's
    ``[B, S, H, D]`` layout viewed as ``[B, H, S, D]``, q scaled by
    :func:`cap_scale` so the cap bites: the output against
    :func:`attention_ref` (atol scaled by each row's RMS, as phase 6 holds
    flash) and the live rows' LSE, the rows that see no key exactly 0 with
    LSE <= -1e29; each timed beside its bound over the visible pairs
    (:func:`attn_pairs` at the offset), its plain version and
    :func:`flex_yardstick` (SDPA takes no soft-cap)."""
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    cfg = window_cfg(2)
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cap = cfg.attn_softcap
    bf = torch.bfloat16
    rows = []
    launches = window_launches(cfg, RING["ranks"], WINDOW_SERVE["prompt_len"])
    for (zigzag, sq, sk, causal, off, window), n in launches.items():
        q = randn(1, sq, hq, d, dtype=bf, scale=cap_scale(cap)).transpose(
            1, 2)
        k, v = (randn(1, sk, hkv, d, dtype=bf).transpose(1, 2)
                for _ in range(2))
        kw = dict(causal=causal, window=window, cap=cap, q_offset=off,
                  return_lse=True)
        mask = "causal" if causal else "window" if window else "unmasked"
        name = (f"gemma2-9b ring {'zigzag c x c' if zigzag else 'round'} "
                f"[1,{hq},{sq},{d}] {mask} offset {off}")
        before = attention.launches_by_path["mma"]
        o, lse = attention(q, k, v, **kw)
        torch.cuda.synchronize()
        need(attention.launches_by_path["mma"] == before + 1,
             f"{name}: did not take mma")
        o_ref, lse_ref = attention_ref(q, k, v, **kw)
        empty = lse_ref <= -1e29
        need(torch.equal(empty, lse <= -1e29) and not o[empty].any(),
             f"{name}: the rows with no key are not 0 with LSE -1e30")
        err = max(compare(name, o, o_ref, *ATTN_TOL["bfloat16"], rms="row"),
                  compare(name + " row LSE", lse[~empty], lse_ref[~empty],
                          *ATTN_TOL["bfloat16"]))
        pairs = hq * attn_pairs(sq, sk, causal, window, off)
        # q, k, v in and o out in bf16, the row LSE out in fp32
        nbytes = 2 * d * (2 * hq * sq + 2 * hkv * sk) + 4 * hq * sq
        row = dict(name=name, shape=[1, hq, sq, d], kv_heads=hkv, skv=sk,
                   q_offset=off, causal=causal, window=window, cap=cap,
                   path="mma", launches_a_layer=n, max_abs_err=err,
                   empty_rows=int(empty.sum()), visible_pairs=pairs,
                   ms=time_ms(torch, lambda: attention(q, k, v, **kw), 20),
                   plain_ms=time_ms(torch, lambda: attention_ref(
                       q, k, v, **kw), 3, 1))
        row["library_ms"], row["library"] = flex_yardstick(
            torch, name, q, k, v, kw, o_ref, live=~empty)
        row["library_ratio"] = row["ms"] / row["library_ms"]
        row["bound_ms"], row["bound_by"] = bound(4 * pairs * d, nbytes,
                                                 "bfloat16")
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        log(f"  timing {name}: {json.dumps(row)} ({CARD['smi']})")
        rows.append(row)
    return rows


def window_degree1(torch):
    """The degree-1 runs phase 17's ranks are held to: (a) WINDOW_PARITY's
    fp32 tree whole on the card (:func:`degree1_parity`); (b)
    WINDOW_SERVE's bf16 serve through ``serve`` on one device, on the
    seed-0 weights the ranks draw shard by shard: the prefill's last
    logits and the tokens."""
    from repro_torch.launch.serve import build_parser, serve

    fp32 = degree1_parity(torch, WINDOW_PARITY)
    w = WINDOW_SERVE
    args = build_parser().parse_args([
        "--arch", w["arch"], "--layers", str(w["layers"]), "--batch",
        str(w["batch"]), "--prompt-len", str(w["prompt_len"]), "--gen",
        str(w["gen"])])
    stats = {}
    res = serve(args, keep_tokens=True, stats=stats)
    bf16 = dict(logits=stats["prefill_logits"][:, -1].float().cpu(),
                tokens=torch.tensor(res["tokens"]))
    del stats
    release(torch)
    return fp32, bf16


def window_before_ranks(torch, randn):
    """Phase 17's part in this process before the ranks start: the offset
    sweep, gemma2-9b's launches timed alone, the degree-1 runs."""
    t0 = time.perf_counter()
    log("[window] phase 17: the forward kernel at query offsets")
    sweep = window_sweep(torch, randn)
    rows = window_rows(torch, randn)
    release(torch)
    fp32, bf16 = window_degree1(torch)
    return dict(sweep=sweep, rows=rows, fp32=fp32, bf16=bf16,
                before_s=time.perf_counter() - t0)


def ring_window(torch, dist, out_dir, rank):
    """Phase 17 on one rank: (a) fp32 parity, (b) the bf16 serve through
    ``launch.serve --mesh 1 4``, (c) engine mode through ``launch.serve
    --serve --auto-plan``; the record to ``window<rank>.json``."""
    t0 = time.perf_counter()
    rec = dict(rank=rank)
    rec["parity"] = ring_parity(torch, dist, out_dir, WINDOW_PARITY,
                                ("native",), "window_parity")
    rec["parity_s"] = time.perf_counter() - t0
    w = WINDOW_SERVE
    t1 = time.perf_counter()
    rec["serve"] = ring_serve(torch, out_dir, rank, argv=[
        "--arch", w["arch"], "--layers", str(w["layers"]), "--mesh", "1",
        "4", "--batch", str(w["batch"]), "--prompt-len",
        str(w["prompt_len"]), "--gen", str(w["gen"])], gen=w["gen"],
        tag="window_serve")
    release(torch)
    rec["serve_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    rec["engine"] = ring_engine_run(
        torch, out_dir, "window", WINDOW_ENGINE_REQUESTS, None,
        spec=WINDOW_ENGINE, rate=WINDOW_ENGINE_RATE, plans="window_plans")
    release(torch)
    rec["engine_s"] = time.perf_counter() - t1
    rec["phase_s"] = time.perf_counter() - t0
    (Path(out_dir) / f"window{rank}.json").write_text(json.dumps(rec))


def window_rank_main(out_dir) -> int:
    """One rank of phase 17 alone (``--window-rank``)."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as tdist
    from repro_torch.core.dist import (init_world, make_mesh_dist,
                                       world_from_env)

    rank, _, local = world_from_env()
    dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_world(RING["backend"])
    try:
        ring_window(torch, make_mesh_dist(RING["mesh"], dev), out_dir, rank)
    finally:
        tdist.destroy_process_group()
    return 0


def check_window_parity(torch, out_dir, ref):
    """(a): the ranks' fp32 prefill logits and cache blocks against the
    degree-1 run within GEMM_TOL's fp32 limits, their tokens identical
    (the launches, all on ``simt``, each rank checked itself)."""
    r = RING["ranks"]
    par = [torch.load(Path(out_dir) / f"window_parity{i}.pt")
           for i in range(r)]
    tol = GEMM_TOL["float32"]
    compare("window ring fp32 prefill logits vs degree 1",
            par[0]["logits_native"], ref["logits"], *tol)
    sl = WINDOW_PARITY["prompt_len"] // r
    for i, p in enumerate(par):
        need(torch.equal(p["logits_native"], par[0]["logits_native"]),
             f"rank {i}'s gathered logits differ from rank 0's")
        for u, leaves in p["caches"].items():
            for n, t in leaves.items():
                compare(f"window ring fp32 rank {i} prefill cache {u}.{n}",
                        t, ref["caches"][u][n][:, :, i * sl:(i + 1) * sl],
                        *tol)
        need(torch.equal(p["tokens"], ref["tokens"]),
             f"rank {i}: window ring tokens {p['tokens'].tolist()} != "
             f"degree 1 {ref['tokens'].tolist()}")
    log(f"  fp32 greedy tokens identical to degree 1: "
        f"{ref['tokens'].tolist()}")


def check_window_serve(torch, out_dir, recs, ref, runs):
    """(b): exact launches a rank by kernel and path (every GEMM tile on
    ``wgmma``, WINDOW_SERVE_FLASH flash on ``mma``), the same tokens on
    every rank, the prefill's last logits within RING_BF16_TOL (relative
    L2) of the degree-1 bf16 run and its first token identical."""
    r = RING["ranks"]
    w = WINDOW_SERVE
    cfg = window_cfg(w["layers"])
    srv = [torch.load(Path(out_dir) / f"window_serve{i}.pt")
           for i in range(r)]
    flash = []
    for i, rec in enumerate(recs):
        sv = rec["serve"]
        want = ring_launches(cfg, r, sv["coords"][1], w["prompt_len"])
        need(sv["launches"] == want,
             f"window serve rank {i}: launches {sv['launches']} != {want}")
        for name, path in MAIN_PATH_KERNEL.items():
            need(sv["launches_by_path"][name][path] == want[name],
                 f"window serve rank {i}: {name} by path "
                 f"{sv['launches_by_path'][name]}")
        need(torch.equal(srv[i]["tokens"], srv[0]["tokens"]),
             f"window serve rank {i}'s tokens differ from rank 0's")
        flash.append(sv["launches"]["flash_attention"])
        runs[f"gemma2-9b ring window serve rank {i}"] = (
            sv["launches"], sv["launches_by_path"])
    need(flash == WINDOW_SERVE_FLASH, f"window serve flash launches a rank "
         f"{flash}, want {WINDOW_SERVE_FLASH}")
    got, want = srv[0]["logits"], ref["logits"]
    err = rel_l2(got, want)
    first, first1 = srv[0]["tokens"][:, 0], ref["tokens"][:, 0]
    top2 = want.topk(2, dim=-1).values
    summary = dict(
        prefill_logits_rel_l2=err,
        prefill_logits_max_abs=(got - want).abs().max().item(),
        first_tokens=first.tolist(), degree1_first_tokens=first1.tolist(),
        degree1_top2_margin=(top2[:, 0] - top2[:, 1]).tolist(),
        tokens=srv[0]["tokens"].tolist(),
        degree1_tokens=ref["tokens"].tolist(), flash_launches=flash,
        per_rank=[{k: rec["serve"][k] for k in (
            "prefill_ms", "ms_per_token", "peak_gb", "transport_s",
            "transport_calls", "transport_gb", "prefill_transport_share",
            "decode_transport_share", "wall_s", "mesh", "launches",
            "launches_by_path")} for rec in recs])
    log(f"[window] (b) gemma2-9b {w['layers']} layers bf16, 1 x "
        f"{w['prompt_len']}, mesh (1, 4): {json.dumps(summary)} "
        f"({CARD['smi']})")
    need(err <= RING_BF16_TOL, f"window serve: prefill logits rel L2 "
         f"{err:.3e} > {RING_BF16_TOL}")
    need(torch.equal(first, first1), f"window serve: first token "
         f"{first.tolist()} != degree 1's {first1.tolist()}")


def check_window_engine(recs, runs):
    """(c): every rank made rank 0's calls, exactly one ring prefill's
    launches per prefill group (the window's rounds counted) and none in a
    decode, all on the main paths' kernel paths; every request finished
    with its tokens."""
    e = WINDOW_ENGINE
    cfg = window_cfg(e["layers"])
    eng = [rec["engine"] for rec in recs]
    rep = eng[0]["report"]
    what = "window engine"
    for i, run in enumerate(eng):
        kinds = [c["kind"] for c in run["calls"]]
        need(kinds == [c["kind"] for c in eng[0]["calls"]],
             f"{what}: rank {i} made calls {kinds}")
        need(run["link_calls"] == eng[0]["link_calls"]
             and run["mesh_after"] == list(RING["mesh"]),
             f"{what}: rank {i} took {run['link_calls']} commands, ended "
             f"on {run['mesh_after']}")
        total = {}
        for c in run["calls"]:
            if c["kind"] == "prefill":
                one = ring_launches(cfg, c["mesh"][1], c["ring_index"],
                                    e["prompt_len"])
                want = {n: v * c["groups"] for n, v in one.items()}
            else:
                want = {n: 0 for n in c["launches"]}
            need(c["launches"] == want, f"{what}: rank {i} {c['kind']} "
                 f"launched {c['launches']}, want {want}")
            for n, v in c["launches"].items():
                total[n] = total.get(n, 0) + v
        need(total == run["launches"], f"{what}: rank {i} launched "
             f"{run['launches']} in all, its calls {total}")
        for name, kpath in MAIN_PATH_KERNEL.items():
            need(run["launches_by_path"][name][kpath]
                 == run["launches"][name],
                 f"{what}: rank {i} {name} by path "
                 f"{run['launches_by_path'][name]}")
        runs[f"gemma2-9b engine ring window rank {i}"] = (
            run["launches"], run["launches_by_path"])
    sent = WINDOW_ENGINE_REQUESTS
    med, cap = ring_engine_capacity(eng[0]["calls"], e)
    calls0 = eng[0]["calls"]
    by_kind = calls_by_kind(calls0)
    out = {k: rep[k] for k in (
        "n_finished", "n_rejected", "generated_tokens", "ttft_p50",
        "ttft_p99", "tpot_p50", "tpot_p99", "tokens_per_s", "makespan",
        "mean_occupancy")}
    out.update(requests_sent=sent, rate=WINDOW_ENGINE_RATE,
               prefill_groups=sum(c["groups"] for c in calls0
                                  if c["kind"] == "prefill"),
               calls=by_kind, wall_s=eng[0]["wall_s"],
               capacity_per_s=cap, offered_share=WINDOW_ENGINE_RATE / cap,
               staged=[dict(rank=i, s=sum(c["staged_s"] for c in r["calls"]),
                            gb=sum(c["staged_bytes"] for c in r["calls"])
                            / 1e9) for i, r in enumerate(eng)])
    log(f"[window] (c) engine, gemma2-9b {e['layers']} layers bf16, "
        f"{e['prompt_len']} + {e['max_new']} tokens: {json.dumps(out)} "
        f"({CARD['smi']})")
    log(f"[window] capacity: prefill group {med['prefill']:.1f} ms, decode "
        f"call {med['decode']:.1f} ms (medians) -> {cap:.3f} requests/s; "
        f"offered {WINDOW_ENGINE_RATE}/s = {WINDOW_ENGINE_RATE / cap:.1%}")
    need(rep["mode"] == "torch" and rep["n_requests"] == sent
         and rep["n_finished"] == sent
         and rep["generated_tokens"] == sent * e["max_new"],
         f"{what}: {rep['n_finished']} of {rep['n_requests']} finished, "
         f"{rep['generated_tokens']} tokens")


def phase_window(torch, out_dir, pre):
    """Phase 17's checks on the ranks' records (``window<rank>.json``):
    (a) :func:`check_window_parity`, (b) :func:`check_window_serve`, (c)
    :func:`check_window_engine`.  Returns the kernels line's additions
    (the offset sweep's errors and the timed launches) and each rank's
    runs (their launches)."""
    t0 = time.perf_counter()
    r = RING["ranks"]
    recs = [json.loads((Path(out_dir) / f"window{i}.json").read_text())
            for i in range(r)]
    runs = {}
    check_window_parity(torch, out_dir, pre["fp32"])
    check_window_serve(torch, out_dir, recs, pre["bf16"], runs)
    check_window_engine(recs, runs)
    ranks_s = max(rec["phase_s"] for rec in recs)
    phase_s = pre["before_s"] + ranks_s + time.perf_counter() - t0
    log(f"[window] phase 17: {phase_s:.1f} s (in this process "
        f"{pre['before_s']:.1f} s; on the ranks {ranks_s:.1f} s: (a) "
        f"{recs[0]['parity_s']:.1f}, (b) {recs[0]['serve_s']:.1f}, (c) "
        f"{recs[0]['engine_s']:.1f}; budget {WINDOW_S} s) ({CARD['smi']})")
    return dict(sweep=pre["sweep"], rows=pre["rows"]), runs


def phase_window_alone(torch):
    """Phase 17 without phases 11 and 16 (its own four ranks): for a quick
    check of the phase on the card after ``phase_device`` and
    ``phase_build``."""
    import tempfile
    pre = window_before_ranks(torch, make_randn(torch, 1))
    with tempfile.TemporaryDirectory() as tmp:
        run_ranks(torch, tmp, entry="--window-rank")
        return phase_window(torch, tmp, pre)


# ---------------------------------------------------------------------------
# phase 12: the TATP ring trains deepseek-7b over four ranks on the card
# ---------------------------------------------------------------------------

# four ranks of this script (``--train-rank``) sharing the card over gloo;
# each train step within step_s of wall clock, the ranks within timeout_s
RING_TRAIN = dict(ranks=4, backend="gloo", timeout_s=420, step_s=60)
# fp32 parity (TF32 off): deepseek-7b at full width, 2 layers, batch 4 x
# seq 128, 1 step (3 until phase 14 needed the time, 2 until phase 16
# did) from the shards of
# one tree on each mesh, against the
# degree-1 run of that tree on the card.  The clip is off (grad_clip
# 1e30) on both sides: above model degree 1 each rank clips by the norm of
# its own shards, as the reference's AdamW does (it psums the norm over
# the data axes only), so with the clip on the ranks' updates differ from
# degree 1's by design; the grad norms are held per shard instead
RING_TRAIN_PARITY = dict(arch="deepseek-7b", n_layers=2, batch=4, seq=128,
                         steps=1, seed=2, meshes=((1, 4), (2, 2)),
                         grad_clip=1e30)
# relative: each step's loss and grad norm, each leaf's final parameters
# (relative L2) -- or, for a leaf, RING_TRAIN_FLOOR times the rel L2 that
# the degree-1 run moves it by with every kernel replaced by its plain
# version (fp32's order of summation alone), where that is larger.  The
# norm scales start at zero, so after 3 steps their values are Adam's
# updates alone, and fp32 rounding moves those by ~1e-4 (final_ln's floor
# 5.4e-5; the ring's final_ln 1.13e-4 from degree 1, 2.1 times it, while
# every weight matrix stays within 1e-4).  One other order of summation
# samples that noise once, so the bound is four times it: a fault in the
# shards, the psums or ZeRO moves a leaf by far more
RING_TRAIN_TOL = 1e-4
RING_TRAIN_FLOOR = 4.0
# bf16 through launch.train --mesh 1 4 --layers 4: phase 5's deepseek-7b
# train run (seed 0, batch 4 x seq 512, remat) over the ring, one step (2
# until phase 15 needed the time; phase 13's (b) times the warm steps)
RING_TRAIN_BF16 = dict(arch="deepseek-7b", layers=TRAIN["n_layers"],
                       batch=TRAIN["batch"], seq=TRAIN["seq"], steps=1,
                       mesh=(1, 4))
RING_TRAIN_BF16_TOL = 1e-2  # the first step's loss against degree 1's
# one rank's rows at (1, 4): batch x seq / 4, the GEMM tiles' M
RING_TRAIN_M = TRAIN["batch"] * TRAIN["seq"] // RING_TRAIN["ranks"]
# one round of the (1, 4) train ring's attention: [B, H, S/4, D]
RING_TRAIN_ATTN = (TRAIN["batch"], HEADS, TRAIN["seq"] // RING_TRAIN["ranks"],
                   HEAD_DIM)


def ring_train_launches(cfg, r, i, remat, saved=False):
    """Kernel launches of one train step on rank ``i`` of a ring of ``r``
    (a causal decoder, :func:`train_launches` at degree 1): every linear's
    forward, dgrad and wgrad as ``r`` per-round tiles each, the streamed
    head's three products once a block (``r`` blocks), and in every
    attention block one flash forward (again under remat) and one flash
    backward, all with an outside delta, a visible round (the own block
    and the ``i`` earlier ones); ``saved``: under ``tatp_outputs``, whose
    recompute runs neither.  Returns (launches by kernel, GEMM launches by
    layout, flash backwards with an outside delta)."""
    n, lay = train_launches(cfg, remat, saved)
    n = dict(n, tatp_matmul=n["tatp_matmul"] * r,
             flash_attention=n["flash_attention"] * (i + 1),
             flash_attention_bwd=n["flash_attention_bwd"] * (i + 1))
    return n, {k: v * r for k, v in lay.items()}, n["flash_attention_bwd"]


def _model_cut(t, spec, r, m):
    """``t``'s block on model index ``m`` of a ring of ``r`` by its
    ``param_specs`` entry (the vocab or column dim over ``model``)."""
    for dim, axis in enumerate(spec):
        if axis == "model":
            blk = t.shape[dim] // r
            t = t.narrow(dim, m * blk, blk)
    return t


def phase_ring_train_rows(torch, randn):
    """The train ring's kernel rows, in this process alone: the flash
    backward with an outside delta at one round of the (1, 4) train
    ([4, 32, 128, 128] bf16; rank 3's queries, whose merged output and
    global row LSE come from its four rounds), causal on the own block and
    unmasked on an earlier one, against its plain version with the same
    delta and timed beside the own-delta mode and SDPA's backward; then
    the dgrad and wgrad per-round GEMM tiles at 512 rows a rank, each
    against its plain version and torch.matmul."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import (attention,
                                                         attention_bwd)
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    from repro_torch.kernels.tatp_matmul.ops import tatp_dot
    from repro_torch.kernels.tatp_matmul.ref import matmul_ref
    from repro_torch.models.attention import _merge

    b, h, s, d = RING_TRAIN_ATTN
    r = RING_TRAIN["ranks"]

    def blk():
        return randn(b, s, h, d, dtype=torch.bfloat16).transpose(1, 2)

    q, do = blk(), blk()
    kv = [(blk(), blk()) for _ in range(r)]
    acc = lse = None
    with torch.no_grad():
        for j, (k, v) in enumerate(kv):
            o, lse_j = attention(q, k, v, causal=j == r - 1,
                                 return_lse=True)
            acc, lse = _merge(acc, lse, o, lse_j)
    delta = (do.float() * acc).sum(-1).contiguous()
    flashes, max_err = [], 0.0
    for causal, j in ((True, r - 1), (False, 0)):
        k, v = kv[j]
        kw = dict(causal=causal, delta=delta)
        before = (attention_bwd.launches_delta_in,
                  attention_bwd.launches_by_path["mma"])
        got = attention_bwd(q, k, v, do, lse, do, **kw)
        torch.cuda.synchronize()
        need((attention_bwd.launches_delta_in,
              attention_bwd.launches_by_path["mma"])
             == (before[0] + 1, before[1] + 1),
             "the ring round's flash backward did not take mma with an "
             "outside delta")
        ref = attention_bwd_ref(q, k, v, do, lse, do, **kw)
        what = "causal own block" if causal else "unmasked earlier block"
        for part, g, want in zip(("dq", "dk", "dv"), got, ref):
            max_err = max(max_err, compare(
                f"ring train round {what} outside delta {part}", g, want,
                *ATTN_TOL["bfloat16"]))
        qc, kc, vc = (t.contiguous() for t in (q, k, v))

        def sdpa(grad):
            def run():
                leaves = [t.detach().requires_grad_(grad)
                          for t in (qc, kc, vc)]
                o = F.scaled_dot_product_attention(*leaves, is_causal=causal)
                if grad:
                    torch.autograd.grad(o, leaves, do)
            return run

        pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
        row = dict(
            shape=[b, h, s, d], causal=causal, path="mma",
            max_abs_err=max_err,
            ms=time_ms(torch, lambda: attention_bwd(q, k, v, do, lse, do,
                                                    **kw), 20),
            own_delta_ms=time_ms(torch, lambda: attention_bwd(
                q, k, v, do, lse, do, causal=causal), 20),
            plain_ms=time_ms(torch, lambda: attention_bwd_ref(
                q, k, v, do, lse, do, **kw), 5),
            library_ms=time_ms(torch, sdpa(True), 20)
            - time_ms(torch, sdpa(False), 20),
            library="SDPA's backward (its own forward's LSE and delta)")
        # recompute S, then dP, dV, dK, dQ: five products over the visible
        # pairs; flash_bwd_bytes and the outside delta read once
        row["bound_ms"], row["bound_by"] = bound(
            10 * pairs * d, flash_bwd_bytes(b, h, h, s, s, d) + 4 * b * h * s,
            "bfloat16")
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["library_ratio"] = row["ms"] / row["library_ms"]
        flashes.append(row)
    gemms = []
    m = RING_TRAIN_M
    for n, kb, per_layer in RING_GEMMS:
        dy = randn(m, r * kb, dtype=torch.bfloat16)
        w = randn(n, kb, dtype=torch.bfloat16, scale=kb ** -0.5)
        x = randn(m, n, dtype=torch.bfloat16, scale=m ** -0.5)
        dyj = dy[:, kb:2 * kb]  # a round's column block, read in place
        for lay, a, bb, out in (("dgrad", dyj, w.t(), (m, n)),
                                ("wgrad", x.t(), dyj, (n, kb))):
            before = tatp_dot.launches_by_layout[lay]
            path = gemm_path(a, bb)
            got = tatp_dot(a, bb)
            need(tatp_dot.launches_by_layout[lay] == before + 1
                 and path == "wgmma",
                 f"ring {lay} tile {list(a.shape)} x {list(bb.shape)}: "
                 f"layout or path {path}")
            err = compare(f"ring train {lay} tile {list(a.shape)} x "
                          f"{list(bb.shape)}", got, matmul_ref(a, bb),
                          *GEMM_TOL["bfloat16"])
            contraction = a.shape[1]
            row = dict(layout=lay, shape=[*a.shape, bb.shape[1]],
                       path=path, max_abs_err=err,
                       launches_per_rank_per_step=per_layer * r
                       * RING_TRAIN_BF16["layers"],
                       ms=time_ms(torch, lambda: tatp_dot(a, bb)),
                       plain_ms=time_ms(torch, lambda: matmul_ref(a, bb)),
                       library_ms=time_ms(torch, lambda: torch.matmul(a, bb)))
            row["bound_ms"], row["bound_by"] = bound(
                2 * out[0] * out[1] * contraction,
                2 * (a.numel() + bb.numel() + out[0] * out[1]), "bfloat16")
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            row["library_ratio"] = row["ms"] / row["library_ms"]
            gemms.append(row)
    log(f"[ring train rows] flash backward, outside delta "
        f"{json.dumps(flashes)}; GEMM tiles {json.dumps(gemms)}")
    return flashes, gemms


def ring_train_degree1(torch, path, spec=None):
    """A ring train parity run's degree-1 fp32 run on the card (``spec``,
    RING_TRAIN_PARITY by default; the whole tree,
    ``init_params``, same seed): each step's loss, the global grad norm
    and, for each ring of 4 and 2, the norm of the gradient restricted to
    each model index's shards (the norm a ring rank clips by: the
    reference's AdamW psums it over the data axes, not the ring), over
    ``spec["loss_steps"]`` steps where given; the parameters after
    ``spec["steps"]`` to ``path`` (by leaf name) for the ranks to read.
    Then the same run with every kernel hook replaced by its plain
    version: each leaf's final rel L2 between the two is what fp32's
    order of summation alone moves it (``floor``)."""
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.core.dist import Dist
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.tatp_matmul.ref import matmul_ref
    from repro_torch.models.ssm import ssd_chunked
    from repro_torch.models.transformer import param_specs
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import loss_and_grads, make_train_step

    spec = spec or RING_TRAIN_PARITY
    dev = torch.device("cuda")
    cfg = parity_config(spec["arch"], spec["n_layers"],
                        **spec.get("overrides", {}))
    shape = ShapeConfig("ring", "train", spec["seq"], spec["batch"])
    specs = {"/".join(k): v for k, v in _leaves(param_specs(
        cfg, spec.get("strategy", "tatp")))}
    out = dict(losses=[], grad_norms=[], shard_norms={})
    finals = []
    for hooks in ({}, dict(dot=matmul_ref, attention=attention_ref,
                           ssd=ssd_chunked)):
        tb = make_train_step(cfg, ParallelConfig(strategy="tatp",
                                                 remat=False),
                             Dist(dev), shape,
                             AdamWConfig(grad_clip=spec["grad_clip"]),
                             **hooks)
        params, state = tb.init_fn(
            torch.Generator(device=dev).manual_seed(spec["seed"]))
        data = SyntheticDataset(cfg, shape, Dist(dev), seed=spec["seed"])
        for step in range(spec["steps"] if hooks
                          else spec.get("loss_steps", spec["steps"])):
            nll, cnt, grads = loss_and_grads(tb.ctx, params,
                                             data.batch(step))
            if not hooks and step == 0 and spec.get("grads"):
                torch.save({"/".join(k): g.cpu() for k, g in _leaves(grads)},
                           grads_path(path))
            if not hooks:
                for r in sorted({m for _, m in spec["meshes"]}):
                    out["shard_norms"].setdefault(str(r), []).append([
                        math.sqrt(sum(float(_model_cut(
                            g, specs["/".join(k)], r, m).float().pow(2)
                            .sum()) for k, g in _leaves(grads)))
                        for m in range(r)])
                out["losses"].append(float(nll / cnt))
            params, state, om = tb.opt.update(params, grads, state)
            if not hooks:
                out["grad_norms"].append(float(om["grad_norm"]))
            del grads
            if step + 1 == spec["steps"]:
                finals.append({"/".join(k): p.cpu()
                               for k, p in _leaves(params)})
        del params, state
        release(torch)
    torch.save(finals[0], path)
    out["floor"] = {name: rel_l2(finals[1][name], p)
                    for name, p in finals[0].items()}
    return out


def grads_path(path):
    """Where :func:`ring_train_degree1` keeps its first step's gradients
    beside the final parameters at ``path``."""
    return Path(path).with_suffix(".grads.pt")


def ring_train_parity(torch, mesh, dev, ref_path, spec=None):
    """One rank's fp32 parity run on ``mesh``: ``spec``'s steps
    (RING_TRAIN_PARITY by default)
    through ``make_train_step`` from ``init_sharded_params``' shards of
    the degree-1 tree, each within RING_TRAIN's step limit; its record
    holds the losses, grad norms, launches and each leaf's rel L2 of its
    final parameters against their block of the degree-1 run's
    (``ref_path``, read mapped), which the parent checks."""
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.core.dist import make_mesh_dist
    from repro_torch.models.transformer import param_specs
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import make_train_step

    spec = spec or RING_TRAIN_PARITY
    strategy = spec.get("strategy", "tatp")
    dist = make_mesh_dist(mesh, dev)
    cfg = parity_config(spec["arch"], spec["n_layers"],
                        **spec.get("overrides", {}))
    shape = ShapeConfig("ring", "train", spec["seq"], spec["batch"])
    par = ParallelConfig(strategy=strategy, remat=False)
    tb = make_train_step(cfg, par, dist, shape,
                         AdamWConfig(grad_clip=spec["grad_clip"]))
    params, state = tb.init_fn(
        torch.Generator(device=dev).manual_seed(spec["seed"]))
    data = SyntheticDataset(cfg, shape, dist, seed=spec["seed"],
                            strategy=strategy)
    specs = {"/".join(k): v for k, v in _leaves(param_specs(cfg, strategy))}
    rec = dict(mesh=list(mesh), coords=list(dist.coords), losses=[],
               grad_norms=[], step_s=[], shard_axis=str(tb.opt.shard_axis))
    if spec.get("grads"):  # every leaf against degree 1's first step
        rec["grad_rel_l2"] = ring_grad_errors(torch, tb, params,
                                              data.batch(0), specs,
                                              grads_path(ref_path))
    zero_launches()
    for step in range(spec["steps"]):
        batch = data.batch(step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = tb.step_fn(params, state, batch)
        rec["losses"].append(float(m["loss"]))
        rec["grad_norms"].append(float(m["grad_norm"]))
        rec["step_s"].append(time.perf_counter() - t0)
        need(rec["step_s"][-1] <= RING_TRAIN["step_s"],
             f"mesh {mesh} rank {dist.coords}: step {step} took "
             f"{rec['step_s'][-1]:.1f} s > {RING_TRAIN['step_s']} s")
    rec["launches"], rec["launches_by_path"] = read_launches(), read_paths()
    ref = torch.load(ref_path, mmap=True, map_location="cpu")
    errs = {}
    for k, p in _leaves(params):
        name = "/".join(k)
        want = _model_cut(ref[name], specs[name], dist.model_degree,
                          dist.axis_index(dist.model_axis))
        errs[name] = rel_l2(p, want.to(dev))
    rec["param_rel_l2"] = errs
    del params, state, ref
    release(torch)
    return rec


def ring_grad_errors(torch, tb, params, batch, specs, path):
    """Each leaf's rel L2 between this rank's gradient (the train step's
    model-axis bookkeeping, then a psum over ``data``) and its block of
    the degree-1 gradient at ``path``."""
    from repro_torch.train.train_loop import (loss_and_grads,
                                              reduce_model_axis_grads)

    dist = tb.ctx.dist
    _, _, grads = loss_and_grads(tb.ctx, params, batch)
    grads = reduce_model_axis_grads(grads, tb.pspecs, tb.ctx.par, dist)
    ref = torch.load(path, mmap=True, map_location="cpu")
    errs = {}
    for k, g in _leaves(grads):
        name = "/".join(k)
        want = _model_cut(ref[name], specs[name], dist.model_degree,
                          dist.axis_index(dist.model_axis))
        errs[name] = rel_l2(dist.psum(g, "data"), want.to(g.device))
    del grads, ref
    return errs


def ring_train_bf16(torch, rank, spec=None):
    """The bf16 train through ``launch.train``'s ``train`` with the CLI's
    arguments (``spec``'s, RING_TRAIN_BF16's by default: ``--mesh 1 4
    --layers 4``): launches by kernel, path and layout and the flash
    backwards with an outside delta, from zero; each step's ms (within
    RING_TRAIN's limit), the host-staged transport's seconds, calls and GB
    sent, and the peak GB."""
    from repro_torch.kernels.flash_attention.ops import attention_bwd
    from repro_torch.launch.train import build_parser, train

    spec = spec or RING_TRAIN_BF16
    args = build_parser().parse_args([
        "--arch", spec["arch"], "--layers", str(spec["layers"]),
        "--mesh", *map(str, spec["mesh"]), "--steps", str(spec["steps"]),
        "--batch", str(spec["batch"]), "--seq", str(spec["seq"]),
        "--dist-backend", RING_TRAIN["backend"], "--log-every", "1000"])
    torch.cuda.reset_peak_memory_stats()
    history, stats = [], {}
    zero_launches()
    res = train(args, history=history, stats=stats)
    torch.cuda.synchronize()
    dist = stats["dist"]
    stage = dist.stage
    step_s = sum(hh["ms"] for hh in history) / 1e3
    for hh in history:
        need(hh["ms"] <= RING_TRAIN["step_s"] * 1e3,
             f"rank {rank}: bf16 step {hh['step']} took {hh['ms']:.0f} ms")
    return dict(
        summary=res, mesh=list(dist.mesh_shape), coords=list(dist.coords),
        losses=[hh["loss"] for hh in history],
        grad_norms=[hh["grad_norm"] for hh in history],
        step_ms=[hh["ms"] for hh in history],
        launches=read_launches(), launches_by_path=read_paths(),
        layouts=read_layouts(),
        delta_in_launches=attention_bwd.launches_delta_in,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        transport_s=stage.seconds, transport_calls=stage.calls,
        transport_gb=stage.bytes / 1e9,
        staged_share=stage.seconds / step_s)


def ring_train_rank_main(out_dir) -> int:
    """One rank of phase 12, started by :func:`run_ranks`: the
    fp32 parity runs on each mesh, then the bf16 train, its record to
    ``rank<rank>.json``."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as tdist
    from repro_torch.core.dist import init_world, world_from_env

    rank, world, local = world_from_env()
    dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_world(RING_TRAIN["backend"])
    try:
        t0 = time.perf_counter()
        rec = dict(rank=rank, parity={
            "x".join(map(str, mesh)): ring_train_parity(
                torch, mesh, dev, Path(out_dir) / "degree1.pt")
            for mesh in RING_TRAIN_PARITY["meshes"]})
        rec["parity_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec["bf16"] = ring_train_bf16(torch, rank)
        rec["bf16_s"] = time.perf_counter() - t0
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(rec))
    finally:
        tdist.destroy_process_group()
    return 0


def strategy_train_launches(cfg, strategy, r, i, remat, saved=False):
    """:func:`ring_train_launches` for ``tatp``; under ``megatron`` every
    product is one local tile and every attention one flash over the
    rank's heads, so degree 1's counts (:func:`train_launches`), except
    that ``tatp_outputs`` saves the attention cores only, as the
    reference names only those: its recompute runs every linear again but
    no flash forward.  Same returns."""
    if strategy == "tatp":
        return ring_train_launches(cfg, r, i, remat, saved)
    n, lay = train_launches(cfg, remat)
    if saved:
        n = dict(n, flash_attention=train_launches(cfg, remat, True)[0][
            "flash_attention"])
    return n, lay, 0


def ring_train_parity_checks(cfg, steps, refs, parities, strategy="tatp"):
    """Phase 12's rules for fp32 train parity over the ring: each step's
    loss within RING_TRAIN_TOL of the degree-1 run's, each rank's grad
    norm within it of the degree-1 gradient's norm over that rank's
    shards, each leaf's final parameters within RING_TRAIN_TOL relative L2
    or RING_TRAIN_FLOOR times the leaf's fp32 floor where larger, exact
    launches on ``simt``, ZeRO-1 over ``data`` where the data degree is
    above 1.  ``parities``: (rank, tag, the rank's
    :func:`ring_train_parity` record) for each run; ``refs``: each tag's
    :func:`ring_train_degree1` record.  Returns (rows by tag, checks)."""
    parity, checks = {}, []
    for rank, tag, p in parities:
        ref = refs[tag]
        mr, mi = p["mesh"][1], p["coords"][1]
        want_norms = [ref["shard_norms"][str(mr)][t][mi]
                      for t in range(steps)]
        want_n = {k: v * steps for k, v in strategy_train_launches(
            cfg, strategy, mr, mi, remat=False)[0].items()}
        errs = p["param_rel_l2"]
        bound_of = {k: max(RING_TRAIN_TOL,
                           RING_TRAIN_FLOOR * ref["floor"][k])
                    for k in errs}
        worst = max(errs, key=lambda k: errs[k] / bound_of[k])
        row = dict(
            rank=rank, coords=p["coords"],
            loss_rel=max(abs(a - b) / abs(b) for a, b in
                         zip(p["losses"], ref["losses"])),
            grad_norm_rel=max(abs(a - b) / b for a, b in
                              zip(p["grad_norms"], want_norms)),
            param_rel_l2=dict(
                worst_to_bound=worst, largest=[
                    [k, errs[k], ref["floor"][k], bound_of[k]]
                    for k in sorted(errs, key=errs.get)[-3:]]),
            step_s=p["step_s"], shard_axis=p["shard_axis"],
            launches=p["launches"])
        parity.setdefault(tag, []).append(row)
        checks += [
            (row["loss_rel"] <= RING_TRAIN_TOL,
             f"mesh {tag} rank {rank}: losses {p['losses']} vs "
             f"degree 1 {ref['losses']}"),
            (row["grad_norm_rel"] <= RING_TRAIN_TOL,
             f"mesh {tag} rank {rank}: grad norms "
             f"{p['grad_norms']} vs degree 1's on its shards "
             f"{want_norms}"),
            (errs[worst] <= bound_of[worst],
             f"mesh {tag} rank {rank}: final parameters "
             f"{row['param_rel_l2']} against degree 1"),
            (p["launches"] == want_n, f"mesh {tag} rank {rank}: "
             f"fp32 launches {p['launches']}, want {want_n}"),
            (all(bp["simt"] == p["launches"][name]
                 for name, bp in p["launches_by_path"].items()),
             f"mesh {tag}: fp32 launches by path "
             f"{p['launches_by_path']}: not all simt"),
            (p["shard_axis"] == ("data" if p["mesh"][0] > 1 else "None"),
             f"mesh {tag}: ZeRO-1 shard axis {p['shard_axis']}")]
    return parity, checks


def phase_ring_train(torch, randn, degree1_loss):
    """Phase 12: deepseek-7b trains through the TATP ring on four ranks
    sharing the card (gloo, host-staged).  ``degree1_loss`` is phase 5's
    first bf16 step loss on the same weights and batch.  Returns the
    kernel rows, each rank's bf16 run (launches, layouts, paths) and the
    flash backwards with an outside delta they launched."""
    import os
    import tempfile
    from dataclasses import replace

    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    flashes, gemms = phase_ring_train_rows(torch, randn)
    r = RING_TRAIN["ranks"]
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    with tempfile.TemporaryDirectory(dir=shm) as tmp:
        t0 = time.perf_counter()
        ref = ring_train_degree1(torch, Path(tmp) / "degree1.pt")
        degree1_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_ranks(torch, tmp, "--train-rank", RING_TRAIN["timeout_s"])
        ranks_s = time.perf_counter() - t0
        recs = [json.loads((Path(tmp) / f"rank{i}.json").read_text())
                for i in range(r)]
    cfg = parity_config(RING_TRAIN_PARITY["arch"],
                        RING_TRAIN_PARITY["n_layers"])
    parity, checks = ring_train_parity_checks(
        cfg, RING_TRAIN_PARITY["steps"],
        {tag: ref for tag in recs[0]["parity"]},
        [(rec["rank"], tag, p) for rec in recs
         for tag, p in rec["parity"].items()])
    floor = sorted(ref["floor"].items(), key=lambda kv: -kv[1])[:4]
    log(f"[ring train] fp32 parity vs degree 1 (losses "
        f"{ref['losses']}, global grad norms {ref['grad_norms']}; the "
        f"largest leaf floors {json.dumps(floor)}): {json.dumps(parity)}")
    for ok, msg in checks:
        need(ok, msg)
    bcfg = replace(get_config(RING_TRAIN_BF16["arch"]),
                   n_layers=RING_TRAIN_BF16["layers"])
    bsteps = RING_TRAIN_BF16["steps"]
    runs, per_rank, checks = {}, [], []
    for rec in recs:
        bf, g = rec["bf16"], rec["rank"]
        want_n, want_lay, want_delta = ring_train_launches(
            bcfg, RING_TRAIN_BF16["mesh"][1], bf["coords"][1], remat=True)
        want_n = {k: v * bsteps for k, v in want_n.items()}
        want_lay = {k: v * bsteps for k, v in want_lay.items()}
        checks += [
            (bf["mesh"] == list(RING_TRAIN_BF16["mesh"]),
             f"bf16 train mesh {bf['mesh']}"),
            (bf["launches"] == want_n,
             f"rank {g}: bf16 launches {bf['launches']} != {want_n}"),
            (bf["layouts"] == want_lay,
             f"rank {g}: GEMM layouts {bf['layouts']} != {want_lay}"),
            (bf["delta_in_launches"] == want_delta * bsteps,
             f"rank {g}: {bf['delta_in_launches']} flash backwards with an "
             f"outside delta, want {want_delta * bsteps}"),
            (all(math.isfinite(x) for x in bf["losses"] + bf["grad_norms"]),
             f"rank {g}: losses {bf['losses']}")]
        checks += [(bf["launches_by_path"][name][path] == want_n[name],
                    f"rank {g}: {name} by path "
                    f"{bf['launches_by_path'][name]}")
                   for name, path in MAIN_PATH_KERNEL.items()]
        runs[f"deepseek-7b ring train {tuple(RING_TRAIN_BF16['mesh'])} rank "
             f"{g}"] = (bf["launches"], bf["layouts"],
                        {n: dict(p) for n, p in bf["launches_by_path"].items()})
        per_rank.append({k: bf[k] for k in (
            "coords", "losses", "grad_norms", "step_ms", "peak_gb",
            "transport_s", "transport_calls", "transport_gb",
            "staged_share", "delta_in_launches", "launches", "layouts")})
    first = recs[0]["bf16"]["losses"][0]
    first_rel = abs(first - degree1_loss) / abs(degree1_loss)
    summary = dict(first_loss=first, degree1_first_loss=degree1_loss,
                   first_loss_rel=first_rel, ranks_wall_s=ranks_s,
                   degree1_s=degree1_s,
                   parity_s=[rec["parity_s"] for rec in recs],
                   bf16_s=[rec["bf16_s"] for rec in recs],
                   phase_s=time.perf_counter() - t_phase, per_rank=per_rank)
    log(f"[ring train] deepseek-7b {RING_TRAIN_BF16['layers']} layers bf16 "
        f"batch {RING_TRAIN_BF16['batch']} x seq {RING_TRAIN_BF16['seq']} "
        f"over {r} ranks, mesh {RING_TRAIN_BF16['mesh']}, "
        f"{RING_TRAIN['backend']}: {json.dumps(summary)}")
    checks += [(abs(rec["bf16"]["losses"][0] - first) <= 1e-6 * abs(first),
                f"rank {rec['rank']}'s loss differs from rank 0's")
               for rec in recs]
    checks.append((first_rel <= RING_TRAIN_BF16_TOL,
                   f"bf16 ring first loss {first} vs degree 1 "
                   f"{degree1_loss}: {first_rel:.3e} > "
                   f"{RING_TRAIN_BF16_TOL}"))
    for ok, msg in checks:
        need(ok, msg)
    delta_in = sum(rec["bf16"]["delta_in_launches"] for rec in recs)
    return flashes, gemms, runs, delta_in


# ---------------------------------------------------------------------------
# phase 13: the rest of the train ring
# ---------------------------------------------------------------------------

RING_MORE = dict(ranks=4, backend="gloo", timeout_s=420)
# (a) launch.train's fail-and-restart over four ranks: reduced deepseek-7b,
# fp32, a checkpoint every 2 steps; the restart at (2, 2) within 2e-4
RING_RESTART = dict(arch="deepseek-7b", batch=4, seq=16, steps=6, every=2,
                    fail_at=4, tol=2e-4)
# (b) full remat against tatp_outputs: phase 12's bf16 model (deepseek-7b,
# 4 layers at full width, batch 4 x seq 512) at (1, 4), one step each
RING_REMAT = dict(arch="deepseek-7b", layers=TRAIN["n_layers"],
                  batch=TRAIN["batch"], seq=TRAIN["seq"], mesh=(1, 4),
                  seed=0)
# (policy, record): full remat first (its call holds the set-up), then
# tatp_outputs (a third run, full remat again and timed warm, was cut when
# phase 13's part (e) needed the time)
REMAT_RUNS = (("full", "full_first"), ("tatp_outputs", "tatp_outputs"))
# (c) zigzag: fp32 at full width, 2 layers, batch 4 x seq 128, the zigzag
# loss on zigzag_permutation-ed data against the contiguous loss; then one
# bf16 step of (b)'s model, 2R + 1 flash launches a layer each way
RING_ZIGZAG = dict(arch="deepseek-7b", n_layers=2, batch=4, seq=128, seed=2,
                   tol=1e-5)
# one zigzag launch of (c)'s bf16 step: c x c blocks, c = 512 / 4 / 2
ZIGZAG_ATTN = (TRAIN["batch"], HEADS, TRAIN["seq"] // 8, HEAD_DIM)
# (d) the vision prefix and the encoder-decoder: one fp32 step at (1, 4) of
# 2 layers (2 + 2) at full width, its loss against degree 1's
RING_FRONTENDS = (("internvl2-1b", 2, 2, 512),
                  ("seamless-m4t-large-v2", 2, 2, 512))
RING_FRONTEND_TOL = 1e-5
RING_FRONTEND_SEED = 4
# (e) gemma2-9b's sliding-window L slots trained over the ring at (1, 4)
# on 1 x 8192 tokens at full width: (i) fp32 ring and zigzag attention at
# an L slot's shape on the hook against degree 1's attention under
# autograd; (ii) launch.train --mesh 1 4 --layers 4, bf16, remat, one step,
# its loss against the degree-1 loss of the same weights and batch; (iii)
# the same step with zigzag on the permuted batch, its loss against (ii)'s
RING_WINDOW_TRAIN = dict(arch="gemma2-9b", layers=4, batch=1, seq=8192,
                         steps=1, mesh=(1, 4), seed=0)
# what the backward decides, against degree 1's bf16 step on the same
# weights and batch (WINDOW_GRADS: its gradient leaves, in the phase's
# directory): (ii)'s and (iii)'s grad norms, each rank's against degree
# 1's norm on that rank's shards, and (iii)'s every gradient leaf on this
# rank (relative L2, after the model-axis reduction).  Measured on the
# H100: the norms 2.6-2.8e-4 apart, the leaves 3.3e-3 to 1.18e-2 (the
# worst layers/u0/wk, an L slot's; bf16 gradients summed in another
# order); the limits are about 3.5 and 2.5 times the worst, and a
# round whose dK/dV went missing or landed on the wrong rows would move
# the L slots' wk and wv by tens of percent
WINDOW_GRADS = "window_grads.pt"
WINDOW_GRAD_NORM_TOL = 1e-3
WINDOW_GRAD_REL_TOL = 3e-2
# the backward's offset sweep: WINDOW_SWEEP's shapes at these head dims
# (mma.sync at 64, wgmma at 128 and 256 in bf16; simt in fp32)
WINDOW_BWD_DIMS = (64, 128, 256)


def zigzag_rows(torch, randn):
    """The zigzag round's launch, in this process alone: one c x c flash
    forward and backward (the backward with an outside delta) of (c)'s
    bf16 step ([4, 32, 64, 128] bf16), causal (an own block's diagonal
    chunk) and unmasked (every other launch), each against its plain
    version and timed beside it and SDPA."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import (attention,
                                                         attention_bwd)
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_ref)

    b, h, c, d = ZIGZAG_ATTN
    r = RING_MORE["ranks"]
    rows = []

    def blk():
        return randn(b, c, h, d, dtype=torch.bfloat16).transpose(1, 2)

    q, k, v, do = blk(), blk(), blk(), blk()
    for causal in (True, False):
        with torch.no_grad():
            o, lse = attention(q, k, v, causal=causal, return_lse=True)
            ro, rlse = attention_ref(q, k, v, causal=causal,
                                     return_lse=True)
        what = "causal" if causal else "unmasked"
        err = max(compare(f"zigzag launch {what} forward", o, ro,
                          *ATTN_TOL["bfloat16"]),
                  compare(f"zigzag launch {what} row LSE", lse, rlse,
                          *ATTN_TOL["bfloat16"]))
        delta = (do.float() * o.float()).sum(-1).contiguous()
        kw = dict(causal=causal, delta=delta)
        got = attention_bwd(q, k, v, do, lse, do, **kw)
        ref = attention_bwd_ref(q, k, v, do, lse, do, **kw)
        berr = max(compare(f"zigzag launch {what} outside delta {p}", g, w,
                           *ATTN_TOL["bfloat16"])
                   for p, g, w in zip(("dq", "dk", "dv"), got, ref))
        qc, kc, vc = (t.contiguous() for t in (q, k, v))

        def sdpa(grad):
            def run():
                leaves = [t.detach().requires_grad_(grad)
                          for t in (qc, kc, vc)]
                out = F.scaled_dot_product_attention(*leaves,
                                                     is_causal=causal)
                if grad:
                    torch.autograd.grad(out, leaves, do)
            return run

        pairs = b * h * (c * (c + 1) // 2 if causal else c * c)
        fwd = dict(
            direction="forward", shape=[b, h, c, d], causal=causal,
            path="mma", max_abs_err=err,
            launches_per_rank_per_layer=2 * r + 1,
            ms=time_ms(torch, lambda: attention(q, k, v, causal=causal,
                                                return_lse=True)),
            plain_ms=time_ms(torch, lambda: attention_ref(
                q, k, v, causal=causal, return_lse=True), 5),
            library_ms=time_ms(torch, sdpa(False)))
        fwd["bound_ms"], fwd["bound_by"] = bound(
            4 * pairs * d, 2 * 4 * b * h * c * d + 4 * b * h * c,
            "bfloat16")
        bwd = dict(
            direction="backward", shape=[b, h, c, d], causal=causal,
            path="mma", max_abs_err=berr,
            launches_per_rank_per_layer=2 * r + 1,
            ms=time_ms(torch, lambda: attention_bwd(q, k, v, do, lse, do,
                                                    **kw)),
            plain_ms=time_ms(torch, lambda: attention_bwd_ref(
                q, k, v, do, lse, do, **kw), 5),
            library_ms=time_ms(torch, sdpa(True)) - time_ms(torch,
                                                           sdpa(False)))
        bwd["bound_ms"], bwd["bound_by"] = bound(
            10 * pairs * d, flash_bwd_bytes(b, h, h, c, c, d) + 4 * b * h * c,
            "bfloat16")
        for row in (fwd, bwd):
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            row["library_ratio"] = row["ms"] / row["library_ms"]
            rows.append(row)
    log(f"[zigzag rows] {json.dumps(rows)}")
    return rows


def seen_by(sq, skv, causal, window, q_offset, device):
    """The masks' visible pairs of one launch as a [sq, skv] bool (query
    row r at r + ``q_offset``, key c at c)."""
    import torch
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(skv, device=device)[None, :]
    ok = torch.ones(sq, skv, dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= qpos - kpos < window
    return ok


def offset_backward(torch, q, k, v, do, kw):
    """One ring round's backward call as ``_RingAttention`` makes it, at
    the flash arguments ``kw`` (its query offset among them), on the
    forward kernel's output and row LSE (a row that sees no key takes LSE
    0: a ring round's LSE is its whole row's, never -1e30) with delta =
    rowsum(dO O) from outside: ``(kernel call, plain call)``."""
    from repro_torch.kernels.flash_attention.ops import (attention,
                                                         attention_bwd)
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    with torch.no_grad():
        o, lse = attention(q, k, v, return_lse=True, **kw)
    lse = torch.where(lse <= -1e29, torch.zeros_like(lse), lse)
    args = (q, k, v, o, lse, do)
    kw = dict(kw, delta=(do.float() * o.float()).sum(-1).contiguous())
    return (lambda: attention_bwd(*args, **kw),
            lambda: attention_bwd_ref(*args, **kw))


def window_bwd_sweep(torch, randn):
    """The backward kernels at query offsets with an outside delta, as
    ring attention's rounds call them (WINDOW_SWEEP's shapes, offsets and
    masks at D 64, 128 and 256), on every variant: ``simt`` (fp32),
    ``mma.sync`` (bf16, D 64) and ``wgmma`` (bf16, D 128 and 256), each
    against the plain version with the same LSE and delta within ATTN_TOL;
    the rows that see no key get dQ exactly 0, the keys no row sees dK and
    dV exactly 0.  Returns the largest error by path."""
    from repro_torch.kernels.flash_attention.ops import attention_bwd

    w = WINDOW_SWEEP
    errs, zero_rows, zero_keys, checks = {}, 0, 0, 0
    for dtype, path in ((torch.float32, "simt"), (torch.bfloat16, "mma")):
        rtol, atol = ATTN_TOL[str(dtype).split(".")[-1]]
        err = 0.0
        for d in WINDOW_BWD_DIMS:
            q, do = (randn(w["batch"], w["heads"], w["sq"], d, dtype=dtype)
                     for _ in range(2))
            k, v = (randn(w["batch"], w["kv_heads"], w["skv"], d,
                          dtype=dtype) for _ in range(2))
            for off in w["offsets"]:
                for causal, window in w["masks"]:
                    kw = dict(causal=causal, window=window, cap=w["cap"],
                              q_offset=off)
                    what = (f"backward offset sweep {path} D {d} offset "
                            f"{off} causal {causal} window {window}")
                    run, plain = offset_backward(torch, q, k, v, do, kw)
                    before = attention_bwd.launches_by_path[path]
                    got, ref = run(), plain()
                    torch.cuda.synchronize()
                    need(attention_bwd.launches_by_path[path] == before + 1,
                         f"{what}: not one {path} launch")
                    seen = seen_by(w["sq"], w["skv"], causal, window, off,
                                   q.device)
                    rows, keys = ~seen.any(1), ~seen.any(0)
                    need(not got[0][:, :, rows].any(),
                         f"{what}: dQ of a row with no key is not 0")
                    need(not got[1][:, :, keys].any()
                         and not got[2][:, :, keys].any(),
                         f"{what}: dK/dV of a key no row sees is not 0")
                    err = max([err] + [compare(f"{what} {part}", g, r, rtol,
                                               atol)
                                       for part, g, r in zip(
                                           ("dq", "dk", "dv"), got, ref)])
                    zero_rows += int(rows.sum())
                    zero_keys += int(keys.sum())
                    checks += 1
        errs[path] = err
    log(f"[window train] backward offset sweep, {checks} launches "
        f"({w['sq']} queries x {w['skv']} keys, D {list(WINDOW_BWD_DIMS)}, "
        f"offsets {list(w['offsets'])}): max_abs_err {json.dumps(errs)}; "
        f"{zero_rows} rows with no key and {zero_keys} keys no row sees, "
        f"each exactly 0")
    return errs


def window_bwd_rows(torch, randn):
    """gemma2-9b's distinct ring backward launches (:func:`window_launches`
    at (1, 4) on RING_WINDOW_TRAIN's 8192 tokens), bf16 (``wgmma`` at D
    256), in the model's ``[B, S, H, D]`` layout viewed as ``[B, H, S,
    D]``, q scaled by :func:`cap_scale` so the cap bites, each as
    :func:`offset_backward` calls it: against the plain version (atol
    scaled by the gradient's RMS, as phase 4 holds a capped backward), the
    rows that see no key and the keys no row sees exactly 0; each timed
    beside its bound over the visible pairs (:func:`attn_pairs` at the
    offset), its plain version and :func:`flex_bwd_yardstick` (SDPA takes
    no soft-cap)."""
    from repro_torch.kernels.flash_attention.ops import attention_bwd

    spec = RING_WINDOW_TRAIN
    cfg = window_cfg(2)
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cap = cfg.attn_softcap
    bf = torch.bfloat16
    rows = []
    for (zigzag, sq, sk, causal, off, window), n in window_launches(
            cfg, spec["mesh"][1], spec["seq"]).items():
        q, do = (randn(1, sq, hq, d, dtype=bf, scale=s).transpose(1, 2)
                 for s in (cap_scale(cap), 1.0))
        k, v = (randn(1, sk, hkv, d, dtype=bf).transpose(1, 2)
                for _ in range(2))
        kw = dict(causal=causal, window=window, cap=cap, q_offset=off)
        mask = "causal" if causal else "window" if window else "unmasked"
        name = (f"gemma2-9b ring backward "
                f"{'zigzag c x c' if zigzag else 'round'} [1,{hq},{sq},{d}] "
                f"{mask} offset {off}")
        run, plain = offset_backward(torch, q, k, v, do, kw)
        before = attention_bwd.launches_by_path["mma"]
        got, ref = run(), plain()
        torch.cuda.synchronize()
        need(attention_bwd.launches_by_path["mma"] == before + 1,
             f"{name}: did not take mma")
        seen = seen_by(sq, sk, causal, window, off, q.device)
        rows_out, keys_out = ~seen.any(1), ~seen.any(0)
        need(not got[0][:, :, rows_out].any()
             and not got[1][:, :, keys_out].any()
             and not got[2][:, :, keys_out].any(),
             f"{name}: a gradient no pair reaches is not 0")
        err = max(compare(f"{name} {part}", g, r, *ATTN_TOL["bfloat16"],
                          rms="tensor")
                  for part, g, r in zip(("dq", "dk", "dv"), got, ref))
        del got, ref
        pairs = hq * attn_pairs(sq, sk, causal, window, off)
        row = dict(name=name, shape=[1, hq, sq, d], kv_heads=hkv, skv=sk,
                   q_offset=off, causal=causal, window=window, cap=cap,
                   path="mma", launches_a_layer=n, max_abs_err=err,
                   rows_with_no_key=int(rows_out.sum()),
                   keys_no_row_sees=int(keys_out.sum()),
                   visible_pairs=pairs, ms=time_ms(torch, run, 20),
                   plain_ms=time_ms(torch, plain, 3, 1))
        row["library_ms"], row["library"] = flex_bwd_yardstick(
            torch, name, randn(1, sq, hq, d, dtype=bf).transpose(1, 2), k, v,
            do, kw)
        row["library_ratio"] = row["ms"] / row["library_ms"]
        # five products over the visible pairs; the bytes of
        # flash_bwd_bytes and the outside delta read
        row["bound_ms"], row["bound_by"] = bound(
            10 * pairs * d, flash_bwd_bytes(1, hq, hkv, sq, sk, d)
            + 4 * hq * sq, "bfloat16")
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        log(f"  timing {name}: {json.dumps(row)} ({CARD['smi']})")
        rows.append(row)
    return rows


def frontend_degree1(torch):
    """RING_FRONTENDS' degree-1 fp32 steps on the card: each model's first
    loss from ``init_params`` of RING_FRONTEND_SEED, the step's batch from
    the same seed (the stub prefix or encoder frames included)."""
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.core.dist import Dist
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.train_loop import make_train_step

    dev = torch.device("cuda")
    out = {}
    for arch, layers, b, s in RING_FRONTENDS:
        cfg = parity_config(arch, layers)
        shape = ShapeConfig("ring", "train", s, b)
        tb = make_train_step(cfg, ParallelConfig(strategy="tatp",
                                                 remat=False), Dist(dev),
                             shape)
        params, state = tb.init_fn(torch.Generator(device=dev).manual_seed(
            RING_FRONTEND_SEED))
        batch = SyntheticDataset(cfg, shape, Dist(dev),
                                 seed=RING_FRONTEND_SEED).batch(0)
        _, _, m = tb.step_fn(params, state, batch)
        out[arch] = float(m["loss"])
        del params, state, batch
        release(torch)
    return out


def window_train_degree1(torch, path):
    """(e)'s degree-1 run: RING_WINDOW_TRAIN's model and first batch at
    degree 1 on the card, bf16, on the weights ``init_params`` draws from
    the launch's seed, which the ranks draw shard by shard: the loss and
    gradients of one step (a step's loss is that of its parameters before
    the update), each gradient leaf to ``path`` (by leaf name) for the
    ranks to read, and the norm of the gradient restricted to each model
    index's shards of the ring (the norm a ring rank clips by):
    ``(loss, shard norms)``."""
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.core.dist import Dist
    from repro_torch.models.transformer import (RunCtx, init_params,
                                                param_specs)
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.train_loop import loss_and_grads

    spec = RING_WINDOW_TRAIN
    dev = torch.device("cuda")
    cfg, dist = window_cfg(spec["layers"]), Dist(dev)
    shape = ShapeConfig("ring", "train", spec["seq"], spec["batch"])
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        spec["seed"]), dev)
    ctx = RunCtx(cfg, ParallelConfig(strategy="tatp", remat=True), dist,
                 phase="train")
    nll, cnt, grads = loss_and_grads(ctx, params, SyntheticDataset(
        cfg, shape, dist).batch(0))
    loss = float(nll / cnt)
    grads = {"/".join(k): g for k, g in _leaves(grads)}
    specs = {"/".join(k): v for k, v in _leaves(param_specs(cfg, "tatp"))}
    r = spec["mesh"][1]
    norms = [math.sqrt(sum(float(_model_cut(g, specs[k], r, m).float()
                                 .pow(2).sum()) for k, g in grads.items()))
             for m in range(r)]
    torch.save({k: g.cpu() for k, g in grads.items()}, path)
    del params, grads
    release(torch)
    return loss, norms


def check_window_train(recs, degree1, runs):
    """(e)'s checks on the ranks' records against ``degree1``, the
    degree-1 loss and shard norms (:func:`window_train_degree1`): (i)
    every rank's output and gradients within GRAD_REL_TOL (relative L2) of
    degree 1's, and its hook's forward and backward launches those of
    :func:`window_round_launches`, all on ``simt``; (ii) and (iii) exact
    launches (:func:`window_train_launches`: kernels, GEMM layouts, paths,
    the flash backwards with an outside delta), (ii)'s loss within
    RING_TRAIN_BF16_TOL of degree 1's and (iii)'s of (ii)'s, every rank's
    the same; each rank's grad norm within WINDOW_GRAD_NORM_TOL of degree
    1's on its shards, and (iii)'s every gradient leaf within
    WINDOW_GRAD_REL_TOL of degree 1's.  Adds each rank's two steps to
    ``runs``; returns the checks, the per-rank summary and the flash
    backwards with an outside delta."""
    spec = RING_WINDOW_TRAIN
    degree1_loss, degree1_norms = degree1
    r, tokens = spec["mesh"][1], spec["seq"]
    cfg, acfg = window_cfg(spec["layers"]), window_cfg(2)
    checks, per_rank, delta_in = [], [], 0
    first = recs[0]["window_train"]["contiguous"]["losses"][0]
    for rec in recs:
        w, g = rec["window_train"], rec["rank"]
        i = w["attention"]["coords"][1]
        for kind in ("contiguous", "zigzag"):
            a = w["attention"][kind]
            n = window_round_launches(acfg, r, i, tokens // r,
                                      kind == "zigzag", acfg.sliding_window)
            checks += [
                (max(a["rel_l2"].values()) <= GRAD_REL_TOL,
                 f"rank {g}: fp32 windowed {kind} ring attention against "
                 f"degree 1: {a['rel_l2']} > {GRAD_REL_TOL}"),
                (a["launches"] == a["simt"] == [n, n],
                 f"rank {g}: {kind} ring attention launches {a['launches']}"
                 f" (simt {a['simt']}), want {n} forward and backward")]
        for kind, zigzag in (("contiguous", False), ("zigzag", True)):
            b = w[kind]
            want, want_lay, want_delta = window_train_launches(
                cfg, r, i, tokens, zigzag)
            loss = b["losses"][0] if kind == "contiguous" else b["loss"]
            base = degree1_loss if kind == "contiguous" else first
            rel = abs(loss - base) / abs(base)
            norm = (b["grad_norms"][0] if kind == "contiguous"
                    else b["grad_norm"])
            norm_rel = abs(norm - degree1_norms[i]) / degree1_norms[i]
            checks += [
                (norm_rel <= WINDOW_GRAD_NORM_TOL,
                 f"rank {g}: gemma2-9b {kind} grad norm {norm} vs degree "
                 f"1's {degree1_norms[i]} on its shards: {norm_rel:.3e} > "
                 f"{WINDOW_GRAD_NORM_TOL}"),
                (b["launches"] == want,
                 f"rank {g}: gemma2-9b {kind} step launches {b['launches']},"
                 f" want {want}"),
                (b["layouts"] == want_lay,
                 f"rank {g}: gemma2-9b {kind} GEMM layouts {b['layouts']}"),
                (b["delta_in_launches"] == want_delta,
                 f"rank {g}: gemma2-9b {kind} {b['delta_in_launches']} flash"
                 f" backwards with an outside delta, want {want_delta}"),
                (math.isfinite(loss) and rel <= RING_TRAIN_BF16_TOL,
                 f"rank {g}: gemma2-9b {kind} loss {loss} vs {base}: "
                 f"{rel:.3e} > {RING_TRAIN_BF16_TOL}"),
                (abs(loss - (first if kind == "contiguous" else
                             recs[0]["window_train"]["zigzag"]["loss"]))
                 <= 1e-6 * abs(loss),
                 f"rank {g}'s {kind} loss differs from rank 0's")]
            checks += [(b["launches_by_path"][name][path] == want[name],
                        f"rank {g}: gemma2-9b {kind} {name} by path "
                        f"{b['launches_by_path'][name]}")
                       for name, path in MAIN_PATH_KERNEL.items()]
            runs[f"gemma2-9b ring {kind} train step {tuple(spec['mesh'])} "
                 f"rank {g}"] = (b["launches"], b["layouts"],
                                 {k: dict(v) for k, v in
                                  b["launches_by_path"].items()})
            delta_in += b["delta_in_launches"]
        worst = max(w["zigzag"]["grad_rel_l2"].items(), key=lambda kv: kv[1])
        checks.append((
            worst[1] <= WINDOW_GRAD_REL_TOL,
            f"rank {g}: gemma2-9b zigzag gradient {worst[0]} {worst[1]:.3e} "
            f"from degree 1's (relative L2) > {WINDOW_GRAD_REL_TOL}"))
        per_rank.append(dict(
            grad_norms=[w["contiguous"]["grad_norms"][0],
                        w["zigzag"]["grad_norm"]],
            degree1_grad_norm=degree1_norms[i],
            zigzag_grad_rel_l2=dict(sorted(
                w["zigzag"]["grad_rel_l2"].items(), key=lambda kv: -kv[1])),
            coords=w["attention"]["coords"],
            attention_rel_l2={k: w["attention"][k]["rel_l2"]
                              for k in ("contiguous", "zigzag")},
            losses=[w["contiguous"]["losses"][0], w["zigzag"]["loss"]],
            step_ms=[w["contiguous"]["step_ms"][0], w["zigzag"]["step_ms"]],
            staged_gb=[w["contiguous"]["transport_gb"],
                       w["zigzag"]["staged_gb"]],
            staged_share=w["contiguous"]["staged_share"],
            peak_gb=[w["contiguous"]["peak_gb"], w["zigzag"]["peak_gb"]],
            flash=[w["contiguous"]["launches"]["flash_attention"],
                   w["contiguous"]["launches"]["flash_attention_bwd"],
                   w["zigzag"]["launches"]["flash_attention"],
                   w["zigzag"]["launches"]["flash_attention_bwd"]],
            wall_s=[w["attention_s"], w["contiguous_s"], w["zigzag_s"]]))
    return checks, per_rank, delta_in


def ring_restart(torch, out_dir, rank):
    """(a) on this rank: ``launch.train``'s ``train`` with the CLI's
    arguments, reduced deepseek-7b in fp32 on the card: a straight run at
    (1, 4); a run that fails at step 4; its restart at (1, 4); a restart
    of a copy of its step-4 checkpoint at (2, 2); and that checkpoint
    restored at (2, 2) and saved at once.  Rank 0 compares the files."""
    import shutil

    import numpy as np
    import torch.distributed as tdist

    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.core.dist import make_mesh_dist
    from repro_torch.launch.train import build_parser, train
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.train_loop import make_train_step

    spec = RING_RESTART
    base = Path(out_dir) / "restart"

    def run(mesh, name, *extra):
        args = build_parser().parse_args([
            "--arch", spec["arch"], "--reduced", "--device", "cuda",
            "--batch", str(spec["batch"]), "--seq", str(spec["seq"]),
            "--steps", str(spec["steps"]), "--ckpt-every",
            str(spec["every"]), "--log-every", "1000", "--mesh",
            *map(str, mesh), "--dist-backend", RING_MORE["backend"],
            "--ckpt-dir", str(base / name), *extra])
        history = []
        train(args, history=history)
        return [hh["loss"] for hh in history]

    t0 = time.perf_counter()
    straight = run((1, 4), "straight")
    try:
        run((1, 4), "failed", "--fail-at-step", str(spec["fail_at"]))
        failed = None
    except RuntimeError as e:  # the simulated failure is the test
        failed = str(e)
    if rank == 0:
        shutil.copytree(base / "failed", base / "elastic")
    tdist.barrier()
    resumed = run((1, 4), "failed")
    moved = run((2, 2), "elastic")
    # the step-4 checkpoint restored at (2, 2) and saved again at once
    dist = make_mesh_dist((2, 2), torch.device("cuda", torch.cuda
                                               .current_device()))
    tb = make_train_step(get_reduced(spec["arch"]),
                         ParallelConfig(strategy="tatp", remat=False), dist,
                         ShapeConfig("t", "train", spec["seq"],
                                     spec["batch"]))
    tree = tb.init_fn(torch.Generator(device="cuda").manual_seed(9))
    io = dict(dist=dist, specs=tb.specs(tree[0]))
    tree, step = ckpt.restore(str(base / "elastic"), tree,
                              step=spec["fail_at"], **io)
    ckpt.save(str(base / "again"), step, tree, **io)
    rec = dict(straight=straight, failed=failed, resumed=resumed,
               moved=moved, s=time.perf_counter() - t0)
    if rank == 0:
        def files(name, step, leaves_only=False):
            with np.load(base / name / f"step_{step:08d}" / "proc00.npz") \
                    as z:
                return {k: z[k] for k in z.files
                        if not (leaves_only and "@" in k)}

        a, b = files("straight", spec["steps"]), files("failed",
                                                       spec["steps"])
        rec["final_keys"] = len(a)
        rec["final_differ"] = sorted(
            set(a) ^ set(b) | {k for k in set(a) & set(b)
                               if not np.array_equal(a[k], b[k])})
        a = files("elastic", spec["fail_at"], leaves_only=True)
        b = files("again", spec["fail_at"], leaves_only=True)
        rec["again_keys"] = len(a)
        rec["again_differ"] = sorted(
            set(a) ^ set(b) | {k for k in set(a) & set(b)
                               if a[k].dtype != b[k].dtype
                               or not np.array_equal(a[k], b[k])})
    del tree
    release(torch)
    return rec


def ring_remat(torch, rank, spec=None):
    """(b) on this rank: one step's loss and gradients of ``spec``'s
    (RING_REMAT's by default) model from the same shards and batch under
    each of REMAT_RUNS; for
    each the launches by kernel, layout and path (from zero), the bytes
    this rank sent, the step's wall clock and its peak GB above what was
    allocated before it; whether its loss and every gradient are bitwise
    the first run's.  Returns the record and the parameters (for
    (c))."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.core.dist import make_mesh_dist
    from repro_torch.kernels.flash_attention.ops import attention_bwd
    from repro_torch.models.transformer import RunCtx, param_specs
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.train_loop import (loss_and_grads,
                                              reduce_model_axis_grads)
    from repro_torch.weights import init_sharded_params

    spec = spec or RING_REMAT
    strategy = spec.get("strategy", "tatp")
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = replace(get_config(spec["arch"]), n_layers=spec["layers"])
    dist = make_mesh_dist(spec["mesh"], dev)
    shape = ShapeConfig("ring", "train", spec["seq"], spec["batch"])
    params = init_sharded_params(
        cfg, torch.Generator(device=dev).manual_seed(spec["seed"]), dist,
        strategy)
    batch = SyntheticDataset(cfg, shape, dist, seed=spec["seed"],
                             strategy=strategy).batch(0)
    rec, first = dict(coords=list(dist.coords)), None
    # full remat first: its call also holds the rank's set-up
    for pol, key in REMAT_RUNS:
        par = ParallelConfig(strategy=strategy, remat=True,
                             remat_policy=pol)
        ctx = RunCtx(cfg, par, dist, phase="train")
        release(torch)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sent = dist.stage.bytes
        zero_launches()
        t0 = time.perf_counter()
        nll, cnt, grads = loss_and_grads(ctx, params, batch)
        grads = reduce_model_axis_grads(grads, param_specs(cfg, strategy),
                                        par, dist)
        torch.cuda.synchronize()
        rec[key] = dict(
            launches=read_launches(), layouts=read_layouts(),
            paths=read_paths(), delta_in=attention_bwd.launches_delta_in,
            step_ms=(time.perf_counter() - t0) * 1e3,
            sent_gb=(dist.stage.bytes - sent) / 1e9,
            peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
            loss=float(nll / cnt))
        named = {"/".join(k): g for k, g in _leaves(grads)}
        del grads
        if first is None:  # the others are held to the first, bitwise
            first = (nll, named)
            rec["grad_leaves"] = len(named)
            continue
        rec[key]["loss_equal"] = bool(torch.equal(first[0], nll))
        rec[key]["grads_differ"] = [n for n in named if not torch.equal(
            first[1][n], named[n])]
        del named
    del first
    release(torch)
    return rec, (cfg, dist, shape, params, batch)


def ring_zigzag(torch, model):
    """(c) on this rank: RING_ZIGZAG's fp32 losses, contiguous and zigzag
    (the batch permuted by ``zigzag_permutation``), forward only; then
    one bf16 step of (b)'s model with zigzag on its permuted batch, its
    launches from zero."""
    import numpy as np

    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.core.dist import make_mesh_dist
    from repro_torch.kernels.flash_attention.ops import attention_bwd
    from repro_torch.models import lm
    from repro_torch.models.attention import zigzag_permutation
    from repro_torch.models.transformer import RunCtx
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.train_loop import loss_and_grads, shard_batch
    from repro_torch.weights import init_sharded_params

    spec = RING_ZIGZAG
    dev = torch.device("cuda", torch.cuda.current_device())
    r = RING_MORE["ranks"]

    def tensors(cfg, host, dist, zig):
        if zig:
            perm = zigzag_permutation(r, host["tokens"].shape[1])
            host = {k: v[:, perm] for k, v in host.items()}
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                    dev, dtype=torch.int64)
                for k, v in shard_batch(cfg, host, dist).items()}

    cfg = parity_config(spec["arch"], spec["n_layers"])
    dist = make_mesh_dist((1, r), dev)
    shape = ShapeConfig("ring", "train", spec["seq"], spec["batch"])
    params = init_sharded_params(
        cfg, torch.Generator(device=dev).manual_seed(spec["seed"]), dist)
    host = SyntheticDataset(cfg, shape, dist, seed=spec["seed"]) \
        ._host_batch(0)
    rec = dict(fp32={})
    for zig in (False, True):
        ctx = RunCtx(cfg, ParallelConfig(strategy="tatp", remat=False,
                                         zigzag=zig), dist, phase="train")
        with torch.no_grad():
            nll, cnt, _ = lm.loss_fn(ctx, params, tensors(cfg, host, dist,
                                                          zig))
        nll, cnt = dist.psum(nll, dist.model_axis), dist.psum(
            cnt, dist.model_axis)
        rec["fp32"]["zigzag" if zig else "contiguous"] = float(nll / cnt)
    del params
    release(torch)
    bcfg, bdist, bshape, bparams, _ = model
    host = SyntheticDataset(bcfg, bshape, bdist, seed=RING_REMAT["seed"]) \
        ._host_batch(0)
    ctx = RunCtx(bcfg, ParallelConfig(strategy="tatp", remat=False,
                                      zigzag=True), bdist, phase="train")
    batch = tensors(bcfg, host, bdist, True)
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    nll, cnt, grads = loss_and_grads(ctx, bparams, batch)
    torch.cuda.synchronize()
    rec["bf16"] = dict(
        coords=list(bdist.coords), launches=read_launches(),
        layouts=read_layouts(), paths=read_paths(),
        delta_in=attention_bwd.launches_delta_in,
        step_ms=(time.perf_counter() - t0) * 1e3,
        loss=float(nll / cnt),
        finite=all(bool(torch.isfinite(g).all())
                   for _, g in _leaves(grads)))
    del grads
    release(torch)
    return rec


def ring_frontends(torch):
    """(d) on this rank: RING_FRONTENDS' fp32 steps at (1, 4) from
    ``init_sharded_params`` of the degree-1 run's seed."""
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.core.dist import make_mesh_dist
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.train_loop import make_train_step

    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    for arch, layers, b, s in RING_FRONTENDS:
        cfg = parity_config(arch, layers)
        dist = make_mesh_dist((1, RING_MORE["ranks"]), dev)
        shape = ShapeConfig("ring", "train", s, b)
        tb = make_train_step(cfg, ParallelConfig(strategy="tatp",
                                                 remat=False), dist, shape)
        params, state = tb.init_fn(torch.Generator(device=dev).manual_seed(
            RING_FRONTEND_SEED))
        batch = SyntheticDataset(cfg, shape, dist,
                                 seed=RING_FRONTEND_SEED).batch(0)
        t0 = time.perf_counter()
        params, state, m = tb.step_fn(params, state, batch)
        out[arch] = dict(loss=float(m["loss"]),
                         grad_norm=float(m["grad_norm"]),
                         step_s=time.perf_counter() - t0)
        del params, state, batch
        release(torch)
    return out


def window_round_launches(cfg, r, i, s_loc, zigzag, window):
    """Rank ``i``'s flash launches in one causal attention call of a ring
    of ``r`` over ``s_loc`` positions a rank under ``window`` (None for a
    ``G`` slot), as :meth:`_Ring.launches` makes them, summed over its
    rounds: the forward's, and its backward's one for each."""
    from repro_torch.models.attention import _Ring

    ring = _Ring("model", r, True, cfg.attn_softcap, False, None, None,
                 None, None, zigzag=zigzag, window=window)
    return sum(len(ring.launches(i, j, s_loc)) for j in range(r))


def window_train_launches(cfg, r, i, tokens, zigzag, remat=True):
    """:func:`ring_train_launches` for a model with sliding-window ``L``
    slots over ``tokens`` positions, contiguous or zigzag: each attention
    block's flash launches from :func:`window_round_launches` (its
    forward's, again under remat, and one backward a launch, each with an
    outside delta) in place of the ``i + 1`` visible rounds.  Same
    returns."""
    n, lay, _ = ring_train_launches(cfg, r, i, remat)
    per = sum(window_round_launches(
        cfg, r, i, tokens // r, zigzag,
        cfg.sliding_window if kind == "L" else None)
        for _, kind in model_blocks(cfg) if kind != "M")
    n = dict(n, flash_attention=per * (2 if remat else 1),
             flash_attention_bwd=per)
    return n, lay, per


def window_ring_attention(torch):
    """(e)(i) on this rank: fp32 ``ring_attention`` and
    ``zigzag_ring_attention`` at gemma2-9b's ``L`` slot (window 4096, cap
    50, 16 heads over 8 K/V heads of 256) on the hook (the flash kernel's
    ``simt`` path), this rank's 2048 of RING_WINDOW_TRAIN's 8192
    positions, under autograd; and degree 1's ``attention`` under autograd
    on the same whole inputs (every rank draws them from one seed): the
    output and dq/dk/dv at this rank's positions, their relative L2 to
    degree 1's, and the hook's forward and backward launches."""
    from repro_torch.core.dist import make_mesh_dist
    from repro_torch.kernels.flash_attention.ops import (attention,
                                                         attention_bwd)
    from repro_torch.models.attention import (ring_attention,
                                              zigzag_local_positions,
                                              zigzag_ring_attention)

    spec = RING_WINDOW_TRAIN
    cfg = window_cfg(2)
    dev = torch.device("cuda", torch.cuda.current_device())
    dist = make_mesh_dist(spec["mesh"], dev)
    r, s = spec["mesh"][1], spec["seq"]
    s_loc, i = s // r, dist.axis_index("model")
    g = torch.Generator(device=dev).manual_seed(spec["seed"])
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v, do = (torch.randn(1, s, h, d, generator=g, device=dev)
                   for h in (hq, hkv, hkv, hq))
    kw = dict(causal=True, window=cfg.sliding_window, cap=cfg.attn_softcap)

    def grads(fn, *ins, ct):
        leaves = [t.detach().clone().requires_grad_(True) for t in ins]
        y = fn(*leaves)
        return (y.detach(), *torch.autograd.grad(y, leaves, ct))

    whole = grads(lambda a, b, c: attention(
        a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2),
        **kw).transpose(1, 2), q, k, v, ct=do)
    out = {}
    for kind, fn in (("contiguous", ring_attention),
                     ("zigzag", zigzag_ring_attention)):
        pos = (zigzag_local_positions("model", r, s_loc, dist, dev)
               if kind == "zigzag" else torch.arange(i * s_loc,
                                                     (i + 1) * s_loc,
                                                     device=dev))
        part = [t.index_select(1, pos) for t in (q, k, v, do)]
        ring_kw = dict(window=kw["window"], cap=kw["cap"])
        if kind == "contiguous":
            ring_kw["causal"] = True
        zero_launches()
        got = grads(lambda a, b, c: fn(
            a, b, c, axis="model", axis_size=r, dist=dist,
            attention=attention, **ring_kw), *part[:3], ct=part[3])
        torch.cuda.synchronize()
        out[kind] = dict(
            rel_l2={n: rel_l2(x, w.index_select(1, pos))
                    for n, x, w in zip(("o", "dq", "dk", "dv"), got, whole)},
            launches=[attention.launches, attention_bwd.launches],
            simt=[attention.launches_by_path["simt"],
                  attention_bwd.launches_by_path["simt"]])
        del got, part
    del whole
    return dict(coords=list(dist.coords), **out)


def window_zigzag_step(torch, rank, path):
    """(e)(iii) on this rank: (ii)'s step (``launch.train``'s model,
    seed, batch and remat) with zigzag, on its batch permuted by
    ``zigzag_permutation``, through ``make_train_step``'s bundle, its step
    made as ``step_fn`` makes it (``loss_and_grads``, the model-axis
    reduction, the optimizer) so that between the halves each gradient
    leaf is held to its block of degree 1's at ``path`` (its rel L2, the
    psum over ``data`` taken: :func:`ring_grad_errors`'s rule): its loss,
    grad norm and leaf errors, the launches by kernel, layout and path
    from zero, the flash backwards with an outside delta, the step's ms
    (without the comparison), the GB this rank staged and its peak GB."""
    import numpy as np

    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.core.dist import make_mesh_dist
    from repro_torch.kernels.flash_attention.ops import attention_bwd
    from repro_torch.models.attention import zigzag_permutation
    from repro_torch.models.transformer import param_specs
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.train_loop import (loss_and_grads,
                                              make_train_step,
                                              reduce_model_axis_grads,
                                              shard_batch, token_axes)

    spec = RING_WINDOW_TRAIN
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = window_cfg(spec["layers"])
    dist = make_mesh_dist(spec["mesh"], dev)
    shape = ShapeConfig("ring", "train", spec["seq"], spec["batch"])
    par = ParallelConfig(strategy="tatp", remat=True, zigzag=True)
    tb = make_train_step(cfg, par, dist, shape)
    params, state = tb.init_fn(torch.Generator(device=dev).manual_seed(
        spec["seed"]))
    host = SyntheticDataset(cfg, shape, dist)._host_batch(0)
    perm = zigzag_permutation(spec["mesh"][1], spec["seq"])
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                 dev, dtype=torch.int64)
             for k, v in shard_batch(cfg, {k: v[:, perm]
                                           for k, v in host.items()},
                                     dist).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sent = dist.stage.bytes
    zero_launches()
    t0 = time.perf_counter()
    nll, cnt, grads = loss_and_grads(tb.ctx, params, batch)
    grads = reduce_model_axis_grads(grads, tb.pspecs, par, dist)
    torch.cuda.synchronize()
    grads_s = time.perf_counter() - t0
    ref = torch.load(path, mmap=True, map_location="cpu")
    specs = {"/".join(k): v for k, v in _leaves(param_specs(cfg, "tatp"))}
    errs = {}
    for k, g in _leaves(grads):
        name = "/".join(k)
        want = _model_cut(ref[name], specs[name], dist.model_degree,
                          dist.axis_index(dist.model_axis))
        errs[name] = rel_l2(dist.psum(g, "data"), want.to(g.device))
    del ref
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, om = tb.opt.update(params, grads, state)
    for a in token_axes(par, dist):
        nll = dist.psum(nll, a)
    loss = float(nll / cnt)
    step_ms = (grads_s + time.perf_counter() - t0) * 1e3
    need(step_ms <= RING_TRAIN["step_s"] * 1e3,
         f"rank {rank}: the zigzag step took {step_ms:.0f} ms")
    rec = dict(coords=list(dist.coords), loss=loss,
               grad_norm=float(om["grad_norm"]), grad_rel_l2=errs,
               step_ms=step_ms, launches=read_launches(),
               layouts=read_layouts(), launches_by_path=read_paths(),
               delta_in_launches=attention_bwd.launches_delta_in,
               staged_gb=(dist.stage.bytes - sent) / 1e9,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del params, state, om, grads, tb
    release(torch)
    return rec


def ring_window_train(torch, rank, out_dir):
    """(e) on this rank: (i) :func:`window_ring_attention`, (ii)
    RING_WINDOW_TRAIN's step through ``launch.train`` (:func:`ring_train_
    bf16`), (iii) :func:`window_zigzag_step` against the degree-1
    gradients in ``out_dir``, each with its wall clock."""
    rec, t0 = {}, time.perf_counter()
    rec["attention"] = window_ring_attention(torch)
    release(torch)
    rec["attention_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["contiguous"] = ring_train_bf16(torch, rank, RING_WINDOW_TRAIN)
    release(torch)
    rec["contiguous_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["zigzag"] = window_zigzag_step(torch, rank,
                                       Path(out_dir) / WINDOW_GRADS)
    rec["zigzag_s"] = time.perf_counter() - t0
    return rec


def ring_more_rank_main(out_dir) -> int:
    """One rank of phase 13, started by :func:`run_ranks`: (a) to
    (e), each part's wall clock, its record to ``rank<rank>.json``, with
    the clock times it started, joined the group and finished."""
    t_entry = time.time()
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as tdist
    from repro_torch.core.dist import init_world, world_from_env

    rank, world, local = world_from_env()
    dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_world(RING_MORE["backend"])
    try:
        rec, laps = dict(rank=rank), {}
        clock = dict(entry=t_entry, ready=time.time())
        t0 = time.perf_counter()
        rec["restart"] = ring_restart(torch, out_dir, rank)
        laps["restart"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec["remat"], model = ring_remat(torch, rank)
        laps["remat"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec["zigzag"] = ring_zigzag(torch, model)
        laps["zigzag"] = time.perf_counter() - t0
        del model
        release(torch)
        t0 = time.perf_counter()
        rec["frontends"] = ring_frontends(torch)
        laps["frontends"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec["window_train"] = ring_window_train(torch, rank, out_dir)
        laps["window_train"] = time.perf_counter() - t0
        rec["laps"], rec["clock"] = laps, dict(clock, done=time.time())
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(rec))
    finally:
        tdist.destroy_process_group()
    return 0


def check_ring_restart(recs):
    spec = RING_RESTART
    fail_at, n = spec["fail_at"], spec["steps"]
    checks = []
    for rec in recs:
        a, g = rec["restart"], rec["rank"]
        checks += [
            (a["failed"] is not None
             and f"simulated node failure at step {fail_at}" in a["failed"],
             f"rank {g}: --fail-at-step {fail_at} did not fail the run "
             f"({a['failed']})"),
            (len(a["straight"]) == n and len(a["resumed"]) == n - fail_at
             and len(a["moved"]) == n - fail_at,
             f"rank {g}: steps run {len(a['straight'])}, "
             f"{len(a['resumed'])}, {len(a['moved'])}"),
            (a["resumed"] == a["straight"][fail_at:],
             f"rank {g}: resumed losses {a['resumed']} != the straight "
             f"run's {a['straight'][fail_at:]}"),
            (all(abs(x - y) <= spec["tol"] * max(1.0, abs(y))
                 for x, y in zip(a["moved"], a["straight"][fail_at:])),
             f"rank {g}: the (2, 2) restart's losses {a['moved']} vs "
             f"{a['straight'][fail_at:]}")]
    a = recs[0]["restart"]
    checks += [(not a["final_differ"],
                f"restarted state differs from the straight run's: "
                f"{a['final_differ'][:5]}"),
               (not a["again_differ"],
                f"the step-{fail_at} checkpoint restored at (2, 2) and saved "
                f"again differs: {a['again_differ'][:5]}")]
    return checks


def phase_ring_more(torch, randn):
    """Phase 13: the rest of the train ring on four ranks sharing the card
    (gloo): the zigzag launch's rows, the backward kernels at query
    offsets (:func:`window_bwd_sweep`, :func:`window_bwd_rows`) and the
    degree-1 losses in this process, then :func:`run_ranks` of this
    script's ``--ring-more-rank`` (a) to (e).  Returns the zigzag rows, the
    bf16 runs' launches (by kernel, layout and path) for the kernels line,
    the flash backwards with an outside delta they launched, and the
    backward's offset rows (the sweep's errors and the timed launches)."""
    import os
    import tempfile
    from dataclasses import replace

    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    rows = zigzag_rows(torch, randn)
    t0 = time.perf_counter()
    log("[window train] the backward kernels at query offsets")
    window = dict(sweep=window_bwd_sweep(torch, randn),
                  rows=window_bwd_rows(torch, randn))
    release(torch)
    rows_s = time.perf_counter() - t0
    r = RING_MORE["ranks"]
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    with tempfile.TemporaryDirectory(dir=shm) as tmp:
        t0 = time.perf_counter()
        degree1 = frontend_degree1(torch)
        window1 = window_train_degree1(torch, Path(tmp) / WINDOW_GRADS)
        degree1_s = time.perf_counter() - t0
        t0, launched = time.perf_counter(), time.time()
        run_ranks(torch, tmp, "--ring-more-rank", RING_MORE["timeout_s"])
        ranks_s, returned = time.perf_counter() - t0, time.time()
        recs = [json.loads((Path(tmp) / f"rank{i}.json").read_text())
                for i in range(r)]
    checks = check_ring_restart(recs)
    a = recs[0]["restart"]
    log(f"[ring restart] reduced deepseek-7b fp32, launch.train --mesh 1 4 "
        f"--ckpt-every {RING_RESTART['every']}: fail at step "
        f"{RING_RESTART['fail_at']}, restart, final state (all "
        f"{a.get('final_keys')} arrays) bitwise the straight run's; "
        f"restart at (2, 2): losses {[x['restart']['moved'] for x in recs]} "
        f"vs {a['straight'][RING_RESTART['fail_at']:]}; restored at (2, 2) "
        f"and saved again: {a.get('again_keys')} leaves bitwise; "
        f"{[round(x['restart']['s'], 1) for x in recs]} s")

    # (b) full remat against tatp_outputs
    cfg = replace(get_config(RING_REMAT["arch"]),
                  n_layers=RING_REMAT["layers"])
    runs, remat, delta_in = {}, [], 0
    for rec in recs:
        b, g = rec["remat"], rec["rank"]
        i = b["coords"][1]
        for pol, key in REMAT_RUNS:
            want, want_lay, _ = ring_train_launches(
                cfg, r, i, remat=True, saved=pol == "tatp_outputs")
            got = b[key]
            checks += [
                (got["launches"] == want,
                 f"rank {g} {key}: launches {got['launches']}, want {want}"),
                (got["layouts"] == want_lay,
                 f"rank {g} {key}: GEMM layouts {got['layouts']}, want "
                 f"{want_lay}"),
                (got["delta_in"] == want["flash_attention_bwd"],
                 f"rank {g} {key}: {got['delta_in']} flash backwards with "
                 f"an outside delta, want {want['flash_attention_bwd']}")]
            delta_in += got["delta_in"]
            checks += [(got["paths"][name][path] == want[name],
                        f"rank {g} {key}: {name} by path "
                        f"{got['paths'][name]}")
                       for name, path in MAIN_PATH_KERNEL.items()]
            if "loss_equal" in got:
                checks += [
                    (got["loss_equal"], f"rank {g}: {key}'s loss "
                     f"{got['loss']} != full remat's "
                     f"{b['full_first']['loss']}"),
                    (not got["grads_differ"], f"rank {g}: {key}'s "
                     f"gradients differ from full remat's: "
                     f"{got['grads_differ'][:5]}")]
            runs[f"deepseek-7b ring {key} step {tuple(RING_REMAT['mesh'])} "
                 f"rank {g}"] = (got["launches"], got["layouts"],
                                 got["paths"])
        remat.append({key: {k: b[key][k] for k in (
            "step_ms", "sent_gb", "peak_gb", "layouts")} | dict(
            flash_fwd=b[key]["launches"]["flash_attention"],
            flash_bwd=b[key]["launches"]["flash_attention_bwd"])
            for _, key in REMAT_RUNS})
    log(f"[ring tatp_outputs] deepseek-7b {RING_REMAT['layers']} layers "
        f"bf16 batch {RING_REMAT['batch']} x seq {RING_REMAT['seq']} mesh "
        f"{RING_REMAT['mesh']}: loss and all "
        f"{recs[0]['remat']['grad_leaves']} gradient leaves bitwise equal "
        f"to full remat's on every rank; per rank {json.dumps(remat)}")

    # (c) zigzag
    zz = []
    for rec in recs:
        z, g = rec["zigzag"], rec["rank"]
        f = z["fp32"]
        rel = abs(f["zigzag"] - f["contiguous"]) / abs(f["contiguous"])
        bf = z["bf16"]
        want, want_lay, _ = ring_train_launches(cfg, r, bf["coords"][1],
                                                remat=False)
        per_layer = 2 * r + 1
        want = dict(want, flash_attention=per_layer * cfg.n_layers,
                    flash_attention_bwd=per_layer * cfg.n_layers)
        checks += [
            (rel <= RING_ZIGZAG["tol"],
             f"rank {g}: fp32 zigzag loss {f['zigzag']} vs contiguous "
             f"{f['contiguous']}: {rel:.2e} > {RING_ZIGZAG['tol']}"),
            (bf["launches"] == want,
             f"rank {g}: zigzag bf16 launches {bf['launches']}, want {want}"),
            (bf["layouts"] == want_lay,
             f"rank {g}: zigzag GEMM layouts {bf['layouts']}"),
            (bf["delta_in"] == want["flash_attention_bwd"],
             f"rank {g}: {bf['delta_in']} zigzag backwards with an outside "
             f"delta"),
            (bf["finite"] and math.isfinite(bf["loss"]),
             f"rank {g}: zigzag bf16 loss {bf['loss']}")]
        checks += [(bf["paths"][name][path] == want[name],
                    f"rank {g}: zigzag {name} by path {bf['paths'][name]}")
                   for name, path in MAIN_PATH_KERNEL.items()]
        runs[f"deepseek-7b ring zigzag step (1, 4) rank {g}"] = (
            bf["launches"], bf["layouts"], bf["paths"])
        delta_in += bf["delta_in"]
        zz.append(dict(coords=bf["coords"], fp32=f, fp32_rel=rel,
                       bf16_loss=bf["loss"], step_ms=bf["step_ms"],
                       flash=[bf["launches"]["flash_attention"],
                              bf["launches"]["flash_attention_bwd"]]))
    log(f"[ring zigzag] fp32 deepseek-7b {RING_ZIGZAG['n_layers']} layers "
        f"batch {RING_ZIGZAG['batch']} x seq {RING_ZIGZAG['seq']}; bf16 "
        f"{cfg.n_layers} layers: {2 * r + 1} flash forwards and backwards "
        f"a layer on every rank; {json.dumps(zz)}")

    # (d) the vision prefix and the encoder-decoder
    fronts = {}
    for rec in recs:
        for arch, got in rec["frontends"].items():
            rel = abs(got["loss"] - degree1[arch]) / abs(degree1[arch])
            fronts.setdefault(arch, []).append(dict(got, rel=rel))
            checks.append((rel <= RING_FRONTEND_TOL,
                           f"rank {rec['rank']}: {arch} ring loss "
                           f"{got['loss']} vs degree 1 {degree1[arch]}: "
                           f"{rel:.2e} > {RING_FRONTEND_TOL}"))
    log(f"[ring frontends] fp32 one step at (1, 4) against degree 1 "
        f"{json.dumps(degree1)}: {json.dumps(fronts)}")

    # (e) gemma2-9b's windowed layers trained over the ring
    more, per_rank, more_delta = check_window_train(recs, window1, runs)
    checks += more
    delta_in += more_delta
    spec = RING_WINDOW_TRAIN
    log(f"[window train] gemma2-9b {spec['layers']} layers bf16 batch "
        f"{spec['batch']} x seq {spec['seq']} mesh {spec['mesh']}, remat: "
        f"degree-1 loss {window1[0]}, grad norm on each rank's shards "
        f"{window1[1]}; per rank {json.dumps(per_rank)} "
        f"({CARD['smi']})")
    # the pool's own cost: from the launch to the first rank's entry and
    # to the last one's joining the group, and from the last one's end to
    # the launcher's return
    clocks = [rec["clock"] for rec in recs]
    pool = dict(to_first_entry_s=min(c["entry"] for c in clocks) - launched,
                to_last_ready_s=max(c["ready"] for c in clocks) - launched,
                after_last_done_s=returned - max(c["done"] for c in clocks))
    summary = dict(ranks_wall_s=ranks_s, pool=pool, degree1_s=degree1_s,
                   window_rows_s=rows_s,
                   window_train_s=max(rec["laps"]["window_train"]
                                      for rec in recs),
                   laps=[rec["laps"] for rec in recs],
                   phase_s=time.perf_counter() - t_phase)
    log(f"[ring more] phase 13: {json.dumps(summary)}")
    for ok, msg in checks:
        need(ok, msg)
    return rows, runs, delta_in, window


# ---------------------------------------------------------------------------
# phase 14: the Mamba-2 block over the TATP ring
# ---------------------------------------------------------------------------

# four ranks of this script (``--ssm-ring-rank``) sharing the card over gloo
RING_SSM = dict(ranks=4, backend="gloo", timeout_s=480)
# the serves' batch, prompt and new tokens: each rank's block at (1, 4) is
# two 256-token chunks, so the in-rank recurrence and the cross-rank scan
# both run; 4 new tokens (8 until phase 15 needed the time)
SSM_RING = dict(batch=2, prompt_len=2048, gen=4)
# (a) fp32 serve parity at full width against the degree-1 run of the same
# tree on the card: (arch, layers, seed)
SSM_RING_PARITY = (("mamba2-780m", 2, 5), ("zamba2-2.7b", 6, 5))
# the ring's own variants of (a)'s prefill: (tag, ssm_scan_mode,
# ssm_state_wire); "seq" is the one held to degree 1
SSM_RING_VARIANTS = (("seq", "seq", "fp32"), ("log", "log", "fp32"),
                     ("bf16", "seq", "bf16"))
# the log scan's prefill logits against seq's: the largest difference over
# the largest magnitude (fp32's association alone; 1.3e-7 and 1.7e-7 on
# the reduced models on the CPU)
SSM_SCAN_TOL = 1e-5
# the bf16 state wire's prefill logits against the fp32 wire's, the same
# measure: the wire rounds each relayed state element by at most 2^-9 of
# its value, so twice that (1.0e-4 and 1.4e-4 on the reduced models on
# the CPU, the reference at mesh (1, 4))
SSM_STATE_WIRE_TOL = 2.0 ** -8
# (b), (c) bf16 through launch.serve --mesh 1 4: (arch, layers); mamba2-780m
# cut to 24 of its 48 layers since phase 15 needed the time
SSM_RING_SERVES = (("mamba2-780m", 24), ("zamba2-2.7b", 12))
# (d) fp32 train parity, phase 12's rules: mamba2-780m, 2 layers at full
# width, 1 step (2 until phase 16 needed the time), the clip off, each
# (mesh, batch, seq) against the degree-1 run of the same tree and
# batches; two chunks a rank on either
SSM_RING_TRAIN_PARITY = dict(arch="mamba2-780m", n_layers=2, steps=1,
                             seed=6, grad_clip=1e30,
                             runs=(((1, 4), 2, 2048), ((2, 2), 2, 1024)))
# and one bf16 step of mamba2-780m, 4 layers (8 until phase 17 needed the
# time), under full remat and under tatp_outputs (REMAT_RUNS, bitwise),
# its loss within tol of degree 1's
SSM_RING_TRAIN_BF16 = dict(arch="mamba2-780m", layers=4, batch=2, seq=2048,
                           mesh=(1, 4), seed=0, tol=1e-2)
# a rank's local SSD pass at (1, 4): [B * nc_loc, 256, H, P], N
SSM_RING_SSD = {"mamba2-780m": (2 * 2, 256, 48, 64, 128),
                "zamba2-2.7b": (2 * 2, 256, 80, 64, 64)}


def ring_tile_path(n, kb):
    """The GEMM path of a forward ring tile ``x[M, n] @ w_j[n, kb]``, both
    operands contiguous (``kernels/tatp_matmul/ops.py:_path``): TMA, so
    ``wgmma``, needs 16-byte pitches; a block of ``kb`` bf16 columns not
    a multiple of 8 (mamba2-780m's and zamba2-2.7b's in_proj at R = 4:
    6448 / 4 = 1612, 10448 / 4 = 2612) takes ``wmma``."""
    return "wgmma" if n % 8 == 0 and kb % 8 == 0 else "wmma"


def ring_prefill_paths(cfg, r):
    """A rank's GEMM launches by path in one ring prefill of ``cfg``:
    every linear's ``r`` tiles on :func:`ring_tile_path`."""
    out = {"simt": 0, "wmma": 0, "wgmma": 0}
    for (_, n, k), count in linear_shapes(cfg, 1).items():
        out[ring_tile_path(n, k // r)] += count * r
    return out


def ssm_train_parity_spec(mesh, batch, seq):
    return dict(SSM_RING_TRAIN_PARITY, batch=batch, seq=seq,
                meshes=(tuple(mesh),))


def ssm_ring_gemm_rows(torch, randn):
    """mamba2-780m's per-round GEMM tiles at (1, 4) (M = 2 x 2048 / 4 =
    1024 rows a rank), each against its plain version and timed beside
    it and ``torch.matmul``: in_proj's [1536, 1612] block, whose pitch
    TMA cannot take (``wmma``), the same block read from a buffer of
    pitch 1616 (``wgmma``: what padding the block would buy), and
    out_proj's [3072, 384] block (``wgmma``)."""
    from repro_torch.kernels.tatp_matmul.ops import tatp_dot
    from repro_torch.kernels.tatp_matmul.ref import matmul_ref

    m = SSM_RING["batch"] * SSM_RING["prompt_len"] // RING_SSM["ranks"]
    rows = []
    for what, n, kb, pitch in (("in_proj", 1536, 1612, 1612),
                               ("in_proj, pitch 1616", 1536, 1612, 1616),
                               ("out_proj", 3072, 384, 384)):
        a = randn(m, n, dtype=torch.bfloat16)
        b = randn(n, pitch, dtype=torch.bfloat16, scale=n ** -0.5)[:, :kb]
        path = gemm_path(a, b)
        need(path == ring_tile_path(n, pitch),
             f"ssm ring tile {what} takes {path}")
        err = compare(f"ssm ring tile {what} bf16 {m}x{n}x{kb} ({path})",
                      tatp_dot(a, b), matmul_ref(a, b), *GEMM_TOL["bfloat16"])
        row = dict(tile=what, shape=[m, n, kb], path=path, max_abs_err=err,
                   ms=time_ms(torch, lambda: tatp_dot(a, b)),
                   plain_ms=time_ms(torch, lambda: matmul_ref(a, b)),
                   library_ms=time_ms(torch, lambda: torch.matmul(a, b)))
        row["bound_ms"], row["bound_by"] = bound(
            2 * m * n * kb, 2 * (m * n + n * kb + m * kb), "bfloat16")
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        rows.append(row)
    log(f"[ssm ring rows] mamba2-780m's GEMM tiles at (1, 4): "
        f"{json.dumps(rows)}")
    return rows


def ssm_ring_rows(torch, randn):
    """The SSD forward and backward kernels at a rank's local shape of the
    (1, 4) runs (SSM_RING_SSD, the conv output's strided views), each
    against its plain version and timed beside it, in this process
    alone."""
    from repro_torch.kernels.ssd.ops import (ssd_intra_chunk,
                                             ssd_intra_chunk_bwd)
    from repro_torch.kernels.ssd.ref import (ssd_intra_chunk_bwd_ref,
                                             ssd_intra_chunk_ref)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for arch, shape in SSM_RING_SSD.items():
        bc, q, h, p, n = shape
        ins = ssd_inputs(torch, randn, g, *shape, strided=True)
        err = max(compare(f"ring local ssd {arch} {list(shape)} {part}", gt,
                          rf, *SSD_TOL)
                  for part, gt, rf in zip(("y", "state", "decay"),
                                          ssd_intra_chunk(*ins),
                                          ssd_intra_chunk_ref(*ins)))
        fwd = dict(arch=arch, direction="forward", shape=list(shape),
                   path=SSD_PATH, max_abs_err=err,
                   ms=time_ms(torch, lambda: ssd_intra_chunk(*ins)),
                   plain_ms=time_ms(torch, lambda: ssd_intra_chunk_ref(*ins)),
                   library_ms=None)
        fwd["bound_ms"], fwd["bound_by"], *_ = ssd_bound(*shape)
        cots = (randn(bc, q, h, p), randn(bc, h, p, n), randn(bc, h))
        got = ssd_intra_chunk_bwd(*ins, *cots)
        want = ssd_intra_chunk_bwd_ref(*ins, *cots)
        abs_err = max((a - b).abs().max().item() for a, b in zip(got, want))
        rel = max((a - b).abs().max().item()
                  / max(b.abs().max().item(), 1e-30)
                  for a, b in zip(got, want))
        need(all(bool(t.isfinite().all()) for t in got),
             f"ring local ssd backward {arch}: non-finite gradients")
        log(f"  check ring local ssd backward {arch} {list(shape)}: max "
            f"relative error {rel:.3e} tol {SSD_BWD_TOL}")
        need(rel <= SSD_BWD_TOL, f"ring local ssd backward {arch}: kernel "
             f"disagrees with the plain backward")
        flops, nbytes = ssd_bwd_work(*shape)
        bwd = dict(arch=arch, direction="backward", shape=list(shape),
                   path=SSD_BWD_PATH, max_abs_err=abs_err, max_rel_err=rel,
                   ms=time_ms(torch, lambda: ssd_intra_chunk_bwd(*ins,
                                                                 *cots)),
                   plain_ms=time_ms(torch, lambda: ssd_intra_chunk_bwd_ref(
                       *ins, *cots), 5, 1),
                   library_ms=None)
        bwd["bound_ms"], bwd["bound_by"] = bound(flops, nbytes, "tf32x3")
        for row in (fwd, bwd):
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            rows.append(row)
    log(f"[ssm ring rows] a rank's local SSD at (1, 4), fp32: "
        f"{json.dumps(rows)}")
    return rows


def ssm_degree1_serve(torch, arch, layers):
    """The degree-1 bf16 serve of ``arch`` cut to ``layers`` through the
    entry point's ``serve`` (seed 0's weights, the ring's tree): its
    tokens and the prefill's last logits; and bf16's own floor there: the
    rel L2 by which the same prefill moves with every kernel replaced by
    its plain version (another order of the same sums)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.tatp_matmul.ref import matmul_ref
    from repro_torch.launch.serve import build_parser, prompt_batch, serve
    from repro_torch.models.ssm import ssd_chunked
    from repro_torch.models.transformer import init_params

    spec = SSM_RING
    args = build_parser().parse_args([
        "--arch", arch, "--layers", str(layers), "--batch",
        str(spec["batch"]), "--prompt-len", str(spec["prompt_len"]),
        "--gen", str(spec["gen"])])
    stats = {}
    res = serve(args, keep_tokens=True, stats=stats)
    out = dict(tokens=torch.tensor(res["tokens"]),
               logits=stats["prefill_logits"][:, -1].float().cpu(),
               prefill_ms=stats["prefill_ms"],
               ms_per_token=res["ms_per_token"])
    del stats
    release(torch)
    dev = torch.device("cuda")
    cfg = replace(get_config(arch), n_layers=layers)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    batch = {name: torch.as_tensor(a, device=dev) for name, a in
             prompt_batch(cfg, spec["batch"], spec["prompt_len"]).items()}
    sb = serve_bundle(torch, cfg, dot=matmul_ref, attention=attention_ref,
                      ssd=ssd_chunked)
    _, logits = sb.prefill_fn(params, batch)
    out["plain_rel_l2"] = rel_l2(logits[:, -1].float().cpu(), out["logits"])
    del params, logits
    release(torch)
    return out


def ssm_degree1_bf16_loss(torch):
    """SSM_RING_TRAIN_BF16's first loss at degree 1 (the whole tree from
    its seed, the same synthetic batch), forward only."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.core.dist import Dist
    from repro_torch.models import lm
    from repro_torch.models.transformer import RunCtx, init_params
    from repro_torch.train.data import SyntheticDataset

    spec = SSM_RING_TRAIN_BF16
    dev = torch.device("cuda")
    cfg = replace(get_config(spec["arch"]), n_layers=spec["layers"])
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        spec["seed"]), dev)
    shape = ShapeConfig("ring", "train", spec["seq"], spec["batch"])
    batch = SyntheticDataset(cfg, shape, Dist(dev), seed=spec["seed"]) \
        .batch(0)
    ctx = RunCtx(cfg, ParallelConfig(strategy="tatp", remat=False),
                 Dist(dev), phase="train")
    with torch.no_grad():
        nll, cnt, _ = lm.loss_fn(ctx, params, batch)
    loss = float(nll / cnt)
    del params
    release(torch)
    return loss


def ssm_ring_parity(torch, dist, out_dir, arch, layers, seed):
    """(a) on this rank: fp32 at full width, ``layers`` layers, from
    ``init_sharded_params``' shards of the degree-1 tree: the prefill
    under each of SSM_RING_VARIANTS, the "seq" one with exact launches on
    ``simt`` and its caches and greedy tokens.  The tensors go to
    ``ssm_<arch><rank>.pt`` for the parent to compare."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import lm
    from repro_torch.train.train_loop import make_serve_fns
    from repro_torch.weights import init_sharded_params

    spec = SSM_RING
    dev, i = dist.device, dist.axis_index(dist.model_axis)
    cfg = parity_config(arch, layers)
    params = init_sharded_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), dist)
    b, s = spec["batch"], spec["prompt_len"]
    batch = {name: torch.as_tensor(a, device=dev) for name, a in
             prompt_batch(cfg, b, s, seed=seed).items()}
    out, rec = {}, {}
    for tag, mode, wire in SSM_RING_VARIANTS:
        sb = make_serve_fns(cfg, ParallelConfig(
            strategy="tatp", remat=False, ssm_scan_mode=mode,
            ssm_state_wire=wire), dist)
        zero_launches()
        caches, logits = sb.prefill_fn(params, batch)
        torch.cuda.synchronize()
        out[f"logits_{tag}"] = logits[:, -1].cpu()
        if tag != "seq":
            continue
        launches, paths = read_launches(), read_paths()
        want = ring_launches(cfg, dist.model_degree, i)
        need(launches == want, f"rank {i}: fp32 {arch} ring prefill "
             f"launched {launches}, want {want}")
        for name, by_path in paths.items():
            need(by_path["simt"] == launches[name],
                 f"rank {i}: fp32 {name} by path {by_path}: not all simt")
        rec["launches"] = launches
        out["caches"] = {u: {n: t.cpu() for n, t in leaves.items()}
                         for u, leaves in caches.items()}
        big = lm.graft_cache_slots(
            lm.init_cache(sb.ctx, b, s + spec["gen"]),
            lm.shard_prompt_cache(sb.ctx, caches, s + spec["gen"]),
            slots=range(b))
        tok = logits[:, -1:].argmax(-1) % cfg.vocab_size
        toks = [tok]
        for t in range(spec["gen"]):
            cl = torch.full((b,), s + t + 1, device=dev)
            tok, _, big = sb.decode_fn(params, tok, big, cl)
            toks.append(tok)
        out["tokens"] = torch.cat(toks, dim=1).cpu()
        del big
    torch.save(out, Path(out_dir) / f"ssm_{arch}{i}.pt")
    del params
    release(torch)
    return rec


def ssm_ring_serve(torch, out_dir, rank, arch, layers):
    """(b), (c) on this rank: the bf16 serve through the entry point's
    ``serve`` with the CLI's arguments (``--mesh 1 4 --layers``):
    launches by path from zero, prefill ms, ms/token, peak GB, the
    host-staged transport's share and bytes, and the bytes and seconds of
    the state scan's hops (``ring_exclusive_scan``, counted around each
    call); the tokens and the prefill's last logits to
    ``ssm_serve_<arch><rank>.pt``."""
    from repro_torch.launch.serve import build_parser, serve
    from repro_torch.models import ssm as ssm_lib

    spec = SSM_RING
    args = build_parser().parse_args([
        "--arch", arch, "--layers", str(layers), "--mesh", "1", "4",
        "--batch", str(spec["batch"]), "--prompt-len",
        str(spec["prompt_len"]), "--gen", str(spec["gen"]),
        "--dist-backend", RING_SSM["backend"]])
    scan = dict(bytes=0, seconds=0.0, calls=0, hops=0)
    scan_fn = ssm_lib.ring_exclusive_scan

    def counted(*a, **kw):
        stage = kw["dist"].stage
        b0, s0, c0 = stage.bytes, stage.seconds, stage.calls
        out = scan_fn(*a, **kw)
        scan["bytes"] += stage.bytes - b0
        scan["seconds"] += stage.seconds - s0
        scan["hops"] += stage.calls - c0
        scan["calls"] += 1
        return out

    torch.cuda.reset_peak_memory_stats()
    stats = {}
    ssm_lib.ring_exclusive_scan = counted
    try:
        zero_launches()
        t0 = time.perf_counter()
        res = serve(args, keep_tokens=True, stats=stats)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        ssm_lib.ring_exclusive_scan = scan_fn
    launches, paths = read_launches(), read_paths()
    dist = stats["dist"]
    stage = dist.stage
    decode_s = res["ms_per_token"] * spec["gen"] / 1e3
    torch.save(dict(tokens=torch.tensor(res.pop("tokens")),
                    logits=stats["prefill_logits"][:, -1].float().cpu()),
               Path(out_dir) / f"ssm_serve_{arch}{rank}.pt")
    prefill_s = stats["prefill_ms"] / 1e3
    out = dict(
        mesh=list(dist.mesh_shape), coords=list(dist.coords),
        launches=launches, launches_by_path=paths,
        prefill_ms=stats["prefill_ms"], ms_per_token=res["ms_per_token"],
        peak_gb=torch.cuda.max_memory_allocated() / 1e9, wall_s=wall_s,
        prefill_gb_sent=stats["prefill_transport_bytes"] / 1e9,
        prefill_staged_calls=stats["prefill_transport_calls"],
        prefill_staged_share=stats["prefill_transport_s"] / prefill_s,
        decode_gb_sent=(stage.bytes - stats["prefill_transport_bytes"])
        / 1e9,
        decode_staged_calls_per_token=(
            stage.calls - stats["prefill_transport_calls"]) / spec["gen"],
        decode_staged_share=(stage.seconds - stats["prefill_transport_s"])
        / decode_s,
        scan_calls=scan["calls"], scan_hops=scan["hops"],
        scan_gb_sent=scan["bytes"] / 1e9, scan_s=scan["seconds"])
    out["scan_share_of_prefill_bytes"] = scan["bytes"] / max(
        stats["prefill_transport_bytes"], 1)
    out["scan_share_of_prefill_s"] = scan["seconds"] / prefill_s
    release(torch)
    return out


def ssm_ring_rank_main(out_dir) -> int:
    """One rank of phase 14, started by :func:`run_ranks`: (a) the
    fp32 serve parity, (b) and (c) the bf16 serves, (d) the fp32 train
    parity and the bf16 step under both remat policies; each part's wall
    clock; its record to ``rank<rank>.json``."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as tdist
    from repro_torch.core.dist import (init_world, make_mesh_dist,
                                       world_from_env)

    rank, world, local = world_from_env()
    dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_world(RING_SSM["backend"])
    try:
        rec, laps = dict(rank=rank), {}
        t0 = time.perf_counter()
        dist = make_mesh_dist((1, RING_SSM["ranks"]), dev)
        rec["parity"] = {arch: ssm_ring_parity(torch, dist, out_dir, arch,
                                               layers, seed)
                         for arch, layers, seed in SSM_RING_PARITY}
        laps["parity"] = time.perf_counter() - t0
        rec["serve"] = {}
        for arch, layers in SSM_RING_SERVES:
            t0 = time.perf_counter()
            rec["serve"][arch] = ssm_ring_serve(torch, out_dir, rank, arch,
                                                layers)
            laps[f"serve {arch}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec["train_parity"] = {}
        for mesh, b, s in SSM_RING_TRAIN_PARITY["runs"]:
            tag = "x".join(map(str, mesh))
            rec["train_parity"][tag] = ring_train_parity(
                torch, mesh, dev, Path(out_dir) / f"ssm_degree1_{tag}.pt",
                ssm_train_parity_spec(mesh, b, s))
        laps["train parity"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec["remat"], model = ring_remat(torch, rank, SSM_RING_TRAIN_BF16)
        del model
        release(torch)
        laps["bf16 step"] = time.perf_counter() - t0
        rec["laps"] = laps
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(rec))
    finally:
        tdist.destroy_process_group()
    return 0


def check_ssm_parity(torch, ref, par, arch):
    """(a)'s rules for ``arch``: ``par`` holds each rank's tensors, ``ref``
    the degree-1 run's.  Returns the variants' errors."""
    tol = GEMM_TOL["float32"]
    r = len(par)
    compare(f"ring fp32 {arch} prefill logits vs degree 1",
            par[0]["logits_seq"], ref["logits"], *tol)
    sl = SSM_RING["prompt_len"] // r
    for i, p in enumerate(par):
        need(torch.equal(p["logits_seq"], par[0]["logits_seq"]),
             f"{arch}: rank {i}'s gathered logits differ from rank 0's")
        for u, leaves in p["caches"].items():
            for n, t in leaves.items():
                full = ref["caches"][u][n]
                if n == "state":  # this rank's heads
                    hl = full.shape[2] // r
                    want = full[:, :, i * hl:(i + 1) * hl]
                elif n == "conv":  # the ring's last inputs, replicated
                    want = full
                else:  # an attention slot's block of positions
                    want = full[:, :, i * sl:(i + 1) * sl]
                compare(f"ring fp32 {arch} rank {i} prefill cache {u}.{n}",
                        t, want, *tol)
        need(torch.equal(p["tokens"], ref["tokens"]),
             f"{arch} rank {i}: ring tokens {p['tokens'].tolist()} != "
             f"degree 1 {ref['tokens'].tolist()}")
    seq = par[0]["logits_seq"]
    errs = {}
    for tag, limit in (("log", SSM_SCAN_TOL), ("bf16", SSM_STATE_WIRE_TOL)):
        got = par[0][f"logits_{tag}"]
        errs[tag] = dict(max_rel=((got - seq).abs().max()
                                  / seq.abs().max()).item(),
                         rel_l2=rel_l2(got, seq), limit=limit)
    return errs


def phase_ssm_ring(torch, randn):
    """Phase 14: the Mamba-2 block over the TATP ring on four ranks
    sharing the card (gloo, host-staged).  The local SSD rows and every
    degree-1 reference run in this process first, then
    :func:`run_ranks` of this script's ``--ssm-ring-rank``.
    Returns the SSD rows, mamba2's GEMM tile rows, the bf16 serves'
    launches (by kernel and path) and the bf16 steps' (by kernel, layout
    and path) for the kernels line."""
    import os
    import tempfile
    from dataclasses import replace

    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    rows = ssm_ring_rows(torch, randn)
    gemm_rows = ssm_ring_gemm_rows(torch, randn)
    t0 = time.perf_counter()
    parity1 = {arch: degree1_parity(torch, dict(
        SSM_RING, arch=arch, n_layers=layers, seed=seed))
        for arch, layers, seed in SSM_RING_PARITY}
    serve1 = {arch: ssm_degree1_serve(torch, arch, layers)
              for arch, layers in SSM_RING_SERVES}
    loss1 = ssm_degree1_bf16_loss(torch)
    r = RING_SSM["ranks"]
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    with tempfile.TemporaryDirectory(dir=shm) as tmp:
        train1 = {}
        for mesh, b, s in SSM_RING_TRAIN_PARITY["runs"]:
            tag = "x".join(map(str, mesh))
            train1[tag] = ring_train_degree1(
                torch, Path(tmp) / f"ssm_degree1_{tag}.pt",
                ssm_train_parity_spec(mesh, b, s))
        degree1_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_ranks(torch, tmp, "--ssm-ring-rank", RING_SSM["timeout_s"])
        ranks_s = time.perf_counter() - t0
        recs = [json.loads((Path(tmp) / f"rank{i}.json").read_text())
                for i in range(r)]
        par = {arch: [torch.load(Path(tmp) / f"ssm_{arch}{i}.pt")
                      for i in range(r)] for arch, _, _ in SSM_RING_PARITY}
        srv = {arch: [torch.load(Path(tmp) / f"ssm_serve_{arch}{i}.pt")
                      for i in range(r)] for arch, _ in SSM_RING_SERVES}

    # (a) fp32 serve parity
    variants = {arch: check_ssm_parity(torch, parity1[arch], par[arch], arch)
                for arch, _, _ in SSM_RING_PARITY}
    log(f"[ssm ring] fp32 parity at (1, 4) against degree 1: logits, "
        f"caches and {SSM_RING['gen']} greedy tokens hold on every rank; "
        f"the log scan and the bf16 state wire against the seq scan's "
        f"prefill logits: {json.dumps(variants)}")
    checks = [(e["max_rel"] <= e["limit"],
               f"{arch} {tag}: prefill logits max_rel {e['max_rel']:.3e} > "
               f"{e['limit']}")
              for arch, errs in variants.items() for tag, e in errs.items()]

    # (b), (c) the bf16 serves
    runs, serves = {}, {}
    for arch, layers in SSM_RING_SERVES:
        full = replace(get_config(arch), n_layers=layers)
        got, want = srv[arch][0]["logits"], serve1[arch]["logits"]
        err = rel_l2(got, want)
        maxerr = (got - want).abs().max().item()
        first = srv[arch][0]["tokens"][:, 0]
        first1 = serve1[arch]["tokens"][:, 0]
        top2 = want.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        agree = (srv[arch][0]["tokens"] == serve1[arch]["tokens"]).float()
        serves[arch] = dict(
            layers=layers, prefill_logits_rel_l2=err,
            prefill_logits_max_abs=maxerr, first_tokens=first.tolist(),
            degree1_first_tokens=first1.tolist(),
            degree1_top2_margin=margin.tolist(),
            token_agreement=agree.mean().item(),
            degree1_plain_hooks_rel_l2=serve1[arch]["plain_rel_l2"],
            degree1_prefill_ms=serve1[arch]["prefill_ms"],
            degree1_ms_per_token=serve1[arch]["ms_per_token"],
            per_rank=[rec["serve"][arch] for rec in recs])
        for i, rec in enumerate(recs):
            sv = rec["serve"][arch]
            want_n = ring_launches(full, r, sv["coords"][1])
            checks += [
                (sv["mesh"] == [1, r], f"{arch} serve mesh {sv['mesh']}"),
                (sv["launches"] == want_n,
                 f"{arch} rank {i}: launches {sv['launches']} != {want_n}"),
                (torch.equal(srv[arch][i]["tokens"],
                             srv[arch][0]["tokens"]),
                 f"{arch} rank {i}'s tokens differ from rank 0's")]
            want_gemm = ring_prefill_paths(full, r)
            checks += [
                (sv["launches_by_path"]["tatp_matmul"] == want_gemm,
                 f"{arch} rank {i}: GEMM by path "
                 f"{sv['launches_by_path']['tatp_matmul']}, want "
                 f"{want_gemm}"),
                (sv["launches_by_path"]["flash_attention"]["mma"]
                 == want_n["flash_attention"],
                 f"{arch} rank {i}: flash by path "
                 f"{sv['launches_by_path']['flash_attention']}")]
            runs[f"{arch} {layers} layers ring (1, {r}) rank {i}"] = (
                sv["launches"], sv["launches_by_path"])
        checks.append((err <= RING_BF16_TOL,
                       f"{arch} bf16 ring prefill logits rel L2 {err:.3e} "
                       f"> {RING_BF16_TOL}"))
        # a flip is possible only where the degree-1 margin is within
        # twice the logits' largest difference
        checks += [(first[row] == first1[row] or margin[row] <= 2 * maxerr,
                    f"{arch} row {row}: first token {first[row]} != degree "
                    f"1's {first1[row]} at margin {margin[row]:.3e}")
                   for row in range(len(first))]
        log(f"[ssm ring] {arch} {layers} layers bf16 batch "
            f"{SSM_RING['batch']} x prompt {SSM_RING['prompt_len']}, "
            f"{SSM_RING['gen']} new tokens, mesh (1, {r}), "
            f"{RING_SSM['backend']}: {json.dumps(serves[arch])}")

    # (d) train: fp32 parity, then the bf16 step under both policies
    cfg = parity_config(SSM_RING_TRAIN_PARITY["arch"],
                        SSM_RING_TRAIN_PARITY["n_layers"])
    parity, more = ring_train_parity_checks(
        cfg, SSM_RING_TRAIN_PARITY["steps"], train1,
        [(rec["rank"], tag, p) for rec in recs
         for tag, p in rec["train_parity"].items()])
    checks += more
    losses1 = {tag: ref["losses"] for tag, ref in train1.items()}
    log(f"[ssm ring train] fp32 parity vs degree 1 (losses "
        f"{json.dumps(losses1)}): {json.dumps(parity)}")
    spec = SSM_RING_TRAIN_BF16
    bcfg = replace(get_config(spec["arch"]), n_layers=spec["layers"])
    trains, remat = {}, []
    for rec in recs:
        b, g = rec["remat"], rec["rank"]
        i = b["coords"][1]
        for pol, key in REMAT_RUNS:
            want, want_lay, _ = ring_train_launches(
                bcfg, r, i, remat=True, saved=pol == "tatp_outputs")
            got = b[key]
            checks += [
                (got["launches"] == want,
                 f"rank {g} {key}: launches {got['launches']}, want {want}"),
                (got["layouts"] == want_lay,
                 f"rank {g} {key}: GEMM layouts {got['layouts']}, want "
                 f"{want_lay}"),
                (math.isfinite(got["loss"]), f"rank {g} {key}: loss "
                 f"{got['loss']}")]
            # the tiles whose operand pitches TMA cannot take (ring_tile_
            # path; in the dgrad and wgrad layouts also a column block of
            # dy at an odd round's 8-byte offset) run on wmma: every GEMM
            # on a bf16 tensor-core path, the split logged
            gp = got["paths"]["tatp_matmul"]
            checks.append((gp["simt"] == 0 and gp["wmma"] + gp["wgmma"]
                           == want["tatp_matmul"],
                           f"rank {g} {key}: GEMM by path {gp}"))
            if "loss_equal" in got:
                checks += [
                    (got["loss_equal"], f"rank {g}: {key}'s loss "
                     f"{got['loss']} != full remat's "
                     f"{b['full_first']['loss']}"),
                    (not got["grads_differ"], f"rank {g}: {key}'s "
                     f"gradients differ from full remat's: "
                     f"{got['grads_differ'][:5]}")]
            trains[f"{spec['arch']} {spec['layers']} layers ring {key} step "
                   f"{tuple(spec['mesh'])} rank {g}"] = (
                got["launches"], got["layouts"], got["paths"])
        remat.append({key: {k: b[key][k] for k in (
            "step_ms", "sent_gb", "peak_gb", "layouts", "loss")} | dict(
            ssd=b[key]["launches"]["ssd"],
            ssd_bwd=b[key]["launches"]["ssd_bwd"],
            gemm_paths=b[key]["paths"]["tatp_matmul"])
            for _, key in REMAT_RUNS})
    # each rank's loss is its tokens' nll over the global count: the
    # step's loss is their sum over the ring (data degree 1)
    first = sum(rec["remat"]["full_first"]["loss"] for rec in recs)
    first_rel = abs(first - loss1) / abs(loss1)
    checks.append((first_rel <= spec["tol"],
                   f"bf16 ring loss {first} vs degree 1 {loss1}: "
                   f"{first_rel:.3e} > {spec['tol']}"))
    summary = dict(loss=first, degree1_loss=loss1, loss_rel=first_rel,
                   grad_leaves=recs[0]["remat"]["grad_leaves"],
                   per_rank=remat)
    log(f"[ssm ring train] {spec['arch']} {spec['layers']} layers bf16 batch "
        f"{spec['batch']} x seq {spec['seq']} mesh {spec['mesh']}, full remat "
        f"then tatp_outputs: {json.dumps(summary)}")
    log(f"[ssm ring] degree1_s {degree1_s:.1f} ranks_wall_s {ranks_s:.1f} "
        f"laps {json.dumps([rec['laps'] for rec in recs])} phase_s "
        f"{time.perf_counter() - t_phase:.1f}")
    for ok, msg in checks:
        need(ok, msg)
    return rows, gemm_rows, runs, trains


# ---------------------------------------------------------------------------
# phase 15: the other strategies and the expert all-to-all over four ranks
# ---------------------------------------------------------------------------

# four ranks of this script (``--other-rank``) sharing the card over gloo
RING_OTHER = dict(ranks=4, backend="gloo", timeout_s=420)
# (a) olmoe-1b-7b at full width, fp32, 2 layers, mesh (1, 4), batch 2 x
# prompt 64 (32 tokens a rank), 4 new tokens: against the degree-1 run of
# the same tree with tests/multidevice/check_model.py's overrides (the
# capacity factor the number of experts: nothing drops; aux_coef 0); then
# at the published capacity factor 1.25 against the plain hooks on the
# ring, routing compared call by call
MOE_RING_PARITY = dict(arch="olmoe-1b-7b", n_layers=2, batch=2,
                       prompt_len=64, gen=4, seed=7,
                       overrides=dict(capacity_factor=64.0, aux_coef=0.0))
# the bf16 serve through launch.serve --mesh 1 4 at olmoe's 16 layers:
# 512 tokens a rank, so a rank's capacity is round(512 x 8 / 64 x 1.25)
# = 80 slots an expert
MOE_RING_SERVE = dict(arch="olmoe-1b-7b", batch=4, prompt_len=512, gen=4)
# one bf16 step through launch.train --mesh 1 4: phase 5's olmoe train run
# (4 layers, batch 4 x seq 512, remat, seed 0)
MOE_RING_TRAIN = dict(arch="olmoe-1b-7b", layers=TRAIN["n_layers"],
                      batch=TRAIN["batch"], seq=TRAIN["seq"], steps=1,
                      mesh=(1, 4))
# fp32 train parity at (2, 2) by phase 12's rules: olmoe, 1 layer (2
# until phase 17 needed the time), no drops and no aux loss
# (check_model.py's overrides), batch 2 x seq 64 (32 tokens a rank:
# nothing dropping needs 256 slots an expert), one step, clip off
MOE_RING_TRAIN_PARITY = dict(arch="olmoe-1b-7b", n_layers=1, batch=2,
                             seq=64, steps=1, seed=8, grad_clip=1e30,
                             meshes=((2, 2),),
                             overrides=MOE_RING_PARITY["overrides"])
# (b) megatron: phase 12's fp32 model (deepseek-7b, 2 layers at full width,
# batch 4 x seq 128, 1 step, clip off) at (1, 4) and (2, 2), by phase 12's
# rules, and every gradient leaf of the step against degree 1's (2 steps
# until the whole run needed the time); its degree-1 run goes on to a
# second step's loss, which (c) is held to
MEG_PARITY = dict(RING_TRAIN_PARITY, strategy="megatron", grads=True,
                  loss_steps=2)
# a gradient leaf's rel L2 from degree 1's: fp32 sums in another order
# (each row-parallel product split over the ring, then psummed)
MEG_GRAD_TOL = 1e-4
# the bf16 prefill of deepseek-7b's 30 layers through make_serve_fns'
# prefill_fn at (1, 4): phase 5's weights (seed 0) and prompts, held to
# its degree-1 run; 2 prefills, the first counted
MEG_PREFILL = dict(arch="deepseek-7b", batch=MAIN["batch"],
                   prompt_len=MAIN["prompt_len"], mesh=(1, 4), repeats=2)
# one bf16 step of phase 5's 4-layer deepseek-7b (batch 4 x seq 512) at
# (1, 4) under each remat policy (REMAT_RUNS), bitwise; its loss within tol
# of phase 5's degree-1 first loss
MEG_REMAT = dict(RING_REMAT, strategy="megatron", tol=1e-2)
# (c) int8 gradient compression: MEG_PARITY's model at (2, 2) under
# megatron (no weight blocks on the wire, so the ZeRO-1 reductions and the
# residuals' gather are what the time buys), its 2 steps' losses within
# tol of the degree-1 run's uncompressed ones (the second loss is the
# first that a compressed gradient moves)
COMPRESS = dict(mesh=(2, 2), steps=MEG_PARITY["loss_steps"], tol=1e-2)
# (d) what the reference cannot run: (what, arch, strategy, entry point);
# internvl2-1b's 2 kv heads are fewer than the ring's 4 ranks
C5_CALLS = (("fsdp above degree 1", "deepseek-7b", "fsdp", "train"),
            ("megatron decode", "deepseek-7b", "megatron", "decode"),
            ("megatron, 2 kv heads over 4 ranks", "internvl2-1b",
             "megatron", "train"),
            ("megatron with MoE layers", "olmoe-1b-7b", "megatron", "train"),
            ("megatron with Mamba-2 layers", "mamba2-780m", "megatron",
             "train"))
# megatron's local GEMMs of deepseek-7b on a rank of (1, 4): (M, N, K) at
# the prefill's M 512 and the train step's 2048; olmoe's ring tile; the
# local-head flash shapes [B, H, S, D] (prefill, train) and olmoe's ring
# round with its row LSE
MEG_GEMMS = tuple((m, n, k) for m in (512, 2048)
                  for n, k in ((D_MODEL, D_MODEL // 4), (D_MODEL, D_FF // 4),
                               (D_MODEL // 4, D_MODEL),
                               (D_FF // 4, D_MODEL)))
MOE_RING_GEMM = (512, 2048, 512)
MEG_FLASH = ((4, HEADS // 4, 128, HEAD_DIM), (4, HEADS // 4, 512, HEAD_DIM))
MOE_RING_ATTN = (4, 16, 128, 128)


def other_rows(torch, randn):
    """The GEMM at megatron's local shapes and olmoe's ring tile, flash at
    megatron's local heads (forward at both, backward at the train shape)
    and at olmoe's ring round with its row LSE: each against its plain
    version, timed beside it and the library call, in this process
    alone."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import (_forward, attention,
                                                         attention_bwd)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.tatp_matmul.ops import tatp_dot
    from repro_torch.kernels.tatp_matmul.ref import matmul_ref

    gemms = []
    for what, (m, n, k) in ([("megatron", s) for s in MEG_GEMMS]
                            + [("olmoe ring tile", MOE_RING_GEMM)]):
        a = randn(m, n, dtype=torch.bfloat16)
        b = randn(n, k, dtype=torch.bfloat16, scale=n ** -0.5)
        path = gemm_path(a, b)
        need(path == "wgmma", f"{what} GEMM {m}x{n}x{k} takes {path}")
        row = dict(what=what, shape=[m, n, k], path=path,
                   max_abs_err=compare(f"{what} GEMM bf16 {m}x{n}x{k}",
                                       tatp_dot(a, b), matmul_ref(a, b),
                                       *GEMM_TOL["bfloat16"]),
                   ms=time_ms(torch, lambda: tatp_dot(a, b)),
                   plain_ms=time_ms(torch, lambda: matmul_ref(a, b)),
                   library_ms=time_ms(torch, lambda: torch.matmul(a, b)))
        row["bound_ms"], row["bound_by"] = bound(
            2 * m * n * k, 2 * (m * n + n * k + m * k), "bfloat16")
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        gemms.append(row)
    flashes = []
    cases = [("megatron", s, False) for s in MEG_FLASH]
    cases += [("olmoe ring round", MOE_RING_ATTN, True)]
    for what, (b, h, s, d), lse in cases:
        q, k, v, do = (randn(b, s, h, d, dtype=torch.bfloat16)
                       .transpose(1, 2) for _ in range(4))
        kw = dict(causal=True, return_lse=True) if lse else dict(causal=True)
        got, want = attention(q, k, v, **kw), attention_ref(q, k, v, **kw)
        got, want = (got, want) if lse else ((got,), (want,))
        err = max(compare(f"{what} flash [{b},{h},{s},{d}] {part}", g, w,
                          *ATTN_TOL["bfloat16"])
                  for part, g, w in zip(("o", "lse"), got, want))
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        pairs = b * h * s * (s + 1) // 2
        row = dict(what=what, direction="forward", shape=[b, h, s, d],
                   max_abs_err=err,
                   ms=time_ms(torch, lambda: attention(q, k, v, **kw), 50),
                   plain_ms=time_ms(torch, lambda: attention_ref(
                       q, k, v, **kw), 50),
                   library_ms=time_ms(torch, lambda: (
                       F.scaled_dot_product_attention(qc, kc, vc,
                                                      is_causal=True)), 50))
        row["bound_ms"], row["bound_by"] = bound(
            4 * pairs * d, 8 * b * h * s * d + (4 * b * h * s if lse else 0),
            "bfloat16")
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        flashes.append(row)
        if what != "megatron" or s != MEG_FLASH[-1][2]:
            continue
        # the backward at the train shape: two launches, against autograd
        # of the plain version, timed alone as phase 4 times it
        got = flash_grads(torch, attention, q, k, v, do, causal=True)
        want = flash_grads(torch, attention_ref, q, k, v, do, causal=True)
        err = max(compare(f"megatron flash backward [{b},{h},{s},{d}] "
                          f"{part}", g, w, *ATTN_TOL["bfloat16"])
                  for part, g, w in zip(("dq", "dk", "dv"), got[1:],
                                        want[1:]))
        o, lse_ = _forward(q, k, v, True, None, None, None, want_lse=True)

        def fwd_bwd(fn, q, k, v, **kw):
            def run():
                qq, kk, vv = (t.detach().requires_grad_(True)
                              for t in (q, k, v))
                torch.autograd.grad(fn(qq, kk, vv, **kw), (qq, kk, vv), do)
            return run

        def fwd(fn, q, k, v, **kw):
            return lambda: fn(q, k, v, **kw)

        row = dict(
            what=what, direction="backward", shape=[b, h, s, d],
            max_abs_err=err,
            ms=time_ms(torch, lambda: attention_bwd(q, k, v, o, lse_, do,
                                                    causal=True), 10),
            plain_ms=(time_ms(torch, fwd_bwd(attention_ref, q, k, v,
                                             causal=True), 5)
                      - time_ms(torch, fwd(attention_ref, q, k, v,
                                           causal=True), 5)),
            library_ms=(time_ms(torch, fwd_bwd(
                F.scaled_dot_product_attention, qc, kc, vc, is_causal=True),
                10) - time_ms(torch, fwd(F.scaled_dot_product_attention, qc,
                                         kc, vc, is_causal=True), 10)))
        row["bound_ms"], row["bound_by"] = bound(
            10 * pairs * d, flash_bwd_bytes(b, h, h, s, s, d), "bfloat16")
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        flashes.append(row)
    log(f"[other rows] GEMM {json.dumps(gemms)}; flash "
        f"{json.dumps(flashes)}")
    return gemms, flashes


def moe_ring_parity(torch, dist, out_dir):
    """(a) on this rank: MOE_RING_PARITY's fp32 serve from
    ``init_sharded_params``' shards of the degree-1 tree, nothing dropped:
    exact launches on ``simt``, the prefill's last logits, this rank's
    caches and the greedy tokens to ``moe<rank>.pt``; then at the
    published capacity the kernel hooks against the plain ones on the
    ring: logits within 1e-3, the same tokens and, call by call, the same
    routing but at near ties (:func:`check_routing`)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.tatp_matmul.ref import matmul_ref
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import lm
    from repro_torch.train.train_loop import make_serve_fns
    from repro_torch.weights import init_sharded_params

    spec = MOE_RING_PARITY
    dev, i = dist.device, dist.axis_index(dist.model_axis)
    cfg = parity_config(spec["arch"], spec["n_layers"], **spec["overrides"])
    params = init_sharded_params(
        cfg, torch.Generator(device=dev).manual_seed(spec["seed"]), dist)
    b, s, gen = spec["batch"], spec["prompt_len"], spec["gen"]
    batch = {name: torch.as_tensor(a, device=dev) for name, a in
             prompt_batch(cfg, b, s, seed=spec["seed"]).items()}
    par = ParallelConfig(strategy="tatp", remat=False)

    def serve(sb):
        caches, logits = sb.prefill_fn(params, batch)
        big = lm.graft_cache_slots(
            lm.init_cache(sb.ctx, b, s + gen),
            lm.shard_prompt_cache(sb.ctx, caches, s + gen), slots=range(b))
        tok = logits[:, -1:].argmax(-1) % cfg.vocab_size
        toks = [tok]
        for t in range(gen):
            tok, _, big = sb.decode_fn(params, tok, big,
                                       torch.full((b,), s + t + 1,
                                                  device=dev))
            toks.append(tok)
        return caches, logits[:, -1].cpu(), torch.cat(toks, dim=1).cpu()

    zero_launches()
    caches, logits, tokens = serve(make_serve_fns(cfg, par, dist))
    torch.cuda.synchronize()
    launches, paths = read_launches(), read_paths()
    want = ring_launches(cfg, dist.model_degree, i)
    need(launches == want, f"rank {i}: fp32 olmoe ring serve launched "
         f"{launches}, want {want}")
    for name, by_path in paths.items():
        need(by_path["simt"] == launches[name],
             f"rank {i}: fp32 {name} by path {by_path}: not all simt")
    torch.save(dict(logits=logits, tokens=tokens,
                    caches={u: {n: t.cpu() for n, t in leaves.items()}
                            for u, leaves in caches.items()}),
               Path(out_dir) / f"moe{i}.pt")
    del caches
    # the published capacity: kernel hooks against plain ones, same ring
    pub = replace(cfg, capacity_factor=get_config(spec["arch"])
                  .capacity_factor)
    routes, runs = ([], []), []
    for k, hooks in enumerate(({}, dict(dot=matmul_ref,
                                         attention=attention_ref))):
        runs.append(serve(make_serve_fns(pub, par, dist, routing=routes[k],
                                         **hooks))[1:])
    err = compare(f"rank {i} olmoe ring capacity {pub.capacity_factor} "
                  f"prefill logits, kernels vs plain", runs[0][0],
                  runs[1][0], *GEMM_TOL["float32"])
    need(torch.equal(runs[0][1], runs[1][1]), f"rank {i}: olmoe ring tokens "
         f"{runs[0][1].tolist()} (kernels) != {runs[1][1].tolist()} (plain)")
    flips = check_routing(f"rank {i} olmoe ring prefill and decode at "
                          f"capacity {pub.capacity_factor}", *routes)
    rec = dict(launches=launches, capacity_logits_err=err,
               routing_flips=len(flips), routed_calls=len(routes[0]),
               capacities=sorted({r.cap for r in routes[0]}),
               smallest_margin=min(r.margin.min().item()
                                   for r in routes[1]))
    del params
    release(torch)
    return rec


def moe_ring_serve(torch, out_dir, rank):
    """(a) on this rank: MOE_RING_SERVE through the entry point's ``serve``
    with the CLI's arguments (``--mesh 1 4``): launches by path from
    zero, prefill ms, ms/token, peak GB, the staged transport, and each
    expert all-to-all's bytes and seconds (``Dist._all_to_all_raw``
    counted around each call; the first 2 x layers are the prefill's);
    the tokens and the prefill's last logits to ``moe_serve<rank>.pt``."""
    from repro_torch.core.dist import Dist
    from repro_torch.launch.serve import build_parser, serve

    spec = MOE_RING_SERVE
    args = build_parser().parse_args([
        "--arch", spec["arch"], "--mesh", "1", "4", "--batch",
        str(spec["batch"]), "--prompt-len", str(spec["prompt_len"]),
        "--gen", str(spec["gen"]), "--dist-backend", RING_OTHER["backend"]])
    calls = []
    raw = Dist._all_to_all_raw

    def counted(self, x, axis):
        b0, s0 = self.stage.bytes, self.stage.seconds
        out = raw(self, x, axis)
        calls.append((self.stage.bytes - b0, self.stage.seconds - s0))
        return out

    torch.cuda.reset_peak_memory_stats()
    stats = {}
    Dist._all_to_all_raw = counted
    try:
        zero_launches()
        t0 = time.perf_counter()
        res = serve(args, keep_tokens=True, stats=stats)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        Dist._all_to_all_raw = raw
    launches, paths = read_launches(), read_paths()
    dist = stats["dist"]
    stage = dist.stage
    logits = stats["prefill_logits"][:, -1].float().cpu()
    torch.save(dict(tokens=torch.tensor(res.pop("tokens")), logits=logits),
               Path(out_dir) / f"moe_serve{rank}.pt")
    n_pre = 2 * 16  # two all-to-alls a layer
    pre, dec = calls[:n_pre], calls[n_pre:]
    prefill_s = stats["prefill_ms"] / 1e3
    decode_s = res["ms_per_token"] * spec["gen"] / 1e3
    out = dict(
        mesh=list(dist.mesh_shape), coords=list(dist.coords),
        launches=launches, launches_by_path=paths,
        prefill_ms=stats["prefill_ms"], ms_per_token=res["ms_per_token"],
        peak_gb=torch.cuda.max_memory_allocated() / 1e9, wall_s=wall_s,
        logits_finite=bool(logits.isfinite().all()),
        prefill_gb_sent=stats["prefill_transport_bytes"] / 1e9,
        prefill_staged_calls=stats["prefill_transport_calls"],
        prefill_staged_share=stats["prefill_transport_s"] / prefill_s,
        decode_staged_calls_per_token=(
            stage.calls - stats["prefill_transport_calls"]) / spec["gen"],
        decode_staged_share=(stage.seconds - stats["prefill_transport_s"])
        / decode_s,
        a2a_prefill_calls=len(pre),
        a2a_prefill_gb=sum(c[0] for c in pre) / 1e9,
        a2a_prefill_s=sum(c[1] for c in pre),
        a2a_decode_calls_per_token=len(dec) / spec["gen"],
        a2a_decode_gb=sum(c[0] for c in dec) / 1e9,
        a2a_decode_s=sum(c[1] for c in dec))
    out["a2a_share_of_prefill_s"] = out["a2a_prefill_s"] / prefill_s
    release(torch)
    return out


def meg_prefill(torch, dist, out_dir):
    """(b) on this rank: deepseek-7b's 30 layers in bf16 under
    ``megatron`` through ``make_serve_fns``' ``prefill_fn`` on phase 5's
    weights (seed 0, drawn shard by shard) and prompts; the first
    prefill's launches by path and staged transport, each prefill's host
    ms; the last logits to ``meg_prefill<rank>.pt``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.train.train_loop import make_serve_fns
    from repro_torch.weights import init_sharded_params

    spec = MEG_PREFILL
    dev, i = dist.device, dist.axis_index(dist.model_axis)
    cfg = get_config(spec["arch"])
    params = init_sharded_params(cfg, torch.Generator(device=dev)
                                 .manual_seed(0), dist, "megatron")
    batch = {name: torch.as_tensor(a, device=dev) for name, a in
             prompt_batch(cfg, spec["batch"], spec["prompt_len"]).items()}
    sb = make_serve_fns(cfg, ParallelConfig(strategy="megatron",
                                            remat=False), dist)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec, ms = {}, []
    for k in range(spec["repeats"]):
        stage = (dist.stage.seconds, dist.stage.calls, dist.stage.bytes)
        zero_launches()
        t0 = time.perf_counter()
        _, logits = sb.prefill_fn(params, batch)
        last = logits[:, -1].float().cpu()
        ms.append((time.perf_counter() - t0) * 1e3)
        if k == 0:
            rec.update(launches=read_launches(), launches_by_path=read_paths(),
                       staged_s=dist.stage.seconds - stage[0],
                       staged_calls=dist.stage.calls - stage[1],
                       staged_gb=(dist.stage.bytes - stage[2]) / 1e9)
            torch.save(last, Path(out_dir) / f"meg_prefill{i}.pt")
    rec.update(coords=list(dist.coords), prefill_ms=ms,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    rec["staged_share"] = rec["staged_s"] / (ms[0] / 1e3)
    del params
    release(torch)
    return rec


def ring_compress(torch, dev):
    """(c) on this rank: MEG_PARITY's model under its strategy at
    COMPRESS's mesh with int8 gradient compression (the clip off), its
    steps' losses and the residuals' largest magnitude and nonzero
    share."""
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.core.dist import make_mesh_dist
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import make_train_step

    spec = MEG_PARITY
    dist = make_mesh_dist(COMPRESS["mesh"], dev)
    cfg = parity_config(spec["arch"], spec["n_layers"])
    shape = ShapeConfig("ring", "train", spec["seq"], spec["batch"])
    tb = make_train_step(cfg, ParallelConfig(strategy=spec["strategy"],
                                             remat=False),
                         dist, shape, AdamWConfig(grad_clip=spec["grad_clip"],
                                                  grad_compress=True))
    params, state = tb.init_fn(
        torch.Generator(device=dev).manual_seed(spec["seed"]))
    data = SyntheticDataset(cfg, shape, dist, seed=spec["seed"],
                            strategy=spec["strategy"])
    losses = []
    for step in range(COMPRESS["steps"]):
        params, state, m = tb.step_fn(params, state, data.batch(step))
        losses.append(float(m["loss"]))
    errs = [e for _, e in _leaves(state.err)]
    rec = dict(mesh=list(dist.mesh_shape), coords=list(dist.coords),
               losses=losses, shard_axis=str(tb.opt.shard_axis),
               err_max=max(float(e.abs().max()) for e in errs),
               err_nonzero=sum(int((e != 0).sum()) for e in errs)
               / sum(e.numel() for e in errs))
    del params, state, errs
    release(torch)
    return rec


def other_rank_main(out_dir) -> int:
    """One rank of phase 15, started by :func:`run_ranks`: (a)
    olmoe's fp32 parity, bf16 serve, fp32 train parity and bf16 step; (b)
    megatron's fp32 train parity, bf16 prefill and bf16 step under both
    remat policies; (c) int8 compression; each part's wall clock; its
    record to ``rank<rank>.json``."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as tdist
    from repro_torch.core.dist import (init_world, make_mesh_dist,
                                       world_from_env)

    rank, world, local = world_from_env()
    dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_world(RING_OTHER["backend"])
    out = Path(out_dir)
    try:
        rec, laps = dict(rank=rank), {}

        def lap(name, t0):
            laps[name] = time.perf_counter() - t0

        t0 = time.perf_counter()
        dist = make_mesh_dist((1, RING_OTHER["ranks"]), dev)
        rec["moe_parity"] = moe_ring_parity(torch, dist, out)
        lap("moe parity", t0)
        t0 = time.perf_counter()
        rec["moe_serve"] = moe_ring_serve(torch, out, rank)
        lap("moe serve", t0)
        t0 = time.perf_counter()
        spec = MOE_RING_TRAIN_PARITY
        rec["moe_train_parity"] = {
            "x".join(map(str, mesh)): ring_train_parity(
                torch, mesh, dev, out / "moe_degree1.pt", spec)
            for mesh in spec["meshes"]}
        lap("moe train parity", t0)
        t0 = time.perf_counter()
        rec["moe_train"] = ring_train_bf16(torch, rank, MOE_RING_TRAIN)
        lap("moe bf16 step", t0)
        t0 = time.perf_counter()
        rec["meg_parity"] = {
            "x".join(map(str, mesh)): ring_train_parity(
                torch, mesh, dev, out / "meg_degree1.pt", MEG_PARITY)
            for mesh in MEG_PARITY["meshes"]}
        lap("megatron train parity", t0)
        t0 = time.perf_counter()
        rec["meg_prefill"] = meg_prefill(torch, dist, out)
        lap("megatron prefill", t0)
        t0 = time.perf_counter()
        rec["meg_remat"], model = ring_remat(torch, rank, MEG_REMAT)
        del model
        release(torch)
        lap("megatron bf16 steps", t0)
        t0 = time.perf_counter()
        rec["compress"] = ring_compress(torch, dev)
        lap("compression", t0)
        rec["laps"] = laps
        (out / f"rank{rank}.json").write_text(json.dumps(rec))
    finally:
        tdist.destroy_process_group()
    return 0


def c5_raises(torch):
    """(d) in this process: each path the reference cannot run raises
    naming ROADMAP.md C5 through its entry point (``make_train_step``, or
    ``make_serve_fns``' ``decode_fn``) on a (1, 4) Dist with no process
    group, so before any collective."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.core.dist import Dist
    from repro_torch.train.train_loop import make_serve_fns, make_train_step

    dist = Dist(torch.device("cuda"), mesh_shape=(1, 4), coords=(0, 1))
    out = {}
    for what, arch, strategy, entry in C5_CALLS:
        cfg = replace(get_config(arch), n_layers=len(
            get_config(arch).layer_pattern))
        par = ParallelConfig(strategy=strategy, remat=False)
        try:
            if entry == "train":
                make_train_step(cfg, par, dist,
                                ShapeConfig("c5", "train", 16, 4))
            else:
                make_serve_fns(cfg, par, dist).decode_fn(
                    {}, torch.zeros(4, 1, dtype=torch.long), {},
                    torch.full((4,), 17))
            raised = None
        except NotImplementedError as e:
            raised = str(e)
        need(raised is not None and "C5" in raised,
             f"{what}: {raised or 'ran'} (want a C5 raise)")
        out[what] = raised
    log(f"[other] the paths the reference cannot run raise before any "
        f"collective: {json.dumps(out)}")


def phase_other(torch, randn, degree1, train_outs):
    """Phase 15: the other strategies and the expert all-to-all on four
    ranks sharing the card (gloo, host-staged).  ``degree1`` holds phase
    5's degree-1 bf16 deepseek-7b serve (its prefill's last logits and
    tokens), ``train_outs`` phase 5's train runs (their first losses).
    The kernel rows, the C5 raises and every degree-1 run the ranks are
    held to come first, in this process; then :func:`run_ranks`
    of this script's ``--other-rank``.  Returns the rows and the bf16
    runs' launches (serves: by kernel and path; steps: by kernel, layout
    and path) for the kernels line."""
    import os
    import tempfile
    from dataclasses import replace

    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    gemms, flashes = other_rows(torch, randn)
    c5_raises(torch)
    t0 = time.perf_counter()
    moe1 = degree1_parity(torch, MOE_RING_PARITY)
    r = RING_OTHER["ranks"]
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    with tempfile.TemporaryDirectory(dir=shm) as tmp:
        moe_train1 = ring_train_degree1(
            torch, Path(tmp) / "moe_degree1.pt", MOE_RING_TRAIN_PARITY)
        meg1 = ring_train_degree1(torch, Path(tmp) / "meg_degree1.pt",
                                  MEG_PARITY)
        degree1_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_ranks(torch, tmp, "--other-rank", RING_OTHER["timeout_s"])
        ranks_s = time.perf_counter() - t0
        recs = [json.loads((Path(tmp) / f"rank{i}.json").read_text())
                for i in range(r)]
        moe = [torch.load(Path(tmp) / f"moe{i}.pt") for i in range(r)]
        moe_srv = [torch.load(Path(tmp) / f"moe_serve{i}.pt")
                   for i in range(r)]
        meg_pre = [torch.load(Path(tmp) / f"meg_prefill{i}.pt")
                   for i in range(r)]
    checks, runs, trains = [], {}, {}

    # (a) olmoe: fp32 parity against degree 1 (no drops)
    spec = MOE_RING_PARITY
    tol = GEMM_TOL["float32"]
    compare("olmoe ring fp32 prefill logits vs degree 1 (no drops)",
            moe[0]["logits"], moe1["logits"], *tol)
    sl = spec["prompt_len"] // r
    for i, p in enumerate(moe):
        need(torch.equal(p["logits"], moe[0]["logits"]),
             f"olmoe: rank {i}'s gathered logits differ from rank 0's")
        for u, leaves in p["caches"].items():
            for n, t in leaves.items():
                compare(f"olmoe ring fp32 rank {i} prefill cache {u}.{n}", t,
                        moe1["caches"][u][n][:, :, i * sl:(i + 1) * sl],
                        *tol)
        need(torch.equal(p["tokens"], moe1["tokens"]),
             f"olmoe rank {i}: ring tokens {p['tokens'].tolist()} != "
             f"degree 1 {moe1['tokens'].tolist()}")
    log(f"[other] olmoe fp32 at (1, {r}) against degree 1, nothing "
        f"dropped: logits, caches and {spec['gen']} greedy tokens hold on "
        f"every rank; at the published capacity, kernels against plain on "
        f"the ring: {json.dumps([rec['moe_parity'] for rec in recs])}")

    # (a) olmoe's bf16 serve at its 16 layers
    full = get_config(MOE_RING_SERVE["arch"])
    srv = [rec["moe_serve"] for rec in recs]
    for i, (sv, out) in enumerate(zip(srv, moe_srv)):
        want_n = ring_launches(full, r, sv["coords"][1])
        checks += [
            (sv["mesh"] == [1, r], f"olmoe serve mesh {sv['mesh']}"),
            (sv["launches"] == want_n,
             f"olmoe serve rank {i}: launches {sv['launches']} != {want_n}"),
            (sv["logits_finite"], f"olmoe serve rank {i}: logits not finite"),
            (torch.equal(out["tokens"], moe_srv[0]["tokens"]),
             f"olmoe serve rank {i}'s tokens differ from rank 0's"),
            (sv["a2a_prefill_calls"] == 2 * full.n_layers
             and sv["a2a_decode_calls_per_token"] == 2 * full.n_layers,
             f"olmoe serve rank {i}: all-to-alls {sv['a2a_prefill_calls']} "
             f"a prefill, {sv['a2a_decode_calls_per_token']} a token")]
        checks += [(sv["launches_by_path"][name][path] == want_n[name],
                    f"olmoe serve rank {i}: {name} by path "
                    f"{sv['launches_by_path'][name]}")
                   for name, path in MAIN_PATH_KERNEL.items()]
        runs[f"olmoe-1b-7b ring (1, {r}) rank {i}"] = (
            sv["launches"], sv["launches_by_path"])
    log(f"[other] olmoe-1b-7b {full.n_layers} layers bf16 batch "
        f"{MOE_RING_SERVE['batch']} x prompt {MOE_RING_SERVE['prompt_len']}, "
        f"{MOE_RING_SERVE['gen']} new tokens, mesh (1, {r}): "
        f"{json.dumps(srv)}")

    # (a) olmoe train: fp32 parity at (2, 2), then the bf16 step
    pcfg = parity_config(MOE_RING_TRAIN_PARITY["arch"],
                         MOE_RING_TRAIN_PARITY["n_layers"],
                         **MOE_RING_TRAIN_PARITY["overrides"])
    parity, more = ring_train_parity_checks(
        pcfg, MOE_RING_TRAIN_PARITY["steps"], {
            tag: moe_train1 for tag in ("2x2",)},
        [(rec["rank"], tag, p) for rec in recs
         for tag, p in rec["moe_train_parity"].items()])
    checks += more
    log(f"[other] olmoe fp32 train parity vs degree 1 (losses "
        f"{moe_train1['losses']}): {json.dumps(parity)}")
    tcfg = replace(full, n_layers=MOE_RING_TRAIN["layers"])
    steps = MOE_RING_TRAIN["steps"]
    for rec in recs:
        t = rec["moe_train"]
        want_n, want_lay, _ = ring_train_launches(tcfg, r, t["coords"][1],
                                                  remat=True)
        want_n = {k: v * steps for k, v in want_n.items()}
        checks += [
            (t["launches"] == want_n, f"olmoe bf16 step rank {rec['rank']}: "
             f"launches {t['launches']}, want {want_n}"),
            (t["layouts"] == {k: v * steps for k, v in want_lay.items()},
             f"olmoe bf16 step rank {rec['rank']}: layouts {t['layouts']}"),
            (all(math.isfinite(x) for x in t["losses"]),
             f"olmoe bf16 step losses {t['losses']}")]
        checks += [(t["launches_by_path"][name][path] == want_n[name],
                    f"olmoe bf16 step rank {rec['rank']}: {name} by path "
                    f"{t['launches_by_path'][name]}")
                   for name, path in MAIN_PATH_KERNEL.items()]
        trains[f"olmoe-1b-7b {tcfg.n_layers} layers ring train (1, {r}) "
               f"rank {rec['rank']}"] = (t["launches"], t["layouts"],
                                         t["launches_by_path"])
    loss1 = train_outs[MOE_RING_TRAIN["arch"]]["losses"][0]
    moe_step = dict(
        loss=recs[0]["moe_train"]["losses"][0], degree1_loss=loss1,
        note="a rank's capacity and load-balance loss are its own 512 "
             "tokens' (the reference's), degree 1's all 2048: logged, "
             "not held",
        per_rank=[{k: rec["moe_train"][k] for k in (
            "step_ms", "transport_s", "transport_calls", "transport_gb",
            "staged_share", "peak_gb", "layouts")} for rec in recs])
    log(f"[other] olmoe-1b-7b {tcfg.n_layers} layers bf16 step, batch "
        f"{MOE_RING_TRAIN['batch']} x seq {MOE_RING_TRAIN['seq']}, mesh "
        f"(1, {r}), remat: {json.dumps(moe_step)}")

    # (b) megatron: fp32 train parity and every gradient leaf
    mcfg = parity_config(MEG_PARITY["arch"], MEG_PARITY["n_layers"])
    parity, more = ring_train_parity_checks(
        mcfg, MEG_PARITY["steps"], {
            "x".join(map(str, mesh)): meg1 for mesh in MEG_PARITY["meshes"]},
        [(rec["rank"], tag, p) for rec in recs
         for tag, p in rec["meg_parity"].items()], strategy="megatron")
    checks += more
    grad_worst = {}
    for rec in recs:
        for tag, p in rec["meg_parity"].items():
            errs = p["grad_rel_l2"]
            worst = max(errs, key=errs.get)
            grad_worst[f"{tag} rank {rec['rank']}"] = [worst, errs[worst]]
            checks.append((errs[worst] <= MEG_GRAD_TOL,
                           f"megatron {tag} rank {rec['rank']}: gradient "
                           f"{worst} rel L2 {errs[worst]:.3e} from degree 1"))
    log(f"[other] megatron fp32 train parity vs degree 1 (losses "
        f"{meg1['losses']}): {json.dumps(parity)}; each rank's worst "
        f"gradient leaf (rel L2, after its ring and data bookkeeping): "
        f"{json.dumps(grad_worst)}")

    # (b) megatron's bf16 prefill at 30 layers against phase 5's degree 1
    pfull = get_config(MEG_PREFILL["arch"])
    want_n = prefill_launches(pfull)
    got, want = meg_pre[0], degree1["logits"]
    err = rel_l2(got, want)
    maxerr = (got - want).abs().max().item()
    first = got.argmax(-1)
    first1 = torch.tensor(degree1["tokens"])[:, 0]
    top2 = want.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    for i, rec in enumerate(recs):
        m = rec["meg_prefill"]
        checks += [
            (m["launches"] == want_n, f"megatron prefill rank {i}: launches "
             f"{m['launches']} != {want_n}"),
            (torch.equal(meg_pre[i], got),
             f"megatron prefill: rank {i}'s logits differ from rank 0's")]
        checks += [(m["launches_by_path"][name][path] == want_n[name],
                    f"megatron prefill rank {i}: {name} by path "
                    f"{m['launches_by_path'][name]}")
                   for name, path in MAIN_PATH_KERNEL.items()]
        runs[f"deepseek-7b megatron prefill (1, {r}) rank {i}"] = (
            m["launches"], m["launches_by_path"])
    checks.append((err <= RING_BF16_TOL, f"megatron bf16 prefill logits rel "
                   f"L2 {err:.3e} > {RING_BF16_TOL}"))
    # a flip is possible only where the degree-1 margin is within twice
    # the logits' largest difference
    checks += [(first[row] == first1[row] or margin[row] <= 2 * maxerr,
                f"megatron prefill row {row}: first token {first[row]} != "
                f"degree 1's {first1[row]} at margin {margin[row]:.3e}")
               for row in range(len(first))]
    log(f"[other] deepseek-7b 30 layers bf16 megatron prefill, batch "
        f"{MEG_PREFILL['batch']} x prompt {MEG_PREFILL['prompt_len']}, mesh "
        f"(1, {r}): {json.dumps(dict(prefill_logits_rel_l2=err, prefill_logits_max_abs=maxerr, first_tokens=first.tolist(), degree1_first_tokens=first1.tolist(), degree1_top2_margin=margin.tolist(), per_rank=[rec['meg_prefill'] for rec in recs]))}")

    # (b) megatron's bf16 step under both remat policies
    spec = MEG_REMAT
    bcfg = replace(get_config(spec["arch"]), n_layers=spec["layers"])
    remat = []
    for rec in recs:
        b, g = rec["meg_remat"], rec["rank"]
        for pol, key in REMAT_RUNS:
            want, want_lay, _ = strategy_train_launches(
                bcfg, "megatron", r, b["coords"][1], remat=True,
                saved=pol == "tatp_outputs")
            got_ = b[key]
            checks += [
                (got_["launches"] == want, f"megatron rank {g} {key}: "
                 f"launches {got_['launches']}, want {want}"),
                (got_["layouts"] == want_lay, f"megatron rank {g} {key}: "
                 f"GEMM layouts {got_['layouts']}, want {want_lay}"),
                (abs(got_["loss"] - train_outs[spec["arch"]]["losses"][0])
                 <= spec["tol"] * abs(train_outs[spec["arch"]]["losses"][0]),
                 f"megatron rank {g} {key}: loss {got_['loss']} vs degree "
                 f"1's {train_outs[spec['arch']]['losses'][0]}")]
            checks += [(got_["paths"][name][path] == want[name],
                        f"megatron rank {g} {key}: {name} by path "
                        f"{got_['paths'][name]}")
                       for name, path in MAIN_PATH_KERNEL.items()]
            if "loss_equal" in got_:
                checks += [
                    (got_["loss_equal"], f"megatron rank {g}: {key}'s loss "
                     f"differs from full remat's"),
                    (not got_["grads_differ"], f"megatron rank {g}: {key}'s "
                     f"gradients differ from full remat's: "
                     f"{got_['grads_differ'][:5]}")]
            trains[f"deepseek-7b {spec['layers']} layers megatron {key} "
                   f"step (1, {r}) rank {g}"] = (got_["launches"],
                                                 got_["layouts"],
                                                 got_["paths"])
        remat.append({key: {k: b[key][k] for k in (
            "step_ms", "sent_gb", "peak_gb", "loss")}
            for _, key in REMAT_RUNS})
    log(f"[other] deepseek-7b {spec['layers']} layers bf16 megatron step, "
        f"batch {spec['batch']} x seq {spec['seq']}, mesh (1, {r}), full "
        f"remat then tatp_outputs (degree 1's first loss "
        f"{train_outs[spec['arch']]['losses'][0]}): {json.dumps(remat)}")

    # (c) int8 gradient compression against degree 1's uncompressed losses
    comp = [rec["compress"] for rec in recs]
    for c in comp:
        rel = [abs(a - b) / abs(b) for a, b in zip(c["losses"],
                                                   meg1["losses"])]
        c["loss_rel"] = rel
        checks += [
            (all(math.isfinite(x) for x in c["losses"])
             and max(rel) <= COMPRESS["tol"],
             f"int8 compression at {c['mesh']} {c['coords']}: losses "
             f"{c['losses']} vs degree 1 {meg1['losses']}"),
            (c["err_max"] > 0, f"int8 compression at {c['coords']}: the "
             f"residual is zero"),
            (c["shard_axis"] == "data", f"int8 compression: ZeRO-1 axis "
             f"{c['shard_axis']}")]
    log(f"[other] int8 gradient compression, deepseek-7b "
        f"{MEG_PARITY['n_layers']} layer(s) fp32 at "
        f"{COMPRESS['mesh']}: {json.dumps(comp)}")
    log(f"[other] degree1_s {degree1_s:.1f} ranks_wall_s {ranks_s:.1f} laps "
        f"{json.dumps([rec['laps'] for rec in recs])} phase_s "
        f"{time.perf_counter() - t_phase:.1f}")
    for ok, msg in checks:
        need(ok, msg)
    return gemms, flashes, runs, trains


def main() -> int:
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke: src/repro_torch not found beside chip_smoke.py; "
              "run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    # fp32 comparisons are true fp32 (no TF32 anywhere)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    laps = [("start", t_start)]

    def lap(phase):  # the wall clock each phase took, logged as it ends
        laps.append((phase, time.perf_counter()))
        log(f"[time] {phase}: {laps[-1][1] - laps[-2][1]:.1f} s "
            f"({laps[-1][1] - t_start:.1f} s in all)")

    name, smi = phase_device(torch)
    flex_join = start_flex_warm(torch)
    (ROOT / "build").mkdir(exist_ok=True)
    dryrun_dir = tempfile.mkdtemp(prefix="dryrun_", dir=ROOT / "build")
    dryrun_join = start_dryrun(dryrun_dir)
    phase_build()
    try:
        log(f"[build] flex_attention's compiles beside the build: "
            f"{json.dumps({n: round(s, 1) for n, s in flex_join().items()})}"
            f" ({time.perf_counter() - t_start:.1f} s in all)")
    except Exception as e:  # the yardsticks compile them instead
        log(f"[build] flex_attention's compiles beside the build failed "
            f"({type(e).__name__}: {e}); the yardsticks compile them")
    lap("build")
    kernels = phase_kernels(torch)
    randn = make_randn(torch, 1)
    kernels += phase_gemm_layouts(torch, randn)
    kernels.append(phase_flash_backward(torch, randn))
    fwd_rows, bwd_rows = phase_flash_arch_rows(torch, randn)
    path_errs = phase_path_shapes(torch, randn)
    for k in kernels:
        if k["name"] == "flash_attention":
            k["arch_shapes"] = fwd_rows
        if k["name"] == "flash_attention_bwd":
            k["arch_shapes"] = bwd_rows
        if k["name"] in path_errs:
            k["max_abs_err"] = max(k["max_abs_err"], path_errs[k["name"]])
    kernels.append(phase_ssd_backward(torch, randn))
    lap("kernels")
    for arch, n_layers, b, s in PARITY:
        phase_parity(torch, arch, n_layers, b, s)
    for arch, n_layers, b, s in TRAIN_PARITY:
        phase_train_parity(torch, arch, n_layers, b, s)
    lap("parity")
    degree1 = {}  # deepseek-7b's degree-1 run, for the ring's check
    runs = {arch: phase_main_path(
        torch, arch, degree1 if arch == RING_SERVE["arch"] else None)
        for arch in PATHS}
    trains, train_outs = {}, {}
    for arch, n_layers in TRAIN_RUNS:
        *counts, train_outs[arch] = phase_train_main(torch, arch, n_layers)
        trains[f"{arch} train"] = tuple(counts)
    lap("main paths")
    phase_dryrun(dryrun_join, train_outs["deepseek-7b"])
    lap("dry-run")
    phase_tatp_outputs(torch)
    phase_restart(torch)
    lap("tatp_outputs and restart")
    plan_serves, plan_trained = phase_plan_launch(torch)
    runs.update(plan_serves)
    lap("plan launch")
    runs.update(phase_engine(torch))
    lap("engine")
    phase_cost_engine(torch)
    lap("cost engine")
    (ring_gemms, ring_flashes), ring_runs, window = phase_ring(
        torch, randn, degree1)
    runs.update(ring_runs)
    lap("ring")
    train_flashes, train_gemms, ring_trains, delta_in = phase_ring_train(
        torch, randn, train_outs[RING_TRAIN_BF16["arch"]]["losses"][0])
    trains.update(ring_trains)
    lap("train ring")
    zigzag, more_trains, more_delta_in, window_bwd = phase_ring_more(
        torch, randn)
    trains.update(more_trains)
    lap("train ring, the rest")
    ssm_rows, ssm_gemms, ssm_runs, ssm_trains = phase_ssm_ring(torch, randn)
    runs.update(ssm_runs)
    trains.update(ssm_trains)
    lap("ssm ring")
    other_gemms, other_flashes, other_runs, other_trains = phase_other(
        torch, randn, degree1, train_outs)
    runs.update(other_runs)
    trains.update(other_trains)
    lap("other strategies and the all-to-all")
    trains[f"{PLAN_TRAIN['arch']} --wafers {PLAN_TRAIN['wafers']} --stage "
           f"{PLAN_TRAIN['stage']} train"] = plan_trained
    # each record's launches: the counts of every main path's run (the
    # serve paths and the train paths), read just after it.  The GEMM's
    # three records split its train launches by layout: tatp_matmul counts
    # the forward ones (serve's too), tatp_matmul_dgrad and _wgrad theirs;
    # every one took wgmma, as phase_train_main asserts step by step, but
    # in phase 14's steps, whose in_proj tiles take wmma
    all_runs = dict(runs)
    for train, (train_n, _, train_paths) in trains.items():
        all_runs[train] = (train_n, train_paths)
    for k in kernels:
        lay = GEMM_RECORD_LAYOUT.get(k["name"])
        counter = "tatp_matmul" if lay else k["name"]
        of = {} if lay in ("dgrad", "wgrad") else {
            a: (n[counter], p.get(counter)) for a, (n, p) in all_runs.items()}
        if lay:
            for train, (_, train_layouts, train_paths) in trains.items():
                n = train_layouts[lay]
                paths = train_paths[counter]
                # a run whose tiles all took wgmma splits by layout; one
                # with wmma tiles too (phase 14's) has its split by path
                # over all layouts only, in its own record
                of[train] = (n, None if paths.get("wmma") else {
                    key: n if key == "wgmma" else 0 for key in paths})
        k["launches"] = sum(n for n, _ in of.values())
        k["launches_by_path"] = {a: n for a, (n, _) in of.items()}
        if counter in MAIN_PATH_KERNEL:
            k["launches_by_kernel_path"] = {a: p for a, (_, p) in of.items()}
    for k in kernels:  # the ring's per-round shapes (phases 11 and 12)
        if k["name"] in ("tatp_matmul", "flash_attention"):
            k["ring_shapes"] = (ring_gemms if k["name"] == "tatp_matmul"
                                else ring_flashes)
        if k["name"] == "flash_attention":  # phase 13's zigzag launch
            k["zigzag_shapes"] = [z for z in zigzag
                                  if z["direction"] == "forward"]
            # phase 17: the launches at a query offset, and the sweep
            k["window_shapes"] = window["rows"]
            k["offset_sweep_max_abs_err"] = window["sweep"]
            k["max_abs_err"] = max([k["max_abs_err"]]
                                   + [w["max_abs_err"]
                                      for w in window["rows"]])
        if k["name"] == "tatp_matmul":  # phase 14's SSM ring tiles
            k["ssm_ring_shapes"] = ssm_gemms
            # phase 15's megatron local GEMMs and olmoe's ring tile
            k["other_shapes"] = other_gemms
        if k["name"] in ("flash_attention", "flash_attention_bwd"):
            way = "forward" if k["name"] == "flash_attention" else "backward"
            k["other_shapes"] = [f for f in other_flashes
                                 if f["direction"] == way]
        if k["name"] in ("ssd", "ssd_bwd"):  # phase 14's local pass
            way = "forward" if k["name"] == "ssd" else "backward"
            k["ring_shapes"] = [s for s in ssm_rows
                                if s["direction"] == way]
        lay = GEMM_RECORD_LAYOUT.get(k["name"])
        if lay in ("dgrad", "wgrad"):
            k["ring_train_shapes"] = [g for g in train_gemms
                                      if g["layout"] == lay]
    # the flash backward with an outside delta: ring attention's rounds in
    # phase 12's bf16 train, timed at one round of it
    row = train_flashes[0]
    kernels.append(dict(
        name="flash_attention_bwd_delta_in", route="cuda", path="mma",
        design="the two backward launches with delta read from outside "
               "(delta_in): the dQ kernel skips its delta sweep; one pair "
               "a visible ring round, with the ring's global row LSE and "
               "delta = rowsum(dO O) of its merged fp32 output",
        source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="none: the Pallas kernel "
                 "src/repro/kernels/flash_attention/kernel.py:26 has no "
                 "backward (JAX differentiates ring attention's jnp loop)",
        launches=delta_in + more_delta_in,
        max_abs_err=max(f["max_abs_err"] for f in train_flashes
                        + [z for z in zigzag
                           if z["direction"] == "backward"]
                        + window_bwd["rows"]
                        + [dict(max_abs_err=e)
                           for e in window_bwd["sweep"].values()]),
        rtol=ATTN_TOL["bfloat16"][0], atol=ATTN_TOL["bfloat16"][1],
        ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=row["library_ms"],
        own_delta_ms=row["own_delta_ms"],
        share_of_bound=row["share_of_bound"],
        library_ratio=row["library_ratio"],
        timed="one round of the (1, 4) train ring's attention, "
              "[4,32,128,128] bf16, causal on the own block",
        shape=row["shape"], rounds=train_flashes,
        zigzag_shapes=[z for z in zigzag if z["direction"] == "backward"],
        # phase 13: the launches at a query offset, and the sweep
        window_shapes=window_bwd["rows"],
        offset_sweep_max_abs_err=window_bwd["sweep"]))
    log(json.dumps({"kernels": kernels}))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--ring-rank"]:  # one rank of phase 11
            sys.exit(ring_rank_main(sys.argv[2]))
        if sys.argv[1:2] == ["--ring-engine-rank"]:  # phase 16 alone
            sys.exit(ring_engine_rank_main(sys.argv[2]))
        if sys.argv[1:2] == ["--window-rank"]:  # phase 17 alone
            sys.exit(window_rank_main(sys.argv[2]))
        if sys.argv[1:2] == ["--train-rank"]:  # one rank of phase 12
            sys.exit(ring_train_rank_main(sys.argv[2]))
        if sys.argv[1:2] == ["--ring-more-rank"]:  # one rank of phase 13
            sys.exit(ring_more_rank_main(sys.argv[2]))
        if sys.argv[1:2] == ["--ssm-ring-rank"]:  # one rank of phase 14
            sys.exit(ssm_ring_rank_main(sys.argv[2]))
        if sys.argv[1:2] == ["--other-rank"]:  # one rank of phase 15
            sys.exit(other_rank_main(sys.argv[2]))
        if sys.argv[1:2] == ["--dryrun-trace"]:  # phase 18 (b)
            sys.exit(dryrun_trace_main(sys.argv[2]))
        adopt_orphans()
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
    finally:
        stop_children()
