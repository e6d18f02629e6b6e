#!/usr/bin/env python3
"""Drive the repro_torch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout (it puts ``src/`` on the path itself).  It
imports nothing of jax or of the JAX package ``repro``.  Phases, each of
which fails the run (non-zero exit, no final ``ok`` line) on any error:

1. device — the card's name and power limit from ``nvidia-smi``;
2. build — the four CUDA sources from ``src/repro_torch/csrc`` (GEMM,
   flash attention, the SSD and its backward; one ``nvcc`` per source,
   in parallel), with the compiler's register/shared-memory report;
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
   256] kv 8, with no library yardstick: SDPA takes no soft-cap;
   gemma-7b's D 256 prefill; seamless-m4t-large-v2's bidirectional
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
   32 generated tokens: deepseek-7b (30 layers, prompt 128), mamba2-780m
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
   ``make_train_step`` and ``SyntheticDataset``, 5 steps each:
   deepseek-7b with 4 layers (each step exactly 115 GEMMs: 57 forward
   with remat's recompute, 29 dgrad, 29 wgrad, the lm head's three
   included; 8 flash forwards and 4 flash backwards), mamba2-780m at its
   48 layers (387 GEMMs, 96 SSD forwards, 48 SSD backwards) and
   zamba2-2.7b at its 54 (579 GEMMs, 18 flash forwards, 9 flash
   backwards, 90 SSD forwards, 45 SSD backwards) and olmoe-1b-7b with 4
   layers (33 forward GEMMs, 17 dgrad, 17 wgrad, 8 flash forwards, 4
   backwards; the router and expert products are torch), gemma2-9b with
   4 layers (115 GEMMs, 8 / 4 flash, the backward on ``mma`` at D 256),
   internvl2-1b at its 24 (675 GEMMs, 48 / 24 flash) and
   seamless-m4t-large-v2 at its 24 + 24 (1539 GEMMs, 144 / 72 flash:
   the encoder is recomputed under remat); every GEMM on ``wgmma``,
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
   for deepseek-7b and gemma-7b (batch 4, prompt 128, 32 tokens; gemma's
   plan prescribes ``megatron``, run at model degree 1) twice, the first
   logging ``[plan] solved fresh`` and the second a cache hit, both with
   tokens identical to the legacy flags' on the same weights and exactly
   their launches (210/30 and 196/28); then ``repro_torch.launch.train
   --arch deepseek-7b --wafers 8 --stage 0 --batch 4 --seq 512 --steps 5
   --ckpt-dir``: the stage's 4 layers, 5 steps' launches, each loss
   bitwise equal to ``make_train_step`` on ``solver.stage_config(cfg,
   4)`` from the same seed, the plan hash and stage in the manifest; and a
   relaunch with ``--failed-dies 3,9 --fail-wafer 1`` that re-solves only
   wafer 1's stage and prints the reference's plan-drift warning.  The
   ``[plan]`` lines give the serve runs' ms/token and the train run's
   step ms, tokens/s, MFU and peak GB;
9. engine — engine-mode serving (``repro_torch.launch.serve --serve
   --auto-plan``, ``serve_engine``) of deepseek-7b at its 30 layers,
   bf16, on ``TorchServeExecutor`` and a wall clock: 12 Poisson requests
   at 4 a second into 4 decode slots, 128 prompt and 32 new tokens each,
   with a fresh plan cache.  (a) Fault-free: every request finished with
   its 32 tokens, and exactly 210 GEMM and 30 flash launches per prefill
   group the engine ran (decode runs no kernel), all ``wgmma`` / ``mma``.
   (b) The same with ``--fault-at 2.0``: exactly one replan, whose plan
   hash equals ``replan_serve``'s offline solve for the same fault, and
   every request finished or rejected with a reason.  Each run logs
   TTFT and TPOT p50/p99, tokens/s, makespan, mean occupancy, peak GB and
   the executor's call times; (b) its recovery event.  (c) fp32, TF32
   off, at full width: deepseek-7b (2 layers, prompts of 128 and 96) and
   zamba2-2.7b (6 layers, prompts of 256 and 512) through ``ServeEngine``
   on a virtual clock, each executor call charged 1.0 s, with a die fault
   at 1e-9 s so ``migrate`` runs; kernels against every hook's plain
   version: identical token streams and reports, the SSD on its kernel
   in zamba2's run.

It then prints one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line,
and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
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


def need(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*parts):
    print(*parts, flush=True)


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
    host op count and the heaviest kernels.  Profiling slows the host, so
    the wall time here is above the unprofiled one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    )


def bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / PEAK_BYTES
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem
                                     else "bytes")


def flash_bwd_bytes(b, hq, hkv, sq, skv, d):
    """Bytes the bf16 flash backward must move: q, dO and dQ (Hq heads, Sq
    rows), k, v, dK and dV (Hkv heads, Skv rows) once each, and the fp32
    row lse.  O is not read (the kernels form delta from P and dP), and
    delta passes between the two kernels, so neither counts."""
    return 2 * b * d * (3 * hq * sq + 4 * hkv * skv) + 4 * b * hq * sq


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(torch):
    need(torch.cuda.is_available(), "no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    need(bool(smi), "nvidia-smi printed no card")
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}; nvidia-smi: {smi[0]}; torch {torch.__version__}"
        f" cuda {torch.version.cuda}; count {torch.cuda.device_count()}")
    return name, smi[0]


def phase_build():
    from repro_torch.kernels import _build
    secs = _build.build_all()
    log(f"[build] {len(_build.SOURCES)} kernels built in {secs:.1f} s "
        f"(nvcc {_build.nvcc_path()})")
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
TRAIN = dict(batch=4, seq=512, n_layers=4, steps=5)
M_TRAIN = TRAIN["batch"] * TRAIN["seq"]
# the bf16 train main paths at batch 4 x seq 512: (arch, layers).
# deepseek-7b's 30 layers need ~110 GB with AdamW's state (16 B a
# parameter); mamba2-780m (0.781 B parameters, ~12.5 GB) and zamba2-2.7b
# (1.956 B in this config, ~31 GB) fit one card at full depth;
# olmoe-1b-7b's 16 layers (6.9 B, ~111 GB) do not, its 4 layers (1.88 B,
# ~30 GB) do; gemma2-9b's 4 layers (two LG units, 1.71 B, ~27 GB) do, as
# do internvl2-1b (0.49 B) and seamless-m4t-large-v2 (24 + 24 layers,
# 1.37 B) at full depth.
TRAIN_RUNS = (("deepseek-7b", TRAIN["n_layers"]), ("mamba2-780m", 48),
              ("zamba2-2.7b", 54), ("olmoe-1b-7b", TRAIN["n_layers"]),
              ("gemma2-9b", TRAIN["n_layers"]), ("internvl2-1b", 24),
              ("seamless-m4t-large-v2", 24))
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
        source="src/repro_torch/csrc/flash_attention.cu",
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
# soft-capped slot, with no library yardstick) and seamless's three at D 64
# (on mma.sync)
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
    forward at gemma2-9b's windowed, soft-capped prefill (no library
    yardstick: SDPA takes no soft-cap), gemma-7b's prefill (D 256),
    seamless's bidirectional encoder and its cross attention of the
    prompt's queries to the frames (against SDPA), and the backward on
    ``mma`` at D 256: gemma-7b's train shape (against SDPA's backward) and
    gemma2-9b's windowed, soft-capped one (q scaled by
    :func:`cap_scale`), where two launches must give bitwise equal
    gradients, and at D 64: seamless's encoder, decoder and cross
    attention (against SDPA's backward).  Each asserts its path and is timed beside its bound over
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
                   library_ms=None,
                   library="scaled_dot_product_attention" if plain
                   else "none: SDPA takes no soft-cap")
        if plain:
            qc, kc, vc = (t.contiguous() for t in (q, k, v))
            row["library_ms"] = time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qc, kc, vc, is_causal=causal), 20)
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
            library_ms=None, library="none: SDPA takes no soft-cap")
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


def attn_pairs(sq, skv, causal, window):
    """The (query, key) pairs one head attends under the flash kernel's
    masks (top-left causal, ``q - k < window``)."""
    n = 0
    for q in range(sq):
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


def parity_config(arch, n_layers):
    """``arch`` at full width in fp32 with ``n_layers`` layers (and as
    many encoder layers, for an encoder-decoder)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    cfg = replace(get_config(arch), n_layers=n_layers, dtype="float32")
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


def phase_main_path(torch, arch):
    """One-shot serve of ``arch`` (all layers, bf16) through the entry
    point a user calls; the launch counts cover exactly this run."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import prompt_batch, serve
    from repro_torch.models import lm
    from repro_torch.models.transformer import init_params, padded_vocab

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
    run = dict(batch=bsz, prompt_len=spec["prompt_len"], gen=GEN)
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
    res = serve(args, params=params)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    paths = read_paths()
    peak = torch.cuda.max_memory_allocated()

    need(launches == spec["launches"],
         f"{arch}: launches {launches} != {spec['launches']}")
    # every GEMM on wgmma + TMA, every flash on the tensor cores
    for name, path in MAIN_PATH_KERNEL.items():
        need(paths[name][path] == launches[name],
             f"{arch}: {name} launches by path {paths[name]}, want all "
             f"{launches[name]} on {path}")
    need(res["generated_shape"] == [bsz, GEN + 1],
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

    # where the time goes: one prefill, then 4 decode steps as serve runs
    # them (token to the host after each step)
    steps = 4
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
                decode_4_steps=profile_window(torch, decode_steps))
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
    log(f"[main path] {arch} {cfg.n_layers} layers bf16 batch {bsz} "
        f"prompt {run['prompt_len']} gen {GEN}: {json.dumps(out)}")
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
    AdamWConfig()), through make_train_step and SyntheticDataset, 5 steps.
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
        init_s=init_s, device_ms=halves, profile=prof)
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
# --wafers 8 --stage 0 gives deepseek-7b at 4 x 512 (4 of its 30 layers)
PLAN_SERVES = ("deepseek-7b", "gemma-7b")
PLAN_TRAIN = dict(arch="deepseek-7b", wafers=8, stage=0, layers=4,
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
               gen=GEN)
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
                     run["prompt_len"] + GEN, cache_dir=solo, remat=False)
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
        f"{run['batch']} prompt {run['prompt_len']} gen {GEN}: "
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
    """``launch.train --arch deepseek-7b --wafers 8 --stage 0 --batch 4
    --seq 512 --steps 5 --ckpt-dir``: the MultiWaferPlan's stage 0 holds 4
    layers; each step's loss bitwise equal to ``make_train_step`` on
    ``solver.stage_config(cfg, 4)`` from the launcher's seed; the launches
    exactly 5 steps' (counted over the launch); the manifest records the
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
    --wafers 8 --stage 0`` for deepseek-7b (:func:`plan_train`).  Returns
    each run's (launches, launches by path) and the train run's GEMM
    layouts."""
    import tempfile
    serves = {}
    for arch in PLAN_SERVES:
        with tempfile.TemporaryDirectory() as cache:
            serves[f"{arch} --auto-plan"] = plan_serve(torch, arch, cache)
    with tempfile.TemporaryDirectory() as cache, \
            tempfile.TemporaryDirectory() as ck:
        trained = plan_train(torch, cache, ck)
    return serves, trained


# engine-mode serving (``launch.serve --serve``): deepseek-7b at its 30
# layers, bf16, 4 decode slots, 128 prompt tokens and 32 new tokens each.
# The measured load: 100 open-loop requests at 1.25 a second, below the
# ~1.8 a second that 4 slots of ~2 s serve, so the queue has a steady
# state and TTFT's p99 rests on 100 samples; then the same with a die
# fault at 2.0 s on the engine's clock (``--fault-at``, 1/8 of the dies,
# seeded).  The stress load: 12 requests at 4 a second, twice what the
# slots serve, so TTFT grows with each request (queueing, not the server)
ENGINE = dict(arch="deepseek-7b", max_batch=4, prompt_len=128, max_new=32,
              fault_at=2.0)
ENGINE_LOAD = dict(requests=100, rate=1.25)
ENGINE_RUNS = (("engine", ENGINE_LOAD, False),
               ("engine fault", ENGINE_LOAD, True),
               ("engine stress", dict(requests=12, rate=4.0), False))
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
    name, smi = phase_device(torch)
    phase_build()
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
    for arch, n_layers, b, s in PARITY:
        phase_parity(torch, arch, n_layers, b, s)
    for arch, n_layers, b, s in TRAIN_PARITY:
        phase_train_parity(torch, arch, n_layers, b, s)
    runs = {arch: phase_main_path(torch, arch) for arch in PATHS}
    trains = {f"{arch} train": phase_train_main(torch, arch, n_layers)[:3]
              for arch, n_layers in TRAIN_RUNS}
    phase_tatp_outputs(torch)
    phase_restart(torch)
    plan_serves, plan_trained = phase_plan_launch(torch)
    runs.update(plan_serves)
    runs.update(phase_engine(torch))
    trains[f"{PLAN_TRAIN['arch']} --wafers {PLAN_TRAIN['wafers']} --stage "
           f"{PLAN_TRAIN['stage']} train"] = plan_trained
    # each record's launches: the counts of every main path's run (the
    # serve paths and the train paths), read just after it.  The GEMM's
    # three records split its train launches by layout: tatp_matmul counts
    # the forward ones (serve's too), tatp_matmul_dgrad and _wgrad theirs;
    # every one took wgmma, as phase_train_main asserts step by step
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
                of[train] = (n, {key: n if key == "wgmma" else 0
                                 for key in train_paths[counter]})
        k["launches"] = sum(n for n, _ in of.values())
        k["launches_by_path"] = {a: n for a, (n, _) in of.items()}
        if counter in MAIN_PATH_KERNEL:
            k["launches_by_kernel_path"] = {a: p for a, (_, p) in of.items()}
    log(json.dumps({"kernels": kernels}))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
