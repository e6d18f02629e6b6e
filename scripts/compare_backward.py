#!/usr/bin/env python3
"""Time the two backward kernels (flash attention's and the SSD's) of one
or more checkouts of this repository on one NVIDIA GPU, in turns, so that
every checkout sees the same card and host.

    python3 scripts/compare_backward.py --root parent=PATH --root change=PATH \
        [--order parent,change,change,parent] [--train]

Each turn is one child process that puts ``<root>/src`` first on the path
and builds that checkout's kernels.  It then times, as device time (CUDA
events behind a device-side spin, as ``chip_smoke.py:time_ms``):

* the flash backward (``attention_bwd``, bf16, ``[B, S, H, D]``
  activations viewed as ``[B, H, S, D]``) at every backward row of
  ``PERF.md`` section 6, at query offset 0: deepseek-7b's causal train
  shape [4, 32, 512, 128], zamba2-2.7b's [4, 32, 512, 80], gemma-7b's
  [4, 16, 512, 256], gemma2-9b's windowed, soft-capped ``L`` slot [4, 16,
  512, 256] over 8 K/V heads (q scaled by 2 x cap, as ``chip_smoke.py``
  scales it), seamless-m4t-large-v2's three at D 64 (the decoder's causal
  [4, 16, 512, 64], the encoder's bidirectional 1024 frames, the cross
  attention of 512 queries to 1024 frames), ``megatron``'s local heads
  [4, 8, 512, 128], and with an outside delta (``delta_in``, the train
  ring's rounds) the (1, 4) ring's round [4, 32, 128, 128] and zigzag's c
  x c launch [4, 32, 64, 128], causal and unmasked; beside its bound
  (five products over the attended pairs; q, k, v, dO, dQ, dK, dV and the
  row lse moved once: the bf16 kernels do not read O) and SDPA's
  backward (autograd's forward and backward less the forward; none under
  a cap or a window); and its gradients' error against fp32 autograd of
  ``attention_ref`` on the same bf16 values, held to
  ``tests/test_torch_attn_bwd.py``'s tolerance (2 bf16 ulps of the
  gradient's RMS plus one bf16 ulp of each element);
* the SSD backward (``ssd_intra_chunk_bwd``, fp32) at mamba2-780m's
  [8, 256, 48, 64], N 128 and zamba2-2.7b's [8, 256, 80, 64], N 64,
  beside its bounds at 3xTF32 and at the fp32 CUDA-core rate;

and, for each, the device time of every ``__global__`` kernel of one call
(``torch.profiler``).  A turn that builds its checkout's kernels reports
the seconds ``nvcc`` took for each flash attention source alone
(``csrc/flash_attention.cu``, and ``csrc/flash_attention_bwd.cu`` where
the checkout has it).  With ``--train`` it also trains each model at full
width, bf16, 4 x 512 tokens, remat, as ``chip_smoke.py`` does (deepseek-7b
with 4 layers, mamba2-780m with 48, zamba2-2.7b with 54): the median
host-clock step of steps 2-4 and, of one profiled step, the device busy
time and the device time of the ``flash_bwd`` and ``ssd_bwd`` kernel
families.  One JSON line per turn, then the medians by checkout.  It needs
one card and imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

PEAK_BF16, PEAK_TF32X3, PEAK_F32, PEAK_BYTES = 989e12, 495e12 / 3, 67e12, \
    3.35e12
SPIN_HZ = 1.98e9
# (B, Hq, Hkv, Sq, Skv, D, causal, window, cap, delta_in)
FLASH_SHAPES = {
    "deepseek-7b": (4, 32, 32, 512, 512, 128, True, None, None, False),
    "zamba2-2.7b": (4, 32, 32, 512, 512, 80, True, None, None, False),
    "gemma-7b": (4, 16, 16, 512, 512, 256, True, None, None, False),
    "gemma2-9b L": (4, 16, 8, 512, 512, 256, True, 4096, 50.0, False),
    "seamless-m4t-large-v2 dec": (4, 16, 16, 512, 512, 64, True, None, None,
                                  False),
    "seamless-m4t-large-v2 enc": (4, 16, 16, 1024, 1024, 64, False, None,
                                  None, False),
    "seamless-m4t-large-v2 cross": (4, 16, 16, 512, 1024, 64, False, None,
                                    None, False),
    "megatron local heads": (4, 8, 8, 512, 512, 128, True, None, None,
                             False),
    "ring round delta_in causal": (4, 32, 32, 128, 128, 128, True, None,
                                   None, True),
    "ring round delta_in unmasked": (4, 32, 32, 128, 128, 128, False, None,
                                     None, True),
    "zigzag delta_in causal": (4, 32, 32, 64, 64, 128, True, None, None,
                               True),
    "zigzag delta_in unmasked": (4, 32, 32, 64, 64, 128, False, None, None,
                                 True)}
SSD_SHAPES = {"mamba2-780m": (8, 256, 48, 64, 128),
              "zamba2-2.7b": (8, 256, 80, 64, 64)}
TRAIN_RUNS = (("deepseek-7b", 4), ("mamba2-780m", 48), ("zamba2-2.7b", 54))
FAMILIES = {"flash_bwd": "namespace)::flash_bwd_",
            "ssd_bwd": "namespace)::ssd_bwd_"}


def time_ms(torch, fn, iters=20, warmup=3):
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


def device_kernels(torch, fn):
    """{kernel name: device ms} of one call of ``fn``, and the busy sum."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0][:60]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    return out, sum(out.values())


def grad_err(torch, got, q, k, v, do, kw):
    """{gradient: its largest error against fp32 autograd of attention_ref
    (at the masks and cap ``kw``) beyond one bf16 ulp of the element (the
    final rounding both sides share), over the gradient's RMS; the limit of
    2 bf16 ulps of the RMS, over the RMS; and whether every element keeps
    within it}."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*leaves, **kw), leaves,
                               do.float())
    out = {}
    for name, g, r in zip(("dq", "dk", "dv"), got, want):
        rms = r.pow(2).mean().sqrt().item()
        excess = ((g.float() - r).abs() - 2.0 ** -8 * r.abs()).max().item()
        limit = 2 * 2.0 ** (math.floor(math.log2(rms)) - 7)
        out[name] = dict(excess_over_rms=excess / rms,
                         limit_over_rms=limit / rms, ok=excess <= limit)
    return out


def flash_rows(torch):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import (_forward,
                                                         attention_bwd)
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for arch, (b, hq, hkv, sq, skv, d, causal, window, cap,
               delta_in) in FLASH_SHAPES.items():
        q, k, v, do = (torch.randn(b, s, h, d, generator=g, device="cuda")
                       .to(torch.bfloat16).transpose(1, 2)
                       for s, h in ((sq, hq), (skv, hkv), (skv, hkv),
                                    (sq, hq)))
        if cap is not None:  # the cap bites (chip_smoke.py:cap_scale)
            q = (q.float() * 2 * cap).to(torch.bfloat16)
        kw = dict(causal=causal, window=window, cap=cap)
        o, lse = _forward(q, k, v, causal, window, cap, None, want_lse=True)
        # a ring round's outside delta: rowsum(dO O) of the row's output
        delta = ((do.float() * o.float()).sum(-1).contiguous() if delta_in
                 else None)
        qc, kc, vc = (t.contiguous() for t in (q, k, v))

        def run():
            return attention_bwd(q, k, v, o, lse, do, delta=delta, **kw)

        def sdpa_fwd_bwd():
            qq, kk, vv = (t.detach().requires_grad_(True)
                          for t in (qc, kc, vc))
            torch.autograd.grad(F.scaled_dot_product_attention(
                qq, kk, vv, is_causal=causal), (qq, kk, vv), do)

        ms = time_ms(torch, run, 10)
        lib = None
        if cap is None and window is None and hkv == hq:
            lib = (time_ms(torch, sdpa_fwd_bwd, 10)
                   - time_ms(torch, lambda: F.scaled_dot_product_attention(
                       qc, kc, vc, is_causal=causal), 10))
        qpos = torch.arange(sq)[:, None]
        seen = torch.ones(sq, skv, dtype=torch.bool)
        if causal:
            seen &= torch.arange(skv)[None, :] <= qpos
        if window is not None:
            seen &= qpos - torch.arange(skv)[None, :] < window
        pairs = b * hq * int(seen.sum())
        flops = 10 * pairs * d
        nbytes = 2 * b * d * (3 * hq * sq + 4 * hkv * skv) + 4 * b * hq * sq
        if delta_in:
            nbytes += 4 * b * hq * sq
        bound = max(flops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3
        kern, _ = device_kernels(torch, run)
        rows[arch] = dict(shape=[b, hq, sq, d], kv=[hkv, skv], causal=causal,
                          window=window, cap=cap, delta_in=delta_in, ms=ms,
                          sdpa_bwd_ms=lib,
                          ratio=None if lib is None else ms / lib,
                          bound_ms=bound, share_of_bound=bound / ms,
                          kernels=kern,
                          grad_err=grad_err(torch, run(), q, k, v, do, kw))
    return rows


def ssd_rows(torch):
    from repro_torch.kernels.ssd.ops import ssd_intra_chunk_bwd
    g = torch.Generator(device="cuda").manual_seed(2)
    rows = {}
    for arch, (bc, q, h, p, n) in SSD_SHAPES.items():
        x = torch.randn(bc, q, h, p, generator=g, device="cuda")
        bm, cm = (torch.randn(bc, q, n, generator=g, device="cuda")
                  for _ in range(2))
        dt = torch.rand(bc, q, h, generator=g, device="cuda") * 0.1
        a = -torch.linspace(1.0, 16.0, h, device="cuda")
        cots = (torch.randn(bc, q, h, p, generator=g, device="cuda"),
                torch.randn(bc, h, p, n, generator=g, device="cuda"),
                torch.randn(bc, h, generator=g, device="cuda"))

        def run():
            ssd_intra_chunk_bwd(x, dt, a, bm, cm, *cots)

        pairs = q * (q + 1) // 2
        flops = bc * (6 * n * pairs + h * (4 * p * pairs + 4 * q * p * n))
        nbytes = 4 * (3 * bc * q * h * p + bc * h * p * n + bc * h
                      + 2 * bc * q * h + 2 * h + 4 * bc * q * n)
        ms = time_ms(torch, run)
        bound = max(flops / PEAK_TF32X3, nbytes / PEAK_BYTES) * 1e3
        kern, _ = device_kernels(torch, run)
        rows[arch] = dict(
            shape=[bc, q, h, p, n], ms=ms, bound_ms=bound,
            bound_fp32_cuda_ms=max(flops / PEAK_F32, nbytes / PEAK_BYTES)
            * 1e3, share_of_bound=bound / ms, kernels=kern)
    return rows


def train_rows(torch):
    from dataclasses import replace
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.core.dist import Dist
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.train_loop import make_train_step
    dev = torch.device("cuda")
    rows = {}
    for arch, n_layers in TRAIN_RUNS:
        cfg = replace(get_config(arch), n_layers=n_layers)
        dist = Dist(dev)
        shape = ShapeConfig("train", "train", 512, 4)
        bundle = make_train_step(cfg, ParallelConfig(strategy="tatp"), dist,
                                 shape)
        data = SyntheticDataset(cfg, shape, dist, seed=0)
        params, state = bundle.init_fn(
            torch.Generator(device=dev).manual_seed(0))
        step_ms = []
        for step in range(4):
            batch = data.batch(step)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, _ = bundle.step_fn(params, state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        batch = data.batch(4)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, state, _ = bundle.step_fn(params, state, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        fam = dict.fromkeys(FAMILIES, 0.0)
        busy = 0.0
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            ms = e.time_range.elapsed_us() / 1e3
            busy += ms
            for f, key in FAMILIES.items():
                if key in e.name:
                    fam[f] += ms
        rows[arch] = dict(layers=n_layers, step_ms=step_ms,
                          step_ms_median=statistics.median(step_ms[1:]),
                          profiled_wall_ms=wall, device_busy_ms=busy,
                          family_ms=fam)
        del params, state, bundle
        torch.cuda.empty_cache()
    return rows


def child(root: Path, train: bool) -> dict:
    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("compare_backward: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flash_build_s = {n: _build.build_all((n,)) for n in _build.SOURCES
                     if n.startswith("flash_attention")
                     and not _build._lib_path(n).exists()}
    _build.build_all()
    out = dict(flash_bwd=flash_rows(torch), ssd_bwd=ssd_rows(torch),
               flash_build_s=flash_build_s or None)
    if train:
        out["train"] = train_rows(torch)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", default=[],
                    help="LABEL=PATH of a checkout (one or more)")
    ap.add_argument("--order", default=None,
                    help="comma-separated labels, one turn each (default: "
                         "A,B,B,A for two roots, else each root once)")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(Path(args.child), args.train)))
        return 0
    roots = dict(r.split("=", 1) for r in args.root)
    if not roots:
        ap.error("give at least one --root LABEL=PATH")
    labels = list(roots)
    order = (args.order.split(",") if args.order
             else [labels[0], labels[1], labels[1], labels[0]]
             if len(labels) == 2 else labels)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    turns = []
    for label in order:
        cmd = [sys.executable, __file__, "--child",
               str(Path(roots[label]).resolve())]
        if args.train:
            cmd.append("--train")
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        turns.append((label, res))
        print(json.dumps({"turn": label, "result": res}), flush=True)
    summary = {}
    for label in labels:
        res = [r for lab, r in turns if lab == label]
        if not res:
            continue
        med = summary.setdefault(label, {})
        for part, keys in (("flash_bwd", ("ms", "sdpa_bwd_ms", "ratio",
                                          "share_of_bound")),
                           ("ssd_bwd", ("ms", "share_of_bound"))):
            for arch in res[0][part]:
                med[f"{part} {arch}"] = {
                    k: statistics.median(r[part][arch][k] for r in res)
                    for k in keys if res[0][part][arch][k] is not None}
                if "grad_err" in res[0][part][arch]:  # deterministic
                    med[f"{part} {arch}"]["grad_err"] = \
                        res[0][part][arch]["grad_err"]
        med["flash_build_s"] = [r["flash_build_s"] for r in res
                                if r["flash_build_s"] is not None]
        for arch in res[0].get("train", {}):
            rows = [r["train"][arch] for r in res]
            med[f"train {arch}"] = dict(
                step_ms_median=statistics.median(
                    r["step_ms_median"] for r in rows),
                device_busy_ms=statistics.median(
                    r["device_busy_ms"] for r in rows),
                **{f: statistics.median(r["family_ms"][f] for r in rows)
                   for f in FAMILIES})
    print(json.dumps({"card": smi, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
