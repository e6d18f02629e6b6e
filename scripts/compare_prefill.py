#!/usr/bin/env python3
"""Compare the one-shot serve paths of two checkouts of this repository on
one NVIDIA GPU, in turns, so that both see the same card and host.

    python3 scripts/compare_prefill.py --root parent=PATH --root change=PATH \
        [--order parent,change,change,parent] [--arch deepseek-7b ...]

Each turn is one child process that puts ``<root>/src`` first on the path,
builds that checkout's kernels, and for each model (full width and depth,
bf16, random weights from seed 0, batch 4, the prompt lengths of
``chip_smoke.py``) times five prefills on the host clock (median), one
prefill's device busy time under ``torch.profiler``, and one
``repro_torch.launch.serve`` call's decode ms/token.  The script prints a
JSON line per turn and, last, the medians by checkout and model.  It needs
one card; it imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from argparse import Namespace
from pathlib import Path

PROMPTS = {"deepseek-7b": 128, "mamba2-780m": 512, "zamba2-2.7b": 512}
BATCH, GEN = 4, 32


def child(root: Path, archs) -> dict:
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.core.dist import Dist
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import serve
    from repro_torch.models.transformer import init_params
    from repro_torch.train.train_loop import make_serve_fns

    if not torch.cuda.is_available():
        raise SystemExit("compare_prefill: no CUDA device is available")
    _build.build_all()
    dev = torch.device("cuda")
    out = {}
    for arch in archs:
        cfg = get_config(arch)
        s = PROMPTS[arch]
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
        sb = make_serve_fns(cfg, ParallelConfig(strategy="tatp",
                                                remat=False), Dist(dev))
        toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (BATCH, s))
        batch = {"tokens": torch.as_tensor(toks, device=dev)}
        sb.prefill_fn(params, batch)  # warm-up
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sb.prefill_fn(params, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sb.prefill_fn(params, batch)
            torch.cuda.synchronize()
        busy = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == DeviceType.CUDA) / 1e3
        res = serve(Namespace(arch=arch, reduced=False, device="cuda",
                              batch=BATCH, prompt_len=s, gen=GEN),
                    params=params)
        out[arch] = dict(prefill_ms=statistics.median(times),
                         prefill_ms_runs=times, prefill_device_busy_ms=busy,
                         decode_ms_per_token=res["ms_per_token"])
        del params
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", default=[],
                    help="LABEL=PATH of a checkout (give two or more)")
    ap.add_argument("--order", default=None,
                    help="comma-separated labels, one turn each "
                         "(default: A,B,B,A for the first two roots)")
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    archs = args.arch or list(PROMPTS)
    if args.child:
        print(json.dumps(child(Path(args.child), archs)))
        return 0
    roots = dict(r.split("=", 1) for r in args.root)
    if len(roots) < 2:
        ap.error("give at least two --root LABEL=PATH")
    labels = list(roots)
    order = (args.order.split(",") if args.order
             else [labels[0], labels[1], labels[1], labels[0]])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    turns = []
    for label in order:
        cmd = [sys.executable, __file__, "--child",
               str(Path(roots[label]).resolve())]
        for a in archs:
            cmd += ["--arch", a]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        turns.append((label, res))
        print(json.dumps({"turn": label, "result": res}), flush=True)
    summary = {}
    for label in labels:
        for arch in archs:
            rows = [r[arch] for lab, r in turns if lab == label]
            if rows:
                summary.setdefault(label, {})[arch] = {
                    k: statistics.median(row[k] for row in rows)
                    for k in ("prefill_ms", "prefill_device_busy_ms",
                              "decode_ms_per_token")}
    print(json.dumps({"card": smi, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
