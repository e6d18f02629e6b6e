#!/usr/bin/env python3
"""Time the flash attention forward kernel of one or more checkouts of this
repository on one NVIDIA GPU, in turns, so that every checkout sees the
same card and host.

    python3 scripts/compare_forward.py --root parent=PATH --root change=PATH \
        [--order parent,change,change,parent]

Each turn is one child process that puts ``<root>/src`` first on the path,
builds that checkout's kernels and times ``attention`` (bf16, ``mma``, at
query offset 0: the call every checkout takes) at the forward rows of
``PERF.md`` section 6, with the shapes, inputs and device timing of the
``chip_smoke.py`` beside this script (:func:`forward_rows`,
``chip_smoke.py:time_ms``, ``make_randn`` with seed 0, ``cap_scale``).
One JSON line per turn, then the medians by checkout.  It needs one card
and imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def forward_rows(smoke, get_config):
    """``{name: (B, Hq, Hkv, Sq, Skv, D, causal, window, cap)}``: chip_smoke's
    deepseek-7b main-path flash and zamba2-2.7b's (phase 3), and its rows
    at the new architectures' shapes (``FLASH_ARCH_ROWS``)."""
    m = smoke.MAIN
    b, h, s, d = smoke.ZAMBA_ATTN
    rows = {
        "deepseek-7b causal": (m["batch"], smoke.HEADS, smoke.HEADS,
                               m["prompt_len"], m["prompt_len"],
                               smoke.HEAD_DIM, True, None, None),
        "zamba2-2.7b causal": (b, h, h, s, s, d, True, None, None)}
    for arch, part, kind in smoke.FLASH_ARCH_ROWS:
        cfg, spec = get_config(arch), smoke.PATHS[arch]
        hq, hkv, d, sq, skv, causal, window, cap = smoke.attention_shape(
            cfg, part, kind, spec["prompt_len"], cfg.frontend_tokens)
        rows[f"{arch} {part} {kind}"] = (spec.get("batch", smoke.BATCH), hq,
                                         hkv, sq, skv, d, causal, window, cap)
    return rows


def child(root: Path) -> dict:
    sys.path.insert(0, str(HERE))
    import chip_smoke as smoke

    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ops import attention

    if not torch.cuda.is_available():
        raise SystemExit("compare_forward: no CUDA device is available")
    _build.build_all()
    randn = smoke.make_randn(torch, 0)
    out = {}
    for name, (b, hq, hkv, sq, skv, d, causal, window, cap) in \
            forward_rows(smoke, get_config).items():
        bf = torch.bfloat16
        q = randn(b, sq, hq, d, dtype=bf,
                  scale=smoke.cap_scale(cap)).transpose(1, 2)
        k, v = (randn(b, skv, hkv, d, dtype=bf).transpose(1, 2)
                for _ in range(2))
        kw = dict(causal=causal, window=window, cap=cap)
        before = attention.launches_by_path["mma"]
        attention(q, k, v, **kw)
        torch.cuda.synchronize()
        if attention.launches_by_path["mma"] != before + 1:
            raise SystemExit(f"compare_forward: {name} did not take mma")
        out[f"{name} {[b, hq, sq, d]}"] = smoke.time_ms(
            torch, lambda: attention(q, k, v, **kw))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", default=[],
                    help="LABEL=PATH of a checkout (one or more)")
    ap.add_argument("--order", default=None,
                    help="comma-separated labels, one turn each (default: "
                         "A,B,B,A for two roots, else each root once)")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(Path(args.child))))
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
        proc = subprocess.run([sys.executable, __file__, "--child",
                               str(Path(roots[label]).resolve())],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        turns.append((label, res))
        print(json.dumps({"turn": label, "ms": res}), flush=True)
    summary = {label: {name: statistics.median(r[name] for lab, r in turns
                                               if lab == label)
                       for name in turns[0][1]}
               for label in labels if any(lab == label for lab, _ in turns)}
    print(json.dumps({"median_ms": summary, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
