"""Serving driver, one-shot mode (counterpart of ``repro.launch.serve``'s
``serve`` / ``main``): prefill a batch of prompts, then greedily decode a
fixed number of tokens, at ring degree 1 with strategy ``tatp``::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \\
        --batch 4 --prompt-len 128 --gen 32

Architectures: every one the config registry lists (``--arch``); for the
SSM models (``mamba2-780m``, ``zamba2-2.7b``) ``--prompt-len`` must be a
multiple of ``ssm_chunk`` (256, or 8 with ``--reduced``).  ``internvl2-1b``
takes stub image embeddings for its first ``frontend_tokens`` (256)
positions, so its prompt should be longer than that; the encoder of
``seamless-m4t-large-v2`` reads stub speech frames (1024).  It runs on the
GPU unless ``--device cpu`` is given; with no GPU it raises.  Prompts and the
stub embeddings come from ``numpy.random.RandomState(0)`` as in the
reference, so both packages serve the same inputs; weights are random
(seed 0, as the reference's ``jax.random.key(0)``) unless the caller
passes ``params``.  The printed JSON has the reference's keys.
``--layers N`` serves the model cut to its first N layers, widths
unchanged, where the whole model does not fit one card.

Plan-driven launch, as the reference's one-shot path: ``--auto-plan``
compiles (or loads from ``--plan-cache``, default ``results/plans``,
shared with the reference) the :class:`~repro_torch.core.plan.WaferPlan`
for ``batch`` sequences of ``prompt-len + gen`` tokens, ``--plan PATH``
replays a plan file, and the one-shot serve runs under the plan's
``ParallelConfig`` with remat off, on the plan's one-device mesh
``(1, 1)`` (:mod:`repro_torch.launch.mesh`)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \
        --reduced --device cpu --auto-plan

The plan is solved for the whole model, before a ``--layers`` cut.
Engine mode (``--serve``, continuous batching over a ServePlan) is
ROADMAP.md item A1 and raises.
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import replace

import numpy as np
import torch

from repro_torch import not_ported
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import ParallelConfig
from repro_torch.core.dist import Dist, resolve_device
from repro_torch.launch.mesh import make_plan_dist
from repro_torch.models import lm
from repro_torch.models.transformer import init_params
from repro_torch.train.data import stub_inputs
from repro_torch.train.train_loop import make_serve_fns


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prompt_batch(cfg, batch: int, prompt_len: int, seed: int = 0) -> dict:
    """The prefill batch as the reference's serve draws it from
    ``RandomState(seed)`` (0 there): the prompts, then the stub frontend
    inputs the config takes (:func:`stub_inputs`; numpy, the embeddings
    fp32)."""
    rng = np.random.RandomState(seed)
    out = {"tokens": rng.randint(0, cfg.vocab_size, (batch, prompt_len))}
    out.update(stub_inputs(cfg, batch, lambda name: rng))
    return out


def serve(args, params=None, keep_tokens: bool = False) -> dict:
    """One-shot serve.  ``params``: a parameter tree for ``args``' config
    on ``args.device`` (default: random weights from seed 0).  With
    ``keep_tokens`` the result also holds every generated token
    (``tokens``, [batch, gen + 1]); the CLI prints the reference's keys."""
    if getattr(args, "serve", False):
        raise not_ported("engine-mode serving (--serve)", "A1")
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    max_seq = args.prompt_len + args.gen
    if getattr(args, "plan", None) or getattr(args, "auto_plan", False):
        from repro_torch.launch.planning import resolve_plan
        plan = resolve_plan(cfg, args.batch, max_seq,
                            plan_path=getattr(args, "plan", None),
                            cache_dir=getattr(args, "plan_cache", None),
                            remat=False)
        print(plan.summary())
        dist = make_plan_dist(plan, args.device)
        par = replace(plan.parallel_config(), remat=False)
    else:
        dist = Dist(resolve_device(args.device))
        par = ParallelConfig(strategy="tatp", remat=False)
    device = dist.device
    if getattr(args, "layers", None):  # a cut in depth only
        cfg = replace(cfg, n_layers=args.layers)
    sb = make_serve_fns(cfg, par, dist)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = init_params(cfg, gen, device)

    batch = {name: torch.as_tensor(arr, device=device)
             for name, arr in prompt_batch(cfg, args.batch,
                                           args.prompt_len).items()}

    # prefill produces prompt-length caches; graft them into the max_seq
    # decode layout (every slot at once)
    caches, logits = sb.prefill_fn(params, batch)
    big = lm.init_cache(sb.ctx, args.batch, max_seq)
    caches = lm.graft_cache_slots(big, caches, slots=range(args.batch))

    # the first token: argmax over the padded vocab, padded columns
    # included, folded back into range — as the reference does
    toks = logits[:, -1:, :].argmax(dim=-1) % cfg.vocab_size
    out_tokens = [toks.cpu()]
    _sync(device)
    t0 = time.perf_counter()
    for i in range(args.gen):
        cache_len = torch.full((args.batch,), args.prompt_len + i + 1,
                               dtype=torch.int64, device=device)
        toks, logits, caches = sb.decode_fn(params, toks, caches, cache_len)
        out_tokens.append(toks.cpu())
    dt = time.perf_counter() - t0
    gen = torch.cat(out_tokens, dim=1).numpy()
    out = {
        "generated_shape": list(gen.shape),
        "tokens_per_s": args.batch * args.gen / dt,
        "ms_per_token": dt / args.gen * 1e3,
        "sample": gen[0][:8].tolist(),
    }
    if keep_tokens:
        out["tokens"] = gen.tolist()
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--layers", type=int, default=None,
                    help="serve only the first N layers (a cut in depth, "
                         "widths unchanged: e.g. qwen2-72b's 80 layers "
                         "of bf16 weights, ~145 GB, do not fit one card)")
    ap.add_argument("--plan", default=None,
                    help="launch from an explicit WaferPlan JSON file")
    ap.add_argument("--auto-plan", action="store_true",
                    help="solve (or load the cached) WaferPlan and take "
                         "the ParallelConfig from it")
    ap.add_argument("--plan-cache", default=None,
                    help="plan cache dir (default results/plans)")
    ap.add_argument("--serve", action="store_true",
                    help="continuous-batching engine mode (ROADMAP.md A1: "
                         "not ported, raises)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only on request)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    print(json.dumps(serve(args)))


if __name__ == "__main__":
    main()
