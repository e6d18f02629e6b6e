"""Training entry point (counterpart of ``repro.launch.train``'s ``build`` /
``setup`` / ``train`` / ``main``, the legacy-flag path) at ring degree 1
with strategy ``tatp`` on one device::

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \\
        --reduced --device cpu --steps 3 --batch 4 --seq 64

``--arch mamba2-780m`` and ``--arch zamba2-2.7b`` train the same way; their
``--seq`` must be a multiple of ``ssm_chunk`` (8 reduced, 256 at full
width).  ``--arch olmoe-1b-7b`` (and the other MoE configs) adds the
routers' load-balance loss to the objective, as the reference does.
``gemma-7b``, ``gemma2-9b``, ``qwen2-72b``, ``internvl2-1b`` (its batch
carries the stub image prefix) and ``seamless-m4t-large-v2`` (its batch
carries the encoder's stub speech frames) train the same way.
It runs on the GPU unless ``--device cpu`` is given; with no GPU it raises.
Weights are random from ``--seed`` and the data is the reference's
synthetic LCG stream (:class:`repro_torch.train.data.SyntheticDataset`),
so both packages train on the same tokens.  As in the reference, reduced
configs train without remat and full ones with it.  The printed JSON has
the reference's summary keys.

Restart, as the reference's: with ``--ckpt-dir`` the run resumes from the
directory's ``LATEST`` checkpoint if there is one (parameters and
optimizer state, :mod:`repro_torch.train.checkpoint`), saves every
``--ckpt-every`` steps and at the end, and keeps the ``--keep`` newest;
``--fail-at-step N`` raises before step N on a run that started at step
0 (a simulated node failure)::

    python -m repro_torch.launch.train --reduced --device cpu --steps 8 \
        --ckpt-dir ck --ckpt-every 2 --fail-at-step 4   # fails
    python -m repro_torch.launch.train --reduced --device cpu --steps 8 \
        --ckpt-dir ck --ckpt-every 2                   # resumes at 4

Plan-driven launch (the solve → plan → execute pipeline), as the
reference's::

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \
        --reduced --device cpu --auto-plan --steps 3 --batch 4 --seq 64

``--auto-plan`` compiles a :class:`~repro_torch.core.plan.WaferPlan` for
the wafer (or loads it from the on-disk plan cache, ``--plan-cache``,
default ``results/plans``, shared with the reference: a second launch
logs ``[plan] cache hit (solver skipped)``); ``--plan PATH`` replays a
plan file; ``--failed-dies`` solves for a degraded wafer.  The plan's
``ParallelConfig`` applies (reduced runs without remat) and its mesh on
this one device is ``(1, 1)`` (:mod:`repro_torch.launch.mesh`), so the
plan's strategy (``tatp``, ``megatron`` or ``fsdp``) runs at degree 1.
``--wafers N`` compiles (or cache-loads) a
:class:`~repro_torch.core.plan.MultiWaferPlan` and runs stage
``--stage``: the config cut to the plan's layers for that stage under
the stage's own plan.  ``--failed-dies`` with ``--fail-wafer`` degrades
one wafer, whose stage alone re-solves.  The checkpoint manifest records
the plan hash (and the stage, ``pp`` and layer split, or the plan's
degrees), and a restart under a different plan warns in the reference's
words.  Any ``--mesh`` other than ``1 1`` is ROADMAP.md item A3.
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
from repro_torch.configs.base import ParallelConfig, ShapeConfig
from repro_torch.core.dist import Dist, resolve_device
from repro_torch.launch.mesh import make_plan_dist
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import SyntheticDataset
from repro_torch.train.train_loop import make_train_step


def build(cfg, dist: Dist, par: ParallelConfig, batch: int, seq: int):
    shape = ShapeConfig("cli", "train", seq, batch)
    return make_train_step(cfg, par, dist, shape), SyntheticDataset(
        cfg, shape, dist)


def setup(args):
    """cfg + Dist + ParallelConfig + plan (None for the legacy flags), from
    a plan or from the legacy flags, as the reference's ``setup``."""
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    plan = None
    if args.wafers > 1:
        # multi-wafer pipeline launch: this process runs ONE stage of the
        # pipeline (--stage); the MultiWaferPlan fixes the layer split and
        # every stage's plan
        from repro_torch.launch.planning import resolve_multiwafer_plan
        plan = resolve_multiwafer_plan(
            cfg, args.batch, args.seq, n_wafers=args.wafers,
            plan_path=args.plan, cache_dir=args.plan_cache,
            failed_dies=args.failed_dies, fail_wafer=args.fail_wafer,
            remat=not args.reduced)
        print(plan.summary())
        if not 0 <= args.stage < plan.pp:
            raise SystemExit(f"--stage {args.stage} out of range for "
                             f"pp={plan.pp}")
        stage_plan = plan.stages[args.stage]
        cfg = replace(cfg, n_layers=plan.stage_layers[args.stage])
        dist = make_plan_dist(stage_plan, args.device)
        par = stage_plan.parallel_config()
        if args.reduced and par.remat:
            par = replace(par, remat=False)
    elif args.plan or args.auto_plan:
        from repro_torch.launch.planning import resolve_plan
        plan = resolve_plan(cfg, args.batch, args.seq, plan_path=args.plan,
                            cache_dir=args.plan_cache,
                            failed_dies=args.failed_dies,
                            remat=not args.reduced)
        print(plan.summary())
        dist = make_plan_dist(plan, args.device)
        par = plan.parallel_config()
        if args.reduced and plan.remat:
            # reduced smoke runs never need remat, whatever the plan says
            par = replace(par, remat=False)
    else:
        if list(args.mesh) not in ([1, 1], [1]):
            raise not_ported(f"mesh {args.mesh}", "A3")
        dist = Dist(resolve_device(args.device))
        par = ParallelConfig(strategy=args.strategy, remat=not args.reduced)
    return cfg, dist, par, plan


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(args, history=None) -> dict:
    """Run the launch; the printed summary has the reference's keys.
    ``history``, if a list, gets one ``{"step", "loss", "grad_norm",
    "ms"}`` record a step (the CLI passes none)."""
    cfg, dist, par, plan = setup(args)
    bundle, data = build(cfg, dist, par, args.batch, args.seq)
    ckpt_meta = {}
    if plan is not None:
        ckpt_meta["plan_hash"] = plan.plan_hash
        if hasattr(plan, "stages"):  # MultiWaferPlan: record this rank's
            ckpt_meta["stage"] = args.stage  # stage so elastic restarts
            ckpt_meta["pp"] = plan.pp  # restore the right pipeline slice
            ckpt_meta["stage_layers"] = list(plan.stage_layers)
        else:
            ckpt_meta["plan_degrees"] = list(plan.degrees_tuple())
    gen = torch.Generator(device=dist.device).manual_seed(args.seed)
    params, opt_state = bundle.init_fn(gen)

    start_step = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        print(f"resuming from {args.ckpt_dir}")
        prev = ckpt.read_meta(args.ckpt_dir)
        if plan and prev.get("plan_hash") \
                and prev["plan_hash"] != plan.plan_hash:
            print(f"[plan] WARNING: checkpoint was trained under plan "
                  f"{prev['plan_hash']} but this launch runs plan "
                  f"{plan.plan_hash} (wafer degraded or re-solved); "
                  f"state restores elastically onto the new mesh")
        (params, opt_state), start_step = ckpt.restore(
            args.ckpt_dir, (params, opt_state))

    losses, times = [], []
    for step in range(start_step, args.steps):
        if args.fail_at_step is not None and step == args.fail_at_step \
                and start_step == 0:
            raise RuntimeError(f"simulated node failure at step {step}")
        batch = data.batch(step)
        _sync(dist.device)
        t0 = time.perf_counter()
        params, opt_state, metrics = bundle.step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        losses.append(loss)
        times.append(dt)
        if history is not None:
            history.append({"step": step, "loss": loss, "grad_norm": float(
                metrics["grad_norm"]), "ms": dt * 1e3})
        # straggler watchdog: flag steps >3x the running median
        if len(times) > 5 and dt > 3 * float(np.median(times)):
            print(f"[watchdog] straggler step {step}: {dt:.2f}s "
                  f"(median {np.median(times):.2f}s)")
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):8.3f} {dt*1e3:7.1f}ms",
                  flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, step + 1, (params, opt_state),
                      keep=args.keep, meta=ckpt_meta)
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps, (params, opt_state),
                  keep=args.keep, meta=ckpt_meta)
    return {"first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None,
            "steps": len(losses),
            "mean_step_s": float(np.mean(times)) if times else None,
            "plan_hash": plan.plan_hash if plan else None,
            "mesh": [1, 1]}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", type=int, nargs="+", default=[1, 1])
    ap.add_argument("--strategy", default="tatp")
    ap.add_argument("--plan", default=None,
                    help="launch from an explicit WaferPlan JSON file")
    ap.add_argument("--auto-plan", action="store_true",
                    help="solve (or load the cached) WaferPlan and take "
                         "the ParallelConfig from it")
    ap.add_argument("--plan-cache", default=None,
                    help="plan cache dir (default results/plans)")
    ap.add_argument("--failed-dies", default=None,
                    help="comma-separated die ids to mark dead before "
                         "planning (degraded-wafer launches)")
    ap.add_argument("--wafers", type=int, default=1,
                    help="pipeline over N wafers (compiles/loads a "
                         "MultiWaferPlan; this process runs --stage)")
    ap.add_argument("--stage", type=int, default=0,
                    help="pipeline stage this process executes "
                         "(multi-wafer launches)")
    ap.add_argument("--fail-wafer", type=int, default=0,
                    help="wafer index --failed-dies applies to "
                         "(multi-wafer launches)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="simulate a node failure before this step (only "
                         "on a run that starts at step 0)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only on request)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    print(json.dumps(train(args)))


if __name__ == "__main__":
    main()
