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

Engine mode (``--serve``, the counterpart of the reference's
``serve_engine``): compile (or load) a
:class:`~repro_torch.core.plan.ServePlan` and run the continuous-batching
engine (:mod:`repro_torch.serve.engine`) over a synthetic open-loop
request stream, on the card through :class:`TorchServeExecutor` and a
wall clock::

    python -m repro_torch.launch.serve --arch deepseek-7b --serve \
        --auto-plan --requests 12 --rate 4 --max-batch 4 \
        --prompt-len 128 --max-new 32

``--sim`` swaps in the cost-model executor on a virtual clock (no
tensors, no device).  ``--fault-at``/``--fault-frac``/``--readmission``,
``--fault-trace``, ``--governor`` and its knobs, and
``--prefill-chunk-tokens`` are the reference's, with its defaults.  The
printed JSON has the reference's keys; ``"mode"`` is ``"sim"`` or
``"torch"`` (the reference prints ``"jax"``).
"""

from __future__ import annotations

import argparse
import json
import math
import time
from dataclasses import replace

import numpy as np
import torch

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


# ---------------------------------------------------------------------------
# engine mode: the real-model executor for the continuous-batching engine
# ---------------------------------------------------------------------------


class TorchServeExecutor:
    """ServeEngine executor running the model off a ServePlan on one
    device (counterpart of the reference's ``JaxServeExecutor``).

    Slot-structured as the reference's: the decode step always runs the
    plan's full ``max_batch`` rows (an idle slot carries token 0 at
    ``cache_len`` 1 and is ignored); admission prefills the new prompts,
    grouped by length and each group padded to ``max_batch`` rows of
    token 0, and grafts their prompt-window caches into the resident
    max-seq cache at their slots (:func:`repro_torch.models.lm.
    graft_cache_slots`, an in-place copy on the device).  The padding is
    the reference's exactly: olmoe's expert capacity couples a batch's
    rows, so only identical padding gives identical tokens.

    Prompts come from ``RandomState(1000 + rid)`` and the stub frontend
    inputs from one ``RandomState(0)`` that lives as long as the
    executor, drawn in the reference's order.  ``params`` default to the
    one-shot path's random weights (seed 0); ``hooks`` go to
    :func:`make_serve_fns` (``dot``, ``attention``, ``ssd``: the plain
    versions, for parity checks).  ``prefill``, ``decode`` and
    ``migrate`` return None, so a wall clock's elapsed time stands; each
    reads its tokens back to the host, so it returns with the device
    synchronised."""

    def __init__(self, plan, cfg, *, device="cuda", params=None, **hooks):
        from repro_torch.models.transformer import init_params

        self.cfg = cfg
        self.hooks = hooks
        self._build(plan, device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = init_params(cfg, gen, self.device)
        self.params = params
        self.caches = self._fresh_cache()
        self.last_tok = np.zeros(plan.max_batch, np.int64)
        self._rng = np.random.RandomState(0)

    def _build(self, plan, device):
        """The serve bundle for ``plan``: its ParallelConfig with remat
        off, on its one-device mesh."""
        self.plan = plan
        dist = make_plan_dist(plan, device)
        self.device = dist.device
        par = replace(plan.parallel_config(), remat=False)
        self.sb = make_serve_fns(self.cfg, par, dist, **self.hooks)

    def _fresh_cache(self):
        return lm.init_cache(self.sb.ctx, self.plan.max_batch,
                             self.plan.max_seq,
                             enc_len=self.cfg.frontend_tokens or None)

    def _prompt(self, req):
        rng = np.random.RandomState(1000 + req.rid)
        return rng.randint(0, self.cfg.vocab_size, (req.prompt_len,))

    def prefill(self, states):
        # prefill_fn returns only the final position's logits, so one call
        # cannot serve mixed prompt lengths: group by length
        by_len: dict = {}
        for st in states:
            by_len.setdefault(st.req.prompt_len, []).append(st)
        for group in by_len.values():
            self._prefill_group(group)
        return None  # wall clock: real elapsed time stands

    def _prefill_group(self, states):
        cfg, plan = self.cfg, self.plan
        plen = states[0].req.prompt_len
        toks = np.zeros((plan.max_batch, plen), np.int64)
        for i, st in enumerate(states):
            toks[i] = self._prompt(st.req)
        batch = {"tokens": toks}
        batch.update(stub_inputs(cfg, plan.max_batch, lambda _: self._rng))
        batch = {name: torch.as_tensor(arr, device=self.device)
                 for name, arr in batch.items()}
        small, logits = self.sb.prefill_fn(self.params, batch)
        lm.graft_cache_slots(self.caches, small, [st.slot for st in states],
                             rows=range(len(states)))
        # argmax over the padded vocab, folded back into range, as the
        # reference takes the first token
        first = (logits[:, -1, :].argmax(dim=-1) % cfg.vocab_size).cpu() \
            .numpy()
        for i, st in enumerate(states):
            st.tokens.append(int(first[i]))
            self.last_tok[st.slot] = first[i]

    def decode(self, states):
        toks = np.zeros((self.plan.max_batch, 1), np.int64)
        clen = np.ones(self.plan.max_batch, np.int64)
        for st in states:
            toks[st.slot, 0] = self.last_tok[st.slot]
            clen[st.slot] = st.context_len  # prompt + generated so far
        nxt, _, self.caches = self.sb.decode_fn(
            self.params, torch.as_tensor(toks, device=self.device),
            self.caches, torch.as_tensor(clen, device=self.device))
        nxt = nxt[:, 0].cpu().numpy()
        for st in states:
            st.tokens.append(int(nxt[st.slot]))
            self.last_tok[st.slot] = nxt[st.slot]
        return None

    def migrate(self, new_plan, mig, wafer=None):
        """Adopt a post-fault plan: rebuild the serve bundle for the new
        contract and graft the survivors' cache rows from the old cache
        into their new slots of a fresh one (``graft_cache_slots`` with
        an old-slot -> new-slot remap), then remap ``last_tok``.

        The parameters are kept: the reference rebuilds them from the
        same ``jax.random.key(0)``, and ``init_params`` does not read the
        parallel config, so the values would be the same; rebuilding
        them would cost time and a second copy on the device.  On one
        device a degraded plan's mesh is still ``(1, 1)``
        (:func:`make_plan_dist` raises otherwise).  Returns None: the
        rebuild and graft take real time."""
        old_caches, old_last = self.caches, self.last_tok
        self._build(new_plan, self.device)
        self.caches = self._fresh_cache()
        if mig.survivors:
            lm.graft_cache_slots(
                self.caches, old_caches,
                [new_slot for _, _, new_slot in mig.survivors],
                rows=[old_slot for _, old_slot, _ in mig.survivors])
        self.last_tok = np.zeros(new_plan.max_batch, np.int64)
        for _, old_slot, new_slot in mig.survivors:
            self.last_tok[new_slot] = old_last[old_slot]
        _sync(self.device)
        return None


def serve_engine(args, params=None, executor=None) -> dict:
    """Engine mode: solve -> ServePlan -> continuous-batching run (the
    reference's ``serve_engine``).  ``params`` go to
    :class:`TorchServeExecutor`; ``executor``, if given, wraps it
    (``executor(ex) -> executor``, e.g. to count or time its calls)."""
    from repro_torch.launch.planning import resolve_serve_plan
    from repro_torch.serve.engine import (CostModelExecutor, ServeEngine,
                                          VirtualClock, WallClock,
                                          poisson_arrivals)
    from repro_torch.wafer.topology import Wafer, WaferSpec

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    plan = resolve_serve_plan(cfg, args.max_batch,
                              args.prompt_len + args.max_new,
                              plan_path=args.plan,
                              cache_dir=args.plan_cache,
                              failed_dies=args.failed_dies,
                              allow_ep=not args.no_ep)
    print(plan.summary())
    reqs = poisson_arrivals(
        args.requests, args.rate, seed=args.seed,
        prompt_len=args.prompt_len, max_new_tokens=args.max_new,
        slo_ttft=args.slo_ttft or math.inf,
        slo_tpot=args.slo_tpot or math.inf)
    wafer = Wafer(WaferSpec(rows=plan.plan.wafer_rows,
                            cols=plan.plan.wafer_cols),
                  frozenset(plan.plan.failed_dies))
    faults = ()
    if args.fault_trace is not None:
        from repro_torch.wafer.fault import parse_fault_trace
        trace = parse_fault_trace(args.fault_trace, wafer)
        faults = trace.events
        print(f"fault trace '{args.fault_trace}': {len(faults)} event(s), "
              f"kind={trace.kind}")
    elif args.fault_at is not None:
        from repro_torch.wafer.fault import sample_die_faults
        rep_f = sample_die_faults(wafer, args.fault_frac, seed=args.seed)
        faults = (rep_f.as_event(args.fault_at),)
        print(f"fault scheduled at t={args.fault_at}s: "
              f"dies {rep_f.failed_dies}")
    governor = None
    if args.governor:
        from repro_torch.serve.governor import GovernorConfig
        governor = GovernorConfig(
            coalesce_s=args.coalesce_s, hysteresis=args.hysteresis,
            backoff_base_s=args.backoff_base,
            backoff_max_s=args.backoff_max,
            replan_budget=args.replan_budget,
            window_s=args.governor_window)
    if args.sim:
        ex = CostModelExecutor(plan, cfg, wafer)
        clock = VirtualClock()
    else:
        run_cfg = replace(cfg, n_layers=args.layers) \
            if getattr(args, "layers", None) else cfg
        ex = TorchServeExecutor(plan, run_cfg, device=args.device,
                                params=params)
        clock = WallClock()
    if executor is not None:
        ex = executor(ex)
    engine = ServeEngine(plan, ex, clock=clock, cfg=cfg, wafer=wafer,
                         faults=faults, readmission=args.readmission,
                         governor=governor,
                         prefill_chunk_tokens=args.prefill_chunk_tokens,
                         plan_cache_dir=args.plan_cache)
    rep = engine.run(reqs)
    out = rep.to_dict()
    out["plan_hash"] = plan.plan_hash
    out["mode"] = "sim" if args.sim else "torch"
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
    ap.add_argument("--failed-dies", default=None,
                    help="comma-separated dead dies (degraded launch)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only on request)")
    # engine mode
    ap.add_argument("--serve", action="store_true",
                    help="continuous-batching engine mode (needs "
                         "--auto-plan or a ServePlan --plan)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--rate", type=float, default=4.0,
                    help="open-loop arrival rate (req/s)")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="decode slots (max in-flight sequences)")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slo-ttft", type=float, default=None)
    ap.add_argument("--slo-tpot", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-ep", action="store_true",
                    help="pin the decode solve to ep=1 (disable "
                         "expert parallelism; A/B against the EP plan)")
    ap.add_argument("--sim", action="store_true",
                    help="cost-model executor (no tensors; virtual clock)")
    # elastic serving: mid-run fault injection
    ap.add_argument("--fault-at", type=float, default=None,
                    help="inject a die-kill fault at this engine time (s): "
                         "live replan + KV migration")
    ap.add_argument("--fault-frac", type=float, default=0.125,
                    help="fraction of alive dies the fault kills "
                         "(exact, seeded)")
    ap.add_argument("--readmission", choices=("live", "drain"),
                    default="live",
                    help="evicted-sequence policy after a migration")
    # fault/repair timelines + replan governor
    ap.add_argument("--fault-trace", default=None,
                    help="fault/repair timeline: 'flap:SEED' (seeded "
                         "flapping link), 'cascade:SEED' (correlated die "
                         "cascade), or a FaultTrace JSON file "
                         "(schema-validated at load); takes precedence "
                         "over --fault-at")
    ap.add_argument("--governor", action="store_true",
                    help="route fault events through the replan governor "
                         "(debounce + hysteresis + backoff) instead of "
                         "one replan per event")
    ap.add_argument("--coalesce-s", type=float, default=0.25,
                    help="governor debounce window (s)")
    ap.add_argument("--hysteresis", type=float, default=0.05,
                    help="min predicted capacity delta to justify an "
                         "elective replan")
    ap.add_argument("--backoff-base", type=float, default=1.0,
                    help="first replan cool-down (s); doubles per "
                         "consecutive replan")
    ap.add_argument("--backoff-max", type=float, default=60.0,
                    help="cool-down ceiling (s)")
    ap.add_argument("--replan-budget", type=int, default=3,
                    help="max elective replans per governor window")
    ap.add_argument("--governor-window", type=float, default=60.0,
                    help="replan-budget accounting window (s)")
    ap.add_argument("--prefill-chunk-tokens", type=int, default=None,
                    help="chunked prefill with fault-clock checks at "
                         "chunk boundaries (intra-step preemption); "
                         "default: single-pass prefill (the real "
                         "executor has no chunked prefill, as the "
                         "reference's has none)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.serve:
        print(json.dumps(serve_engine(args)))
    else:
        print(json.dumps(serve(args)))


if __name__ == "__main__":
    main()
