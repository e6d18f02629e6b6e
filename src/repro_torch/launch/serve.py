"""Serving driver, one-shot mode (counterpart of ``repro.launch.serve``'s
``serve`` / ``main``): prefill a batch of prompts, then greedily decode a
fixed number of tokens, at ring degree 1 with strategy ``tatp``::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \\
        --batch 4 --prompt-len 128 --gen 32

Architectures: every one the config registry lists (``--arch``); for the
SSM models (``mamba2-780m``, ``zamba2-2.7b``) ``--prompt-len`` must be a
multiple of ``ssm_chunk`` (256, or 8 with ``--reduced``) times the ring
degree (the ``--mesh`` model degree; 1 on one device).  ``internvl2-1b``
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

Over several ranks (``torch.distributed.run``; the ranks come from its
``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``) the one-shot serve runs the
TATP ring: the plan's mesh for the world (``--auto-plan``: deepseek-7b's
``(1, 4)`` on four ranks) or ``--mesh D M``, over ``--dist-backend``
``gloo`` (default: host-staged, so ranks may share a card) or ``nccl``
(one card a rank).  Each rank builds only its shard of the weights and
serves its sequence block of the prompts; rank 0 prints the JSON::

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.serve --arch deepseek-7b --auto-plan \
        --batch 4 --prompt-len 128 --gen 32

The prompt length must be a multiple of the ring degree.  MoE models
serve on the ring too (``--arch olmoe-1b-7b --mesh 1 4``: each rank holds
its experts, the slots reach them by all-to-all).  A plan that prescribes
``megatron`` or ``fsdp`` above model degree 1 raises before the mesh is
built: the reference cannot decode under either (ROADMAP.md C5).

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
tensors, no device; on one rank only).  ``--fault-at``/``--fault-frac``/
``--readmission``, ``--fault-trace``, ``--governor`` and its knobs, and
``--prefill-chunk-tokens`` are the reference's, with its defaults.  The
printed JSON has the reference's keys; ``"mode"`` is ``"sim"`` or
``"torch"`` (the reference prints ``"jax"``).

Engine mode over several ranks runs on the ServePlan's mesh for the
world (deepseek-7b's ``(1, 4)`` on four ranks; the reduced configs'
``(4, 1)``)::

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.serve --arch deepseek-7b --serve \
        --auto-plan --requests 12 --rate 1 --max-batch 4 \
        --prompt-len 128 --max-new 8

Rank 0 runs the engine, its clock, the fault timeline and the replans,
and broadcasts each executor call before it makes it; the other ranks
make the same calls on their shards (:class:`LeaderExecutor`,
:func:`follow`) and rank 0 prints the report.  Each rank holds its rows
(over ``data``), its block of positions and its Mamba-2 heads (over the
ring) of the cache.  A fault that keeps the mesh grafts the survivors in
place; one that changes it ((1, 4) <-> (2, 2)) gathers the survivors'
rows and re-cuts the weights leaf by leaf for the new mesh.  The plan's
``max_batch`` must split over its data degree and its ``max_seq`` and
the prompts over its ring, all of it checked before the mesh is built.
gemma2-9b's windowed layers serve on the ring (ring attention masks global
positions).
"""

from __future__ import annotations

import argparse
import datetime
import json
import math
import pickle
import time
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import torch

import torch.distributed as tdist

from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import ParallelConfig
from repro_torch.core.dist import (GROUP_TIMEOUT_S, Dist, make_mesh_dist,
                                   world_from_env)
from repro_torch.launch.mesh import (first_resolves, join_world,
                                     make_plan_dist, plan_device_permutation,
                                     plan_mesh_shape, resolve_rank_plan)
from repro_torch.models import lm
from repro_torch.models.transformer import (check_strategy, init_params,
                                            param_specs)
from repro_torch.train.checkpoint import _global_leaf
from repro_torch.train.data import stub_inputs
from repro_torch.train.train_loop import (batch_rows, check_prompt_len,
                                          make_serve_fns)
from repro_torch.weights import _shard, init_sharded_params


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


def serve(args, params=None, keep_tokens: bool = False,
          stats=None) -> dict:
    """One-shot serve.  ``params``: a parameter tree (this rank's shard)
    for ``args``' config on ``args.device`` (default: random weights from
    seed 0, drawn shard by shard above degree 1).  With ``keep_tokens``
    the result also holds every generated token (``tokens``, [batch, gen +
    1]); the CLI prints the reference's keys.  ``stats``, a dict, gets the
    run's ``dist``, the prefill's host ``prefill_ms`` (to the logits on
    the host), its global ``prefill_logits`` and the host-staged
    transport's seconds, bytes sent and calls up to then
    (``prefill_transport_s``, ``_bytes``, ``_calls``)."""
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    max_seq = args.prompt_len + args.gen
    device = join_world(args)
    if getattr(args, "plan", None) or getattr(args, "auto_plan", False):
        plan = resolve_rank_plan(cfg, args, max_seq, remat=False)
        if world_from_env()[0] == 0:
            print(plan.summary())
        par = replace(plan.parallel_config(), remat=False)
        # the one-shot serve decodes: what the reference cannot run there
        # raises before the mesh is built
        check_strategy(cfg, par.strategy, plan_mesh_shape(
            plan, world_from_env()[1])[1], "decode")
        dist = make_plan_dist(plan, device)
    else:
        par = ParallelConfig(strategy="tatp", remat=False)
        dist = make_mesh_dist(getattr(args, "mesh", None) or (1, 1), device)
    if getattr(args, "layers", None):  # a cut in depth only
        cfg = replace(cfg, n_layers=args.layers)
    check_prompt_len(dist, args.prompt_len, cfg)
    sb = make_serve_fns(cfg, par, dist)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = init_params(cfg, gen, device) if dist.n_devices == 1 \
            else init_sharded_params(cfg, gen, dist, par.strategy)

    batch = {name: torch.as_tensor(arr, device=device)
             for name, arr in prompt_batch(cfg, args.batch,
                                           args.prompt_len).items()}

    # prefill produces prompt-length caches (above degree 1 moved to the
    # ranks owning those positions of the max_seq cache); graft them into
    # the max_seq decode layout (every slot at once)
    t0 = time.perf_counter()
    caches, logits = sb.prefill_fn(params, batch)
    # the first token: argmax over the padded vocab, padded columns
    # included, folded back into range — as the reference does
    toks = logits[:, -1:, :].argmax(dim=-1) % cfg.vocab_size
    out_tokens = [toks.cpu()]
    if stats is not None:
        stage = dist.stage
        stats.update(dist=dist, prefill_logits=logits,
                     prefill_ms=(time.perf_counter() - t0) * 1e3,
                     prefill_transport_s=stage.seconds if stage else 0.0,
                     prefill_transport_bytes=stage.bytes if stage else 0,
                     prefill_transport_calls=stage.calls if stage else 0)
    caches = lm.shard_prompt_cache(sb.ctx, caches, max_seq)
    rows = len(range(args.batch)[batch_rows(dist, args.batch)])
    big = lm.init_cache(sb.ctx, rows, max_seq)
    caches = lm.graft_cache_slots(big, caches, slots=range(rows))
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
    """ServeEngine executor running the model off a ServePlan
    (counterpart of the reference's ``JaxServeExecutor``), on one device
    or on the plan's ``(data, model)`` mesh over the world's ranks
    (:func:`make_plan_dist`; every rank builds one, in the same order).

    Slot-structured as the reference's: the decode step always runs the
    plan's full ``max_batch`` rows (an idle slot carries token 0 at
    ``cache_len`` 1 and is ignored); admission prefills the new prompts,
    grouped by length and each group padded to ``max_batch`` rows of
    token 0, and grafts their prompt-window caches into the resident
    max-seq cache at their slots (:func:`repro_torch.models.lm.
    graft_cache_slots`, an in-place copy on the device).  At data degree
    1 the prompts take rows 0, 1, ... as in the reference exactly
    (olmoe's expert capacity couples a batch's rows, so only identical
    padding gives identical tokens); above it each prompt takes the row
    of its own slot, so every graft stays on the data rank that owns the
    slot (slot // (max_batch / data degree)).  Each rank holds its rows,
    its block of positions and its Mamba-2 heads of the cache
    (:func:`lm.init_cache`, :func:`lm.cache_specs`) and its shard of the
    weights.

    Prompts come from ``RandomState(1000 + req.rid)`` and the stub
    frontend inputs from one ``RandomState(0)`` that lives as long as the
    executor, drawn in the reference's order, so every rank builds the
    same batch.  ``params`` (this rank's shard) default to the one-shot
    path's random weights (seed 0, drawn shard by shard above degree 1);
    ``hooks`` go to :func:`make_serve_fns` (``dot``, ``attention``,
    ``ssd``: the plain versions, for parity checks).  ``prefill``,
    ``decode`` and ``migrate`` return None, so a wall clock's elapsed time
    stands; each reads its tokens back to the host, so it returns with
    the device synchronised.  Over several ranks every rank makes the
    same calls in the same order (:class:`LeaderExecutor`,
    :func:`follow`)."""

    def __init__(self, plan, cfg, *, device="cuda", params=None, **hooks):
        self.cfg = cfg
        self.hooks = hooks
        self._build(plan, device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = init_params(cfg, gen, self.device) \
                if self.dist.n_devices == 1 \
                else init_sharded_params(cfg, gen, self.dist,
                                         self.par.strategy)
        self.params = params
        self.caches = self._fresh_cache()
        self.last_tok = np.zeros(plan.max_batch, np.int64)
        self._rng = np.random.RandomState(0)
        self.last_migration: dict = {}
        self.link = None  # engine mode over several ranks: its CommandLink

    def _build(self, plan, device):
        """The serve bundle for ``plan``: its ParallelConfig with remat
        off, on its mesh over the world (checked first)."""
        check_serve_plan(plan, self.cfg, _world())
        self.plan = plan
        self.par = replace(plan.parallel_config(), remat=False)
        self.dist = make_plan_dist(plan, device)
        self.device = self.dist.device
        self.sb = make_serve_fns(self.cfg, self.par, self.dist, **self.hooks)

    def _rows(self, plan=None) -> range:
        """This rank's global slots of ``plan``'s (default the current
        one's) ``max_batch``."""
        n = (plan or self.plan).max_batch
        return range(n)[batch_rows(self.dist, n)]

    def _fresh_cache(self):
        return lm.init_cache(self.sb.ctx, len(self._rows()),
                             self.plan.max_seq,
                             enc_len=self.cfg.frontend_tokens or None)

    def _prompt(self, req):
        rng = np.random.RandomState(1000 + req.rid)
        return rng.randint(0, self.cfg.vocab_size, (req.prompt_len,))

    def prefill(self, states):
        # a prompt the ring cannot split raises on every rank alike, before
        # any collective
        for n in sorted({st.req.prompt_len for st in states}):
            check_prompt_len(self.dist, n, self.cfg)
        # prefill_fn returns only the final position's logits, so one call
        # cannot serve mixed prompt lengths: group by length
        by_len: dict = {}
        for st in states:
            by_len.setdefault(st.req.prompt_len, []).append(st)
        for group in by_len.values():
            self._prefill_group(group)
        return None  # wall clock: real elapsed time stands

    def _prefill_group(self, states):
        cfg, n = self.cfg, self.plan.max_batch
        plen = states[0].req.prompt_len
        rows = [st.slot for st in states] if self.dist.batch_degree > 1 \
            else list(range(len(states)))
        # draw i of the stub inputs goes to row perm[i]: the prompts' rows,
        # then the others in order (the identity at data degree 1)
        perm = rows + [r for r in range(n) if r not in rows]
        toks = np.zeros((n, plen), np.int64)
        for row, st in zip(rows, states):
            toks[row] = self._prompt(st.req)
        batch = {"tokens": toks}
        for name, arr in stub_inputs(cfg, n, lambda _: self._rng).items():
            batch[name] = np.empty_like(arr)
            batch[name][perm] = arr
        batch = {name: torch.as_tensor(arr, device=self.device)
                 for name, arr in batch.items()}
        small, logits = self.sb.prefill_fn(self.params, batch)
        small = lm.shard_prompt_cache(self.sb.ctx, small, self.plan.max_seq)
        mine = self._rows()
        pairs = [(row - mine.start, st.slot - mine.start)
                 for row, st in zip(rows, states) if st.slot in mine]
        lm.graft_cache_slots(self.caches, small, [s for _, s in pairs],
                             rows=[r for r, _ in pairs])
        # argmax over the padded vocab, folded back into range, as the
        # reference takes the first token
        first = (logits[:, -1, :].argmax(dim=-1) % cfg.vocab_size).cpu() \
            .numpy()
        for row, st in zip(rows, states):
            st.tokens.append(int(first[row]))
            self.last_tok[st.slot] = first[row]

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

    def global_cache(self, slots=None) -> dict:
        """The cache's global rows ``slots`` (default every slot), each
        leaf gathered over the mesh (:func:`lm.cache_specs`); a collective
        every rank calls alike."""
        slots = list(range(self.plan.max_batch)) if slots is None \
            else list(slots)
        specs = lm.cache_specs(self.sb.ctx, self.plan.max_batch)
        return _map_leaves(
            lambda leaf, spec: _global_leaf(leaf, spec, self.dist)[0][
                :, slots], self.caches, specs)

    def migrate(self, new_plan, mig, wafer=None):
        """Adopt a post-fault plan: rebuild the serve bundle for the new
        contract and move the survivors' cache rows from their old slots
        to their new ones in a fresh cache, then remap ``last_tok``.

        Where the new plan keeps the mesh (its shape and device order)
        the weights stay and every rank grafts the survivors' rows on its
        own block, if each survivor's new slot is on the data rank of its
        old one.  Otherwise the survivors' global rows are gathered over
        the old mesh (:meth:`global_cache`), the new mesh is built and
        each rank cuts its rows, positions and heads from them; the
        weights are re-cut leaf by leaf (:func:`_recut_params`: one
        leaf's global array at a time).  The reference rebuilds the
        weights from the same ``jax.random.key(0)``, and ``init_params``
        does not read the parallel config, so the values are the same
        either way.  On one device every plan's mesh is ``(1, 1)``.
        ``last_migration`` gets the path taken (``"graft"`` or
        ``"reshard"``), its seconds and the cache and weight bytes this
        rank contributed to the gathers.  Returns None: the rebuild and
        the moves take real time."""
        t0 = time.perf_counter()
        old_caches, old_last = self.caches, self.last_tok
        old_dist, old_par, old_plan = self.dist, self.par, self.plan
        moves = [(old, new) for _, old, new in mig.survivors]
        world = _world()
        kept = (plan_mesh_shape(new_plan, world)
                == plan_mesh_shape(old_plan, world)
                and plan_device_permutation(new_plan, world)
                == plan_device_permutation(old_plan, world))
        local = kept and all(
            _owner(old, old_plan.max_batch, old_dist)
            == _owner(new, new_plan.max_batch, old_dist)
            for old, new in moves)
        surv, moved = None, 0
        if moves and not local:
            surv = self.global_cache([old for old, _ in moves])
            moved += _tree_bytes(old_caches)
            old_caches = None
        self._build(new_plan, self.device)
        self.caches = self._fresh_cache()
        if moves and local:
            was, now = self._rows(old_plan), self._rows()
            pairs = [(old - was.start, new - now.start) for old, new in moves
                     if new in now]
            lm.graft_cache_slots(self.caches, old_caches,
                                 [n for _, n in pairs],
                                 rows=[o for o, _ in pairs])
        elif moves:
            specs = lm.cache_specs(self.sb.ctx, new_plan.max_batch)
            now = self._rows()
            pairs = [(j, new - now.start) for j, (_, new) in enumerate(moves)
                     if new in now]
            _place_rows(self.caches, surv, specs, self.dist, pairs)
        # the shards differ with the mesh, or with the strategy above
        # model degree 1
        recut = not kept or (self.dist.model_degree > 1
                             and old_par.strategy != self.par.strategy)
        if recut:
            moved += _tree_bytes(self.params)
            self.params = _recut_params(self.cfg, self.params, old_dist,
                                        old_par.strategy, self.dist,
                                        self.par.strategy)
        self.last_tok = np.zeros(new_plan.max_batch, np.int64)
        for _, old_slot, new_slot in mig.survivors:
            self.last_tok[new_slot] = old_last[old_slot]
        _sync(self.device)
        self.last_migration = {
            "path": "graft" if local or not moves else "reshard",
            "weights": "recut" if recut else "kept",
            "seconds": time.perf_counter() - t0, "bytes": moved}
        return None


def _world() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def _owner(slot: int, max_batch: int, dist) -> int:
    """The data rank that holds ``slot`` of ``max_batch`` (0 where the
    rows are not split)."""
    deg = dist.batch_degree
    return slot // (max_batch // deg) if deg > 1 and max_batch % deg == 0 \
        else 0


def _map_leaves(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree``'s leaves in sorted key order (the
    same order on every rank: ``fn`` may be a collective)."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, tree[k], specs[k]) for k in sorted(tree)}
    return fn(tree, specs)


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _place_rows(caches, rows, specs, dist, pairs):
    """Write ``rows``' global rows ``j`` (every leaf ``[reps, k, ...]``)
    into this rank's local slots ``s`` of ``caches`` for each ``(j, s)``
    of ``pairs``, each cut to this rank's block of the other dims."""
    if not pairs:
        return
    js = [j for j, _ in pairs]
    slots = [s for _, s in pairs]

    def put(leaf, spec, src):
        cut = _shard(src[:, js], (spec[0], None) + tuple(spec[2:]), dist)
        leaf[:, torch.as_tensor(slots, device=leaf.device)] = cut.to(
            device=leaf.device, dtype=leaf.dtype)

    for key in sorted(caches):
        for name in sorted(caches[key]):
            put(caches[key][name], specs[key][name], rows[key][name])


def _recut_params(cfg, params, old_dist, old_strategy, new_dist,
                  new_strategy):
    """``params`` (this rank's shards on ``old_dist``) re-cut for
    ``new_dist``, leaf by leaf in sorted key order: each leaf's global
    array is gathered over the old mesh (``checkpoint._global_leaf``),
    this rank's block cut from it (``weights._shard``) and the global
    array and the old shard freed before the next leaf, so the peak is one
    leaf's global array above the tree."""
    old_specs = param_specs(cfg, old_strategy)
    new_specs = param_specs(cfg, new_strategy)

    def walk(tree, olds, news):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                walk(tree[k], olds[k], news[k])
                continue
            full = _global_leaf(tree[k], olds[k], old_dist)[0]
            tree[k] = None  # the old shard goes before the next leaf
            tree[k] = _shard(full, news[k], new_dist).clone()
            del full

    walk(params, old_specs, new_specs)
    return params


def check_serve_plan(plan, cfg, world: int, prompt_lens=()) -> None:
    """Raise, before the mesh is built, where ``plan`` cannot serve
    ``cfg`` over ``world`` ranks: its ``max_batch`` slots must split over
    its data degree and its ``max_seq`` positions over its ring; what the
    reference cannot decode raises naming C5 (:func:`check_strategy`);
    each of ``prompt_lens`` must split over the ring
    (:func:`check_prompt_len`)."""
    data, model = plan_mesh_shape(plan, world)
    if plan.max_batch % data:
        raise ValueError(f"the plan's {plan.max_batch} decode slots do not "
                         f"split over its data degree {data}")
    if plan.max_seq % model:
        raise ValueError(f"the plan's max_seq {plan.max_seq} does not split "
                         f"over its ring degree {model}")
    check_strategy(cfg, plan.parallel_config().strategy, model, "decode")
    ring = Dist(torch.device("cpu"), mesh_shape=(data, model))
    for n in sorted(set(prompt_lens)):
        check_prompt_len(ring, n, cfg)


# ---------------------------------------------------------------------------
# engine mode over several ranks: rank 0 leads, the others follow
# ---------------------------------------------------------------------------


class CommandLink:
    """The engine's commands from rank 0 to the other ranks: small host
    objects broadcast over a gloo group of the whole world (created by
    every rank alike, apart from the mesh's groups, so the ring's
    :class:`~repro_torch.core.dist.HostStage` figures leave them out).
    ``calls`` and ``bytes`` (pickled) count what went over it."""

    def __init__(self):
        self.group = tdist.new_group(
            backend="gloo",
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        self.calls = 0
        self.bytes = 0

    def broadcast(self, cmd=None):
        """Rank 0's ``cmd``, on every rank."""
        box = [cmd]
        tdist.broadcast_object_list(box, src=0, group=self.group)
        self.calls += 1
        self.bytes += len(pickle.dumps(box[0]))
        return box[0]


def _wire(states) -> list:
    """What another rank needs of each state to make the same call."""
    return [(st.req.rid, st.req.prompt_len, st.slot, st.context_len)
            for st in states]


def _states(wire) -> list:
    """Stand-ins for the engine's states, from :func:`_wire`."""
    return [SimpleNamespace(req=SimpleNamespace(rid=rid, prompt_len=plen),
                            slot=slot, context_len=clen, tokens=[])
            for rid, plen, slot, clen in wire]


class LeaderExecutor:
    """Rank 0's executor over several ranks: each call the engine makes is
    first broadcast to the other ranks (:class:`CommandLink`; they make it
    in :func:`follow`), then made here on ``inner`` (the
    :class:`TorchServeExecutor` or a wrapper of it, as on the others).
    What a call refuses (a prompt the ring cannot split, a plan the mesh
    cannot take) it refuses on every rank alike before any collective.
    :meth:`stop` ends the followers."""

    def __init__(self, inner, link: CommandLink):
        self.inner = inner
        self.link = link
        self._busy = False

    def _call(self, method, args, cmd):
        self.link.broadcast(cmd)
        self._busy = True  # the others are in the call now
        out = getattr(self.inner, method)(*args)
        self._busy = False
        return out

    def prefill(self, states):
        return self._call("prefill", (states,), ("prefill", _wire(states)))

    def decode(self, states):
        return self._call("decode", (states,), ("decode", _wire(states)))

    def migrate(self, new_plan, mig, wafer=None):
        return self._call("migrate", (new_plan, mig, wafer),
                          ("migrate", new_plan.dumps(),
                           [list(s) for s in mig.survivors]))

    def stop(self, error=None):
        """End the followers, from the caller's ``finally``: ``stop``
        carries ``error`` (what ended the run, if anything), which they
        raise.  Nothing is sent while a call is under way on them (they
        are in its collectives: the groups' timeout or the launcher ends
        them), and with ``error`` set a failed send is dropped, so the
        caller's error stands."""
        if self._busy:
            return
        msg = None if error is None else f"{type(error).__name__}: {error}"
        try:
            self.link.broadcast(("stop", msg))
        except Exception:
            if error is None:
                raise


def follow(executor, link: CommandLink) -> int:
    """A follower rank's loop: make each call rank 0 broadcasts on
    ``executor`` until ``stop``; returns the number of calls.  A ``stop``
    that carries rank 0's error raises it here."""
    from repro_torch.core.plan import ServePlan
    n = 0
    while True:
        cmd = link.broadcast()
        kind = cmd[0]
        if kind == "stop":
            if cmd[1] is not None:
                raise RuntimeError(f"rank 0 stopped the engine: {cmd[1]}")
            return n
        if kind == "prefill":
            executor.prefill(_states(cmd[1]))
        elif kind == "decode":
            executor.decode(_states(cmd[1]))
        elif kind == "migrate":
            executor.migrate(ServePlan.loads(cmd[1]),
                             SimpleNamespace(
                                 survivors=[tuple(s) for s in cmd[2]]))
        else:
            raise ValueError(f"unknown engine command {kind!r}")
        n += 1


def serve_engine(args, params=None, executor=None):
    """Engine mode: solve -> ServePlan -> continuous-batching run (the
    reference's ``serve_engine``); the report as a dict.  ``params`` (this
    rank's shard) go to :class:`TorchServeExecutor`; ``executor``, if
    given, wraps it (``executor(ex) -> executor``, e.g. to count or time
    its calls) on every rank alike.

    Over several ranks (``torch.distributed.run``) every rank joins the
    world, resolves the plan (rank 0 first, so the others read its cache
    entry) and builds its executor on the plan's mesh; rank 0 alone runs
    the engine, the fault timeline and the replans, broadcasting each
    executor call before it makes it (:class:`LeaderExecutor`), and the
    others make the same calls (:func:`follow`) until rank 0's ``stop``.
    Rank 0 returns the report, the others None.  ``--sim`` has no tensors
    to shard and raises over several ranks, before joining."""
    from repro_torch.launch.planning import resolve_serve_plan
    from repro_torch.serve.engine import (CostModelExecutor, ServeEngine,
                                          VirtualClock, WallClock,
                                          poisson_arrivals)
    from repro_torch.wafer.topology import Wafer, WaferSpec

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    rank, world, _ = world_from_env()
    if args.sim and world > 1:
        raise ValueError("--sim runs the cost model, with no tensors to "
                         "shard: run it on one rank")
    device = None if args.sim else join_world(args)
    plan = first_resolves(lambda: resolve_serve_plan(
        cfg, args.max_batch, args.prompt_len + args.max_new,
        plan_path=args.plan, cache_dir=args.plan_cache,
        failed_dies=args.failed_dies, allow_ep=not args.no_ep))
    run_cfg = replace(cfg, n_layers=args.layers) \
        if getattr(args, "layers", None) else cfg
    link = ex = None
    if not args.sim:
        check_serve_plan(plan, run_cfg, world, [args.prompt_len])
        link = CommandLink() if world > 1 else None
        ex = TorchServeExecutor(plan, run_cfg, device=device, params=params)
        ex.link = link
        wrapped = executor(ex) if executor is not None else ex
        if rank > 0:
            follow(wrapped, link)
            return None
        if link is not None:
            wrapped = LeaderExecutor(wrapped, link)
    err = None
    try:
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
            print(f"fault trace '{args.fault_trace}': {len(faults)} "
                  f"event(s), kind={trace.kind}")
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
            wrapped = CostModelExecutor(plan, cfg, wafer)
            if executor is not None:
                wrapped = executor(wrapped)
            clock = VirtualClock()
        else:
            clock = WallClock()
        engine = ServeEngine(plan, wrapped, clock=clock, cfg=cfg,
                             wafer=wafer, faults=faults,
                             readmission=args.readmission,
                             governor=governor,
                             prefill_chunk_tokens=args.prefill_chunk_tokens,
                             plan_cache_dir=args.plan_cache)
        rep = engine.run(reqs)
    except BaseException as e:
        err = e
        raise
    finally:
        if link is not None:
            wrapped.stop(err)
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
    ap.add_argument("--mesh", type=int, nargs="+", default=[1, 1],
                    help="(data, model) mesh over torch.distributed.run's "
                         "ranks (one number: data only); its size must be "
                         "the world's")
    ap.add_argument("--dist-backend", choices=("gloo", "nccl"),
                    default="gloo",
                    help="torch.distributed backend over several ranks: "
                         "gloo stages through the host (ranks may share a "
                         "card), nccl needs one card a rank")
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
    rank, _, _ = world_from_env()
    try:
        out = serve_engine(args) if args.serve else serve(args)
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
    if out is not None and rank == 0:
        print(json.dumps(out))


if __name__ == "__main__":
    main()
