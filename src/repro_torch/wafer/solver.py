"""DLWS — Dual-Level Wafer Solver (paper §VII, Fig. 12b).

Copy of ``repro.wafer.solver`` (the port imports nothing of ``repro``):
the reference's names, constants and arithmetic, in its order, so
results are bitwise equal to the reference's.

Level 0: partition the compute graph at residual-connection boundaries into
independent sub-graphs (shrinking the joint space from O(N^m) to O(N^m/k)).
Level 1: recursive dynamic programming — optimise one operator class at a
time against the wafer cost model, holding the others fixed, iterating to a
fixed point.  Level 2: a genetic algorithm refines the full configuration
vector (degrees × mapping engine ordering) with crossover / mutation /
elitist selection.

All levels score candidates through the two-tier batched cost engine
(:class:`repro_torch.wafer.simulator.StepCostContext` + ``simulate_batch``): the
DP pass submits whole (va, vb) grids per dimension pair and the GA submits
whole generations, so the engine can vectorize the arithmetic and prune
memory-infeasible candidates before traffic modeling.  The context also
carries the result cache, which keys evaluations to the wafer + alive-die
subset (the seed's module-level cache leaked results across different
``dies`` subsets during fault sweeps).

An ILP-style exhaustive baseline (:func:`ilp_search`) provides the paper's
§VIII-H search-time comparison (DLS is >100× faster on the same space while
matching solution quality).
"""

from __future__ import annotations

import itertools
import random
import time
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.wafer.simulator import (BYTES_ACT, ParallelDegrees, SimResult,
                                   StepCostContext, candidate_degrees,
                                   divisors, memory_components,
                                   simulate_batch)
from repro_torch.wafer.topology import Wafer

# paper Takeaway 3: ~9 TB/s aggregate bandwidth between adjacent wafers
INTER_WAFER_BW = 9e12


@dataclass
class SolveResult:
    best: SimResult
    config: ParallelDegrees
    engine: str
    search_time_s: float
    evaluated: int
    method: str
    history: list[float] = field(default_factory=list)
    space_size: int = 0  # full joint space (ILP may be capped below this)
    projected_full_time_s: float = 0.0


# ---------------------------------------------------------------------------
# graph partition (level 0)
# ---------------------------------------------------------------------------


def partition_graph(cfg: ModelConfig) -> list[str]:
    """Residual-free sub-graphs of one transformer block (paper Fig. 12a):
    each attention / MLP / embedding unit can be optimised independently
    because residual adds are the only cross-edges."""
    subs = ["embed"]
    for kind in set(cfg.pattern_for_layers()):
        if kind in ("G", "L", "S"):
            subs += ["attn", "moe" if cfg.is_moe else "mlp"]
        elif kind == "M":
            subs += ["ssm"]
    subs += ["head"]
    # dedupe, preserve order
    seen, out = set(), []
    for s in subs:
        if s not in seen:
            seen.add(s)
            out.append(s)
    return out


# ---------------------------------------------------------------------------
# level 1: recursive dynamic programming over degree dimensions
# ---------------------------------------------------------------------------


def _score(res: SimResult) -> float:
    # memoized on the result: DP re-sweeps re-score the same cached
    # SimResults thousands of times per solve
    s = res.score_cache
    if s is None:
        s = res.throughput if res.ok else -res.mem_per_die
        res.score_cache = s
    return s


# generous degree ladder for subset-totals: composite values let degraded
# wafers with awkward alive counts use most (not all) surviving dies
_LADDER = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)

_ALL_DIMS = ("dp", "tp", "sp", "tatp")
# DP candidate grids keyed on everything that determines them — the die
# count (which fixes refine_values), the swept pair, the remaining
# degrees, and the Megatron-3 flag.  ParallelDegrees is frozen, so the
# grids are shared across solves and evaluators; building ~10² dataclass
# instances per grid per sweep was a measurable share of solve time.
_GRID_CACHE: dict = {}


def refine_values(n: int) -> tuple[int, ...]:
    """Candidate per-dimension degrees for an ``n``-die wafer: the true
    divisors of ``n`` (exact partitions, incl. primes like 47) plus the
    composite ladder (subset totals — spare dies idle)."""
    return tuple(sorted(set(divisors(n)).union(
        v for v in _LADDER if v <= n)))


def _grid_scores(ctx: StepCostContext, cands: list) -> "np.ndarray":
    """Score vector of one (cached, persistent) candidate grid.

    Grids from ``_GRID_CACHE`` are immutable and results are memoized per
    context, so the whole vector is cached on the context after the first
    evaluation — DP re-sweeps over converged grids become one ``argmax``
    instead of a 10²-candidate Python scan."""
    sv = ctx.__dict__.get("_scorevecs")
    if sv is None:
        sv = ctx._scorevecs = {}
    vec = sv.get(id(cands))
    if vec is None:
        results = ctx.evaluate_many(cands)
        vec = np.fromiter((_score(r) for r in results), np.float64,
                          len(results))
        sv[id(cands)] = vec
    return vec


def dp_refine(ctx: StepCostContext, start: ParallelDegrees,
              dims=("dp", "tp", "sp", "tatp")) -> ParallelDegrees:
    """Pairwise coordinate-descent DP: optimise two parallel dimensions
    jointly (holding the rest fixed) so moves can trade degree between
    dimensions while the die count stays full — one batch-scored candidate
    grid per dimension pair, iterated to a fixed point.

    ``dims`` may include ``"ep"`` (decode + MoE): expert parallelism
    subdivides the dp replicas rather than consuming dies, so its
    candidate values are the divisors of ``cfg.n_experts`` and it is
    excluded from the die-budget product (the evaluator rejects
    ``ep ∤ dp`` combinations as infeasible)."""
    n = ctx.n_dies
    vals = refine_values(n)
    ep_vals = divisors(ctx.cfg.n_experts) if "ep" in dims else (1,)

    def dim_vals(d):
        return ep_vals if d == "ep" else vals

    cur = start
    cur_s = _score(ctx.evaluate(cur))
    improved = True
    while improved:
        improved = False
        for i, da in enumerate(dims):
            for db in dims[i + 1:]:
                rest = 1
                for d in dims:
                    if d not in (da, db) and d != "ep":
                        rest *= getattr(cur, d)
                # whole (va, vb) grid scored in one batch; subset totals are
                # allowed (spare dies idle) — essential for degraded wafers
                # with awkward alive counts
                gkey = (n, da, db,
                        tuple(getattr(cur, d) for d in _ALL_DIMS + ("ep",)
                              if d not in (da, db)), cur.seq_par,
                        ctx.cfg.n_experts if "ep" in dims else 0)
                cands = _GRID_CACHE.get(gkey)
                if cands is None:
                    cands = [replace(cur, **{da: va, db: vb})
                             for va in dim_vals(da) for vb in dim_vals(db)
                             if rest * (1 if da == "ep" else va)
                             * (1 if db == "ep" else vb) <= n]
                    _GRID_CACHE[gkey] = cands
                # the running-max scan equals the grid argmax (first tie
                # wins in both), so the vectorized form picks the same cur
                svec = _grid_scores(ctx, cands)
                if len(svec):
                    j = int(np.argmax(svec))
                    s = float(svec[j])
                    if s > cur_s:
                        cur, cur_s = cands[j], s
                        improved = True
    return cur


# ---------------------------------------------------------------------------
# level 2: genetic refinement
# ---------------------------------------------------------------------------


def ga_refine(ctx: StepCostContext, seeds: list[ParallelDegrees], *,
              pop: int = 12, gens: int = 6,
              rng: Optional[random.Random] = None,
              dims: tuple = ("dp", "tp", "sp", "tatp")) -> ParallelDegrees:
    rng = rng or random.Random(0)
    n = ctx.n_dies
    # die-consuming genome dims; "ep" (decode + MoE) rides along with its
    # own move set since it subdivides dp instead of consuming dies.  All
    # extra rng draws are gated on has_ep so train trajectories (and the
    # recorded baselines pinned to them) are untouched.
    genome_dims = tuple(d for d in dims if d != "ep")
    has_ep = "ep" in dims
    ep_vals = divisors(ctx.cfg.n_experts) if has_ep else (1,)

    def fitness_of(res: SimResult) -> float:
        return res.throughput if res.ok else -1.0

    def legal(deg):
        # subset totals are legal (spare dies idle) — matching Tier-B's
        # semantics and dp_refine's candidate grids.  Requiring
        # ``n % deg.total == 0`` froze the GA on degraded wafers with
        # awkward alive counts (e.g. 47 dies): every mutation/crossover
        # from a subset-total parent collapsed back to the parent.
        # Each expert group hosts whole replicas, so ep must divide dp.
        return deg.total <= n and deg.dp % deg.ep == 0

    def remake(deg, **kw):
        # direct construction: dataclasses.replace went through asdict
        # machinery on every GA move and showed up in solve profiles
        return ParallelDegrees(kw.get("dp", deg.dp), kw.get("tp", deg.tp),
                               kw.get("sp", deg.sp),
                               kw.get("tatp", deg.tatp),
                               seq_par=deg.seq_par,
                               ep=kw.get("ep", deg.ep))

    def mutate(deg):
        # swap move: trade a factor of 2 between two dimensions so the die
        # count is preserved (plus occasional single-dim jitter); EP moves
        # resample the expert-group count from the divisor ladder
        if has_ep and rng.random() < 0.3:
            cand = remake(deg, ep=rng.choice(ep_vals))
            return cand if legal(cand) else deg
        a, b = rng.sample(genome_dims, 2)
        va, vb = getattr(deg, a), getattr(deg, b)
        if va > 1 and rng.random() < 0.8:
            cand = remake(deg, **{a: va // 2, b: vb * 2})
        else:
            cand = remake(deg, **{a: max(1, min(64, va * 2))})
        return cand if legal(cand) else deg

    def crossover(a, b):
        cand = ParallelDegrees(rng.choice((a, b)).dp, rng.choice((a, b)).tp,
                               rng.choice((a, b)).sp,
                               rng.choice((a, b)).tatp, seq_par=a.seq_par,
                               ep=rng.choice((a, b)).ep if has_ep
                               else a.ep)
        return cand if legal(cand) else a

    popl = list(seeds)
    while len(popl) < pop:
        popl.append(mutate(rng.choice(seeds)))
    for _ in range(gens):
        # batch-score the generation (memoized, so survivors are free)
        fits = [fitness_of(r) for r in ctx.evaluate_many(popl)]
        scored = [d for _, d in sorted(zip(fits, popl), reverse=True,
                                       key=lambda t: t[0])]
        elite = scored[: max(2, pop // 4)]
        nxt = list(elite)
        while len(nxt) < pop:
            a, b = rng.sample(elite, 2) if len(elite) > 1 else (elite[0],
                                                                elite[0])
            child = mutate(crossover(a, b))
            nxt.append(child)
        popl = nxt
    fits = [fitness_of(r) for r in ctx.evaluate_many(popl)]
    return popl[max(range(len(popl)), key=fits.__getitem__)]


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def dlws_solve(wafer: Wafer, cfg: ModelConfig, batch: int, seq: int, *,
               engine: str = "tcme", space: str = "temp", seed: int = 0,
               dies: Optional[list[int]] = None,
               evaluator: str = "batch",
               stage1: Optional[str] = None,
               tierb: Optional[str] = None,
               objective: str = "train",
               allow_ep: bool = True) -> SolveResult:
    """Dual-level solve.  ``evaluator="reference"`` routes every score
    through the seed scalar path (same trajectory — results are bitwise
    identical — used by benchmarks to measure the engine speedup);
    ``stage1="jax"`` runs the Tier-B stage-1 arithmetic through the jitted
    twin (million-candidate sweeps); ``tierb="jax"`` (or ``REPRO_TIERB=jax``)
    runs search-time evaluations through the fully-jitted Tier B — final
    evaluations stay on the anchored numpy path, and the two tiers share
    the candidate-sized arithmetic verbatim, so the search trajectory,
    selected config and recorded throughput are backend-invariant.

    The scoring context is *resident*: on a cache-enabled wafer the
    :class:`StepCostContext` (and its per-candidate result memo) is shared
    across calls with the same cost-surface identity, so a long-lived
    solver re-solving a workload pays only the search logic — the engine
    serves repeat evaluations from the memo.  ``evaluated`` on the returned
    :class:`SolveResult` counts the cost-model evaluations *this call*
    actually performed (0 for a fully-memoized re-solve).

    ``objective="decode"`` scores candidates as one continuous-batching
    decode iteration instead of a training step (``batch`` = max in-flight
    sequences, ``seq`` = per-sequence KV budget): the same DP/GA search
    runs against :func:`repro_torch.wafer.simulator.simulate_decode_batch`, so
    serving solves inherit every search-level optimization while trading
    ring-KV stream latency and cache capacity instead of step time.

    For MoE configs the decode search additionally sweeps an ``ep``
    expert-parallel axis (expert weights sharded ``n_experts/ep`` per
    group, dispatch/combine all-to-alls priced by the traffic engine);
    ``allow_ep=False`` pins ``ep=1`` for A/B sweeps of the EP win."""
    from repro_torch.wafer.simulator import STRATEGY_SPACES
    spec = STRATEGY_SPACES[space]
    t0 = time.time()
    ctx = StepCostContext.resident(wafer, cfg, batch, seq, engine,
                                   fsdp=spec["fsdp"], dies=dies,
                                   evaluator=evaluator, stage1=stage1,
                                   tierb=tierb, objective=objective)
    ev0 = ctx.evaluated
    use_ep = (objective == "decode" and allow_ep and cfg.is_moe
              and cfg.n_experts > 1)
    dims = _ALL_DIMS + ("ep",) if use_ep else _ALL_DIMS
    subs = partition_graph(cfg)  # level 0 (scopes the DP passes)
    start = ParallelDegrees(dp=ctx.n_dies, seq_par=spec["seq_par"])
    if objective == "decode" and ctx.n_dies > 1:
        # dp=n replicates full weights per die — hopeless for big models;
        # seed the search from a balanced data × ring split as well
        r = max(d for d in divisors(ctx.n_dies) if d * d <= ctx.n_dies)
        start2 = ParallelDegrees(dp=ctx.n_dies // r, tatp=r,
                                 seq_par=spec["seq_par"])
        seeds = [start, start2]
        if use_ep:
            # widest expert split the balanced seed admits — gives both
            # DP and GA an in-basin EP starting point
            ep0 = max((e for e in divisors(cfg.n_experts)
                       if start2.dp % e == 0), default=1)
            if ep0 > 1:
                seeds.append(replace(start2, ep=ep0))
    else:
        seeds = [start]
    cur = seeds[-1]
    for _ in subs:  # one DP pass per residual-free sub-graph
        cur = dp_refine(ctx, cur, dims)
    best = ga_refine(ctx, [cur] + seeds, rng=random.Random(seed),
                     dims=dims)
    res = ctx.evaluate(best, final=True)
    return SolveResult(res, best, engine, time.time() - t0,
                       ctx.evaluated - ev0,
                       "dlws-decode" if objective == "decode" else "dlws")


def ilp_search(wafer: Wafer, cfg: ModelConfig, batch: int, seq: int, *,
               engine: str = "tcme", space: str = "temp",
               per_op: bool = True,
               dies: Optional[list[int]] = None) -> SolveResult:
    """Exhaustive joint search (the ILP stand-in): enumerates the full
    configuration space — per-operator-class assignments when ``per_op`` —
    which blows up combinatorially exactly as §III challenge 3 describes.
    Every assignment is re-simulated (no memoization — that's the point),
    though in batched chunks so both searches run on the same engine.

    ``dies`` restricts the search to an alive-die subset, mirroring
    ``dlws_solve(dies=...)`` — degraded-wafer search-time comparisons must
    score the same problem as the DLWS run they are compared against (the
    context used to be built on the full wafer regardless)."""
    from repro_torch.wafer.simulator import STRATEGY_SPACES
    spec = STRATEGY_SPACES[space]
    t0 = time.time()
    n = len(dies) if dies is not None else len(wafer.alive_dies())
    cands = candidate_degrees(n, spec["allow"], spec["seq_par"])
    subs = partition_graph(cfg) if per_op else ["all"]
    best: Optional[SimResult] = None
    best_deg = None
    evaluated = 0
    space_size = len(cands) ** len(subs)
    cap = 50_000
    chunk_n = 1024
    ctx = StepCostContext(wafer, cfg, batch, seq, engine, fsdp=spec["fsdp"],
                          dies=dies)
    # joint assignment over operator classes (cost decomposes, but the ILP
    # enumerates the product space regardless — that's the point)
    chunk: list[ParallelDegrees] = []

    def flush(chunk):
        nonlocal best, best_deg
        for res in simulate_batch(ctx, chunk, run_tcme_optimizer=False,
                                  prune_oom=True):
            if res.ok and (best is None
                           or res.throughput > best.throughput):
                best, best_deg = res, res.degrees

    for assign in itertools.product(cands, repeat=len(subs)):
        evaluated += 1
        # evaluate with the dominant (layer) assignment; others add resharding
        chunk.append(assign[min(1, len(assign) - 1)])
        if len(chunk) >= chunk_n:
            flush(chunk)
            chunk = []
        if evaluated >= cap:  # safety valve; report projected full time
            break
    if chunk:
        flush(chunk)
    dt = time.time() - t0
    return SolveResult(best, best_deg, engine, dt, evaluated, "ilp",
                       space_size=space_size,
                       projected_full_time_s=dt * space_size
                       / max(evaluated, 1))


# ---------------------------------------------------------------------------
# upper level: multi-wafer pipeline solve (§VIII-E)
# ---------------------------------------------------------------------------


def stage_config(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    """A pipeline-stage view of ``cfg`` holding ``n_layers`` layers.  The
    name is disambiguated so per-name caches (plan cache, fault ctx_cache)
    never alias stages with different layer counts."""
    return replace(cfg, name=f"{cfg.name}@L{n_layers}", n_layers=n_layers)


def apportion(total: int, weights: Sequence[float],
              min_per: int = 1) -> tuple[int, ...]:
    """Apportion ``total`` units over bins proportionally to ``weights``
    (largest-remainder method; every bin gets at least ``min_per``).
    Shared by the layer → stage split and the launch-side device → stage
    partition."""
    k = len(weights)
    if total < k * min_per:
        raise ValueError(f"{total} units cannot fill {k} bins "
                         f"(min {min_per} each)")
    total_w = sum(weights) or k
    raw = [total * w / total_w for w in weights]
    out = [max(min_per, int(r)) for r in raw]
    rema = sorted(range(k), key=lambda i: raw[i] - int(raw[i]), reverse=True)
    i = 0
    while sum(out) < total:
        out[rema[i % k]] += 1
        i += 1
    while sum(out) > total:  # max(min_per, ...) may have over-allocated
        j = max(range(k), key=lambda s: (out[s], -s))
        out[j] -= 1
    return tuple(out)


def split_layers(n_layers: int, weights: Sequence[float]) -> tuple[int, ...]:
    """Apportion ``n_layers`` over stages proportionally to ``weights``
    (largest-remainder method; every stage gets at least one layer)."""
    if n_layers < len(weights):
        raise ValueError(f"{n_layers} layers cannot fill "
                         f"{len(weights)} stages")
    return apportion(n_layers, weights)


def stage_die_split(wafer: Wafer, n_stages: int,
                    dies: Optional[Sequence[int]] = None) \
        -> list[tuple[int, ...]]:
    """Split a wafer's alive dies into ``n_stages`` contiguous chunks of
    the snake order (so every stage's TATP rings stay embeddable on
    physically adjacent dies, holes skipped)."""
    from repro_torch.wafer import mapping as wmap
    live = set(dies) if dies is not None else set(wafer.alive_dies())
    order = [d for d in wmap.snake_order(wafer.spec.rows, wafer.spec.cols)
             if d in live]
    n = len(order)
    if n < n_stages:
        raise ValueError(f"{n} alive dies cannot host {n_stages} stages")
    bounds = [round(i * n / n_stages) for i in range(n_stages + 1)]
    return [tuple(order[bounds[i]:bounds[i + 1]]) for i in range(n_stages)]


@dataclass
class MultiWaferSolveResult:
    """One solved multi-wafer pipeline configuration (upper DLWS level)."""
    stages: list[SolveResult]  # per-stage intra-wafer solves
    stage_layers: tuple[int, ...]
    stage_wafer: tuple[int, ...]  # stage -> wafer index
    stage_dies: tuple[tuple[int, ...], ...]  # stage -> die subset
    pp: int
    n_micro: int
    family: str  # "gpipe" | "1f1b"
    step_time: float
    throughput: float  # tokens/s through the whole pipeline
    bubble: float
    peak_inflight: int
    stage_mem: tuple[float, ...]  # pipeline-adjusted bytes/die per stage
    oom: bool
    search_time_s: float = 0.0
    evaluated: int = 0  # cost-model evaluations across all stage solves
    candidates: int = 0  # upper-level (split, family, n_micro) combos

    @property
    def ok(self) -> bool:
        return not self.oom and all(s.best is not None and s.best.ok
                                    for s in self.stages)


def _micro_candidates(batch: int, cands: Sequence[int]) -> list[int]:
    out = [m for m in cands if 1 <= m <= batch and batch % m == 0]
    if not out:
        # no candidate divides the batch: fall back to the largest true
        # divisor ≤ 8 so microbatches stay equal-sized (the schedule model
        # assumes them so)
        out = [max(d for d in divisors(batch) if d <= 8)]
    return out


def _wafer_fingerprint(w: Wafer) -> tuple:
    return (w.spec, w.failed_dies, w.failed_links)


def stage_boundary_p2p(wafers: Sequence[Wafer], stage_wafer, stage_dies,
                       boundary_bytes: float, n_micro: int,
                       inter_wafer_bw: float, *,
                       shared_cut: bool = False) -> list[float]:
    """Per-boundary activation-transfer time for one pipeline layout.

    Boundary ``b`` sits between stages ``b`` and ``b+1``.  Boundaries
    crossing wafers pay the inter-wafer bandwidth; boundaries internal to
    a wafer (co-located stages, ``pp > n_wafers``) pay the physical D2D
    cut between the two die subsets — ``cut_links · link_bw``, which on a
    4×8 wafer split in half is 8 TB/s, *slower* than the 9 TB/s
    inter-wafer fabric the old model charged them at.

    ``shared_cut=True`` additionally charges co-located boundaries the
    contention of *sharing* their wafer's D2D fabric: in a steady 1F1B
    pipeline every on-wafer boundary streams activations concurrently,
    so each gets ``1/k`` of its cut when ``k`` on-wafer boundaries live
    on the same wafer.  The fault-recovery path prices stage replans
    with this on (``replan_stage``/``recover_multiwafer`` — the replan
    governor must not see an optimistic boundary when deciding whether
    a degraded co-located layout is worth keeping); the healthy solve
    keeps the optimistic un-shared price so existing solve baselines
    are untouched."""
    on_wafer = [0] * len(wafers)
    if shared_cut:
        for b in range(len(stage_wafer) - 1):
            if stage_wafer[b] == stage_wafer[b + 1]:
                on_wafer[stage_wafer[b]] += 1
    out = []
    for b in range(len(stage_wafer) - 1):
        if stage_wafer[b] == stage_wafer[b + 1]:
            w = wafers[stage_wafer[b]]
            cut = max(w.cut_links(stage_dies[b], stage_dies[b + 1]), 1)
            bw = cut * w.spec.link_bw
            if shared_cut:
                bw /= max(on_wafer[stage_wafer[b]], 1)
        else:
            bw = inter_wafer_bw
        out.append(boundary_bytes / n_micro / bw)
    return out


def dlws_solve_multiwafer(
        wafers: Sequence[Wafer], cfg: ModelConfig, batch: int, seq: int, *,
        engine: str = "tcme", space: str = "temp", seed: int = 0,
        dies_per_wafer: Optional[Sequence[Optional[Sequence[int]]]] = None,
        inter_wafer_bw: float = INTER_WAFER_BW,
        pp_multipliers: Sequence[int] = (1,),
        n_micro_candidates: Sequence[int] = (4, 8, 16, 32),
        families: Sequence[str] = ("gpipe", "1f1b"),
        max_rebalance: int = 8,
        tierb: Optional[str] = None,
        stage_cache: Optional[dict] = None) -> MultiWaferSolveResult:
    """Upper DLWS level: solve pipeline parallelism across ``wafers``.

    Chooses the pipeline degree (``n_wafers × mult`` for each multiplier),
    the layer → stage split (die-count-proportional, so a degraded wafer
    automatically gets fewer layers), the microbatch count and the
    schedule family.  The ``(mult × split × family × n_micro)`` candidate
    space is scored in two batched phases: first every *distinct* stage
    sub-problem across all pipeline-shape candidates is solved once
    through the per-wafer :func:`dlws_solve` (stage solutions are
    memoized across pipeline candidates, and across *calls* when the
    caller passes a shared ``stage_cache`` — keys carry the full wafer
    fingerprint, die subset, layer count and workload identity, so
    sharing one dict across solves/systems is safe); then every candidate
    pipeline is scored against the executable schedule model in
    :mod:`repro_torch.core.schedule` (``schedule_and_report`` memoizes the slot
    executor per ``(family, pp, n_micro)`` shape).

    With ``mult > 1`` the stages sharing a wafer each get a contiguous
    *subset* of its dies (the baselines' regime: shorter stages, more of
    them, more bubbles) — which is why the ``dies=`` plumbing through the
    cost engine matters here.  Stage boundaries crossing wafers pay the
    inter-wafer bandwidth; boundaries internal to a wafer pay the D2D cut
    between the two die subsets (:func:`stage_boundary_p2p`).

    ``tierb`` selects the Tier-B backend for every per-stage solve (same
    contract as :func:`dlws_solve` — stage solutions are backend-invariant,
    so a ``stage_cache`` may be shared across backends).

    Memory feasibility is re-judged at the pipeline level: stage ``s``
    holds ``inflight_s`` of ``n_micro`` microbatches' activations
    (:func:`repro_torch.wafer.simulator.memory_components` splits the solver's
    memory prediction), so 1F1B can rescue a configuration GPipe cannot
    fit.  If no candidate is feasible, layers migrate away from the worst
    over-capacity stage (≤ ``max_rebalance`` moves) before giving up.
    """
    from repro_torch.core.schedule import pipeline_step_time, schedule_and_report
    from repro_torch.wafer.simulator import STRATEGY_SPACES
    t0 = time.time()
    n_wafers = len(wafers)
    if n_wafers < 1:
        raise ValueError("need at least one wafer")
    spec = STRATEGY_SPACES[space]
    micro_cands = _micro_candidates(batch, n_micro_candidates)
    solve_cache: dict = stage_cache if stage_cache is not None else {}
    evaluated = 0

    def stage_solve(widx: int, dies: tuple[int, ...], n_layers: int):
        nonlocal evaluated
        # cfg itself (frozen dataclass) is the workload identity — keying
        # on cfg.name alone would alias two configs sharing a name
        key = (_wafer_fingerprint(wafers[widx]), dies, n_layers,
               cfg, batch, seq, engine, space, seed)
        got = solve_cache.get(key)
        if got is None:
            scfg = stage_config(cfg, n_layers)
            sol = dlws_solve(wafers[widx], scfg, batch, seq, engine=engine,
                             space=space, seed=seed, dies=list(dies),
                             tierb=tierb)
            ctx = StepCostContext.resident(wafers[widx], scfg, batch, seq,
                                           engine, fsdp=spec["fsdp"],
                                           dies=list(dies), tierb=tierb)
            fixed, act_full, _ = memory_components(ctx, sol.config)
            got = (sol, fixed, act_full)
            solve_cache[key] = got
            evaluated += sol.evaluated
        return got

    boundary_bytes = batch * seq * cfg.d_model * BYTES_ACT
    best: Optional[MultiWaferSolveResult] = None
    n_candidates = 0

    def score(stage_wafer, stage_dies, layers, family, n_micro, sched_rep):
        """Assemble + score one fully-specified pipeline candidate."""
        nonlocal n_candidates
        n_candidates += 1
        sched, rep = sched_rep
        pp = len(layers)
        sols, mems = [], []
        for s in range(pp):
            sol, fixed, act_full = stage_solve(stage_wafer[s],
                                               stage_dies[s], layers[s])
            sols.append(sol)
            mems.append(fixed + act_full * rep.inflight_per_stage[s]
                        / n_micro)
        caps = [wafers[stage_wafer[s]].spec.hbm_cap for s in range(pp)]
        oom = any(m > c for m, c in zip(mems, caps)) \
            or any(s.best is None or not s.best.ok for s in sols)
        half = [s.best.step_time / (2 * n_micro) if s.best else float("inf")
                for s in sols]
        p2p = stage_boundary_p2p(wafers, stage_wafer, stage_dies,
                                 boundary_bytes, n_micro, inter_wafer_bw)
        t_step = pipeline_step_time(sched, half, half, p2p)
        thr = batch * seq / t_step if t_step > 0 else 0.0
        return MultiWaferSolveResult(
            stages=sols, stage_layers=tuple(layers),
            stage_wafer=tuple(stage_wafer), stage_dies=tuple(stage_dies),
            pp=pp, n_micro=n_micro, family=family,
            step_time=t_step, throughput=thr, bubble=rep.bubble,
            peak_inflight=rep.peak_inflight, stage_mem=tuple(mems),
            oom=oom)

    def better(a: MultiWaferSolveResult,
               b: Optional[MultiWaferSolveResult]) -> bool:
        if b is None:
            return True
        if a.oom != b.oom:
            return not a.oom
        if a.oom:  # least-bad: smallest worst-stage overshoot
            return max(a.stage_mem) < max(b.stage_mem)
        return a.throughput > b.throughput

    # ---- phase 1: enumerate pipeline shapes (mult × layer split) ---------
    combos: list[tuple[list[int], list[tuple[int, ...]], tuple[int, ...]]] \
        = []
    for mult in pp_multipliers:
        pp = n_wafers * mult
        if pp > cfg.n_layers or pp < 1:
            continue
        stage_wafer, stage_dies = [], []
        for w in range(n_wafers):
            sub = dies_per_wafer[w] if dies_per_wafer is not None else None
            for chunk in stage_die_split(wafers[w], mult, sub):
                stage_wafer.append(w)
                stage_dies.append(chunk)
        weights = [len(d) for d in stage_dies]
        splits = [split_layers(cfg.n_layers, weights)]
        equal = split_layers(cfg.n_layers, [1.0] * pp)
        if equal not in splits:
            splits.append(equal)
        for layers in splits:
            combos.append((stage_wafer, stage_dies, layers))

    # ---- phase 2: solve every distinct stage sub-problem once ------------
    for stage_wafer, stage_dies, layers in combos:
        for s in range(len(layers)):
            stage_solve(stage_wafer[s], stage_dies[s], layers[s])

    # ---- phase 3: score the full (shape × family × n_micro) batch --------
    for stage_wafer, stage_dies, layers in combos:
        pp = len(layers)
        for family in families:
            for n_micro in micro_cands:
                cand = score(stage_wafer, stage_dies, layers, family,
                             n_micro, schedule_and_report(family, pp,
                                                          n_micro))
                if better(cand, best):
                    best = cand

    # memory-repair: migrate layers off the worst over-capacity stage
    attempts = 0
    while best is not None and best.oom and attempts < max_rebalance:
        attempts += 1
        caps = [wafers[best.stage_wafer[s]].spec.hbm_cap
                for s in range(best.pp)]
        over = [s for s in range(best.pp) if best.stage_mem[s] > caps[s]
                and best.stage_layers[s] > 1]
        if not over:
            break
        src = max(over, key=lambda s: best.stage_mem[s] - caps[s])
        dst = min((s for s in range(best.pp) if s != src),
                  key=lambda s: best.stage_mem[s] / caps[s], default=None)
        if dst is None:
            break
        layers = list(best.stage_layers)
        layers[src] -= 1
        layers[dst] += 1
        cand = score(best.stage_wafer, best.stage_dies, tuple(layers),
                     best.family, best.n_micro,
                     schedule_and_report(best.family, best.pp,
                                         best.n_micro))
        if better(cand, best):
            best = cand
        else:
            break

    if best is None:
        raise ValueError(
            f"no pipeline candidate fits: n_layers={cfg.n_layers} cannot "
            f"fill pp in {[n_wafers * m for m in pp_multipliers]} stages "
            f"(need pp <= n_layers)")
    best.search_time_s = time.time() - t0
    best.evaluated = evaluated
    best.candidates = n_candidates
    return best
