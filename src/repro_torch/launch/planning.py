"""Launch-side plan resolution: shared by the train and serve drivers.

Copy of ``repro.launch.planning`` (the port imports nothing of
``repro``): the reference's names, constants and arithmetic, in its
order, so results are bitwise equal to the reference's.

One function turns the CLI surface (``--plan`` / ``--auto-plan`` /
``--failed-dies`` / ``--plan-cache``) into a :class:`WaferPlan`, logging
whether the solver ran or the on-disk cache answered — the observable
signal the acceptance tests (and operators) use to confirm that repeated
launches skip the search.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core import plan as planlib


def resolve_plan(cfg, batch: int, seq: int, *,
                 plan_path: Optional[str] = None,
                 cache_dir: Optional[str] = None,
                 failed_dies: Optional[str] = None,
                 remat: bool = True) -> planlib.WaferPlan:
    """Explicit plan file wins; otherwise compile (or hit the cache) for
    the wafer at hand.  ``failed_dies`` is the CLI's comma-separated die
    list for degraded-wafer launches."""
    from repro_torch.wafer.topology import Wafer, WaferSpec

    if plan_path:
        if failed_dies:
            print(f"[plan] WARNING: --failed-dies {failed_dies} is ignored "
                  f"when an explicit --plan file is given; the plan is "
                  f"replayed as-is (drop --plan to re-solve degraded)")
        plan = planlib.WaferPlan.load(plan_path)
        print(f"[plan] loaded {plan_path} (hash {plan.plan_hash})")
        return plan
    wafer = Wafer(WaferSpec())
    if failed_dies:
        dead = [int(x) for x in failed_dies.split(",") if x]
        wafer = wafer.with_faults(dies=dead)
    before = dict(planlib.PLAN_STATS)
    plan = planlib.compile_plan(wafer, cfg, batch, seq, arch=cfg.name,
                                cache_dir=cache_dir, remat=remat)
    hit = planlib.PLAN_STATS["cache_hits"] > before["cache_hits"]
    solves = planlib.PLAN_STATS["solver_calls"] - before["solver_calls"]
    src = "cache hit (solver skipped)" if hit \
        else f"solved fresh ({solves} solver call)"
    print(f"[plan] {src}: hash {plan.plan_hash}")
    return plan


def resolve_serve_plan(cfg, max_batch: int, max_seq: int, *,
                       plan_path: Optional[str] = None,
                       cache_dir: Optional[str] = None,
                       failed_dies: Optional[str] = None,
                       allow_ep: bool = True) \
        -> planlib.ServePlan:
    """Serving analogue of :func:`resolve_plan`: explicit ServePlan file
    wins; otherwise ``compile_serve_plan`` runs the decode-objective solve
    (or hits the ``splan_*`` cache) for the wafer at hand."""
    from repro_torch.wafer.topology import Wafer, WaferSpec

    if plan_path:
        if failed_dies:
            print(f"[plan] WARNING: --failed-dies {failed_dies} is ignored "
                  f"when an explicit --plan file is given")
        plan = planlib.ServePlan.load(plan_path)
        print(f"[plan] loaded {plan_path} (hash {plan.plan_hash})")
        return plan
    wafer = Wafer(WaferSpec())
    if failed_dies:
        dead = [int(x) for x in failed_dies.split(",") if x]
        wafer = wafer.with_faults(dies=dead)
    before = dict(planlib.PLAN_STATS)
    plan = planlib.compile_serve_plan(wafer, cfg, max_batch, max_seq,
                                      arch=cfg.name, cache_dir=cache_dir,
                                      allow_ep=allow_ep)
    hit = planlib.PLAN_STATS["cache_hits"] > before["cache_hits"]
    solves = planlib.PLAN_STATS["solver_calls"] - before["solver_calls"]
    src = "cache hit (solver skipped)" if hit \
        else f"solved fresh ({solves} solver call)"
    print(f"[plan] {src}: hash {plan.plan_hash}")
    return plan


def resolve_multiwafer_plan(cfg, batch: int, seq: int, *, n_wafers: int,
                            plan_path: Optional[str] = None,
                            cache_dir: Optional[str] = None,
                            failed_dies: Optional[str] = None,
                            fail_wafer: int = 0,
                            remat: bool = True) -> planlib.MultiWaferPlan:
    """Multi-wafer analogue of :func:`resolve_plan`: ``--plan`` file wins;
    otherwise compile (or hit the fault-tuple-keyed cache) for ``n_wafers``
    wafers.  ``failed_dies`` marks dies dead on wafer ``fail_wafer`` —
    the cache key changes for that wafer only, so only its stages
    re-solve (via the upper solve level's per-stage memoization)."""
    from repro_torch.wafer.topology import Wafer, WaferSpec

    if plan_path:
        if failed_dies:
            print(f"[plan] WARNING: --failed-dies {failed_dies} is ignored "
                  f"when an explicit --plan file is given")
        plan = planlib.MultiWaferPlan.load(plan_path)
        print(f"[plan] loaded {plan_path} (hash {plan.plan_hash})")
        return plan
    wafers = [Wafer(WaferSpec()) for _ in range(n_wafers)]
    if failed_dies:
        dead = [int(x) for x in failed_dies.split(",") if x]
        wafers[fail_wafer] = wafers[fail_wafer].with_faults(dies=dead)
    before = dict(planlib.PLAN_STATS)
    plan = planlib.compile_multiwafer_plan(wafers, cfg, batch, seq,
                                           arch=cfg.name,
                                           cache_dir=cache_dir, remat=remat)
    hit = planlib.PLAN_STATS["cache_hits"] > before["cache_hits"]
    src = "cache hit (solver skipped)" if hit else "solved fresh"
    print(f"[plan] {src}: hash {plan.plan_hash} "
          f"(pp={plan.pp}, n_micro={plan.n_micro}, {plan.family})")
    return plan
