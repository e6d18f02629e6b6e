"""Static plan verifier: check a plan IR against its wafer without
running the engine.

Copy of ``repro.analysis.verify`` (the port imports nothing of
``repro``): the reference's names, constants and arithmetic, in its
order, so results are bitwise equal to the reference's.

``verify_plan`` checks any :class:`~repro_torch.core.plan.WaferPlan` /
:class:`~repro_torch.core.plan.ServePlan` / :class:`~repro_torch.core.plan.
MultiWaferPlan` purely from its recorded fields (plus, optionally, the
live :class:`~repro_torch.wafer.topology.Wafer` and the
:class:`~repro_torch.configs.base.ModelConfig` it was solved for):

* degree products vs the alive-die count,
* ``device_order`` is a bijection over the alive-die snake order,
* predicted memory vs per-die HBM — train: the weights/grad/optimizer
  *fixed floor* from :func:`repro_torch.wafer.simulator.memory_components`
  must fit (activations can shrink via microbatching; the floor cannot);
  serve: weights + ``kv_budget_tokens``-scaled cache + workspace from
  :func:`repro_torch.wafer.simulator.decode_memory_components`, and the
  ``kv_budget_capped`` flag must agree with the budget,
* pipeline-schedule legality (GPipe/1F1B in-flight caps vs ``n_micro``),
* ``PLAN_VERSION`` staleness,
* for on-disk entries (:func:`verify_plan_file`): JSON-schema validity,
  the recomputed ``plan_hash`` against the raw bytes, and the cache-key
  filename consistency.

Memory checks are *consistency* checks, not feasibility checks: a plan
that genuinely cannot fit is legal as long as ``predicted["oom"]`` says
so — the invariant is that no plan silently claims to fit when the
recorded numbers prove it cannot.  When no live wafer is provided the
hardware constants fall back to the default WaferSpec and every
spec-dependent finding is demoted to ``warning`` (non-default
deployments would otherwise false-positive).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional, Sequence, Union

from repro_torch.analysis.schema import plan_kind, validate_plan_json
from repro_torch.analysis.violations import (SEV_ERROR, SEV_WARNING,
                                       PlanVerificationError, Violation,
                                       errors)
from repro_torch.core.plan import (PLAN_VERSION, MultiWaferPlan, ServePlan,
                             WaferPlan, multiwafer_cache_key,
                             plan_cache_key)

AnyPlan = Union[WaferPlan, ServePlan, MultiWaferPlan]

_REL_EPS = 1e-6  # float-accumulation slack on byte comparisons


def _v(code: str, message: str, severity: str = SEV_ERROR,
       path: str = "") -> Violation:
    return Violation(code=code, message=message, severity=severity,
                     path=path)


def resolve_cfg(arch: str):
    """Best-effort ModelConfig for a plan's recorded arch id.

    Multi-wafer stage plans carry ``<arch>#stage<i>``; bench-local archs
    (``gpt3-6.7b``, ``*-smoke``) are not in the registry — cfg-dependent
    checks are simply skipped for them.
    """
    from repro_torch.configs import get_config
    base = arch.split("#", 1)[0]
    try:
        return get_config(base)
    except Exception:
        return None


def _wafer_for(plan: WaferPlan, wafer) -> tuple[object, bool]:
    """(wafer object to check against, spec_is_live).  Falls back to the
    plan's own grid-only record (default WaferSpec) when no live wafer is
    given — spec-dependent findings then demote to warnings."""
    if wafer is not None:
        return wafer, True
    return plan.wafer(), False


def verify_plan(plan: AnyPlan, wafer=None, cfg=None) -> list[Violation]:
    """Statically verify one plan IR.  Returns all findings (empty list =
    clean).  ``wafer`` is the live wafer (or, for a MultiWaferPlan, the
    sequence of live wafers); ``cfg`` the ModelConfig it was solved for —
    both optional, both enable deeper checks when present."""
    if isinstance(plan, ServePlan):
        return _verify_serve_plan(plan, wafer, cfg)
    if isinstance(plan, MultiWaferPlan):
        return _verify_multiwafer_plan(plan, wafer, cfg)
    return _verify_wafer_plan(plan, wafer, cfg)


def assert_plan_valid(plan: AnyPlan, wafer=None, cfg=None) -> None:
    """Raise :class:`PlanVerificationError` on any error-severity finding
    (the compile pipelines call this between solve and cache write)."""
    bad = errors(verify_plan(plan, wafer, cfg))
    if bad:
        raise PlanVerificationError(bad)


# ---------------------------------------------------------------------------
# WaferPlan
# ---------------------------------------------------------------------------


def _verify_wafer_plan(plan: WaferPlan, wafer=None, cfg=None, *,
                       check_train_mem: bool = True,
                       tag: str = "") -> list[Violation]:
    out: list[Violation] = []
    p = tag and tag + ": " or ""

    if plan.version != PLAN_VERSION:
        out.append(_v("plan/version-stale",
                      f"{p}plan version {plan.version} != runtime "
                      f"PLAN_VERSION {PLAN_VERSION}; the entry predates a "
                      f"cache-identity bump and must be re-solved"))

    n_grid = plan.wafer_rows * plan.wafer_cols
    alive = plan.alive_dies
    failed = set(plan.failed_dies)
    if not alive:
        out.append(_v("plan/alive-dies-inconsistent",
                      f"{p}plan records no alive dies"))
        return out
    bad_range = [d for d in alive if not 0 <= d < n_grid]
    dead_alive = sorted(set(alive) & failed)
    if bad_range or dead_alive:
        out.append(_v("plan/alive-dies-inconsistent",
                      f"{p}alive dies out of grid {bad_range} / "
                      f"marked failed {dead_alive}"))

    degs = plan.degrees_tuple()
    if any(d < 1 for d in degs) or (plan.seq_par and plan.tp <= 1):
        out.append(_v("plan/degree-invalid",
                      f"{p}illegal degrees (dp,tp,sp,tatp)={degs} "
                      f"seq_par={plan.seq_par}"))
    elif plan.total_degree > len(alive):
        out.append(_v("plan/degree-oversubscribed",
                      f"{p}degree product {plan.total_degree} exceeds the "
                      f"{len(alive)} alive dies "
                      f"(dp,tp,sp,tatp)={degs}"))

    out += _check_device_order(plan, p)
    out += _check_memory(plan, wafer, cfg,
                         check_train_mem=check_train_mem, p=p)
    return out


def _check_device_order(plan: WaferPlan, p: str) -> list[Violation]:
    from repro_torch.wafer import mapping as wmap
    order = plan.device_order
    alive = plan.alive_dies
    if len(set(order)) != len(order) or set(order) != set(alive):
        return [_v("plan/device-order-not-bijective",
                   f"{p}device_order is not a bijection over the "
                   f"{len(alive)} alive dies ({len(order)} entries, "
                   f"{len(set(order))} distinct, "
                   f"{len(set(order) & set(alive))} alive)")]
    base = (wmap.snake_order(plan.wafer_rows, plan.wafer_cols)
            if plan.engine in ("tcme", "snake")
            else wmap.rowmajor_order(plan.wafer_rows, plan.wafer_cols))
    live = set(alive)
    expected = tuple(d for d in base if d in live)
    if tuple(order) != expected:
        return [_v("plan/device-order-not-snake",
                   f"{p}device_order deviates from the alive-die "
                   f"{'snake' if plan.engine in ('tcme', 'snake') else 'row-major'} "
                   f"order of engine={plan.engine}")]
    return []


def _check_memory(plan: WaferPlan, wafer, cfg, *,
                  check_train_mem: bool, p: str) -> list[Violation]:
    out: list[Violation] = []
    wobj, live_spec = _wafer_for(plan, wafer)
    sev = SEV_ERROR if live_spec else SEV_WARNING
    cap = wobj.spec.hbm_cap
    pred = plan.predicted or {}
    mem = pred.get("mem_per_die")
    oom = bool(pred.get("oom"))
    if mem is not None and mem > cap * (1 + _REL_EPS) and not oom:
        out.append(_v("plan/mem-flag-inconsistent",
                      f"{p}predicted mem_per_die {mem / 1e9:.2f} GB "
                      f"exceeds hbm_cap {cap / 1e9:.2f} GB but "
                      f"predicted['oom'] is False", sev))
    if not (check_train_mem and cfg is not None):
        return out
    try:
        from repro_torch.wafer.simulator import (STRATEGY_SPACES,
                                           StepCostContext,
                                           memory_components)
        space = STRATEGY_SPACES.get(plan.space)
        if space is None:
            out.append(_v("plan/space-unknown",
                          f"{p}unknown strategy space "
                          f"{plan.space!r}", sev))
            return out
        ctx = StepCostContext(wobj, cfg, plan.batch, plan.seq,
                              plan.engine, fsdp=space["fsdp"],
                              dies=list(plan.alive_dies))
        fixed, _act_full, _ = memory_components(
            ctx, plan.parallel_degrees())
    except Exception as e:  # cfg/wafer mismatch — report, don't crash
        return out + [_v("plan/mem-check-failed",
                         f"{p}memory recompute failed: {e!r}",
                         SEV_WARNING)]
    if fixed > cap * (1 + _REL_EPS) and not oom:
        out.append(_v("plan/mem-fixed-over-hbm",
                      f"{p}weights/grad/optimizer floor "
                      f"{fixed / 1e9:.2f} GB/die exceeds hbm_cap "
                      f"{cap / 1e9:.2f} GB (microbatching cannot "
                      f"rescue it) but predicted['oom'] is False", sev))
    if mem is not None and mem * (1 + _REL_EPS) < fixed:
        out.append(_v("plan/mem-under-floor",
                      f"{p}predicted mem_per_die {mem / 1e9:.2f} GB is "
                      f"below the weights/optimizer floor "
                      f"{fixed / 1e9:.2f} GB — the record was "
                      f"tampered with or the model changed",
                      SEV_WARNING))
    return out


# ---------------------------------------------------------------------------
# ServePlan
# ---------------------------------------------------------------------------


def _verify_serve_plan(plan: ServePlan, wafer=None,
                       cfg=None) -> list[Violation]:
    out: list[Violation] = []
    if plan.version != PLAN_VERSION:
        out.append(_v("plan/version-stale",
                      f"serve plan version {plan.version} != runtime "
                      f"PLAN_VERSION {PLAN_VERSION}"))
    # the inner decode mesh: structural checks only (its memory story is
    # the serving contract below, not the training split)
    out += _verify_wafer_plan(plan.plan, wafer, None,
                              check_train_mem=False, tag="decode mesh")

    if plan.max_batch < 1 or plan.max_seq < 1 or plan.prefill_chunk < 1:
        out.append(_v("serve/contract-invalid",
                      f"max_batch={plan.max_batch} "
                      f"max_seq={plan.max_seq} "
                      f"prefill_chunk={plan.prefill_chunk} must all "
                      f"be >= 1"))
        return out

    pred = plan.predicted or {}
    oom = bool(pred.get("oom"))
    capped = bool(pred.get("kv_budget_capped"))
    full_budget = plan.max_batch * plan.max_seq
    if plan.kv_budget_tokens > full_budget:
        out.append(_v("serve/kv-budget-overflow",
                      f"kv_budget_tokens {plan.kv_budget_tokens} exceeds "
                      f"max_batch*max_seq = {full_budget}"))
    elif plan.kv_budget_tokens < full_budget and not capped:
        out.append(_v("serve/kv-cap-flag",
                      f"kv_budget_tokens {plan.kv_budget_tokens} < "
                      f"max_batch*max_seq = {full_budget} but "
                      f"predicted['kv_budget_capped'] is False"))
    elif capped and plan.kv_budget_tokens == full_budget:
        out.append(_v("serve/kv-cap-flag",
                      "kv_budget_capped is True but the budget is the "
                      "full max_batch*max_seq", SEV_WARNING))
    if plan.kv_budget_tokens < plan.max_seq and not oom:
        out.append(_v("serve/kv-budget-too-small",
                      f"kv_budget_tokens {plan.kv_budget_tokens} cannot "
                      f"hold one max-context request "
                      f"(max_seq={plan.max_seq}) yet the plan does not "
                      f"report OOM"))

    lay = dict(plan.kv_layout)
    inner = plan.plan
    if (lay.get("dp") != inner.dp or lay.get("sp") != inner.sp
            or lay.get("tatp") != inner.tatp
            or lay.get("tp", 1) > inner.tp):
        out.append(_v("serve/kv-layout-mismatch",
                      f"kv_layout {lay} disagrees with the decode mesh "
                      f"degrees (dp,tp,sp,tatp)={inner.degrees_tuple()}"))

    out += _check_expert_parallel(plan, cfg)
    out += _check_serve_memory(plan, wafer, cfg)
    return out


def _check_expert_parallel(plan: ServePlan, cfg) -> list[Violation]:
    """EP legality: degree divisibility, placement partition shape, and
    recorded all-to-all volume.  Placement must be exactly ``ep``
    disjoint non-empty die groups drawn from the alive set (a corrupted
    bijection would route dispatches to dies that host no experts)."""
    out: list[Violation] = []
    ep = plan.ep
    inner = plan.plan
    if ep < 1:
        return [_v("serve/ep-invalid", f"ep={ep} must be >= 1")]
    if ep == 1:
        if plan.expert_placement:
            out.append(_v("serve/ep-placement-invalid",
                          f"ep=1 plan records a non-empty "
                          f"expert_placement "
                          f"({len(plan.expert_placement)} groups)"))
        if plan.a2a_bytes_per_token:
            out.append(_v("serve/ep-a2a-mismatch",
                          f"ep=1 plan records a2a_bytes_per_token="
                          f"{plan.a2a_bytes_per_token}", SEV_WARNING))
        return out

    if inner.dp % ep:
        out.append(_v("serve/ep-invalid",
                      f"ep={ep} does not divide dp={inner.dp}: expert "
                      f"groups cannot partition the replica positions"))
    if cfg is not None:
        if not getattr(cfg, "is_moe", False):
            out.append(_v("serve/ep-invalid",
                          f"ep={ep} on a dense model ({inner.arch})"))
        elif cfg.n_experts % ep:
            out.append(_v("serve/ep-invalid",
                          f"ep={ep} does not divide "
                          f"n_experts={cfg.n_experts}"))

    pl = plan.expert_placement
    if len(pl) != ep:
        out.append(_v("serve/ep-placement-invalid",
                      f"expert_placement has {len(pl)} groups, "
                      f"expected ep={ep}"))
        return out
    empty = [g for g, grp in enumerate(pl) if not grp]
    alive = set(inner.alive_dies)
    flat = [d for grp in pl for d in grp]
    dups = len(flat) != len(set(flat))
    stray = sorted(set(flat) - alive)
    if empty or dups or stray:
        parts = []
        if empty:
            parts.append(f"empty groups {empty}")
        if dups:
            parts.append("dies shared between groups")
        if stray:
            parts.append(f"dies outside the alive set {stray}")
        out.append(_v("serve/ep-placement-invalid",
                      f"expert_placement is not a disjoint partition of "
                      f"alive dies: " + "; ".join(parts)))

    if cfg is not None and getattr(cfg, "is_moe", False) \
            and cfg.n_experts % ep == 0:
        from repro_torch.wafer.simulator import BYTES_ACT
        want = 2 * cfg.top_k * cfg.d_model * BYTES_ACT * (ep - 1) / ep
        if abs(plan.a2a_bytes_per_token - want) > want * 1e-6 + 1e-9:
            out.append(_v("serve/ep-a2a-mismatch",
                          f"recorded a2a_bytes_per_token "
                          f"{plan.a2a_bytes_per_token:.1f} != "
                          f"{want:.1f} derived from top_k/d_model/ep",
                          SEV_WARNING))
    return out


def _check_serve_memory(plan: ServePlan, wafer, cfg) -> list[Violation]:
    out: list[Violation] = []
    wobj, live_spec = _wafer_for(plan.plan, wafer)
    sev = SEV_ERROR if live_spec else SEV_WARNING
    cap = wobj.spec.hbm_cap
    pred = plan.predicted or {}
    mem = pred.get("mem_per_die")
    oom = bool(pred.get("oom"))
    if mem is not None and mem > cap * (1 + _REL_EPS) and not oom:
        out.append(_v("plan/mem-flag-inconsistent",
                      f"predicted mem_per_die {mem / 1e9:.2f} GB exceeds "
                      f"hbm_cap {cap / 1e9:.2f} GB but predicted['oom'] "
                      f"is False", sev))
    if cfg is None:
        return out
    try:
        from repro_torch.wafer.simulator import (StepCostContext,
                                           decode_memory_components)
        ctx = StepCostContext(wobj, cfg, plan.max_batch, plan.max_seq,
                              plan.plan.engine,
                              dies=list(plan.plan.alive_dies),
                              objective="decode")
        # decode_degrees() folds the serve plan's ep into the weight
        # split — per-die expert shards are checked at their EP size
        w, cache_full, ws = decode_memory_components(
            ctx, plan.decode_degrees())
    except Exception as e:
        return out + [_v("plan/mem-check-failed",
                         f"serve memory recompute failed: {e!r}",
                         SEV_WARNING)]
    frac = plan.kv_budget_tokens / (plan.max_batch * plan.max_seq)
    kv_at_budget = cache_full * frac
    total = w + kv_at_budget + ws
    if total > cap * (1 + _REL_EPS) and not oom:
        out.append(_v("serve/kv-over-hbm",
                      f"weights {w / 1e9:.2f} + KV@budget "
                      f"{kv_at_budget / 1e9:.2f} + workspace "
                      f"{ws / 1e9:.2f} GB/die = {total / 1e9:.2f} GB "
                      f"exceeds hbm_cap {cap / 1e9:.2f} GB and the "
                      f"budget is not capped to fit "
                      f"(kv_budget_tokens={plan.kv_budget_tokens})",
                      sev))
    if cache_full > 0 and abs(plan.kv_bytes_per_die - kv_at_budget) \
            > kv_at_budget * 1e-3 + 1.0:
        out.append(_v("serve/kv-bytes-mismatch",
                      f"recorded kv_bytes_per_die "
                      f"{plan.kv_bytes_per_die / 1e9:.3f} GB != "
                      f"budget-scaled cache {kv_at_budget / 1e9:.3f} GB",
                      SEV_WARNING))
    return out


# ---------------------------------------------------------------------------
# MultiWaferPlan
# ---------------------------------------------------------------------------


def _verify_multiwafer_plan(plan: MultiWaferPlan, wafers=None,
                            cfg=None) -> list[Violation]:
    out: list[Violation] = []
    if plan.version != PLAN_VERSION:
        out.append(_v("plan/version-stale",
                      f"multi-wafer plan version {plan.version} != "
                      f"runtime PLAN_VERSION {PLAN_VERSION}"))
    pp = plan.pp
    if not (len(plan.stages) == len(plan.stage_layers)
            == len(plan.stage_wafer) == pp) or pp < 1:
        out.append(_v("mw/stage-count-mismatch",
                      f"pp={pp} but {len(plan.stages)} stages, "
                      f"{len(plan.stage_layers)} layer entries, "
                      f"{len(plan.stage_wafer)} wafer entries"))
        return out
    if any(not 0 <= w < plan.n_wafers for w in plan.stage_wafer):
        out.append(_v("mw/stage-count-mismatch",
                      f"stage_wafer {list(plan.stage_wafer)} references "
                      f"wafers outside 0..{plan.n_wafers - 1}"))
    if any(n < 1 for n in plan.stage_layers):
        out.append(_v("mw/layer-split-invalid",
                      f"every stage needs >= 1 layer, got "
                      f"{list(plan.stage_layers)}"))
    if cfg is not None and sum(plan.stage_layers) != cfg.n_layers:
        out.append(_v("mw/layer-split-invalid",
                      f"stage_layers sum to {sum(plan.stage_layers)} "
                      f"but the model has {cfg.n_layers} layers"))

    out += _check_pipeline_schedule(plan)

    # stages sharing a wafer must own disjoint die subsets
    by_wafer: dict[int, dict[int, int]] = {}
    for s, w in enumerate(plan.stage_wafer):
        owner = by_wafer.setdefault(w, {})
        for d in plan.stages[s].alive_dies:
            if d in owner:
                out.append(_v("mw/stage-dies-overlap",
                              f"die {d} on wafer {w} is owned by both "
                              f"stage {owner[d]} and stage {s}"))
                break
            owner[d] = s

    # per-stage structural checks (stage cfg = the stage's layer slice)
    stage_cfgs = [None] * pp
    if cfg is not None:
        try:
            from repro_torch.wafer.solver import stage_config
            stage_cfgs = [stage_config(cfg, n) for n in plan.stage_layers]
        except Exception:
            stage_cfgs = [None] * pp
    for s, stage in enumerate(plan.stages):
        w = None
        if wafers is not None and 0 <= plan.stage_wafer[s] < len(wafers):
            w = wafers[plan.stage_wafer[s]]
        out += _verify_wafer_plan(stage, w, stage_cfgs[s],
                                  tag=f"stage{s}")

    # recorded per-stage memory vs recorded per-stage caps
    pred = plan.predicted or {}
    mems = pred.get("stage_mem")
    caps = pred.get("stage_hbm_cap")
    oom = bool(pred.get("oom"))
    if mems and caps and len(mems) == len(caps) == pp and not oom:
        over = [s for s in range(pp)
                if mems[s] > caps[s] * (1 + _REL_EPS)]
        if over:
            out.append(_v("mw/mem-flag-inconsistent",
                          f"stage_mem exceeds stage_hbm_cap on stages "
                          f"{over} but predicted['oom'] is False"))
    return out


def _check_pipeline_schedule(plan: MultiWaferPlan) -> list[Violation]:
    if plan.family not in ("gpipe", "1f1b") or plan.n_micro < 1:
        return [_v("mw/schedule-illegal",
                   f"family={plan.family!r} n_micro={plan.n_micro} is "
                   f"not an executable pipeline schedule")]
    try:
        from repro_torch.core.schedule import pipeline_schedule, simulate_pipeline
        rep = simulate_pipeline(
            pipeline_schedule(plan.family, plan.pp, plan.n_micro))
    except Exception as e:
        return [_v("mw/schedule-illegal",
                   f"{plan.family} pp={plan.pp} n_micro={plan.n_micro} "
                   f"does not replay: {e!r}")]
    out = []
    for s, k in enumerate(rep.inflight_per_stage):
        cap = (plan.n_micro if plan.family == "gpipe"
               else min(plan.pp - s, plan.n_micro))
        if k > cap:
            out.append(_v("mw/schedule-illegal",
                          f"stage {s} holds {k} in-flight microbatches; "
                          f"{plan.family} caps it at {cap}"))
    peak = (plan.predicted or {}).get("peak_inflight")
    if peak is not None and peak != rep.peak_inflight:
        out.append(_v("mw/inflight-mismatch",
                      f"recorded peak_inflight {peak} != replayed "
                      f"{rep.peak_inflight}", SEV_WARNING))
    return out


# ---------------------------------------------------------------------------
# on-disk entries: schema + hash + cache-key + plan checks
# ---------------------------------------------------------------------------

_LOADERS = {"plan": WaferPlan, "splan": ServePlan,
            "mwplan": MultiWaferPlan}


def _raw_plan_hash(raw: dict, kind: str) -> str:
    """Recompute the executable-surface hash straight from the raw JSON
    document (the exact recipe of ``<Plan>.plan_hash``): any field the
    loader would drop or normalize shows up as a hash mismatch."""
    d = dict(raw)
    d.pop("predicted", None)
    d.pop("solver", None)
    if kind == "splan":
        d["plan"] = _raw_plan_hash(raw.get("plan", {}), "plan")
    elif kind == "mwplan":
        d["stages"] = [_raw_plan_hash(s, "plan")
                       for s in raw.get("stages", ())]
    blob = json.dumps(d, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _expected_cache_key(plan: AnyPlan, kind: str) -> Optional[str]:
    """Recompute the cache key a ``compile_*`` call would derive for this
    plan's recorded identity.  The WaferSpec is NOT recorded in the plan,
    so this uses the default spec — a mismatch is therefore only a
    warning (non-default-spec deployments legitimately mismatch)."""
    if kind == "plan":
        p = plan
        knobs = (p.stream, p.bidirectional, p.stream_dtype, p.remat)
    elif kind == "splan":
        p = plan.plan
        knobs = ("decode", plan.stream_dtype, plan.prefill_chunk,
                 (plan.solver or {}).get("allow_ep", True))
    else:
        return None  # mwplan keys need the full per-wafer fault union
    return plan_cache_key(p.arch, p.batch, p.seq, p.wafer(),
                          list(p.alive_dies), engine=p.engine,
                          space=p.space, knobs=knobs)


def verify_plan_file(path: str, wafer=None, cfg=None, *,
                     resolve_config: bool = True
                     ) -> tuple[Optional[AnyPlan], list[Violation]]:
    """Verify one on-disk plan entry.  Returns ``(plan, violations)``;
    ``plan`` is None when the file cannot even be loaded."""
    out: list[Violation] = []
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return None, [Violation(code="file/unparseable",
                                message=f"cannot parse: {e!r}",
                                severity=SEV_ERROR, path=path)]
    kind = plan_kind(raw, path)
    if kind is None:
        return None, [Violation(code="file/schema",
                                message="not a recognizable plan IR",
                                severity=SEV_ERROR, path=path)]
    out += validate_plan_json(raw, kind, path)
    try:
        plan = _LOADERS[kind].from_dict(raw)
    except Exception as e:
        out.append(Violation(code="file/schema",
                             message=f"from_dict failed: {e!r}",
                             severity=SEV_ERROR, path=path))
        return None, out

    if plan.plan_hash != _raw_plan_hash(raw, kind):
        out.append(Violation(
            code="file/hash-drift",
            message=f"recomputed plan_hash {plan.plan_hash} does not "
                    f"match the raw on-disk executable surface — the "
                    f"entry was hand-edited or lossily round-tripped",
            severity=SEV_ERROR, path=path))

    base = os.path.basename(path)
    stem = base[len(kind) + 1:].split(".")[0]
    key = _expected_cache_key(plan, kind)
    if key is not None and stem and stem != key:
        out.append(Violation(
            code="file/cache-key-mismatch",
            message=f"filename key {stem} != recomputed default-spec "
                    f"key {key} (benign iff the plan was compiled for "
                    f"a non-default WaferSpec or different knobs)",
            severity=SEV_WARNING, path=path))

    arch = plan.arch if not isinstance(plan, MultiWaferPlan) else plan.arch
    if cfg is None and resolve_config:
        cfg = resolve_cfg(arch)
    pv = verify_plan(plan, wafer, cfg)
    out += [Violation(code=v.code, message=v.message,
                      severity=v.severity, path=path, line=v.line,
                      rule=v.rule) for v in pv]
    return plan, out


def verify_cache_dir(cache_dir: str, *, quarantine: bool = False,
                     resolve_config: bool = True
                     ) -> tuple[int, list[Violation]]:
    """Verify every ``plan_*.json`` / ``splan_*.json`` / ``mwplan_*.json``
    under ``cache_dir``.  With ``quarantine=True``, entries with
    error-severity findings are renamed to ``*.bad`` (the compile
    pipeline will re-solve on the next miss) and their findings demoted
    to ``file/quarantined`` warnings — the surviving cache is healthy.

    Returns ``(n_entries_checked, violations)``.
    """
    if not os.path.isdir(cache_dir):
        return 0, []
    out: list[Violation] = []
    n = 0
    for base in sorted(os.listdir(cache_dir)):
        if not base.endswith(".json"):
            continue
        if plan_kind({}, base) is None:
            continue
        path = os.path.join(cache_dir, base)
        _plan, vs = verify_plan_file(path, resolve_config=resolve_config)
        n += 1
        if quarantine and errors(vs):
            try:
                os.replace(path, path + ".bad")
            except OSError:
                out += vs
                continue
            detail = "; ".join(f"[{v.code}] {v.message}"
                               for v in errors(vs))
            out.append(Violation(
                code="file/quarantined",
                message=f"quarantined to {base}.bad: {detail}",
                severity=SEV_WARNING, path=path))
            out += warnings_only(vs)
        else:
            out += vs
    return n, out


def warnings_only(vs: Sequence[Violation]) -> list[Violation]:
    return [v for v in vs if v.severity == SEV_WARNING]


__all__ = [
    "verify_plan", "assert_plan_valid", "verify_plan_file",
    "verify_cache_dir", "resolve_cfg", "PlanVerificationError",
    "multiwafer_cache_key",
]
