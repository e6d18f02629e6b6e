"""WaferPlan IR — the compiled artifact between the solver and the runtime.

Copy of ``repro.core.plan`` (the port imports nothing of ``repro``): the
reference's names, constants and arithmetic, in its order, so results
are bitwise equal to the reference's.

The paper's pipeline is solve-then-run: DLWS picks the parallel degrees,
TCME embeds the rings, and the TATP runtime executes them.  ``WaferPlan``
is the serializable contract between those halves: everything a launch
needs to reproduce the solved mapping —

* the parallel degrees per axis (dp/tp/sp/tatp + the Megatron-3 flag),
* the mapping engine and the snake **device order** it implies
  (``device_order_for_jax`` consumes it to permute ``jax.make_mesh``),
* the stream policy (weights/inputs/auto), orchestration direction and
  wire codec of the TATP streams,
* the schedule family and remat policy for the executable step,
* the solver's predicted memory/throughput (so a launch can sanity-check
  the wafer it lands on against what was solved for).

``compile_plan`` runs the full pipeline — ``dlws_solve`` →
``hierarchical_map`` (the TCME embedding) → plan — and caches the result
on disk keyed on ``(arch, shape, wafer, alive-die subset)``: repeated
launches skip the search, and a degraded wafer (different alive dies)
misses the cache and re-solves automatically.  ``PLAN_STATS`` counts
solver calls vs cache hits so tests and launch logs can verify which path
ran.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Callable, Optional, Sequence

if TYPE_CHECKING:  # annotation-only: runtime imports stay lazy/cycle-free
    from repro_torch.configs.base import ModelConfig, ParallelConfig
    from repro_torch.core.schedule import PipelineSchedule
    from repro_torch.wafer.simulator import ParallelDegrees
    from repro_torch.wafer.topology import Wafer

# v2: GA legality fix (subset totals) changes solver output — the bump
# changes every cache key so pre-fix on-disk plans miss and re-solve
# v3: plan_cache_key now folds the full WaferSpec into the identity (it
# keyed only on the grid shape before, so non-default-spec deployments
# could alias default-spec entries) — the bump retires every pre-spec key
# v4: expert-parallel decode (ep axis + expert placement + a2a pricing +
# the distinct-expert HBM read model) changes every MoE decode solve and
# grows the ServePlan surface — pre-EP serve plans miss and re-solve
PLAN_VERSION = 4

# observable pipeline counters (reset via reset_plan_stats; the launch
# drivers print them so "second run hit the cache" is checkable from logs)
PLAN_STATS = {"solver_calls": 0, "cache_hits": 0, "cache_misses": 0,
              "quarantined": 0}


def reset_plan_stats() -> None:
    for k in PLAN_STATS:
        PLAN_STATS[k] = 0


@dataclass(frozen=True)
class WaferPlan:
    """Executable launch plan compiled from one DLWS solution."""

    # workload identity
    arch: str
    batch: int
    seq: int
    # wafer identity (enough to rebuild the Wafer and check degradation)
    wafer_rows: int
    wafer_cols: int
    failed_dies: tuple[int, ...]
    failed_links: tuple[tuple[int, int], ...]
    alive_dies: tuple[int, ...]
    # solved configuration
    dp: int
    tp: int
    sp: int
    tatp: int
    seq_par: bool
    engine: str  # smap | gmap | tcme
    space: str  # strategy space the solve ran in (STRATEGY_SPACES key)
    device_order: tuple[int, ...]  # snake/row-major order over alive dies
    # stream policy + executable knobs
    stream: str = "auto"  # TATP selective transfer: weights | inputs | auto
    bidirectional: bool = True
    stream_dtype: str = "native"  # wire codec of the TATP streams
    schedule: str = "bidir_ring"  # bidir_ring | tspp_line
    remat: bool = True
    # solver outputs (advisory: what the plan was predicted to achieve)
    predicted: dict = field(default_factory=dict)
    solver: dict = field(default_factory=dict)
    version: int = PLAN_VERSION

    # ------------------------------------------------------------------
    # identity
    # ------------------------------------------------------------------
    @property
    def total_degree(self) -> int:
        return self.dp * self.tp * self.sp * self.tatp

    def degrees_tuple(self) -> tuple[int, int, int, int]:
        return (self.dp, self.tp, self.sp, self.tatp)

    @property
    def plan_hash(self) -> str:
        """Content hash of the executable surface (solver telemetry and
        predictions excluded): two plans with the same hash launch the
        same system."""
        d = self.to_dict()
        d.pop("predicted", None)
        d.pop("solver", None)
        blob = json.dumps(d, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    # ------------------------------------------------------------------
    # serialization
    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["failed_links"] = [list(l) for l in self.failed_links]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "WaferPlan":
        d = dict(d)
        if d.get("version", PLAN_VERSION) > PLAN_VERSION:
            raise ValueError(f"plan version {d['version']} is newer than "
                             f"this runtime ({PLAN_VERSION})")
        d["failed_dies"] = tuple(d.get("failed_dies", ()))
        d["failed_links"] = tuple(tuple(l) for l in d.get("failed_links", ()))
        d["alive_dies"] = tuple(d.get("alive_dies", ()))
        d["device_order"] = tuple(d.get("device_order", ()))
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def dumps(self) -> str:
        return json.dumps(self.to_dict(), indent=1, sort_keys=True)

    @classmethod
    def loads(cls, s: str) -> "WaferPlan":
        return cls.from_dict(json.loads(s))

    def dump(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.dumps())
        os.replace(tmp, path)  # atomic publish (mirrors checkpoint.save)
        return path

    @classmethod
    def load(cls, path: str) -> "WaferPlan":
        with open(path) as f:
            return cls.loads(f.read())

    # ------------------------------------------------------------------
    # executable views
    # ------------------------------------------------------------------
    def wafer(self) -> "Wafer":
        """Rebuild the Wafer this plan was solved for."""
        from repro_torch.wafer.topology import Wafer, WaferSpec
        return Wafer(WaferSpec(rows=self.wafer_rows, cols=self.wafer_cols),
                     frozenset(self.failed_dies),
                     frozenset(tuple(l) for l in self.failed_links))

    def parallel_degrees(self) -> "ParallelDegrees":
        from repro_torch.wafer.simulator import ParallelDegrees
        return ParallelDegrees(self.dp, self.tp, self.sp, self.tatp,
                               seq_par=self.seq_par)

    def parallel_config(self) -> "ParallelConfig":
        """The runnable-side ParallelConfig this plan prescribes."""
        from repro_torch.configs.base import ParallelConfig
        if self.space == "fsdp":
            strategy = "fsdp"
        elif self.tatp > 1 or self.tp <= 1:
            strategy = "tatp"
        else:
            strategy = "megatron"
        return ParallelConfig(
            dp=self.dp, tp=self.tp, sp=self.sp, tatp=self.tatp,
            strategy=strategy, stream=self.stream,
            bidirectional=self.bidirectional, stream_dtype=self.stream_dtype,
            remat=self.remat)

    def mesh_shape_for(self, n_devices: int) -> tuple[int, int]:
        """(data, model) mesh shape on ``n_devices`` actual devices.

        The runnable system maps the TATP ring onto the ``model`` axis and
        everything batch-like onto ``data``.  When the launch has fewer
        devices than the plan's wafer (elastic restart, CPU smoke runs),
        the ring degree shrinks to the largest divisor of the device count
        that still divides the planned degree — same rings, fewer of them.
        """
        model = max(1, self.tatp)
        if n_devices % model:
            model = math.gcd(n_devices, model) or 1
        model = min(model, n_devices)
        return (n_devices // model, model)

    def summary(self) -> str:
        pred = self.predicted or {}
        thr = pred.get("throughput")
        mem = pred.get("mem_per_die")
        parts = [
            f"WaferPlan[{self.plan_hash}] {self.arch} "
            f"batch={self.batch} seq={self.seq}",
            f"  wafer {self.wafer_rows}x{self.wafer_cols} "
            f"alive={len(self.alive_dies)}/"
            f"{self.wafer_rows * self.wafer_cols}",
            f"  degrees (dp,tp,sp,tatp)={self.degrees_tuple()} "
            f"seq_par={self.seq_par} engine={self.engine} "
            f"space={self.space}",
            f"  stream={self.stream} codec={self.stream_dtype} "
            f"schedule={self.schedule} remat={self.remat}",
        ]
        if thr is not None:
            parts.append(
                f"  predicted {thr / 1e6:.2f} Mtok/s, "
                f"{(mem or 0) / 1e9:.1f} GB/die "
                f"({self.solver.get('method', '?')}, "
                f"{self.solver.get('evaluated', 0)} sims in "
                f"{self.solver.get('search_time_s', 0):.2f}s)")
        return "\n".join(parts)


# ---------------------------------------------------------------------------
# cache key + compile pipeline
# ---------------------------------------------------------------------------


def plan_cache_key(arch: str, batch: int, seq: int, wafer: "Wafer",
                   dies: Optional[Sequence[int]] = None, *,
                   engine: str = "tcme", space: str = "temp",
                   knobs: tuple = ()) -> str:
    """Cache identity: (arch, shape, wafer spec incl. hardware constants,
    faults, alive-die subset, executable knobs).

    Any die death or link failure changes the key, so a degraded wafer can
    never replay a stale plan — the miss forces a re-solve.  The *full*
    :class:`WaferSpec` is part of the identity (not just the grid shape):
    wafers with different HBM caps / link bandwidths / energy constants
    solve to different plans and must not alias one cache entry, so
    non-default-spec deployments share the default cache dir safely.
    ``knobs`` is the tuple of launch-side settings compile_plan bakes into
    the plan (stream/bidirectional/codec/remat): two launches requesting
    different knobs must not alias one cache entry.
    """
    alive = list(dies) if dies is not None else wafer.alive_dies()
    ident = {
        "v": PLAN_VERSION,
        "arch": arch,
        "batch": batch,
        "seq": seq,
        "spec": dataclasses.asdict(wafer.spec),
        "failed_dies": sorted(wafer.failed_dies),
        "failed_links": sorted(list(l) for l in wafer.failed_links),
        "dies": sorted(alive),
        "engine": engine,
        "space": space,
        "knobs": list(knobs),
    }
    blob = json.dumps(ident, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:24]


def default_cache_dir() -> str:
    return os.environ.get("REPRO_PLAN_CACHE",
                          os.path.join("results", "plans"))


def _quarantine(path: str, reason: str) -> None:
    """Retire a bad cache entry (rename to ``*.bad``) so the next lookup
    misses and re-solves; keep the bytes around for a post-mortem."""
    import sys
    try:
        os.replace(path, path + ".bad")
    except OSError:
        return
    PLAN_STATS["quarantined"] += 1
    sys.stderr.write(f"[plan-cache] quarantined {path} -> "
                     f"{os.path.basename(path)}.bad ({reason})\n")


def _read_cached(loader: Callable[[str], Any], path: str,
                 wafer: Any = None, cfg: Any = None) -> Any:
    """Load **and statically verify** one cached plan entry.

    Any failure — truncated/corrupt JSON (``json.JSONDecodeError`` /
    ``TypeError`` out of ``from_dict`` on a half-written dict), a
    newer-version entry, or an error-severity finding from
    :func:`repro_torch.analysis.verify.verify_plan` — quarantines the file and
    returns ``None`` so the caller falls through to a fresh solve.  A
    cached plan is input to a launch: it gets the same verify-before-use
    discipline as a freshly solved one.
    """
    try:
        plan = loader(path)
    except Exception as e:  # corrupt entries raise all over: quarantine all
        _quarantine(path, repr(e))
        return None
    from repro_torch.analysis.verify import verify_plan
    from repro_torch.analysis.violations import errors
    bad = errors(verify_plan(plan, wafer, cfg))
    if bad:
        _quarantine(path, "; ".join(v.code for v in bad))
        return None
    return plan


def _verify_fresh(plan: Any, wafer: Any = None, cfg: Any = None) -> None:
    """Verify a freshly solved plan before it is published to the cache
    (raises :class:`repro_torch.analysis.violations.PlanVerificationError`)."""
    from repro_torch.analysis.verify import assert_plan_valid
    assert_plan_valid(plan, wafer, cfg)


def compile_plan(wafer: "Wafer", cfg: "ModelConfig", batch: int,
                 seq: int, *,
                 arch: Optional[str] = None, engine: str = "tcme",
                 space: str = "temp", dies: Optional[Sequence[int]] = None,
                 stream: str = "auto", bidirectional: bool = True,
                 stream_dtype: str = "native", remat: bool = True,
                 seed: int = 0, tierb: Optional[str] = None,
                 cache_dir: Optional[str] = None,
                 use_cache: bool = True) -> WaferPlan:
    """solve → map → plan, with an on-disk cache around the whole pipeline.

    ``cache_dir=None`` with ``use_cache=True`` uses :func:`default_cache_dir`;
    pass ``use_cache=False`` to force a fresh solve (the plan is still
    written back so the next launch hits).

    ``tierb`` selects the cost-engine Tier-B backend for the solve
    (``"numpy"``/``"torch"``/``"torch:cpu"``, default from
    ``REPRO_TIERB``).  It is *not* part of the cache key: every backend
    produces bitwise-identical solutions (the torch tier is pinned to the
    numpy anchor), so a plan compiled under any backend is the same plan.
    """
    from repro_torch.wafer.solver import dlws_solve

    arch = arch or cfg.name
    cache_dir = cache_dir if cache_dir is not None else default_cache_dir()
    key = plan_cache_key(arch, batch, seq, wafer, dies,
                         engine=engine, space=space,
                         knobs=(stream, bidirectional, stream_dtype, remat))
    path = os.path.join(cache_dir, f"plan_{key}.json")
    if use_cache and os.path.exists(path):
        plan = _read_cached(WaferPlan.load, path, wafer, cfg)
        if plan is not None:
            PLAN_STATS["cache_hits"] += 1
            return plan
    PLAN_STATS["cache_misses"] += 1

    # --- solve (DLWS over the batched cost engine) ------------------------
    PLAN_STATS["solver_calls"] += 1
    sol = dlws_solve(wafer, cfg, batch, seq, engine=engine, space=space,
                     seed=seed, dies=dies, tierb=tierb)
    plan = plan_from_solution(
        wafer, sol, arch=arch, batch=batch, seq=seq, engine=engine,
        space=space, dies=dies, stream=stream, bidirectional=bidirectional,
        stream_dtype=stream_dtype, remat=remat)
    # verify, then publish: a plan that violates its own invariants must
    # never reach the cache or a launch.  Written back even when
    # use_cache=False (a forced fresh solve must replace any stale entry
    # so the next launch hits the new plan).
    _verify_fresh(plan, wafer, cfg)
    plan.dump(path)
    return plan


def plan_from_solution(wafer: "Wafer", sol: Any, *, arch: str,
                       batch: int, seq: int,
                       engine: str, space: str,
                       dies: Optional[Sequence[int]] = None,
                       stream: str = "auto", bidirectional: bool = True,
                       stream_dtype: str = "native",
                       remat: bool = True) -> WaferPlan:
    """map → plan for one already-computed DLWS solution (the tail of
    :func:`compile_plan`, shared with the multi-wafer compiler so stage
    solves are planned without re-running the solver)."""
    from repro_torch.wafer import mapping as wmap
    deg = sol.config
    alive = list(dies) if dies is not None else wafer.alive_dies()
    degrees_map = {a: v for a, v in
                   (("dp", deg.dp), ("tp", deg.tp), ("sp", deg.sp),
                    ("tatp", deg.tatp)) if v > 1} or {"dp": 1}
    wmap.hierarchical_map(wafer, degrees_map, engine)  # validates the embed
    base = (wmap.snake_order(wafer.spec.rows, wafer.spec.cols)
            if engine in ("tcme", "snake")
            else wmap.rowmajor_order(wafer.spec.rows, wafer.spec.cols))
    live = set(alive)
    device_order = tuple(d for d in base if d in live)

    best = sol.best
    return WaferPlan(
        arch=arch, batch=batch, seq=seq,
        wafer_rows=wafer.spec.rows, wafer_cols=wafer.spec.cols,
        failed_dies=tuple(sorted(wafer.failed_dies)),
        failed_links=tuple(sorted(tuple(l) for l in wafer.failed_links)),
        alive_dies=tuple(sorted(alive)),
        dp=deg.dp, tp=deg.tp, sp=deg.sp, tatp=deg.tatp,
        seq_par=deg.seq_par, engine=engine, space=space,
        device_order=device_order,
        stream=stream, bidirectional=bidirectional,
        stream_dtype=stream_dtype,
        schedule="bidir_ring" if bidirectional else "tspp_line",
        remat=remat,
        predicted={
            "throughput": best.throughput,
            "step_time": best.step_time,
            "mem_per_die": best.mem_per_die,
            "power": best.power,
            "oom": best.oom,
        },
        solver={
            "method": sol.method,
            "search_time_s": sol.search_time_s,
            "evaluated": sol.evaluated,
        },
    )


def load_or_compile(plan_path: Optional[str], wafer: "Wafer",
                    cfg: "ModelConfig", batch: int,
                    seq: int, **kw: Any) -> WaferPlan:
    """Launchers' entry: explicit ``--plan`` file wins; otherwise compile
    (or hit the cache) for the wafer at hand."""
    if plan_path:
        return WaferPlan.load(plan_path)
    return compile_plan(wafer, cfg, batch, seq, **kw)


# ---------------------------------------------------------------------------
# serve plans: the decode mesh + KV-cache contract for continuous batching
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ServePlan:
    """Executable serving plan — the decode twin of :class:`WaferPlan`.

    Wraps the decode-objective WaferPlan (mesh degrees, snake device
    order, stream codec — everything a launch needs to build the mesh)
    with the serving-side contract the continuous-batching engine
    executes against:

    * ``max_batch`` — decode slots: the max number of in-flight sequences
      one iteration advances (the jitted decode step's batch shape),
    * ``max_seq`` — per-sequence context budget in tokens (the KV cache's
      sequence dimension),
    * ``kv_layout`` — how the cache shards per axis (dp over batch, sp
      over sequence, tp over KV heads, tatp around the ring),
    * ``kv_bytes_per_die`` / ``kv_budget_tokens`` — the admission budget:
      the scheduler never holds more in-flight cache than the solver
      proved fits beside the weight shard,
    * ``prefill_chunk`` — iteration-level admission granularity (how many
      waiting requests one iteration may prefill into free slots).

    The plan is what makes serve launches go through the same
    solve → plan → execute pipeline as training: ``compile_serve_plan``
    runs ``dlws_solve(objective="decode")`` and caches the result on disk
    keyed on (arch, serving shape, wafer incl. faults, knobs).
    """

    plan: WaferPlan  # decode mesh (solved with objective="decode")
    max_batch: int
    max_seq: int
    kv_layout: tuple[tuple[str, int], ...]
    kv_bytes_per_die: float
    kv_budget_tokens: int
    stream_dtype: str = "native"
    prefill_chunk: int = 4
    # expert parallelism (MoE decode): number of expert groups, the die
    # subset hosting each group (ep disjoint tuples partitioning the
    # mesh; empty when ep == 1), and the dispatch+combine activation
    # bytes one routed token puts on the fabric
    ep: int = 1
    expert_placement: tuple[tuple[int, ...], ...] = ()
    a2a_bytes_per_token: float = 0.0
    predicted: dict = field(default_factory=dict)
    solver: dict = field(default_factory=dict)
    version: int = PLAN_VERSION

    @property
    def plan_hash(self) -> str:
        """Executable-surface hash (telemetry excluded; the inner decode
        mesh contributes through its own ``plan_hash``)."""
        d = self.to_dict()
        d.pop("predicted", None)
        d.pop("solver", None)
        d["plan"] = self.plan.plan_hash
        blob = json.dumps(d, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["plan"] = self.plan.to_dict()
        d["kv_layout"] = [list(kv) for kv in self.kv_layout]
        d["expert_placement"] = [list(g) for g in self.expert_placement]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ServePlan":
        d = dict(d)
        if d.get("version", PLAN_VERSION) > PLAN_VERSION:
            raise ValueError(f"plan version {d['version']} is newer than "
                             f"this runtime ({PLAN_VERSION})")
        d["plan"] = WaferPlan.from_dict(d["plan"])
        d["kv_layout"] = tuple((str(a), int(v))
                               for a, v in d.get("kv_layout", ()))
        d["expert_placement"] = tuple(
            tuple(int(x) for x in grp)
            for grp in d.get("expert_placement", ()))
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def dumps(self) -> str:
        return json.dumps(self.to_dict(), indent=1, sort_keys=True)

    @classmethod
    def loads(cls, s: str) -> "ServePlan":
        return cls.from_dict(json.loads(s))

    def dump(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.dumps())
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "ServePlan":
        with open(path) as f:
            return cls.loads(f.read())

    # -- executable views --------------------------------------------------
    @property
    def arch(self) -> str:
        return self.plan.arch

    def parallel_config(self) -> "ParallelConfig":
        """Decode-time ParallelConfig: the inner plan's, with remat off
        (there is no backward pass to rematerialize for)."""
        return dataclasses.replace(self.plan.parallel_config(), remat=False)

    def decode_degrees(self) -> "ParallelDegrees":
        """The solved decode degree tuple *including* the EP axis (the
        inner WaferPlan only carries the die-consuming dims)."""
        import dataclasses as _dc
        return _dc.replace(self.plan.parallel_degrees(), ep=self.ep)

    def cache_tokens_per_request(self, prompt_len: int,
                                 max_new_tokens: int) -> int:
        """Budget tokens one request consumes while in flight: its full
        context window.  A request over ``max_seq`` can never be admitted
        (the cache's sequence dim physically cannot hold it)."""
        return prompt_len + max_new_tokens

    def summary(self) -> str:
        pred = self.predicted or {}
        parts = [
            f"ServePlan[{self.plan_hash}] {self.plan.arch} "
            f"max_batch={self.max_batch} max_seq={self.max_seq}",
            f"  decode mesh (dp,tp,sp,tatp)={self.plan.degrees_tuple()} "
            f"ep={self.ep} engine={self.plan.engine} "
            f"codec={self.stream_dtype} "
            f"prefill_chunk={self.prefill_chunk}",
            f"  kv {self.kv_bytes_per_die / 1e9:.2f} GB/die "
            f"({self.kv_budget_tokens} budget tokens, layout "
            f"{dict(self.kv_layout)})",
        ]
        if pred.get("token_latency") is not None:
            parts.append(
                f"  predicted {pred['token_latency'] * 1e3:.3f} ms/token, "
                f"{pred.get('tokens_per_s', 0):.0f} tok/s at full batch")
        return "\n".join(parts)


def compile_serve_plan(wafer: "Wafer", cfg: "ModelConfig",
                       max_batch: int, max_seq: int, *,
                       arch: Optional[str] = None, engine: str = "tcme",
                       space: str = "temp",
                       dies: Optional[Sequence[int]] = None,
                       stream_dtype: str = "native",
                       prefill_chunk: int = 4, seed: int = 0,
                       tierb: Optional[str] = None,
                       allow_ep: bool = True,
                       cache_dir: Optional[str] = None,
                       use_cache: bool = True) -> ServePlan:
    """solve(objective="decode") → map → ServePlan, with the same on-disk
    cache discipline as :func:`compile_plan` (any die/link death misses
    and re-solves; ``splan_*.json`` entries never alias train plans).
    ``tierb`` selects the Tier-B backend exactly as in
    :func:`compile_plan` — backend-invariant, so never part of the key.
    ``allow_ep=False`` pins the decode solve to ``ep=1`` (A/B sweeps of
    the EP win); it is a solve knob, so it *is* part of the key."""
    from repro_torch.wafer.simulator import (BYTES_ACT, StepCostContext,
                                       _decode_expert_placement,
                                       _decode_kv_divisors,
                                       decode_memory_components)
    from repro_torch.wafer.solver import dlws_solve

    arch = arch or cfg.name
    cache_dir = cache_dir if cache_dir is not None else default_cache_dir()
    key = plan_cache_key(arch, max_batch, max_seq, wafer, dies,
                         engine=engine, space=space,
                         knobs=("decode", stream_dtype, prefill_chunk,
                                allow_ep))
    path = os.path.join(cache_dir, f"splan_{key}.json")
    if use_cache and os.path.exists(path):
        plan = _read_cached(ServePlan.load, path, wafer, cfg)
        if plan is not None:
            PLAN_STATS["cache_hits"] += 1
            return plan
    PLAN_STATS["cache_misses"] += 1

    PLAN_STATS["solver_calls"] += 1
    sol = dlws_solve(wafer, cfg, max_batch, max_seq, engine=engine,
                     space=space, seed=seed, dies=dies, tierb=tierb,
                     objective="decode", allow_ep=allow_ep)
    inner = plan_from_solution(
        wafer, sol, arch=arch, batch=max_batch, seq=max_seq, engine=engine,
        space=space, dies=dies, stream="auto", bidirectional=True,
        stream_dtype=stream_dtype, remat=False)
    deg = sol.config
    ctx = StepCostContext.resident(wafer, cfg, max_batch, max_seq, engine,
                                   dies=dies, tierb=tierb,
                                   objective="decode")
    _, cache_bytes, _ = decode_memory_components(ctx, deg)
    kv_div, _ = _decode_kv_divisors(cfg, deg.dp, deg.tp, deg.sp, deg.tatp)
    kv_layout = (("dp", deg.dp), ("sp", deg.sp),
                 ("tp", int(min(deg.tp, max(cfg.n_kv_heads, 1)))),
                 ("tatp", deg.tatp))
    # expert-parallel contract: the topology-aware placement the cost
    # model priced (which die subset hosts each expert group) plus the
    # per-token dispatch+combine fabric volume, recorded so the engine
    # and verifier see exactly what the solve chose
    expert_placement: tuple = ()
    a2a_bytes_per_token = 0.0
    if deg.ep > 1:
        pl = _decode_expert_placement(ctx, deg)
        expert_placement = pl.placement
        a2a_bytes_per_token = (2 * cfg.top_k * cfg.d_model * BYTES_ACT
                               * (deg.ep - 1) / deg.ep)
    best = sol.best
    # KV-budget cap: when the wafer cannot hold the *full* B×S cache
    # beside the weight shard (degraded meshes mostly — fewer dies means
    # fewer KV shards), the plan is still servable with fewer resident
    # tokens.  Cap ``kv_budget_tokens`` at what actually fits instead of
    # declaring OOM, as long as at least one max-context request fits.
    # On a healthy solve the cache fits by construction and the budget
    # stays at max_batch*max_seq, so pristine plans are unchanged.
    kv_budget = max_batch * max_seq
    kv_bytes = cache_bytes
    mem_pred = best.mem_per_die
    oom_pred = best.oom
    kv_capped = False
    if best.oom and cache_bytes > 0:
        free = wafer.spec.hbm_cap - (best.mem_per_die - cache_bytes)
        budget = int(free / cache_bytes * max_batch * max_seq)
        if budget >= max_seq:
            kv_budget = budget
            kv_bytes = cache_bytes * budget / (max_batch * max_seq)
            mem_pred = best.mem_per_die - cache_bytes + kv_bytes
            oom_pred = False
            kv_capped = True
    plan = ServePlan(
        plan=inner, max_batch=max_batch, max_seq=max_seq,
        kv_layout=kv_layout, kv_bytes_per_die=kv_bytes,
        kv_budget_tokens=kv_budget,
        stream_dtype=stream_dtype, prefill_chunk=prefill_chunk,
        ep=deg.ep, expert_placement=expert_placement,
        a2a_bytes_per_token=a2a_bytes_per_token,
        predicted={
            "token_latency": best.step_time,
            "tokens_per_s": best.throughput,
            "mem_per_die": mem_pred,
            "oom": oom_pred,
            "kv_shards": int(kv_div),
            "kv_budget_capped": kv_capped,
        },
        solver={
            "method": sol.method,
            "search_time_s": sol.search_time_s,
            "evaluated": sol.evaluated,
            "allow_ep": allow_ep,
        },
    )
    _verify_fresh(plan, wafer, cfg)
    plan.dump(path)
    return plan


def replan_serve(plan: ServePlan, cfg: "ModelConfig",
                 wafer: Optional["Wafer"] = None, *,
                 failed_dies: Sequence[int] = (),
                 failed_links: Sequence[tuple[int, int]] = (),
                 min_batch: int = 1, seed: int = 0,
                 tierb: Optional[str] = None,
                 cache_dir: Optional[str] = None,
                 use_cache: bool = True) -> ServePlan:
    """Re-solve a serving plan on a degraded wafer (§VIII-F, live).

    The elastic-serving recovery path: given the plan currently being
    executed and the fault state, re-run ``dlws_solve(objective="decode")``
    on the surviving dies and emit a new :class:`ServePlan` with the same
    serving contract knobs (``max_seq``, codec, prefill chunk).  Goes
    through :func:`compile_serve_plan`, so the fault-keyed plan cache
    applies — a wafer that already degraded the same way replans from
    disk, and an offline ``compile_serve_plan`` on the same degraded
    wafer produces the *identical* plan (pinned by the fault_recovery
    gate's fresh-solve control).

    Capacity may shrink two ways: the KV-budget cap inside
    ``compile_serve_plan`` trims ``kv_budget_tokens`` when the full cache
    no longer fits beside the (now larger) weight shard, and if even one
    max-context request cannot fit, ``max_batch`` halves until the plan
    is feasible (floor ``min_batch``).  The caller migrates resident
    sequences into whatever contract comes back
    (:func:`repro_torch.serve.migrate.plan_kv_migration`).

    ``wafer``, when given, is the live degraded wafer and takes
    precedence over the plan's grid-only record — pass it whenever the
    deployment runs a non-default :class:`WaferSpec` (the plan cache is
    spec-keyed, so non-default specs share the default cache dir; the
    plan record itself still only carries the grid shape).
    ``failed_dies`` / ``failed_links`` apply *additional* faults on top
    (cumulative failures compose).  ``tierb`` selects the Tier-B backend
    for the re-solve (backend-invariant — the replanned contract is
    byte-identical either way).
    """
    degraded = wafer if wafer is not None else plan.plan.wafer()
    if failed_dies or failed_links:
        degraded = degraded.with_faults(failed_dies, failed_links)
    if not degraded.alive_dies():
        raise ValueError("replan_serve: no surviving dies to replan onto")
    max_batch = plan.max_batch
    while True:
        new = compile_serve_plan(
            degraded, cfg, max_batch, plan.max_seq, arch=plan.arch,
            engine=plan.plan.engine, space=plan.plan.space,
            stream_dtype=plan.stream_dtype, prefill_chunk=plan.prefill_chunk,
            seed=seed, tierb=tierb,
            allow_ep=plan.solver.get("allow_ep", True),
            cache_dir=cache_dir, use_cache=use_cache)
        if not new.predicted.get("oom") or max_batch <= min_batch:
            return new
        max_batch = max(min_batch, max_batch // 2)


def cached_serve_plan(plan: ServePlan, cfg: "ModelConfig", wafer: "Wafer",
                      *, cache_dir: Optional[str] = None
                      ) -> Optional[ServePlan]:
    """Peek the serve-plan cache for ``wafer`` at ``plan``'s contract
    knobs — **no solver call, ever**.  Returns the cached (verified)
    plan or ``None`` on a miss.

    This is the replan governor's revert probe: a repair that restores
    a previously-seen topology hits the fault-keyed cache entry that
    topology was solved under, which makes reverting to it free — the
    governor can bypass its hysteresis/budget accounting for such
    replans.  The probe uses the *current* contract (``max_batch`` may
    have halved during an OOM replan; a differently-sized entry is a
    miss, and the capacity-upside path re-solves instead)."""
    cache_dir = cache_dir if cache_dir is not None else default_cache_dir()
    key = plan_cache_key(plan.arch, plan.max_batch, plan.max_seq, wafer,
                         None, engine=plan.plan.engine,
                         space=plan.plan.space,
                         knobs=("decode", plan.stream_dtype,
                                plan.prefill_chunk,
                                plan.solver.get("allow_ep", True)))
    path = os.path.join(cache_dir, f"splan_{key}.json")
    if not os.path.exists(path):
        return None
    return _read_cached(ServePlan.load, path, wafer, cfg)


# ---------------------------------------------------------------------------
# multi-wafer pipeline plans (§VIII-E): solve → plan → execute across wafers
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MultiWaferPlan:
    """Executable launch plan for a pipeline of wafers.

    One :class:`WaferPlan` per pipeline stage (a stage owns a whole wafer
    at ``pp == n_wafers``, or a contiguous die subset when stages share a
    wafer) plus the pipeline-level choices: the layer → stage split, the
    microbatch count, the schedule family and the inter-wafer bandwidth
    the plan was scored against.
    """

    arch: str
    batch: int
    seq: int
    n_wafers: int
    pp: int
    n_micro: int
    family: str  # "gpipe" | "1f1b"
    inter_wafer_bw: float
    stage_layers: tuple[int, ...]
    stage_wafer: tuple[int, ...]  # stage -> wafer index
    stages: tuple[WaferPlan, ...]
    predicted: dict = field(default_factory=dict)
    solver: dict = field(default_factory=dict)
    version: int = PLAN_VERSION

    @property
    def plan_hash(self) -> str:
        """Executable-surface hash: pipeline shape + every stage's own
        ``plan_hash`` (stage telemetry excluded transitively)."""
        d = self.to_dict()
        d.pop("predicted", None)
        d.pop("solver", None)
        d["stages"] = [s.plan_hash for s in self.stages]
        blob = json.dumps(d, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["stages"] = [s.to_dict() for s in self.stages]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "MultiWaferPlan":
        d = dict(d)
        if d.get("version", PLAN_VERSION) > PLAN_VERSION:
            raise ValueError(f"plan version {d['version']} is newer than "
                             f"this runtime ({PLAN_VERSION})")
        d["stages"] = tuple(WaferPlan.from_dict(s) for s in d["stages"])
        d["stage_layers"] = tuple(d.get("stage_layers", ()))
        d["stage_wafer"] = tuple(d.get("stage_wafer", ()))
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def dumps(self) -> str:
        return json.dumps(self.to_dict(), indent=1, sort_keys=True)

    @classmethod
    def loads(cls, s: str) -> "MultiWaferPlan":
        return cls.from_dict(json.loads(s))

    def dump(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.dumps())
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "MultiWaferPlan":
        with open(path) as f:
            return cls.loads(f.read())

    def stages_of_wafer(self, wafer_idx: int) -> list[int]:
        return [s for s, w in enumerate(self.stage_wafer) if w == wafer_idx]

    def pipeline_schedule(self) -> "PipelineSchedule":
        from repro_torch.core.schedule import pipeline_schedule
        return pipeline_schedule(self.family, self.pp, self.n_micro)

    def summary(self) -> str:
        pred = self.predicted or {}
        parts = [
            f"MultiWaferPlan[{self.plan_hash}] {self.arch} "
            f"batch={self.batch} seq={self.seq}",
            f"  {self.n_wafers} wafers, pp={self.pp} "
            f"n_micro={self.n_micro} family={self.family} "
            f"layers={list(self.stage_layers)}",
        ]
        if pred.get("throughput") is not None:
            parts.append(
                f"  predicted {pred['throughput'] / 1e6:.2f} Mtok/s, "
                f"bubble {pred.get('bubble', 0):.2f}, "
                f"peak mem {max(pred.get('stage_mem', [0])) / 1e9:.1f} "
                f"GB/die")
        for i, s in enumerate(self.stages):
            parts.append(f"  stage{i} w{self.stage_wafer[i]} "
                         f"L={self.stage_layers[i]} "
                         f"degrees={s.degrees_tuple()} "
                         f"dies={len(s.alive_dies)} [{s.plan_hash}]")
        return "\n".join(parts)


def multiwafer_cache_key(arch: str, batch: int, seq: int,
                         wafers: Sequence["Wafer"],
                         dies_per_wafer: Optional[Sequence[
                             Optional[Sequence[int]]]] = None,
                         *, engine: str = "tcme",
                         space: str = "temp", knobs: tuple = (),
                         upper: tuple = ()) -> str:
    """Cache identity keyed on the tuple of per-wafer fault states: any
    die/link death on any one wafer changes the key and forces a re-solve
    of (at least) that wafer's stages.  ``upper`` carries the pipeline-
    level search space (pp multipliers, n_micro candidates, families)."""
    per_wafer = []
    for i, w in enumerate(wafers):
        dies = None
        if dies_per_wafer is not None and dies_per_wafer[i] is not None:
            dies = sorted(dies_per_wafer[i])
        per_wafer.append({
            # the full hardware spec, not just the grid shape: wafers with
            # different HBM caps / link bandwidths solve to different
            # plans and must not alias one cache entry
            "spec": dataclasses.asdict(w.spec),
            "failed_dies": sorted(w.failed_dies),
            "failed_links": sorted(list(l) for l in w.failed_links),
            "dies": dies if dies is not None else sorted(w.alive_dies()),
        })
    ident = {
        "v": PLAN_VERSION,
        "arch": arch, "batch": batch, "seq": seq,
        "wafers": per_wafer,
        "engine": engine, "space": space,
        "knobs": list(knobs), "upper": list(upper),
    }
    blob = json.dumps(ident, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:24]


def compile_multiwafer_plan(
        wafers: Sequence["Wafer"], cfg: "ModelConfig",
        batch: int, seq: int, *,
        arch: Optional[str] = None, engine: str = "tcme",
        space: str = "temp",
        dies_per_wafer: Optional[Sequence[
            Optional[Sequence[int]]]] = None,
        stream: str = "auto", bidirectional: bool = True,
        stream_dtype: str = "native", remat: bool = True, seed: int = 0,
        inter_wafer_bw: Optional[float] = None,
        pp_multipliers: Sequence[int] = (1,),
        n_micro_candidates: Sequence[int] = (4, 8, 16, 32),
        families: Sequence[str] = ("gpipe", "1f1b"),
        tierb: Optional[str] = None,
        cache_dir: Optional[str] = None,
        use_cache: bool = True) -> MultiWaferPlan:
    """solve (upper + per-stage DLWS) → map → plan across ``wafers``, with
    an on-disk cache keyed on the tuple of per-wafer fault states.
    ``tierb`` selects the Tier-B backend for every stage solve
    (backend-invariant, never part of the key)."""
    from repro_torch.wafer.solver import INTER_WAFER_BW, dlws_solve_multiwafer
    arch = arch or cfg.name
    bw = inter_wafer_bw if inter_wafer_bw is not None else INTER_WAFER_BW
    cache_dir = cache_dir if cache_dir is not None else default_cache_dir()
    key = multiwafer_cache_key(
        arch, batch, seq, wafers, dies_per_wafer, engine=engine,
        space=space, knobs=(stream, bidirectional, stream_dtype, remat, bw),
        upper=(tuple(pp_multipliers), tuple(n_micro_candidates),
               tuple(families)))
    path = os.path.join(cache_dir, f"mwplan_{key}.json")
    if use_cache and os.path.exists(path):
        plan = _read_cached(MultiWaferPlan.load, path, wafers, cfg)
        if plan is not None:
            PLAN_STATS["cache_hits"] += 1
            return plan
    PLAN_STATS["cache_misses"] += 1

    PLAN_STATS["solver_calls"] += 1
    sol = dlws_solve_multiwafer(
        wafers, cfg, batch, seq, engine=engine, space=space, seed=seed,
        dies_per_wafer=dies_per_wafer, inter_wafer_bw=bw,
        pp_multipliers=pp_multipliers,
        n_micro_candidates=n_micro_candidates, families=families,
        tierb=tierb)
    plan = _plan_from_multiwafer_solution(
        wafers, sol, cfg=cfg, arch=arch, batch=batch, seq=seq,
        engine=engine, space=space, stream=stream,
        bidirectional=bidirectional, stream_dtype=stream_dtype,
        remat=remat, inter_wafer_bw=bw,
        upper=(tuple(pp_multipliers), tuple(n_micro_candidates),
               tuple(families)))
    _verify_fresh(plan, wafers, cfg)
    plan.dump(path)
    return plan


def _plan_from_multiwafer_solution(
        wafers: Sequence["Wafer"], sol: Any, *, cfg: "ModelConfig",
        arch: str, batch: int, seq: int, engine: str, space: str,
        stream: str, bidirectional: bool, stream_dtype: str, remat: bool,
        inter_wafer_bw: float, upper: tuple = ()) -> MultiWaferPlan:
    from repro_torch.wafer.simulator import StepCostContext, memory_components
    from repro_torch.wafer.simulator import STRATEGY_SPACES
    from repro_torch.wafer.solver import stage_config
    spec = STRATEGY_SPACES[space]
    stage_plans = []
    fixed_l, act_l = [], []
    for s in range(sol.pp):
        wafer = wafers[sol.stage_wafer[s]]
        stage_plans.append(plan_from_solution(
            wafer, sol.stages[s], arch=f"{arch}#stage{s}", batch=batch,
            seq=seq, engine=engine, space=space, dies=sol.stage_dies[s],
            stream=stream, bidirectional=bidirectional,
            stream_dtype=stream_dtype, remat=remat))
        # memory split per stage (advisory; replan's rebalance needs it)
        ctx = StepCostContext(wafer, stage_config(cfg, sol.stage_layers[s]),
                              batch, seq, engine, fsdp=spec["fsdp"],
                              dies=list(sol.stage_dies[s]))
        fixed, act_full, _ = memory_components(ctx, sol.stages[s].config)
        fixed_l.append(fixed)
        act_l.append(act_full)
    return MultiWaferPlan(
        arch=arch, batch=batch, seq=seq, n_wafers=len(wafers),
        pp=sol.pp, n_micro=sol.n_micro, family=sol.family,
        inter_wafer_bw=inter_wafer_bw,
        stage_layers=sol.stage_layers, stage_wafer=sol.stage_wafer,
        stages=tuple(stage_plans),
        predicted={
            "throughput": sol.throughput,
            "step_time": sol.step_time,
            "bubble": sol.bubble,
            "peak_inflight": sol.peak_inflight,
            "oom": sol.oom,
            "stage_mem": list(sol.stage_mem),
            "stage_step_time": [s.best.step_time for s in sol.stages],
            "stage_mem_fixed": fixed_l,
            "stage_act_full": act_l,
            # per-stage HBM caps: WaferPlan.wafer() rebuilds with a default
            # WaferSpec, so replan must not re-derive caps from it
            "stage_hbm_cap": [wafers[w].spec.hbm_cap
                              for w in sol.stage_wafer],
        },
        solver={
            "method": "dlws-multiwafer",
            "search_time_s": sol.search_time_s,
            "evaluated": sol.evaluated,
            "candidates": sol.candidates,
            "upper": [list(u) for u in upper],  # search surface (cache key)
        },
    )


def replan_stage(plan: MultiWaferPlan, cfg: "ModelConfig",
                 stage_idx: int, wafer: "Wafer", *,
                 seed: int = 0, max_rebalance: int = 8,
                 cache_dir: Optional[str] = None) -> MultiWaferPlan:
    """Re-solve ONE stage of a multi-wafer plan on a degraded wafer,
    leaving every other stage's :class:`WaferPlan` untouched.

    A die death on one wafer only invalidates that wafer's stage: the
    stage re-solves on its surviving dies with its current layer count.
    If the re-solved stage no longer fits (pipeline in-flight memory over
    ``hbm_cap``), layers migrate one at a time to the stage with the most
    headroom — the *receiving* stage keeps its solved degrees and plan
    (its layer count lives in ``stage_layers``, not in its WaferPlan), so
    only its advisory predictions go stale (rescaled first-order here).
    """
    from repro_torch.core.schedule import (pipeline_schedule, pipeline_step_time,
                                     simulate_pipeline)
    from repro_torch.wafer.simulator import STRATEGY_SPACES, StepCostContext
    from repro_torch.wafer.simulator import memory_components
    from repro_torch.wafer.solver import dlws_solve, stage_config
    s = stage_idx
    old_stage = plan.stages[s]
    space, engine = old_stage.space, old_stage.engine
    spec = STRATEGY_SPACES[space]
    alive = [d for d in old_stage.alive_dies if wafer.alive(d)]
    if not alive:
        raise ValueError(f"stage {s} has no surviving dies")
    sched = pipeline_schedule(plan.family, plan.pp, plan.n_micro)
    rep = simulate_pipeline(sched)
    cap = wafer.spec.hbm_cap
    pred = plan.predicted
    # per-stage caps come from the compile-time record: WaferPlan.wafer()
    # rebuilds with a *default* WaferSpec, so its hbm_cap is not trustworthy
    caps_all = list(pred.get("stage_hbm_cap",
                             [cap] * plan.pp))
    caps_all[s] = cap
    layers = list(plan.stage_layers)
    old_layers = list(plan.stage_layers)

    def solve_here(n_layers: int) -> tuple[Any, float, float, float]:
        scfg = stage_config(cfg, n_layers)
        sol = dlws_solve(wafer, scfg, plan.batch, plan.seq, engine=engine,
                         space=space, seed=seed, dies=alive)
        ctx = StepCostContext(wafer, scfg, plan.batch, plan.seq, engine,
                              fsdp=spec["fsdp"], dies=alive)
        fixed, act_full, _ = memory_components(ctx, sol.config)
        mem = fixed + act_full * rep.inflight_per_stage[s] / plan.n_micro
        return sol, fixed, act_full, mem

    def other_mem(j: int) -> float:
        """Receiver occupancy at the CURRENT layer assignment (first-order
        rescale of the recorded split — not the stale pre-fault value, so
        successive sheds spread instead of piling onto one stage).  Both
        terms scale with the layer count: weights/grads/optimizer are
        per-layer (modulo the embedding) and so are activations."""
        ratio = layers[j] / max(old_layers[j], 1)
        return ratio * (pred["stage_mem_fixed"][j]
                        + pred["stage_act_full"][j]
                        * rep.inflight_per_stage[j] / plan.n_micro)

    needed = ("stage_step_time", "stage_mem_fixed", "stage_act_full")
    missing = [k for k in needed if k not in pred]
    if missing:
        raise ValueError(f"plan lacks solver telemetry {missing}: "
                         f"replan_stage needs a plan produced by "
                         f"compile_multiwafer_plan (predicted was "
                         f"stripped or hand-edited)")

    sol, fixed, act_full, mem = solve_here(layers[s])
    moved = 0
    while mem > cap and layers[s] > 1 and moved < max_rebalance:
        # shed one layer to the stage with the most headroom *now*
        head = [(other_mem(j) / caps_all[j], j)
                for j in range(plan.pp) if j != s]
        if not head:  # pp == 1: nowhere to shed — ship flagged as OOM
            break
        dst = min(head)[1]
        layers[s] -= 1
        layers[dst] += 1
        moved += 1
        sol, fixed, act_full, mem = solve_here(layers[s])

    new_stage = plan_from_solution(
        wafer, sol, arch=old_stage.arch, batch=plan.batch, seq=plan.seq,
        engine=engine, space=space, dies=alive, stream=old_stage.stream,
        bidirectional=old_stage.bidirectional,
        stream_dtype=old_stage.stream_dtype, remat=old_stage.remat)
    stages = tuple(new_stage if j == s else plan.stages[j]
                   for j in range(plan.pp))

    # re-score the pipeline: untouched stages scale first-order with their
    # (possibly rebalanced) layer counts; the re-solved stage is exact
    step_times, mems = [], []
    for j in range(plan.pp):
        ratio = layers[j] / max(old_layers[j], 1)
        if j == s:
            step_times.append(sol.best.step_time)
            mems.append(mem)
        else:
            step_times.append(pred["stage_step_time"][j] * ratio)
            mems.append(other_mem(j))
    half = [t / (2 * plan.n_micro) for t in step_times]
    from repro_torch.wafer.simulator import BYTES_ACT
    from repro_torch.wafer.solver import stage_boundary_p2p
    # per-boundary charging, matching the upper solve: on-wafer boundaries
    # pay the D2D cut (wafers other than the degraded one are rebuilt from
    # their stage plans — the grid/fault state is exact; hardware constants
    # fall back to the recorded defaults, same caveat as `caps_all`)
    wafer_objs = {w: (wafer if w == plan.stage_wafer[s]
                      else plan.stages[plan.stages_of_wafer(w)[0]].wafer())
                  for w in set(plan.stage_wafer)}
    wafer_list = [wafer_objs[w] for w in range(plan.n_wafers)]
    stage_dies = [tuple(alive) if j == s else plan.stages[j].alive_dies
                  for j in range(plan.pp)]
    # fault-path pricing is *pessimistic* about co-located boundaries:
    # shared_cut charges every on-wafer boundary its 1/k share of the
    # wafer's D2D fabric (k boundaries streaming concurrently in steady
    # 1F1B).  The healthy upper solve keeps the optimistic un-shared
    # price — the replan governor deciding whether a degraded co-located
    # layout is worth keeping must not see a boundary rate the fabric
    # cannot actually sustain under contention.
    boundary_bytes = plan.batch * plan.seq * cfg.d_model * BYTES_ACT
    p2p = stage_boundary_p2p(
        wafer_list, plan.stage_wafer, stage_dies, boundary_bytes,
        plan.n_micro, plan.inter_wafer_bw, shared_cut=True)
    p2p_unshared = stage_boundary_p2p(
        wafer_list, plan.stage_wafer, stage_dies, boundary_bytes,
        plan.n_micro, plan.inter_wafer_bw)
    t_step = pipeline_step_time(sched, half, half, p2p)
    new_pred = dict(pred)
    new_pred.update({
        "step_time": t_step,
        # per-boundary contention multipliers (1.0 = uncontended): >1 on
        # wafers hosting several co-located boundaries
        "boundary_contention": [b / u if u > 0 else 1.0
                                for b, u in zip(p2p, p2p_unshared)],
        "throughput": plan.batch * plan.seq / t_step if t_step > 0 else 0.0,
        "oom": any(m > c for m, c in zip(mems, caps_all))
        or not sol.best.ok,
        "stage_mem": mems,
        "stage_step_time": step_times,
        "stage_hbm_cap": caps_all,
        # rescaled bases so a future replan's ratios compose from the new
        # stage_layers
        "stage_mem_fixed": [fixed if j == s else pred["stage_mem_fixed"][j]
                            * layers[j] / max(old_layers[j], 1)
                            for j in range(plan.pp)],
        "stage_act_full": [act_full * 1.0 if j == s
                           else pred["stage_act_full"][j]
                           * layers[j] / max(old_layers[j], 1)
                           for j in range(plan.pp)],
    })
    new_solver = dict(plan.solver)
    new_solver.update({"replanned_stage": s, "layers_moved": moved,
                       "evaluated": sol.evaluated})
    new_plan = dataclasses.replace(plan, stages=stages,
                                   stage_layers=tuple(layers),
                                   predicted=new_pred, solver=new_solver)
    # static verification of the stitched plan before it is returned or
    # republished.  Wafers other than the degraded one are only known by
    # grid shape here, so spec-dependent memory checks run as warnings;
    # the structural invariants (degrees, device orders, schedule
    # legality, disjoint stage dies) stay hard errors.
    _verify_fresh(new_plan, None, cfg)
    if cache_dir is not None:
        # publish under the new fault tuple (same key a fresh compile on
        # the degraded wafers would compute) so a relaunch hits it.  A
        # wafer's fault state is the UNION over all its stages' plans —
        # with stages sharing a wafer, rebuilding from any single stage
        # would drop the other stage's faults and alias the healthy key.
        # All wafers are assumed to share the passed wafer's hardware spec
        # (WaferPlan records only the grid shape).
        from repro_torch.wafer.topology import Wafer
        wafers = []
        for w in range(new_plan.n_wafers):
            idxs = new_plan.stages_of_wafer(w)
            fd: set = set()
            fl: set = set()
            for i in idxs:
                fd |= set(new_plan.stages[i].failed_dies)
                fl |= {tuple(l) for l in new_plan.stages[i].failed_links}
            st = new_plan.stages[idxs[0]]
            wspec = dataclasses.replace(wafer.spec, rows=st.wafer_rows,
                                        cols=st.wafer_cols)
            wafers.append(Wafer(wspec, frozenset(fd), frozenset(fl)))
        st0 = new_plan.stages[0]
        key = multiwafer_cache_key(
            plan.arch, plan.batch, plan.seq, wafers, engine=engine,
            space=space,
            knobs=(st0.stream, st0.bidirectional, st0.stream_dtype,
                   st0.remat, plan.inter_wafer_bw),
            upper=tuple(tuple(u) for u in plan.solver.get("upper", ())))
        new_plan.dump(os.path.join(cache_dir, f"mwplan_{key}.json"))
    return new_plan
