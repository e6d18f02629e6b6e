"""Framework-level fault tolerance (paper §VIII-F, Fig. 20).

Copy of ``repro.wafer.fault`` (the port imports nothing of ``repro``):
the reference's names, constants and arithmetic, in its order, so
results are bitwise equal to the reference's.

Three-step strategy on top of the wafer model:

1. **Fault localization & classification** — failed cores (dies) vs failed
   links, from a health report.
2. **Adaptive tensor partitioning** — re-solve the parallel configuration on
   the surviving dies (DLWS on the degraded wafer); TATP ring groups are
   re-embedded by the snake mapping so they stay one-hop contiguous around
   the holes.
3. **Communication rerouting** — traffic on failed links is detoured (BFS
   paths in :mod:`repro_torch.wafer.topology`); TCME re-optimises contention.

The same module drives the runnable system's elastic restart: on a failure
report the launcher shrinks the mesh to the surviving grid, restores the
latest checkpoint, and continues (see repro/launch/train.py).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.wafer.simulator import (ParallelDegrees, SimResult,
                                   StepCostContext)
from repro_torch.wafer.topology import Wafer


@dataclass
class FaultReport:
    failed_dies: list[int] = field(default_factory=list)
    failed_links: list[tuple[int, int]] = field(default_factory=list)

    def classify(self) -> str:
        if self.failed_dies and self.failed_links:
            return "mixed"
        if self.failed_dies:
            return "core"
        if self.failed_links:
            return "link"
        return "healthy"

    def as_event(self, time: float):
        """This report as a serve-engine fault-timeline event firing at
        ``time`` seconds on the engine clock (elastic serving)."""
        from repro_torch.serve.engine import FaultEvent
        return FaultEvent(time=time,
                          failed_dies=tuple(self.failed_dies),
                          failed_links=tuple(tuple(l) for l in
                                             sorted(self.failed_links)))


def inject_faults(wafer: Wafer, *, die_rate: float = 0.0,
                  link_rate: float = 0.0, seed: int = 0) -> FaultReport:
    rng = random.Random(seed)
    spec = wafer.spec
    dies = [d for d in range(spec.n_dies) if rng.random() < die_rate]
    links = []
    for d in range(spec.n_dies):
        r, c = wafer.rc(d)
        for dr, dc in ((0, 1), (1, 0)):
            nr, nc = r + dr, c + dc
            if nr < spec.rows and nc < spec.cols:
                if rng.random() < link_rate:
                    links.append((d, wafer.die(nr, nc)))
    return FaultReport(dies, links)


def sample_die_faults(wafer: Wafer, frac: float, *,
                      seed: int = 0) -> FaultReport:
    """Kill *exactly* ``ceil(frac * alive)`` dies, seeded.

    :func:`inject_faults` draws per-die Bernoulli failures, so the
    realized severity wobbles around the rate; the elastic-serving
    benchmark and its drift gate need the severity axis to be exact
    ("kill ≥10% of the dies" must mean exactly that, deterministically).
    """
    import math
    alive = wafer.alive_dies()
    if frac <= 0 or not alive:
        return FaultReport()
    k = min(len(alive), max(1, math.ceil(frac * len(alive))))
    rng = random.Random(seed)
    return FaultReport(failed_dies=sorted(rng.sample(alive, k)))


def working_mesh_links(wafer: Wafer) -> list[tuple[int, int]]:
    """Undirected working mesh links ``(a, b)`` with ``a < b``, sorted —
    the deterministic sampling universe for link-fault injection (each
    geometric link appears once; failed links and links touching dead
    dies are excluded)."""
    out = []
    for d in range(wafer.spec.n_dies):
        if not wafer.alive(d):
            continue
        r, c = wafer.rc(d)
        for dr, dc in ((0, 1), (1, 0)):
            nr, nc = r + dr, c + dc
            if nr < wafer.spec.rows and nc < wafer.spec.cols:
                n = wafer.die(nr, nc)
                if wafer.link_ok(d, n):
                    out.append((d, n))
    return sorted(out)


def sample_link_faults(wafer: Wafer, frac: float, *,
                       seed: int = 0) -> FaultReport:
    """Kill *exactly* ``ceil(frac * working)`` undirected mesh links,
    seeded — the link twin of :func:`sample_die_faults`, so fig20's
    link-severity axis (and the chaos trace generators) can be exact
    instead of Bernoulli-wobbly."""
    import math
    links = working_mesh_links(wafer)
    if frac <= 0 or not links:
        return FaultReport()
    k = min(len(links), max(1, math.ceil(frac * len(links))))
    rng = random.Random(seed)
    return FaultReport(failed_links=sorted(rng.sample(links, k)))


# ---------------------------------------------------------------------------
# fault/repair timelines (chaos traces for the elastic serving engine)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FaultTrace:
    """A seeded, serializable fault/repair timeline — the input grammar
    of chaos-grade elastic serving.

    ``events`` is a time-sorted tuple of
    :class:`repro_torch.serve.engine.FaultEvent`; the constructors below
    generate the three canonical shapes ROADMAP item 5 calls out
    (flapping link, cascade, MTTF/MTTR), all driven by
    ``random.Random(seed)`` so a trace is a pure function of
    ``(wafer, seed, knobs)`` and benchmark runs replay bit-for-bit.
    ``to_json``/``from_json`` round-trip the trace for
    ``launch/serve.py --fault-trace FILE.json``.
    """

    events: tuple = ()   # tuple[FaultEvent, ...], time-sorted
    kind: str = "custom"
    seed: int = 0

    # -- generators --------------------------------------------------------
    @classmethod
    def flapping(cls, wafer: Wafer, *, seed: int = 0,
                 link: Optional[tuple[int, int]] = None,
                 start: float = 1.0, period_s: float = 0.5,
                 n_flaps: int = 4,
                 settle: str = "failed") -> "FaultTrace":
        """One link failing and repairing every ``period_s`` seconds:
        ``n_flaps`` failures, each (except possibly the last) followed by
        a repair.  ``settle="failed"`` ends the trace with the link down
        (2·n_flaps − 1 events); ``settle="repaired"`` brings it back up
        (2·n_flaps events).  ``link=None`` picks a working link with the
        seeded RNG."""
        from repro_torch.serve.engine import FaultEvent
        if settle not in ("failed", "repaired"):
            raise ValueError(f"settle must be 'failed' or 'repaired', "
                             f"got {settle!r}")
        if n_flaps < 1:
            raise ValueError("n_flaps must be >= 1")
        if link is None:
            links = working_mesh_links(wafer)
            if not links:
                raise ValueError("no working links to flap")
            link = random.Random(seed).choice(links)
        link = tuple(link)
        n_events = 2 * n_flaps - (1 if settle == "failed" else 0)
        events = []
        for j in range(n_events):
            t = start + j * period_s
            if j % 2 == 0:
                events.append(FaultEvent(time=t, failed_links=(link,)))
            else:
                events.append(FaultEvent(time=t, repaired_links=(link,)))
        return cls(events=tuple(events), kind="flapping", seed=seed)

    @classmethod
    def cascade(cls, wafer: Wafer, *, seed: int = 0, start: float = 1.0,
                interval_s: float = 0.3, n_events: int = 3,
                frac_per_event: float = 0.05) -> "FaultTrace":
        """Correlated die failures landing seconds apart: each event
        kills exactly ``ceil(frac_per_event · remaining)`` of the dies
        still alive after the previous event (disjoint, seeded)."""
        from repro_torch.serve.engine import FaultEvent
        import math as _math
        rng = random.Random(seed)
        alive = list(wafer.alive_dies())
        events = []
        for j in range(n_events):
            if not alive:
                break
            k = min(len(alive),
                    max(1, _math.ceil(frac_per_event * len(alive))))
            dead = sorted(rng.sample(alive, k))
            alive = [d for d in alive if d not in set(dead)]
            events.append(FaultEvent(time=start + j * interval_s,
                                     failed_dies=tuple(dead)))
        return cls(events=tuple(events), kind="cascade", seed=seed)

    @classmethod
    def mttf_mttr(cls, wafer: Wafer, *, seed: int = 0,
                  horizon_s: float = 30.0, mttf_s: float = 60.0,
                  mttr_s: float = 5.0,
                  max_dies: int = 8) -> "FaultTrace":
        """Exponential fail/repair per die (classic MTTF/MTTR renewal
        process): up-times ~ Exp(mean ``mttf_s``), down-times ~
        Exp(mean ``mttr_s``), truncated at ``horizon_s``.  Only the
        ``max_dies`` lowest-numbered alive dies participate (a full
        wafer at a short MTTF would bury the engine in events)."""
        from repro_torch.serve.engine import FaultEvent
        rng = random.Random(seed)
        transitions = []  # (time, die, up->down?)
        for d in sorted(wafer.alive_dies())[:max_dies]:
            t, up = 0.0, True
            while True:
                t += rng.expovariate(1.0 / (mttf_s if up else mttr_s))
                if t >= horizon_s:
                    break
                transitions.append((t, d, up))
                up = not up
        transitions.sort()
        events = [FaultEvent(time=t,
                             failed_dies=(d,) if going_down else (),
                             repaired_dies=() if going_down else (d,))
                  for t, d, going_down in transitions]
        return cls(events=tuple(events), kind="mttf_mttr", seed=seed)

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "seed": self.seed,
            "events": [{
                "time": ev.time,
                "failed_dies": list(ev.failed_dies),
                "failed_links": [list(l) for l in sorted(ev.failed_links)],
                "repaired_dies": list(ev.repaired_dies),
                "repaired_links": [list(l)
                                   for l in sorted(ev.repaired_links)],
            } for ev in self.events],
        }

    @classmethod
    def from_dict(cls, raw: dict) -> "FaultTrace":
        from repro_torch.analysis.schema import validate_fault_trace
        from repro_torch.serve.engine import FaultEvent
        validate_fault_trace(raw)
        events = tuple(sorted(
            (FaultEvent(
                time=float(e["time"]),
                failed_dies=tuple(e.get("failed_dies", ())),
                failed_links=tuple(tuple(l)
                                   for l in e.get("failed_links", ())),
                repaired_dies=tuple(e.get("repaired_dies", ())),
                repaired_links=tuple(tuple(l)
                                     for l in e.get("repaired_links", ())))
             for e in raw["events"]), key=lambda ev: ev.time))
        return cls(events=events, kind=raw.get("kind", "custom"),
                   seed=int(raw.get("seed", 0)))

    def to_json(self, path: str) -> None:
        import json
        import os
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, path: str) -> "FaultTrace":
        import json
        with open(path) as f:
            return cls.from_dict(json.load(f))

    # -- helpers -----------------------------------------------------------
    def final_wafer(self, wafer: Wafer) -> Wafer:
        """The topology after the whole trace has played out (what a
        post-settle fresh solve should be compared against)."""
        for ev in self.events:
            wafer = wafer.with_faults(ev.failed_dies, ev.failed_links) \
                         .with_repairs(ev.repaired_dies, ev.repaired_links)
        return wafer


def parse_fault_trace(spec: str, wafer: Wafer) -> FaultTrace:
    """CLI grammar for ``launch/serve.py --fault-trace``:
    ``flap:SEED`` / ``cascade:SEED`` (seeded generators on ``wafer``)
    or a path to a ``FaultTrace`` JSON file."""
    if spec.startswith("flap:"):
        return FaultTrace.flapping(wafer, seed=int(spec[5:]))
    if spec.startswith("cascade:"):
        return FaultTrace.cascade(wafer, seed=int(spec[8:]))
    return FaultTrace.from_json(spec)


def random_degraded_wafer(seed: int, *, spec=None,
                          max_die_rate: float = 0.15,
                          max_link_rate: float = 0.08
                          ) -> tuple[Wafer, list[int]]:
    """Seeded degraded-wafer scenario: dead dies, dead links, and a
    contiguous snake-order die subset (a pipeline stage's die share).

    Shared by the batched-vs-reference bitwise property tests and the
    degraded search-time benchmark rows, so both exercise the same shapes:
    holes in rings, detoured links, and subset-restricted solves.
    Returns ``(degraded_wafer, die_subset)``.
    """
    from repro_torch.wafer.mapping import snake_order
    rng = random.Random(seed)
    base = Wafer(spec) if spec is not None else Wafer()
    rep = inject_faults(base,
                        die_rate=rng.uniform(0.02, max_die_rate),
                        link_rate=rng.uniform(0.0, max_link_rate),
                        seed=rng.randrange(1 << 30))
    degraded = base.with_faults(rep.failed_dies, rep.failed_links)
    alive = set(degraded.alive_dies())
    order = [d for d in snake_order(degraded.spec.rows, degraded.spec.cols)
             if d in alive]
    n = rng.randint(max(2, len(order) // 2), len(order))
    start = rng.randint(0, len(order) - n)
    return degraded, order[start:start + n]


def largest_usable_count(n: int) -> int:
    """All surviving dies are usable: the snake re-embedding routes around
    holes and the solver's degree search accepts any divisor of n — this is
    what keeps throughput ≈ alive/total instead of snapping to the next
    power of two (paper Fig. 20b: ~80% at 25% core faults)."""
    return max(1, n)


def recover(wafer: Wafer, report: FaultReport, cfg: ModelConfig, batch: int,
            seq: int, *, engine: str = "tcme",
            ctx_cache: Optional[dict] = None) -> SimResult:
    """Steps 1–3: classify, re-partition, re-route; returns the degraded-mesh
    simulation result with the re-solved configuration.

    ``ctx_cache`` lets a sweep reuse :class:`StepCostContext` instances
    across fault reports.  The key is the full cost-surface identity —
    the alive-die subset, the failed-link set, and the workload
    (cfg/batch/seq/engine) — so two reports that degrade the wafer
    identically share one context (and its memoized routing/groups/
    results), while any extra dead die, link, or workload change misses.
    """
    degraded = wafer.with_faults(report.failed_dies, report.failed_links)
    alive = degraded.alive_dies()
    usable = largest_usable_count(len(alive))
    # adaptive partitioning: re-solve on the usable subset (the snake
    # embedding skips the holes; spares stay idle)
    sub = alive[:usable]
    # quick re-solve (DP only — GA omitted for speed in the fault loop);
    # the context pins the evaluation cache to this degraded die subset
    from repro_torch.wafer.solver import dp_refine
    key = (tuple(sub), tuple(sorted(degraded.failed_links)),
           cfg.name, batch, seq, engine)
    ctx = ctx_cache.get(key) if ctx_cache is not None else None
    if ctx is None:
        ctx = StepCostContext(degraded, cfg, batch, seq, engine, dies=sub)
        if ctx_cache is not None:
            ctx_cache[key] = ctx
    deg = dp_refine(ctx, ParallelDegrees(dp=usable))
    return ctx.evaluate(deg, final=True)


def recover_multiwafer(plan, cfg: ModelConfig, wafer_idx: int,
                       report: FaultReport, *,
                       wafer: Optional[Wafer] = None,
                       cache_dir: Optional[str] = None):
    """Multi-wafer recovery (pipeline level): a fault on one wafer
    re-solves ONLY that wafer's stage(s), leaving every other stage's
    :class:`~repro_torch.core.plan.WaferPlan` untouched.

    Delegates to :func:`repro_torch.core.plan.replan_stage`, which re-solves the
    degraded stage on its surviving dies and — if the stage no longer fits
    under the pipeline's in-flight activation memory — migrates layers to
    the stage with the most headroom (the receiving stage keeps its solved
    degrees; only ``stage_layers`` and advisory predictions change).
    Returns the new :class:`~repro_torch.core.plan.MultiWaferPlan`.

    Pass ``wafer`` (the live Wafer the report came from) when the
    deployment runs a non-default :class:`WaferSpec` — the plan records
    only the grid shape, so reconstructing the wafer from the plan falls
    back to Table-I hardware constants.
    """
    from repro_torch.core.plan import replan_stage
    new_plan = plan
    for s in plan.stages_of_wafer(wafer_idx):
        base = wafer if wafer is not None \
            else new_plan.stages[s].wafer()
        degraded = base.with_faults(report.failed_dies, report.failed_links)
        new_plan = replan_stage(new_plan, cfg, s, degraded,
                                cache_dir=cache_dir)
    return new_plan


def throughput_vs_fault_rate(wafer: Wafer, cfg: ModelConfig, batch: int,
                             seq: int, *, kind: str = "core",
                             engine: str = "tcme",
                             rates=(0.0, 0.05, 0.1, 0.15, 0.2, 0.25, 0.3,
                                    0.35, 0.4),
                             seed: int = 0,
                             sampler: str = "bernoulli",
                             ctx_cache: Optional[dict] = None) -> list[dict]:
    """Paper Fig. 20b/20c sweep.  ``kind`` picks what the rate kills:
    ``"core"`` (dies), ``"link"``, or ``"mixed"`` (both at once, the
    worst case §VIII-F classifies).  ``engine`` selects the cost engine
    the re-solve runs on (threaded to :func:`recover`, which keys its
    context cache on it).  ``sampler="bernoulli"`` draws per-element
    failures at the rate (:func:`inject_faults`, the paper's setup);
    ``"exact"`` kills exactly ``ceil(rate · population)`` via
    :func:`sample_die_faults` / :func:`sample_link_faults`, making the
    severity axis deterministic in *count*, not just in draw.  One
    ``ctx_cache`` spans the whole loop (callers may pass their own to
    share across kinds/seeds): adjacent rates that kill the same die
    subset — common at low rates, where the same seed draws the same
    failures — reuse one context instead of rebuilding invariants per
    rate."""
    if kind not in ("core", "link", "mixed"):
        raise ValueError(f"kind must be 'core', 'link' or 'mixed', "
                         f"got {kind!r}")
    if sampler not in ("bernoulli", "exact"):
        raise ValueError(f"sampler must be 'bernoulli' or 'exact', "
                         f"got {sampler!r}")
    out = []
    base = None
    if ctx_cache is None:
        ctx_cache = {}
    for rate in rates:
        if sampler == "exact":
            rep = FaultReport()
            if kind in ("core", "mixed"):
                rep.failed_dies = sample_die_faults(
                    wafer, rate, seed=seed).failed_dies
            if kind in ("link", "mixed"):
                rep.failed_links = sample_link_faults(
                    wafer, rate, seed=seed).failed_links
        else:
            rep = inject_faults(
                wafer,
                die_rate=rate if kind in ("core", "mixed") else 0.0,
                link_rate=rate if kind in ("link", "mixed") else 0.0,
                seed=seed)
        res = recover(wafer, rep, cfg, batch, seq, engine=engine,
                      ctx_cache=ctx_cache)
        if base is None:
            base = res.throughput
        out.append({
            "rate": rate,
            "throughput": res.throughput,
            "normalized": res.throughput / base if base else 0.0,
            "alive": len(wafer.with_faults(rep.failed_dies,
                                           rep.failed_links).alive_dies()),
            "class": rep.classify(),
        })
    return out
