"""Replan governor: the control plane between the fault/repair timeline
and :func:`repro_torch.core.plan.replan_serve` (elastic serving under fault
*streams*, not fault *points*).

Copy of ``repro.serve.governor`` (the port imports nothing of ``repro``):
the reference's names, constants and arithmetic, in its order, so
results are bitwise equal to the reference's.

PR 6's recovery path replans on every :class:`FaultEvent`.  That is
correct for a single permanent die fault, but real wafers deliver event
streams — a flapping D2D link alone would trigger a full
solve+migration cycle per edge, thrashing plans and melting steady-state
SLOs.  The governor sits in front of the replan path and decides, per
coalesced batch of events, whether a replan is *worth it*:

* **Debounce** — events arriving within ``coalesce_s`` of each other
  merge into one net topology change before any decision is made.  A
  fail/repair pair of the same link inside one window cancels out into
  a no-op.
* **Hysteresis** — the net change is priced with the same decode cost
  model the plan was solved with (:func:`predict_plan_throughput`: the
  current plan re-simulated on the changed wafer).  If the predicted
  capacity delta is below the ``hysteresis`` threshold the change is
  *absorbed*: the wafer state advances and the executor's cost surface
  recalibrates, but the plan (and every admitted request's contract)
  stands — no migration, no pause.
* **Cached revert** — a repair that restores a topology whose plan is
  already in the fault-keyed plan cache replans for free (disk read, no
  solver call), so reverting to the healthy plan after a repair bypasses
  the hysteresis check and never burns replan budget.
* **Backoff + budget** — each executed replan doubles a cool-down
  (``backoff_base_s`` up to ``backoff_max_s``) during which further
  events keep coalescing, and at most ``replan_budget`` replans may run
  per rolling ``window_s``.  A link flapping faster than the backoff
  settles into the *conservative* (degraded) plan instead of thrashing;
  the one exception is correctness: an event that kills a die the
  current plan decodes on forces an immediate replan past both limits.

Every decision — including the skips — is logged as a typed
:class:`GovernorEvent`, the raw material of
``results/bench/serve_chaos_events.csv``.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.serve.engine import FaultEvent


@dataclass(frozen=True)
class GovernorConfig:
    """Knobs of the replan governor (see module docstring).

    Defaults are tuned for the virtual-clock chaos benchmark: a link
    flapping with a sub-second period coalesces and backs off into the
    conservative plan within ``replan_budget`` replans, while a
    one-shot die fault (the PR-6 scenario) replans immediately.
    """
    coalesce_s: float = 0.25    # debounce window: quiet time before deciding
    hysteresis: float = 0.05    # min predicted |capacity delta| to replan
    backoff_base_s: float = 1.0  # cool-down after a replan (doubles each
    backoff_max_s: float = 60.0  # consecutive replan, capped here)
    replan_budget: int = 3      # max replans per rolling window_s
    window_s: float = 60.0      # budget window; also resets the backoff


@dataclass(frozen=True)
class GovernorEvent:
    """One governor decision, logged whether or not it replanned."""
    time: float
    action: str               # replan | apply | noop | defer
    reason: str               # plan-die-dead | capacity-loss |
    #                           capacity-upside | revert-cached |
    #                           hysteresis | budget-exhausted |
    #                           coalesced-cancel | backoff
    n_coalesced: int          # timeline events merged into this decision
    failed_dies: tuple[int, ...] = ()
    failed_links: tuple[tuple[int, int], ...] = ()
    repaired_dies: tuple[int, ...] = ()
    repaired_links: tuple[tuple[int, int], ...] = ()
    capacity_delta: float = 0.0  # 1 - predicted thr on new wafer / plan's
    thr_ref: float = 0.0         # plan's predicted tokens/s at adoption
    thr_est: float = 0.0         # current plan re-simulated on new wafer
    cached: bool = False         # replan satisfied from the plan cache
    replans_in_window: int = 0   # executed replans inside window_s
    backoff_s: float = 0.0       # cool-down armed after this decision

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclass(frozen=True)
class GovernorDecision:
    """What the engine should do *now*.  ``action`` is ``"replan"``
    (run the full recover path on ``event``), ``"apply"`` (absorb the
    topology change, keep the plan) or ``"noop"`` (the coalesced events
    cancelled out)."""
    action: str
    event: FaultEvent
    reason: str
    cached: bool = False


def predict_plan_throughput(plan, cfg, wafer) -> float:
    """Decode throughput of ``plan``'s solved configuration re-simulated
    on ``wafer`` — the governor's capacity estimator.  Same cost surface
    as :class:`repro_torch.serve.engine.CostModelExecutor` calibration (one
    anchor, full batch/context), so hysteresis decisions and the engine
    clock agree on what a topology change costs.  Returns 0.0 when the
    plan cannot run on ``wafer`` at all (a plan die died, or routing is
    cut so the simulation comes back non-finite)."""
    from repro_torch.wafer.simulator import (ParallelDegrees, StepCostContext,
                                       simulate_decode_batch)
    dies = list(plan.plan.alive_dies)
    if any(not wafer.alive(d) for d in dies):
        return 0.0
    deg = ParallelDegrees(*plan.plan.degrees_tuple(),
                          seq_par=plan.plan.seq_par)
    ctx = StepCostContext(wafer, cfg, max(plan.max_batch, 1),
                          max(plan.max_seq, 1), plan.plan.engine,
                          dies=dies, objective="decode")
    res = simulate_decode_batch(ctx, [deg])[0]
    return res.throughput if math.isfinite(res.step_time) else 0.0


def _norm_link(link) -> tuple[int, int]:
    a, b = link
    return (a, b) if a <= b else (b, a)


@dataclass
class ReplanGovernor:
    """Stateful decision loop over an engine run (one instance per
    :class:`~repro_torch.serve.engine.ServeEngine`).  The engine feeds it
    timeline events (:meth:`observe`) and polls :meth:`decide` once per
    iteration; all state is deterministic functions of the event times,
    so governed runs replay bit-for-bit on a virtual clock."""

    config: GovernorConfig = field(default_factory=GovernorConfig)
    events: list[GovernorEvent] = field(default_factory=list)

    def __post_init__(self) -> None:
        self._pending: list[FaultEvent] = []
        self._last_observed = -math.inf
        self._next_allowed = -math.inf
        self._consecutive = 0          # backoff doubling level
        self._replan_times: list[float] = []
        self._last_replan: Optional[float] = None
        self._deferring = False        # "defer" logged once per episode

    # -- engine-facing protocol -------------------------------------------
    @property
    def pending(self) -> int:
        """Coalescing timeline events not yet resolved to a decision."""
        return len(self._pending)

    def observe(self, ev: FaultEvent) -> None:
        """A timeline event fired: start (or extend) the debounce
        window.  No decision is made here — the engine polls
        :meth:`decide` once the window closes."""
        self._pending.append(ev)
        self._last_observed = max(self._last_observed, ev.time)

    def next_deadline(self) -> Optional[float]:
        """When the idle engine must wake the governor: the close of the
        debounce window, or the backoff expiry once a decision was
        deferred.  ``None`` when nothing is pending."""
        if not self._pending:
            return None
        d = self._last_observed + self.config.coalesce_s
        return max(d, self._next_allowed) if self._deferring else d

    def decide(self, now: float, *, plan, wafer, cfg,
               cache_dir: Optional[str] = None
               ) -> Optional[GovernorDecision]:
        """Resolve the pending events into at most one decision.
        Returns ``None`` while the debounce window is open or a backoff
        deferral holds."""
        cfg_g = self.config
        if self._last_replan is not None \
                and now - self._last_replan >= cfg_g.window_s:
            self._consecutive = 0  # a quiet window resets the doubling
        if not self._pending:
            return None
        if now < self._last_observed + cfg_g.coalesce_s:
            return None  # debounce window still open
        n = len(self._pending)
        failed_d, failed_l, repaired_d, repaired_l = self._net(wafer)
        if not (failed_d or failed_l or repaired_d or repaired_l):
            # e.g. a link failed and repaired inside one window
            ev = FaultEvent(time=now)
            return self._resolve("noop", now, ev, "coalesced-cancel", n)
        ev = FaultEvent(time=now,
                        failed_dies=tuple(failed_d),
                        failed_links=tuple(failed_l),
                        repaired_dies=tuple(repaired_d),
                        repaired_links=tuple(repaired_l))
        # correctness first: the current plan decodes on a die that just
        # died — the plan cannot run, replan past backoff and budget
        dead = set(failed_d)
        if any(d in dead for d in plan.plan.alive_dies):
            return self._fire(now, ev, "plan-die-dead", n,
                              delta=1.0, thr_ref=0.0, thr_est=0.0)
        if now < self._next_allowed:
            if not self._deferring:
                self._deferring = True
                self._log(now, "defer", "backoff", n, ev,
                          backoff_s=self._next_allowed - now)
            return None
        new_wafer = wafer.with_faults(failed_d, failed_l) \
                         .with_repairs(repaired_d, repaired_l)
        thr_ref = float(plan.predicted.get("tokens_per_s") or 0.0)
        thr_est = predict_plan_throughput(plan, cfg, new_wafer)
        if thr_ref > 0:
            delta = 1.0 - thr_est / thr_ref
        else:
            delta = 1.0 if thr_est <= 0 else 0.0
        self._prune(now)
        cached_plan = self._probe_cached(plan, cfg, new_wafer, cache_dir,
                                         thr_ref) \
            if (repaired_d or repaired_l) else None
        if cached_plan is not None:
            # plan cache makes the revert free: no solver call, no
            # budget burn — but it still arms the backoff, so a
            # flapping link cannot thrash through cheap reverts
            return self._fire(now, ev, "revert-cached", n, cached=True,
                              delta=delta, thr_ref=thr_ref,
                              thr_est=thr_est)
        # repaired dies the current plan cannot use are invisible to
        # thr_est (the plan's die set is fixed); count them as upside
        gain = len(repaired_d) / max(len(plan.plan.alive_dies), 1)
        if abs(delta) >= cfg_g.hysteresis or gain >= cfg_g.hysteresis:
            if len(self._replan_times) >= cfg_g.replan_budget:
                return self._resolve("apply", now, ev, "budget-exhausted",
                                     n, delta=delta, thr_ref=thr_ref,
                                     thr_est=thr_est)
            reason = "capacity-loss" if delta > 0 else "capacity-upside"
            return self._fire(now, ev, reason, n, delta=delta,
                              thr_ref=thr_ref, thr_est=thr_est)
        return self._resolve("apply", now, ev, "hysteresis", n,
                             delta=delta, thr_ref=thr_ref, thr_est=thr_est)

    # -- internals ---------------------------------------------------------
    def _net(self, wafer):
        """Net topology change of the pending events relative to the
        live wafer (last writer wins per die/link; changes that restore
        the current state drop out)."""
        die_status: dict[int, bool] = {}       # True = ends failed
        link_status: dict[tuple[int, int], bool] = {}
        for ev in self._pending:
            for d in ev.failed_dies:
                die_status[d] = True
            for l in ev.failed_links:
                link_status[_norm_link(l)] = True
            for d in ev.repaired_dies:
                die_status[d] = False
            for l in ev.repaired_links:
                link_status[_norm_link(l)] = False
        failed_d = sorted(d for d, s in die_status.items()
                          if s and wafer.alive(d))
        repaired_d = sorted(d for d, s in die_status.items()
                            if not s and not wafer.alive(d))
        failed_l = sorted(l for l, s in link_status.items()
                          if s and l not in wafer.failed_links)
        repaired_l = sorted(l for l, s in link_status.items()
                            if not s and l in wafer.failed_links)
        return failed_d, failed_l, repaired_d, repaired_l

    def _probe_cached(self, plan, cfg, new_wafer, cache_dir, thr_ref):
        """A cached plan for the post-change wafer that beats the
        current one, or None.  Peeks the fault-keyed serve-plan cache
        without ever calling the solver."""
        from repro_torch.core.plan import cached_serve_plan
        cand = cached_serve_plan(plan, cfg, new_wafer, cache_dir=cache_dir)
        if cand is None or cand.plan_hash == plan.plan_hash:
            return None
        if float(cand.predicted.get("tokens_per_s") or 0.0) <= thr_ref:
            return None
        return cand

    def _prune(self, now: float) -> None:
        w = self.config.window_s
        self._replan_times = [t for t in self._replan_times
                              if now - t < w]

    def _fire(self, now: float, ev: FaultEvent, reason: str, n: int, *,
              cached: bool = False, delta: float, thr_ref: float,
              thr_est: float) -> GovernorDecision:
        """Commit to a replan: burn budget (unless cached), arm the
        exponential backoff, log, clear the window."""
        if not cached:
            self._replan_times.append(now)
        self._last_replan = now
        self._consecutive += 1
        backoff = min(self.config.backoff_base_s
                      * 2 ** (self._consecutive - 1),
                      self.config.backoff_max_s)
        self._next_allowed = now + backoff
        self._pending.clear()
        self._deferring = False
        self._log(now, "replan", reason, n, ev, delta=delta,
                  thr_ref=thr_ref, thr_est=thr_est, cached=cached,
                  backoff_s=backoff)
        return GovernorDecision("replan", ev, reason, cached)

    def _resolve(self, action: str, now: float, ev: FaultEvent,
                 reason: str, n: int, *, delta: float = 0.0,
                 thr_ref: float = 0.0, thr_est: float = 0.0
                 ) -> GovernorDecision:
        """Resolve the window without a replan (absorb or no-op)."""
        self._pending.clear()
        self._deferring = False
        self._log(now, action, reason, n, ev, delta=delta,
                  thr_ref=thr_ref, thr_est=thr_est)
        return GovernorDecision(action, ev, reason, False)

    def _log(self, now: float, action: str, reason: str, n: int,
             ev: FaultEvent, *, delta: float = 0.0, thr_ref: float = 0.0,
             thr_est: float = 0.0, cached: bool = False,
             backoff_s: float = 0.0) -> None:
        self.events.append(GovernorEvent(
            time=now, action=action, reason=reason, n_coalesced=n,
            failed_dies=tuple(ev.failed_dies),
            failed_links=tuple(tuple(l) for l in ev.failed_links),
            repaired_dies=tuple(ev.repaired_dies),
            repaired_links=tuple(tuple(l) for l in ev.repaired_links),
            capacity_delta=delta, thr_ref=thr_ref, thr_est=thr_est,
            cached=cached,
            replans_in_window=len(self._replan_times),
            backoff_s=backoff_s))
