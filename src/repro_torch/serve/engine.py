"""Continuous-batching serving engine, executing off a compiled ServePlan.

Copy of ``repro.serve.engine`` (the port imports nothing of ``repro``):
the reference's names, constants and arithmetic, in its order, so
results are bitwise equal to the reference's.

The engine is the runtime half of the serving pipeline (solve → plan →
serve): :func:`repro_torch.core.plan.compile_serve_plan` proves a decode mesh +
KV budget with the wafer cost model, and this module schedules real
requests against that contract —

* :class:`ContinuousBatchingScheduler` — the request queue: strict-FCFS
  iteration-level admission into ``max_batch`` decode slots, bounded by
  the plan's KV-token budget (a request's whole context window is
  reserved at admission, so an admitted request can never OOM the cache
  mid-generation), prefill/decode split, per-request SLO accounting.
* :class:`ServeEngine` — the iteration loop: deliver arrivals → admit +
  prefill → one decode iteration for every in-flight sequence → retire
  finished requests.  The loop is clock-agnostic: a :class:`WallClock`
  serves real jax execution (repro_torch.launch.serve) while a
  :class:`VirtualClock` driven by executor-reported durations makes whole
  arrival-rate sweeps deterministic (benchmarks/serve_decode.py and the
  ``serve/decode_baseline`` drift gate).
* :class:`CostModelExecutor` — a model-free executor whose step durations
  come from the same decode cost model the plan was solved with
  (latency linearized in in-flight sequences and resident cache tokens),
  so scheduler experiments run at simulation speed without touching jax.

Scheduling policy (kept deliberately simple and fully deterministic):
admission is strict FCFS — a request that does not fit (no free slot, or
KV budget exhausted) blocks everything behind it.  No bypass means no
starvation, and makes the admission order a pure function of arrivals,
which the drift gate hashes.  The one exception: a request that can
*never* fit the plan (context over ``max_seq`` or the whole KV budget)
is rejected with a recorded reason instead of deadlocking the queue.

Elastic serving (§VIII-F under live traffic): the engine accepts a
timeline of :class:`FaultEvent`s.  When one fires mid-run, the engine
re-solves the decode mesh on the surviving dies
(:func:`repro_torch.core.plan.replan_serve`), plans a KV-cache migration into
the new contract (:mod:`repro_torch.serve.migrate`), lets the executor carry
it out (``migrate()`` — a priced pause on the cost model, a real
``graft_cache_slots`` move on jax), and re-admits evicted sequences as
continuations with prefix-recompute accounting.  Each recovery is
recorded as a :class:`RecoveryEvent` with SLO-dip depth and
time-to-recover, which ``benchmarks/serve_fault.py`` gates on.
"""

from __future__ import annotations

import hashlib
import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence


@dataclass(frozen=True)
class Request:
    """One generation request as submitted by a client.

    ``prior_tokens`` marks a *continuation*: when a fault-triggered
    migration evicts an in-flight sequence, the scheduler re-queues it
    as a fresh request whose prompt is the full evicted context (prefix
    recompute) and whose budget is the remaining tokens; ``prior_tokens``
    carries how many tokens the rid already generated before eviction.
    Client submissions leave it at 0.
    """
    rid: int
    arrival: float  # seconds on the engine clock
    prompt_len: int
    max_new_tokens: int
    slo_ttft: float = math.inf  # s: arrival -> first token
    slo_tpot: float = math.inf  # s: per output token (steady decode)
    prior_tokens: int = 0


def validate_request(req: Request) -> None:
    """Fail fast on requests that would violate scheduler assertions deep
    in the decode loop (``mark_decoded`` requires ``0 < tokens_done <
    max_new_tokens``; a negative prompt would corrupt KV accounting)."""
    if req.max_new_tokens <= 0:
        raise ValueError(
            f"request {req.rid}: max_new_tokens must be positive "
            f"(got {req.max_new_tokens})")
    if req.prompt_len < 0:
        raise ValueError(
            f"request {req.rid}: prompt_len must be non-negative "
            f"(got {req.prompt_len})")


@dataclass
class RequestState:
    """Lifecycle + accounting of one admitted request."""
    req: Request
    slot: int = -1
    kv_reserved: int = 0  # budget tokens reserved at admission
    admitted_at: float = math.nan
    first_token_at: float = math.nan
    finished_at: float = math.nan
    tokens_done: int = 0  # generated tokens (prefill yields the first)
    prefilled_tokens: int = 0  # prompt tokens whose KV is resident
    #                            (chunked-prefill checkpoint; == prompt_len
    #                            once prefill completed)
    token_times: list[float] = field(default_factory=list)
    tokens: list[int] = field(default_factory=list)  # generated token ids

    @property
    def done(self) -> bool:
        return self.tokens_done >= self.req.max_new_tokens

    @property
    def context_len(self) -> int:
        """Tokens currently resident in this request's KV slot."""
        return self.req.prompt_len + self.tokens_done

    @property
    def resident_tokens(self) -> int:
        """KV tokens *actually* resident right now.  Differs from
        ``context_len`` only mid-prefill (``tokens_done == 0`` with a
        partial chunked prefill): migration moves and prices what is
        resident, not the full would-be context."""
        return self.context_len if self.tokens_done > 0 \
            else self.prefilled_tokens

    # -- SLO accounting ----------------------------------------------------
    @property
    def ttft(self) -> float:
        return self.first_token_at - self.req.arrival

    @property
    def tpots(self) -> list[float]:
        """Inter-token latencies of the steady decode phase."""
        ts = [self.first_token_at] + self.token_times
        return [b - a for a, b in zip(ts, ts[1:])]

    @property
    def slo_ok(self) -> bool:
        tp = self.tpots
        return self.ttft <= self.req.slo_ttft and \
            (not tp or max(tp) <= self.req.slo_tpot)


class ContinuousBatchingScheduler:
    """Strict-FCFS iteration-level admission under the ServePlan contract.

    Invariants (asserted here, property-tested in tests/test_serve.py):

    * at most ``plan.max_batch`` requests in flight,
    * reserved KV tokens never exceed ``plan.kv_budget_tokens``,
    * admission order == arrival order (no bypass),
    * a request decodes only after its prefill completed, gains exactly
      one token per decode iteration, and leaves its slot the iteration
      it finishes.
    """

    def __init__(self, plan):
        self.plan = plan
        self.waiting: deque[Request] = deque()
        self.active: dict[int, RequestState] = {}  # slot -> state
        self.free_slots = list(range(plan.max_batch - 1, -1, -1))
        self.kv_reserved = 0
        self.finished: list[RequestState] = []
        self.admission_trace: list[tuple[int, int]] = []  # (iteration, rid)
        self.iterations = 0
        self.occupancy_sum = 0  # Σ active per iteration (mean occupancy)
        self.rejected: list[tuple[Request, str]] = []  # never-fit requests
        self.evicted_partials: list[RequestState] = []  # migration evictions
        self.readmitted = 0  # continuations re-queued by migrations
        self.drain_hold = False  # drain policy: block admission until empty

    # -- queue -------------------------------------------------------------
    def submit(self, req: Request) -> None:
        validate_request(req)
        if self.waiting and req.arrival < self.waiting[-1].arrival:
            raise ValueError("submissions must be in arrival order")
        self.waiting.append(req)

    def reject_never_fit(self, now: float) -> list[Request]:
        """Pop head-of-line requests that can *never* be admitted under
        the current plan (context over ``max_seq`` or over the whole KV
        budget) into ``self.rejected`` with a recorded reason, so the
        queue behind them keeps being served.  Requests that merely have
        to wait for headroom are left in place (strict FCFS)."""
        out: list[Request] = []
        while self.waiting:
            head = self.waiting[0]
            cost = self.kv_cost(head)
            if cost <= self.plan.max_seq and \
                    cost <= self.plan.kv_budget_tokens:
                break
            self.waiting.popleft()
            limit = (f"max_seq={self.plan.max_seq}"
                     if cost > self.plan.max_seq else
                     f"KV budget={self.plan.kv_budget_tokens} tokens")
            self.rejected.append(
                (head, f"prompt+gen={cost} tokens can never fit {limit}"))
            out.append(head)
        return out

    def kv_cost(self, req: Request) -> int:
        return self.plan.cache_tokens_per_request(req.prompt_len,
                                                  req.max_new_tokens)

    @property
    def kv_headroom(self) -> int:
        return self.plan.kv_budget_tokens - self.kv_reserved

    def admissible(self) -> bool:
        """Can the head-of-line request start this iteration?"""
        if self.drain_hold:
            # drain readmission policy: after a migration, no admission
            # until every surviving in-flight sequence has retired
            if self.active:
                return False
            self.drain_hold = False
        if not (self.waiting and self.free_slots):
            return False
        cost = self.kv_cost(self.waiting[0])
        # a context over max_seq can never fit the cache's sequence dim
        return cost <= self.plan.max_seq and cost <= self.kv_headroom

    # -- iteration-level admission ----------------------------------------
    def admit(self, now: float) -> list[RequestState]:
        """Admit up to ``prefill_chunk`` head-of-line requests into free
        slots (strict FCFS: the first request that does not fit blocks
        the rest — deterministic, starvation-free)."""
        out: list[RequestState] = []
        while len(out) < self.plan.prefill_chunk and self.admissible():
            req = self.waiting.popleft()
            st = RequestState(req, slot=self.free_slots.pop(),
                              kv_reserved=self.kv_cost(req),
                              admitted_at=now)
            self.kv_reserved += st.kv_reserved
            assert self.kv_reserved <= self.plan.kv_budget_tokens
            assert len(self.active) < self.plan.max_batch
            self.active[st.slot] = st
            self.admission_trace.append((self.iterations, req.rid))
            out.append(st)
        return out

    def mark_prefilled(self, states: Sequence[RequestState],
                       now: float) -> None:
        """Prefill completion: the prefill pass yields each request's
        first generated token (TTFT is measured here)."""
        for st in states:
            assert st.tokens_done == 0
            st.prefilled_tokens = st.req.prompt_len
            st.first_token_at = now
            st.tokens_done = 1
            self._retire_if_done(st, now)

    # -- decode iterations -------------------------------------------------
    def decode_batch(self) -> list[RequestState]:
        """In-flight states this iteration advances (prefilled, un-done),
        in slot order so the executor's batch layout is stable."""
        return [self.active[s] for s in sorted(self.active)
                if self.active[s].tokens_done > 0]

    def mark_decoded(self, states: Sequence[RequestState],
                     now: float) -> None:
        self.iterations += 1
        self.occupancy_sum += len(states)
        for st in states:
            assert 0 < st.tokens_done < st.req.max_new_tokens
            st.tokens_done += 1
            st.token_times.append(now)
            self._retire_if_done(st, now)

    def _retire_if_done(self, st: RequestState, now: float) -> None:
        if st.done:
            st.finished_at = now
            del self.active[st.slot]
            self.free_slots.append(st.slot)
            self.kv_reserved -= st.kv_reserved
            assert self.kv_reserved >= 0
            self.finished.append(st)

    # -- plan-to-plan migration (elastic serving) --------------------------
    def apply_migration(self, new_plan, mig, now: float,
                        policy: str = "live") -> None:
        """Adopt a post-fault plan: remap survivors into their new slots,
        rebuild the free list and KV reservation for the new contract,
        and re-queue evicted sequences as continuations.

        A continuation re-enters *head-of-line* in original admission
        order (the displaced were admitted before anything still
        waiting, so FCFS is preserved across the migration) with its
        full evicted context as the prompt — the prefix is recomputed at
        prefill cost, honestly charged, rather than the request being
        dropped.  ``policy="drain"`` additionally holds all admission
        until the surviving in-flight sequences retire.
        """
        import dataclasses
        old_active = dict(self.active)
        self.plan = new_plan
        self.active = {}
        for rid, old_slot, new_slot in mig.survivors:
            st = old_active.pop(old_slot)
            assert st.req.rid == rid
            st.slot = new_slot
            self.active[new_slot] = st
        self.free_slots = [s for s in range(new_plan.max_batch - 1, -1, -1)
                           if s not in self.active]
        self.kv_reserved = sum(st.kv_reserved
                               for st in self.active.values())
        assert self.kv_reserved <= new_plan.kv_budget_tokens
        assert len(self.active) <= new_plan.max_batch
        conts: list[Request] = []
        for rid, old_slot in mig.evicted:
            st = old_active.pop(old_slot)
            assert st.req.rid == rid
            self.evicted_partials.append(st)
            conts.append(dataclasses.replace(
                st.req, arrival=now, prompt_len=st.context_len,
                max_new_tokens=st.req.max_new_tokens - st.tokens_done,
                prior_tokens=st.req.prior_tokens + st.tokens_done))
        assert not old_active, "migration must account for every slot"
        for cont in reversed(conts):  # earliest-admitted back at the head
            self.waiting.appendleft(cont)
        self.readmitted += len(conts)
        if policy == "drain":
            self.drain_hold = True

    @property
    def drained(self) -> bool:
        return not self.waiting and not self.active


# ---------------------------------------------------------------------------
# clocks
# ---------------------------------------------------------------------------


class WallClock:
    """Real time: executor durations are ignored, elapsed time is
    whatever the jax calls actually took."""

    def now(self) -> float:
        return time.perf_counter()

    def advance(self, dt: Optional[float]) -> float:
        return self.now()

    def wait_until(self, t: float) -> float:
        # serving loop has nothing to run: don't busy-spin the host
        dt = t - self.now()
        if dt > 0:
            time.sleep(min(dt, 0.05))
        return self.now()


class VirtualClock:
    """Deterministic simulation time driven by executor-reported
    durations (benchmarks, tests, the drift gate)."""

    def __init__(self, start: float = 0.0):
        self.t = start

    def now(self) -> float:
        return self.t

    def advance(self, dt: Optional[float]) -> float:
        self.t += float(dt or 0.0)
        return self.t

    def wait_until(self, t: float) -> float:
        self.t = max(self.t, t)
        return self.t


# ---------------------------------------------------------------------------
# fault timeline + recovery accounting (elastic serving)
# ---------------------------------------------------------------------------

# rolling window (in engine iterations) over which throughput is measured
# for the recovery metrics, and the fraction of the pre-fault rate —
# scaled by the degraded plan's capacity ratio — at which the engine
# declares itself recovered.
RECOVERY_WINDOW = 16
RECOVERY_FRACTION = 0.85


@dataclass(frozen=True)
class FaultEvent:
    """One edge of the fault/repair timeline, scheduled on the engine
    clock (seconds relative to the engine start, like
    ``Request.arrival``).  Events compose in time order: each event's
    dies/links fail *in addition to* whatever already failed, and its
    ``repaired_*`` entries come back online (a flapping link is a
    fail/repair/fail/... sequence over the same link).  Within one event
    faults apply before repairs.  Generators for seeded flapping /
    cascade / MTTF-MTTR traces live in
    :class:`repro_torch.wafer.fault.FaultTrace`."""
    time: float
    failed_dies: tuple[int, ...] = ()
    failed_links: tuple[tuple[int, int], ...] = ()
    repaired_dies: tuple[int, ...] = ()
    repaired_links: tuple[tuple[int, int], ...] = ()


@dataclass
class RecoveryEvent:
    """Per-fault recovery record: what the replan+migration did and how
    the SLO timeline absorbed it.  ``dip_depth``/``time_to_recover``/
    ``thr_after`` are filled in post-run (they need the samples that come
    *after* the event)."""
    time: float
    failed_dies: tuple[int, ...]
    failed_links: tuple[tuple[int, int], ...]
    old_plan_hash: str
    new_plan_hash: str
    old_max_batch: int
    new_max_batch: int
    old_kv_budget: int
    new_kv_budget: int
    n_active: int          # in flight when the fault hit
    n_survivors: int
    n_evicted: int
    moved_bytes: float
    pause_s: float         # what the executor actually charged
    recompute_tokens: int  # evicted prefix tokens to re-prefill
    tokens_lost: int       # generated tokens whose KV was evicted
    capacity_ratio: float  # degraded/healthy predicted tokens_per_s
    thr_before: float      # rolling throughput entering the fault
    thr_after: float = 0.0   # post-recovery steady (peak rolling) rate
    dip_depth: float = 0.0   # 1 - mean rate during the dip / thr_before
    time_to_recover: float = 0.0
    recovered: bool = False
    # fault/repair-timeline accounting (defaults keep single-fault runs
    # and their pinned drift-gate baselines untouched)
    repaired_dies: tuple[int, ...] = ()
    repaired_links: tuple[tuple[int, int], ...] = ()
    reason: str = "fault"    # what triggered the replan (governor reason)
    cached: bool = False     # replan served from the plan cache (revert)
    thr_before_window: int = 0  # samples behind thr_before (< RECOVERY_WINDOW
    #                             means thr_before is a short-trace estimate
    #                             and `recovered` is never claimed against it)

    def to_dict(self) -> dict:
        import dataclasses
        return dataclasses.asdict(self)


def _window_throughput(samples: Sequence[tuple]) -> float:
    """tokens/s over (t_end, tokens, duration, kind) iteration samples."""
    toks = sum(s[1] for s in samples)
    dt = sum(s[2] for s in samples)
    return toks / dt if dt > 0 else 0.0


def rolling_peak_throughput(samples: Sequence[tuple],
                            w: int = RECOVERY_WINDOW,
                            kind: Optional[str] = None, *,
                            require_full: bool = False) -> float:
    """Peak ``w``-sample rolling throughput.  With ``kind="decode"`` only
    decode iterations count — the steady decode rate is what the
    fault-recovery gate compares against a fresh solve on the degraded
    wafer (all-sample windows depend on how prefills happened to
    interleave, which a mid-run migration legitimately perturbs).

    Short traces (fewer than ``w`` matching samples) fall back to the
    largest window available — the whole trace — which is an *estimate*,
    not a steady rate: callers comparing against it must not treat it as
    a recovery target (:meth:`ServeEngine._finalize_events` refuses to
    set ``recovered`` off a short pre-fault window for exactly this
    reason).  Pass ``require_full=True`` to get 0.0 instead of the
    padded estimate."""
    samples = [s for s in samples if kind is None or s[3] == kind]
    if not samples:
        return 0.0
    if len(samples) < w:
        return 0.0 if require_full else _window_throughput(samples)
    return max(_window_throughput(samples[j:j + w])
               for j in range(len(samples) - w + 1))


# ---------------------------------------------------------------------------
# per-expert router accounting (MoE serving)
# ---------------------------------------------------------------------------


class ExpertRouterSim:
    """Seeded per-iteration router simulation for MoE decode accounting.

    The cost-model executor has no token content to route, but the plan's
    capacity contract still needs exercising: each decode iteration routes
    its ``t`` in-flight tokens top-k over the expert pool (grouped
    routing first keeps ``top_k_groups`` groups, deepseek-v3 style) and
    admits at most ``cap = max(1, round(t·top_k/E·capacity_factor))``
    assignments per expert — the exact slot formula of
    :func:`repro_torch.models.moe.moe_ffn`, so plan-time drop statistics and
    the jax kernel's drop behaviour share one capacity law.  Assignments
    over capacity are *dropped and counted*, never silent.

    PURE accounting: seeded rng private to this object, no engine state
    read or written — admission traces and the sample timeline of a run
    with accounting are bit-for-bit those of a run without.
    """

    def __init__(self, cfg, ep: int = 1, *, seed: int = 0):
        import random
        self.cfg = cfg
        self.ep = max(1, int(ep))
        self.rng = random.Random(seed)
        self.load = [0] * cfg.n_experts  # admitted assignments per expert
        self.routed = 0   # token->expert assignments simulated
        self.dropped = 0  # assignments over expert capacity

    def _route_one(self) -> list[int]:
        cfg = self.cfg
        if cfg.n_expert_groups:
            gsz = cfg.n_experts // cfg.n_expert_groups
            groups = self.rng.sample(range(cfg.n_expert_groups),
                                     min(cfg.top_k_groups,
                                         cfg.n_expert_groups))
            pool = [g * gsz + j for g in groups for j in range(gsz)]
            return self.rng.sample(pool, min(cfg.top_k, len(pool)))
        return self.rng.sample(range(cfg.n_experts), cfg.top_k)

    def observe(self, t: int) -> None:
        """Route one decode iteration of ``t`` tokens."""
        if t <= 0:
            return
        cfg = self.cfg
        cap = int(max(1, round(t * cfg.top_k / cfg.n_experts
                               * cfg.capacity_factor)))
        counts = [0] * cfg.n_experts
        for _ in range(t):
            for e in self._route_one():
                counts[e] += 1
                self.routed += 1
                if counts[e] <= cap:
                    self.load[e] += 1
                else:
                    self.dropped += 1

    @property
    def drop_rate(self) -> float:
        return self.dropped / self.routed if self.routed else 0.0

    @property
    def load_cv(self) -> float:
        """Coefficient of variation of per-expert admitted load (0 =
        perfectly balanced)."""
        mean = sum(self.load) / len(self.load)
        if mean <= 0:
            return 0.0
        var = sum((x - mean) ** 2 for x in self.load) / len(self.load)
        return math.sqrt(var) / mean

    def ep_group_load(self) -> tuple[int, ...]:
        """Admitted load per EP expert group (contiguous expert shards,
        matching the solver's placement); empty when ep == 1."""
        if self.ep <= 1 or self.cfg.n_experts % self.ep:
            return ()
        per = self.cfg.n_experts // self.ep
        return tuple(sum(self.load[g * per:(g + 1) * per])
                     for g in range(self.ep))


# ---------------------------------------------------------------------------
# executors
# ---------------------------------------------------------------------------


class CostModelExecutor:
    """Executor whose step durations come from the decode cost model the
    plan was solved with — no jax, no weights, simulation speed.

    Decode-iteration latency is linearized from three anchor evaluations
    of :func:`repro_torch.wafer.simulator.simulate_decode_batch` as
    ``lat ≈ a + b·n_active + c·resident_cache_tokens`` (the cost model is
    affine in both to first order: the weight-read term is occupancy-free,
    flops scale with sequences, the KV scan scales with resident tokens).
    Prefill is charged per prompt token at the compute-bound rate
    (``prefill_eff`` tokens prefill in the time one token decodes).
    """

    def __init__(self, plan, cfg, wafer=None, *, prefill_eff: int = 16):
        from repro_torch.wafer.topology import Wafer, WaferSpec
        if wafer is None:
            wafer = Wafer(WaferSpec(rows=plan.plan.wafer_rows,
                                    cols=plan.plan.wafer_cols),
                          frozenset(plan.plan.failed_dies),
                          frozenset(tuple(l)
                                    for l in plan.plan.failed_links))
        self.cfg = cfg
        self.prefill_eff = prefill_eff
        self._next_tok = 0
        self._calibrate(plan, wafer)

    def _calibrate(self, plan, wafer) -> None:
        """Fit the affine latency surface for ``plan`` on ``wafer`` (run
        at construction, and again by ``migrate`` when a fault swaps the
        plan for one solved on the degraded wafer)."""
        from repro_torch.wafer.simulator import (StepCostContext,
                                           simulate_decode_batch)
        self.plan = plan
        # decode_degrees() folds the serve plan's ep in, so an EP plan's
        # latency surface prices the all-to-all + sharded expert reads
        deg = plan.decode_degrees()
        B, S = plan.max_batch, plan.max_seq
        dies = list(plan.plan.alive_dies)

        def lat(b, s):
            ctx = StepCostContext(wafer, self.cfg, max(b, 1), max(s, 1),
                                  plan.plan.engine, dies=dies,
                                  objective="decode")
            return simulate_decode_batch(ctx, [deg])[0].step_time

        l_full = lat(B, S)
        l_half_b = lat(max(B // 2, 1), S)
        l_half_s = lat(B, max(S // 2, 1))
        # a half anchor can be infeasible for the solved degrees (e.g. the
        # dp degree exceeds the halved batch) and come back inf — pinning
        # it to the full-shape latency zeroes that slope instead of
        # letting a non-finite duration poison the engine clock
        if not math.isfinite(l_full):
            l_full = plan.predicted.get("token_latency") or 1e-3
        if not math.isfinite(l_half_b):
            l_half_b = l_full
        if not math.isfinite(l_half_s):
            l_half_s = l_full
        # solve a + b*n + c*(n*s) through the three anchors
        self.c = (l_full - l_half_s) / max(B * S - B * (S // 2), 1)
        bspan = max(B - B // 2, 1)
        self.b = (l_full - l_half_b
                  - self.c * (B * S - (B // 2) * S)) / bspan
        self.a = l_full - self.b * B - self.c * B * S
        self.prefill_tok = l_full / max(plan.max_batch, 1) \
            / self.prefill_eff + self.c

    def migrate(self, new_plan, mig, wafer=None) -> float:
        """Adopt a post-fault plan: refit the latency surface on the
        degraded wafer and charge the migration as a priced pause — the
        planner's deterministic estimate of re-shard + lost-shard
        recompute time (:class:`repro_torch.serve.migrate.KVMigration`)."""
        if wafer is None:
            wafer = new_plan.plan.wafer()
        self._calibrate(new_plan, wafer)
        return mig.est_pause_s

    def recalibrate(self, plan, wafer) -> None:
        """Refit the latency surface without a plan swap — the replan
        governor's *skip* decisions absorb a topology change (degraded
        routing slows the same plan down; a repair speeds it up) while
        keeping the contract, so only the cost surface moves."""
        self._calibrate(plan, wafer)

    def decode_latency(self, n_active: int, resident_tokens: int) -> float:
        return max(self.a + self.b * n_active
                   + self.c * resident_tokens, 1e-9)

    # -- executor protocol -------------------------------------------------
    def prefill(self, states: Sequence[RequestState]) -> float:
        return sum(self.prefill_tok * st.req.prompt_len for st in states)

    def prefill_chunk(self, states: Sequence[RequestState],
                      n_tokens: Sequence[int]) -> float:
        """One chunked-prefill pass: advance each state by its share of
        prompt tokens.  Priced at the same per-token rate as a whole
        prefill, so chunking splits the duration without changing the
        total — what it buys is preemption points (the engine checks the
        fault clock between chunks)."""
        return sum(self.prefill_tok * n for n in n_tokens)

    def decode(self, states: Sequence[RequestState]) -> float:
        resident = sum(st.context_len for st in states)
        for st in states:
            st.tokens.append(self._next_tok)
            self._next_tok += 1
        return self.decode_latency(len(states), resident)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@dataclass
class ServeReport:
    """Aggregate serving metrics of one engine run."""
    n_requests: int
    n_finished: int
    generated_tokens: int
    makespan: float
    tokens_per_s: float
    ttft_p50: float
    ttft_p99: float
    tpot_p50: float
    tpot_p99: float
    slo_attainment: float
    mean_occupancy: float
    iterations: int
    trace_hash: str
    # elastic-serving accounting (zero on fault-free runs)
    n_rejected: int = 0      # never-fit requests rejected, not crashed on
    n_evicted: int = 0       # in-flight sequences displaced by migrations
    n_readmitted: int = 0    # continuations re-queued (== n_evicted)
    rejected: tuple = ()     # (rid, reason) per rejected request
    recovery: tuple = ()     # RecoveryEvent.to_dict() per replan
    n_replans: int = 0       # plan swaps actually executed (== len(recovery))
    governor: tuple = ()     # GovernorEvent.to_dict() per governor decision
    # MoE router accounting (zero/empty on dense models — defaults keep
    # pinned dense drift-gate baselines untouched)
    moe_routed_tokens: int = 0   # token->expert assignments simulated
    moe_dropped_tokens: int = 0  # assignments over expert capacity
    moe_drop_rate: float = 0.0
    expert_load: tuple = ()      # admitted assignments per expert
    expert_load_cv: float = 0.0  # std/mean of expert_load (imbalance)
    ep_group_load: tuple = ()    # per-EP-group admitted load (ep > 1)

    def to_dict(self) -> dict:
        import dataclasses
        return dataclasses.asdict(self)


def _percentile(xs: list[float], q: float) -> float:
    """Nearest-rank percentile (no numpy: exact, platform-independent)."""
    if not xs:
        return math.nan
    s = sorted(xs)
    k = max(0, min(len(s) - 1, math.ceil(q / 100.0 * len(s)) - 1))
    return s[k]


class ServeEngine:
    """The iteration loop: arrivals → admission+prefill → decode → retire.

    ``executor`` provides ``prefill(states) -> duration`` and
    ``decode(states) -> duration`` (return None under a WallClock to let
    real elapsed time stand), and optionally ``migrate(new_plan, mig,
    wafer) -> duration`` for fault recovery.  ``on_iteration`` /
    ``on_recovery`` are optional hooks for logging/tracing.

    Elastic serving: pass ``faults`` (a timeline of :class:`FaultEvent`)
    plus the model ``cfg`` the plan was compiled for.  When an event
    fires, the engine re-solves on the survivors, migrates the resident
    KV cache and — per ``readmission`` — either re-queues evicted
    sequences live (``"live"``) or additionally holds new admissions
    until the survivors retire (``"drain"``).  ``wafer`` is the live
    wafer when the deployment runs a non-default :class:`WaferSpec` (the
    plan's grid-only record cannot reconstruct hardware constants).

    Fault *streams* (flapping links, cascades, repairs) should go
    through the replan governor: pass ``governor`` (a
    :class:`repro_torch.serve.governor.GovernorConfig`) and events are
    coalesced/debounced/hysteresis-filtered instead of each triggering
    an independent replan.  ``governor=None`` keeps the legacy
    one-replan-per-event behaviour bit-for-bit (the ``serve/fault``
    drift gate runs ungoverned).

    ``prefill_chunk_tokens`` opts into intra-step prefill preemption:
    prefill runs in chunks of that many prompt tokens per request and
    the engine re-checks the fault clock at every chunk boundary, so a
    fault landing mid-prefill preempts at the last completed chunk
    (checkpointed in ``RequestState.prefilled_tokens``) instead of
    being absorbed only at the iteration boundary.  ``None`` (default)
    keeps the single-pass prefill and its sample timeline bit-for-bit.
    """

    def __init__(self, plan, executor, *, clock=None, cfg=None, wafer=None,
                 faults: Sequence[FaultEvent] = (),
                 readmission: str = "live",
                 governor=None,
                 prefill_chunk_tokens: Optional[int] = None,
                 plan_cache_dir: Optional[str] = None,
                 plan_use_cache: bool = True,
                 on_iteration: Optional[Callable] = None,
                 on_recovery: Optional[Callable] = None):
        if readmission not in ("live", "drain"):
            raise ValueError(f"readmission must be 'live' or 'drain', "
                             f"got {readmission!r}")
        if faults and cfg is None:
            raise ValueError("fault recovery needs the model cfg the plan "
                             "was compiled for (pass cfg=...)")
        if prefill_chunk_tokens is not None and prefill_chunk_tokens <= 0:
            raise ValueError("prefill_chunk_tokens must be positive or None")
        self.plan = plan
        self.executor = executor
        self.clock = clock if clock is not None else VirtualClock()
        self.sched = ContinuousBatchingScheduler(plan)
        self.cfg = cfg
        self.wafer = wafer if wafer is not None else plan.plan.wafer()
        self.faults = tuple(sorted(faults, key=lambda e: e.time))
        self.readmission = readmission
        self.plan_cache_dir = plan_cache_dir
        self.plan_use_cache = plan_use_cache
        self.on_iteration = on_iteration
        self.on_recovery = on_recovery
        self.gov = None
        if governor is not None:
            if cfg is None:
                raise ValueError("the replan governor estimates capacity "
                                 "deltas with the decode cost model (pass "
                                 "cfg=...)")
            from repro_torch.serve.governor import GovernorConfig, ReplanGovernor
            self.gov = governor if isinstance(governor, ReplanGovernor) \
                else ReplanGovernor(governor if isinstance(governor,
                                                           GovernorConfig)
                                    else GovernorConfig())
        self.prefill_chunk_tokens = prefill_chunk_tokens
        # chunked prefill needs executor support; fall back to the whole
        # pass when the executor can't slice (e.g. a jax prefill that
        # only returns final-position logits)
        self._chunked = prefill_chunk_tokens is not None \
            and getattr(executor, "prefill_chunk", None) is not None
        self.router: Optional[ExpertRouterSim] = None
        if cfg is not None and getattr(cfg, "is_moe", False):
            self.router = ExpertRouterSim(cfg, getattr(plan, "ep", 1))
        self._fault_q: deque = deque()
        self.events: list[RecoveryEvent] = []
        # iteration timeline: (t_end, tokens, duration, kind) with kind in
        # prefill | decode | pause — the raw material of recovery metrics
        self.samples: list[tuple[float, int, float, str]] = []

    def _sample(self, t_end: float, tokens: int, dt: float,
                kind: str) -> None:
        self.samples.append((t_end, tokens, dt, kind))

    def _apply_event(self, ev: FaultEvent) -> None:
        """Fold one timeline event into the live wafer state (faults
        first, then repairs — a die both failed and repaired in one
        event ends up repaired)."""
        self.wafer = self.wafer \
            .with_faults(ev.failed_dies, ev.failed_links) \
            .with_repairs(ev.repaired_dies, ev.repaired_links)

    def _absorb(self, ev: FaultEvent) -> None:
        """Governor *skip*: adopt the topology change without a replan —
        the plan (and every admitted request's contract) stands, only
        the executor's cost surface refits to the changed wafer."""
        self._apply_event(ev)
        recal = getattr(self.executor, "recalibrate", None)
        if recal is not None:
            recal(self.plan, self.wafer)

    def _recover(self, ev: FaultEvent, now: float, *,
                 reason: str = "fault", cached: bool = False) -> float:
        """Fault hits: replan on survivors, migrate resident KV, swap the
        contract, re-queue the displaced.  Returns the post-pause time."""
        from repro_torch.core.plan import replan_serve
        from repro_torch.serve.migrate import plan_kv_migration
        old_plan = self.plan
        self._apply_event(ev)
        new_plan = replan_serve(old_plan, self.cfg, wafer=self.wafer,
                                cache_dir=self.plan_cache_dir,
                                use_cache=self.plan_use_cache)
        mig = plan_kv_migration(old_plan, new_plan,
                                list(self.sched.active.values()),
                                self.cfg, self.wafer)
        pre = self.samples[-RECOVERY_WINDOW:]
        thr_before = _window_throughput(pre)
        mig_fn = getattr(self.executor, "migrate", None)
        dt = mig_fn(new_plan, mig, self.wafer) if mig_fn is not None \
            else mig.est_pause_s
        t_before = now
        now = self.clock.advance(dt)
        self._sample(now, 0, now - t_before, "pause")  # part of the dip
        self.sched.apply_migration(new_plan, mig, now, self.readmission)
        self.plan = new_plan
        if self.router is not None:
            # cumulative per-expert loads survive the plan swap (experts
            # are model-level); only the EP grouping follows the new plan
            self.router.ep = max(1, getattr(new_plan, "ep", 1))
        old_pred = old_plan.predicted.get("tokens_per_s") or 0.0
        new_pred = new_plan.predicted.get("tokens_per_s") or 0.0
        rec = RecoveryEvent(
            time=t_before,
            failed_dies=tuple(ev.failed_dies),
            failed_links=tuple(tuple(l) for l in ev.failed_links),
            old_plan_hash=old_plan.plan_hash,
            new_plan_hash=new_plan.plan_hash,
            old_max_batch=old_plan.max_batch,
            new_max_batch=new_plan.max_batch,
            old_kv_budget=old_plan.kv_budget_tokens,
            new_kv_budget=new_plan.kv_budget_tokens,
            n_active=len(mig.survivors) + len(mig.evicted),
            n_survivors=len(mig.survivors),
            n_evicted=len(mig.evicted),
            moved_bytes=mig.moved_bytes,
            pause_s=now - t_before,
            recompute_tokens=mig.recompute_tokens,
            tokens_lost=mig.tokens_lost,
            capacity_ratio=new_pred / old_pred if old_pred > 0 else 1.0,
            thr_before=thr_before,
            repaired_dies=tuple(ev.repaired_dies),
            repaired_links=tuple(tuple(l) for l in ev.repaired_links),
            reason=reason,
            cached=cached,
            thr_before_window=len(pre),
        )
        self.events.append(rec)
        if self.on_recovery:
            self.on_recovery(self, rec)
        return now

    def _finalize_events(self, t_end: float) -> None:
        """Fill each RecoveryEvent's dip/recovery metrics from the full
        iteration-sample timeline (needs samples *after* the event).

        Each event's attribution window is bounded by the *next* event's
        time: with back-to-back faults inside one ``RECOVERY_WINDOW``,
        event k's dip/time-to-recover only sees samples in
        ``(t_k, t_{k+1}]`` — the second fault's pause and dip are never
        double-counted into the first event's metrics, and an event the
        engine did not recover from before the next one hit reports
        ``recovered=False`` with ``time_to_recover`` censored at
        ``t_{k+1}``.  An event whose pre-fault window was short
        (``thr_before_window < RECOVERY_WINDOW``: the fault landed
        before a full window of samples existed) also reports
        ``recovered=False`` — its ``thr_before`` is a padded estimate,
        not a steady rate to recover *to*."""
        w = RECOVERY_WINDOW
        for k, ev in enumerate(self.events):
            bound = self.events[k + 1].time if k + 1 < len(self.events) \
                else t_end
            after = [s for s in self.samples if ev.time < s[0] <= bound]
            target = RECOVERY_FRACTION * ev.thr_before \
                * min(1.0, ev.capacity_ratio)
            rec_t = None
            n_win = max(1, len(after) - w + 1)
            for j in range(n_win):
                win = after[j:j + w]
                if win and _window_throughput(win) >= target:
                    rec_t = win[-1][0]
                    break
            short_pre = ev.thr_before_window < w
            if rec_t is not None:
                ev.recovered = not short_pre
                ev.time_to_recover = rec_t - ev.time
                tail = [s for s in after if s[0] > rec_t]
                ev.thr_after = rolling_peak_throughput(tail or after, w,
                                                       kind="decode")
            else:
                rec_t = bound
                ev.time_to_recover = bound - ev.time
                ev.thr_after = rolling_peak_throughput(after, w,
                                                       kind="decode")
            span = rec_t - ev.time
            if ev.thr_before > 0 and span > 0:
                dip_rate = sum(s[1] for s in after if s[0] <= rec_t) / span
                ev.dip_depth = min(max(1.0 - dip_rate / ev.thr_before,
                                       0.0), 1.0)

    def _fault_due(self, now: float) -> bool:
        """A timeline event (or a pending governor decision) wants the
        loop's attention — chunked prefill preempts on this."""
        if self._fault_q and self._fault_q[0].time <= now:
            return True
        return self.gov is not None and bool(self.gov.pending)

    def _prefill(self, states: Sequence[RequestState], now: float) -> float:
        """Prefill ``states``; chunked mode checks the fault clock at
        every chunk boundary and preempts with progress checkpointed in
        ``prefilled_tokens`` (the interrupted states stay in their slots
        with ``tokens_done == 0`` and resume — or migrate — from the
        last completed chunk)."""
        sched, clock = self.sched, self.clock
        if not self._chunked:
            t_before = now
            dt = self.executor.prefill(states)
            now = clock.advance(dt)
            sched.mark_prefilled(states, now)
            self._sample(now, len(states), now - t_before, "prefill")
            return now
        chunk = self.prefill_chunk_tokens
        # anything already at its full prompt (zero-length prompts,
        # states whose last chunk completed right before a preemption)
        # yields its first token without another pass
        insta = [st for st in states
                 if st.prefilled_tokens >= st.req.prompt_len]
        if insta:
            sched.mark_prefilled(insta, now)
            self._sample(now, len(insta), 0.0, "prefill")
        while True:
            todo = [st for st in states
                    if 0 < st.req.prompt_len - st.prefilled_tokens]
            if not todo:
                break
            ns = [min(chunk, st.req.prompt_len - st.prefilled_tokens)
                  for st in todo]
            t_before = now
            dt = self.executor.prefill_chunk(todo, ns)
            now = clock.advance(dt)
            done = []
            for st, n in zip(todo, ns):
                st.prefilled_tokens += n
                if st.prefilled_tokens >= st.req.prompt_len:
                    done.append(st)
            if done:
                sched.mark_prefilled(done, now)
            self._sample(now, len(done), now - t_before, "prefill")
            if self._fault_due(now):
                break  # preemption point: fault lands between chunks
        return now

    def run(self, requests: Sequence[Request],
            max_iterations: int = 1_000_000) -> ServeReport:
        import dataclasses
        sched, clock, gov = self.sched, self.clock, self.gov
        t0 = clock.now()
        # arrivals are relative to the engine start (a WallClock's origin
        # is arbitrary; a VirtualClock starts at 0 so this is a no-op)
        pending = [dataclasses.replace(r, arrival=r.arrival + t0)
                   for r in sorted(requests,
                                   key=lambda r: (r.arrival, r.rid))]
        self._fault_q = fault_q = deque(
            dataclasses.replace(ev, time=ev.time + t0)
            for ev in self.faults)
        i = 0
        for _ in range(max_iterations):
            now = clock.now()
            while fault_q and fault_q[0].time <= now:
                ev = fault_q.popleft()
                if gov is None:
                    now = self._recover(ev, now)
                else:
                    gov.observe(ev)
            if gov is not None:
                dec = gov.decide(now, plan=self.plan, wafer=self.wafer,
                                 cfg=self.cfg,
                                 cache_dir=self.plan_cache_dir)
                if dec is not None:
                    if dec.action == "replan":
                        now = self._recover(dec.event, now,
                                            reason=dec.reason,
                                            cached=dec.cached)
                    elif dec.action == "apply":
                        self._absorb(dec.event)
                    # "noop": the coalesced events cancelled out
            while i < len(pending) and pending[i].arrival <= now:
                sched.submit(pending[i])
                i += 1
            sched.reject_never_fit(now)
            if sched.drained and i == len(pending) and \
                    (gov is None or (not fault_q and not gov.pending)):
                break
            newly = sched.admit(now)
            if self._chunked:
                # resumed partial prefills ride along with fresh admits
                prefills = [sched.active[s] for s in sorted(sched.active)
                            if sched.active[s].tokens_done == 0]
            else:
                prefills = newly
            if prefills:
                now = self._prefill(prefills, now)
            batch = sched.decode_batch()
            if batch:
                t_before = now
                dt = self.executor.decode(batch)
                now = clock.advance(dt)
                sched.mark_decoded(batch, now)
                self._sample(now, len(batch), now - t_before, "decode")
                if self.router is not None:
                    self.router.observe(len(batch))
            elif not prefills:
                # nothing in flight and head-of-line blocked or queue
                # empty: jump to the next arrival, scheduled fault, or
                # pending governor deadline (coalesce/backoff expiry)
                horizon = []
                if i < len(pending):
                    horizon.append(pending[i].arrival)
                if fault_q:
                    horizon.append(fault_q[0].time)
                if gov is not None:
                    d = gov.next_deadline()
                    if d is not None:
                        horizon.append(d)
                if horizon:
                    clock.wait_until(min(horizon))
                elif sched.waiting:
                    # unreachable: never-fit heads were rejected above and
                    # an idle mesh always has headroom for a fitting head
                    raise RuntimeError(
                        f"scheduler deadlock: request "
                        f"{sched.waiting[0].rid} blocked on an idle mesh")
            if self.on_iteration:
                self.on_iteration(self)
        self._finalize_events(clock.now())
        return self.report(clock.now() - t0)

    def report(self, makespan: float) -> ServeReport:
        fin = self.sched.finished
        ttfts = [st.ttft for st in fin]
        tpots = [t for st in fin for t in st.tpots]
        gen = sum(st.tokens_done for st in fin) \
            + sum(st.tokens_done for st in self.sched.active.values()) \
            + sum(st.tokens_done for st in self.sched.evicted_partials)
        trace = hashlib.sha256(
            str(self.sched.admission_trace).encode()).hexdigest()[:16]
        return ServeReport(
            n_requests=len(fin) + len(self.sched.active)
            + len(self.sched.waiting) + len(self.sched.rejected),
            n_finished=len(fin),
            generated_tokens=gen,
            makespan=makespan,
            tokens_per_s=gen / makespan if makespan > 0 else 0.0,
            ttft_p50=_percentile(ttfts, 50), ttft_p99=_percentile(ttfts, 99),
            tpot_p50=_percentile(tpots, 50), tpot_p99=_percentile(tpots, 99),
            slo_attainment=(sum(st.slo_ok for st in fin) / len(fin))
            if fin else math.nan,
            mean_occupancy=self.sched.occupancy_sum
            / max(self.sched.iterations, 1),
            iterations=self.sched.iterations,
            trace_hash=trace,
            n_rejected=len(self.sched.rejected),
            n_evicted=len(self.sched.evicted_partials),
            n_readmitted=self.sched.readmitted,
            rejected=tuple((req.rid, reason)
                           for req, reason in self.sched.rejected),
            recovery=tuple(ev.to_dict() for ev in self.events),
            n_replans=len(self.events),
            governor=tuple(ge.to_dict() for ge in self.gov.events)
            if self.gov is not None else (),
            moe_routed_tokens=self.router.routed
            if self.router is not None else 0,
            moe_dropped_tokens=self.router.dropped
            if self.router is not None else 0,
            moe_drop_rate=self.router.drop_rate
            if self.router is not None else 0.0,
            expert_load=tuple(self.router.load)
            if self.router is not None else (),
            expert_load_cv=self.router.load_cv
            if self.router is not None else 0.0,
            ep_group_load=self.router.ep_group_load()
            if self.router is not None else (),
        )


def poisson_arrivals(n: int, rate: float, *, seed: int = 0,
                     prompt_len: int = 128, max_new_tokens: int = 64,
                     slo_ttft: float = math.inf,
                     slo_tpot: float = math.inf) -> list[Request]:
    """A deterministic synthetic open-loop workload: exponential
    inter-arrivals at ``rate`` req/s (seeded), fixed prompt/gen shape."""
    import random
    rng = random.Random(seed)
    t = 0.0
    out = []
    for rid in range(n):
        t += rng.expovariate(rate) if rate > 0 else 0.0
        out.append(Request(rid=rid, arrival=t, prompt_len=prompt_len,
                           max_new_tokens=max_new_tokens,
                           slo_ttft=slo_ttft, slo_tpot=slo_tpot))
    return out
