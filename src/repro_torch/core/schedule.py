"""Tensor-stream and pipeline orchestration schedules (paper §V, Alg. 1
and the multi-wafer pipeline level of §VIII-E).

Copy of ``repro.core.schedule`` (the port imports nothing of ``repro``):
the reference's names, constants and arithmetic, in its order, so
results are bitwise equal to the reference's.

Four schedule families are modelled — two intra-wafer tensor-stream
schedules and two inter-wafer pipeline schedules:

* ``line_schedule(N)`` — the paper's Bidirectional Tensor Stream Orchestration
  (Alg. 1) for an *open line* of dies (a wafer row has no wrap-around link).
  Die ``i`` computes one sub-output per round; sub-tensors stream
  simultaneously in both directions with relays; every transfer is one
  physical hop.  Lower-half dies consume ascending block indices (arriving
  from the right), upper-half dies descending (arriving from the left).

* ``ring_schedule(N, bidirectional)`` — the closed-ring (torus) realization
  used by the SPMD ``shard_map`` implementation in :mod:`repro_torch.core.tatp`.
  With ``bidirectional=True`` both directions deliver a fresh block every
  round (two computes per round, ⌈(N−1)/2⌉+… rounds); with ``False`` it is the
  naive unidirectional TSPP ring (one block per round, N−1 shifts, requires
  the wrap link).

* ``gpipe_schedule(pp, n_micro)`` / ``one_f_one_b_schedule(pp, n_micro)``
  — inter-wafer pipeline parallelism over ``pp`` stages and ``n_micro``
  microbatches.  GPipe flushes: every stage runs all forwards, then all
  backwards (peak ``n_micro`` in-flight microbatches on stage 0); 1F1B
  (PipeDream-flush) interleaves one backward per forward after a
  per-stage warmup, capping in-flight activations at ``min(pp − s,
  n_micro)`` with the same bubble fraction.

All are *executable* descriptions: :func:`simulate` runs a tensor-stream
schedule on a virtual die array and checks feasibility (a die only ever
computes/relays a block it holds), the one-hop property, coverage (every
die computes every block exactly once) and peak buffer occupancy;
:func:`simulate_pipeline` replays a pipeline schedule and checks the
stage/microbatch dependency order, per-slot exclusivity, coverage, bubble
fraction and peak in-flight microbatches per stage.  The property tests in
``tests/test_schedule.py`` sweep these with hypothesis.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache


@dataclass(frozen=True)
class Event:
    t: int  # round index
    die: int
    kind: str  # "compute" | "send"
    block: int
    dst: int = -1  # for sends


@dataclass
class Schedule:
    n_dies: int
    n_rounds: int
    topology: str  # "line" | "ring"
    events: list[Event] = field(default_factory=list)

    def computes(self, die: int) -> list[tuple[int, int]]:
        return [(e.t, e.block) for e in self.events
                if e.kind == "compute" and e.die == die]

    def sends_at(self, t: int) -> list[Event]:
        return [e for e in self.events if e.kind == "send" and e.t == t]


# ---------------------------------------------------------------------------
# Alg. 1 — open line, bidirectional redundant-transfer orchestration
# ---------------------------------------------------------------------------


def line_schedule(n: int) -> Schedule:
    """Paper Alg. 1 (constructive form).

    Possession model: block ``b`` originates on die ``b`` and streams one hop
    per round in both directions (leftward stream serves / relays toward die
    0, rightward toward die n−1).  Compute rule (Alg. 1 lines 2–4)::

        die i, round t:  block (i + t) mod n   if i < n/2
                         block (i − t) mod n   otherwise

    Send rule (lines 5–9, constructive): die ``d`` relays at round ``t`` the
    block arriving on each stream — leftward stream carries block ``d + t``
    (while it exists), rightward carries ``d − t`` — so each die performs at
    most one send per direction per round and **every send is one hop**.
    Blocks whose compute round is later than their arrival round wait in the
    die's stream buffer (bounded; asserted by :func:`simulate`).
    """
    if n < 2 or n % 2:
        raise ValueError("line_schedule requires an even die count >= 2")
    ev: list[Event] = []
    for t in range(n):
        for i in range(n):
            b = (i + t) % n if i < n // 2 else (i - t) % n
            ev.append(Event(t, i, "compute", b))
        if t == n - 1:
            break  # last round: nothing left to send
        for d in range(n):
            # leftward stream: block d+t sits on die d at round t (it left die
            # d+t at round 0 heading left); relay to d-1.
            b_left = d + t
            if b_left < n and d - 1 >= 0:
                ev.append(Event(t, d, "send", b_left, d - 1))
            # rightward stream: block d−t relayed to d+1.
            b_right = d - t
            if b_right >= 0 and d + 1 < n:
                ev.append(Event(t, d, "send", b_right, d + 1))
    return Schedule(n, n, "line", ev)


# ---------------------------------------------------------------------------
# Closed-ring schedules (the shard_map/torus realization)
# ---------------------------------------------------------------------------


def ring_schedule(n: int, bidirectional: bool = True) -> Schedule:
    if n < 1:
        raise ValueError("n >= 1")
    ev: list[Event] = []
    if not bidirectional:
        # naive TSPP: block (i+t) mod n computed at round t, single stream.
        for t in range(n):
            for i in range(n):
                ev.append(Event(t, i, "compute", (i + t) % n))
                if t < n - 1:
                    # send current block to the left neighbour (ring)
                    ev.append(Event(t, i, "send", (i + t) % n, (i - 1) % n))
        return Schedule(n, n, "ring", ev)

    # bidirectional: round 0 computes the local block; round t>=1 computes the
    # two blocks at ring distance t (one per direction); even n has a single
    # antipodal block at the final round.
    n_rounds = n // 2 + 1 if n % 2 == 0 else (n + 1) // 2
    for t in range(n_rounds):
        for i in range(n):
            up = (i + t) % n
            dn = (i - t) % n
            if t == 0:
                ev.append(Event(t, i, "compute", i))
            elif up == dn:  # antipodal (even n, t == n/2)
                ev.append(Event(t, i, "compute", up))
            else:
                ev.append(Event(t, i, "compute", up))
                ev.append(Event(t, i, "compute", dn))
            if t < n_rounds - 1:
                # relay both streams one hop
                ev.append(Event(t, i, "send", up, (i - 1) % n))
                ev.append(Event(t, i, "send", dn, (i + 1) % n))
    return Schedule(n, n_rounds, "ring", ev)


# ---------------------------------------------------------------------------
# Feasibility simulator
# ---------------------------------------------------------------------------


@dataclass
class SimReport:
    ok: bool
    n_rounds: int
    peak_buffer_blocks: int
    max_hop: int
    computes_per_die_per_round: int
    errors: list[str] = field(default_factory=list)


def simulate(sched: Schedule, *, drop_after_use: bool = True) -> SimReport:
    """Execute a schedule on a virtual die array and verify its invariants."""
    n = sched.n_dies
    holds: list[set[int]] = [{i} for i in range(n)]
    computed: list[set[int]] = [set() for _ in range(n)]
    errors: list[str] = []
    peak = 1
    max_hop = 0
    max_cpr = 0

    for t in range(sched.n_rounds):
        round_ev = [e for e in sched.events if e.t == t]
        # computes
        per_die = {}
        for e in round_ev:
            if e.kind != "compute":
                continue
            per_die[e.die] = per_die.get(e.die, 0) + 1
            if e.block not in holds[e.die]:
                errors.append(f"t={t} die{e.die} computes {e.block} w/o holding")
            if e.block in computed[e.die]:
                errors.append(f"t={t} die{e.die} recomputes {e.block}")
            computed[e.die].add(e.block)
        max_cpr = max(max_cpr, *per_die.values()) if per_die else max_cpr
        # sends (verify possession + hop distance), then deliver
        inbox: list[set[int]] = [set() for _ in range(n)]
        for e in round_ev:
            if e.kind != "send":
                continue
            if e.block not in holds[e.die]:
                errors.append(f"t={t} die{e.die} sends {e.block} w/o holding")
            if sched.topology == "line":
                hop = abs(e.dst - e.die)
            else:
                hop = min((e.dst - e.die) % n, (e.die - e.dst) % n)
            max_hop = max(max_hop, hop)
            if not (0 <= e.dst < n):
                errors.append(f"t={t} die{e.die} sends to invalid die {e.dst}")
            else:
                inbox[e.dst].add(e.block)
        # deliver; optionally drop blocks that are computed AND already
        # relayed past (memory-minimising policy)
        for d in range(n):
            holds[d] |= inbox[d]
            if drop_after_use:
                sends_next = {e.block for e in sched.events
                              if e.kind == "send" and e.die == d and e.t > t}
                holds[d] = {b for b in holds[d]
                            if b not in computed[d] or b in sends_next}
            peak = max(peak, len(holds[d]))

    for d in range(n):
        if computed[d] != set(range(n)):
            missing = set(range(n)) - computed[d]
            errors.append(f"die{d} missing blocks {sorted(missing)}")

    return SimReport(
        ok=not errors,
        n_rounds=sched.n_rounds,
        peak_buffer_blocks=peak,
        max_hop=max_hop,
        computes_per_die_per_round=max_cpr,
        errors=errors[:20],
    )


def tail_latency_rounds(n: int, topology: str, bidirectional: bool) -> int:
    """Worst-case extra hops suffered by any single transfer (paper Fig. 5a).

    A naive TSPP ring mapped on an open line incurs an (n−1)-hop wrap
    transfer; TATP keeps every transfer at one hop.
    """
    if topology == "line" and not bidirectional:
        return n - 1
    return 1


# ---------------------------------------------------------------------------
# Inter-wafer pipeline schedules (multi-wafer level, §VIII-E)
# ---------------------------------------------------------------------------

PIPELINE_FAMILIES = ("gpipe", "1f1b")


@dataclass(frozen=True)
class PipeEvent:
    t: int  # slot index (one slot = one fwd or one bwd of one microbatch)
    stage: int
    kind: str  # "fwd" | "bwd"
    micro: int


@dataclass
class PipelineSchedule:
    n_stages: int
    n_micro: int
    family: str  # "gpipe" | "1f1b"
    n_slots: int
    events: list[PipeEvent] = field(default_factory=list)

    def ops_at(self, t: int) -> list[PipeEvent]:
        return [e for e in self.events if e.t == t]

    def stage_ops(self, stage: int) -> list[PipeEvent]:
        return sorted((e for e in self.events if e.stage == stage),
                      key=lambda e: e.t)


def _run_pipeline(pp: int, n_micro: int, family: str) -> PipelineSchedule:
    """Greedy slot-by-slot executor that realises a pipeline policy.

    Dependencies (both families): ``fwd(s, m)`` needs ``fwd(s−1, m)`` done
    in an earlier slot; ``bwd(s, m)`` needs ``fwd(s, m)`` and
    ``bwd(s+1, m)`` done in earlier slots.  Forwards run in microbatch
    order (FIFO streams between stages).

    * gpipe — a stage prefers forwards and only starts backwards once all
      its forwards are done (the flush); backwards drain LIFO (freshest
      activations first), giving the canonical 2·(n_micro+pp−1) slots and
      ``n_micro`` peak in-flight microbatches.
    * 1f1b — stage ``s`` holds at most ``min(pp − s, n_micro)``
      microbatches in flight: once at the cap it waits for a backward
      rather than running ahead, which caps activation memory at the same
      total slot count (backwards drain FIFO).
    """
    if pp < 1 or n_micro < 1:
        raise ValueError("pipeline needs pp >= 1 and n_micro >= 1")
    fwd_done: list[dict[int, int]] = [{} for _ in range(pp)]  # micro -> slot
    bwd_done: list[dict[int, int]] = [{} for _ in range(pp)]
    events: list[PipeEvent] = []
    t = 0
    total = 2 * pp * n_micro
    limit = [min(pp - s, n_micro) for s in range(pp)]
    while len(events) < total:
        for s in range(pp):
            nf, nb = len(fwd_done[s]), len(bwd_done[s])
            can_fwd = nf < n_micro and (
                s == 0 or fwd_done[s - 1].get(nf, t) < t)
            # backwards drain LIFO under gpipe, FIFO under 1f1b
            bm = (nf - 1 - nb) if family == "gpipe" else nb
            can_bwd = nb < nf and bm in fwd_done[s] \
                and fwd_done[s][bm] < t \
                and (s == pp - 1 or bwd_done[s + 1].get(bm, t) < t)
            if family == "gpipe":
                do_bwd = can_bwd and nf == n_micro
                do_fwd = not do_bwd and can_fwd
            else:  # 1f1b: respect the in-flight cap, prefer bwd at the cap
                at_cap = nf - nb >= limit[s]
                do_bwd = can_bwd and (at_cap or nf == n_micro)
                do_fwd = not do_bwd and can_fwd and not at_cap
            if do_bwd:
                events.append(PipeEvent(t, s, "bwd", bm))
                bwd_done[s][bm] = t
            elif do_fwd:
                events.append(PipeEvent(t, s, "fwd", nf))
                fwd_done[s][nf] = t
        t += 1
        if t > 4 * total + 8:  # policy deadlock guard (should never fire)
            raise RuntimeError(f"pipeline schedule did not converge "
                               f"(pp={pp}, n_micro={n_micro}, {family})")
    return PipelineSchedule(pp, n_micro, family, t, events)


def gpipe_schedule(pp: int, n_micro: int) -> PipelineSchedule:
    """GPipe: all forwards, flush, all backwards (paper baselines)."""
    return _run_pipeline(pp, n_micro, "gpipe")


def one_f_one_b_schedule(pp: int, n_micro: int) -> PipelineSchedule:
    """Non-interleaved 1F1B (PipeDream-flush): same bubble as GPipe, peak
    in-flight activations capped at ``min(pp − s, n_micro)`` per stage."""
    return _run_pipeline(pp, n_micro, "1f1b")


def pipeline_schedule(family: str, pp: int, n_micro: int) -> PipelineSchedule:
    if family not in PIPELINE_FAMILIES:
        raise ValueError(f"unknown pipeline family {family!r} "
                         f"(expected one of {PIPELINE_FAMILIES})")
    return _run_pipeline(pp, n_micro, family)


@dataclass
class PipeReport:
    ok: bool
    n_slots: int
    bubble: float  # idle fraction of stage-slots
    peak_inflight: int  # max over stages
    inflight_per_stage: tuple[int, ...]
    errors: list[str] = field(default_factory=list)


def simulate_pipeline(sched: PipelineSchedule) -> PipeReport:
    """Replay a pipeline schedule and verify its invariants: dependency
    order, one op per stage per slot, forward FIFO order, coverage (every
    stage runs fwd+bwd of every microbatch exactly once), plus bubble and
    peak-in-flight accounting."""
    pp, nm = sched.n_stages, sched.n_micro
    errors: list[str] = []
    f_slot: list[dict[int, int]] = [{} for _ in range(pp)]
    b_slot: list[dict[int, int]] = [{} for _ in range(pp)]
    by_slot: dict[int, list[PipeEvent]] = {}
    for e in sched.events:
        if not (0 <= e.stage < pp and 0 <= e.micro < nm):
            errors.append(f"event out of range: {e}")
            continue
        if not (0 <= e.t < sched.n_slots):
            errors.append(f"slot out of range: {e}")
        by_slot.setdefault(e.t, []).append(e)
        tgt = f_slot if e.kind == "fwd" else b_slot
        if e.micro in tgt[e.stage]:
            errors.append(f"duplicate {e.kind} of micro {e.micro} "
                          f"on stage {e.stage}")
        tgt[e.stage][e.micro] = e.t
    for t in sorted(by_slot):
        seen_stage: set[int] = set()
        for e in by_slot[t]:
            if e.stage in seen_stage:
                errors.append(f"t={t} stage{e.stage} runs two ops")
            seen_stage.add(e.stage)
            if e.kind == "fwd":
                if e.stage > 0 and f_slot[e.stage - 1].get(e.micro, t) >= t:
                    errors.append(f"t={t} stage{e.stage} fwd micro "
                                  f"{e.micro} before upstream fwd")
            else:
                if f_slot[e.stage].get(e.micro, t) >= t:
                    errors.append(f"t={t} stage{e.stage} bwd micro "
                                  f"{e.micro} before its own fwd")
                if e.stage < pp - 1 \
                        and b_slot[e.stage + 1].get(e.micro, t) >= t:
                    errors.append(f"t={t} stage{e.stage} bwd micro "
                                  f"{e.micro} before downstream bwd")
    for s in range(pp):
        if set(f_slot[s]) != set(range(nm)):
            errors.append(f"stage{s} missing fwd micros "
                          f"{sorted(set(range(nm)) - set(f_slot[s]))}")
        if set(b_slot[s]) != set(range(nm)):
            errors.append(f"stage{s} missing bwd micros "
                          f"{sorted(set(range(nm)) - set(b_slot[s]))}")
        fwd_order = [m for _, m in sorted((t, m)
                                          for m, t in f_slot[s].items())]
        if fwd_order != sorted(fwd_order):
            errors.append(f"stage{s} forwards out of FIFO order")
    # in-flight microbatches per stage: fwd done, bwd not yet done
    inflight = []
    for s in range(pp):
        peak, cur = 0, 0
        marks = sorted([(t, +1) for t in f_slot[s].values()]
                       + [(t, -1) for t in b_slot[s].values()])
        for _, d in marks:
            cur += d
            peak = max(peak, cur)
        inflight.append(peak)
    busy = len(sched.events)
    bubble = 1.0 - busy / max(sched.n_slots * pp, 1)
    return PipeReport(
        ok=not errors,
        n_slots=sched.n_slots,
        bubble=bubble,
        peak_inflight=max(inflight, default=0),
        inflight_per_stage=tuple(inflight),
        errors=errors[:20],
    )


def pipeline_bubble_fraction(pp: int, n_micro: int) -> float:
    """Canonical GPipe/1F1B bubble fraction: (pp−1)/(n_micro+pp−1)."""
    return (pp - 1) / (n_micro + pp - 1)


def pipeline_step_time(sched: PipelineSchedule,
                       stage_fwd_s, stage_bwd_s,
                       p2p_s=0.0) -> float:
    """Wall-clock of one pipeline step by walking the schedule's slots.

    ``stage_fwd_s`` / ``stage_bwd_s`` are per-stage per-microbatch compute
    times (scalars broadcast to all stages).  ``p2p_s`` is the inter-stage
    boundary-activation transfer per microbatch:

    * a scalar is the legacy uniform model — every op of every stage pays
      it (the send/recv of the slot's microbatch is serialized with its
      compute — the conservative, non-overlapped model);
    * a sequence of length ``pp - 1`` gives the per-boundary time —
      boundary ``b`` sits between stages ``b`` and ``b+1``, a forward on
      stage ``s`` pays boundary ``s`` (its activation send downstream,
      nothing for the last stage), a backward pays boundary ``s - 1``
      (its gradient send upstream, nothing for stage 0).  This is how the
      multi-wafer solver charges on-wafer stage boundaries at the D2D cut
      bandwidth instead of the inter-wafer bandwidth.

    Slots are synchronous: a slot lasts as long as its slowest stage,
    which is how degraded (or unevenly loaded) wafers gate the whole
    pipeline.
    """
    pp = sched.n_stages
    if not isinstance(stage_fwd_s, (list, tuple)):
        stage_fwd_s = [float(stage_fwd_s)] * pp
    if not isinstance(stage_bwd_s, (list, tuple)):
        stage_bwd_s = [float(stage_bwd_s)] * pp
    if isinstance(p2p_s, (list, tuple)):
        if len(p2p_s) != max(pp - 1, 0):
            raise ValueError(f"need {pp - 1} boundary times, got "
                             f"{len(p2p_s)}")
        fwd_p2p = [p2p_s[s] if s < pp - 1 else 0.0 for s in range(pp)]
        bwd_p2p = [p2p_s[s - 1] if s > 0 else 0.0 for s in range(pp)]
    else:
        fwd_p2p = bwd_p2p = [p2p_s] * pp
    by_slot: dict[int, float] = {}
    for e in sched.events:
        dur = (stage_fwd_s[e.stage] + fwd_p2p[e.stage] if e.kind == "fwd"
               else stage_bwd_s[e.stage] + bwd_p2p[e.stage])
        by_slot[e.t] = max(by_slot.get(e.t, 0.0), dur)
    return sum(by_slot.values())


@lru_cache(maxsize=256)
def schedule_and_report(family: str, pp: int,
                        n_micro: int) -> "tuple[PipelineSchedule, PipeReport]":
    """Memoized (schedule, feasibility report) pair.

    The greedy slot executor and its replay are pure Python over
    ``2·pp·n_micro`` events; the multi-wafer upper solve scores the same
    ``(family, pp, n_micro)`` shape for every layer split and the plan
    compiler re-derives it again, so the pair is built once per shape.
    Treat both as read-only (they are shared across callers)."""
    sched = pipeline_schedule(family, pp, n_micro)
    return sched, simulate_pipeline(sched)
