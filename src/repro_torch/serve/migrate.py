"""Plan-to-plan KV-cache migration for elastic serving (§VIII-F live).

Copy of ``repro.serve.migrate`` (the port imports nothing of ``repro``):
the reference's names, constants and arithmetic, in its order, so
results are bitwise equal to the reference's.

When a fault degrades the wafer mid-serving, the engine re-solves the
decode mesh (:func:`repro_torch.core.plan.replan_serve`) and must carry the
resident KV cache from the old :class:`~repro_torch.core.plan.ServePlan` to the
new one.  This module is the planning half of that move:

* **Survivor selection** — the new plan's contract may be smaller (fewer
  decode slots after a ``max_batch`` shrink, a capped
  ``kv_budget_tokens`` when the degraded wafer cannot hold the full
  cache beside the weight shard).  Survivors are chosen strictly FCFS by
  admission time: the earliest-admitted in-flight sequences keep their
  cache as long as they fit the new slot count and token budget; the
  rest are evicted — *not dropped*: the scheduler re-queues them as
  continuations with prefix-recompute accounting
  (:meth:`ContinuousBatchingScheduler.apply_migration`).
* **Re-shard pricing** — surviving cache bytes are re-laid-out for the
  new mesh over the *degraded* topology.  Every surviving byte is
  charged one traversal of the mean (detour-aware) hop distance between
  the old and new die sets, against the aggregate working-link
  bandwidth at DMA granularity (``spec.bw_eff``).  Shards that lived on
  the now-dead dies are gone; they are rebuilt from the (host-resident)
  token ids by chunked re-prefill, charged at the prefill rate on the
  lost token fraction.  Both terms land in ``est_pause_s`` — the
  virtual-clock pause the :class:`CostModelExecutor` charges, so fault
  severity shows up in the SLO timeline deterministically.

The planner is a pure function of (old plan, new plan, in-flight states,
degraded wafer): the cost-model and real-jax executors consume the same
:class:`KVMigration`, so they agree by construction on which sequences
survive — a property pinned in tests/test_serve_fault.py.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

# control-plane allowance per recovery: fault localization, the plan swap
# and scheduler bookkeeping.  A deterministic stand-in for solver wall
# time — the virtual clock must not depend on host speed.
REPLAN_OVERHEAD_S = 2e-3
# chunked re-prefill of lost shards runs compute-bound, like admission
# prefill: this many tokens rebuild in the time one token decodes
# (matches CostModelExecutor's default prefill_eff).
PREFILL_RECOMPUTE_EFF = 16
# tokens per re-prefill pass: each chunk is one forward launch on the
# degraded mesh and can never beat a single decode step's latency (the
# per-chunk floor in _reprefill_pricing).
REPREFILL_CHUNK_TOKENS = 512


def _reprefill_pricing(new_plan, cfg, wafer, lost_tokens: float, *,
                       chunk_tokens: int = REPREFILL_CHUNK_TOKENS,
                       prefill_eff: int = PREFILL_RECOMPUTE_EFF
                       ) -> tuple[float, int, str]:
    """Price rebuilding ``lost_tokens`` of KV by chunked re-prefill,
    re-simulated on the *degraded* plan.

    Runs the same two-anchor calibration as
    :class:`repro_torch.serve.engine.CostModelExecutor` —
    ``simulate_decode_batch`` at full and half context on the new plan's
    die set over the degraded wafer — so the per-token rate carries the
    degraded fabric's real detours and contention instead of the old
    flat ``predicted_tokens_per_s × PREFILL_RECOMPUTE_EFF`` guess
    (which priced a 25%-dead mesh and a healthy one identically per
    predicted token).  The rebuild runs in ``chunk_tokens`` passes,
    each floored at one decode-step latency (a launch cannot be faster
    than a step).  Returns ``(recompute_s, n_chunks, model)`` where
    ``model`` is ``"resim"`` or — if the simulation is unusable —
    ``"flat"`` (the legacy pricing, kept as a deterministic fallback).
    """
    import math
    n_tok = int(math.ceil(lost_tokens))
    if n_tok <= 0:
        return 0.0, 0, "resim"
    try:
        from repro_torch.wafer.simulator import (ParallelDegrees, StepCostContext,
                                           simulate_decode_batch)
        deg = ParallelDegrees(*new_plan.plan.degrees_tuple(),
                              seq_par=new_plan.plan.seq_par)
        B = max(new_plan.max_batch, 1)
        S = max(new_plan.max_seq, 1)
        dies = list(new_plan.plan.alive_dies)

        def lat(s):
            ctx = StepCostContext(wafer, cfg, B, max(s, 1),
                                  new_plan.plan.engine, dies=dies,
                                  objective="decode")
            return simulate_decode_batch(ctx, [deg])[0].step_time

        l_full = lat(S)
        if not (math.isfinite(l_full) and l_full > 0):
            raise ValueError("degraded plan simulates non-finite")
        l_half = lat(S // 2)
        if not math.isfinite(l_half):
            l_half = l_full
        # KV-scan slope per resident token (the executor's `c`): longer
        # rebuilt prefixes scan more resident cache per pass
        c = (l_full - l_half) / max(B * S - B * (S // 2), 1)
        per_tok = l_full / B / prefill_eff + max(c, 0.0)
        n_chunks = (n_tok + chunk_tokens - 1) // chunk_tokens
        total, rem = 0.0, n_tok
        for _ in range(n_chunks):
            t = min(chunk_tokens, rem)
            total += max(t * per_tok, l_full)
            rem -= t
        return total, n_chunks, "resim"
    except Exception:
        tok_rate = max(new_plan.predicted.get("tokens_per_s", 0.0), 1e-9) \
            * prefill_eff
        return n_tok / tok_rate, 0, "flat"


@dataclass(frozen=True)
class KVMigration:
    """One planned cache move between two ServePlans.

    ``survivors`` is ``(rid, old_slot, new_slot)`` in admission order;
    ``evicted`` is ``(rid, old_slot)`` in admission order (the scheduler
    re-queues them head-of-line in exactly this order, preserving FCFS
    among the displaced).
    """

    survivors: tuple[tuple[int, int, int], ...]
    evicted: tuple[tuple[int, int], ...]
    moved_bytes: float       # surviving resident KV re-sharded (bytes)
    lost_bytes: float        # resident KV that lived on dead dies (bytes)
    avg_hops: float          # mean detour-aware old-die -> new-die distance
    reshard_s: float         # time to push moved_bytes over the fabric
    recompute_s: float       # time to rebuild lost shards by re-prefill
    est_pause_s: float       # REPLAN_OVERHEAD_S + reshard_s + recompute_s
    kv_tokens_kept: int      # budget tokens the survivors keep reserved
    recompute_tokens: int    # evicted prefix tokens to re-prefill later
    tokens_lost: int         # generated tokens whose KV was evicted
    recompute_chunks: int = 0    # re-prefill passes the pricing simulated
    recompute_model: str = "flat"  # "resim" (degraded-plan sim) | "flat"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _mean_hops(wafer, src_dies: Sequence[int],
               dst_dies: Sequence[int]) -> float:
    """Mean detour-aware hop distance from ``src_dies`` to ``dst_dies``
    (expected path length of one re-shard transfer).  Uses the BFS
    detour route so the price reflects the *degraded* fabric; pairs the
    mesh cannot connect at all fall back to Manhattan distance (their
    shard is rebuilt, not moved, but the mean must stay defined)."""
    if not src_dies or not dst_dies:
        return 0.0
    total = 0.0
    for a in src_dies:
        for b in dst_dies:
            path = wafer.detour_path(a, b)
            total += len(path) if path is not None else wafer.hops(a, b)
    return total / (len(src_dies) * len(dst_dies))


def _working_links(wafer) -> int:
    """Directed working links of the degraded mesh (the aggregate fabric
    the re-shard traffic spreads over)."""
    return sum(len(wafer.neighbors(d)) for d in wafer.alive_dies())


def plan_kv_migration(old_plan, new_plan, states, cfg, wafer) -> KVMigration:
    """Decide which in-flight sequences survive a plan change and price
    the cache move over the degraded topology.

    ``states`` are the scheduler's active :class:`RequestState`s (any
    order; selection sorts by admission time).  ``wafer`` is the live
    degraded wafer (carries the real :class:`WaferSpec`, which the plan's
    grid-only record cannot reconstruct).
    """
    spec = wafer.spec
    ordered = sorted(states, key=lambda st: (st.admitted_at, st.req.rid))

    survivors: list[tuple[int, int, int]] = []
    evicted: list[tuple[int, int]] = []
    kv_sum = 0
    moved_bytes = 0.0
    recompute_tokens = 0
    tokens_lost = 0
    for st in ordered:
        fits = (len(survivors) < new_plan.max_batch
                and kv_sum + st.kv_reserved <= new_plan.kv_budget_tokens
                and st.kv_reserved <= new_plan.max_seq)
        if fits:
            survivors.append((st.req.rid, st.slot, len(survivors)))
            kv_sum += st.kv_reserved
            # resident_tokens == context_len except mid-chunked-prefill:
            # a preempted prefill only moves the chunks it completed
            moved_bytes += cfg.cache_bytes_per_seq(
                getattr(st, "resident_tokens", st.context_len))
        else:
            evicted.append((st.req.rid, st.slot))
            recompute_tokens += st.context_len
            tokens_lost += st.tokens_done

    # --- traffic over the degraded fabric --------------------------------
    old_dies = [d for d in old_plan.plan.alive_dies if wafer.alive(d)]
    new_dies = list(new_plan.plan.alive_dies)
    dead_now = len(old_plan.plan.alive_dies) - len(old_dies)
    lost_frac = dead_now / max(len(old_plan.plan.alive_dies), 1)
    lost_bytes = moved_bytes * lost_frac
    surviving_bytes = moved_bytes - lost_bytes

    avg_hops = _mean_hops(wafer, old_dies, new_dies)
    links = max(_working_links(wafer), 1)
    chunk = surviving_bytes / links  # per-link message for the DMA ramp
    agg_bw = links * spec.link_bw * spec.bw_eff(chunk)
    reshard_s = surviving_bytes * avg_hops / agg_bw \
        + avg_hops * spec.hop_latency if surviving_bytes > 0 else 0.0

    # lost shards: rebuilt from host-resident token ids by chunked
    # re-prefill, priced by re-simulating the *degraded* plan (two
    # decode-cost anchors on the new die set over the degraded wafer,
    # chunked passes floored at one step each) — the rebuild rate falls
    # with the fabric, it is not the healthy plan's predicted rate
    # scaled by a constant.  PREFILL_RECOMPUTE_EFF survives as the
    # compute-bound tokens-per-step ratio inside the pricing, shared
    # with CostModelExecutor so the sim and the pricing agree.
    lost_tokens = lost_frac * sum(
        st.context_len for st in ordered
        if any(st.req.rid == rid for rid, _, _ in survivors))
    if lost_bytes > 0:
        recompute_s, recompute_chunks, recompute_model = \
            _reprefill_pricing(new_plan, cfg, wafer, lost_tokens)
    else:
        recompute_s, recompute_chunks, recompute_model = 0.0, 0, "resim"

    return KVMigration(
        survivors=tuple(survivors),
        evicted=tuple(evicted),
        moved_bytes=moved_bytes,
        lost_bytes=lost_bytes,
        avg_hops=avg_hops,
        reshard_s=reshard_s,
        recompute_s=recompute_s,
        est_pause_s=REPLAN_OVERHEAD_S + reshard_s + recompute_s,
        kv_tokens_kept=kv_sum,
        recompute_tokens=recompute_tokens,
        tokens_lost=tokens_lost,
        recompute_chunks=recompute_chunks,
        recompute_model=recompute_model,
    )
