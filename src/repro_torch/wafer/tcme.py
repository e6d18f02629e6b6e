"""TCME — Traffic-Conscious Mapping Engine (paper §VI, Fig. 11).

Copy of ``repro.wafer.tcme`` (the port imports nothing of ``repro``):
the reference's names, constants and arithmetic, in its order, so
results are bitwise equal to the reference's.

Five-phase communication optimizer:

1. **Pattern analysis & path init** — decompose the hybrid-parallel step
   into parallel groups and their comm ops; initialise all routes XY.
2. **Bottleneck identification** — global link-load analysis → most
   congested link (mcl) and its load (cur).
3. **Congested path identification** — ops whose routes traverse mcl.
4. **Path merging & routing optimization** — merge redundant flows into
   multicast trees; try YX / detour re-routes for the rest; keep a change
   only if it lowers the bottleneck load.
5. **Global update & termination** — recompute loads; stop when improvement
   stagnates or MAX_ITER is hit.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.wafer.topology import Link, Wafer
from repro_torch.wafer.traffic import CommOp, link_loads, path_for


@dataclass
class TCMEReport:
    initial_max_load: float
    final_max_load: float
    iterations: int
    merged_ops: int
    rerouted_pairs: int
    history: list[float] = field(default_factory=list)

    @property
    def improvement(self) -> float:
        if self.initial_max_load <= 0:
            return 1.0
        return self.initial_max_load / max(self.final_max_load, 1e-12)


def _max_link(loads: dict[Link, float]) -> tuple[Link | None, float]:
    if not loads:
        return None, 0.0
    link = max(loads, key=loads.get)
    return link, loads[link]


def _state(loads: dict[Link, float]) -> tuple[float, int, float]:
    """Lexicographic congestion state: (max load, #links at max, total).
    Accepting equal-max moves that shrink the bottleneck set lets the greedy
    pass clear multiple hot links one at a time."""
    if not loads:
        return (0.0, 0, 0.0)
    mx = max(loads.values())
    at = sum(1 for v in loads.values() if v >= mx * (1 - 1e-9))
    return (mx, at, sum(loads.values()))


def _pair_uses_link(op: CommOp, idx: int, pair, wafer: Wafer,
                    link: Link) -> bool:
    pol = op.routing.get(idx, "xy")
    path = path_for(wafer, pair[0], pair[1], pol, op, idx) or []
    return link in path


def optimize_phase(ops: list[CommOp], wafer: Wafer, *, max_iter: int = 64,
                   min_gain: float = 1e-3) -> TCMEReport:
    """Runs the five-phase optimizer in place (mutates op.routing/multicast).
    Returns the contention report.

    The optimizer is deterministic in the phase's op structure (kinds,
    groups, payloads) and the wafer, so on cache-enabled wafers the
    resulting mutations are memoized per phase fingerprint: a re-solve of
    the same step (repeat launches, fault sweeps re-scoring the surviving
    configuration) replays the recorded routing instead of re-running the
    greedy search — every downstream load/time query sees identical state.
    """
    ckey = None
    if wafer.cache_enabled:
        ckey = (tuple((op.kind, op.group, op.nbytes, op.chunk_bytes,
                       op.multicast, op.tag) for op in ops),
                max_iter, min_gain)
        hit = wafer._tcme_cache.get(ckey)
        if hit is not None:
            report, states = hit
            for op, (group, routing, custom, mcast) in zip(ops, states):
                op.group = group
                op.routing = dict(routing)
                op.custom_paths = dict(custom)
                op.multicast = mcast
            return report
    # Phase 1: init all paths XY
    for op in ops:
        op.routing = {i: "xy" for i, _ in enumerate(op.pairs())}

    loads = link_loads(ops, wafer)
    _, init_load = _max_link(loads)
    best = init_load
    history = [best]
    merged = 0
    rerouted = 0

    # Phase 4a (once): merge redundant flows — identical (src, payload tag)
    # pairs across ops become a multicast tree (modelled as halved load)
    seen: dict[tuple[int, str], CommOp] = {}
    for op in ops:
        if not op.tag:
            continue
        key = (op.group[0], op.tag)
        if key in seen and seen[key].nbytes == op.nbytes \
                and not op.multicast:
            op.multicast = True
            seen[key].multicast = True
            merged += 1
        else:
            seen[key] = op

    it = 0
    stall = 0
    while it < max_iter and stall < 3:
        it += 1
        loads = link_loads(ops, wafer)
        mcl, cur = _max_link(loads)  # Phase 2
        cur_state = _state(loads)
        if mcl is None or cur <= 0:
            break
        improved = False
        # Phase 4c: stream-direction reversal (paper Fig. 11 reroutes whole
        # chains, e.g. D2→D0→D8→D10 becomes D0→D2→D10→D8) — uses the
        # opposite directed links, which are often idle.
        for op in ops:
            if op.kind not in ("p2p_ring", "p2p_chain", "allgather",
                               "reducescatter"):
                continue
            uses = any(_pair_uses_link(op, idx, pair, wafer, mcl)
                       for idx, pair in enumerate(op.pairs()))
            if not uses:
                continue
            old_group = op.group
            old_routing = dict(op.routing)
            op.group = tuple(reversed(op.group))
            op.routing = {i: "xy" for i, _ in enumerate(op.pairs())}
            new_state = _state(link_loads(ops, wafer))
            if new_state < cur_state:
                cur_state = new_state
                cur = new_state[0]
                improved = True
                rerouted += 1
            else:
                op.group = old_group
                op.routing = old_routing
        # Phase 3: congested paths through mcl
        for op in ops:
            for idx, pair in enumerate(op.pairs()):
                if not _pair_uses_link(op, idx, pair, wafer, mcl):
                    continue
                old = op.routing.get(idx, "xy")
                old_custom = op.custom_paths.get(idx)
                # Phase 4b: congestion-aware re-route — dimension swap,
                # shortest detour, then load-weighted Dijkstra
                candidates = [a for a in ("yx", "xy", "detour")
                              if a != old]
                # weighted path against the residual load (without this pair)
                residual = dict(link_loads(ops, wafer))
                per_hop = op.pair_bytes() * (0.5 if op.multicast else 1.0)
                for link in (path_for(wafer, pair[0], pair[1], old, op, idx)
                             or []):
                    residual[link] = residual.get(link, 0.0) - per_hop
                wpath = wafer.weighted_path(pair[0], pair[1], residual,
                                            hop_cost=op.pair_bytes() * 0.05)
                for alt in candidates + (["custom"] if wpath else []):
                    if alt == "custom":
                        op.custom_paths[idx] = wpath
                    elif path_for(wafer, pair[0], pair[1], alt) is None:
                        continue
                    op.routing[idx] = alt
                    new_state = _state(link_loads(ops, wafer))
                    if new_state < cur_state:
                        cur_state = new_state
                        cur = new_state[0]
                        improved = True
                        rerouted += 1
                        break
                    op.routing[idx] = old
                    if alt == "custom":
                        if old_custom is None:
                            op.custom_paths.pop(idx, None)
                        else:
                            op.custom_paths[idx] = old_custom
        # Phase 5: global update & termination check
        history.append(cur)
        if improved and cur < best - min_gain * best:
            best = cur
            stall = 0
        else:
            stall += 1

    loads = link_loads(ops, wafer)
    _, final = _max_link(loads)
    report = TCMEReport(init_load, final, it, merged, rerouted, history)
    if ckey is not None:
        wafer._tcme_cache[ckey] = (report, [
            (op.group, dict(op.routing), dict(op.custom_paths),
             op.multicast) for op in ops])
    return report
