"""Communication ops and link-load accounting on the wafer mesh.

Copy of ``repro.wafer.traffic`` (the port imports nothing of ``repro``):
the reference's names, constants and arithmetic, in its order, so
results are bitwise equal to the reference's.

A training phase is a set of :class:`CommOp`s that execute concurrently; the
phase's wall time is governed by the most-loaded link (the paper's Fig. 11
contention analysis).  TCME's optimizer permutes routing choices to minimise
that maximum load.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Literal, Optional

import numpy as np

from repro_torch.wafer.topology import Link, Wafer

Kind = Literal["p2p_ring", "p2p_chain", "allreduce", "allgather",
               "reducescatter", "alltoall", "p2p"]


@dataclass
class CommOp:
    kind: Kind
    group: tuple[int, ...]  # die ids in ring order
    nbytes: float  # per-die payload bytes
    tag: str = ""
    # routing decision (filled by the optimizer): per consecutive pair,
    # "xy" | "yx" | "detour"
    routing: dict[int, str] = field(default_factory=dict)
    custom_paths: dict[int, list[Link]] = field(default_factory=dict)
    multicast: bool = False  # merged into a tree by the optimizer
    chunk_bytes: Optional[float] = None  # per-message granularity (None ->
    # ring chunk nbytes/|group|); drives the D2D efficiency ramp

    def chunk(self) -> float:
        if self.chunk_bytes is not None:
            return self.chunk_bytes
        return self.nbytes / max(len(self.group), 1)

    def pairs(self) -> list[tuple[int, int]]:
        g = self.group
        if len(g) < 2:
            return []
        if self.kind == "p2p":
            return [(g[0], g[1])]
        if self.kind == "p2p_chain":  # open chain (relay without wrap)
            return [(g[i], g[i + 1]) for i in range(len(g) - 1)]
        # ring ops: every consecutive pair (incl. wrap) carries traffic
        return [(g[i], g[(i + 1) % len(g)]) for i in range(len(g))]

    def pair_bytes(self) -> float:
        """Bytes crossing each ring hop for this op."""
        return pair_hop_bytes(self.kind, len(self.group), self.nbytes)


def path_for(wafer: Wafer, a: int, b: int, policy: str,
             op: Optional["CommOp"] = None,
             idx: Optional[int] = None) -> Optional[list[Link]]:
    if policy == "custom" and op is not None and idx in op.custom_paths:
        return op.custom_paths[idx]
    if policy == "xy":
        return wafer.xy_path(a, b)
    if policy == "yx":
        return wafer.yx_path(a, b)
    return wafer.detour_path(a, b)


def _default_routed(op: CommOp) -> bool:
    """True when every pair of ``op`` takes the default XY route (the state
    of every op outside a TCME optimizer pass) — the precondition for the
    per-group link template cache."""
    if op.custom_paths:
        return False
    if not op.routing:  # search-path ops: routing never populated
        return True
    return all(pol == "xy" for pol in op.routing.values())


@dataclass(frozen=True)
class _LinkTemplate:
    links: tuple[Link, ...]  # traversal order (pair by pair)
    max_len: int  # longest single-pair path (hop-latency term)
    ids: np.ndarray  # links as wafer link-registry ids (for bincount)


def link_template(kind: str, group: tuple[int, ...],
                  wafer: Wafer) -> _LinkTemplate:
    """Link template of a default-XY-routed op, cached per (pair structure,
    group) on the wafer.

    The link sequence preserves the exact pair-by-pair traversal order of
    the uncached loop, so accumulating loads over it — one element at a
    time, or via ``np.bincount`` (also sequential) — is bitwise identical
    to recomputing every path.

    ``kind="a2a"`` is the expert-dispatch structure: every *ordered* pair
    of the group carries traffic (token activations routed to remote
    expert shards and combined back), unlike the ring kinds where only
    consecutive pairs do.
    """
    struct = kind if kind in ("p2p", "p2p_chain", "a2a") else "ring"
    key = (struct, group)
    cached = wafer._tmpl_cache.get(key)
    if cached is not None:
        return cached
    if struct == "a2a":
        pairs = [(a, b) for a in group for b in group if a != b]
    else:
        probe = CommOp(struct if struct != "ring" else "p2p_ring",
                       group, 0.0)
        pairs = probe.pairs()
    links: list[Link] = []
    max_len = 0
    for a, b in pairs:
        path = wafer.xy_path(a, b)
        if path is None:
            path = wafer.detour_path(a, b)
        if path is None:
            continue  # unroutable (disconnected fault) — handled upstream
        links.extend(path)
        max_len = max(max_len, len(path))
    ids_map = wafer._link_ids
    for link in links:
        if link not in ids_map:
            ids_map[link] = len(ids_map)
    tmpl = _LinkTemplate(tuple(links), max_len,
                         np.array([ids_map[li] for li in links], np.int64))
    wafer._tmpl_cache[key] = tmpl
    return tmpl


def _op_link_template(op: CommOp, wafer: Wafer) -> _LinkTemplate:
    return link_template(op.kind, op.group, wafer)


def template_bank_row(ids: np.ndarray, wafer: Wafer) -> np.ndarray:
    """Dense per-link hop-count row of a (concatenated) link template,
    over the wafer's fixed link universe.

    This is the bank form of a template: ``row[link_id]`` counts how many
    times the pair-by-pair traversal crosses that link.  The batched
    traffic stage (`repro_torch.wafer.simulator`) gathers these rows into a
    per-wafer matrix so a whole candidate batch's link loads become row
    gathers — note that *consumers must replay the per-hop add chain*
    (``w`` added ``count`` times), not multiply ``count · w``, to stay
    bitwise identical to the sequential :func:`max_load_entries` /
    :func:`link_loads` accumulation.
    """
    return np.bincount(ids, minlength=wafer.link_universe())


def pair_hop_bytes(kind: str, glen: int, nbytes: float) -> float:
    """Bytes crossing each ring hop for one op (the single source of the
    per-kind formulas; :meth:`CommOp.pair_bytes` delegates here)."""
    if glen < 2:
        return 0.0
    if kind == "p2p":
        return nbytes
    if kind in ("p2p_ring", "p2p_chain"):  # TATP/relay streams
        return nbytes
    if kind == "allreduce":  # ring AR: 2(g-1)/g of the buffer
        return 2.0 * nbytes * (glen - 1) / glen
    if kind in ("allgather", "reducescatter"):
        return nbytes * (glen - 1) / glen
    if kind == "alltoall":
        return nbytes * (glen - 1) / glen
    raise ValueError(kind)


def a2a_group_stats(sets: list[tuple[int, ...]],
                    wafer: Wafer) -> tuple[int, int, float]:
    """``(bottleneck multiplicity, max pair hops, mean pair hops)`` over
    concurrently executing all-to-all sets.

    Every ordered pair of every set routes XY (detour fallback on degraded
    wafers); the bottleneck multiplicity is how many pair paths cross the
    busiest directed link.  All pairs of an EP dispatch carry the same
    per-pair volume, so ``bottleneck_bytes = multiplicity × pair_bytes``
    exactly — the multiplicity stays an int and the one float multiply
    happens in the (bitwise-pinned) decode cost path, not here.
    """
    ids_parts: list[np.ndarray] = []
    max_len = 0
    total_len = 0
    n_pairs = 0
    for g in sets:
        tmpl = link_template("a2a", tuple(g), wafer)
        if len(tmpl.ids):
            ids_parts.append(tmpl.ids)
        max_len = max(max_len, tmpl.max_len)
        total_len += len(tmpl.ids)
        n_pairs += len(g) * (len(g) - 1)
    if not ids_parts or not n_pairs:
        return 0, 0, 0.0
    idx = np.concatenate(ids_parts) if len(ids_parts) > 1 else ids_parts[0]
    loads = np.bincount(idx)
    return int(loads.max()), int(max_len), total_len / n_pairs


def max_load_entries(entries: list[tuple[np.ndarray, float]]
                     ) -> tuple[float, bool]:
    """Bottleneck load over (link-id template, per-hop weight) entries.

    ``np.bincount`` adds weights sequentially in input order — the same
    op-by-op, hop-by-hop order as the :func:`link_loads` dict loop — so the
    maximum is bitwise identical to ``max(link_loads(...).values())``.
    """
    ids_list, w_list, lens = [], [], []
    for ids, w in entries:
        m = len(ids)
        if m:
            ids_list.append(ids)
            w_list.append(w)
            lens.append(m)
    if not ids_list:
        return 0.0, False
    idx = np.concatenate(ids_list) if len(ids_list) > 1 else ids_list[0]
    w = np.repeat(np.asarray(w_list), np.asarray(lens))
    loads = np.bincount(idx, weights=w)
    return float(loads.max()), True


def max_link_load(ops: list[CommOp], wafer: Wafer,
                  weighted: bool = False) -> tuple[float, bool]:
    """(bottleneck link load, any link touched) for a phase.

    Fast path: when every op is default-XY-routed, loads accumulate with
    ``np.bincount`` over the cached link-id templates — the C loop adds
    weights in input order, i.e. the exact op-by-op, pair-by-pair,
    hop-by-hop order of :func:`link_loads`, so the bottleneck value is
    bitwise identical to ``max(link_loads(...).values())``.
    """
    spec = wafer.spec
    if wafer.cache_enabled and all(map(_default_routed, ops)):
        idx_parts: list[np.ndarray] = []
        w_parts: list[np.ndarray] = []
        for op in ops:
            tmpl = _op_link_template(op, wafer)
            m = len(tmpl.ids)
            if not m:
                continue
            per_hop = op.pair_bytes()
            if weighted:
                per_hop = per_hop / max(spec.bw_eff(op.chunk()), 1e-3)
            share = 0.5 if op.multicast else 1.0
            idx_parts.append(tmpl.ids)
            w_parts.append(np.full(m, per_hop * share))
        if not idx_parts:
            return 0.0, False
        idx = np.concatenate(idx_parts) if len(idx_parts) > 1 \
            else idx_parts[0]
        w = np.concatenate(w_parts) if len(w_parts) > 1 else w_parts[0]
        loads = np.bincount(idx, weights=w)
        return float(loads.max()), True
    loads = link_loads(ops, wafer, weighted=weighted)
    if not loads:
        return 0.0, False
    return max(loads.values()), True


def link_loads(ops: list[CommOp], wafer: Wafer,
               weighted: bool = False) -> dict[Link, float]:
    """Bytes per directed link across all ops in a phase.  ``weighted``
    divides by each op's message-granularity efficiency, yielding effective
    wire-seconds×bw per link."""
    loads: dict[Link, float] = {}
    spec = wafer.spec
    for op in ops:
        per_hop = op.pair_bytes()
        if weighted:
            per_hop = per_hop / max(spec.bw_eff(op.chunk()), 1e-3)
        share = 0.5 if op.multicast else 1.0
        if wafer.cache_enabled and _default_routed(op):
            x = per_hop * share
            for link in _op_link_template(op, wafer).links:
                loads[link] = loads.get(link, 0.0) + x
            continue
        for idx, (a, b) in enumerate(op.pairs()):
            pol = op.routing.get(idx, "xy")
            path = path_for(wafer, a, b, pol, op, idx)
            if path is None:
                path = wafer.detour_path(a, b)
            if path is None:
                continue  # unroutable (disconnected fault) — handled upstream
            for link in path:
                loads[link] = loads.get(link, 0.0) + per_hop * share
    return loads


def phase_time(ops: list[CommOp], wafer: Wafer) -> float:
    """Wall time of a concurrent comm phase: bottleneck link (weighted by
    each op's message-size efficiency — the paper's granularity challenge)
    plus serial hop latency."""
    if not ops:
        return 0.0
    mx, touched = max_link_load(ops, wafer, weighted=True)
    if not touched:
        return 0.0
    spec = wafer.spec
    t_bw = mx / spec.link_bw
    # serial hop latency along the longest path of any op
    max_hops = 0
    for op in ops:
        if wafer.cache_enabled and _default_routed(op):
            max_hops = max(max_hops, _op_link_template(op, wafer).max_len)
            continue
        for idx, (a, b) in enumerate(op.pairs()):
            pol = op.routing.get(idx, "xy")
            path = path_for(wafer, a, b, pol, op, idx) \
                or wafer.detour_path(a, b) or []
            max_hops = max(max_hops, len(path))
    return t_bw + max_hops * spec.hop_latency


def max_ring_hops(group: tuple[int, ...], wafer: Wafer,
                  wrap: bool = True) -> int:
    """Worst *routable* hop distance between ring-adjacent dies (tail
    latency, paper Fig. 5a).  Uses BFS on the (possibly degraded) wafer so
    failed links show up as longer detours."""
    if wafer.cache_enabled:
        key = (group, wrap)
        cached = wafer._ring_hops_cache.get(key)
        if cached is None:
            cached = _max_ring_hops(group, wafer, wrap)
            wafer._ring_hops_cache[key] = cached
        return cached
    return _max_ring_hops(group, wafer, wrap)


def _max_ring_hops(group: tuple[int, ...], wafer: Wafer, wrap: bool) -> int:
    if len(group) < 2:
        return 0
    pairs = [(group[i], group[(i + 1) % len(group)])
             for i in range(len(group) if wrap else len(group) - 1)]
    hops = []
    for a, b in pairs:
        if wafer.failed_links or wafer.failed_dies:
            path = wafer.detour_path(a, b)
            hops.append(len(path) if path is not None
                        else 4 * wafer.spec.n_dies)  # disconnected: huge
        else:
            hops.append(wafer.hops(a, b))
    return max(hops)
