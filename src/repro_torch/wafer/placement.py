"""Topology-aware expert placement for expert-parallel decode.

Copy of ``repro.wafer.placement`` (the port imports nothing of
``repro``): the reference's names, constants and arithmetic, in its
order, so results are bitwise equal to the reference's.

Under ``ep`` expert parallelism the ``dp`` replica positions split into
``ep`` expert groups (each hosting ``n_experts/ep`` experts plus a full
dense copy); every decode layer then runs a dispatch/combine all-to-all
between *a2a sets* — one replica position per expert group.  On a 2D
mesh the grouping decides how far those all-to-alls reach: consecutive
snake positions are physically adjacent, so whichever scheme makes a2a
partners consecutive wins on hop distance (MoEntwine's observation that
expert placement must be co-designed with the dispatch routes).

Two deterministic schemes are scored and the better one recorded:

* ``"blocked"`` — expert group ``g`` hosts the contiguous position block
  ``[g·dp/ep, (g+1)·dp/ep)``; a2a partners are strided ``dp/ep`` apart.
* ``"strided"`` — expert group ``g`` hosts positions ``≡ g (mod ep)``;
  a2a partners are consecutive positions.

The choice is data-independent (pure topology), so it is computed once
per (degrees, engine) and cached on the wafer alongside the ring-hop
factors.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.wafer.topology import Wafer
from repro_torch.wafer.traffic import a2a_group_stats

SCHEMES = ("blocked", "strided")


@dataclass(frozen=True)
class ExpertPlacement:
    """A placement decision: which dies host each expert group, plus the
    all-to-all congestion stats of the dispatch pattern it induces."""

    ep: int
    scheme: str  # member of SCHEMES
    # die ids per expert group (ep disjoint tuples partitioning the mesh)
    placement: tuple[tuple[int, ...], ...]
    a2a_load: int  # bottleneck link multiplicity (ordered pair paths)
    a2a_hops: int  # longest single-pair path (hop-latency term)
    mean_hops: float  # mean pair path length (the placement objective)


def group_positions(dp: int, ep: int, scheme: str) -> list[tuple[int, ...]]:
    """Replica positions (0..dp-1) hosted by each expert group."""
    width = dp // ep
    if scheme == "blocked":
        return [tuple(range(g * width, (g + 1) * width))
                for g in range(ep)]
    if scheme == "strided":
        return [tuple(range(g, dp, ep)) for g in range(ep)]
    raise ValueError(scheme)


def a2a_position_sets(dp: int, ep: int, scheme: str) -> list[tuple[int, ...]]:
    """The dp positions partition into ``dp/ep`` all-to-all sets, one
    member per expert group (the j-th member of every group exchange
    tokens with each other)."""
    width = dp // ep
    if scheme == "blocked":  # one position out of each contiguous block
        return [tuple(g * width + j for g in range(ep))
                for j in range(width)]
    if scheme == "strided":  # consecutive positions, one per residue
        return [tuple(j * ep + g for g in range(ep))
                for j in range(width)]
    raise ValueError(scheme)


def a2a_die_sets(dp_groups: list[tuple[int, ...]], dp: int, ep: int,
                 scheme: str) -> list[tuple[int, ...]]:
    """Concrete die sets of every concurrent all-to-all: the position
    sets instantiated at every inner (tp/sp/tatp) coordinate."""
    psets = a2a_position_sets(dp, ep, scheme)
    return [tuple(grp[p] for p in ps)
            for grp in dp_groups for ps in psets]


def placement_for(dp_groups: list[tuple[int, ...]], dp: int, ep: int,
                  scheme: str) -> tuple[tuple[int, ...], ...]:
    """Die partition per expert group: every die of every replica position
    the group hosts (sorted, disjoint across groups)."""
    return tuple(
        tuple(sorted(grp[p] for grp in dp_groups for p in ps))
        for ps in group_positions(dp, ep, scheme)
    )


def choose_expert_placement(wafer: Wafer,
                            dp_groups: list[tuple[int, ...]],
                            dp: int, ep: int) -> ExpertPlacement:
    """Pick the scheme minimizing mean a2a hop distance on this wafer
    (tie-break: lower bottleneck multiplicity, then scheme order — fully
    deterministic)."""
    if ep <= 1 or dp % ep:
        raise ValueError(f"ep={ep} must divide dp={dp} and exceed 1")
    best = None
    for scheme in SCHEMES:
        load, hops, mean = a2a_group_stats(
            a2a_die_sets(dp_groups, dp, ep, scheme), wafer)
        cand = (mean, load, SCHEMES.index(scheme), scheme, hops)
        if best is None or cand < best:
            best = cand
    mean, load, _, scheme, hops = best
    return ExpertPlacement(ep=ep, scheme=scheme,
                           placement=placement_for(dp_groups, dp, ep,
                                                   scheme),
                           a2a_load=load, a2a_hops=hops, mean_hops=mean)
