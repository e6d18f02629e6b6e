"""Spatial mapping of parallel groups onto the wafer (paper Fig. 7).

Copy of ``repro.wafer.mapping`` (the port imports nothing of ``repro``):
the reference's names, constants and arithmetic, in its order, so
results are bitwise equal to the reference's.

Three engines:

* ``smap`` — the sequential baseline: row-major assignment with a fixed
  strategy order; many rings end up non-contiguous ("tetris" patterns).
* ``gmap`` — Gemini-adapted: flexible degrees/ordering but no spatial or
  contention awareness (row-major placement too).
* ``tcme`` — snake-order embedding: every ring group occupies physically
  contiguous dies along a boustrophedon path, so all ring hops are 1
  (the enabling condition for TATP), and orthogonal parallelisms get
  disjoint link sets where possible.

``device_order_for_jax`` exports the same embedding as a device permutation
for ``jax.make_mesh`` — the deployable output of TCME on TPU meshes.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from repro_torch.wafer.topology import Wafer


@lru_cache(maxsize=None)
def _snake(rows: int, cols: int) -> tuple[int, ...]:
    order = []
    for r in range(rows):
        cs = range(cols) if r % 2 == 0 else range(cols - 1, -1, -1)
        for c in cs:
            order.append(r * cols + c)
    return tuple(order)


def snake_order(rows: int, cols: int) -> list[int]:
    """Boustrophedon enumeration: a Hamiltonian path on the 2D mesh —
    consecutive entries are always physically adjacent."""
    return list(_snake(rows, cols))


def rowmajor_order(rows: int, cols: int) -> list[int]:
    return list(range(rows * cols))


def make_groups(wafer: Wafer, group_size: int, engine: str,
                dies: list[int] | None = None) -> list[tuple[int, ...]]:
    """Partition the (alive) dies into parallel groups of ``group_size``."""
    spec = wafer.spec
    if dies is None:
        dies = wafer.alive_dies()
    live = set(dies)
    if engine in ("tcme", "snake"):
        base = [d for d in snake_order(spec.rows, spec.cols) if d in live]
    else:  # smap / gmap: row-major
        base = [d for d in rowmajor_order(spec.rows, spec.cols) if d in live]
    n_groups = len(base) // group_size
    return [tuple(base[g * group_size:(g + 1) * group_size])
            for g in range(n_groups)]


def ring_contiguity_stats(groups: list[tuple[int, ...]], wafer: Wafer,
                          wrap: bool = False) -> dict:
    """How many groups form contiguous physical rings/lines (Fig. 7a)."""
    from repro_torch.wafer.traffic import max_ring_hops
    hops = [max_ring_hops(g, wafer, wrap=wrap) for g in groups]
    return {
        "groups": len(groups),
        "contiguous": sum(1 for h in hops if h <= 1),
        "max_hops": max(hops) if hops else 0,
        "mean_hops": float(np.mean(hops)) if hops else 0.0,
    }


def device_order_for_jax(data_degree: int, model_degree: int) -> np.ndarray:
    """Device permutation for ``jax.make_mesh((data, model), ...)`` that
    embeds every model-axis ring contiguously (snake) on a
    ``data×model`` grid of chips — TCME's deployable output."""
    order = snake_order(data_degree, model_degree)
    return np.asarray(order)


def hierarchical_map(wafer: Wafer, degrees: dict[str, int],
                     engine: str) -> dict[str, list[tuple[int, ...]]]:
    """Assign nested parallel groups (paper Fig. 10 coordinates).

    ``degrees`` maps axis name (outer→inner, e.g. {"dp": 2, "tatp": 16}) to
    its degree; the product must not exceed the alive die count.  Inner axes
    get contiguous runs (rings), outer axes stride across them.
    """
    dies = wafer.alive_dies()
    total = 1
    for v in degrees.values():
        total *= v
    if total > len(dies):
        raise ValueError(f"degrees {degrees} exceed {len(dies)} dies")
    base = (snake_order(wafer.spec.rows, wafer.spec.cols)
            if engine in ("tcme", "snake")
            else rowmajor_order(wafer.spec.rows, wafer.spec.cols))
    live = set(dies)
    base = [d for d in base if d in live][:total]

    axes = list(degrees.items())
    out: dict[str, list[tuple[int, ...]]] = {}
    base_arr = np.asarray(base, np.int64)
    inner = total
    for name, deg in axes:
        inner //= deg
        n_outer = total // (deg * inner)
        # group[(o, i)][k] = base[o·deg·inner + k·inner + i]: reshape to
        # (outer, deg, inner) and swap the stride axes — same enumeration
        # as the nested scalar loops, built in one shot
        rows = base_arr.reshape(n_outer, deg, inner) \
            .transpose(0, 2, 1).reshape(-1, deg)
        out[name] = [tuple(r) for r in rows.tolist()]
    return out
