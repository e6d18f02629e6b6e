"""A plan's device layout for the port's launchers (counterpart of
``repro.launch.mesh``'s ``plan_device_permutation`` and
``make_plan_mesh``).

The reference builds a jax ``(data, model)`` mesh from a plan's degrees
and snake device order.  Here the devices are the ranks of the
initialised ``torch.distributed`` world (one process each; one rank on
one device without a process group): :func:`make_plan_dist` gives this
rank's :class:`~repro_torch.core.dist.Dist` on the plan's mesh for the
world's size (``plan.mesh_shape_for``: the plan's ring degree shrunk to
divide the ranks), with the plan's device permutation;
:func:`make_mesh_dist` takes a shape instead (``--mesh``).  On one rank
every plan's mesh is ``(1, 1)``.  :func:`join_world` and
:func:`resolve_rank_plan` are the launchers' shared steps under
``torch.distributed.run``.  A multi-wafer plan's stages split the ranks
into contiguous blocks (:func:`stage_device_partition`), each with the
stage plan's mesh (:func:`make_stage_submeshes`); a ``--wafers N --stage
k`` launch runs one stage, whose plan's mesh spans its world's ranks
(:func:`make_plan_dist` of the stage plan), as the reference's
``make_plan_mesh(stage_plan)`` spans its process's devices.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as tdist

from repro_torch.core.dist import (Dist, init_world, make_mesh_dist,
                                   resolve_device, world_from_env)
from repro_torch.wafer.mapping import device_order_for_jax

__all__ = ["first_resolves", "join_world", "make_mesh_dist",
           "make_plan_dist", "make_stage_submeshes",
           "plan_device_permutation", "plan_mesh_shape",
           "resolve_rank_plan", "stage_device_partition"]


def plan_mesh_shape(plan, n_devices: int = 1) -> tuple[int, int]:
    """The ``(data, model)`` shape a :class:`~repro_torch.core.plan.
    WaferPlan` (or a ServePlan's decode plan) prescribes on ``n_devices``
    devices."""
    plan = getattr(plan, "plan", plan)  # ServePlan wraps its decode mesh
    return plan.mesh_shape_for(n_devices)


def plan_device_permutation(plan, n_devices: int) -> list[int]:
    """Device permutation a plan prescribes for ``n_devices`` (the
    reference's): at full scale, one device per alive die, the plan's own
    ``device_order`` compacted from die ids to device ranks; at reduced
    scale the dense snake over the shrunken ``(data, model)`` grid
    (``device_order_for_jax``)."""
    plan = getattr(plan, "plan", plan)
    if n_devices == len(plan.device_order):
        rank = {die: k for k, die in enumerate(sorted(plan.alive_dies))}
        return [rank[d] for d in plan.device_order]
    data, model = plan.mesh_shape_for(n_devices)
    return device_order_for_jax(data, model).tolist()


def make_plan_dist(plan, device="cuda") -> Dist:
    """This rank's :class:`Dist` on ``plan``'s mesh over the world's ranks
    (one without a process group), in the plan's device order."""
    world = tdist.get_world_size() if tdist.is_initialized() else 1
    return make_mesh_dist(plan_mesh_shape(plan, world), device,
                          order=plan_device_permutation(plan, world))


def stage_device_partition(plan, n_devices: int) -> list[list[int]]:
    """Partition ``n_devices`` device ranks into one contiguous block per
    pipeline stage of a :class:`~repro_torch.core.plan.MultiWaferPlan`
    (the reference's).

    At full scale (one device per solved die) each stage gets exactly as
    many devices as its die subset; at reduced scale (CPU smoke, elastic)
    the blocks shrink proportionally, never below one device per stage.
    """
    from repro_torch.wafer.solver import apportion
    pp = plan.pp
    if n_devices < pp:
        raise ValueError(f"{n_devices} devices cannot host a pp={pp} "
                         f"pipeline (one device per stage minimum)")
    sizes = [len(s.alive_dies) for s in plan.stages]
    cuts = sizes if n_devices == sum(sizes) \
        else apportion(n_devices, sizes)
    out, lo = [], 0
    for c in cuts:
        out.append(list(range(lo, lo + c)))
        lo += c
    return out


def make_stage_submeshes(plan, device="cuda") -> list[tuple[list[int],
                                                         Optional[Dist]]]:
    """One ``(ranks, dist)`` a pipeline stage over the world's ranks: the
    stage's block of :func:`stage_device_partition`, and this rank's
    :class:`Dist` on the stage plan's ``(data, model)`` mesh over that
    block in the plan's device order (None where this rank lies outside
    it).  Every rank of the world calls it: it creates every stage's
    groups."""
    world = tdist.get_world_size() if tdist.is_initialized() else 1
    out = []
    for stage, block in zip(plan.stages,
                            stage_device_partition(plan, world)):
        order = [block[k] for k in plan_device_permutation(stage,
                                                           len(block))]
        out.append((block, make_mesh_dist(plan_mesh_shape(stage, len(block)),
                                          device, order=order, ranks=block)))
    return out


def join_world(args) -> torch.device:
    """This rank's device.  Under ``torch.distributed.run`` the world from
    its environment is initialised once, with ``--dist-backend``, and
    each rank takes ``cuda:(LOCAL_RANK mod the cards)`` (so gloo ranks
    may share one)."""
    _, world, local = world_from_env()
    device = resolve_device(args.device)
    if world > 1 and device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local % torch.cuda.device_count())
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    if world > 1 and not tdist.is_initialized():
        init_world(getattr(args, "dist_backend", "gloo"))
    return device


def first_resolves(resolve):
    """``resolve()``, run by rank 0 first, so the other ranks of a world
    read its plan cache entry instead of writing the same file at once."""
    first = world_from_env()[0] == 0
    joined = tdist.is_initialized()
    if joined and not first:
        tdist.barrier()
    plan = resolve()
    if joined and first:
        tdist.barrier()
    return plan


def resolve_rank_plan(cfg, args, seq: int, remat: bool, failed_dies=None):
    """The plan for ``args`` (``--plan`` or ``--auto-plan``, ``--batch``,
    ``seq``), resolved by rank 0 first (:func:`first_resolves`)."""
    from repro_torch.launch.planning import resolve_plan

    return first_resolves(lambda: resolve_plan(
        cfg, args.batch, seq, plan_path=getattr(args, "plan", None),
        cache_dir=getattr(args, "plan_cache", None),
        failed_dies=failed_dies, remat=remat))
