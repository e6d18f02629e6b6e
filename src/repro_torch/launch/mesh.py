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
every plan's mesh is ``(1, 1)``.  The stage partition of a multi-wafer
plan (``stage_device_partition``) and its submeshes belong to the train
ring, ROADMAP.md item A3a.
"""

from __future__ import annotations

import torch.distributed as tdist

from repro_torch.core.dist import Dist, make_mesh_dist
from repro_torch.wafer.mapping import device_order_for_jax

__all__ = ["make_mesh_dist", "make_plan_dist", "plan_device_permutation",
           "plan_mesh_shape"]


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
