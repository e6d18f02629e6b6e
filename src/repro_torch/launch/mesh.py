"""A plan's device layout for the port's launchers (counterpart of the
plan half of ``repro.launch.mesh``, ``make_plan_mesh``).

The reference builds a jax ``(data, model)`` mesh from a plan's degrees
and snake device order.  The port runs on one device, and a plan's mesh
on one device, ``plan.mesh_shape_for(1)``, is ``(1, 1)`` whatever the
wafer's degrees: the plan's rings shrink to that device, as the
reference's do on a one-device CPU run.  :func:`make_plan_dist` returns
the port's :class:`~repro_torch.core.dist.Dist` for it; a layout with
more than one device on an axis is the ring, ROADMAP.md item A3, and
raises.  There is no jax mesh and no process group.
"""

from __future__ import annotations

from repro_torch import not_ported
from repro_torch.core.dist import Dist, resolve_device


def plan_mesh_shape(plan, n_devices: int = 1) -> tuple[int, int]:
    """The ``(data, model)`` shape a :class:`~repro_torch.core.plan.
    WaferPlan` (or a ServePlan's decode plan) prescribes on ``n_devices``
    devices; raises unless it is one device, ``(1, 1)``."""
    plan = getattr(plan, "plan", plan)  # ServePlan wraps its decode mesh
    data, model = plan.mesh_shape_for(n_devices)
    if (data, model) != (1, 1):
        raise not_ported(f"plan {plan.plan_hash}'s (data, model) = "
                         f"({data}, {model}) mesh on {n_devices} devices",
                         "A3")
    return data, model


def make_plan_dist(plan, device="cuda") -> Dist:
    """The port's :class:`Dist` for ``plan`` on ``device``: the plan's
    mesh on one device (:func:`plan_mesh_shape`)."""
    plan_mesh_shape(plan, 1)
    return Dist(resolve_device(device))
