"""Plan-driven serving subsystem: continuous-batching decode off a
compiled :class:`repro_torch.core.plan.ServePlan`, with elastic fault recovery
(live replan + KV-cache migration, :mod:`repro_torch.serve.migrate`) governed
under fault *streams* by :mod:`repro_torch.serve.governor` (debounce,
hysteresis, backoff, cached reverts).

Copy of ``repro.serve`` (the port imports nothing of ``repro``):
the reference's names, constants and arithmetic, in its order, so
results are bitwise equal to the reference's.
"""

from repro_torch.serve.engine import (ContinuousBatchingScheduler,
                                CostModelExecutor, FaultEvent, RecoveryEvent,
                                Request, RequestState, ServeEngine,
                                ServeReport, VirtualClock, WallClock,
                                poisson_arrivals, rolling_peak_throughput,
                                validate_request)
from repro_torch.serve.governor import (GovernorConfig, GovernorDecision,
                                  GovernorEvent, ReplanGovernor,
                                  predict_plan_throughput)
from repro_torch.serve.migrate import KVMigration, plan_kv_migration

__all__ = [
    "ContinuousBatchingScheduler",
    "CostModelExecutor",
    "FaultEvent",
    "GovernorConfig",
    "GovernorDecision",
    "GovernorEvent",
    "KVMigration",
    "RecoveryEvent",
    "ReplanGovernor",
    "Request",
    "RequestState",
    "ServeEngine",
    "ServeReport",
    "VirtualClock",
    "WallClock",
    "plan_kv_migration",
    "poisson_arrivals",
    "predict_plan_throughput",
    "rolling_peak_throughput",
    "validate_request",
]
