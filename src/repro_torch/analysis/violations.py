"""Violation records shared by the plan verifier and the invariant linter.

Copy of ``repro.analysis.violations`` (the port imports nothing of
``repro``): the reference's names, constants and arithmetic, in its
order, so results are bitwise equal to the reference's.

One finding type for both passes keeps the CLI, the ``--check`` gates and
the machine-readable report uniform: a verifier finding carries the plan
file (or no path, for an in-memory plan) and a ``plan/...`` code; a
linter finding carries the source location and a ``lint/<rule>`` code.

Severity semantics: ``error`` findings fail CLIs, gates and the compile
pipeline (a cached plan with error findings is quarantined and
re-solved); ``warning`` findings are surfaced but never fail anything —
they mark checks run with partial information (e.g. memory checks
against the *default* :class:`~repro_torch.wafer.topology.WaferSpec` when the
deployment's live wafer was not provided).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Iterable, Sequence

SEV_ERROR = "error"
SEV_WARNING = "warning"


@dataclass(frozen=True)
class Violation:
    """One verifier or linter finding."""

    code: str  # e.g. "plan/degree-oversubscribed", "lint/determinism"
    message: str
    severity: str = SEV_ERROR
    path: str = ""  # plan file or source file ("" for in-memory plans)
    line: int = 0  # 1-based source line (lint findings; 0 = whole file)
    rule: str = ""  # linter rule name ("" for verifier findings)

    def format(self) -> str:
        loc = self.path or "<plan>"
        if self.line:
            loc += f":{self.line}"
        return f"{loc}: {self.severity}: [{self.code}] {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class PlanVerificationError(ValueError):
    """A freshly-solved plan failed static verification.

    Raised by the ``compile_*`` pipelines *before* the cache write: a plan
    that violates its own invariants must never be published, cached, or
    launched.  (Cached entries that fail verification are quarantined and
    re-solved instead — see ``repro_torch.core.plan``.)
    """

    def __init__(self, violations: Sequence[Violation]):
        self.violations = tuple(violations)
        lines = "\n".join("  " + v.format() for v in self.violations)
        super().__init__(
            f"plan failed static verification "
            f"({len(self.violations)} violation(s)):\n{lines}")


def errors(violations: Iterable[Violation]) -> list[Violation]:
    return [v for v in violations if v.severity == SEV_ERROR]


def warnings(violations: Iterable[Violation]) -> list[Violation]:
    return [v for v in violations if v.severity == SEV_WARNING]


def write_report(violations: Sequence[Violation], path: str,
                 meta: dict | None = None) -> str:
    """Write the machine-readable violation report (CI artifact)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    report = {
        "n_violations": len(violations),
        "n_errors": len(errors(violations)),
        "n_warnings": len(warnings(violations)),
        "violations": [v.to_dict() for v in violations],
    }
    if meta:
        report.update(meta)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path
