"""JSON Schemas for the on-disk plan IRs (``plan_*.json`` /
``splan_*.json`` / ``mwplan_*.json``).

Copy of ``repro.analysis.schema`` (the port imports nothing of
``repro``): the reference's names, constants and arithmetic, in its
order, so results are bitwise equal to the reference's.

The schemas are the machine-checked twin of the dataclass definitions in
:mod:`repro_torch.core.plan`: strict at the top level (``additionalProperties:
false`` — ``from_dict`` silently drops unknown keys, so an entry with
extra keys would load fine but its recomputed ``plan_hash`` would no
longer match the raw bytes, which is exactly the drift class the
verifier exists to catch early).  ``predicted`` / ``solver`` stay free-
form objects: they are advisory telemetry, excluded from the plan hash.

Validation prefers the real ``jsonschema`` package when importable and
falls back to a minimal structural validator (required keys + scalar
types) so the verifier works in minimal environments.
"""

from __future__ import annotations

from typing import Any, Optional

from repro_torch.analysis.violations import SEV_ERROR, Violation

_INT = {"type": "integer"}
_NUM = {"type": "number"}
_STR = {"type": "string"}
_BOOL = {"type": "boolean"}
_INT_ARRAY = {"type": "array", "items": _INT}
_OBJ = {"type": "object"}
_LINK_ARRAY = {
    "type": "array",
    "items": {"type": "array", "items": _INT,
              "minItems": 2, "maxItems": 2},
}

WAFER_PLAN_SCHEMA: dict = {
    "type": "object",
    "required": [
        "arch", "batch", "seq", "wafer_rows", "wafer_cols",
        "failed_dies", "failed_links", "alive_dies",
        "dp", "tp", "sp", "tatp", "seq_par", "engine", "space",
        "device_order", "stream", "bidirectional", "stream_dtype",
        "schedule", "remat", "predicted", "solver", "version",
    ],
    "properties": {
        "arch": _STR, "batch": _INT, "seq": _INT,
        "wafer_rows": _INT, "wafer_cols": _INT,
        "failed_dies": _INT_ARRAY, "failed_links": _LINK_ARRAY,
        "alive_dies": _INT_ARRAY,
        "dp": _INT, "tp": _INT, "sp": _INT, "tatp": _INT,
        "seq_par": _BOOL, "engine": _STR, "space": _STR,
        "device_order": _INT_ARRAY,
        "stream": _STR, "bidirectional": _BOOL, "stream_dtype": _STR,
        "schedule": _STR, "remat": _BOOL,
        "predicted": _OBJ, "solver": _OBJ, "version": _INT,
    },
    "additionalProperties": False,
}

SERVE_PLAN_SCHEMA: dict = {
    "type": "object",
    "required": [
        "plan", "max_batch", "max_seq", "kv_layout", "kv_bytes_per_die",
        "kv_budget_tokens", "stream_dtype", "prefill_chunk",
        "ep", "expert_placement", "a2a_bytes_per_token",
        "predicted", "solver", "version",
    ],
    "properties": {
        "plan": WAFER_PLAN_SCHEMA,
        "max_batch": _INT, "max_seq": _INT,
        "kv_layout": {
            "type": "array",
            "items": {"type": "array", "minItems": 2, "maxItems": 2},
        },
        "kv_bytes_per_die": _NUM, "kv_budget_tokens": _INT,
        "stream_dtype": _STR, "prefill_chunk": _INT,
        "ep": _INT,
        # die ids per expert group: ep disjoint tuples (empty when ep == 1)
        "expert_placement": {"type": "array", "items": _INT_ARRAY},
        "a2a_bytes_per_token": _NUM,
        "predicted": _OBJ, "solver": _OBJ, "version": _INT,
    },
    "additionalProperties": False,
}

MULTI_WAFER_PLAN_SCHEMA: dict = {
    "type": "object",
    "required": [
        "arch", "batch", "seq", "n_wafers", "pp", "n_micro", "family",
        "inter_wafer_bw", "stage_layers", "stage_wafer", "stages",
        "predicted", "solver", "version",
    ],
    "properties": {
        "arch": _STR, "batch": _INT, "seq": _INT,
        "n_wafers": _INT, "pp": _INT, "n_micro": _INT, "family": _STR,
        "inter_wafer_bw": _NUM,
        "stage_layers": _INT_ARRAY, "stage_wafer": _INT_ARRAY,
        "stages": {"type": "array", "items": WAFER_PLAN_SCHEMA},
        "predicted": _OBJ, "solver": _OBJ, "version": _INT,
    },
    "additionalProperties": False,
}

# fault/repair timeline files (``launch/serve.py --fault-trace FILE.json``,
# :class:`repro_torch.wafer.fault.FaultTrace`).  Strict like the plan IRs: an
# event key the engine does not know (a typo'd ``repared_dies``) would
# silently drop a repair from the timeline, which is exactly the failure
# mode a chaos trace exists to exercise.
FAULT_TRACE_SCHEMA: dict = {
    "type": "object",
    "required": ["events"],
    "properties": {
        "kind": _STR,
        "seed": _INT,
        "events": {
            "type": "array",
            "items": {
                "type": "object",
                "required": ["time"],
                "properties": {
                    "time": _NUM,
                    "failed_dies": _INT_ARRAY,
                    "failed_links": _LINK_ARRAY,
                    "repaired_dies": _INT_ARRAY,
                    "repaired_links": _LINK_ARRAY,
                },
                "additionalProperties": False,
            },
        },
    },
    "additionalProperties": False,
}

SCHEMAS = {
    "plan": WAFER_PLAN_SCHEMA,
    "splan": SERVE_PLAN_SCHEMA,
    "mwplan": MULTI_WAFER_PLAN_SCHEMA,
}


def plan_kind(raw: dict, filename: str = "") -> Optional[str]:
    """Which IR a raw plan dict (or its filename) encodes."""
    base = filename.rsplit("/", 1)[-1]
    for kind in ("splan", "mwplan", "plan"):
        if base.startswith(kind + "_"):
            return kind
    if not isinstance(raw, dict):
        return None
    if "stages" in raw:
        return "mwplan"
    if "max_batch" in raw and "plan" in raw:
        return "splan"
    if "device_order" in raw:
        return "plan"
    return None


def _type_ok(value: Any, schema: dict) -> bool:
    t = schema.get("type")
    if t == "object":
        return isinstance(value, dict)
    if t == "array":
        return isinstance(value, list)
    if t == "string":
        return isinstance(value, str)
    if t == "integer":
        return isinstance(value, int) and not isinstance(value, bool)
    if t == "number":
        return (isinstance(value, (int, float))
                and not isinstance(value, bool))
    if t == "boolean":
        return isinstance(value, bool)
    return True


def _validate_minimal(raw: Any, schema: dict, where: str = "") -> list[str]:
    """Structural fallback when ``jsonschema`` is unavailable: required
    keys, top-level scalar/container types, one level of recursion into
    nested plan objects/arrays."""
    probs: list[str] = []
    if not isinstance(raw, dict):
        return [f"{where or '$'}: not a JSON object"]
    for key in schema.get("required", ()):
        if key not in raw:
            probs.append(f"{where}{key}: required key missing")
    for key, sub in schema.get("properties", {}).items():
        if key not in raw:
            continue
        val = raw[key]
        if not _type_ok(val, sub):
            probs.append(f"{where}{key}: expected {sub.get('type')}, "
                         f"got {type(val).__name__}")
            continue
        if sub.get("required"):  # nested plan object
            probs += _validate_minimal(val, sub, f"{where}{key}.")
        elif (sub.get("type") == "array"
              and sub.get("items", {}).get("required")):
            for i, item in enumerate(val):
                probs += _validate_minimal(item, sub["items"],
                                           f"{where}{key}[{i}].")
    if not schema.get("additionalProperties", True):
        known = set(schema.get("properties", {}))
        for key in raw:
            if key not in known:
                probs.append(f"{where}{key}: unknown key")
    return probs


def validate_plan_json(raw: Any, kind: str,
                       path: str = "") -> list[Violation]:
    """Validate a raw (parsed) plan JSON document against its schema."""
    schema = SCHEMAS[kind]
    try:
        import jsonschema
        probs = [
            f"{'/'.join(str(p) for p in e.absolute_path) or '$'}: "
            f"{e.message}"
            for e in jsonschema.Draft7Validator(schema).iter_errors(raw)
        ]
    except ImportError:
        probs = _validate_minimal(raw, schema)
    return [Violation(code="file/schema", message=p, severity=SEV_ERROR,
                      path=path) for p in sorted(probs)]


def validate_fault_trace(raw: Any) -> None:
    """Validate a raw fault-trace document; raise ``ValueError`` listing
    every problem.  Called by :meth:`repro_torch.wafer.fault.FaultTrace.from_dict`
    before any event reaches the serve timeline — a malformed trace must
    fail loudly at load, not drop events silently mid-soak."""
    try:
        import jsonschema
        probs = sorted(
            f"{'/'.join(str(p) for p in e.absolute_path) or '$'}: "
            f"{e.message}"
            for e in jsonschema.Draft7Validator(
                FAULT_TRACE_SCHEMA).iter_errors(raw)
        )
    except ImportError:
        probs = sorted(_validate_minimal(raw, FAULT_TRACE_SCHEMA))
    if probs:
        raise ValueError("invalid fault trace: " + "; ".join(probs))
