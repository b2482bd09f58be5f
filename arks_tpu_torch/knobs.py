"""The port's one reader of its ``ARKS_*`` settings: a table of defaults
and typed getters that parse and validate (a local reader: the reference's
registry lives in its own package).  Defaults equal the reference's
registry entries; reads are live (``os.environ`` at call time), so tests
and launchers may set a value just before the reading object is built.
An empty value counts as unset, except for ``get_bool`` (the reference's
rule: "" reads False)."""

from __future__ import annotations

import os

DEFAULTS: dict[str, str | None] = {
    # Admission and scheduling (engine/engine.py).
    "ARKS_ADMIT_BATCH_SIZES": "8,4,2,1",
    "ARKS_MIXED_STEP": "auto",
    "ARKS_MIXED_CHUNK_TOKENS": None,        # the engine's prefill chunk
    "ARKS_PIPELINE_DEPTH": "2",
    "ARKS_SAMPLER_FUSE": "1",
    "ARKS_OVERLAP_DECODE": "auto",
    # Prefix tiers; the disk tier, peer fetch and preemption are refused.
    "ARKS_PREFIX_HOST_MB": "256",
    "ARKS_PREFIX_DISK_MB": "0",
    "ARKS_PEER_FETCH": "0",
    "ARKS_PEER_ADDRS": None,
    "ARKS_PREEMPT": "0",
    # Kernels and quantization.
    "ARKS_MIXED_GRID": "ragged",
    "ARKS_MOE_KERNEL": "auto",
    "ARKS_INT4_GROUP": "128",
    # Guided decoding and tool calls.
    "ARKS_GUIDE_MAX": "8",
    "ARKS_GUIDE_ROWS": "4096",
    "ARKS_GUIDE_CLASSES": "2048",
    "ARKS_GUIDE_COMPILE_WORKERS": "2",
    "ARKS_JSON_DEPTH": "3",
    "ARKS_TOOL_PARSER": "auto",
    # Fair, bounded admission, tenants and the SLO ladder.
    "ARKS_FAIR": "1",
    "ARKS_FAIR_QUANTUM_TOKENS": "512",
    "ARKS_FAIR_WEIGHTS": None,
    "ARKS_QUEUE_MAX": "0",
    "ARKS_QUEUE_TENANT_MAX": "0",
    "ARKS_QUEUE_AGING_S": "0",
    "ARKS_SHED_DEADLINE": "0",
    "ARKS_TENANT_LABEL_MAX": "32",
    "ARKS_SLO_TIERS": None,
    "ARKS_SLO_BURN_WINDOW_S": "60",
    "ARKS_SLO_ERROR_BUDGET": "0.1",
}


def raw(name: str, fallback: str | None = None) -> str | None:
    """The environment's value (empty counts as unset), else the default,
    else ``fallback``.  An unknown name raises: every setting read here is
    listed above."""
    if name not in DEFAULTS:
        raise KeyError(f"{name} is not a setting of this reader")
    return os.environ.get(name) or DEFAULTS[name] or fallback


def get_str(name: str, fallback: str | None = None) -> str | None:
    return raw(name, fallback)


def _number(name, conv, what, fallback, minimum):
    v = raw(name, None if fallback is None else str(fallback)) or "0"
    try:
        value = conv(v)
    except ValueError:
        raise ValueError(f"{name}={v!r}: expected {what}") from None
    if minimum is not None and value < minimum:
        raise ValueError(f"{name}={v}: must be >= {minimum}")
    return value


def get_int(name: str, fallback: int | None = None,
            minimum: int | None = None) -> int:
    """Integer setting; ``fallback`` stands in for a computed default,
    ``minimum`` bounds it from below."""
    return _number(name, int, "an integer", fallback, minimum)


def get_float(name: str, minimum: float | None = None) -> float:
    return _number(name, float, "a number", None, minimum)


def get_enum(name: str, values: tuple[str, ...]) -> str:
    v = raw(name)
    if v not in values:
        raise ValueError(f"{name}={v!r}: expected one of "
                         f"{', '.join(values)}")
    return v


def get_bool(name: str) -> bool:
    """"0", "false" and "" read False, anything else True (the
    reference's rule)."""
    v = os.environ.get(name, raw(name))
    return v is not None and v.strip().lower() not in ("", "0", "false")
