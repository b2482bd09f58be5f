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
    # Prefix tiers; the disk tier and peer fetch are refused.
    "ARKS_PREFIX_HOST_MB": "256",
    "ARKS_PREFIX_DISK_MB": "0",
    "ARKS_PEER_FETCH": "0",
    "ARKS_PEER_ADDRS": None,
    # Windowed-residency decode: a slot's resident page budget (0 = off).
    "ARKS_RESIDENCY_WINDOW_PAGES": "0",
    # The multi-model weight pool and its switch policy
    # (engine/model_pool.py).
    "ARKS_MODEL_POOL_HBM_MB": "0",
    "ARKS_MODEL_SWITCH_POLICY": "drain",
    "ARKS_MODEL_SWITCH_QUANTUM_S": "5",
    # Scale-to-zero of an idle engine and its re-arm.
    "ARKS_ELASTIC_IDLE_ZERO_S": "0",
    "ARKS_ELASTIC_WARMUP": "1",
    # Preemptive KV swap for SLO tiers.
    "ARKS_PREEMPT": "0",
    "ARKS_PREEMPT_MAX_INFLIGHT": "1",
    "ARKS_PREEMPT_COOLDOWN_S": "2",
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
    # Fault isolation, token replay and the dispatch watchdog
    # (engine/faults.py).
    "ARKS_FAULT_RETRIES": "1",
    "ARKS_FAULT_INJECT": None,
    "ARKS_FAULT_HANG_S": "3600",
    "ARKS_DISPATCH_DEADLINE_S": "0",
    # Request tracing and profiler windows (obs/).
    "ARKS_TRACE": "1",
    "ARKS_TRACE_RING": "8192",
    "ARKS_TRACE_SAMPLE": "1.0",
    "ARKS_TRACE_TAIL": "256",
    "ARKS_TRACE_FLUSH_S": "0.2",
    "ARKS_TRACE_MAX": "256",
    "ARKS_PROF_AUTO_ARM": "0",
    "ARKS_PROF_WINDOW_S": "5",
    "ARKS_PROF_DIR": "/tmp/arks-prof",
    # The server's SIGTERM grace (server/__main__.py --drain-timeout).
    "ARKS_DRAIN_TIMEOUT": "20",
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
