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
    # Prefix tiers: host RAM, local disk, and blocks fetched from peers.
    "ARKS_PREFIX_HOST_MB": "256",
    "ARKS_PREFIX_DISK_MB": "0",
    "ARKS_PREFIX_DISK_DIR": None,           # <tmpdir>/arks-prefix-disk
    "ARKS_PEER_FETCH": "0",
    "ARKS_PEER_FETCH_TIMEOUT_S": "5",
    "ARKS_PEER_ADDRS": None,
    # The prefix-digest sketch the router polls (prefix_sketch.py).
    "ARKS_ROUTER_SKETCH_CHARS": "256",
    "ARKS_ROUTER_SKETCH_BITS": "16384",
    "ARKS_ROUTER_SKETCH_HASHES": "4",
    "ARKS_ROUTER_SKETCH_TOPK": "128",
    "ARKS_ROUTER_SKETCH_LINKS": "4096",
    # The router (router/__init__.py): its static backends, failover
    # backoff, sketch scoring and the planned-join wait.
    "ARKS_PREFILL_ADDRS": None,
    "ARKS_DECODE_ADDRS": None,
    "ARKS_ROUTER_UNIFIED": "0",
    "ARKS_ROUTER_RETRY_BACKOFF_S": "0.05",
    "ARKS_ROUTER_SKETCH": "1",
    "ARKS_ROUTER_SKETCH_POLL_S": "2.0",
    "ARKS_ROUTER_SKETCH_STALE_S": "10",
    "ARKS_ROUTER_SKETCH_T0_WEIGHT": "1.0",
    "ARKS_ROUTER_SKETCH_DISK_WEIGHT": "0.5",
    "ARKS_ROUTER_SKETCH_MAX_BLOCKS": "64",
    "ARKS_ELASTIC_JOIN_TIMEOUT_S": "10",
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
    # The gang a local driver launches a server into (control/workloads.py
    # sets them; the server serves gangs of one process only).
    "ARKS_GANG_SIZE": None,
    "ARKS_NUM_PROCESSES": "1",
    # The operator: the reference's Orbax conversion switch, which the
    # port's model controller refuses (control/model_controller.py), and
    # the default images of the GPU runtimes it only renders
    # (control/workloads.py).
    "ARKS_CONVERT_ORBAX": "0",
    "ARKS_RUNTIME_DEFAULT_VLLM_IMAGE": None,
    "ARKS_RUNTIME_DEFAULT_SGLANG_IMAGE": None,
    "ARKS_RUNTIME_DEFAULT_DYNAMO_IMAGE": None,
    # The autoscaler's signals mode (control/autoscaler.py).
    "ARKS_ELASTIC_COOLDOWN_S": "30",
    "ARKS_ELASTIC_BURN_HI": "1.0",
    "ARKS_ELASTIC_BURN_LO": "0.25",
    "ARKS_ELASTIC_SAT_HI": "0.9",
    "ARKS_ELASTIC_SAT_LO": "0.3",
    # The gateway (gateway/server.py) and its native library
    # (gateway/native.py): off, or a prebuilt one in place of the build.
    "ARKS_NATIVE": "1",
    "ARKS_NATIVE_LIB": None,
    "ARKS_GW_COLD_START_WAIT_S": "10",
    "ARKS_GW_SHED_INFLIGHT": "0",
    "ARKS_GW_DISCONNECT_DRAIN_S": "10",
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


def get_list(name: str) -> list[str]:
    """Comma-separated setting as a list of its non-empty items."""
    return [x.strip() for x in (raw(name) or "").split(",") if x.strip()]


def get_bool(name: str) -> bool:
    """"0", "false" and "" read False, anything else True (the
    reference's rule)."""
    v = os.environ.get(name, raw(name))
    return v is not None and v.strip().lower() not in ("", "0", "false")
