"""Tenant identity, fair-share weights, and bounded tenant metric labels.

The gateway already knows WHO a request belongs to (TokenQos carries the
namespace and username the Bearer token resolved to), but until the
tenant-fair admission work that identity died at the gateway: the engine
queue was tenant-blind, so one key's burst starved every other key in
the same SLO tier.  This module is the shared, jax-free vocabulary the
whole path speaks:

- ``HDR_TENANT`` — the ``x-arks-tenant`` header the gateway mints from
  ``TokenQos.namespace/username``, the router forwards verbatim, and the
  OpenAI server maps onto ``Request.tenant``.  Requests arriving without
  it (direct-to-pod clients, tests) fall into ``DEFAULT_TENANT`` — with
  a single tenant the weighted-fair queue degenerates to exactly the old
  tier-FIFO order, so nothing changes for untenanted deployments.
- ``ARKS_FAIR_WEIGHTS`` — ``tenant:weight`` pairs giving a tenant a
  larger (or smaller) share of each admission round; unlisted tenants
  weigh 1.  The same weights drive the engine's deficit round-robin and
  the gateway's edge shedding (most-over-share tenant rejected first).
- ``TenantLabels`` — the metric-label cardinality bound: tenant ids are
  unbounded user input (key churn mints new namespace/username pairs
  forever), so the first ``ARKS_TENANT_LABEL_MAX`` distinct tenants keep
  their own label and everyone later lands in ``OTHER_LABEL``.  Counters
  stay accurate in aggregate; dashboards stay scrapeable.

A copy of ``arks_tpu/tenancy.py`` with the port's own settings reader;
stdlib only, like ``arks_tpu_torch.slo``.
"""

from __future__ import annotations

import threading

from arks_tpu_torch import knobs

HDR_TENANT = "x-arks-tenant"
# Queue-saturation signal (0.00-1.00 of ARKS_QUEUE_MAX, "inf"-safe):
# rides /readiness and shed (429/503) responses so edges can back off
# BEFORE the engine queue absorbs a flood.
HDR_SATURATION = "x-arks-saturation"

DEFAULT_TENANT = "default"
OTHER_LABEL = "other"

WEIGHTS_ENV = "ARKS_FAIR_WEIGHTS"


def tenant_id(namespace: str, username: str) -> str:
    """The canonical tenant identity: one billing principal, matching the
    rate-limit/quota key granularity the gateway already enforces."""
    return f"{namespace}/{username}"


def parse_weights(spec: str) -> dict[str, float]:
    """Parse ``tenant:weight,...``.  Raises ValueError on malformed
    entries or non-positive weights (weight 0 would starve the tenant
    forever — use quota, not fairness, to cut someone off)."""
    weights: dict[str, float] = {}
    for entry in (s for s in spec.split(",") if s.strip()):
        name, sep, val = entry.strip().rpartition(":")
        if not sep or not name:
            raise ValueError(
                f"{WEIGHTS_ENV}: bad entry {entry!r} (want tenant:weight)")
        try:
            w = float(val)
        except ValueError:
            raise ValueError(
                f"{WEIGHTS_ENV}: non-numeric weight in {entry!r}") from None
        if w <= 0:
            raise ValueError(
                f"{WEIGHTS_ENV}: weight must be > 0 in {entry!r}")
        weights[name] = w
    return weights


def weights_from_env() -> dict[str, float]:
    spec = knobs.get_str(WEIGHTS_ENV, fallback="") or ""
    return parse_weights(spec) if spec.strip() else {}


def weight_of(weights: dict[str, float], tenant: str) -> float:
    return weights.get(tenant, 1.0)


class TenantLabels:
    """First-K-tenants bounded label mapper (thread-safe).  The K slots
    go to the first K distinct tenants seen — under normal operation the
    stable, high-volume tenants — and every later arrival shares the
    ``other`` bucket, so hostile key churn cannot mint unbounded metric
    series.  ``tests/test_torch_metrics.py`` holds the bound."""

    def __init__(self, cap: int | None = None) -> None:
        if cap is None:
            cap = knobs.get_int("ARKS_TENANT_LABEL_MAX")
        if cap < 1:
            raise ValueError(
                f"ARKS_TENANT_LABEL_MAX={cap}: must be >= 1")
        self.cap = cap
        self._lock = threading.Lock()
        self._known: set[str] = set()

    def label(self, tenant: str | None) -> str:
        t = tenant or DEFAULT_TENANT
        with self._lock:
            if t in self._known:
                return t
            if len(self._known) < self.cap:
                self._known.add(t)
                return t
        return OTHER_LABEL
