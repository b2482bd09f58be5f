"""Gateway and router Prometheus metrics — same families as the reference
(pkg/gateway/metrics/metrics.go:24-132); a copy of
``arks_tpu/gateway/metrics.py``."""

from __future__ import annotations

from arks_tpu_torch.utils import metrics as prom


class GatewayMetrics:
    def __init__(self, registry: prom.Registry | None = None):
        self.registry = registry or prom.Registry()
        r = self.registry
        self.requests_total = r.counter(
            "gateway_requests_total", "Requests by namespace/user/model/status")
        self.request_duration = r.histogram(
            "gateway_request_duration_seconds", "End-to-end request duration",
            buckets=[0.1, 0.25, 0.5, 1, 2.5, 5, 10, 20, 30, 60])
        self.response_process_duration = r.histogram(
            "gateway_response_process_duration_milliseconds",
            "Gateway-side processing time",
            buckets=[1, 5, 10, 25, 50, 100, 250, 500, 1000, 5000])
        self.token_usage = r.counter(
            "gateway_token_usage_total", "Token usage by type")
        self.token_distribution = r.histogram(
            "gateway_token_distribution", "Per-request total tokens",
            buckets=[2 ** i for i in range(0, 17)])
        self.rate_limit_hits_total = r.counter(
            "gateway_rate_limit_hits_total", "Rate-limit rejections by rule")
        self.rate_limit_tokens = r.counter(
            "gateway_rate_limit_tokens_total",
            "Tokens counted toward rate limits")
        self.quota_usage = r.gauge("gateway_quota_usage", "Quota used")
        self.quota_limit = r.gauge("gateway_quota_limit", "Quota limit")
        self.errors_total = r.counter(
            "gateway_errors_total", "Gateway errors by stage")
        self.shed_total = r.counter(
            "gateway_shed_total",
            "Requests shed at the edge by bounded tenant label and reason "
            "(inflight_overshare = gateway at ARKS_GW_SHED_INFLIGHT and the "
            "tenant at/over its weighted fair share)")
        self.client_disconnects_total = r.counter(
            "gateway_client_disconnects_total",
            "Streaming responses whose client hung up before the stream "
            "finished (the gateway drains the backend to meter usage)")
        self.usage_unmetered_total = r.counter(
            "gateway_usage_unmetered_total",
            "Disconnected streams abandoned before the usage frame arrived "
            "(ARKS_GW_DISCONNECT_DRAIN_S exceeded) — billed-but-unmetered "
            "tokens; should be ~0")


class RouterMetrics:
    """Routing-layer families (the router is part of the same data-plane
    metrics surface as the gateway).  Besides the request/backend basics,
    this carries the sketch-routing observability set: per-backend sketch
    age, route decisions by reason, and the expected-vs-actual hit-depth
    pair that makes a mis-scoring sketch visible in monitoring."""

    def __init__(self, registry: prom.Registry | None = None):
        self.registry = registry or prom.Registry()
        r = self.registry
        self.requests_total = r.counter(
            "router_requests_total", "Routed requests")
        self.backends = r.gauge("router_backends", "Known backends")
        self.retries_total = r.counter(
            "router_retries_total",
            "Requests retried on another backend (by reason)")
        self.sketch_age = r.gauge(
            "router_sketch_age_seconds",
            "Seconds since each backend's sketch was last accepted")
        self.route_decisions_total = r.counter(
            "router_route_decisions_total",
            "Routing decisions by reason "
            '(sketch_hit|tie_fallback|stale_sketch|no_key)')
        self.expected_hit_blocks_total = r.counter(
            "router_expected_hit_blocks_total",
            "Sketch-predicted prefix hit depth in blocks, by backend/tier "
            "(compare against the actual router_backend_hit_tokens)")
        self.backend_hit_tokens = r.gauge(
            "router_backend_hit_tokens",
            "Actual cumulative per-tier prefix hit tokens each backend "
            "reports in its sketch")
        self.sketch_epoch_drops_total = r.counter(
            "router_sketch_epoch_drops_total",
            "Sketches dropped because the backend's epoch changed "
            "(restart/reset)")
        self.planned_membership_total = r.counter(
            "router_planned_membership_total",
            "Planned membership changes by op (join|leave) and outcome "
            "(ok|timeout) — the elastic scale-up/down handoff path")
        self.join_seconds = r.gauge(
            "router_join_seconds",
            "Duration of the last planned join per backend: readiness "
            "polling + sketch prime, before first traffic was routed")
