"""Endpoint controller: service discovery -> routing table (a copy of
``arks_tpu/control/endpoint_controller.py``).

Mirrors the reference ArksEndpointReconciler (internal/
controller/arksendpoint_controller.go):

- finds Applications + DisaggregatedApplications whose servedModelName
  (fallback: model name) equals the endpoint's name, same namespace
  (field index :51-77, list :260-281)
- static spec.routeConfigs take priority over discovered backends (:286-290)
- only *ready* apps become backends (standalone: all replicas ready :300;
  disaggregated: router+prefill+decode complete :326-333), each weighted by
  spec.defaultWeight (:293-347)
- every route carries the {namespace, model} match the gateway injects as
  headers (:349-369)
- writes status.routes (:411-414)

Instead of emitting a Gateway-API HTTPRoute for Envoy, the routing table is
written to Endpoint.status.routes and consumed directly by the arks_tpu
gateway (arks_tpu_torch.gateway) — same two-plane split, one less moving part.
"""

from __future__ import annotations

import logging
from typing import Iterable

from arks_tpu_torch.control.reconciler import Controller, Result
from arks_tpu_torch.control.resources import (
    Application, DisaggregatedApplication, Endpoint, Service,
)

log = logging.getLogger("arks_tpu_torch.control.endpoint")


class EndpointController(Controller):
    KIND = Endpoint

    def watches(self) -> Iterable:
        def endpoints_for_app(app) -> list[tuple[str, str]]:
            served = app.served_model_name
            return [(app.namespace, served)] if served else []

        def endpoints_for_service(svc) -> list[tuple[str, str]]:
            # Service address churn re-resolves routes for all endpoints in ns.
            return [e.key for e in self.store.list(Endpoint, namespace=svc.namespace)]

        return [(Application, endpoints_for_app),
                (DisaggregatedApplication, endpoints_for_app),
                (Service, endpoints_for_service)]

    def reconcile(self, ep: Endpoint) -> Result | None:
        routes: list[dict] = []

        # Static routes win (:286-290).
        for rc in ep.spec.get("routeConfigs", []):
            routes.append({
                "backend": rc["backend"],
                "weight": rc.get("weight", ep.spec.get("defaultWeight", 1)),
                "static": True,
            })

        default_weight = ep.spec.get("defaultWeight", 1)
        for app in self.store.list(Application, namespace=ep.namespace):
            # serving() (>=1 ready group), not ready() (ALL groups): during
            # a rolling update readiness dips by maxUnavailable=1 and the
            # route must survive on the remaining groups.
            if app.served_model_name != ep.name or not app.serving():
                continue
            routes.append(self._app_route(app, default_weight))
        for app in self.store.list(DisaggregatedApplication, namespace=ep.namespace):
            # serving(), not ready(), for the same rollout-survival reason.
            if app.served_model_name != ep.name or not app.serving():
                continue
            routes.append({
                "backend": {"service": f"{app.name}-router-svc",
                            "addresses": self._service_addrs(
                                f"{app.name}-router-svc", ep.namespace)},
                "weight": default_weight,
                "application": app.name,
            })

        # Route match contract: the gateway injects these as headers and the
        # router matches on them (:349-369).
        match = {"namespace": ep.namespace, "model": ep.name}
        if ep.status.get("routes") != routes or ep.status.get("match") != match:
            ep.status["routes"] = routes
            ep.status["match"] = match
            self.store.update_status(ep)
        return None

    def _app_route(self, app: Application, weight: int) -> dict:
        svc = f"arks-application-{app.name}"
        return {
            "backend": {"service": svc,
                        "addresses": self._service_addrs(svc, app.namespace)},
            "weight": weight,
            "application": app.name,
        }

    def _service_addrs(self, svc_name: str, namespace: str) -> list[str]:
        svc = self.store.try_get(Service, svc_name, namespace)
        return list(svc.status.get("addresses", [])) if svc else []
