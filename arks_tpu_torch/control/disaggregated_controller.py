"""DisaggregatedApplication controller: prefill/decode-separated serving (a
copy of ``arks_tpu/control/disaggregated_controller.py`` that deploys the
port).

Mirrors the reference ArksDisaggregatedApplicationReconciler
(internal/controller/arksdisaggregatedapplication_controller.go):

- same phase machine as the standalone controller (:208-216 precheck,
  Pending -> Checking -> Loading -> Creating -> Running | Failed)
- three workloads per app: router + prefill gang + decode gang
  (legacy-mode layout ``<name>-prefill`` / ``<name>-decode`` + router
  deployment :284-391; the router Service is ``<name>-router-svc`` :739-770)
- per-component status {replicas, readyReplicas} synced back (:393-497)

The port's runtime is ``torch`` (the default): the tiers run ``python -m
arks_tpu_torch.server --disaggregation-mode prefill|decode`` with
``--device local_device`` (``cpu`` in tests; unset, the server's own
default, the CUDA device), and the router gang ``python -m
arks_tpu_torch.router --discovery-file ...``.  The controller maintains the
discovery JSON file (the ready prefill/decode addresses); the router
re-reads it on mtime change.

The precheck refuses, besides the reference's invalid specs:
``runtime: jax`` (``InvalidRuntime``); a TPU accelerator and a tier with
``tensorParallel`` or ``contextParallel`` above 1 (``InvalidSpec``: the
port's server runs one device per process, ``ROADMAP.md`` queue 1 item 7).
``router_discovery="kubernetes"`` (routers that find their pods by label
selector) needs the Kubernetes client, queue 1 item 5.3, and raises.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import tempfile
import threading
from typing import Iterable

from arks_tpu_torch.control.k8s_export import (
    try_shape, validate_dapp_mode, validate_instance_spec,
    validate_pod_group_policy,
)
from arks_tpu_torch.control.reconciler import Controller, Result
from arks_tpu_torch.control.resources import (
    COND_LOADED, COND_PRECHECK, COND_READY, LABEL_APPLICATION,
    LABEL_MANAGED_BY, LABEL_MODEL, LABEL_ROLE, MANAGED_BY, MODEL_PHASE_READY,
    PHASE_CHECKING, PHASE_CREATING, PHASE_FAILED, PHASE_LOADING,
    PHASE_PENDING, PHASE_RUNNING, RESERVED_MODELS_PATH, RUNTIME_TORCH,
    DisaggregatedApplication, GangSet, Model, Service,
)
from arks_tpu_torch.control.store import NotFound, Store
from arks_tpu_torch.control.workloads import (
    default_runtime_image, torch_serve_command,
)

log = logging.getLogger("arks_tpu_torch.control.disaggregated")

COMPONENTS = ("router", "prefill", "decode")


def component_name(app: DisaggregatedApplication, component: str) -> str:
    # reference naming: <name>-prefill / <name>-decode (:284-391)
    return f"{app.name}-{component}"


def router_service_name(app: DisaggregatedApplication) -> str:
    # reference: <name>-router-svc (:739-770)
    return f"{app.name}-router-svc"


def _tier(app: DisaggregatedApplication, tier: str) -> dict:
    """A tier's settings over the app-wide ones (the reference's lookup)."""
    return {**app.spec, **(app.spec.get(tier) or {})}


def _check_parallel(app: DisaggregatedApplication) -> None:
    """Refuse a tier the port's server would refuse at launch: it runs one
    device per process (``--tensor-parallel-size`` and
    ``--context-parallel-size`` above 1 raise there)."""
    for tier in ("prefill", "decode"):
        ws = _tier(app, tier)
        for key in ("tensorParallel", "contextParallel"):
            n = ws.get(key, 1)
            if n != 1:
                raise ValueError(
                    f"{tier}.{key}={n}: the port's server runs one device "
                    "per process; tensor and context parallelism are not "
                    "ported yet (ROADMAP.md queue 1 item 7)")


class DisaggregatedApplicationController(Controller):
    KIND = DisaggregatedApplication
    FINALIZER = "disaggregatedapplication.arks.ai/controller"

    def __init__(self, store: Store, workers: int = 4,
                 local_device: str | None = None,
                 discovery_dir: str | None = None,
                 router_discovery: str = "file"):
        if router_discovery == "kubernetes":
            raise NotImplementedError(
                "router_discovery='kubernetes' (the router's "
                "--service-discovery) needs the Kubernetes client, which "
                "the port does not have yet (ROADMAP.md queue 1 item 5.3)")
        if router_discovery != "file":
            raise ValueError(f"router_discovery={router_discovery!r}")
        super().__init__(store, workers=workers)
        # Forced device of locally-driven gangs (tests: "cpu"); None leaves
        # the server's own default, the CUDA device.
        self.local_device = local_device
        # The operator maintains a discovery JSON on a filesystem it shares
        # with the router (local single-binary mode).
        self.discovery_dir = discovery_dir or os.path.join(
            tempfile.gettempdir(), "arks-tpu-torch-discovery")
        os.makedirs(self.discovery_dir, exist_ok=True)

    def watches(self) -> Iterable:
        def apps_for_model(model) -> list[tuple[str, str]]:
            return [a.key for a in self.store.list(
                DisaggregatedApplication, namespace=model.namespace)
                if a.spec.get("model", {}).get("name") == model.name]

        def app_for_gangset(gs) -> list[tuple[str, str]]:
            for kind, name in gs.owner_refs:
                if kind == DisaggregatedApplication.KIND:
                    return [(gs.namespace, name)]
            return []

        return [(Model, apps_for_model), (GangSet, app_for_gangset)]

    # ------------------------------------------------------------------

    def reconcile(self, app: DisaggregatedApplication) -> Result | None:
        status_before = app.deepcopy().status

        if not app.status.get("phase"):
            app.status["phase"] = PHASE_PENDING

        # --- precheck: only the native runtime supports PD separation
        # (the reference only supports sglang there, :208-216). ---
        runtime = app.spec.get("runtime", RUNTIME_TORCH)
        if runtime != RUNTIME_TORCH:
            app.set_condition(COND_PRECHECK, False, "InvalidRuntime",
                              f"disaggregated serving requires runtime "
                              f"{RUNTIME_TORCH!r}, got {runtime!r}")
            app.status["phase"] = PHASE_FAILED
            self._sync(app, status_before)
            return None
        try:
            validate_dapp_mode(app.spec.get("mode", "legacy"))
            validate_pod_group_policy(app.spec.get("podGroupPolicy"))
            for section in ("prefill", "decode", "router"):
                validate_instance_spec(
                    (app.spec.get(section) or {}).get("instanceSpec"))
            for tier in ("prefill", "decode"):
                try_shape(_tier(app, tier).get("accelerator"))
            _check_parallel(app)
        except ValueError as e:
            app.set_condition(COND_PRECHECK, False, "InvalidSpec", str(e))
            app.status["phase"] = PHASE_FAILED
            self._sync(app, status_before)
            return None
        app.set_condition(COND_PRECHECK, True, "PrecheckPassed", "")
        if app.status["phase"] == PHASE_PENDING:
            app.status["phase"] = PHASE_CHECKING

        # --- model gate ---
        model_name = app.spec.get("model", {}).get("name")
        if not model_name:
            app.set_condition(COND_PRECHECK, False, "NoModel",
                              "spec.model.name required")
            app.status["phase"] = PHASE_FAILED
            self._sync(app, status_before)
            return None
        model = self.store.try_get(Model, model_name, app.namespace)
        if model is None or model.phase != MODEL_PHASE_READY:
            app.set_condition(COND_LOADED, False, "ModelNotReady",
                              f"model {model_name} not ready")
            app.status["phase"] = PHASE_LOADING
            self._sync(app, status_before)
            return Result(requeue_after=1.0)
        app.set_condition(COND_LOADED, True, "ModelReady", "")
        if app.status["phase"] in (PHASE_CHECKING, PHASE_LOADING):
            app.status["phase"] = PHASE_CREATING

        # --- workloads: prefill + decode gangs, then router ---
        statuses: dict[str, dict] = {}
        for component in ("prefill", "decode"):
            self._ensure_gangset(
                app, model, component,
                self._worker_spec(app, model, component))
            gs = self.store.try_get(
                GangSet, component_name(app, component), app.namespace)
            statuses[component] = gs.status if gs else {}

        # Discovery file BEFORE the router so it starts with addresses.
        self._write_discovery(app, statuses)
        self._ensure_gangset(app, model, "router", self._router_spec(app))
        gs = self.store.try_get(GangSet, component_name(app, "router"),
                                app.namespace)
        statuses["router"] = gs.status if gs else {}

        self._ensure_router_service(app)

        # --- status sync (:393-497) ---
        for component in COMPONENTS:
            st = statuses[component]
            app.status[component] = {
                "replicas": st.get("replicas", 0),
                "readyReplicas": st.get("readyReplicas", 0),
            }
        if app.ready():
            app.status["phase"] = PHASE_RUNNING
            app.set_condition(COND_READY, True, "AllComponentsReady", "")
        else:
            waiting = ", ".join(
                f"{c}={app.status[c]['readyReplicas']}/"
                f"{app.spec.get(c, {}).get('replicas', 1)}"
                for c in COMPONENTS)
            app.set_condition(COND_READY, False, "WaitingForComponents", waiting)
            if app.status["phase"] == PHASE_RUNNING:
                app.status["phase"] = PHASE_CREATING

        self._sync(app, status_before)
        self._sync_router_addresses(app, statuses["router"])
        return None

    # ------------------------------------------------------------------
    # Spec generation
    # ------------------------------------------------------------------

    def _worker_spec(self, app: DisaggregatedApplication, model: Model,
                     component: str) -> dict:
        ws = app.spec.get(component, {})
        tp = ws.get("tensorParallel", app.spec.get("tensorParallel", 1))
        size = ws.get("size") or 1
        served = app.served_model_name or model.name
        common = list(ws.get("runtimeCommonArgs",
                             app.spec.get("runtimeCommonArgs", [])))
        common += ["--disaggregation-mode", component]
        model_path = model.status.get("path", RESERVED_MODELS_PATH)
        model_arg = app.spec.get("modelConfig") or model_path
        cmd = torch_serve_command(
            model_arg=model_arg, served_model_name=served,
            port_token="$(PORT)", tensor_parallel=tp, size=size,
            common_args=common, model_path=model_path,
            device=self.local_device,
            context_parallel=ws.get("contextParallel",
                                    app.spec.get("contextParallel", 1)))
        return {
            "replicas": ws.get("replicas", 1),
            "size": size,
            "leader": {"command": cmd, "env": {}},
            "worker": {"command": cmd, "env": {}},
            "ports": {"http": 8080},
            "restartPolicy": "RecreateGroupOnPodRestart",
            "runtime": RUNTIME_TORCH,
            "role": component,
            # K8s-driver fields — see application_controller.
            "image": ws.get("runtimeImage")
            or app.spec.get("runtimeImage")
            or default_runtime_image(RUNTIME_TORCH),
            "accelerator": ws.get("accelerator",
                                  app.spec.get("accelerator", "cpu")),
            "modelPvc": (model.spec.get("storage") or {}).get("pvc")
            or "models",  # shared operator claim (see application_controller)
            **({"instanceSpec": ws["instanceSpec"]}
               if ws.get("instanceSpec") else {}),
            **({"podGroupPolicy": app.spec["podGroupPolicy"]}
               if app.spec.get("podGroupPolicy") else {}),
            **({"podGroupUnit": unit}
               if (unit := self._pod_group_unit(app)) else {}),
        }

    def _router_spec(self, app: DisaggregatedApplication) -> dict:
        rs = app.spec.get("router", {})
        served = app.served_model_name or app.spec.get("model", {}).get("name", "")
        cmd = [sys.executable, "-m", "arks_tpu_torch.router",
               "--port", "$(PORT)",
               "--served-model-name", served,
               "--discovery-file", self._discovery_path(app),
               # RouterArgs passthrough (reference:
               # arksdisaggregatedapplication_types.go:69-84).
               *[str(a) for a in rs.get("routerArgs", [])]]
        return {
            "replicas": rs.get("replicas", 1),
            "size": 1,
            "leader": {"command": cmd, "env": {}},
            "worker": {"command": cmd, "env": {}},
            "ports": {"http": 8080},
            "restartPolicy": "RecreateGroupOnPodRestart",
            "runtime": "router",
            "role": "router",
            "image": rs.get("runtimeImage")
            or app.spec.get("runtimeImage")
            or default_runtime_image(RUNTIME_TORCH),
            "accelerator": "cpu",
            **({"instanceSpec": rs["instanceSpec"]}
               if rs.get("instanceSpec") else {}),
            # Unified layout: the router (scheduler role) joins the unit
            # PodGroup too (reference unified RBGS :1316-1320).
            **({"podGroupPolicy": app.spec["podGroupPolicy"],
                "podGroupUnit": unit}
               if (unit := self._pod_group_unit(app)) else {}),
        }

    def _pod_group_unit(self, app: DisaggregatedApplication) -> dict | None:
        """Unified layout: ONE PodGroup spans every router/prefill/decode
        pod (minMember = the whole PD unit), so a unit schedules atomically
        — the GangSet carries it for a K8s driver.  A tier's gang is
        ``size`` pods (default 1: the port derives no gang from a TPU
        topology)."""
        if (app.spec.get("mode", "legacy") != "unified"
                or not app.spec.get("podGroupPolicy")):
            return None
        total = (app.spec.get("router") or {}).get("replicas", 1)
        for tier in ("prefill", "decode"):
            ws = _tier(app, tier)
            total += ws.get("replicas", 1) * (ws.get("size") or 1)
        return {"name": f"arks-{app.name}", "minMember": total}

    def _ensure_gangset(self, app: DisaggregatedApplication, model: Model,
                        component: str, spec: dict) -> None:
        name = component_name(app, component)
        existing = self.store.try_get(GangSet, name, app.namespace)
        if existing is None:
            gs = GangSet(name=name, namespace=app.namespace,
                         labels={LABEL_MANAGED_BY: MANAGED_BY,
                                 LABEL_APPLICATION: app.name,
                                 LABEL_MODEL: model.name if model else "",
                                 LABEL_ROLE: component},
                         owner_refs=[(DisaggregatedApplication.KIND, app.name)],
                         spec=spec)
            self.store.create(gs)
        elif existing.spec != spec:
            existing.spec = spec
            self.store.update(existing)

    # ------------------------------------------------------------------
    # Discovery + service
    # ------------------------------------------------------------------

    def _discovery_path(self, app: DisaggregatedApplication) -> str:
        return os.path.join(self.discovery_dir,
                            f"{app.namespace}-{app.name}.json")

    def _write_discovery(self, app: DisaggregatedApplication,
                         statuses: dict[str, dict]) -> None:
        data = {}
        for component in ("prefill", "decode"):
            data[component] = [
                g["leaderAddr"] for g in
                statuses.get(component, {}).get("groups", [])
                if g.get("phase") == "Running" and g.get("leaderAddr")]
        path = self._discovery_path(app)
        try:
            with open(path) as f:
                if json.load(f) == data:
                    return  # unchanged; don't bump mtime
        except (OSError, ValueError, json.JSONDecodeError):
            pass
        # A temporary name of this thread's own: two workers may reconcile
        # one app at once (the work queue hands a key to the next worker
        # while another still holds it), and a shared name let one rename
        # the other's file away (the reference's ``path + ".tmp"``).
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, path)

    def _ensure_router_service(self, app: DisaggregatedApplication) -> None:
        name = router_service_name(app)
        if self.store.try_get(Service, name, app.namespace) is None:
            svc = Service(
                name=name, namespace=app.namespace,
                labels={LABEL_MANAGED_BY: MANAGED_BY,
                        LABEL_APPLICATION: app.name,
                        "prometheus-discovery": "true"},
                owner_refs=[(DisaggregatedApplication.KIND, app.name)],
                spec={"selector": {LABEL_APPLICATION: app.name,
                                   LABEL_ROLE: "router"},
                      "port": 8080})
            self.store.create(svc)

    def _sync_router_addresses(self, app: DisaggregatedApplication,
                               router_status: dict) -> None:
        svc = self.store.try_get(Service, router_service_name(app),
                                 app.namespace)
        if svc is None:
            return
        addrs = [g["leaderAddr"] for g in router_status.get("groups", [])
                 if g.get("phase") == "Running" and g.get("leaderAddr")]
        if svc.status.get("addresses") != addrs:
            svc.status["addresses"] = addrs
            self.store.update_status(svc)

    def _sync(self, app: DisaggregatedApplication, before: dict) -> None:
        if app.status != before:
            self.store.update_status(app)

    def finalize(self, app: DisaggregatedApplication) -> None:
        for component in COMPONENTS:
            try:
                self.store.delete(GangSet, component_name(app, component),
                                  app.namespace)
            except NotFound:
                pass
        try:
            self.store.delete(Service, router_service_name(app), app.namespace)
        except NotFound:
            pass
        try:
            os.remove(self._discovery_path(app))
        except OSError:
            pass
