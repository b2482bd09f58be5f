"""Application controller: the workload-layer phase machine (a copy of
``arks_tpu/control/application_controller.py`` that deploys the port).

Mirrors the reference ArksApplicationReconciler (internal/
controller/arksapplication_controller.go):

- phases Pending -> Checking -> Loading -> Creating -> Running | Failed with
  conditions Precheck / Loaded / Ready (:211-219, :1165-1190)
- precheck validates the runtime (:236-264)
- gates on the referenced Model reaching Ready (:266-296), woken by a Model
  watch fan-out (requestsForModel :1063-1088)
- generates the gang workload (generateLws/generateRBGS :509-889 — here a
  GangSet with the serve commands) and a stable Service
  ``arks-application-<name>`` on the leader port (:376-415)
- syncs replica status back from the workload (:424-503), woken by a GangSet
  ownership watch (:146-148)

The native runtime is ``torch`` (the default): ``python -m
arks_tpu_torch.server`` with the reference's flags and ``--device
local_device`` (``cpu`` in tests; unset, the server's own default, the
CUDA device, which raises without a GPU).  A gang's size is
``spec.size`` (default 1); a TPU ``accelerator`` fails the precheck
(``InvalidSpec``), as does ``runtime: jax`` (``InvalidRuntime``).
"""

from __future__ import annotations

import logging
from typing import Iterable

from arks_tpu_torch.control.reconciler import Controller, Result
from arks_tpu_torch.control.resources import (
    COND_LOADED, COND_PRECHECK, COND_READY, LABEL_APPLICATION,
    LABEL_MANAGED_BY, LABEL_MODEL, LABEL_ROLE, MANAGED_BY, MODEL_PHASE_READY,
    PHASE_CHECKING, PHASE_CREATING, PHASE_FAILED, PHASE_LOADING,
    PHASE_PENDING, PHASE_RUNNING, RESERVED_MODELS_PATH, RUNTIME_TORCH,
    VALID_RUNTIMES, Application, GangSet, Model, Service,
)
from arks_tpu_torch.control.store import NotFound, Store
from arks_tpu_torch.control.k8s_export import (
    try_shape, validate_instance_spec, validate_pod_group_policy,
)
from arks_tpu_torch.control.workloads import (
    default_runtime_image, gpu_runtime_command, torch_serve_command,
)

log = logging.getLogger("arks_tpu_torch.control.application")


def workload_name(app: Application) -> str:
    return app.name


def service_name(app: Application) -> str:
    # reference: "arks-application-<name>" (:376-415)
    return f"arks-application-{app.name}"


class ApplicationController(Controller):
    KIND = Application
    FINALIZER = "application.arks.ai/controller"

    def __init__(self, store: Store, workers: int = 4,
                 local_device: str | None = None):
        super().__init__(store, workers=workers)
        # Forced device of locally-driven gangs (tests: "cpu"); None leaves
        # the server's own default, the CUDA device.
        self.local_device = local_device

    def watches(self) -> Iterable:
        def apps_for_model(model) -> list[tuple[str, str]]:
            # requestsForModel fan-out (:1063-1088)
            return [a.key for a in self.store.list(
                Application, namespace=model.namespace)
                if a.spec.get("model", {}).get("name") == model.name]

        def app_for_gangset(gs) -> list[tuple[str, str]]:
            for kind, name in gs.owner_refs:
                if kind == Application.KIND:
                    return [(gs.namespace, name)]
            return []

        return [(Model, apps_for_model), (GangSet, app_for_gangset)]

    # ------------------------------------------------------------------

    def reconcile(self, app: Application) -> Result | None:
        status_before = app.deepcopy().status

        if not app.status.get("phase"):
            app.status["phase"] = PHASE_PENDING

        # --- precheck (:236-264) ---
        runtime = app.spec.get("runtime", RUNTIME_TORCH)
        if runtime not in VALID_RUNTIMES:
            app.set_condition(COND_PRECHECK, False, "InvalidRuntime",
                              f"runtime {runtime!r} not in {VALID_RUNTIMES}")
            app.status["phase"] = PHASE_FAILED
            self._sync(app, status_before)
            return None
        if app.spec.get("replicas", 1) < 0 or app.spec.get("size", 1) < 1:
            app.set_condition(COND_PRECHECK, False, "InvalidSpec",
                              "replicas must be >= 0 and size >= 1")
            app.status["phase"] = PHASE_FAILED
            self._sync(app, status_before)
            return None
        # Reserved-name + pod-group validation (reference precheck :236-264
        # rejects the reserved 'models' volume; PodGroupPolicy is one-of),
        # and the port's refusal of TPU topologies.
        try:
            validate_instance_spec(app.spec.get("instanceSpec"))
            validate_pod_group_policy(app.spec.get("podGroupPolicy"))
            try_shape(app.spec.get("accelerator"))
        except ValueError as e:
            app.set_condition(COND_PRECHECK, False, "InvalidSpec", str(e))
            app.status["phase"] = PHASE_FAILED
            self._sync(app, status_before)
            return None
        app.set_condition(COND_PRECHECK, True, "PrecheckPassed", "")
        if app.status["phase"] == PHASE_PENDING:
            app.status["phase"] = PHASE_CHECKING

        # --- model gate (:266-296) ---
        model_name = app.spec.get("model", {}).get("name")
        if not model_name:
            app.set_condition(COND_PRECHECK, False, "NoModel", "spec.model.name required")
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

        # --- workload + service (:303-415) ---
        self._ensure_gangset(app, model)
        self._ensure_service(app)

        # --- status sync (:424-503) ---
        gs = self.store.try_get(GangSet, workload_name(app), app.namespace)
        st = gs.status if gs else {}
        app.status["replicas"] = st.get("replicas", 0)
        app.status["readyReplicas"] = st.get("readyReplicas", 0)
        want = app.spec.get("replicas", 1)
        if want > 0 and app.status["readyReplicas"] >= want:
            app.status["phase"] = PHASE_RUNNING
            app.set_condition(COND_READY, True, "AllReplicasReady", "")
        else:
            app.set_condition(COND_READY, False, "WaitingForReplicas",
                              f"{app.status['readyReplicas']}/{want} ready")
            if app.status["phase"] == PHASE_RUNNING:
                app.status["phase"] = PHASE_CREATING

        self._sync(app, status_before)
        # Keep the service address list fresh against gang churn.
        self._sync_service_addresses(app, st)
        return None

    # ------------------------------------------------------------------

    def _ensure_gangset(self, app: Application, model: Model) -> None:
        spec = self._generate_gangset_spec(app, model)
        name = workload_name(app)
        existing = self.store.try_get(GangSet, name, app.namespace)
        if existing is None:
            gs = GangSet(name=name, namespace=app.namespace,
                         labels={LABEL_MANAGED_BY: MANAGED_BY,
                                 LABEL_APPLICATION: app.name,
                                 LABEL_MODEL: model.name},
                         owner_refs=[(Application.KIND, app.name)],
                         spec=spec)
            self.store.create(gs)
        elif existing.spec != spec:
            # CreateOrPatch-style rolling update (:303-341).
            existing.spec = spec
            self.store.update(existing)

    def _generate_gangset_spec(self, app: Application, model: Model) -> dict:
        runtime = app.spec.get("runtime", RUNTIME_TORCH)
        tp = app.spec.get("tensorParallel", 1)
        size = app.spec.get("size") or 1
        served = app.served_model_name or model.name
        common = list(app.spec.get("runtimeCommonArgs", []))
        model_path = model.status.get("path", RESERVED_MODELS_PATH)
        if runtime == RUNTIME_TORCH:
            model_arg = app.spec.get("modelConfig") or model_path
            leader_cmd = torch_serve_command(
                model_arg=model_arg, served_model_name=served,
                port_token="$(PORT)", tensor_parallel=tp, size=size,
                common_args=common, model_path=model_path,
                device=self.local_device,
                context_parallel=app.spec.get("contextParallel", 1))
        else:
            leader_cmd = gpu_runtime_command(
                runtime, model_path, served, tp, size, common)
        return {
            "replicas": app.spec.get("replicas", 1),
            "size": size,
            "leader": {"command": leader_cmd, "env": {}},
            "worker": {"command": leader_cmd, "env": {}},
            "ports": {"http": 8080},
            "restartPolicy": "RecreateGroupOnPodRestart",
            "runtime": runtime,
            # Consumed by a K8s driver: pod image, node selection, and the
            # models-PVC mount.  Local drivers ignore these.  The PVC
            # default is the SHARED "models" claim the operator itself
            # downloads into — nothing provisions per-model PVCs, so engine
            # pods must mount the volume the weights actually landed on.
            "image": app.spec.get("runtimeImage") or default_runtime_image(runtime),
            "accelerator": app.spec.get("accelerator", "cpu"),
            "modelPvc": (model.spec.get("storage") or {}).get("pvc")
            or "models",
            # Pod-spec passthrough + gang scheduling, consumed by the K8s
            # renderer (reference: InstanceSpec arksapplication_types.go:
            # 80-250, PodGroupPolicy utils.go:9-26).
            **({"instanceSpec": app.spec["instanceSpec"]}
               if app.spec.get("instanceSpec") else {}),
            **({"podGroupPolicy": app.spec["podGroupPolicy"]}
               if app.spec.get("podGroupPolicy") else {}),
        }

    def _ensure_service(self, app: Application) -> None:
        name = service_name(app)
        if self.store.try_get(Service, name, app.namespace) is None:
            svc = Service(
                name=name, namespace=app.namespace,
                labels={LABEL_MANAGED_BY: MANAGED_BY,
                        LABEL_APPLICATION: app.name,
                        # prometheus-discovery selector parity (:388-391)
                        "prometheus-discovery": "true"},
                owner_refs=[(Application.KIND, app.name)],
                spec={"selector": {LABEL_APPLICATION: app.name,
                                   LABEL_ROLE: "leader"},
                      "port": 8080})
            self.store.create(svc)

    def _sync_service_addresses(self, app: Application, gang_status: dict) -> None:
        svc = self.store.try_get(Service, service_name(app), app.namespace)
        if svc is None:
            return
        addrs = [g["leaderAddr"] for g in gang_status.get("groups", [])
                 if g.get("phase") == "Running" and g.get("leaderAddr")]
        if svc.status.get("addresses") != addrs:
            svc.status["addresses"] = addrs
            self.store.update_status(svc)

    def _sync(self, app: Application, before: dict) -> None:
        if app.status != before:
            self.store.update_status(app)

    def finalize(self, app: Application) -> None:
        # Owned GangSet/Service are cascade-deleted by the store GC; the
        # GangSet finalizer tears down its processes.
        for kind, name in ((GangSet, workload_name(app)),
                           (Service, service_name(app))):
            try:
                self.store.delete(kind, name, app.namespace)
            except NotFound:
                pass
