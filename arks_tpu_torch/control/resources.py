"""Resource schemas: the six Arks resource kinds (a copy of
``arks_tpu/control/resources.py`` for the port's operator).

The same kinds, phases, conditions and label keys as the reference CRDs.
One difference: the native runtime is ``torch`` (``RUNTIME_TORCH``, the
port's own server, ``python -m arks_tpu_torch.server``) and is the default
when ``spec.runtime`` is absent.  ``jax`` is not a runtime of this
operator, which never launches the JAX package.  ``accelerator`` names a
GPU type or ``cpu``; a TPU topology name fails the precheck
(``k8s_export.try_shape``).

Resources serialize to/from plain dicts (YAML/JSON-shaped) so manifests look
and feel like the reference's CRs.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any

# Label keys (reference: api/v1/arksapplication_types.go:56-67).
LABEL_MANAGED_BY = "arks.ai/managed-by"
LABEL_APPLICATION = "arks.ai/application"
LABEL_MODEL = "arks.ai/model"
LABEL_ROLE = "arks.ai/role"
LABEL_COMPONENT = "arks.ai/component"
MANAGED_BY = "arks-tpu"

# Reserved model mount (reference: arksapplication_types.go:52-54 —
# volume "models" mounted read-only at /models in every serving pod).
RESERVED_MODELS_VOLUME = "models"
RESERVED_MODELS_PATH = "/models"

# Runtimes (reference: arksapplication_types.go:46-49 + the port's native
# "torch" in the place of the JAX package's "jax").
RUNTIME_TORCH = "torch"
RUNTIME_VLLM = "vllm"
RUNTIME_SGLANG = "sglang"
RUNTIME_DYNAMO = "dynamo"
VALID_RUNTIMES = (RUNTIME_TORCH, RUNTIME_VLLM, RUNTIME_SGLANG,
                  RUNTIME_DYNAMO)

# Application phases (reference: arksapplication_types.go:31-37).
PHASE_PENDING = "Pending"
PHASE_CHECKING = "Checking"
PHASE_LOADING = "Loading"
PHASE_CREATING = "Creating"
PHASE_RUNNING = "Running"
PHASE_FAILED = "Failed"

# Application conditions (reference: arksapplication_types.go:40-44).
COND_PRECHECK = "Precheck"
COND_LOADED = "Loaded"
COND_READY = "Ready"

# Model phases (reference: arksmodel_types.go:30-35).
MODEL_PHASE_PENDING = "Pending"
MODEL_PHASE_STORAGE_CREATING = "StorageCreating"
MODEL_PHASE_LOADING = "ModelLoading"
MODEL_PHASE_READY = "Ready"
MODEL_PHASE_FAILED = "Failed"

# Model conditions (reference: arksmodel_types.go:37-45).
COND_STORAGE_CREATED = "StorageCreated"
COND_MODEL_LOADED = "ModelLoaded"

# Rate-limit types (reference: arkstoken_types.go:28-34).
RL_RPM = "rpm"
RL_RPD = "rpd"
RL_TPM = "tpm"
RL_TPD = "tpd"
VALID_RATE_LIMITS = (RL_RPM, RL_RPD, RL_TPM, RL_TPD)

# Quota types (reference: arksquota_types.go:28-33).
QUOTA_PROMPT = "prompt"
QUOTA_RESPONSE = "response"
QUOTA_TOTAL = "total"
VALID_QUOTAS = (QUOTA_PROMPT, QUOTA_RESPONSE, QUOTA_TOTAL)


def now_iso() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


@dataclasses.dataclass
class Condition:
    type: str
    status: str            # "True" | "False" | "Unknown"
    reason: str = ""
    message: str = ""
    last_transition_time: str = dataclasses.field(default_factory=now_iso)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Resource:
    """Base: kind + metadata + spec + status (k8s object shape)."""

    name: str
    namespace: str = "default"
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    annotations: dict[str, str] = dataclasses.field(default_factory=dict)
    finalizers: list[str] = dataclasses.field(default_factory=list)
    owner_refs: list[tuple[str, str]] = dataclasses.field(default_factory=list)  # (kind, name)
    deletion_requested: bool = False
    resource_version: int = 0
    spec: dict[str, Any] = dataclasses.field(default_factory=dict)
    status: dict[str, Any] = dataclasses.field(default_factory=dict)

    KIND = "Resource"

    @property
    def key(self) -> tuple[str, str]:
        return (self.namespace, self.name)

    def deepcopy(self):
        return copy.deepcopy(self)

    # -- condition helpers (shared by all kinds, like the reference's
    #    meta.SetStatusCondition usage) --

    def set_condition(self, type_: str, status: bool, reason: str = "",
                      message: str = "") -> None:
        conds = self.status.setdefault("conditions", [])
        val = "True" if status else "False"
        for c in conds:
            if c["type"] == type_:
                if c["status"] != val or c.get("reason") != reason:
                    c.update(status=val, reason=reason, message=message,
                             last_transition_time=now_iso())
                return
        conds.append(Condition(type_, val, reason, message).to_dict())

    def condition(self, type_: str) -> bool:
        for c in self.status.get("conditions", []):
            if c["type"] == type_:
                return c["status"] == "True"
        return False

    def to_dict(self) -> dict:
        return {
            "kind": self.KIND,
            "metadata": {
                "name": self.name, "namespace": self.namespace,
                "labels": dict(self.labels), "annotations": dict(self.annotations),
                "resourceVersion": self.resource_version,
            },
            "spec": copy.deepcopy(self.spec),
            "status": copy.deepcopy(self.status),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Resource":
        md = d.get("metadata", {})
        return cls(
            name=md["name"], namespace=md.get("namespace", "default"),
            labels=dict(md.get("labels", {})),
            annotations=dict(md.get("annotations", {})),
            spec=copy.deepcopy(d.get("spec", {})),
            status=copy.deepcopy(d.get("status", {})),
        )


# ---------------------------------------------------------------------------
# The six kinds + workload/infra kinds
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Model(Resource):
    """ArksModel: model artifact = storage + download source.

    spec: {model: "Qwen/Qwen2.5-7B-Instruct",
           source: {huggingface: {tokenSecretRef: ...}} | None,
           storage: {path: ..., subPath: ...} | None,
           convertOrbax: bool}
    (reference: arksmodel_types.go:83-101; nil source = pre-existing storage,
    arksmodel_controller.go:355-358).  ``convertOrbax: true`` fails the
    Model here: Orbax imports jax.
    """

    KIND = "Model"

    @property
    def phase(self) -> str:
        return self.status.get("phase", MODEL_PHASE_PENDING)


@dataclasses.dataclass
class Application(Resource):
    """ArksApplication: standalone inference service.

    spec: {replicas: int, size: int (hosts per replica group),
           runtime: torch|vllm|sglang|dynamo, runtimeImage: str,
           model: {name: str}, servedModelName: str,
           tensorParallel: int, accelerator: str,
           runtimeCommonArgs: [str], instanceSpec: {...}}
    (reference: arksapplication_types.go:250-300)
    """

    KIND = "Application"

    @property
    def phase(self) -> str:
        return self.status.get("phase", PHASE_PENDING)

    @property
    def served_model_name(self) -> str:
        return self.spec.get("servedModelName") or self.spec.get("model", {}).get("name", "")

    def ready(self) -> bool:
        # reference readiness: Replicas == ReadyReplicas (arksendpoint_controller.go:300)
        want = self.spec.get("replicas", 1)
        return self.status.get("readyReplicas", 0) >= want and want > 0

    def serving(self) -> bool:
        """At least one replica group can take traffic.  Deliberately looser
        than ready(): during a rolling update (maxUnavailable=1) readiness
        dips below spec.replicas, and dropping the whole route then — as the
        reference's Replicas==ReadyReplicas gate does — would turn every
        rollout into an outage.  The route's address list still contains
        only Running groups (Service status sync)."""
        return self.status.get("readyReplicas", 0) >= 1


@dataclasses.dataclass
class DisaggregatedApplication(Resource):
    """ArksDisaggregatedApplication: prefill/decode-separated service.

    spec: {router: {replicas, port}, prefill: {replicas, size, ...},
           decode: {replicas, size, ...}, runtime, model, servedModelName}
    (reference: arksdisaggregatedapplication_types.go:103-148)
    """

    KIND = "DisaggregatedApplication"

    @property
    def phase(self) -> str:
        return self.status.get("phase", PHASE_PENDING)

    @property
    def served_model_name(self) -> str:
        return self.spec.get("servedModelName") or self.spec.get("model", {}).get("name", "")

    def ready(self) -> bool:
        # reference: router>0 & prefill & decode complete
        # (arksendpoint_controller.go:326-333)
        s = self.status
        return (s.get("router", {}).get("readyReplicas", 0) > 0
                and s.get("prefill", {}).get("readyReplicas", 0)
                >= self.spec.get("prefill", {}).get("replicas", 1)
                and s.get("decode", {}).get("readyReplicas", 0)
                >= self.spec.get("decode", {}).get("replicas", 1))

    def serving(self) -> bool:
        """One ready replica in EVERY tier can take traffic — the same
        rolling-update route survival as Application.serving(): readiness
        dips by maxUnavailable=1 during a rollout and dropping the route
        then would make every disagg rollout an outage."""
        s = self.status
        return (s.get("router", {}).get("readyReplicas", 0) >= 1
                and s.get("prefill", {}).get("readyReplicas", 0) >= 1
                and s.get("decode", {}).get("readyReplicas", 0) >= 1)


@dataclasses.dataclass
class Endpoint(Resource):
    """ArksEndpoint: model-name-keyed routing rule.

    spec: {defaultWeight: int, routeConfigs: [{backend: {host, port}, weight}],
           matchConfigs: [...]}
    status: {routes: [{backend, weight}]}
    (reference: arksendpoint_types.go:27-56)
    """

    KIND = "Endpoint"


@dataclasses.dataclass
class Token(Resource):
    """ArksToken: API token with per-endpoint QoS.

    spec: {token: str, qos: [{endpoint: {name, namespace},
           rateLimits: [{type, value}], quota: {name}}]}
    (reference: arkstoken_types.go:46-61)
    """

    KIND = "Token"


@dataclasses.dataclass
class Quota(Resource):
    """ArksQuota: cumulative token-usage budget.

    spec: {quotas: [{type: prompt|response|total, value: int}]}
    status: {quotaStatus: [{type, used, lastUpdateTime}]}
    (reference: arksquota_types.go:47-73)
    """

    KIND = "Quota"


@dataclasses.dataclass
class GangSet(Resource):
    """Gang workload (LeaderWorkerSet equivalent): replicas x size pod
    groups with leader/worker commands and all-or-nothing semantics.

    spec: {replicas, size, leader: {command, env}, worker: {command, env},
           ports: {http: 8080}, restartPolicy: "RecreateGroupOnPodRestart"}
    status: {replicas, readyReplicas, groups: [{index, phase, leaderAddr}]}
    """

    KIND = "GangSet"


@dataclasses.dataclass
class Service(Resource):
    """Service record: stable name -> backend addresses.

    spec: {selector: {...}, port: int}
    status: {addresses: ["host:port", ...]}
    (reference creates Service arks-application-<name>:8080 —
    arksapplication_controller.go:376-415)
    """

    KIND = "Service"


ALL_KINDS = [Model, Application, DisaggregatedApplication, Endpoint, Token,
             Quota, GangSet, Service]
KIND_BY_NAME = {k.KIND: k for k in ALL_KINDS}
