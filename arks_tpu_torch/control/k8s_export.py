"""The checks of ``arks_tpu/control/k8s_export.py`` that the controllers
run at precheck (the reference's renderer of Kubernetes manifests is not
ported yet: a GPU node-pool renderer is queued in ``ROADMAP.md``).

- ``validate_instance_spec``: the reserved model mount and the gang's
  rendezvous env (reference precheck :236-264), a copy.
- ``validate_pod_group_policy``: exactly one gang scheduler, a copy.
- ``validate_dapp_mode``: a DisaggregatedApplication's layout, ``legacy``
  or ``unified``, a copy.
- ``try_shape``: the reference derives a gang's size and slice count from
  a TPU topology name (``tpu-v5e-16``, ``tpu-v5p-16x2``).  The port serves
  NVIDIA GPUs, so a TPU topology name is refused (``ValueError``, which the
  precheck turns into ``InvalidSpec``) and every other accelerator (a GPU
  type, ``cpu``, unset) has no host topology: a gang's size is
  ``spec.size``, default 1.
"""

from __future__ import annotations

from arks_tpu_torch.control.resources import (
    RESERVED_MODELS_PATH, RESERVED_MODELS_VOLUME,
)

# Env names the renderer owns — user env may not shadow the rendezvous
# contract (a wrong ARKS_PROCESS_ID would scramble the gang).
_RESERVED_ENV = {"ARKS_COORDINATOR_ADDRESS", "ARKS_NUM_PROCESSES",
                 "ARKS_PROCESS_ID", "ARKS_GANG_SIZE", "ARKS_GANG_SECRET"}


def validate_instance_spec(inst: dict | None) -> None:
    """Reserved-name precheck (reference precheck :236-264: the 'models'
    volume / '/models' mount belong to ArksModel)."""
    if not inst:
        return
    for v in inst.get("volumes") or []:
        if v.get("name") == RESERVED_MODELS_VOLUME:
            raise ValueError(
                f"instanceSpec volume name {RESERVED_MODELS_VOLUME!r} is "
                "reserved for the model mount")
    for vm in inst.get("volumeMounts") or []:
        if vm.get("mountPath") == RESERVED_MODELS_PATH:
            raise ValueError(
                f"instanceSpec mountPath {RESERVED_MODELS_PATH!r} is "
                "reserved for the model mount")
    for e in inst.get("env") or []:
        if e.get("name") in _RESERVED_ENV:
            raise ValueError(
                f"instanceSpec env {e.get('name')!r} is reserved for the "
                "gang rendezvous contract")


def validate_pod_group_policy(policy: dict | None) -> None:
    if not policy:
        return
    srcs = [k for k in ("kubeScheduling", "volcanoScheduling") if policy.get(k) is not None]
    if len(srcs) != 1:
        raise ValueError(
            "podGroupPolicy must set exactly one of kubeScheduling / "
            f"volcanoScheduling (got {srcs or 'neither'})")


VALID_DAPP_MODES = ("legacy", "unified")


def validate_dapp_mode(mode: str) -> None:
    if mode not in VALID_DAPP_MODES:
        raise ValueError(
            f"spec.mode must be one of {'|'.join(VALID_DAPP_MODES)}, "
            f"got {mode!r}")


def try_shape(accelerator: str | None) -> None:
    """The host topology of ``accelerator``: none for a GPU type, ``cpu``
    or unset.  A TPU topology name raises ``ValueError``: this operator
    launches the port, which runs on NVIDIA GPUs, and sizes no gang from
    TPU hosts."""
    if accelerator and accelerator.startswith("tpu-"):
        raise ValueError(
            f"accelerator {accelerator!r} is a TPU topology; this operator "
            "deploys the PyTorch port on NVIDIA GPUs (name a GPU type or "
            "cpu, and set spec.size for a gang)")
    return None
