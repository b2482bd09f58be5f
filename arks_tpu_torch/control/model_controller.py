"""Model controller: storage + download (a copy of
``arks_tpu/control/model_controller.py``).

Phase machine mirrors the reference ArksModelReconciler
(internal/controller/arksmodel_controller.go:143-367):
Pending -> StorageCreating -> ModelLoading -> Ready | Failed, conditions
StorageCreated / ModelLoaded / Ready, terminal phases skipped on re-entry
(:150-152), nil source = "existing storage" (:355-358).

- Storage is a directory under ``models_root`` (stand-in for the PVC; the
  path layout matches generateModelPath :377-382 — ``<root>/<subPath>`` or
  ``<root>/models/<ns>/<name>``).
- The download worker is a background thread running a pluggable fetcher
  (local copy, HuggingFace snapshot) instead of a worker pod; its terminal
  state maps to the ModelLoaded condition exactly like the pod-phase mapping
  (:338-353).
- ``spec.convertOrbax: true`` (or ``ARKS_CONVERT_ORBAX``, the reference's
  download job's switch) fails the Model (reason
  ``OrbaxUnsupported``): the reference writes an Orbax checkpoint after the
  download, and ``orbax.checkpoint`` imports jax, which the port never
  does.  The port's server loads the HF safetensors themselves.
"""

from __future__ import annotations

import logging
import os
import shutil
import threading

from arks_tpu_torch import knobs
from arks_tpu_torch.control.reconciler import Controller, Result
from arks_tpu_torch.control.resources import (
    COND_MODEL_LOADED, COND_READY, COND_STORAGE_CREATED,
    MODEL_PHASE_FAILED, MODEL_PHASE_LOADING, MODEL_PHASE_PENDING,
    MODEL_PHASE_READY, MODEL_PHASE_STORAGE_CREATING, Model,
)
from arks_tpu_torch.control.store import Store

log = logging.getLogger("arks_tpu_torch.control.model")


def default_fetcher(model: Model, dest: str) -> None:
    """Fetch model artifacts into ``dest``.

    source.local.path  -> copy a local directory (tests, pre-staged NFS)
    source.huggingface -> snapshot_download (needs egress; mirrors
                          scripts/download.py)
    """
    source = model.spec.get("source") or {}
    if "local" in source:
        src = source["local"]["path"]
        if not os.path.isdir(src):
            raise FileNotFoundError(f"local source {src} does not exist")
        shutil.copytree(src, dest, dirs_exist_ok=True)
        return
    if "huggingface" in source:
        from huggingface_hub import snapshot_download  # optional dep

        repo = model.spec.get("model") or model.name
        token = source["huggingface"].get("token")
        snapshot_download(repo_id=repo, local_dir=dest, token=token)
        return
    raise ValueError(f"unsupported model source {sorted(source)}")


class _Worker:
    def __init__(self) -> None:
        self.phase = "Running"
        self.message = ""


class ModelController(Controller):
    KIND = Model
    FINALIZER = "model.arks.ai/controller"

    def __init__(self, store: Store, models_root: str,
                 fetcher=default_fetcher, workers: int = 2):
        super().__init__(store, workers=workers)
        self.models_root = models_root
        self.fetcher = fetcher
        self._download_workers: dict[tuple, _Worker] = {}
        self._dw_lock = threading.Lock()

    # reference generateModelPath (arksmodel_controller.go:377-382)
    def model_path(self, m: Model) -> str:
        sub = (m.spec.get("storage") or {}).get("subPath")
        if sub:
            return os.path.join(self.models_root, sub)
        return os.path.join(self.models_root, "models", m.namespace, m.name)

    def reconcile(self, m: Model) -> Result | None:
        if m.phase in (MODEL_PHASE_READY, MODEL_PHASE_FAILED):
            return None  # terminal (:150-152)

        if m.spec.get("convertOrbax") or knobs.get_bool("ARKS_CONVERT_ORBAX"):
            m.set_condition(
                COND_MODEL_LOADED, False, "OrbaxUnsupported",
                "convertOrbax: Orbax checkpoints are not written by "
                "this operator (orbax.checkpoint imports jax); the PyTorch "
                "port serves the HF safetensors directly, so drop "
                "convertOrbax (and ARKS_CONVERT_ORBAX)")
            m.status["phase"] = MODEL_PHASE_FAILED
            self.store.update_status(m)
            return None

        changed = False
        if not m.status.get("phase"):
            m.status["phase"] = MODEL_PHASE_PENDING
            changed = True

        # --- storage (:172-216) ---
        if not m.condition(COND_STORAGE_CREATED):
            path = self.model_path(m)
            os.makedirs(path, exist_ok=True)
            m.status["path"] = path
            m.status["phase"] = MODEL_PHASE_STORAGE_CREATING
            m.set_condition(COND_STORAGE_CREATED, True, "StorageReady", path)
            changed = True

        # --- download (:218-358) ---
        if not m.condition(COND_MODEL_LOADED):
            if not m.spec.get("source"):
                # Existing storage: nothing to download (:355-358).
                m.set_condition(COND_MODEL_LOADED, True, "ExistingStorage",
                                "no source specified; using existing storage")
                changed = True
            else:
                worker = self._ensure_worker(m)
                m.status["phase"] = MODEL_PHASE_LOADING
                if worker.phase == "Succeeded":
                    m.set_condition(COND_MODEL_LOADED, True, "Downloaded", "")
                    changed = True
                elif worker.phase == "Failed":
                    m.set_condition(COND_MODEL_LOADED, False, "DownloadFailed",
                                    worker.message)
                    m.status["phase"] = MODEL_PHASE_FAILED
                    self.store.update_status(m)
                    return None
                else:
                    self.store.update_status(m)
                    return Result(requeue_after=0.2)

        # --- ready ---
        if m.condition(COND_STORAGE_CREATED) and m.condition(COND_MODEL_LOADED):
            m.status["phase"] = MODEL_PHASE_READY
            m.set_condition(COND_READY, True, "ModelReady", "")
            changed = True

        if changed:
            self.store.update_status(m)
        return None

    def _ensure_worker(self, m: Model) -> _Worker:
        with self._dw_lock:
            worker = self._download_workers.get(m.key)
            if worker is not None:
                return worker
            worker = _Worker()
            self._download_workers[m.key] = worker

        def run():
            dest = self.model_path(m)
            try:
                self.fetcher(m, dest)
                worker.phase = "Succeeded"
            except Exception as e:
                log.exception("model %s/%s download failed", m.namespace, m.name)
                worker.phase = "Failed"
                worker.message = str(e)  # termination-message analogue (:338-353)
            self.queue.add(m.key)

        threading.Thread(target=run, name=f"download-{m.name}", daemon=True).start()
        return worker

    def finalize(self, m: Model) -> None:
        with self._dw_lock:
            self._download_workers.pop(m.key, None)
        # Storage retention mirrors PVC semantics: data outlives the CR
        # unless explicitly reclaimed.
        if (m.spec.get("storage") or {}).get("reclaim") == "Delete":
            path = m.status.get("path")
            if path and os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
