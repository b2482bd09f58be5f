"""Operator assembly: store + the controller set (cmd/main.go analogue; the
port's copy of ``arks_tpu/control/manager.py``)."""

from __future__ import annotations

from arks_tpu_torch.control.application_controller import (
    ApplicationController,
)
from arks_tpu_torch.control.disaggregated_controller import (
    DisaggregatedApplicationController,
)
from arks_tpu_torch.control.endpoint_controller import EndpointController
from arks_tpu_torch.control.gangset_controller import GangSetController
from arks_tpu_torch.control.model_controller import (
    ModelController, default_fetcher,
)
from arks_tpu_torch.control.reconciler import Manager
from arks_tpu_torch.control.store import Store
from arks_tpu_torch.control.workloads import GangDriver, LocalProcessDriver


def build_manager(
    models_root: str,
    driver: GangDriver | None = None,
    store: Store | None = None,
    fetcher=default_fetcher,
    local_device: str | None = None,
    rate_source=None,
    autoscale_interval_s: float = 10.0,
    router_discovery: str = "file",
) -> Manager:
    """Wire the controller set over one store.

    Token/Quota have no controllers — by design, matching the reference where
    both reconcilers are unregistered no-ops (cmd/main.go:264-277); the
    gateway consumes those resources read-only.

    ``local_device`` is the ``--device`` of every server the local driver
    spawns (``cpu`` in tests; None: the server's default, the CUDA device).
    ``rate_source(namespace, served_model_name) -> rpm`` (typically the
    embedded gateway's RequestRateTracker.rpm) enables the native
    autoscaler over ``Application.spec.autoscale``.
    """
    mgr = Manager(store)
    driver = driver or LocalProcessDriver()
    mgr.add(ModelController(mgr.store, models_root, fetcher=fetcher))
    mgr.add(GangSetController(mgr.store, driver))
    mgr.add(ApplicationController(mgr.store, local_device=local_device))
    mgr.add(DisaggregatedApplicationController(
        mgr.store, local_device=local_device,
        router_discovery=router_discovery))
    mgr.add(EndpointController(mgr.store))
    if rate_source is not None:
        from arks_tpu_torch.control.autoscaler import AutoscalerController
        mgr.add(AutoscalerController(mgr.store, rate_source,
                                     interval_s=autoscale_interval_s))
    return mgr
