"""GangSet controller: converges gang workloads via a driver and publishes
group status — the role LWS/RBGS operators play for the reference
(SURVEY.md §1 external deps).  A copy of
``arks_tpu/control/gangset_controller.py``."""

from __future__ import annotations

import logging

from arks_tpu_torch.control.reconciler import Controller, Result
from arks_tpu_torch.control.resources import GangSet
from arks_tpu_torch.control.store import Store
from arks_tpu_torch.control.workloads import GangDriver

log = logging.getLogger("arks_tpu_torch.control.gangset")


class GangSetController(Controller):
    KIND = GangSet
    FINALIZER = "gangset.arks.ai/controller"
    RESYNC_S = 1.0  # liveness poll; groups can die between events

    def __init__(self, store: Store, driver: GangDriver, workers: int = 2):
        super().__init__(store, workers=workers)
        self.driver = driver

    def reconcile(self, gs: GangSet) -> Result | None:
        self.driver.ensure(gs)
        st = self.driver.status(gs)
        if st != {k: gs.status.get(k) for k in st}:
            gs.status.update(st)
            self.store.update_status(gs)
        # Keep polling: process death must flip readiness without an event.
        return Result(requeue_after=self.RESYNC_S)

    def finalize(self, gs: GangSet) -> None:
        self.driver.teardown(gs)
