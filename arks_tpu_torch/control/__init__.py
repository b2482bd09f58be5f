"""The port's operator (a copy of ``arks_tpu/control/``, local mode): the
six Arks resources in a watchable store, and the controllers that deploy
``python -m arks_tpu_torch.server`` replicas and route to them."""

from arks_tpu_torch.control.resources import (
    Application, DisaggregatedApplication, Endpoint, Model, Quota, Token,
)
from arks_tpu_torch.control.store import Store

__all__ = ["Application", "DisaggregatedApplication", "Endpoint", "Model",
           "Quota", "Token", "Store"]
