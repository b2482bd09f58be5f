"""The port's QoS gateway (a copy of ``arks_tpu/gateway/``): tokens, rate
limits, quota and weighted routing in front of the port's replicas."""

from arks_tpu_torch.gateway.server import Gateway

__all__ = ["Gateway"]
