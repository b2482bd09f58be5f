"""Operator entrypoint: ``python -m arks_tpu_torch.control [flags]`` (the
port's copy of ``arks_tpu/control/__main__.py``).

The single-binary analogue of the reference's two deployments (operator
cmd/main.go + gateway cmd/gateway/main.go): starts the controller set over a
store, optionally the QoS gateway, and applies manifests — so

    python -m arks_tpu_torch.control \\
        --manifests examples/quickstart/quickstart_torch.yaml

deploys replicas of ``python -m arks_tpu_torch.server`` on this host's GPU
(``--local-device cpu`` runs them on the CPU) behind the gateway's tokens,
rate limits and quota, and

    python -m arks_tpu_torch.control \\
        --manifests examples/quickstart/disaggregated_torch.yaml

deploys a DisaggregatedApplication: prefill and decode replicas of the
server behind the port's cache-aware router (``python -m
arks_tpu_torch.router``).  Manifests are YAML documents with the same
kind/metadata/spec shape as the reference CRs.
"""

from __future__ import annotations

import argparse
import logging
import signal
import time

log = logging.getLogger("arks_tpu_torch.operator")


def apply_manifests(store, path: str) -> list:
    """Create (or update the spec of) every resource in the YAML file
    ``path``.  Every document is checked before any is applied: an unknown
    kind raises ``ValueError``, and then nothing of the file is applied."""
    import yaml

    from arks_tpu_torch.control.resources import KIND_BY_NAME
    from arks_tpu_torch.control.store import Conflict

    with open(path) as f:
        docs = [d for d in yaml.safe_load_all(f) if d]
    objs = []
    for doc in docs:
        kind = doc.get("kind")
        cls = KIND_BY_NAME.get(kind)
        if cls is None:
            raise ValueError(f"unknown kind {kind!r} in {path}")
        objs.append(cls.from_dict(doc))
    for obj in objs:
        try:
            store.create(obj)
        except Conflict:
            cur = store.get(type(obj), obj.name, obj.namespace)
            cur.spec = obj.spec
            store.update(cur)
        log.info("applied %s %s/%s", obj.KIND, obj.namespace, obj.name)
    return objs


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser("arks_tpu_torch.control")
    p.add_argument("--models-root", default=None,
                   help="model storage root (default: arks-tpu-torch/models "
                        "under the system's temporary directory)")
    p.add_argument("--manifests", action="append", default=[])
    p.add_argument("--gateway-port", type=int, default=8081)
    p.add_argument("--no-gateway", action="store_true")
    p.add_argument("--local-device", default=None,
                   help="--device of the spawned servers (cpu for demos; "
                        "default: the server's own, the CUDA device)")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    import os
    import tempfile

    from arks_tpu_torch.control.manager import build_manager
    from arks_tpu_torch.control.store import Store
    from arks_tpu_torch.gateway.server import Gateway

    models_root = args.models_root or os.path.join(
        tempfile.gettempdir(), "arks-tpu-torch", "models")
    store = Store()
    gateway = None if args.no_gateway else Gateway(store, port=args.gateway_port)
    # The embedded gateway's admitted-request rates drive the native
    # autoscaler (Application.spec.autoscale).
    mgr = build_manager(models_root=models_root, store=store,
                        local_device=args.local_device,
                        rate_source=gateway.rate.rpm if gateway else None)
    mgr.start()
    try:
        if gateway is not None:
            gateway.start(background=True)
            log.info("gateway on :%d", gateway.port)
        for path in args.manifests:
            apply_manifests(mgr.store, path)

        stop = []
        signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
        signal.signal(signal.SIGINT, lambda *a: stop.append(1))
        while not stop:
            time.sleep(0.5)
    finally:
        log.info("shutting down")
        if gateway:
            gateway.stop()
        mgr.stop()


if __name__ == "__main__":
    main()
