"""Standalone gateway: ``python -m arks_tpu_torch.gateway [flags]`` (the
port's copy of ``arks_tpu/gateway/__main__.py``).

The analogue of the reference's gateway binary (cmd/gateway/main.go) in its
``file`` config-provider mode: QoS resources (Token/Quota/Endpoint) come
from YAML manifests instead of a live operator store.  When embedded next
to the operator (python -m arks_tpu_torch.control), the gateway shares the
operator's store instead and this entrypoint is not used.

Counter stores (``--backend``): ``auto`` is the native C++ store when its
library builds, else the in-memory one; ``memory`` and ``native`` name one;
``redis`` keeps the rate windows and the quota ledger on a RESP server
(``--redis-addr``), which gateway replicas share.
"""

from __future__ import annotations

import argparse
import logging
import signal
import time

log = logging.getLogger("arks_tpu_torch.gateway.main")


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser("arks_tpu_torch.gateway")
    p.add_argument("--manifests", action="append", default=[],
                   help="YAML files with Token/Quota/Endpoint resources "
                        "(the reference's file provider)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8081)
    p.add_argument("--backend", choices=("auto", "memory", "native", "redis"),
                   default="auto",
                   help="counter/quota store: auto = native C++ if built "
                        "else memory (single replica); redis = shared store "
                        "for HA gateways (reference redis_impl.go parity)")
    p.add_argument("--redis-addr", default="127.0.0.1:6379",
                   help="RESP server address(es) for --backend redis — "
                        "comma-separated list selects cluster mode; with "
                        "--redis-sentinel-master the list is sentinel "
                        "addresses (reference cmd/gateway/main.go:137-170)")
    p.add_argument("--redis-sentinel-master", default=None,
                   help="Redis Sentinel master name (enables sentinel mode)")
    p.add_argument("--max-body-bytes", type=int, default=4 * 1024 * 1024,
                   help="request-body cap -> 413 (reference "
                        "ClientTrafficPolicy 4MiB client buffer)")
    p.add_argument("--process-timeout", type=float, default=5.0,
                   help="per-stage processing deadline in seconds "
                        "(reference ext_proc messageTimeout)")
    args = p.parse_args(argv)

    from arks_tpu_torch.control.__main__ import apply_manifests
    from arks_tpu_torch.control.store import Store
    from arks_tpu_torch.gateway.ratelimiter import (
        RateLimiter, make_counter_backend,
    )
    from arks_tpu_torch.gateway.server import Gateway

    # The store first: one that cannot be reached or built fails before
    # anything starts.
    backend = make_counter_backend(args.backend, args.redis_addr,
                                   args.redis_sentinel_master)
    rate_limiter = RateLimiter(backend)
    quota = None
    if args.backend == "redis":
        from arks_tpu_torch.gateway.rediskv import RedisQuotaService
        quota = RedisQuotaService(backend.client)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    store = Store()
    for path in args.manifests:
        apply_manifests(store, path)

    gw = Gateway(store, host=args.host, port=args.port,
                 rate_limiter=rate_limiter, quota=quota,
                 max_body_bytes=args.max_body_bytes,
                 process_timeout_s=args.process_timeout)
    gw.start(background=True)
    log.info("gateway on %s:%d (/v1/* + /metrics, backend=%s: %s)",
             args.host, gw.port, args.backend, type(backend).__name__)

    stop: list[int] = []
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    try:
        while not stop:
            time.sleep(0.5)
    finally:
        gw.stop()


if __name__ == "__main__":
    main()
