"""Standalone gateway: ``python -m arks_tpu_torch.gateway [flags]`` (the
port's copy of ``arks_tpu/gateway/__main__.py``).

The analogue of the reference's gateway binary (cmd/gateway/main.go) in its
``file`` config-provider mode: QoS resources (Token/Quota/Endpoint) come
from YAML manifests instead of a live operator store.  When embedded next
to the operator (python -m arks_tpu_torch.control), the gateway shares the
operator's store instead and this entrypoint is not used.

Counter stores: ``auto`` and ``memory`` are the in-memory store (one
gateway replica).  ``native`` (the reference's C++ store) and ``redis``
(its shared store for HA gateways) are not ported yet and raise
``NotImplementedError``.
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
                   help="counter store: auto = memory (single replica); "
                        "native and redis are not ported yet")
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

    # Refuse an unported store before anything starts.
    rate_limiter = RateLimiter(make_counter_backend(args.backend))

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    store = Store()
    for path in args.manifests:
        apply_manifests(store, path)

    gw = Gateway(store, host=args.host, port=args.port,
                 rate_limiter=rate_limiter,
                 max_body_bytes=args.max_body_bytes,
                 process_timeout_s=args.process_timeout)
    gw.start(background=True)
    log.info("gateway on %s:%d (/v1/* + /metrics, backend=%s)",
             args.host, gw.port, args.backend)

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
