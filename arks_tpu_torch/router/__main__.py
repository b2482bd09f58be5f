"""Router entrypoint: ``python -m arks_tpu_torch.router --port ...
--discovery-file ...`` (the port's copy of ``arks_tpu/router/__main__.py``).

The reference router command line is generated at
internal/controller/arksdisaggregatedapplication_controller.go:1630-1670;
this is its native stand-in (no torch import — the router is pure I/O).
``--service-discovery`` (pods by label selector from the Kubernetes API)
needs the Kubernetes client, which the port does not have yet: it raises
``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import logging


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser("arks_tpu_torch.router")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--served-model-name", default="")
    p.add_argument("--discovery-file", default=None,
                   help="JSON {prefill: [addr], decode: [addr]}; falls back "
                        "to ARKS_PREFILL_ADDRS/ARKS_DECODE_ADDRS env")
    p.add_argument("--service-discovery", action="store_true",
                   help="discover prefill/decode pods from the Kubernetes "
                        "API by label selector (the reference router's "
                        "--service-discovery mode); not ported yet")
    p.add_argument("--namespace", default=None,
                   help="pod namespace for --service-discovery (default: "
                        "the pod's own namespace)")
    p.add_argument("--application", default=None,
                   help="arks.ai/application label value to select")
    p.add_argument("--backend-port", type=int, default=8080,
                   help="fallback port when a pod declares no containerPort")
    p.add_argument("--discovery-interval", type=float, default=2.0)
    p.add_argument("--kube-api", default=None,
                   help="apiserver base URL (default: in-cluster config)")
    p.add_argument("--policy", default="cache_aware",
                   choices=("round_robin", "cache_aware"),
                   help="cache_aware scores backends by expected prefix "
                        "hit depth against their exported cache sketches "
                        "(ARKS_ROUTER_SKETCH_* knobs; ARKS_ROUTER_SKETCH=0 "
                        "falls back to rendezvous-only), pinning shared "
                        "prompt prefixes to the backend that actually "
                        "holds them (reference router default)")
    p.add_argument("--unified", action="store_true",
                   help="backends are plain OpenAI servers (no prefill/"
                        "decode split): route over the decode list only "
                        "and forward to the ordinary completion paths "
                        "(also ARKS_ROUTER_UNIFIED=1)")
    args = p.parse_args(argv)

    if args.service_discovery:
        raise NotImplementedError(
            "--service-discovery needs the Kubernetes client, which the "
            "port does not have yet (ROADMAP.md queue 1 item 5.3); use "
            "--discovery-file")

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    from arks_tpu_torch.router import Discovery, Router

    router = Router(Discovery(args.discovery_file), args.served_model_name,
                    host=args.host, port=args.port, policy=args.policy,
                    unified=args.unified)
    router.start(background=False)


if __name__ == "__main__":
    main()
