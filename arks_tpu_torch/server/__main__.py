"""Serving entry point: ``python -m arks_tpu_torch.server --model NAME``.

``--model`` is a registry name or a HuggingFace model directory (its
``config.json`` gives the config).  Weights come from ``--model-path`` (or
the ``--model`` directory): safetensors shards, quantized on load with
``--weight-dtype int8|int4``; with neither, random weights from
``--seed``.  An ``arks_orbax/`` checkpoint raises.  The tokenizer is the
model directory's (required when it holds real weights), else the
byte-level one; ``--tokenizer-path`` overrides both.  Runs on the CUDA
device unless ``--device cpu``.

SIGTERM drains (readiness 503, new completions 503, in-flight requests
finish for up to ``--drain-timeout`` seconds) and then exits; SIGINT
stops at once.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import threading


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser("arks_tpu_torch.server")
    p.add_argument("--model", required=True,
                   help="model config name (arks_tpu_torch.models) or a "
                        "model directory with config.json")
    p.add_argument("--model-path", default=None,
                   help="weights/tokenizer directory (HF safetensors); "
                        "random weights from --seed without it")
    p.add_argument("--served-model-name", default=None)
    p.add_argument("--tokenizer-path", default=None)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--num-slots", type=int, default=8)
    p.add_argument("--max-model-len", type=int, default=1024)
    p.add_argument("--dtype", default=None)
    p.add_argument("--kv-cache-dtype", default="auto",
                   choices=("auto", "bf16", "int8", "int4"),
                   help="KV pool: auto (the model's preference, else the "
                        "engine dtype), bf16, int8 (per-token scales) or "
                        "int4 (token pairs packed per byte)")
    p.add_argument("--weight-dtype", default="bf16",
                   choices=("bf16", "int8", "int4"),
                   help="weights: bf16 (the engine dtype), int8 (w8a16, "
                        "per-channel scales) or int4 (w4a16, groupwise "
                        "scales, packed two a byte); Mixtral-8x7B fits one "
                        "80 GB card in int8 or int4")
    p.add_argument("--kv-layout", default="auto",
                   choices=("auto", "paged", "slot"),
                   help="KV layout: auto/paged (page pool; the mixed "
                        "scheduler unless ARKS_MIXED_STEP=0) or slot "
                        "(slot-contiguous cache, legacy scheduler)")
    p.add_argument("--prefix-cache-mb", type=int, default=256,
                   help="prefix reuse: a paged pool's retention pages, or "
                        "the slot cache's host prefix cache, in MB (0: "
                        "none)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--drain-timeout", type=float, default=20.0,
                   help="SIGTERM grace: finish in-flight requests up to "
                        "this many seconds before exiting")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from arks_tpu_torch.device import resolve_device
    from arks_tpu_torch.engine.engine import EngineConfig, InferenceEngine
    from arks_tpu_torch.engine.tokenizer import load_tokenizer
    from arks_tpu_torch.models.config import ModelConfig, get_config
    from arks_tpu_torch.models.weights import has_real_weights, load_params
    from arks_tpu_torch.server.openai_server import OpenAIServer

    if os.path.isdir(args.model):
        cfg = ModelConfig.from_hf_config(
            args.model, name=os.path.basename(os.path.normpath(args.model)))
        model_path = args.model_path or args.model
    else:
        cfg = get_config(args.model)
        model_path = args.model_path
    device = resolve_device(args.device)
    params = None
    if model_path:
        params = load_params(cfg, model_path, dtype=args.dtype,
                             weight_dtype=args.weight_dtype, device=device,
                             seed=args.seed)
    if args.tokenizer_path:
        tokenizer = load_tokenizer(args.tokenizer_path)
    else:
        # Real weights without tokenizer assets is a broken mount: fail.
        tokenizer = load_tokenizer(
            model_path if model_path and os.path.isdir(model_path) else None,
            strict=has_real_weights(model_path))
    ecfg = EngineConfig(model=cfg.name, num_slots=args.num_slots,
                        max_cache_len=args.max_model_len, dtype=args.dtype,
                        kv_cache_dtype=args.kv_cache_dtype,
                        weight_dtype=args.weight_dtype,
                        kv_layout=args.kv_layout,
                        prefix_cache_mb=args.prefix_cache_mb, seed=args.seed)
    engine = InferenceEngine(cfg, ecfg, tokenizer, params=params,
                             device=device)
    server = OpenAIServer(engine, args.served_model_name or cfg.name,
                          host=args.host, port=args.port)
    log = logging.getLogger("arks_tpu_torch.server")
    engine.start()
    done = threading.Event()

    def _drain_then_exit():
        server.drain(args.drain_timeout)
        done.set()

    def _on_term(signum, frame):
        log.info("SIGTERM: draining in-flight requests (up to %.0fs)",
                 args.drain_timeout)
        threading.Thread(target=_drain_then_exit, name="drain",
                         daemon=True).start()

    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, lambda *_: done.set())
    server.start(background=True)
    log.info("serving %s on %s:%d (%s)", cfg.name, args.host, server.port,
             engine.device)
    # A timed wait: a signal delivered to another thread runs its handler
    # only once the main thread next runs Python code.
    while not done.wait(0.1):
        pass
    server.stop()
    engine.stop()
    log.info("stopped")


if __name__ == "__main__":
    main()
