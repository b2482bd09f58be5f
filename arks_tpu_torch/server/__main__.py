"""Serving entry point: ``python -m arks_tpu_torch.server --model NAME``.

Random weights from ``--seed`` (loading checkpoints is a later slice) and
the byte-level tokenizer unless ``--tokenizer-path`` names a HuggingFace
tokenizer directory.  Runs on the CUDA device unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser("arks_tpu_torch.server")
    p.add_argument("--model", required=True,
                   help="model config name (arks_tpu_torch.models)")
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
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from arks_tpu_torch.engine.engine import EngineConfig, InferenceEngine
    from arks_tpu_torch.engine.tokenizer import load_tokenizer
    from arks_tpu_torch.models.config import get_config
    from arks_tpu_torch.server.openai_server import OpenAIServer

    cfg = get_config(args.model)
    ecfg = EngineConfig(model=args.model, num_slots=args.num_slots,
                        max_cache_len=args.max_model_len, dtype=args.dtype,
                        kv_cache_dtype=args.kv_cache_dtype,
                        weight_dtype=args.weight_dtype,
                        kv_layout=args.kv_layout,
                        prefix_cache_mb=args.prefix_cache_mb, seed=args.seed)
    engine = InferenceEngine(cfg, ecfg, load_tokenizer(args.tokenizer_path),
                             device=args.device)
    server = OpenAIServer(engine, args.served_model_name or args.model,
                          host=args.host, port=args.port)
    engine.start()
    done = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: done.set())
    signal.signal(signal.SIGINT, lambda *_: done.set())
    server.start(background=True)
    logging.getLogger("arks_tpu_torch.server").info(
        "serving %s on %s:%d (%s)", args.model, args.host, server.port,
        engine.device)
    done.wait()
    server.stop()
    engine.stop()


if __name__ == "__main__":
    main()
