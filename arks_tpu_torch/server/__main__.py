"""Serving entry point: ``python -m arks_tpu_torch.server --model NAME``.

``--model`` is a registry name or a HuggingFace model directory (its
``config.json`` gives the config).  Weights come from ``--model-path`` (or
the ``--model`` directory): safetensors shards, quantized on load with
``--weight-dtype int8|int4``; with neither, random weights from
``--seed``.  An ``arks_orbax/`` checkpoint raises.  The tokenizer is the
model directory's (required when it holds real weights), else the
byte-level one; ``--tokenizer-path`` overrides both.  Runs on the CUDA
device unless ``--device cpu``.

``--draft-model`` (a registry name or a model directory, which then loads
its own weights) turns on speculative decoding with ``--draft-len``
tokens verified a step; its weights come from ``--draft-model-path``
through the same loader (quantized on load with ``--weight-dtype``), else
random from ``--seed`` + 1.  The draft shares the target's tokenizer.

``--extra-model NAME[=PATH]`` (repeatable) registers another model with
the engine's weight pool; requests route by their ``model`` field, and the
engine streams the weights in and switches at drained boundaries.  The
pool exists whenever ``--extra-model``, ``--model-pool-hbm-mb`` (the
weight budget, ``ARKS_MODEL_POOL_HBM_MB``; LRU-evicts idle secondary
models) or ``--draft-model`` is given; the primary and the draft are
pinned in it.

``--disaggregation-mode prefill`` serves ``POST /v1/prefill`` on an
engine that never starts its step loop (``server/disagg.py``
``PrefillServer``); ``decode`` serves the OpenAI endpoints and
``/v1/disagg/*``, which pull each prompt's K/V from the prefill server
named in ``X-Arks-Prefill-Addr`` (``DecodeServer``).  The prefix tiers
behind the pool read the environment: ``ARKS_PREFIX_DISK_MB`` and
``ARKS_PREFIX_DISK_DIR`` (the disk tier), ``ARKS_PEER_FETCH``,
``ARKS_PEER_ADDRS`` and ``ARKS_PEER_FETCH_TIMEOUT_S`` (peer block fetch).

The reference's parallelism flags (``--tensor-parallel-size`` and the
others) are accepted at 1 and refused above it, and so is a gang of more
than one process (``ARKS_GANG_SIZE`` / ``ARKS_NUM_PROCESSES``, which the
operator's local driver sets).  ``--dispatch-deadline``
and ``--fault-retries`` set ``ARKS_DISPATCH_DEADLINE_S`` and
``ARKS_FAULT_RETRIES``.

SIGTERM drains (readiness 503, new completions 503, in-flight requests
finish for up to ``--drain-timeout`` seconds, default
``ARKS_DRAIN_TIMEOUT``) and then exits; SIGINT stops at once.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import threading

from arks_tpu_torch import knobs


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
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
    p.add_argument("--tensor-parallel-size", "--tp", type=int, default=None,
                   dest="tp", help="accepted at 1 (one card); above 1 the "
                   "engine refuses it")
    p.add_argument("--data-parallel-size", "--dp", type=int, default=1,
                   dest="dp", help="accepted at 1")
    p.add_argument("--context-parallel-size", "--cp", type=int, default=1,
                   dest="cp", help="accepted at 1")
    p.add_argument("--pipeline-parallel-size", "--pp", type=int, default=1,
                   dest="pp", help="accepted at 1")
    p.add_argument("--num-slices", type=int, default=None,
                   help="accepted at 1")
    p.add_argument("--num-slots", type=int, default=8)
    p.add_argument("--max-model-len", type=int, default=1024)
    p.add_argument("--steps-per-dispatch", type=int, default=4,
                   help="decode steps per legacy dispatch (and decode rows "
                        "reserved past a prompt)")
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
    p.add_argument("--draft-model", default=None,
                   help="speculative decoding: draft model config name or "
                        "directory (must share the target's tokenizer); "
                        "greedy requests emit the target's tokens, several "
                        "a step")
    p.add_argument("--draft-model-path", default=None,
                   help="draft weights directory (random init from --seed "
                        "+ 1 without it)")
    p.add_argument("--draft-len", type=int, default=4,
                   help="tokens a speculative step verifies (the draft "
                        "proposes draft-len - 1)")
    p.add_argument("--extra-model", action="append", default=None,
                   metavar="NAME[=PATH]",
                   help="register another model with the weight pool "
                        "(repeatable): NAME a config name or a model "
                        "directory, PATH its weights directory; requests "
                        "route by their 'model' field")
    p.add_argument("--model-pool-hbm-mb", type=int, default=None,
                   help="weight budget of the model pool in MiB "
                        "(ARKS_MODEL_POOL_HBM_MB; 0/unset: unlimited); "
                        "idle secondary models are evicted LRU")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--drain-timeout", type=float,
                   default=knobs.get_float("ARKS_DRAIN_TIMEOUT"),
                   help="SIGTERM grace: finish in-flight requests up to "
                        "this many seconds before exiting (default "
                        "ARKS_DRAIN_TIMEOUT)")
    p.add_argument("--dispatch-deadline", type=float, default=None,
                   help="watchdog deadline in seconds for a wedged device "
                        "step (sets ARKS_DISPATCH_DEADLINE_S; 0: off)")
    p.add_argument("--fault-retries", type=int, default=None,
                   help="per-request fault retry budget (sets "
                        "ARKS_FAULT_RETRIES; default 1)")
    p.add_argument("--disaggregation-mode", choices=("prefill", "decode"),
                   default=None, dest="disagg",
                   help="disaggregated serving role: prefill (POST "
                        "/v1/prefill, no decode loop) or decode (pulls the "
                        "K/V from X-Arks-Prefill-Addr on /v1/disagg/*)")
    return p.parse_args(argv)


def build_engine(args: argparse.Namespace):
    """The model config and the engine ``args`` ask for: weights from the
    checkpoint or the seed, the tokenizer, and the draft model when
    speculative decoding is on.  Returns (config, engine)."""
    from arks_tpu_torch.device import resolve_device
    from arks_tpu_torch.engine.engine import EngineConfig, InferenceEngine
    from arks_tpu_torch.engine.model_pool import ModelPool
    from arks_tpu_torch.engine.tokenizer import load_tokenizer
    from arks_tpu_torch.models.config import ModelConfig, get_config
    from arks_tpu_torch.models.weights import has_real_weights, load_params

    if (args.num_slices or 1) > 1:
        raise NotImplementedError(
            f"num_slices={args.num_slices}: parallelism arrives with the "
            "parallelism slice")
    # A gang the operator's local driver launched (ARKS_GANG_SIZE, and the
    # rendezvous's ARKS_NUM_PROCESSES for more than one process).
    gang = max(knobs.get_int("ARKS_GANG_SIZE", 1),
               knobs.get_int("ARKS_NUM_PROCESSES"))
    if gang > 1:
        raise NotImplementedError(
            f"a gang of {gang} processes: this server serves gangs of one "
            "process (multi-host serving arrives with the parallelism "
            "slice); set the Application's size to 1")
    # Fault-tolerance flags travel by the environment, where the engine
    # and its watchdog read them; an explicit flag wins over it.
    if args.dispatch_deadline is not None:
        os.environ["ARKS_DISPATCH_DEADLINE_S"] = str(args.dispatch_deadline)
    if args.fault_retries is not None:
        os.environ["ARKS_FAULT_RETRIES"] = str(args.fault_retries)

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
    # The weight pool, whenever anything multi-model is asked for: the
    # draft, too, is served from it (pinned beside the primary).
    pool = None
    if args.extra_model or args.model_pool_hbm_mb is not None or \
            args.draft_model:
        pool = ModelPool(hbm_budget_mb=args.model_pool_hbm_mb)
    draft_cfg = draft_params = None
    if args.draft_model:
        if os.path.isdir(args.draft_model):
            draft_cfg = ModelConfig.from_hf_config(
                args.draft_model,
                name=os.path.basename(os.path.normpath(args.draft_model)))
            # A directory loads its own weights, as --model's does.
            draft_path = args.draft_model_path or args.draft_model
        else:
            draft_cfg = get_config(args.draft_model)
            draft_path = args.draft_model_path
        if draft_path:
            def _draft_loader(dc=draft_cfg, dp=draft_path):
                return load_params(dc, dp, dtype=args.dtype,
                                   weight_dtype=args.weight_dtype,
                                   device=device, seed=args.seed + 1)

            pool.register(draft_cfg.name, draft_cfg, model_path=draft_path,
                          loader=_draft_loader, pinned=True)
            draft_params = pool.load(draft_cfg.name)
    ecfg = EngineConfig(model=cfg.name, num_slots=args.num_slots,
                        max_cache_len=args.max_model_len,
                        steps_per_dispatch=args.steps_per_dispatch,
                        tensor_parallel=args.tp, data_parallel=args.dp,
                        context_parallel=args.cp, pipeline_parallel=args.pp,
                        dtype=args.dtype,
                        kv_cache_dtype=args.kv_cache_dtype,
                        weight_dtype=args.weight_dtype,
                        kv_layout=args.kv_layout,
                        prefix_cache_mb=args.prefix_cache_mb, seed=args.seed,
                        draft_model=draft_cfg.name if draft_cfg else None,
                        draft_len=args.draft_len)
    engine = InferenceEngine(cfg, ecfg, tokenizer, params=params,
                             device=device, draft_params=draft_params,
                             draft_cfg=draft_cfg, pool=pool)
    if params is not None:
        # Scale-from-zero re-arms from the checkpoint, not the seed.
        engine.set_rearm_loader(
            lambda c, mp=model_path: load_params(
                c, mp, dtype=args.dtype, weight_dtype=args.weight_dtype,
                device=device, seed=args.seed))
    for spec in args.extra_model or []:
        name, _, path = spec.partition("=")
        if os.path.isdir(name):
            engine.register_model(
                ModelConfig.from_hf_config(
                    name, name=os.path.basename(os.path.normpath(name))),
                model_path=path or name)
        else:
            engine.register_model(name, model_path=path or None)
    return cfg, engine


def make_server(args: argparse.Namespace, engine, served: str):
    """The server class of ``--disaggregation-mode``: PrefillServer,
    DecodeServer, or the unified OpenAIServer."""
    if args.disagg == "prefill":
        from arks_tpu_torch.server.disagg import PrefillServer as cls
    elif args.disagg == "decode":
        from arks_tpu_torch.server.disagg import DecodeServer as cls
    else:
        from arks_tpu_torch.server.openai_server import OpenAIServer as cls
    return cls(engine, served, host=args.host, port=args.port)


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg, engine = build_engine(args)
    server = make_server(args, engine, args.served_model_name or cfg.name)
    log = logging.getLogger("arks_tpu_torch.server")
    if args.disagg != "prefill":
        # A prefill server's engine runs detached prefills only.
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
    log.info("serving %s on %s:%d (%s, %s)", cfg.name, args.host,
             server.port, engine.device, args.disagg or "unified")
    # A timed wait: a signal delivered to another thread runs its handler
    # only once the main thread next runs Python code.
    while not done.wait(0.1):
        pass
    server.stop()
    engine.stop()
    log.info("stopped")


if __name__ == "__main__":
    main()
