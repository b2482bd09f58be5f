#!/usr/bin/env python3
"""Time one tree's classic mixed step for a short prompt on the GPU, so two
trees can be compared inside one call to the card: Qwen2.5-7B bf16 (or,
with ``--model mixtral``, Mixtral-8x7B with int8 weights) at full width on
random weights, ``chip_smoke.py``'s engine shape (8 slots x 4096, chunk
256, bf16 paged pool, pipeline depth 2).  One stream decodes while a
20-token prompt (``max_tokens`` 1) arrives, 12 times; the engine is driven
step by step from this thread.

It prints the flat batch's rows of the step that carried the prompt's
chunk (the tokens in use, or the fixed ``num_slots`` + chunk budget),
that ``mixed_step`` call's device µs and kernel launches (chip_smoke's
``_profile_step``: the profiler window that saw the most device events of
three) and host ms with a synchronise, and the time to first token on
the host clock (its median and least, the first two trials dropped).

    python3 tools/torch_rows_compare.py --root DIR [--model qwen|mixtral]

``DIR`` is the root of the tree whose ``arks_tpu_torch`` is timed (its
kernels build into DIR/build/); this script and the helpers it borrows
from ``chip_smoke.py`` come from the tree that holds it.  Prints one JSON
object.  Run two trees in turns (A, B, B, A) and compare within the call:
the host clock moves 1.5-2.5x between calls on a shared machine."""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
TRIALS, WARM_TRIALS, PROMPT_LEN = 12, 2, 20


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--model", choices=("qwen", "mixtral"), default="qwen")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("torch_rows_compare: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from arks_tpu_torch.engine import Request, SamplingParams
    from arks_tpu_torch.models import get_config
    from arks_tpu_torch.models import transformer as tf
    assert Path(tf.__file__).resolve().is_relative_to(root), tf.__file__
    dev = torch.device("cuda", 0)
    cs.phase_build()
    if args.model == "qwen":
        params = tf.init_params(get_config(cs.MODEL), cs.SEED,
                                torch.bfloat16, dev)
        engine = cs._pipe_engine(torch, dev, params, "mixed", "2", "1")
    else:
        engine, _ = cs._moe_engine(torch, dev, "int8")

    captured = []
    real = tf.mixed_step

    def spy(*a, **k):
        if k.get("qmax", 1) > 1:      # the step carries a prefill chunk
            captured[:] = [(a, k)]
        return real(*a, **k)

    tf.mixed_step = spy

    def drive_until(pred, limit=5000):
        for _ in range(limit):
            engine.step(block_s=0.001)
            if pred():
                return
        raise AssertionError("the engine made no progress")

    engine.add_request(Request(
        "background", [66 + i % 20 for i in range(40)],
        SamplingParams(max_tokens=3000, temperature=0.0, ignore_eos=True)))
    drive_until(lambda: bool(engine._slots))
    for _ in range(8):
        engine.step(block_s=0.001)
    ttft = []
    for trial in range(TRIALS):
        r = Request(f"short-{trial}",
                    [70 + (trial + j) % 23 for j in range(PROMPT_LEN)],
                    SamplingParams(max_tokens=1, temperature=0.0,
                                   ignore_eos=True))
        got = []

        def answered():
            while not r.outputs.empty():
                got.append(r.outputs.get_nowait())
            return bool(got)

        t0 = time.perf_counter()
        engine.add_request(r)
        drive_until(answered)
        ttft.append(time.perf_counter() - t0)
        drive_until(lambda: answered() and got[-1].finished)
        for _ in range(4):
            engine.step(block_s=0.001)
    tf.mixed_step = real
    a, k = captured[0]
    host_ms, dev_us, launches, _ = cs._profile_step(
        torch, lambda: real(*a, **k), 1)
    ttft = ttft[WARM_TRIALS:]
    print(json.dumps(dict(
        root=str(root), model=args.model, flat_rows=int(a[4].shape[0]),
        qmax=k.get("qmax"), step_device_us=dev_us, step_launches=launches,
        step_host_ms=host_ms, ttft_ms_median=statistics.median(ttft) * 1e3,
        ttft_ms_min=min(ttft) * 1e3,
        ttft_ms=[round(t * 1e3, 3) for t in ttft])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
