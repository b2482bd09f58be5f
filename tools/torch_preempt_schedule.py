#!/usr/bin/env python3
"""Show on the GPU how a guide's compile time moves ``chip_smoke.py``'s
``phase_preempt`` rounds: the baseline round (``_pre_engine`` with
``ARKS_PREEMPT=0`` at pipeline depth 2 on a bf16 pool, ``_pre_round``'s 8
batch streams of 512-token prompts, the last one guided by ``[a-f]+``,
and 2 latency arrivals) on Qwen2.5-7B bf16 at full width on random
weights from ``SEED``, six times on the same weights:

- ``first``: the guide compiled before the requests come in (what
  ``_pre_round`` does);
- ``queued``: compiled on the guide compiler's thread once the guided
  request is queued, so that the request parks if it is admitted before
  the compile published (what ``_pre_round`` did before);
- ``queued+0.3s`` / ``queued+0.8s``: the same with the compile held that
  much longer.

For each round it prints the chunk steps' count, the takes of the first
three chunk steps ((slot, tokens) per prompt prefilling), and a digest of
every chunk step's takes; then, for pairs of rounds, whether their chunk
layouts are equal and the first differing token of each stream that
differs.

    python3 tools/torch_preempt_schedule.py
"""

from __future__ import annotations

import hashlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402

# Round tags hold no "-": _pre_round names a stream by what follows the
# first "-" of its request id.
ROUNDS = (("first_a", "first", 0.0), ("queued_a", "queued", 0.0),
          ("first_b", "first", 0.0), ("queued_b", "queued", 0.0),
          ("queued+0.3s", "queued", 0.3), ("queued+0.8s", "queued", 0.8))
PAIRS = (("first_a", "first_b"), ("queued_a", "queued_b"),
         ("first_a", "queued_a"), ("queued_a", "queued+0.3s"),
         ("queued_a", "queued+0.8s"), ("queued+0.3s", "queued+0.8s"))


def one(torch, dev, params, tag, mode, delay):
    engine = cs._pre_engine(torch, dev, params, False)
    steps = []
    real_fill = engine._fill_chunk_lanes

    def fill(a, t):
        out = real_fill(a, t)
        if out[1]:
            steps.append(tuple(out[1]))
        return out

    engine._fill_chunk_lanes = fill
    if mode == "queued":
        # _pre_round's compile does nothing: the request's own ensure()
        # starts the compile on the compiler's thread.
        engine.guides.compile = lambda *guide: None
        if delay:
            real_build = engine.guides._build

            def slow(rx):
                time.sleep(delay)
                return real_build(rx)

            engine.guides._build = slow
    t0 = time.perf_counter()
    got = cs._pre_round(torch, engine, tag)[0]
    secs = time.perf_counter() - t0
    del engine._fill_chunk_lanes
    digest = hashlib.sha1(repr(steps).encode()).hexdigest()[:12]
    cs.log(f"[schedule {tag}] {secs:.1f} s; chunk steps {len(steps)}; "
           f"first three {steps[:3]}; layout {digest}")
    del engine
    torch.cuda.empty_cache()
    return {k: v[0] for k, v in got.items()}, digest


def first_differing(a: dict, b: dict) -> dict:
    out = {}
    for k in sorted(a):
        if a[k] != b[k]:
            out[k] = next((i for i, (x, y) in enumerate(zip(a[k], b[k]))
                           if x != y), min(len(a[k]), len(b[k])))
    return out


def main() -> int:
    import torch

    from arks_tpu_torch.models import get_config
    from arks_tpu_torch.models import transformer as tf
    if not torch.cuda.is_available():
        print("torch_preempt_schedule: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cs.phase_device(torch)
    cs.phase_build()
    params = tf.init_params(get_config(cs.MODEL), cs.SEED, torch.bfloat16,
                            dev)
    runs = {tag: one(torch, dev, params, tag, mode, delay)
            for tag, mode, delay in ROUNDS}
    rows = []
    for x, y in PAIRS:
        row = dict(a=x, b=y, layouts_equal=runs[x][1] == runs[y][1],
                   differing=first_differing(runs[x][0], runs[y][0]))
        cs.log(f"[schedule pair] {json.dumps(row)}")
        rows.append(row)
    print(json.dumps({"pairs": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
