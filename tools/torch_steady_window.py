#!/usr/bin/env python3
"""Show on the GPU what ``chip_smoke.py``'s steady launch-count windows
see: on Qwen2.5-7B bf16 at full width on random weights from ``SEED``, an
engine of ``phase_operability``'s shape (8 slots, bf16 pool, pipeline
depth 2) runs ``_pipe_batch``'s 8-stream window of OPS_WINDOW steps six
times, in turns without a lead-in (the whole profiler session counted)
and with OPS_LEAD_IN lead-in steps (only the window's steps, between two
marker kernels, counted: what ``_steady_launches`` does).  For each
window it prints the launches per step, the events counted and the
events of the whole session, then each window's launches by kernel name
less the first bracketed window's.  Last, ``phase_zero`` runs against the
first bracketed window.

    python3 tools/torch_steady_window.py
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    from arks_tpu_torch.engine import EngineConfig, InferenceEngine
    from arks_tpu_torch.engine.tokenizer import ByteTokenizer
    from arks_tpu_torch.models import get_config
    from arks_tpu_torch.models import transformer as tf
    if not torch.cuda.is_available():
        print("torch_steady_window: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cs.phase_device(torch)
    cs.phase_build()
    params = tf.init_params(get_config(cs.MODEL), cs.SEED, torch.bfloat16,
                            dev)
    whole = []
    counts = cs._trace_counts

    def traced(torch, prof, bracket=False):
        whole.append(sum(counts(torch, prof)[0].values()))
        return counts(torch, prof, bracket)

    cs._trace_counts = traced
    engine = InferenceEngine(get_config(cs.MODEL), EngineConfig(
        model=cs.MODEL, num_slots=8, max_cache_len=cs.MAX_PAGES * cs.PAGE,
        prefill_chunk=cs.PAGE, dtype="bfloat16", kv_cache_dtype="bf16",
        seed=cs.SEED), ByteTokenizer(), params=params, device=dev)
    cs._pipe_batch(torch, engine, ["warm"] * 8, 8)
    prompts = [f"steady window stream {j}" for j in range(8)]
    rows = []
    for lead in (0, cs.OPS_LEAD_IN) * 3:
        _, _, win = cs._pipe_batch(
            torch, engine, prompts, 2 * cs.OPS_WINDOW + 32, window=True,
            window_steps=cs.OPS_WINDOW, lead_in=lead)
        rows.append(dict(lead_in=lead, per_step=win[2],
                         counted=sum(win[3].values()), session=whole[-1],
                         host_ms=win[0], names=win[3]))
    cs._trace_counts = counts
    base = rows[1]["names"]
    for row in rows:
        names = row.pop("names")
        row["less_first_bracketed"] = {
            k[:70]: names[k] - base[k] for k in names | base
            if names[k] != base[k]}
        print(json.dumps(row), flush=True)
    ops = dict(launches_per_step=(rows[1]["per_step"],) * 2,
               host_ms_per_step=(rows[1]["host_ms"], 0.0),
               steady_names=base)
    del engine
    torch.cuda.empty_cache()
    res = cs.phase_zero(torch, dev, ops)
    print(json.dumps({"zero_steady": res["steady"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
