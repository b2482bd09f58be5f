#!/usr/bin/env python3
"""Time the port's redesigned kernels of one source tree on the GPU, at
``chip_smoke.py``'s shapes, so two trees can be compared inside one call
to the card: the mixed attention (phase 3's mixed batch over bf16, int8
and int4 pools, its dense launch, and the batch's 8 decode lanes alone),
``grouped_matmul`` (bf16 / int8 / int4 weights at Mixtral-8x7B's gate and
down shapes, over the 528-row mixed batch and the 16-row decode batch)
and the two decode attentions (bf16 and int8, phase 3's slot cache and
paged pool).  Each time is chip_smoke's ``_time_ms``: the CUDA-event mean
over 20 launches, L2 flushed before each.

The four row writes (``paged_kv_update``, ``paged_kv_update_quant`` into
int8 and int4 pools at phase 3's batch, ``kv_cache_update`` and
``kv_cache_update_quant`` at its slot cache) get the cold time above
("cold"), the profiler's device µs with L2 warm ("warm_us") and the
wrapper's host µs per call with no sync over 5 runs of 1000 calls (their
median "host_us" and least "host_min_us"); the paged ones also the warm
device µs at a served decode step's 8 tokens ("step ... warm_us").  The
paged writes are timed through write_idx / tables and, where the tree has
``paged_write_rows``, through the step's destinations (``dst``).  "launch floor" is an empty kernel
(``torch.cuda._sleep(0)``) timed cold, and its "warm_us" by the profiler.

``--legacy-step`` instead profiles the served legacy decode step alone
(``chip_smoke.phase_decode_profile``: K = 4 steps over 8 slots at context
512, Qwen2.5-7B at full width on random bf16 weights, a bf16 and an int8
slot cache): host and device ms per step, kernel launches per step, and
the device µs per step of the slot write and of the decode attention's
kernels.

    python3 tools/torch_kernel_compare.py --root DIR [--out FILE]
        [--mixed-only | --updates-only | --legacy-step]

``DIR`` is the root of the tree whose ``arks_tpu_torch`` is timed (its
kernels build into DIR/build/); this script and the helpers it borrows
from ``chip_smoke.py`` come from the tree that holds it.  Prints one JSON
object {"root", "device", "times": {name: ms}}.  Run two trees in turns
(A, B, B, A) and compare within the call."""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--out")
    ap.add_argument("--mixed-only", action="store_true",
                    help="time the mixed attention alone")
    ap.add_argument("--updates-only", action="store_true",
                    help="time the row writes alone")
    ap.add_argument("--legacy-step", action="store_true",
                    help="profile the served legacy decode step alone")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_compare: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from arks_tpu_torch.models import get_config
    from arks_tpu_torch.ops import moe_kernel as mk
    from arks_tpu_torch.ops import paged_attention as pa
    from arks_tpu_torch.ops import pallas_attention as pl
    assert Path(mk.__file__).resolve().is_relative_to(root), mk.__file__
    dev = torch.device("cuda", 0)
    if args.legacy_step:
        return _report(root, _legacy_step(cs, torch, dev), args.out)
    times = {}

    b = cs.kernel_batch(torch, dev)
    lane = (b["tables"], b["seq_q_start"], b["seq_q_len"],
            b["seq_pos_start"])
    hkv, layer = b["k_pool"].shape[2], b["layer"]
    qmax = int(b["seq_q_len"].max().item())
    b["pools_before"] = b["k_pool"], b["v_pool"]
    pools = {"bf16": dict(k_pool=b["k_pool"], v_pool=b["v_pool"])}
    for kv in ("int8", "int4"):
        qp = cs.quant_pools(b, kv)
        pools[kv] = dict(k_pool=qp["k_pool"], v_pool=qp["v_pool"],
                         k_scale=qp["k_scale"], v_scale=qp["v_scale"])
    dec = b["seq_q_len"].clone()
    dec[8:] = 0
    if not args.mixed_only:
        times.update(_row_writes(cs, torch, dev, pa, pl, b, pools))
    if args.updates_only:
        return _report(root, times, args.out)

    def mixed(kv, grid="ragged", q_len=None):
        p = pools[kv]
        ql = b["seq_q_len"] if q_len is None else q_len
        work = pa.mixed_work(lane[0], lane[1], ql, lane[3], page=cs.PAGE,
                             hkv=hkv, qmax=qmax if q_len is None else 1,
                             grid=grid)
        return lambda: pa.paged_mixed_attention(
            b["q"], p["k_pool"], p["v_pool"], lane[0], lane[1], ql,
            lane[3], layer, k_scale=p.get("k_scale"),
            v_scale=p.get("v_scale"), work=work)

    cases = {f"paged_mixed_attention {kv}": mixed(kv)
             for kv in ("bf16", "int8", "int4")}
    cases["paged_mixed_attention_dense bf16"] = mixed("bf16", "dense")
    cases["paged_mixed_attention decode-only bf16"] = mixed("bf16",
                                                            q_len=dec)
    for name, fn in cases.items():
        times[name] = cs._time_ms(torch, fn)
    del b, pools, cases
    torch.cuda.empty_cache()
    if args.mixed_only:
        return _report(root, times, args.out)

    b = cs.slot_batch(torch, dev)
    q, layer = b["q"], b["layer"]
    args_slot = (b["lengths"], layer)
    args_paged = (b["tables"], b["paged_lengths"], layer)
    sq = cs._int8(pa, (b["k_cache"], b["v_cache"]))
    pq = cs._int8(pa, (b["k_pool"], b["v_pool"]))
    cases = {
        "ragged_decode_attention bf16": lambda: pl.ragged_decode_attention(
            q, b["k_cache"], b["v_cache"], *args_slot),
        "ragged_decode_attention int8": lambda: pl.ragged_decode_attention(
            q, sq[0], sq[1], *args_slot, k_scale=sq[2], v_scale=sq[3]),
        "paged_decode_attention bf16": lambda: pa.paged_decode_attention(
            q, b["k_pool"], b["v_pool"], *args_paged),
        "paged_decode_attention int8": lambda: pa.paged_decode_attention(
            q, pq[0], pq[1], *args_paged, k_scale=pq[2], v_scale=pq[3]),
    }
    for name, fn in cases.items():
        times[name] = cs._time_ms(torch, fn)
    del b, sq, pq, cases
    torch.cuda.empty_cache()

    cfg = get_config(cs.MOE_MODEL)
    e, fm, nx = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts
    takes_rows = "tile_rows" in inspect.signature(mk.grouped_matmul).parameters
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    for shape, (k, n) in (("gate", (e, fm)), ("down", (fm, e))):
        batches = {}
        for batch in ("528-row", "decode"):
            sizes = cs.MOE_BATCHES[batch]
            gs = torch.as_tensor(sizes, device=dev)
            se = torch.repeat_interleave(torch.arange(nx, device=dev), gs)
            xs = torch.randn((sum(sizes), k), generator=gen,
                             device=dev).to(torch.bfloat16)
            xs_p, _, bexp = mk.pad_groups(xs, se, gs)
            kw = dict(rows_used=mk.rows_used(gs))
            if takes_rows:
                kw["tile_rows"] = mk.tile_rows(gs, bexp.shape[0])
            batches[batch] = (xs_p, bexp, kw)
        for mode in ("bf16", "int8", "int4"):
            w, wkw, _ = cs._moe_weight(torch, dev, mode, (nx, k, n), gen)
            for batch, (xs_p, bexp, kw) in batches.items():
                times[f"grouped_matmul {mode} {shape} {batch}"] = cs._time_ms(
                    torch, lambda: mk.grouped_matmul(xs_p, w, bexp, **kw,
                                                     **wkw))
            del w, wkw
            torch.cuda.empty_cache()
    return _report(root, times, args.out)


def _row_writes(cs, torch, dev, pa, pl, b, pools) -> dict:
    """The row writes' numbers (see the module's docstring)."""
    layer = b["layer"]
    has_dst = hasattr(pa, "paged_write_rows")

    def entries(batch):
        """{entry point: (args after the pools, kwargs)} of one batch."""
        rows = (batch["k_new"], batch["v_new"])
        out = {"write_idx/tables": ((*rows, batch["write_idx"],
                                     batch["tables_tok"], layer), {})}
        if has_dst:
            dst = pa.paged_write_rows(batch["write_idx"],
                                      batch["tables_tok"], cs.PAGE,
                                      b["k_pool"].shape[1])
            out["dst"] = ((*rows, None, None, layer), dict(dst=dst))
        return out

    # A served decode step: 8 tokens at context 512, one per lane.
    step = dict(k_new=b["k_new"][:8], v_new=b["v_new"][:8],
                write_idx=torch.full((8,), 512, dtype=torch.int32,
                                     device=dev),
                tables_tok=b["tables"][:8])
    fns = {}
    for batch, tag in ((b, ""), (step, "step ")):
        for e, (a, kw) in entries(batch).items():
            fns[f"{tag}paged_kv_update [{e}]"] = (
                lambda a=a, kw=kw: pa.paged_kv_update(
                    b["k_pool"], b["v_pool"], *a, **kw),
                "paged_kv_update_kernel")
            for kv in ("int8", "int4"):
                p = pools[kv]
                fns[f"{tag}paged_kv_update_quant {kv} [{e}]"] = (
                    lambda a=a, kw=kw, p=p: pa.paged_kv_update_quant(
                        p["k_pool"], p["v_pool"], p["k_scale"],
                        p["v_scale"], *a, **kw),
                    "paged_kv_update_quant_kernel")
    slot = cs.slot_batch(torch, dev)
    rows = (slot["k_new"], slot["v_new"], slot["write_idx"], slot["layer"])
    sq = cs._int8(pa, (slot["k_cache"], slot["v_cache"]))
    fns["kv_cache_update"] = (lambda: pl.kv_cache_update(
        slot["k_cache"], slot["v_cache"], *rows), "kv_cache_update_kernel")
    fns["kv_cache_update_quant"] = (lambda: pl.kv_cache_update_quant(
        *sq, *rows), "kv_cache_update_quant_kernel")
    empty = lambda: torch.cuda._sleep(0)  # noqa: E731
    times = {"launch floor": cs._time_ms(torch, empty),
             "launch floor warm_us": cs._device_us(torch, empty,
                                                   "spin_kernel")}
    for name, (fn, kernel) in fns.items():
        if name.startswith("step "):
            times[f"{name} warm_us"] = cs._device_us(torch, fn, kernel)
            continue
        times[f"{name} cold"] = cs._time_ms(torch, fn)
        times[f"{name} warm_us"] = cs._device_us(torch, fn, kernel)
        times[f"{name} host_us"], times[f"{name} host_min_us"] = \
            cs._host_us(torch, fn)
    return times


def _legacy_step(cs, torch, dev) -> dict:
    """The served legacy decode step's numbers (see the module's
    docstring); kernels by their function name."""
    from arks_tpu_torch.models import get_config
    from arks_tpu_torch.models import transformer as tf
    cfg = get_config(cs.MODEL)
    engine = SimpleNamespace(cfg=cfg, params=tf.init_params(
        cfg, cs.SEED, torch.bfloat16, dev))
    times = {}
    for kv in ("bf16", "int8"):
        host_ms, device_ms, per, launches = cs.phase_decode_profile(
            torch, dev, engine, kv)
        times[f"legacy step {kv} host_ms"] = host_ms
        times[f"legacy step {kv} device_ms"] = device_ms
        times[f"legacy step {kv} launches"] = launches
        for key, us in per.items():
            name = re.search(r"\w*kernel\w*", key)
            times[f"legacy step {kv} {name[0] if name else key} us"] = us
    return times


def _report(root: Path, times: dict, out: str | None) -> int:
    """Print (and with ``out`` write) the JSON line of one tree's times."""
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    line = json.dumps({"root": str(root), "device": card.strip(),
                       "times": times})
    print(line, flush=True)
    if out:
        Path(out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
