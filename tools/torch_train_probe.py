#!/usr/bin/env python3
"""Measure on the GPU the choices behind the port's trainer
(``arks_tpu_torch/train/``), each beside its alternative:

1. the disk: 4 GiB written, synced and read back;
2. ``torch.save`` of 6 x 1.5 GiB f32 tensors on the card, with the
   defaults and with ``torch.utils.serialization.config.save``'s
   ``compute_crc32=False`` / ``use_pinned_memory_for_d2h=True`` (what
   ``checkpoint._fast_save`` sets), and the same tensors copied to fresh
   pageable and fresh pinned host memory (``checkpoint.host_copy``);
3. the embedding gather's backward at Qwen2.5-1.5B's table (151,936 x
   1,536 f32) over 8 x 512 byte-level ids, by indexing and by
   ``F.embedding``: whether 5 runs repeat bit for bit, and their ms;
4. a child process's start: seconds to reach the card, and to construct
   ``torch.optim.AdamW`` (which imports ``torch._dynamo``) against the
   port's ``sft.adamw(...).init``;
5. one optimizer update's peak device memory over Qwen2-57B-A14B cut to 1
   layer (params and gradients of 3.1e9 f32 parameters, the moments
   beside them): ``torch.optim.AdamW`` with ``foreach`` against the
   port's leaf-by-leaf ``AdamW.update``, from the same state.

Prints one line per measurement and a JSON object last.

    python3 tools/torch_train_probe.py
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

GIB = 1 << 30


def log(msg: str) -> None:
    print(f"[train probe] {msg}", flush=True)


def disk() -> dict:
    d = tempfile.mkdtemp(prefix="train-probe-")
    try:
        buf = os.urandom(64 << 20)
        path = os.path.join(d, "f")
        t0 = time.perf_counter()
        with open(path, "wb") as f:
            for _ in range(64):
                f.write(buf)
            t1 = time.perf_counter()
            os.fsync(f.fileno())
        t2 = time.perf_counter()
        with open(path, "rb") as f:
            while f.read(64 << 20):
                pass
        t3 = time.perf_counter()
    finally:
        shutil.rmtree(d)
    out = dict(write_s=t1 - t0, fsync_s=t2 - t1, read_s=t3 - t2)
    log(f"disk: 4 GiB written in {out['write_s']:.2f} s, synced in "
        f"{out['fsync_s']:.2f} s, read back in {out['read_s']:.2f} s")
    return out


def saves(torch, dev) -> dict:
    from torch.utils.serialization import config

    from arks_tpu_torch.train.checkpoint import host_copy
    ts = {f"t{i}": torch.randn(384 << 20, device=dev) for i in range(6)}
    nbytes = sum(t.numel() * t.element_size() for t in ts.values())
    d = tempfile.mkdtemp(prefix="train-probe-")
    out = {}

    def timed(tag, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out[tag] = nbytes / secs / 1e9
        log(f"{tag}: {secs:.2f} s, {out[tag]:.2f} GB/s")

    old = config.save.compute_crc32, config.save.use_pinned_memory_for_d2h
    try:
        for crc, pinned in ((True, False), (False, True), (True, False),
                            (False, True)):
            config.save.compute_crc32 = crc
            config.save.use_pinned_memory_for_d2h = pinned
            path = os.path.join(d, "s.pt")
            timed(f"torch.save crc={crc} pinned={pinned}",
                  lambda: torch.save(ts, path))
            os.remove(path)
    finally:
        config.save.compute_crc32, config.save.use_pinned_memory_for_d2h = old
        shutil.rmtree(d)
    timed("host copy, fresh pageable",
          lambda: [t.to("cpu") for t in ts.values()])
    timed("host copy, fresh pinned (host_copy)",
          lambda: [host_copy(t) for t in ts.values()])
    return out


def gathers(torch, dev) -> dict:
    torch.manual_seed(0)
    table = torch.randn(151936, 1536, device=dev, requires_grad=True)
    ids = torch.randint(2, 258, (8, 512), device=dev)
    grad = torch.randn(8, 512, 1536, device=dev)
    out = {}
    for tag, fn in (("index", lambda: table[ids]),
                    ("F.embedding",
                     lambda: torch.nn.functional.embedding(ids, table))):
        runs, ms = [], []
        for _ in range(5):
            table.grad = None
            y = fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y.backward(grad)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            runs.append(table.grad.clone())
        same = all(torch.equal(runs[0], r) for r in runs)
        out[tag] = dict(bit_identical=same, ms=ms)
        log(f"{tag} backward: 5 runs bit-identical {same}; ms "
            f"{[round(m, 2) for m in ms]}")
        del runs
    return out


_CHILD = """
import time
t0 = time.perf_counter()
import torch
torch.zeros(1, device="cuda").sum().item()
t1 = time.perf_counter()
from arks_tpu_torch.train import sft
p = [torch.zeros(4, device="cuda")]
sft.adamw(1e-3).init({"w": p[0]})
t2 = time.perf_counter()
torch.optim.AdamW([torch.zeros(4, device="cuda", requires_grad=True)],
                  foreach=True)
t3 = time.perf_counter()
print(t1 - t0, t2 - t1, t3 - t2)
"""


def child() -> dict:
    r = subprocess.run([sys.executable, "-c", _CHILD], capture_output=True,
                       text=True, check=True, timeout=300, cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=str(REPO)))
    card, port, optim = map(float, r.stdout.split())
    log(f"a child process: {card:.2f} s to reach the card; then the port's "
        f"AdamW init {port:.2f} s, torch.optim.AdamW's constructor "
        f"{optim:.2f} s")
    return dict(card_s=card, port_adamw_s=port, torch_adamw_s=optim)


def updates(torch, dev) -> dict:
    from arks_tpu_torch.models import get_config
    from arks_tpu_torch.train import sft
    cfg = dataclasses.replace(get_config("qwen2-57b-a14b"), num_layers=1)
    out = {}
    for tag in ("torch.optim.AdamW foreach", "port AdamW.update"):
        state = sft.train_init(cfg, 0, sft.adamw(1e-4), dev)
        leaves = sft.named_leaves(state.params)
        for _, p in leaves:
            p.grad = torch.full_like(p, 1e-3)
        if tag.startswith("torch"):
            opt = torch.optim.AdamW(
                [p for _, p in leaves], lr=1e-4, betas=(0.9, 0.999),
                eps=1e-8, weight_decay=1e-4, foreach=True)
            for (name, p) in leaves:       # the same moments as the port's
                opt.state[p] = {"step": torch.tensor(0.0),
                                "exp_avg": state.opt_state.mu[name],
                                "exp_avg_sq": state.opt_state.nu[name]}
            step = opt.step
        else:
            def step():
                sft.adamw(1e-4).update(state.params, state.opt_state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step()
        torch.cuda.synchronize()
        out[tag] = torch.cuda.max_memory_allocated() - base
        log(f"one update over {cfg.name} x1 layer: {tag} peak +"
            f"{out[tag]} B above the state and gradients ({base} B)")
        del state, leaves, step
        if tag.startswith("torch"):
            del opt
        torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_train_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    log(smi)
    res = dict(device=smi, disk=disk(), saves=saves(torch, dev),
               gathers=gathers(torch, dev), child=child(),
               updates=updates(torch, dev))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
