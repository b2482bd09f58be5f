"""Runnable SFT / fine-tune trainer: data pipeline + train step + resume —
the port of ``python -m arks_tpu.train``.

    python -m arks_tpu_torch.train --model qwen2.5-0.5b --data corpus.jsonl \
        --seq-len 512 --batch-size 8 --steps 1000 --ckpt-dir /tmp/run1

Ties the training subsystem together end to end: ``PackedDataset``
(tokenize/pack/shard/prefetch — train/data.py), the train step
(train/sft.py) and checkpoint/resume (train/checkpoint.py).  Restarting
with the same --ckpt-dir resumes from the latest step, bit-identical to an
uninterrupted run (the data pipeline's deterministic (seed, shard, epoch)
streams make the replay line up).  The reference's flags, defaults and log
lines, except that ``--platform`` is ``--device``: CUDA by default, ``cpu``
for the tests; with no GPU and no ``--device cpu`` the trainer raises.
Parallel sizes above 1 raise: the port's parallelism is still to come
(ROADMAP queue 1, parallelism).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

log = logging.getLogger("arks_tpu_torch.train")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("arks_tpu_torch.train")
    p.add_argument("--model", required=True,
                   help="model config name (arks_tpu_torch.models)")
    p.add_argument("--model-path", default=None,
                   help="init from weights/tokenizer dir (default: random "
                        "init + byte tokenizer)")
    p.add_argument("--data", required=True, action="append",
                   help="jsonl file(s): {'text'} or {'prompt','completion'}")
    p.add_argument("--seq-len", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=8,
                   help="GLOBAL batch per step (split over data parallel)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tensor-parallel", "--tp", type=int, default=None,
                   dest="tp")
    p.add_argument("--data-parallel", "--dp", type=int, default=1, dest="dp")
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint directory (enables save + resume)")
    p.add_argument("--ckpt-every", type=int, default=100)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu (for the tests)")
    return p.parse_args(argv)


def _fence(args: argparse.Namespace) -> None:
    """The resume fence: the fast-forward replay is only bit-identical when
    the data-shaping arguments match the original run — a silently
    different stream would re-train some windows and skip others."""
    shape = {"model": args.model, "data": sorted(args.data),
             "seq_len": args.seq_len, "batch_size": args.batch_size,
             "seed": args.seed}
    fence = os.path.join(args.ckpt_dir, "trainer_config.json")
    if os.path.exists(fence):
        with open(fence) as f:
            prev = json.load(f)
        if prev != shape:
            diff = {k: (prev.get(k), shape[k]) for k in shape
                    if prev.get(k) != shape[k]}
            raise SystemExit(
                f"--ckpt-dir {args.ckpt_dir} was written with different "
                f"data-shaping args (stored vs given): {diff} — resume "
                "would not replay the same stream; use a fresh dir or "
                "the original arguments")
    else:
        os.makedirs(args.ckpt_dir, exist_ok=True)
        with open(fence, "w") as f:
            json.dump(shape, f)


def main(argv=None) -> None:
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    import torch

    from arks_tpu_torch.device import resolve_device
    from arks_tpu_torch.engine.tokenizer import ByteTokenizer, load_tokenizer
    from arks_tpu_torch.models import get_config
    from arks_tpu_torch.train.checkpoint import (
        make_manager, restore_train_state, save_train_state)
    from arks_tpu_torch.train.data import PackedDataset, prefetch, read_jsonl
    from arks_tpu_torch.train.sft import (
        TrainState, adamw, make_train_step, train_init)

    if (args.tp or 1) * args.dp > 1:
        raise NotImplementedError(
            f"--tensor-parallel {args.tp} x --data-parallel {args.dp}: "
            "parallelism arrives with the parallelism slice (ROADMAP "
            "queue 1, parallelism)")
    device = resolve_device(args.device)
    cfg = get_config(args.model)
    tokenizer = (load_tokenizer(args.model_path)
                 if args.model_path else ByteTokenizer())
    if args.ckpt_every < 1 or args.log_every < 1:
        raise SystemExit("--ckpt-every and --log-every must be >= 1")

    optimizer = adamw(args.lr, weight_decay=args.weight_decay)
    step_fn = make_train_step(cfg, optimizer)

    manager = make_manager(args.ckpt_dir) if args.ckpt_dir else None
    if args.ckpt_dir:
        _fence(args)
    if manager is not None and manager.latest_step() is not None:
        state = restore_train_state(manager, cfg, optimizer, device)
        log.info("resumed from step %d (%s)", state.step, args.ckpt_dir)
    elif args.model_path:
        from arks_tpu_torch.models.weights import load_params
        params = load_params(cfg, args.model_path, torch.float32,
                             device=device, seed=args.seed)
        state = TrainState(params, optimizer.init(params), 0)
    else:
        state = train_init(cfg, args.seed, optimizer, device)

    records = [r for path in args.data for r in read_jsonl(path)]
    # Single process, one device: the dataset is unsharded (multi-host
    # would pass process_index/process_count here).
    ds = PackedDataset(records, tokenizer, seq_len=args.seq_len,
                       batch_size=args.batch_size, seed=args.seed)

    start = state.step
    done = start
    bpe = ds.batches_per_epoch(0)
    if bpe == 0:
        raise SystemExit(
            f"corpus too small: {args.data} packs to fewer than "
            f"--batch-size {args.batch_size} windows of --seq-len "
            f"{args.seq_len} — zero steps per epoch")
    # Resume lands mid-epoch: fast-forward the deterministic stream.
    epoch, skip = divmod(start, bpe)
    t0 = time.monotonic()
    while done < args.steps:
        it = prefetch(ds.epoch(epoch))
        for i, batch in enumerate(it):
            if i < skip:
                continue
            state, loss = step_fn(
                state, *(torch.from_numpy(batch[k]).to(device)
                         for k in ("tokens", "targets", "loss_mask")))
            done += 1
            if done % args.log_every == 0 or done == args.steps:
                dt = time.monotonic() - t0
                toks = (done - start) * args.batch_size * args.seq_len
                log.info("step %d loss %.4f (%.0f tok/s)", done,
                         float(loss), toks / max(dt, 1e-6))
            if manager is not None and done % args.ckpt_every == 0:
                save_train_state(manager, state, wait=False)
            if done >= args.steps:
                break
        epoch += 1
        skip = 0
    if manager is not None:
        save_train_state(manager, state, wait=True)
        log.info("final checkpoint at step %d (%s)", done, args.ckpt_dir)


if __name__ == "__main__":
    main()
