"""Training input pipeline: tokenize, pack, shard, prefetch — the port's
copy of ``arks_tpu/train/data.py`` (which imports no JAX, but the port
imports nothing of ``arks_tpu``).  Windows, targets and loss masks equal
the reference's bit for bit for the same records, seed, epoch and shard.

- **Packing**: documents are tokenized, joined with EOS separators, and
  cut into fixed-length windows — every position trains (no padding
  waste).  Each window yields (tokens, targets, loss_mask): targets are
  tokens shifted left, with cross-document lookahead targets masked.
- **SFT masking**: records with a ``prompt``/``completion`` split mask
  the prompt positions so loss lands on completions only.
- **Sharding**: WINDOW-level round robin — every process packs the same
  shuffled stream and takes its ``shard_index``-th stripe, capped at
  ``floor(total_windows / shard_count)`` windows, so every data-parallel
  process yields EXACTLY the same number of batches per epoch (unequal
  counts would deadlock a collective train step at the epoch tail).
- **Determinism**: a seeded shuffle over the document order — the same
  (seed, shard, epoch) always yields the same batch stream, which is
  what makes checkpoint resume (train/checkpoint.py) reproducible end to
  end.
- **Prefetch**: a background thread keeps ``depth`` batches ready so
  host tokenization overlaps device steps; iterator errors re-raise in
  the consumer, and abandoning the generator releases the worker.
"""

from __future__ import annotations

import json
import queue
import random
import threading
from typing import Iterable, Iterator

import numpy as np


def read_jsonl(path: str) -> Iterator[dict]:
    """{"text": ...} or {"prompt": ..., "completion": ...} per line."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


class PackedDataset:
    """Tokenize + pack documents into fixed-length training windows.

    ``records`` is any iterable of dicts (``read_jsonl`` or an in-memory
    list); it is materialized once so epochs can reshuffle.
    """

    def __init__(self, records: Iterable[dict], tokenizer, seq_len: int,
                 batch_size: int, seed: int = 0,
                 shard_index: int = 0, shard_count: int = 1):
        if not (0 <= shard_index < shard_count):
            raise ValueError(
                f"shard_index={shard_index} outside shard_count={shard_count}")
        self.tokenizer = tokenizer
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.seed = seed
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.records = list(records)
        if not self.records:
            raise ValueError("dataset is empty")
        self.eos = (tokenizer.eos_token_ids or (0,))[0]
        # Tokenize ONCE (order-independent): epochs only reshuffle+repack,
        # so multi-epoch runs and resume fast-forward never re-pay the
        # tokenizer.
        self._docs = [self._doc_tokens(r) for r in self.records]
        self._window_cache: tuple[int, list] | None = None

    def _doc_tokens(self, rec: dict) -> tuple[list[int], list[int]]:
        """(token_ids, loss_mask) for one document, EOS-terminated."""
        if "prompt" in rec:
            p = self.tokenizer.encode(rec["prompt"])
            c = self.tokenizer.encode(rec.get("completion", ""))
            ids = p + c + [self.eos]
            # SFT: loss on completion + EOS only, never on the prompt.
            mask = [0] * len(p) + [1] * (len(c) + 1)
        else:
            ids = self.tokenizer.encode(rec.get("text", "")) + [self.eos]
            mask = [1] * len(ids)
        return ids, mask

    def _windows(self, epoch: int) -> list[tuple[list[int], list[int],
                                                 list[int]]]:
        """All (tokens, targets, loss_mask) windows of the epoch's shuffled
        stream (shard-independent — the basis every shard stripes over)."""
        # One-epoch memo: the trainer's startup batches_per_epoch() and
        # the first epoch() pack the same windows.
        if self._window_cache is not None and \
                self._window_cache[0] == epoch:
            return self._window_cache[1]
        order = list(range(len(self.records)))
        random.Random(f"{self.seed}/{epoch}").shuffle(order)
        t = self.seq_len
        buf_ids: list[int] = []
        buf_mask: list[int] = []
        out = []
        for i in order:
            ids, mask = self._docs[i]
            buf_ids.extend(ids)
            buf_mask.extend(mask)
            while len(buf_ids) > t:  # need t+1 to form targets for t
                window = buf_ids[: t + 1]
                wmask = buf_mask[: t + 1]
                del buf_ids[:t], buf_mask[:t]
                # Loss applies where the TARGET is a trainable position.
                out.append((window[:t], window[1: t + 1], wmask[1: t + 1]))
        self._window_cache = (epoch, out)
        return out

    def batches_per_epoch(self, epoch: int = 0) -> int:
        """Identical on every shard — the number of collective train steps
        each process will run for this epoch."""
        n = len(self._windows(epoch)) // self.shard_count
        return n // self.batch_size

    def epoch(self, epoch: int = 0) -> Iterator[dict[str, np.ndarray]]:
        """Yield {"tokens", "targets", "loss_mask"} batches
        ([B, T] int32 / int32 / float32), deterministically per
        (seed, shard, epoch).  Every shard yields the SAME batch count
        (windows are capped at floor(total/shard_count) per shard); the
        remainder is dropped, like the tail that doesn't fill a window —
        both reappear under another epoch's shuffle."""
        windows = self._windows(epoch)
        per_shard = len(windows) // self.shard_count
        mine = windows[self.shard_index:: self.shard_count][:per_shard]
        b = self.batch_size
        for start in range(0, per_shard - b + 1, b):
            rows = mine[start: start + b]
            yield {
                "tokens": np.asarray([r[0] for r in rows], np.int32),
                "targets": np.asarray([r[1] for r in rows], np.int32),
                "loss_mask": np.asarray([r[2] for r in rows], np.float32),
            }


def prefetch(batches: Iterator[dict], depth: int = 2) -> Iterator[dict]:
    """Run the batch iterator in a background thread, ``depth`` batches
    ahead — host tokenization/packing overlaps device train steps.

    Iterator exceptions RE-RAISE in the consumer (a crash mid-epoch must
    not masquerade as a short epoch), and closing/abandoning the
    generator unblocks and ends the worker."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    cancel = threading.Event()
    done = object()

    def _put(item) -> bool:
        while not cancel.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for b in batches:
                if not _put(b):
                    return
            _put(done)
        except BaseException as e:  # re-raised consumer-side
            _put(e)

    threading.Thread(target=worker, name="data-prefetch",
                     daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        cancel.set()  # consumer gone: release a worker blocked on put
