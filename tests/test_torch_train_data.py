"""The port's training data pipeline (``arks_tpu_torch/train/data.py``)
against the reference's (``arks_tpu/train/data.py``): windows, targets and
loss masks equal bit for bit for the same records, seed, epoch and shard;
SFT prompt masking; disjoint, equal and covering shards; prefetch."""

import json
import threading
import time

import numpy as np
import pytest

from arks_tpu.engine.tokenizer import ByteTokenizer as RefByteTokenizer
from arks_tpu.train import data as ref_data
from arks_tpu_torch.engine.tokenizer import ByteTokenizer
from arks_tpu_torch.train.data import PackedDataset, prefetch, read_jsonl


def _records(n=40):
    recs = [{"text": f"document number {i} " + "x" * (i % 17)}
            for i in range(n)]
    recs += [{"prompt": f"Q{i}: what?", "completion": f" A: {'y' * i}"}
             for i in range(n // 4)]
    return recs


def _batches(ds, epoch):
    return [{k: v.copy() for k, v in b.items()} for b in ds.epoch(epoch)]


@pytest.mark.parametrize("seed,seq_len,batch,shards", [
    (0, 32, 2, 1), (3, 16, 4, 1), (7, 24, 1, 3), (11, 13, 2, 2)])
def test_batches_equal_the_reference_bit_for_bit(seed, seq_len, batch,
                                                 shards):
    recs = _records()
    for shard in range(shards):
        mine = PackedDataset(recs, ByteTokenizer(), seq_len, batch,
                             seed=seed, shard_index=shard,
                             shard_count=shards)
        ref = ref_data.PackedDataset(recs, RefByteTokenizer(), seq_len,
                                     batch, seed=seed, shard_index=shard,
                                     shard_count=shards)
        for epoch in range(3):
            assert mine.batches_per_epoch(epoch) == \
                ref.batches_per_epoch(epoch)
            got, want = _batches(mine, epoch), _batches(ref, epoch)
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                assert g.keys() == w.keys()
                for k in g:
                    assert g[k].dtype == w[k].dtype
                    assert g[k].tobytes() == w[k].tobytes(), (epoch, k)


def test_sft_prompt_masking():
    """prompt/completion records train on completions (+EOS) only."""
    tok = ByteTokenizer()
    recs = [{"prompt": "Q: abc", "completion": " A: de"}] * 8
    ds = PackedDataset(recs, tok, seq_len=13, batch_size=1, seed=0)
    plen = len(tok.encode("Q: abc"))
    batch = next(iter(ds.epoch(0)))
    toks = batch["tokens"][0].tolist()
    mask = batch["loss_mask"][0].tolist()
    assert toks[:plen] == tok.encode("Q: abc")
    assert mask[: plen - 1] == [0.0] * (plen - 1)
    assert mask[plen - 1: -1] == [1.0] * (13 - plen)
    assert mask[-1] == 0.0  # the next document's prompt token


def test_shards_are_disjoint_equal_and_cover():
    tok = ByteTokenizer()
    recs = _records(30)
    windows = PackedDataset(recs, tok, seq_len=16, batch_size=2,
                            seed=1)._windows(0)
    per_shard = len(windows) // 3
    counts, seen = [], []
    for s in range(3):
        ds = PackedDataset(recs, tok, seq_len=16, batch_size=2, seed=1,
                           shard_index=s, shard_count=3)
        batches = list(ds.epoch(0))
        counts.append(len(batches))
        assert len(batches) == ds.batches_per_epoch(0)
        rows = [row.tolist() for b in batches for row in b["tokens"]]
        assert rows == [w[0] for w in windows[s::3][:per_shard]][:len(rows)]
        seen += [s + 3 * i for i in range(len(rows))]
    assert counts[0] > 0 and len(set(counts)) == 1
    assert len(seen) == len(set(seen))          # disjoint by position
    with pytest.raises(ValueError, match="shard_index"):
        PackedDataset(recs, tok, 16, 1, shard_index=3, shard_count=3)
    with pytest.raises(ValueError, match="empty"):
        PackedDataset([], tok, 16, 1)


def test_window_memo_serves_one_epoch():
    ds = PackedDataset(_records(), ByteTokenizer(), 24, 2, seed=5)
    first = ds._windows(0)
    assert ds._windows(0) is first
    assert ds._windows(1) is not first and ds._windows(0) is not first


def test_prefetch_propagates_errors_and_releases_worker():
    def boom():
        yield {"tokens": np.zeros((1, 4), np.int32)}
        raise RuntimeError("malformed record")

    it = prefetch(boom(), depth=2)
    next(it)
    with pytest.raises(RuntimeError, match="malformed record"):
        next(it)

    n_before = threading.active_count()
    many = prefetch(iter([{"i": i} for i in range(100)]), depth=1)
    next(many)
    many.close()      # abandoned: the cancel flag releases the worker
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and \
            threading.active_count() > n_before:
        time.sleep(0.02)
    assert threading.active_count() <= n_before


def test_read_jsonl_and_prefetch(tmp_path):
    path = tmp_path / "d.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in _records(12))
                    + "\n\n")
    ds = PackedDataset(read_jsonl(str(path)), ByteTokenizer(), seq_len=16,
                       batch_size=2, seed=0)
    assert ds.records == list(ref_data.read_jsonl(str(path)))
    direct = [b["tokens"] for b in ds.epoch(0)]
    fetched = [b["tokens"] for b in prefetch(ds.epoch(0), depth=2)]
    assert len(direct) == len(fetched) > 0
    assert all(np.array_equal(x, y) for x, y in zip(direct, fetched))
