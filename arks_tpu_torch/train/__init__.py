"""Training — the port of ``arks_tpu/train/``: the packed data pipeline
(``data``), the SFT step over the serving layer body with AdamW (``sft``),
checkpoint/resume in the port's own format (``checkpoint``), and the
trainer (``python -m arks_tpu_torch.train``)."""

from arks_tpu_torch.train.checkpoint import (
    make_manager, restore_train_state, save_train_state)
from arks_tpu_torch.train.data import PackedDataset, prefetch, read_jsonl
from arks_tpu_torch.train.sft import (
    TrainState, adamw, make_train_step, train_init)

__all__ = [
    "PackedDataset", "TrainState", "adamw", "make_manager",
    "make_train_step", "prefetch", "read_jsonl", "restore_train_state",
    "save_train_state", "train_init",
]
