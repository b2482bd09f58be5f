"""Training checkpoint/resume — the port of ``arks_tpu/train/checkpoint.py``
in the port's own format (the reference's Orbax imports jax).

Each step is a directory ``<dir>/<step>/`` holding ``state.pt``: a
``torch.save`` of named tensors — ``params/<leaf>``, the AdamW moments
``opt_state/mu/<leaf>`` and ``opt_state/nu/<leaf>``, the update count
``opt_state/count``, and ``step`` — read back with
``torch.load(weights_only=True)``.  The reference's guarantees:

- step-numbered retention (``max_to_keep``) and ``latest_step``.  A step
  is written under a temporary name and renamed, so a killed save leaves
  no half step; a step at or below the latest saved one is not saved
  again (Orbax's rule);
- ``save_train_state(wait=False)`` overlaps the write with later steps:
  it takes a host snapshot at once (pinned memory for a card's tensors)
  and writes it on a thread, which the next save and
  ``wait_until_finished`` join (and re-raise from);
- a resumed run is bit-identical to an uninterrupted one, in the
  checkpoint's own dtype: a bf16 run restores bf16 without the caller
  saying so;
- no double peak: the restore allocates the state with ``torch.empty``
  (no random draw) and fills it leaf by leaf from a memory-mapped load,
  so peak device memory is the state itself.

Writes skip the zip records' CRC32 and copy device storages through pinned
memory (``torch.utils.serialization.config``, set around each write):
3.0 GB/s from an H100 against 0.9 GB/s with the defaults (PERF.md).

An Orbax directory (a model's ``arks_orbax/``, or a step directory Orbax
wrote) raises, naming the gap.  A sharded restore onto a mesh waits for
the port's parallelism (ROADMAP).
"""

from __future__ import annotations

import contextlib
import os
import shutil
import threading

import torch
from torch.utils.serialization import config as _serialization

from arks_tpu_torch.device import resolve_device
from arks_tpu_torch.models.config import ModelConfig
from arks_tpu_torch.models.transformer import torch_dtype
from arks_tpu_torch.models.weights import ORBAX_SUBDIR, param_shapes
from arks_tpu_torch.train.sft import (AdamW, AdamWState, TrainState,
                                      named_leaves, trainable)

STATE_FILE = "state.pt"
_TMP_PREFIX = ".tmp-"
# What Orbax's CheckpointManager leaves in a step directory.
_ORBAX_MARKS = ("_CHECKPOINT_METADATA", "default")


def _refuse_orbax(directory: str) -> None:
    def orbax_step(name: str) -> bool:
        path = os.path.join(directory, name)
        return (name.isdigit() and os.path.isdir(path)
                and not os.path.exists(os.path.join(path, STATE_FILE))
                and any(os.path.exists(os.path.join(path, m))
                        for m in _ORBAX_MARKS))

    if not os.path.isdir(directory):
        return
    names = os.listdir(directory)
    if ORBAX_SUBDIR in names or any(orbax_step(n) for n in names):
        raise NotImplementedError(
            f"{directory} holds an Orbax checkpoint, which this port does "
            "not read (orbax.checkpoint imports jax); start a fresh "
            "--ckpt-dir")


class CheckpointManager:
    """Step-numbered checkpoint directory with bounded retention."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep={max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        _refuse_orbax(self.directory)
        os.makedirs(self.directory, exist_ok=True)
        self._writer: threading.Thread | None = None
        self._error: BaseException | None = None

    def step_path(self, step: int) -> str:
        return os.path.join(self.directory, str(step), STATE_FILE)

    def all_steps(self) -> list[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.exists(self.step_path(n)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tensors: dict, wait: bool = True) -> bool:
        """Write ``tensors`` as ``step`` (``wait=False``: on a thread;
        the tensors must then be a snapshot nothing else changes).
        Returns False, writing nothing, for a step at or below the latest
        saved one."""
        self.wait_until_finished()
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return False
        if wait:
            self._write(step, tensors)
        else:
            self._writer = threading.Thread(
                target=self._write_logged, args=(step, tensors),
                name="checkpoint-writer")
            self._writer.start()
        return True

    def wait_until_finished(self) -> None:
        """Join a write in flight; re-raise what it raised."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_logged(self, step: int, tensors: dict) -> None:
        try:
            self._write(step, tensors)
        except BaseException as e:      # re-raised by wait_until_finished
            self._error = e

    def _write(self, step: int, tensors: dict) -> None:
        tmp = os.path.join(self.directory, f"{_TMP_PREFIX}{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with _fast_save():
            torch.save(tensors, os.path.join(tmp, STATE_FILE))
        os.rename(tmp, os.path.join(self.directory, str(step)))
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))


@contextlib.contextmanager
def _fast_save():
    """``torch.save`` without CRC32s, its device copies through pinned
    memory; the process's settings come back after."""
    save = _serialization.save
    old = save.compute_crc32, save.use_pinned_memory_for_d2h
    save.compute_crc32, save.use_pinned_memory_for_d2h = False, True
    try:
        yield
    finally:
        save.compute_crc32, save.use_pinned_memory_for_d2h = old


def host_copy(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``: in pinned memory for a card's tensor (the
    copy runs at the link's rate, and the host allocator reuses the
    blocks at the next snapshot)."""
    t = t.detach()
    if not t.is_cuda:
        return t.clone()
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)


def make_manager(directory: str, max_to_keep: int = 3) -> CheckpointManager:
    """Step-numbered checkpoint directory with bounded retention."""
    return CheckpointManager(directory, max_to_keep)


def state_tensors(state: TrainState) -> dict[str, torch.Tensor]:
    """The checkpoint's named tensors of ``state`` (views, no copies)."""
    out = {"step": torch.tensor(state.step, dtype=torch.int64),
           "opt_state/count": torch.tensor(state.opt_state.count,
                                           dtype=torch.int64)}
    for name, leaf in named_leaves(state.params):
        out[f"params/{name}"] = leaf.detach()
        out[f"opt_state/mu/{name}"] = state.opt_state.mu[name]
        out[f"opt_state/nu/{name}"] = state.opt_state.nu[name]
    return out


def save_train_state(manager: CheckpointManager, state: TrainState,
                     wait: bool = True) -> int:
    """Persist ``state`` under its own step number; returns the step.

    ``wait=True`` (the default) writes before returning, straight from the
    device tensors (``torch.save`` copies one storage at a time to the
    host).  ``wait=False`` copies the state to the host now and writes it
    on a thread while training goes on."""
    tensors = state_tensors(state)
    if not wait:
        tensors = {k: host_copy(t) for k, t in tensors.items()}
    manager.save(state.step, tensors, wait)
    if wait:
        manager.wait_until_finished()
    return state.step


def empty_params(cfg: ModelConfig, dtype, device) -> dict:
    """A params tree of ``cfg``'s shapes, allocated and not filled."""
    out: dict = {"layers": {}}
    for path, shape in param_shapes(cfg).items():
        *parents, leaf = path.split("/")
        node = out
        for key in parents:
            node = node[key]
        node[leaf] = torch.empty(shape, dtype=dtype, device=device)
    return out


def _stored(stored: dict, key: str, like: torch.Tensor) -> torch.Tensor:
    try:
        t = stored[key]
    except KeyError:
        raise KeyError(f"checkpoint has no {key!r}") from None
    if t.shape != like.shape:
        raise ValueError(f"checkpoint {key}: shape {tuple(t.shape)} != "
                         f"{tuple(like.shape)}")
    return t


def restore_train_state(manager: CheckpointManager, cfg: ModelConfig,
                        optimizer: AdamW,
                        device: torch.device | str | None = None,
                        dtype=None, step: int | None = None) -> TrainState:
    """Restore a TrainState (the latest step by default) on ``device``
    (CUDA unless the caller passes "cpu"), in the checkpoint's own dtype
    unless ``dtype`` overrides it.  ``optimizer`` is the run's; its
    hyperparameters are not stored (nor are they in optax's state)."""
    step = manager.latest_step() if step is None else step
    if step is None:
        raise FileNotFoundError(
            f"no checkpoint steps under {manager.directory}")
    device = resolve_device(device)
    stored = torch.load(manager.step_path(step), map_location="cpu",
                        mmap=True, weights_only=True)
    dtype = torch_dtype(dtype) if dtype is not None else \
        stored["params/embed"].dtype
    params = empty_params(cfg, dtype, device)
    mu, nu = {}, {}
    for name, leaf in named_leaves(params):
        leaf.copy_(_stored(stored, f"params/{name}", leaf))
        for moments, key in ((mu, "mu"), (nu, "nu")):
            moments[name] = torch.empty_like(leaf).copy_(
                _stored(stored, f"opt_state/{key}/{name}", leaf))
    trainable(params)
    return TrainState(params, AdamWState(int(stored["opt_state/count"]),
                                         mu, nu), int(stored["step"]))
