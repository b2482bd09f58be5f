"""Device weight pool for multi-model serving (the port of
``arks_tpu/engine/model_pool.py``).

One engine process serves several models; the pool owns their weights as a
budgeted resource (``ARKS_MODEL_POOL_HBM_MB``).  Each registered model is
resident, loading or evicted; residency is guarded by refcounts against
in-flight use (the engine holds a ref on the active model) plus a
``pinned`` flag for the primary and its draft, which are never evicted.
Eviction is LRU over unpinned refcount-0 entries.

``ensure()`` is a NON-BLOCKING claim: it returns the resident entry or a
``LoadTicket`` whose ``event`` fires when a background loader thread has
finished.  On a CUDA device the loader runs on a side stream of its own,
so the weights stream host->device while the resident model keeps
decoding on the engine's stream, and it ends by recording a CUDA event on
that stream (``ModelEntry.ready``): the engine's switch makes its own
stream wait on that event, so the weights are whole on the card before
the first kernel that reads them, and no thread waits on the host.  The
engine polls the ticket from its step loop (the ``awaiting_model``
park).

The budget covers WEIGHTS only (``tree_bytes`` over the param tree).  KV
pools and per-model scheduler state live with the engine's model context.
A model's first load may transiently overshoot the budget (its size is
unknown until its tensors exist): the pool then evicts, or fails the load,
right after.  Once a model has been resident its size is remembered, and
later reloads make room BEFORE streaming.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time

import torch

from arks_tpu_torch import knobs
from arks_tpu_torch.utils.swallow import swallowed

log = logging.getLogger("arks_tpu_torch.model_pool")


class PoolFullError(RuntimeError):
    """The budget cannot fit the model even after evicting every unpinned
    idle entry.  Surfaces to clients as ``model_pool_exhausted`` (HTTP 503
    + Retry-After)."""


@dataclasses.dataclass
class LoadTicket:
    """Returned by ``ensure()`` when the model is not resident: ``event``
    fires when the background load has finished; ``error`` is set on
    failure (``model_pool_exhausted: ...`` when the budget cannot fit
    it)."""

    name: str
    event: threading.Event = dataclasses.field(default_factory=threading.Event)
    error: str | None = None
    t0: float = dataclasses.field(default_factory=time.monotonic)


@dataclasses.dataclass
class ModelEntry:
    name: str
    cfg: object                      # models.config.ModelConfig
    model_path: str | None = None
    loader: object | None = None     # zero-arg callable -> params
    params: object | None = None
    nbytes: int = 0                  # stored bytes; remembered across evictions
    pinned: bool = False
    refcount: int = 0
    state: str = "evicted"           # "resident" | "loading" | "evicted"
    last_used: float = 0.0
    cold_starts: int = 0
    # The CUDA event recorded after a background load's last copy (None
    # when loaded on the CPU or adopted): a stream that reads the params
    # waits on it first.
    ready: object | None = None


def tree_bytes(params) -> int:
    """Stored bytes over the nested dict of tensors: an int8 or packed int4
    leaf counts its ``q`` bytes and its scales as they are stored."""
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    if isinstance(params, dict):
        return sum(tree_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(tree_bytes(v) for v in params)
    return 0


def tree_tensors(params):
    """Every tensor of a nested dict of tensors."""
    if isinstance(params, torch.Tensor):
        yield params
    elif isinstance(params, dict):
        for v in params.values():
            yield from tree_tensors(v)
    elif isinstance(params, (list, tuple)):
        for v in params:
            yield from tree_tensors(v)


def _run_loader(loader):
    """(``loader()``, its ready event): on a card the loader runs on a side
    stream, and the event is recorded there after its last copy; on the
    CPU, as is, with no event."""
    if not torch.cuda.is_available():
        return loader(), None
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        params = loader()
        ready = torch.cuda.Event()
        ready.record(stream)
    return params, ready


class ModelPool:
    """Thread-safe registry of models sharing one device's memory."""

    def __init__(self, hbm_budget_mb: int | None = None):
        if hbm_budget_mb is None:
            hbm_budget_mb = knobs.get_int("ARKS_MODEL_POOL_HBM_MB")
        if hbm_budget_mb < 0:
            raise ValueError(f"ARKS_MODEL_POOL_HBM_MB={hbm_budget_mb} "
                             "(want >= 0)")
        self.budget_bytes = hbm_budget_mb * (1 << 20)  # 0 = unlimited
        self._lock = threading.Lock()
        self._entries: dict[str, ModelEntry] = {}
        self._tickets: dict[str, LoadTicket] = {}
        # Called (outside the lock) with an evicted model's name: the
        # engine drops its saved context, which holds a params reference,
        # so the device memory really frees.
        self.on_evict = None
        # Optional namespace with the .resident_bytes gauge and the
        # .cold_starts counter (labelled by model); the engine wires it.
        self.metrics = None

    # ---- registration ------------------------------------------------

    def register(self, name: str, cfg, *, model_path: str | None = None,
                 loader=None, pinned: bool = False) -> ModelEntry:
        """Declare a model the pool may serve.  ``loader`` is a zero-arg
        callable returning the device-resident params; without one the
        registrant must ``adopt()`` params later."""
        with self._lock:
            e = self._entries.get(name)
            if e is None:
                e = ModelEntry(name=name, cfg=cfg, model_path=model_path)
                self._entries[name] = e
            if loader is not None:
                e.loader = loader
            if model_path is not None:
                e.model_path = model_path
            e.pinned = e.pinned or pinned
            return e

    def adopt(self, name: str, cfg, params, *,
              pinned: bool = False) -> ModelEntry:
        """Attach already-loaded params (the primary the engine booted
        with, a draft loaded at startup) as resident."""
        e = self.register(name, cfg, pinned=pinned)
        with self._lock:
            e.params = params
            e.nbytes = tree_bytes(params)
            e.state = "resident"
            e.ready = None
            e.last_used = time.monotonic()
        self._publish_metrics()
        return e

    # ---- residency ---------------------------------------------------

    def ensure(self, name: str) -> ModelEntry | LoadTicket:
        """Non-blocking: the resident entry, or a ticket for an in-flight
        or newly started background load.  Raises KeyError on an unknown
        model; PoolFullError when a known size cannot be made room for."""
        evicted = []
        try:
            with self._lock:
                e = self._entries[name]
                if e.state == "resident":
                    e.last_used = time.monotonic()
                    return e
                t = self._tickets.get(name)
                if t is not None:
                    return t
                if e.loader is None:
                    raise KeyError(f"model {name!r} has no loader and no "
                                   "params")
                # Known size from an earlier residency: make room BEFORE
                # the load streams, so the budget is never overshot.
                if e.nbytes:
                    evicted = self._make_room_locked(e.nbytes, exclude=name)
                e.state = "loading"
                t = self._tickets[name] = LoadTicket(name=name)
                threading.Thread(target=self._load, args=(e, t),
                                 name=f"model-load-{name}",
                                 daemon=True).start()
                return t
        finally:
            self._notify_evicted(evicted)

    def load(self, name: str, timeout: float | None = None):
        """Blocking wrapper over ``ensure`` (startup, re-arm, tests).
        Returns the params, whole on the device; raises on a failed or
        timed-out load."""
        got = self.ensure(name)
        if isinstance(got, LoadTicket):
            if not got.event.wait(timeout):
                raise TimeoutError(f"model {name!r} load timed out")
            if got.error:
                raise PoolFullError(got.error) \
                    if "model_pool_exhausted" in got.error \
                    else RuntimeError(got.error)
        with self._lock:
            e = self._entries[name]
            if e.state != "resident":
                raise RuntimeError(f"model {name!r} not resident after load")
            e.last_used = time.monotonic()
            ready, params = e.ready, e.params
        if ready is not None:
            ready.synchronize()
        return params

    def _load(self, e: ModelEntry, t: LoadTicket) -> None:
        evicted = []
        try:
            params, ready = _run_loader(e.loader)
            nbytes = tree_bytes(params)
            with self._lock:
                try:
                    evicted = self._make_room_locked(nbytes, exclude=e.name)
                except PoolFullError as pf:
                    # The size is known now: a retry makes room before it
                    # streams (or fails at once).
                    e.state = "evicted"
                    e.nbytes = nbytes
                    t.error = f"model_pool_exhausted: {pf}"
                    return
                e.params = params
                e.ready = ready
                e.nbytes = nbytes
                e.state = "resident"
                e.last_used = time.monotonic()
                e.cold_starts += 1
            if self.metrics is not None:
                self.metrics.cold_starts.inc(1, model=e.name)
            log.info("model %s loaded (%.1f MiB) in %.2fs", e.name,
                     nbytes / (1 << 20), time.monotonic() - t.t0)
        except Exception as exc:  # surfaces on the ticket
            with self._lock:
                e.state = "evicted"
            t.error = f"{type(exc).__name__}: {exc}"
            log.error("model %s load failed: %s", e.name, t.error)
            swallowed("model_pool.load", exc)
        finally:
            self._notify_evicted(evicted)
            self._publish_metrics()
            with self._lock:
                self._tickets.pop(e.name, None)
            t.event.set()

    def _make_room_locked(self, need: int, exclude: str) -> list[str]:
        """Evict LRU unpinned refcount-0 entries until ``need`` fits the
        budget.  Returns the evicted names (the caller notifies outside
        the lock); raises PoolFullError when eviction cannot make room."""
        if not self.budget_bytes:
            return []
        evicted: list[str] = []

        def resident_bytes():
            return sum(x.nbytes for x in self._entries.values()
                       if x.state == "resident")

        victims = sorted((x for x in self._entries.values()
                          if x.state == "resident" and not x.pinned
                          and x.refcount == 0 and x.name != exclude),
                         key=lambda x: x.last_used)
        vi = iter(victims)
        while resident_bytes() + need > self.budget_bytes:
            v = next(vi, None)
            if v is None:
                raise PoolFullError(
                    f"need {need >> 20} MiB but only "
                    f"{(self.budget_bytes - resident_bytes()) >> 20} MiB "
                    f"free of {self.budget_bytes >> 20} MiB budget "
                    "(pinned/in-use models cannot be evicted)")
            v.params = None
            v.state = "evicted"
            evicted.append(v.name)
        return evicted

    def _notify_evicted(self, names: list[str]) -> None:
        for n in names:
            log.info("model %s evicted (LRU)", n)
            if self.on_evict is not None:
                self.on_evict(n)
        if names:
            self._publish_metrics()

    def scale_to_zero(self, name: str) -> bool:
        """Drop a model's device weights even when PINNED: the engine's
        scale-to-zero.  The only live reference allowed is the caller's own
        active-model ref (refcount <= 1).  The remembered ``nbytes``
        survives, so a reload makes room before streaming, and a
        ``loader`` keeps ``ensure()`` able to stream the weights back."""
        with self._lock:
            e = self._entries.get(name)
            if e is None or e.state != "resident":
                return False
            if e.refcount > 1:
                raise RuntimeError(
                    f"model {name!r} has refcount {e.refcount}; cannot "
                    "scale to zero while other holders are live")
            e.params = None
            e.state = "evicted"
            freed = e.nbytes
        self._publish_metrics()
        log.info("model %s scaled to zero (%.1f MiB of weights dropped)",
                 name, freed / (1 << 20))
        return True

    # ---- refcounts ---------------------------------------------------

    def acquire(self, name: str) -> ModelEntry:
        """Pin ``name`` against eviction while in use.  Raises if it is not
        resident: callers go through ``ensure`` first."""
        with self._lock:
            e = self._entries[name]
            if e.state != "resident":
                raise RuntimeError(f"model {name!r} is {e.state}, not "
                                   "resident")
            e.refcount += 1
            e.last_used = time.monotonic()
            return e

    def release(self, name: str) -> None:
        with self._lock:
            e = self._entries.get(name)
            if e is not None and e.refcount > 0:
                e.refcount -= 1

    # ---- introspection -----------------------------------------------

    def has(self, name: str) -> bool:
        with self._lock:
            return name in self._entries

    def names(self) -> list[str]:
        with self._lock:
            return list(self._entries)

    def params_of(self, name: str):
        with self._lock:
            e = self._entries[name]
            if e.state != "resident":
                raise RuntimeError(f"model {name!r} is {e.state}, not "
                                   "resident")
            return e.params

    def entry(self, name: str) -> ModelEntry:
        with self._lock:
            return self._entries[name]

    def snapshot(self) -> list[dict]:
        """The residency listing of ``/v1/models``."""
        with self._lock:
            return [{
                "name": e.name,
                "state": e.state,
                "resident_bytes": e.nbytes if e.state == "resident" else 0,
                "pinned": e.pinned,
                "refcount": e.refcount,
                "cold_starts": e.cold_starts,
            } for e in self._entries.values()]

    def resident_bytes(self) -> int:
        """Weight bytes resident now, over every entry."""
        with self._lock:
            return sum(e.nbytes for e in self._entries.values()
                       if e.state == "resident")

    def _publish_metrics(self) -> None:
        if self.metrics is None:
            return
        with self._lock:
            rows = [(e.name, e.nbytes if e.state == "resident" else 0)
                    for e in self._entries.values()]
        for name, nbytes in rows:
            self.metrics.resident_bytes.set(nbytes, model=name)
