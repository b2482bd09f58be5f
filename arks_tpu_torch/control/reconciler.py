"""Reconciler framework: level-triggered controllers over the Store (a copy
of ``arks_tpu/control/reconciler.py``).

The controller-runtime pattern the reference is built on (watch -> workqueue
-> Reconcile(key) -> requeue), reduced to its essentials: per-controller
worker threads pull dedup'd keys from a queue fed by watch streams; a
reconcile returns an optional requeue delay; errors requeue with backoff.
"""

from __future__ import annotations

import heapq
import logging
import queue
import threading
import time
from typing import Callable, Iterable, Type

from arks_tpu_torch.control.resources import Resource
from arks_tpu_torch.control.store import Store

log = logging.getLogger("arks_tpu_torch.control")


class Result:
    def __init__(self, requeue_after: float | None = None):
        self.requeue_after = requeue_after


class WorkQueue:
    """Dedup'd delay-capable work queue (a tiny workqueue.RateLimiting)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: set = set()
        self._ready: list = []
        self._delayed: list[tuple[float, object]] = []  # heap (when, key)
        self._shutdown = False

    def add(self, key, delay: float = 0.0) -> None:
        with self._cond:
            if delay > 0:
                heapq.heappush(self._delayed, (time.monotonic() + delay, key))
            elif key not in self._pending:
                self._pending.add(key)
                self._ready.append(key)
            self._cond.notify()

    def get(self, timeout: float = 0.2):
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                now = time.monotonic()
                while self._delayed and self._delayed[0][0] <= now:
                    _, key = heapq.heappop(self._delayed)
                    if key not in self._pending:
                        self._pending.add(key)
                        self._ready.append(key)
                if self._ready:
                    key = self._ready.pop(0)
                    self._pending.discard(key)
                    return key
                if self._shutdown or now >= deadline:
                    return None
                wait = deadline - now
                if self._delayed:
                    wait = min(wait, self._delayed[0][0] - now)
                self._cond.wait(max(wait, 0.001))

    def shutdown(self) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()


class Controller:
    """Base controller: watches kinds, reconciles keys (namespace, name).

    Subclasses set ``KIND`` (primary kind) and override ``reconcile(obj)``;
    secondary watches map events to primary keys via ``watches()`` —
    the reference's Owns()/Watches() with handler mappers
    (e.g. arksapplication_controller.go:123-150).
    """

    KIND: Type[Resource] = Resource
    FINALIZER = ""
    ERROR_BACKOFF = 0.5

    def __init__(self, store: Store, workers: int = 1, name: str | None = None):
        self.store = store
        self.queue = WorkQueue()
        self.name = name or type(self).__name__
        self._workers = workers
        self._threads: list[threading.Thread] = []
        self._running = False

    # -- wiring --------------------------------------------------------

    def watches(self) -> Iterable[tuple[Type[Resource], Callable[[Resource], Iterable[tuple[str, str]]]]]:
        """Secondary (kind, mapper) pairs: mapper(event obj) -> primary keys."""
        return []

    def start(self) -> None:
        self._running = True

        def pump(kind, mapper):
            q = self.store.watch(kind)
            while self._running:
                try:
                    event, obj = q.get(timeout=0.2)
                except queue.Empty:
                    continue
                for key in mapper(obj):
                    self.queue.add(key)

        primary_pump = threading.Thread(
            target=pump, args=(self.KIND, lambda o: [o.key]),
            name=f"{self.name}-watch", daemon=True)
        primary_pump.start()
        self._threads.append(primary_pump)
        for kind, mapper in self.watches():
            t = threading.Thread(target=pump, args=(kind, mapper),
                                 name=f"{self.name}-watch-{kind.KIND}", daemon=True)
            t.start()
            self._threads.append(t)
        for i in range(self._workers):
            t = threading.Thread(target=self._work, name=f"{self.name}-{i}", daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._running = False
        self.queue.shutdown()
        for t in self._threads:
            t.join(timeout=5)

    def kick(self, name: str, namespace: str = "default") -> None:
        """Enqueue an immediate reconcile of one primary object, outside
        any watch event.  The elastic control loop uses this to force an
        autoscaler evaluation the moment fresh overload evidence lands
        (an SLO-burn spike mid-tick) instead of waiting out the ticker
        interval; the workqueue's dedup makes redundant kicks free."""
        self.queue.add((namespace, name))

    # -- loop ----------------------------------------------------------

    def _work(self) -> None:
        while self._running:
            key = self.queue.get(timeout=0.2)
            if key is None:
                continue
            ns, name = key
            try:
                obj = self.store.try_get(self.KIND, name, ns)
                if obj is None:
                    continue
                if obj.deletion_requested:
                    self.finalize(obj)
                    if self.FINALIZER:
                        self.store.strip_finalizer(obj, self.FINALIZER)
                    continue
                if self.FINALIZER and self.FINALIZER not in obj.finalizers:
                    obj = self.store.add_finalizer(obj, self.FINALIZER)
                result = self.reconcile(obj)
                if result is not None and result.requeue_after:
                    self.queue.add(key, delay=result.requeue_after)
            except Exception:
                log.exception("%s: reconcile %s/%s failed", self.name, ns, name)
                self.queue.add(key, delay=self.ERROR_BACKOFF)

    # -- to override ---------------------------------------------------

    def reconcile(self, obj: Resource) -> Result | None:
        raise NotImplementedError

    def finalize(self, obj: Resource) -> None:
        """Cleanup on deletion (before the finalizer is stripped)."""


class Manager:
    """Holds the store + controllers; mirrors cmd/main.go's manager setup."""

    def __init__(self, store: Store | None = None):
        self.store = store or Store()
        self.controllers: list[Controller] = []

    def add(self, controller: Controller) -> Controller:
        self.controllers.append(controller)
        return controller

    def start(self) -> None:
        for c in self.controllers:
            c.start()

    def stop(self) -> None:
        for c in self.controllers:
            c.stop()

    def wait_idle(self, timeout: float = 30.0, settle: float = 0.3) -> bool:
        """Test helper: wait until all workqueues drain and stay drained."""
        deadline = time.monotonic() + timeout
        idle_since = None
        while time.monotonic() < deadline:
            busy = any(c.queue._ready or c.queue._pending for c in self.controllers)
            if busy:
                idle_since = None
            elif idle_since is None:
                idle_since = time.monotonic()
            elif time.monotonic() - idle_since >= settle:
                return True
            time.sleep(0.02)
        return False
