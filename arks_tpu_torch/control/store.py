"""In-memory watchable object store — the control plane's "apiserver" (a
copy of ``arks_tpu/control/store.py``).

Plays the role the Kubernetes apiserver plays for the reference operator:
typed CRUD with resourceVersion bumps, per-kind watch streams, finalizers,
deletion propagation to owned objects, and a status subresource.  Backed by
plain dicts; persistence (e.g. file-backed snapshots) can be layered under
``snapshot()/restore()``.

Concurrency: a single lock; reads return deep copies so reconcilers can
mutate freely and write back (mirroring controller-runtime's cached-client
get/update pattern).
"""

from __future__ import annotations

import copy
import queue
import threading
from typing import Callable, Type

from arks_tpu_torch.control.resources import Resource


class Conflict(Exception):
    """resourceVersion mismatch on update (optimistic concurrency)."""


class NotFound(Exception):
    pass


class Store:
    def __init__(self) -> None:
        self._lock = threading.RLock()
        # kind -> (namespace, name) -> Resource
        self._objects: dict[str, dict[tuple[str, str], Resource]] = {}
        self._watchers: dict[str, list["queue.Queue[tuple[str, Resource]]"]] = {}
        self._rv = 0

    # ------------------------------------------------------------------
    # CRUD
    # ------------------------------------------------------------------

    def create(self, obj: Resource) -> Resource:
        with self._lock:
            kind = obj.KIND
            objs = self._objects.setdefault(kind, {})
            if obj.key in objs:
                raise Conflict(f"{kind} {obj.key} already exists")
            self._rv += 1
            obj = obj.deepcopy()
            obj.resource_version = self._rv
            objs[obj.key] = obj
            self._notify(kind, "ADDED", obj)
            return obj.deepcopy()

    def get(self, kind: Type[Resource] | str, name: str,
            namespace: str = "default") -> Resource:
        k = kind if isinstance(kind, str) else kind.KIND
        with self._lock:
            obj = self._objects.get(k, {}).get((namespace, name))
            if obj is None:
                raise NotFound(f"{k} {namespace}/{name}")
            return obj.deepcopy()

    def try_get(self, kind, name, namespace="default") -> Resource | None:
        try:
            return self.get(kind, name, namespace)
        except NotFound:
            return None

    def list(self, kind: Type[Resource] | str, namespace: str | None = None,
             selector: Callable[[Resource], bool] | None = None) -> list[Resource]:
        k = kind if isinstance(kind, str) else kind.KIND
        with self._lock:
            out = []
            for obj in self._objects.get(k, {}).values():
                if namespace is not None and obj.namespace != namespace:
                    continue
                if selector is not None and not selector(obj):
                    continue
                out.append(obj.deepcopy())
            return out

    def update(self, obj: Resource) -> Resource:
        """Full update with optimistic concurrency on resource_version."""
        with self._lock:
            kind = obj.KIND
            objs = self._objects.get(kind, {})
            cur = objs.get(obj.key)
            if cur is None:
                raise NotFound(f"{kind} {obj.key}")
            if obj.resource_version != cur.resource_version:
                raise Conflict(
                    f"{kind} {obj.key}: stale resourceVersion "
                    f"{obj.resource_version} != {cur.resource_version}")
            self._rv += 1
            new = obj.deepcopy()
            new.resource_version = self._rv
            objs[obj.key] = new
            self._notify(kind, "MODIFIED", new)
            # Finalizer-driven deletion: object goes away once marked deleted
            # and no finalizers remain.
            if new.deletion_requested and not new.finalizers:
                self._remove(new)
            return new.deepcopy()

    def update_status(self, obj: Resource) -> Resource:
        """Status-subresource update: merges status only, ignores spec edits,
        retries on conflict like the reference's RetryOnConflict patch
        (arksapplication_controller.go:1024-1038)."""
        with self._lock:
            cur = self._objects.get(obj.KIND, {}).get(obj.key)
            if cur is None:
                raise NotFound(f"{obj.KIND} {obj.key}")
            self._rv += 1
            cur.status = copy.deepcopy(obj.status)
            cur.resource_version = self._rv
            self._notify(obj.KIND, "MODIFIED", cur)
            return cur.deepcopy()

    def delete(self, kind: Type[Resource] | str, name: str,
               namespace: str = "default") -> None:
        """Request deletion: with finalizers present the object is only
        marked (controllers then clean up and strip their finalizer);
        without, it is removed and owned objects cascade."""
        k = kind if isinstance(kind, str) else kind.KIND
        with self._lock:
            obj = self._objects.get(k, {}).get((namespace, name))
            if obj is None:
                raise NotFound(f"{k} {namespace}/{name}")
            if obj.finalizers:
                if not obj.deletion_requested:
                    self._rv += 1
                    obj.deletion_requested = True
                    obj.resource_version = self._rv
                    self._notify(k, "MODIFIED", obj)
                return
            self._remove(obj)

    def _remove(self, obj: Resource) -> None:
        self._objects.get(obj.KIND, {}).pop(obj.key, None)
        self._notify(obj.KIND, "DELETED", obj)
        # Cascading delete of owned objects (ownerReference GC).
        for kind_objs in list(self._objects.values()):
            for owned in list(kind_objs.values()):
                if (obj.KIND, obj.name) in owned.owner_refs \
                        and owned.namespace == obj.namespace:
                    try:
                        self.delete(owned.KIND, owned.name, owned.namespace)
                    except NotFound:
                        pass

    def strip_finalizer(self, obj: Resource, finalizer: str) -> None:
        """Remove a finalizer (post-cleanup) and finish deletion if due."""
        with self._lock:
            cur = self._objects.get(obj.KIND, {}).get(obj.key)
            if cur is None:
                return
            if finalizer in cur.finalizers:
                cur.finalizers.remove(finalizer)
                self._rv += 1
                cur.resource_version = self._rv
                self._notify(cur.KIND, "MODIFIED", cur)
            if cur.deletion_requested and not cur.finalizers:
                self._remove(cur)

    def add_finalizer(self, obj: Resource, finalizer: str) -> Resource:
        with self._lock:
            cur = self._objects.get(obj.KIND, {}).get(obj.key)
            if cur is None:
                raise NotFound(f"{obj.KIND} {obj.key}")
            if finalizer not in cur.finalizers:
                cur.finalizers.append(finalizer)
                self._rv += 1
                cur.resource_version = self._rv
            return cur.deepcopy()

    # ------------------------------------------------------------------
    # Watch
    # ------------------------------------------------------------------

    def watch(self, kind: Type[Resource] | str,
              maxsize: int = 1024) -> "queue.Queue[tuple[str, Resource]]":
        """Subscribe to (event_type, object) for a kind.  Slow consumers drop
        oldest events — reconcilers are level-triggered, so a drop only costs
        latency, never correctness."""
        k = kind if isinstance(kind, str) else kind.KIND
        with self._lock:
            # Size the queue so the initial replay can never block while the
            # store lock is held (the consumer only gets the queue after
            # watch() returns, so a bounded q.put here would deadlock).
            existing = list(self._objects.get(k, {}).values())
            q: "queue.Queue[tuple[str, Resource]]" = queue.Queue(
                maxsize=maxsize + len(existing))
            self._watchers.setdefault(k, []).append(q)
            # Replay current state (informer-style initial LIST).
            for obj in existing:
                q.put_nowait(("ADDED", obj.deepcopy()))
        return q

    def _notify(self, kind: str, event: str, obj: Resource) -> None:
        for q in self._watchers.get(kind, []):
            item = (event, obj.deepcopy())
            try:
                q.put_nowait(item)
            except queue.Full:
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                q.put_nowait(item)
