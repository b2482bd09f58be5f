"""Cumulative token-usage quota service with CR-status persistence (a copy
of ``arks_tpu/gateway/quota.py``).

Mirrors the reference quota service (pkg/gateway/quota/ —
plain non-expiring counters keyed namespace/quotaname/type) plus the
qosconfig sync loop (qosconfig/arks_impl.go:217-300): every ``sync_s`` the
gateway writes live usage into Quota.status.quotaStatus, and re-seeds its
counters from the CR when its own store is behind (restart recovery).
"""

from __future__ import annotations

import logging
import threading

from arks_tpu_torch.control.resources import Quota, VALID_QUOTAS, now_iso
from arks_tpu_torch.control.store import NotFound, Store

log = logging.getLogger("arks_tpu_torch.gateway.quota")


class QuotaService:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._usage: dict[tuple[str, str, str], int] = {}  # (ns, quota, type)

    def incr_usage(self, namespace: str, quota_name: str,
                   amounts: dict[str, int]) -> None:
        with self._lock:
            for typ, amount in amounts.items():
                if typ in VALID_QUOTAS and amount > 0:
                    key = (namespace, quota_name, typ)
                    self._usage[key] = self._usage.get(key, 0) + amount

    def get_usage(self, namespace: str, quota_name: str) -> dict[str, int]:
        with self._lock:
            return {typ: self._usage.get((namespace, quota_name, typ), 0)
                    for typ in VALID_QUOTAS}

    def set_usage(self, namespace: str, quota_name: str, typ: str, value: int) -> None:
        with self._lock:
            self._usage[(namespace, quota_name, typ)] = value

    def check(self, namespace: str, quota_name: str,
              limits: dict[str, int]) -> tuple[bool, str]:
        """True = over limit; returns (over, which_type)."""
        usage = self.get_usage(namespace, quota_name)
        for typ, limit in limits.items():
            if limit > 0 and usage.get(typ, 0) >= limit:
                return True, typ
        return False, ""


class QuotaStatusSyncer:
    """The 10s Redis<->CR reconciliation loop (arks_impl.go:217-300)."""

    def __init__(self, store: Store, service: QuotaService, sync_s: float = 2.0):
        self.store = store
        self.service = service
        self.sync_s = sync_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name="quota-sync",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    def sync_once(self) -> None:
        for q in self.store.list(Quota):
            live = self.service.get_usage(q.namespace, q.name)
            persisted = {s["type"]: s.get("used", 0)
                         for s in q.status.get("quotaStatus", [])}
            changed = False
            for typ in VALID_QUOTAS:
                if live[typ] < persisted.get(typ, 0):
                    # Gateway restarted: re-seed from the CR (the durable copy).
                    self.service.set_usage(q.namespace, q.name, typ,
                                           persisted[typ])
                    live[typ] = persisted[typ]
                if live[typ] != persisted.get(typ, 0):
                    changed = True
            if changed:
                q.status["quotaStatus"] = [
                    {"type": t, "used": live[t], "lastUpdateTime": now_iso()}
                    for t in VALID_QUOTAS]
                try:
                    self.store.update_status(q)
                except NotFound:
                    pass

    def _loop(self) -> None:
        # An event, not a sleep: stop() returns at once (the reference's
        # loop sleeps out its interval).
        while True:
            try:
                self.sync_once()
            except Exception:
                log.exception("quota status sync failed")
            if self._stop.wait(self.sync_s):
                return
