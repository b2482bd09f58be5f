"""QoS config provider: token -> per-endpoint limits, from the store (a
copy of ``arks_tpu/gateway/qos.py``).

The reference's ConfigProvider (pkg/gateway/qosconfig/) runs
its own controller-runtime cache over ArksToken/ArksQuota/ArksEndpoint with a
``spec.token`` index (arks_impl.go:59-73).  Here the store IS the cache; the
token index is maintained from a Token watch.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

from arks_tpu_torch.control.resources import Endpoint, Quota, Token
from arks_tpu_torch.control.store import Store


@dataclasses.dataclass
class TokenQos:
    namespace: str
    username: str          # token resource name (identifier labels parity)
    endpoint: str
    rate_limits: dict[str, int]
    quota_name: str | None


class QosProvider:
    def __init__(self, store: Store):
        self.store = store
        self._lock = threading.Lock()
        self._by_token: dict[str, Token] = {}
        self._watch_thread = threading.Thread(target=self._pump, daemon=True,
                                              name="qos-token-index")
        self._running = True
        self._queue = store.watch(Token)
        self._watch_thread.start()

    def stop(self) -> None:
        self._running = False

    def _pump(self) -> None:
        while self._running:
            try:
                event, tok = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            with self._lock:
                secret = tok.spec.get("token", "")
                if event == "DELETED":
                    self._by_token.pop(secret, None)
                else:
                    # Re-index: drop stale secrets pointing at this resource.
                    for k, v in list(self._by_token.items()):
                        if v.key == tok.key and k != secret:
                            del self._by_token[k]
                    if secret:
                        self._by_token[secret] = tok

    # ------------------------------------------------------------------

    def get_qos_by_token(self, secret: str, model: str) -> TokenQos | None:
        """Resolve (token, model) -> QoS (arks_impl.go:303-338)."""
        with self._lock:
            tok = self._by_token.get(secret)
        if tok is None:
            return None
        for qos in tok.spec.get("qos", []):
            ep_ref = qos.get("endpoint", {})
            if ep_ref.get("name") == model:
                return TokenQos(
                    namespace=tok.namespace,
                    username=tok.name,
                    endpoint=model,
                    rate_limits={rl["type"]: rl["value"]
                                 for rl in qos.get("rateLimits", [])},
                    quota_name=(qos.get("quota") or {}).get("name"),
                )
        return None

    def token_known(self, secret: str) -> bool:
        with self._lock:
            return secret in self._by_token

    def get_model_list(self, namespace: str) -> list[str]:
        """All endpoints in a namespace (arks_impl.go:364-376)."""
        return [e.name for e in self.store.list(Endpoint, namespace=namespace)]

    def get_models_by_token(self, secret: str) -> list[str]:
        """Token-visible endpoint names for /v1/models (arks_impl.go:378-397)."""
        with self._lock:
            tok = self._by_token.get(secret)
        if tok is None:
            return []
        eps = set(self.get_model_list(tok.namespace))
        return [q["endpoint"]["name"] for q in tok.spec.get("qos", [])
                if q.get("endpoint", {}).get("name") in eps]

    def get_quota_limits(self, namespace: str, quota_name: str) -> dict[str, int]:
        q = self.store.try_get(Quota, quota_name, namespace)
        if q is None:
            return {}
        return {item["type"]: item["value"] for item in q.spec.get("quotas", [])}

    def get_endpoint(self, namespace: str, name: str) -> Endpoint | None:
        return self.store.try_get(Endpoint, name, namespace)
