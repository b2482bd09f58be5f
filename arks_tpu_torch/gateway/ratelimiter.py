"""Fixed-window rate limiting (rpm/rpd/tpm/tpd).

Semantics mirror the reference's Redis limiter (pkg/gateway/
ratelimiter): windows are wall-clock-aligned (``now.Truncate(period)``,
cache_key.go:42-80), admission pre-checks without incrementing
(``CheckLimit`` = over iff current + requested > limit, redis_impl.go:47-114),
and usage lands post-hoc (``DoLimit`` = INCRBY, :116-168).  Request-type
rules (rpm/rpd) increment by 1 at admission; token-type rules (tpm/tpd)
increment by actual usage at completion.

A copy of ``arks_tpu/gateway/ratelimiter.py``.  Backends are pluggable
(``CounterBackend``, ``make_counter_backend``): the native C++ counter
store (``gateway/native.py``) when it builds, the pure-Python in-memory
store otherwise, and a Redis store (``gateway/rediskv.py``) that gateway
replicas share.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Protocol

from arks_tpu_torch.control.resources import RL_RPD, RL_RPM, RL_TPD, RL_TPM

log = logging.getLogger("arks_tpu_torch.gateway.ratelimiter")

MINUTE = 60
DAY = 24 * 3600

# rule -> (window seconds, is_token_rule)  (reference rate_limiter.go:31-68)
RULES: dict[str, tuple[int, bool]] = {
    RL_RPM: (MINUTE, False),
    RL_RPD: (DAY, False),
    RL_TPM: (MINUTE, True),
    RL_TPD: (DAY, True),
}

REQUEST_RULES = [r for r, (_, tok) in RULES.items() if not tok]
TOKEN_RULES = [r for r, (_, tok) in RULES.items() if tok]


class LimitResult:
    def __init__(self, rule: str, limit: int, current: int, over: bool):
        self.rule, self.limit, self.current, self.over = rule, limit, current, over


class CounterBackend(Protocol):
    def get(self, key: str) -> int: ...
    def incr(self, key: str, amount: int, ttl_s: int) -> int: ...


class MemoryCounterBackend:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._data: dict[str, tuple[int, float]] = {}  # key -> (value, expiry)

    def _gc(self, now: float) -> None:
        if len(self._data) > 4096:
            self._data = {k: v for k, v in self._data.items() if v[1] > now}

    def get(self, key: str) -> int:
        now = time.time()
        with self._lock:
            val = self._data.get(key)
            return val[0] if val and val[1] > now else 0

    def incr(self, key: str, amount: int, ttl_s: int) -> int:
        now = time.time()
        with self._lock:
            self._gc(now)
            val = self._data.get(key)
            cur = val[0] if val and val[1] > now else 0
            expiry = val[1] if val and val[1] > now else now + ttl_s
            cur += amount
            self._data[key] = (cur, expiry)
            return cur


def window_key(namespace: str, user: str, model: str, rule: str,
               now: float | None = None) -> str:
    period = RULES[rule][0]
    start = int((now if now is not None else time.time()) // period) * period
    # key layout parity: prefix:ns=..user=..model=..<rule>:<windowStart>
    return f"arks:ns={namespace}:user={user}:model={model}:{rule}:{start}"


def make_counter_backend(kind: str = "auto",
                         redis_addr: str = "127.0.0.1:6379",
                         redis_sentinel_master: str | None = None
                         ) -> CounterBackend:
    """The counter store ``kind`` names.  ``auto`` (the reference's default
    store) is the native store when its library builds and loads, else the
    in-memory one; ``memory`` is the in-memory store (one gateway replica);
    ``native`` the C++ store, raising ``RuntimeError`` when its library
    does not build or load; ``redis`` a RESP server at ``redis_addr`` (a
    comma-separated list selects cluster mode; with
    ``redis_sentinel_master`` the list is of sentinels), shared by gateway
    replicas."""
    if kind == "memory":
        return MemoryCounterBackend()
    if kind in ("auto", "native"):
        from arks_tpu_torch.gateway import native
        if kind == "native" or native.available():
            backend = native.NativeCounterBackend()
        else:
            backend = MemoryCounterBackend()
        if kind == "auto":
            log.info("counter store: %s", type(backend).__name__)
        return backend
    if kind == "redis":
        from arks_tpu_torch.gateway.rediskv import (
            RedisCounterBackend, make_resp_client,
        )
        return RedisCounterBackend(make_resp_client(redis_addr,
                                                    redis_sentinel_master))
    raise ValueError(f"unknown counter store {kind!r}")


class RateLimiter:
    """check_limit/do_limit over (namespace, user, model) identifiers."""

    def __init__(self, backend: CounterBackend | None = None):
        self.backend = backend or make_counter_backend()

    def check_limit(self, namespace: str, user: str, model: str,
                    rules: dict[str, int], requested: dict[str, int]) -> list[LimitResult]:
        """Pre-admission check; increments nothing. over ⇔ current + req > limit."""
        out = []
        for rule, limit in rules.items():
            if rule not in RULES or limit <= 0:
                continue
            key = window_key(namespace, user, model, rule)
            cur = self.backend.get(key)
            req = requested.get(rule, 1 if rule in REQUEST_RULES else 0)
            out.append(LimitResult(rule, limit, cur, cur + req > limit))
        return out

    def do_limit(self, namespace: str, user: str, model: str,
                 amounts: dict[str, int]) -> None:
        """Record consumption (admission +1 for request rules; usage for
        token rules)."""
        for rule, amount in amounts.items():
            if rule not in RULES or amount <= 0:
                continue
            period = RULES[rule][0]
            key = window_key(namespace, user, model, rule)
            # TTL slightly beyond the window end (the reference adds jitter
            # to avoid synchronized expiry; same idea).
            self.backend.incr(key, amount, ttl_s=period + 5)
