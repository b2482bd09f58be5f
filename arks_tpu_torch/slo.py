"""SLO tiers: named latency classes mapped onto the engine priority scale
(a copy of ``arks_tpu/slo.py`` with the port's own settings reader).

The engine's admission queue has always ordered by the integer
``SamplingParams.priority`` (lower = sooner); since the preemptive-swap
work that integer is real QoS — a queued lower value can seize a running
slot.  This module gives the integers NAMES and TARGETS so the gateway,
the router, the OpenAI front-end and the metrics pipeline all speak the
same tier vocabulary:

- ``ARKS_SLO_TIERS`` declares the ladder, best tier first, e.g.::

      latency:ttft_ms=300;tpot_ms=50,interactive:ttft_ms=1500,batch:

  Each comma-separated entry is ``name[:key=val[;key=val...]]``.  Tier
  index == engine priority (``latency`` above is priority 0, ``batch``
  priority 2).  Known target keys: ``ttft_ms``, ``tpot_ms`` — surfaced
  for dashboards/alerting (docs/monitoring.md); unknown keys are
  rejected so a typo'd SLO does not silently vanish.
- The gateway accepts an ``x-arks-tier`` header, validates it against
  the ladder (unknown tier -> 400) and forwards it; the OpenAI server
  maps it to ``params.priority`` (header wins over a body ``priority``).
- ``tier_of(priority)`` is the metric label everywhere
  (``ttft_seconds{tier=...}`` etc.); priorities past the end of the
  ladder clamp to the last (worst) tier, and with no ladder configured
  every request labels as ``"default"``.

With ``ARKS_SLO_TIERS`` unset nothing changes: no tiers exist, tier
headers are rejected, and body priorities pass through untouched.
"""

from __future__ import annotations

import dataclasses

from arks_tpu_torch import knobs

ENV_VAR = "ARKS_SLO_TIERS"
DEFAULT_TIER = "default"

_TARGET_KEYS = ("ttft_ms", "tpot_ms")


@dataclasses.dataclass(frozen=True)
class Tier:
    """One rung of the SLO ladder: a name, its engine priority (= ladder
    index), and optional latency targets in milliseconds."""
    name: str
    priority: int
    ttft_ms: float | None = None
    tpot_ms: float | None = None


class SloTiers:
    """An ordered tier ladder (best first).  Empty = tiers disabled."""

    def __init__(self, tiers: tuple[Tier, ...] = ()) -> None:
        self.tiers = tiers
        self._by_name = {t.name: t for t in tiers}

    def __bool__(self) -> bool:
        return bool(self.tiers)

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(t.name for t in self.tiers)

    def get(self, name: str) -> Tier | None:
        return self._by_name.get(name)

    def priority_of(self, name: str) -> int | None:
        """Engine priority for a tier name (None = unknown tier)."""
        t = self._by_name.get(name)
        return None if t is None else t.priority

    def tier_of(self, priority: int) -> str:
        """Metric label for an engine priority.  Priorities are clamped
        into the ladder (replayers run at priority - 2**20; overly-batch
        requests clamp to the worst tier); no ladder -> "default"."""
        if not self.tiers:
            return DEFAULT_TIER
        idx = min(max(int(priority), 0), len(self.tiers) - 1)
        return self.tiers[idx].name


def parse_tiers(spec: str) -> SloTiers:
    """Parse an ``ARKS_SLO_TIERS`` value.  Raises ValueError on malformed
    entries, duplicate names, or unknown target keys."""
    tiers: list[Tier] = []
    seen: set[str] = set()
    for i, entry in enumerate(s for s in spec.split(",") if s.strip()):
        name, _, rest = entry.strip().partition(":")
        name = name.strip()
        if not name or not name.replace("-", "").replace("_", "").isalnum():
            raise ValueError(f"{ENV_VAR}: bad tier name in entry {entry!r}")
        if name in seen:
            raise ValueError(f"{ENV_VAR}: duplicate tier {name!r}")
        seen.add(name)
        targets: dict[str, float] = {}
        for kv in (s for s in rest.split(";") if s.strip()):
            key, sep, val = kv.partition("=")
            key = key.strip()
            if not sep or key not in _TARGET_KEYS:
                raise ValueError(
                    f"{ENV_VAR}: unknown target {kv!r} in tier {name!r} "
                    f"(known: {', '.join(_TARGET_KEYS)})")
            try:
                targets[key] = float(val)
            except ValueError:
                raise ValueError(
                    f"{ENV_VAR}: non-numeric target {kv!r} in tier "
                    f"{name!r}") from None
            if targets[key] <= 0:
                raise ValueError(
                    f"{ENV_VAR}: target {kv!r} in tier {name!r} must be "
                    "positive")
        tiers.append(Tier(name=name, priority=i, **targets))
    return SloTiers(tuple(tiers))


def from_env() -> SloTiers:
    """The process-wide ladder from ``ARKS_SLO_TIERS`` (empty when
    unset)."""
    spec = knobs.get_str(ENV_VAR, fallback="") or ""
    return parse_tiers(spec) if spec.strip() else SloTiers()
