"""The sanctioned intentional-swallow marker (the port of
``arks_tpu/utils/swallow.py`` and of ``arks_tpu/engine/faults.py``'s
``swallowed``): one implementation, importable without the engine.  The
engine package calls it as ``faults.swallowed``; the tracer imports it
from here."""

from __future__ import annotations

import logging

_log = logging.getLogger("arks_tpu_torch.swallowed")


def swallowed(site: str, exc: BaseException | None = None, *,
              warn: bool = False) -> None:
    """Record an intentionally swallowed exception.  ``warn=True`` for
    swallows that should be visible in default logs (supervision loops);
    the default DEBUG level suits per-request best-effort paths that
    would otherwise spam (client disconnects, probe failures)."""
    _log.log(logging.WARNING if warn else logging.DEBUG,
             "swallowed exception at %s: %s", site, exc, exc_info=exc)
