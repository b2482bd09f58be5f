"""Fault taxonomy, injection, and escalation for the serving engine (the
port of ``arks_tpu/engine/faults.py``).

- **StepFault**: the typed wrapper every scheduler-phase fault is raised
  as.  It carries *blast-radius attribution* — which request(s) the
  failing operation was doing work for (``culprits``) — plus any request
  state that would otherwise be stranded in locals when the stack unwinds
  (``survivors``).  The engine's recovery loop quarantines only the
  culprits (bounded per-request retry budget, ``ARKS_FAULT_RETRIES``) and
  token-replays everyone else.
- **FaultInjector**: the ``ARKS_FAULT_INJECT`` chaos hook.  Spec:
  comma-separated ``phase:nth:kind`` entries (``decode:3:runtime`` = raise
  a RuntimeError at the 3rd decode-dispatch issue).  The port fires
  ``decode`` (any decode-carrying model dispatch issue, pipelined and
  mixed included), ``resolve`` (their host-sync tails), ``admit`` /
  ``admit_resolve`` (one-shot admission batches), ``admit_fair`` (the fair
  queue's pick point), ``chunk`` (a legacy chunked-prefill dispatch),
  ``replay`` (recovery re-admission), ``pages`` (page-table growth and
  allocation), ``guide`` (guide-table upload), ``spill`` (a host-tier
  spill issue), ``restore`` (a host-tier restore issue or unpark),
  ``preempt`` (a preemption's spill, harvest or resume) and ``spec`` (a
  speculative dispatch issue, pipelined or not), ``model_switch`` (a
  pool model's activation) and ``residency`` (a windowed-residency
  step).  The parser does not check phase names: the reference's other
  phases (``disk_spill``, ``peer_fetch``, ``resize``) parse and never
  fire here.  Kinds:
  ``runtime``, ``value``, ``oom`` (a RESOURCE_EXHAUSTED-shaped error),
  ``hang`` (sleeps ``ARKS_FAULT_HANG_S``, default 3600 — the
  watchdog-escalation fixture).
- **Watchdog**: detects a wedged device dispatch — a ``step()`` that has
  not returned within ``ARKS_DISPATCH_DEADLINE_S`` — flips the engine
  state to ``wedged`` (readiness then answers 503), dumps the in-flight
  diagnostics, and escalates to ``os._exit(70)`` so the supervisor
  restarts the process.  Disabled at 0 (the default).
- **is_sticky()**: a CUDA error that poisons the context (an illegal
  address, a device-side assert, an unspecified launch failure): every
  later CUDA call fails too, so the engine cannot rebuild its device state
  in-process and escalates the way the watchdog does (exit 70).
- **swallowed()** (``arks_tpu_torch/utils/swallow.py``, re-exported
  here): the sanctioned route for the few handlers that intentionally
  swallow an exception.  ``tests/test_torch_faults.py``
  statically requires every ``except Exception`` under
  ``arks_tpu_torch/engine/`` to re-raise or call into this module.
"""

from __future__ import annotations

import logging
import os
import threading
import time

import torch

from arks_tpu_torch import knobs
from arks_tpu_torch.utils.swallow import swallowed

__all__ = ["StepFault", "InjectedFault", "FaultInjector", "Watchdog",
           "classify", "is_sticky", "swallowed", "STATE_CODES"]

log = logging.getLogger("arks_tpu_torch.faults")

# Engine state codes surfaced by the engine_state gauge.
STATE_SERVING = 0
STATE_RECOVERING = 1
STATE_WEDGED = 2
STATE_CODES = {"serving": STATE_SERVING, "recovering": STATE_RECOVERING,
               "wedged": STATE_WEDGED}


class StepFault(Exception):
    """A scheduler-phase fault with blast-radius attribution.

    ``phase``     the scheduler phase that faulted (metric label).
    ``kind``      coarse failure class (metric label; see classify()).
    ``culprits``  request ids the failing operation was doing work FOR —
                  the quarantine set (retry-budget accounting).
    ``survivors`` request-state descriptors (engine._Survivor) that only
                  lived in the failing frame's locals: un-registered
                  admissions, not-yet-replayed recovery snapshots.  The
                  recovery loop re-admits them; without this they would be
                  stranded (client blocks forever).
    """

    def __init__(self, phase: str, kind: str, culprits=(), survivors=(),
                 message: str = ""):
        super().__init__(message or f"engine fault in phase {phase!r} ({kind})")
        self.phase = phase
        self.kind = kind
        self.culprits = tuple(culprits)
        self.survivors = list(survivors)


class InjectedFault(RuntimeError):
    """Raised by FaultInjector.fire(); distinguishable in logs/tests."""


def classify(exc: BaseException) -> str:
    """Coarse fault kind for the engine_faults_total metric label.
    Deliberately low-cardinality: dashboards alert on (phase, kind), and
    one label value per exception class would explode the family.  A CUDA
    out-of-memory error is "oom", as the reference's RESOURCE_EXHAUSTED."""
    if isinstance(exc, StepFault):
        return exc.kind
    msg = f"{type(exc).__name__}: {exc}"
    if ("RESOURCE_EXHAUSTED" in msg or isinstance(exc, MemoryError)
            or isinstance(exc, torch.cuda.OutOfMemoryError)):
        return "oom"
    if isinstance(exc, InjectedFault):
        return "injected"
    if isinstance(exc, (ValueError, TypeError, KeyError, IndexError)):
        return "value"
    if isinstance(exc, OSError):
        return "io"
    return "runtime"


# CUDA errors after which the context is unusable (cudaError_t 700, 702,
# 710, 714-719 and the uncorrectable ECC error): the message texts the
# runtime gives them, and their codes where the exception carries one.
_STICKY_TEXT = ("illegal memory access", "device-side assert",
                "unspecified launch failure", "misaligned address",
                "illegal instruction", "invalid program counter",
                "hardware stack error", "uncorrectable ecc error",
                "the launch timed out")
_STICKY_CODES = {700, 702, 710, 714, 715, 716, 717, 718, 719, 214}


def is_sticky(exc: BaseException | None) -> bool:
    """True when ``exc`` (or an exception it was raised from) is a CUDA
    error that leaves the context unusable, so nothing in this process can
    rebuild the device state."""
    seen = 0
    while exc is not None and seen < 16:
        if getattr(exc, "error_code", None) in _STICKY_CODES:
            return True
        msg = str(exc).lower()
        if "cuda" in msg and any(t in msg for t in _STICKY_TEXT):
            return True
        exc = exc.__cause__ or exc.__context__
        seen += 1
    return False


_KINDS = ("runtime", "value", "oom", "hang")


class FaultInjector:
    """ARKS_FAULT_INJECT chaos hook: ``phase:nth:kind[,phase:nth:kind...]``.

    ``nth`` is the 1-based occurrence of ``fire(phase)`` calls for that
    phase; each spec entry fires at most once.  Engine-thread only (the
    counters are unsynchronized on purpose — all fire sites run on the
    scheduler thread)."""

    def __init__(self, spec: str | None = None):
        self._specs: list[list] = []   # [phase, nth, kind, armed]
        self._counts: dict[str, int] = {}
        spec = (knobs.get_str("ARKS_FAULT_INJECT", fallback="") or ""
                ) if spec is None else spec
        if spec:
            for entry in spec.split(","):
                self.arm(entry)

    def arm(self, entry: str) -> None:
        """Add one ``phase:nth:kind`` spec (env parsing and the chaos
        harness's programmatic injection)."""
        entry = entry.strip()
        if not entry:
            return
        parts = entry.split(":")
        if len(parts) != 3:
            raise ValueError(
                f"ARKS_FAULT_INJECT entry {entry!r}: expected phase:nth:kind")
        phase, nth_s, kind = parts
        try:
            nth = int(nth_s)
        except ValueError:
            raise ValueError(
                f"ARKS_FAULT_INJECT entry {entry!r}: nth must be an integer")
        if nth < 1:
            raise ValueError(
                f"ARKS_FAULT_INJECT entry {entry!r}: nth must be >= 1")
        if kind not in _KINDS:
            raise ValueError(
                f"ARKS_FAULT_INJECT entry {entry!r}: kind must be one of "
                f"{_KINDS}")
        self._specs.append([phase, nth, kind, True])

    @property
    def active(self) -> bool:
        return bool(self._specs)

    def fire(self, phase: str) -> None:
        """Count one occurrence of ``phase``; raise if a spec matches."""
        if not self._specs:
            return
        n = self._counts.get(phase, 0) + 1
        self._counts[phase] = n
        for spec in self._specs:
            if spec[3] and spec[0] == phase and spec[1] == n:
                spec[3] = False
                kind = spec[2]
                log.warning("fault injection: phase=%s nth=%d kind=%s",
                            phase, n, kind)
                if kind == "hang":
                    time.sleep(knobs.get_float("ARKS_FAULT_HANG_S"))
                    return
                if kind == "oom":
                    raise InjectedFault(
                        f"RESOURCE_EXHAUSTED (injected at {phase}:{n})")
                if kind == "value":
                    raise ValueError(f"injected fault at {phase}:{n}")
                raise InjectedFault(f"injected fault at {phase}:{n}")


class Watchdog:
    """Wedged-dispatch detector: ``heartbeat()`` returns (phase, t0) of
    the in-flight scheduler step (None when idle); if a step overruns the
    deadline the watchdog calls ``on_wedged()`` (flip state/readiness,
    dump diagnostics) and escalates through ``exit_fn(70)`` so the
    supervisor restarts the process.  ``exit_fn`` is injectable for
    tests; production uses os._exit — a wedged device call cannot be
    cancelled from Python, so a clean shutdown is not on the table."""

    def __init__(self, deadline_s: float, heartbeat, on_wedged,
                 exit_fn=os._exit):
        self.deadline_s = deadline_s
        self._heartbeat = heartbeat
        self._on_wedged = on_wedged
        self._exit_fn = exit_fn
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, name="watchdog",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop and join the thread, and drop the callbacks: they close
        over the engine, which a finished watchdog must not keep alive."""
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)
        self._heartbeat = self._on_wedged = None

    def _run(self) -> None:
        poll = max(min(self.deadline_s / 4.0, 1.0), 0.02)
        heartbeat, on_wedged = self._heartbeat, self._on_wedged
        while not self._stop.wait(poll):
            hb = heartbeat()
            if hb is None:
                continue
            phase, t0 = hb
            age = time.monotonic() - t0
            if age <= self.deadline_s:
                continue
            log.critical(
                "engine step wedged for %.1fs (> ARKS_DISPATCH_DEADLINE_S="
                "%.1fs) in phase %r; flipping readiness and exiting 70 so "
                "the supervisor restarts the process", age, self.deadline_s,
                phase)
            try:
                on_wedged(phase, age)
            except Exception as e:  # the escalation must not be derailed
                swallowed("watchdog.on_wedged", e)
            self._exit_fn(70)
            return
