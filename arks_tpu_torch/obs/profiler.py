"""On-demand ``torch.profiler`` windows (the port of
``arks_tpu/obs/profiler.py``, which opens ``jax.profiler`` traces).

Armed two ways:

- **HTTP**: ``POST /v1/profiler/start`` / ``POST /v1/profiler/stop`` on
  the serving port.  A window records CPU operations and, on a CUDA
  machine, the device's kernels; ``stop`` writes ``trace.json`` (Chrome
  trace events, loadable in Perfetto) into the window's directory under
  ``ARKS_PROF_DIR``.
- **Auto-arm**: when a step's wall time jumps past
  ``ARKS_PROF_AUTO_ARM`` × the trailing median step time (default 0 =
  off), a window of ``ARKS_PROF_WINDOW_S`` seconds opens by itself — the
  profile of the anomaly, captured while it is still happening.

While a window is active the engine run loop wraps each step in a
``torch.profiler.record_function`` named ``arks_step[<live ids>]``, so
device timelines correlate back to the span timelines in the TraceStore.
All hooks are called from the run loop and early-return to a couple of
float compares when idle.

A window opens and closes on the engine loop's thread (``bind``): the
profiler records the CPU side (operators, the ``arks_step`` annotations)
of the thread that started it only, and a session ended on another thread
than the one that began it crashes the process.  ``start``/``stop`` from
another thread (the HTTP handlers) hand the call to the loop, which runs
it at its next iteration (``pump``).  One profiler runs at a time in a
process: a window cannot open inside another ``torch.profiler`` session.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import threading
import time

from arks_tpu_torch import knobs

log = logging.getLogger("arks_tpu_torch.profiler")

TRACE_FILE = "trace.json"
# How long a start/stop from another thread waits for the loop to take it.
HANDOFF_S = 30.0


class ProfilerWindows:
    def __init__(self, base_dir: str | None = None) -> None:
        self.base_dir = base_dir or knobs.get_str("ARKS_PROF_DIR")
        self.auto_mult = knobs.get_float("ARKS_PROF_AUTO_ARM")
        self.window_s = knobs.get_float("ARKS_PROF_WINDOW_S")
        self.active = False
        self.dir: str | None = None
        self.auto_armed_total = 0
        self._lock = threading.Lock()
        self._auto_end: float | None = None
        self._steps: collections.deque = collections.deque(maxlen=128)
        self._prof = None
        self._loop: threading.Thread | None = None
        self._cmd = None                 # (fn, result box, done event)
        self._cmd_lock = threading.Lock()

    # ---- the owning thread ---------------------------------------------

    def bind(self, thread: threading.Thread | None) -> None:
        """Make ``thread`` (the engine loop) the one that opens and closes
        windows; None unbinds it and refuses a call still waiting."""
        self._loop = thread
        if thread is None:
            with self._cmd_lock:
                cmd, self._cmd = self._cmd, None
            if cmd is not None:
                cmd[1]["r"] = {"ok": False, "error": "engine loop stopped"}
                cmd[2].set()

    def pump(self) -> None:
        """Loop hook: run the start or stop another thread handed over."""
        if self._cmd is None:
            return
        with self._cmd_lock:
            cmd, self._cmd = self._cmd, None
        if cmd is not None:
            fn, box, done = cmd
            box["r"] = fn()
            done.set()

    def _on_loop(self, fn) -> dict:
        loop = self._loop
        if loop is None or loop is threading.current_thread() \
                or not loop.is_alive():
            return fn()
        box, done = {}, threading.Event()
        with self._cmd_lock:
            if self._cmd is not None:
                return {"ok": False, "error": "busy"}
            self._cmd = (fn, box, done)
        if not done.wait(HANDOFF_S):
            with self._cmd_lock:
                if self._cmd is not None and self._cmd[1] is box:
                    self._cmd = None
                    return {"ok": False, "error": "engine loop busy"}
            done.wait()          # the loop took it meanwhile
        return box["r"]

    # ---- windows --------------------------------------------------------

    def start(self, logdir: str | None = None) -> dict:
        """Open a profiler window (on the loop's thread).  Returns {"ok",
        "dir"} or an error."""
        return self._on_loop(lambda: self._start(logdir))

    def stop(self) -> dict:
        """Close the window and write its trace (on the loop's thread)."""
        return self._on_loop(self._stop)

    def _start(self, logdir: str | None) -> dict:
        with self._lock:
            if self.active:
                return {"ok": False, "error": "already_active",
                        "dir": self.dir}
            d = logdir or os.path.join(
                self.base_dir, time.strftime("%Y%m%d-%H%M%S"))
            try:
                os.makedirs(d, exist_ok=True)
                import torch
                from torch.profiler import ProfilerActivity, profile
                acts = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(ProfilerActivity.CUDA)
                prof = profile(activities=acts)
                prof.start()
            except Exception as e:
                log.debug("profiler start failed", exc_info=True)
                return {"ok": False, "error": f"{type(e).__name__}: {e}"}
            self._prof = prof
            self.dir = d
            self.active = True
            return {"ok": True, "dir": d}

    def _stop(self) -> dict:
        with self._lock:
            if not self.active:
                return {"ok": False, "error": "not_active"}
            self.active = False
            self._auto_end = None
            d, self.dir = self.dir, None
            prof, self._prof = self._prof, None
            try:
                prof.stop()
                prof.export_chrome_trace(os.path.join(d, TRACE_FILE))
            except Exception as e:
                log.debug("profiler stop failed", exc_info=True)
                return {"ok": False, "error": f"{type(e).__name__}: {e}",
                        "dir": d}
            return {"ok": True, "dir": d}

    def on_step(self, dur_s: float) -> None:
        """Run-loop hook: feed one step's wall time.  Closes an expired
        auto window; opens one when the step time spikes past
        ``auto_mult`` × the trailing median."""
        if self.active:
            if self._auto_end is not None and time.monotonic() > self._auto_end:
                self._stop()
            return
        if self.auto_mult <= 0:
            return
        steps = self._steps
        steps.append(dur_s)
        if len(steps) < 32:
            return
        ordered = sorted(steps)
        med = ordered[len(ordered) // 2]
        if med > 0 and dur_s > self.auto_mult * med:
            r = self._start(None)
            if r.get("ok"):
                self._auto_end = time.monotonic() + self.window_s
                self.auto_armed_total += 1

    def annotate(self, name: str, ids: str = ""):
        """A ``torch.profiler.record_function`` stamping the live span ids
        into the profile's timeline; a null context if it cannot open."""
        try:
            import torch
            label = f"{name}[{ids}]" if ids else name
            return torch.profiler.record_function(label)
        except Exception as e:
            log.debug("profiler annotation failed: %s", e, exc_info=e)
            return contextlib.nullcontext()
