"""Per-request span timelines from the engine's lifecycle seams (a copy of
``arks_tpu/obs/trace.py``; it reads its settings through the port's
``knobs``).

The design splits the work by thread so the scheduler never pays for
observability:

- **Hot path** (engine step loop, ``Tracer.evt``): append one small tuple
  into a per-thread overwrite ring — one slot write plus an index
  increment, no locks, no allocation beyond the record tuple, no
  serialization.  The slot is written *before* the index advances, so a
  concurrent reader under the GIL only ever sees complete records.
- **Off thread** (the collector, ``Tracer.flush``): drain the rings with
  per-ring cursors, pair begin/end markers into spans, fold in upstream
  (gateway/router) spans carried on the request's ``TraceCtx``, decide
  retention, and file the finished timeline in the bounded
  :class:`TraceStore`.

Retention is **tail-based**: traces that faulted, were quarantined, were
preempted, or violated their SLO tier target are always kept; the rest
are sampled at ``ARKS_TRACE_SAMPLE`` (default 1.0).  ``ARKS_TRACE=0``
disables event recording entirely — token streams are byte-identical
either way (the tracer records, it never schedules).

The same rings double as a **flight recorder**: :meth:`Tracer.tail`
returns the last-N events across every thread, which the watchdog's
wedged-dispatch dump and the fault-recovery path attach to their
diagnostics so a dead process ships its own timeline.
"""

from __future__ import annotations

import collections
import json
import os
import random
import threading
import time

from arks_tpu_torch import knobs
from arks_tpu_torch.utils.swallow import swallowed

TRACEPARENT_HEADER = "traceparent"
SPANS_HEADER = "x-arks-trace-spans"

# Span names that flag a trace for unconditional retention.
_FLAG_NAMES = {
    "fault": "faulted",
    "quarantined": "quarantined",
    "park.preempt": "preempted",
    "slo_violation": "slo_violation",
    "replay": "faulted",
}

# Engine-scope (rid-less) span names attached to overlapping request
# traces; everything else engine-scope (phase.* markers) is export-only.
_ATTACH_NAMES = ("pipe", "spill", "recover")

# Events that end a request's timeline.  ``finish`` fires in
# ``_finish``; ``quarantined`` requests fail outside the slot machinery
# and never reach ``_finish``.
_TERMINAL = ("finish", "quarantined")


def _hexid(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


class TraceCtx:
    """W3C trace context for one hop, plus upstream component spans.

    ``upstream`` carries the spans completed by earlier hops (gateway
    admit, router pick) as a list of dicts with a ``component`` key —
    they were serialized into the ``x-arks-trace-spans`` header because
    those processes keep no store of their own; the engine-side trace is
    the single assembly point.
    """

    __slots__ = ("trace_id", "span_id", "parent_id", "flags", "upstream")

    def __init__(self, trace_id: str | None = None, span_id: str | None = None,
                 parent_id: str | None = None, flags: str = "01",
                 upstream: list | None = None) -> None:
        self.trace_id = trace_id or _hexid(16)
        self.span_id = span_id or _hexid(8)
        self.parent_id = parent_id
        self.flags = flags
        self.upstream = upstream or []

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{self.flags}"

    def child(self) -> "TraceCtx":
        """A new span id under the same trace (the next hop's context)."""
        return TraceCtx(trace_id=self.trace_id, parent_id=self.span_id,
                        flags=self.flags, upstream=list(self.upstream))

    @classmethod
    def parse(cls, header: str | None) -> "TraceCtx | None":
        """Parse a ``traceparent`` header; None if absent or malformed."""
        if not header:
            return None
        parts = header.strip().split("-")
        if len(parts) != 4:
            return None
        ver, tid, sid, flags = parts
        if len(ver) != 2 or len(tid) != 32 or len(sid) != 16 or len(flags) != 2:
            return None
        try:
            int(tid, 16), int(sid, 16), int(flags, 16)
        except ValueError:
            return None
        if tid == "0" * 32 or sid == "0" * 16:
            return None
        return cls(trace_id=tid, parent_id=sid, flags=flags)

    @classmethod
    def from_headers(cls, headers) -> "TraceCtx":
        """Build the context for this hop from incoming HTTP headers:
        continue the propagated trace (minting this hop's span id) or
        mint a fresh root; fold in the upstream-spans header."""
        ctx = cls.parse(headers.get(TRACEPARENT_HEADER))
        if ctx is None:
            ctx = cls()
        raw = headers.get(SPANS_HEADER)
        if raw:
            try:
                spans = json.loads(raw)
                if isinstance(spans, list):
                    ctx.upstream = [s for s in spans if isinstance(s, dict)]
            except ValueError:
                pass
        return ctx


def spans_header(spans: list[dict]) -> str:
    """Serialize completed upstream spans for the forward header."""
    return json.dumps(spans, separators=(",", ":"))


class _Ring:
    """Per-thread overwrite ring.  Append is slot-write-then-index-bump —
    safe against the off-thread reader under the GIL without a lock."""

    __slots__ = ("buf", "cap", "idx", "seen", "tname")

    def __init__(self, cap: int) -> None:
        self.buf: list = [None] * cap
        self.cap = cap
        self.idx = 0        # writer position (monotonic)
        self.seen = 0       # collector cursor
        self.tname = threading.current_thread().name


class Tracer:
    """Event recording + off-thread trace assembly for one engine."""

    def __init__(self, enabled: bool | None = None) -> None:
        if enabled is None:
            enabled = knobs.get_bool("ARKS_TRACE")
        self.enabled = enabled
        self.ring_cap = knobs.get_int("ARKS_TRACE_RING")
        self.sample = knobs.get_float("ARKS_TRACE_SAMPLE")
        self.tail_n = knobs.get_int("ARKS_TRACE_TAIL")
        self.flush_s = knobs.get_float("ARKS_TRACE_FLUSH_S")
        self.store = TraceStore(knobs.get_int("ARKS_TRACE_MAX"))
        self._tl = threading.local()
        self._rings: list[_Ring] = []
        self._lock = threading.Lock()          # ring creation + meta only
        self._flush_lock = threading.Lock()    # collector/flush exclusion
        self._meta: dict[str, dict] = {}       # rid -> ctx/tier/tail
        self._pending: dict[str, list] = {}    # rid -> drained records
        self._done: list[str] = []             # rids with a terminal event
        self._open_eng: dict[str, list] = {}   # engine-scope B/E pairing
        self._engine_spans: collections.deque = collections.deque(maxlen=2048)
        self._phase_spans: collections.deque = collections.deque(maxlen=2048)
        self._thread: threading.Thread | None = None
        self._stopping = threading.Event()

    # ---- hot path -------------------------------------------------------

    def evt(self, rid, name, ph="I", arg=None):
        """Record one event.  ``rid`` is the request id ("" / None for
        engine-scope events); ``ph`` is "B"/"E"/"I" (begin/end/instant).
        This is the ONLY tracer entry point the step loop may call."""
        if not self.enabled:
            return
        try:
            ring = self._tl.ring
        except AttributeError:
            ring = self._new_ring()
        i = ring.idx
        ring.buf[i % ring.cap] = (time.monotonic(), rid, name, ph, arg)
        ring.idx = i + 1

    def _new_ring(self) -> _Ring:
        ring = _Ring(self.ring_cap)
        with self._lock:
            self._rings.append(ring)
        self._tl.ring = ring
        return ring

    # ---- registration (server threads / slow paths) ---------------------

    def register(self, rid: str, ctx: TraceCtx | None = None,
                 tier: str | None = None) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._meta[rid] = {"ctx": ctx, "tier": tier, "tail": None}

    def attach_tail(self, rid: str, tail: list) -> None:
        """Pin the flight-recorder tail onto a request's eventual trace
        (fault recovery calls this for every culprit/quarantined rid)."""
        if not self.enabled:
            return
        with self._lock:
            self._meta.setdefault(
                rid, {"ctx": None, "tier": None, "tail": None})["tail"] = tail

    def live_ids(self, limit: int = 8) -> str:
        """Compact 'rid=trace_id' list of registered in-flight requests —
        stamped into profiler annotations while a window is active."""
        with self._lock:
            items = list(self._meta.items())[:limit]
        return ",".join(
            f"{rid}={m['ctx'].trace_id}" if m.get("ctx") else rid
            for rid, m in items)

    # ---- flight recorder ------------------------------------------------

    def tail(self, n: int | None = None) -> list[dict]:
        """Last-N events across every thread ring, oldest first."""
        if not self.enabled:
            return []
        n = n or self.tail_n
        with self._lock:
            rings = list(self._rings)
        recs = []
        for ring in rings:
            idx = ring.idx
            for i in range(max(0, idx - ring.cap), idx):
                r = ring.buf[i % ring.cap]
                if r is not None:
                    recs.append((r, ring.tname))
        recs.sort(key=lambda p: p[0][0])
        return [{"t": round(r[0], 6), "rid": r[1], "name": r[2],
                 "ph": r[3], "arg": _plain(r[4]), "thread": tn}
                for r, tn in recs[-n:]]

    # ---- collector ------------------------------------------------------

    def start(self) -> None:
        if not self.enabled or self._thread is not None:
            return
        self._stopping.clear()
        self._thread = threading.Thread(
            target=self._loop, name="trace-collect", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        t, self._thread = self._thread, None
        if t is not None:
            self._stopping.set()
            t.join(timeout=5)
        if self.enabled:
            self.flush()

    def _loop(self) -> None:
        while not self._stopping.wait(self.flush_s):
            try:
                self.flush()
            except Exception as e:
                # Keep the flusher thread alive, but a failed flush means
                # trace loss — surface it.
                swallowed("trace.flush", e, warn=True)

    def flush(self) -> None:
        """Drain the rings and assemble every finished trace.  Safe from
        any non-step-loop thread; also the synchronous entry the HTTP
        endpoints and the fault path use."""
        if not self.enabled:
            return
        with self._flush_lock:
            self._drain()
            self._assemble_done()
            self._gc_pending()

    _PENDING_CAP = 4096

    def _gc_pending(self) -> None:
        """Aborted/errored requests can end without a terminal event;
        drop the stalest pending timelines rather than grow forever."""
        excess = len(self._pending) - self._PENDING_CAP
        if excess <= 0:
            return
        stale = sorted(self._pending,
                       key=lambda r: self._pending[r][-1][0])[:excess]
        with self._lock:
            for rid in stale:
                self._pending.pop(rid, None)
                self._meta.pop(rid, None)

    def _drain(self) -> None:
        with self._lock:
            rings = list(self._rings)
        for ring in rings:
            idx = ring.idx
            for i in range(max(ring.seen, idx - ring.cap), idx):
                rec = ring.buf[i % ring.cap]
                if rec is None:
                    continue
                t, rid, name, ph, arg = rec
                if not rid:
                    self._fold_engine(t, name, ph, arg)
                    continue
                self._pending.setdefault(rid, []).append(rec)
                if name in _TERMINAL:
                    self._done.append(rid)
            ring.seen = idx

    def _fold_engine(self, t, name, ph, arg) -> None:
        if ph == "B":
            self._open_eng.setdefault(name, []).append((t, arg))
            return
        if ph == "E" and self._open_eng.get(name):
            t0, a0 = self._open_eng[name].pop(0)
            span = {"name": name, "start": t0, "end": t,
                    "arg": arg if arg is not None else a0}
        else:
            span = {"name": name, "start": t, "end": t, "arg": arg}
        if name in _ATTACH_NAMES:
            self._engine_spans.append(span)
        else:
            self._phase_spans.append(span)

    def _assemble_done(self) -> None:
        done, self._done = self._done, []
        for rid in done:
            events = self._pending.pop(rid, None)
            if events is None:
                continue
            with self._lock:
                meta = self._meta.pop(rid, None) or {}
            trace = self._assemble(
                rid, sorted(events, key=lambda e: e[0]), meta)
            keep = bool(trace["flags"]) or random.random() < self.sample
            if keep:
                self.store.add(trace)

    def _assemble(self, rid: str, events: list, meta: dict) -> dict:
        spans: list[dict] = []
        open_: dict[str, list] = {}
        flags: set[str] = set()
        for t, _rid, name, ph, arg in events:
            flag = _FLAG_NAMES.get(name)
            if flag:
                flags.add(flag)
            if ph == "B":
                open_.setdefault(name, []).append((t, arg))
            elif ph == "E":
                if open_.get(name):
                    t0, a0 = open_[name].pop(0)
                    spans.append({"name": name, "component": "engine",
                                  "start": t0, "end": t,
                                  "arg": _plain(arg if arg is not None else a0)})
                else:
                    spans.append({"name": name, "component": "engine",
                                  "start": t, "end": t, "arg": _plain(arg)})
            else:
                spans.append({"name": name, "component": "engine",
                              "start": t, "end": t, "arg": _plain(arg)})
        for name, rest in open_.items():
            for t0, a0 in rest:    # parked at fault/abort: open span
                spans.append({"name": name, "component": "engine",
                              "start": t0, "end": None, "arg": _plain(a0)})
        t_lo = events[0][0]
        t_hi = max(e[0] for e in events)
        for sp in self._engine_spans:
            if sp["end"] is not None and sp["end"] >= t_lo \
                    and sp["start"] <= t_hi:
                spans.append({"component": "engine", **sp,
                              "arg": _plain(sp["arg"])})
        ctx: TraceCtx | None = meta.get("ctx")
        if ctx is not None:
            for up in ctx.upstream:
                spans.append({"component": "upstream", **up})
        spans.sort(key=lambda s: s["start"])
        return {
            "trace_id": ctx.trace_id if ctx else _hexid(16),
            "span_id": ctx.span_id if ctx else _hexid(8),
            "parent_id": ctx.parent_id if ctx else None,
            "request_id": rid,
            "tier": meta.get("tier"),
            "flags": sorted(flags),
            "start": t_lo,
            "end": t_hi,
            "spans": spans,
            "flight_tail": meta.get("tail"),
        }

    def phase_spans(self) -> list[dict]:
        """Recent engine-scope scheduler-phase spans (export only)."""
        return list(self._phase_spans)


def _plain(arg):
    """Coerce an event payload to something JSON-serializable."""
    if arg is None or isinstance(arg, (str, int, float, bool)):
        return arg
    if isinstance(arg, (list, tuple)):
        return [_plain(a) for a in arg]
    return str(arg)


class TraceStore:
    """Bounded in-proc store of finished traces with tail-based eviction:
    when full, the oldest *unflagged* trace goes first — faulted,
    quarantined, preempted, and SLO-violating timelines outlive the
    sampled bulk."""

    def __init__(self, cap: int) -> None:
        self.cap = max(cap, 1)
        self._lock = threading.Lock()
        self._by_trace: collections.OrderedDict[str, dict] = \
            collections.OrderedDict()
        self._by_rid: dict[str, str] = {}

    def add(self, trace: dict) -> None:
        with self._lock:
            tid = trace["trace_id"]
            self._by_trace[tid] = trace
            self._by_rid[trace["request_id"]] = tid
            while len(self._by_trace) > self.cap:
                victim = next(
                    (k for k, v in self._by_trace.items() if not v["flags"]),
                    next(iter(self._by_trace)))
                gone = self._by_trace.pop(victim)
                self._by_rid.pop(gone["request_id"], None)

    def get(self, key: str) -> dict | None:
        with self._lock:
            tid = self._by_rid.get(key, key)
            return self._by_trace.get(tid)

    def all(self) -> list[dict]:
        with self._lock:
            return list(self._by_trace.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._by_trace)
