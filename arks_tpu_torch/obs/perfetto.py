"""Chrome trace-event (Perfetto-loadable) export of assembled traces (a
copy of ``arks_tpu/obs/perfetto.py``).

``chrome_trace`` renders the TraceStore's finished timelines plus the
engine-scope scheduler-phase spans as a Chrome trace-event JSON object —
open it at https://ui.perfetto.dev or chrome://tracing.  Layout: one
"process" per component (gateway / router / engine), one "thread" per
request, so a request's spans line up on one row and cross-component
hops read left to right under a single trace id.
"""

from __future__ import annotations

_PIDS = {"gateway": 1, "router": 2, "upstream": 2, "engine": 3}
_ENGINE_LOOP_TID = 0


def _component_pid(span: dict) -> int:
    return _PIDS.get(span.get("component", "engine"), 3)


def chrome_trace(traces: list[dict], phase_spans: list[dict] = ()) -> dict:
    """Render finished traces (and optional engine phase spans) as a
    Chrome trace-event object: ``{"traceEvents": [...]}``."""
    events: list[dict] = []
    tids: dict[str, int] = {}
    for pid_name, pid in (("gateway", 1), ("router", 2), ("engine", 3)):
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": pid_name}})
    events.append({"name": "thread_name", "ph": "M", "pid": 3,
                   "tid": _ENGINE_LOOP_TID, "args": {"name": "engine-loop"}})

    for tr in traces:
        rid = tr["request_id"]
        tid = tids.setdefault(rid, len(tids) + 1)
        for pid in (1, 2, 3):
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": rid}})
        args = {"request_id": rid, "trace_id": tr["trace_id"],
                "flags": tr["flags"]}
        if tr.get("tier"):
            args["tier"] = tr["tier"]
        for sp in tr["spans"]:
            start = sp.get("start")
            if start is None:
                continue
            end = sp.get("end")
            ev = {"name": sp["name"], "ph": "X",
                  "ts": round(start * 1e6, 1),
                  "dur": round(((end if end is not None else start) - start)
                               * 1e6, 1),
                  "pid": _component_pid(sp), "tid": tid,
                  "cat": sp.get("component", "engine"), "args": dict(args)}
            if sp.get("arg") is not None:
                ev["args"]["arg"] = sp["arg"]
            if end is None:
                ev["args"]["open"] = True
            events.append(ev)

    for sp in phase_spans:
        if sp.get("start") is None:
            continue
        end = sp.get("end") if sp.get("end") is not None else sp["start"]
        events.append({"name": sp["name"], "ph": "X",
                       "ts": round(sp["start"] * 1e6, 1),
                       "dur": round((end - sp["start"]) * 1e6, 1),
                       "pid": 3, "tid": _ENGINE_LOOP_TID, "cat": "phase",
                       "args": ({"arg": sp["arg"]}
                                if sp.get("arg") is not None else {})})

    return {"traceEvents": events, "displayTimeUnit": "ms"}
