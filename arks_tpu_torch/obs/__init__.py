"""Observability (the port of ``arks_tpu/obs/``): per-request span
timelines, flight recorder, Perfetto export, on-demand ``torch.profiler``
windows, and log correlation.

Submodules:

- ``trace``    — W3C traceparent context, the lock-light per-thread event
  rings the engine step loop appends to, off-thread trace assembly, and
  the bounded tail-retention ``TraceStore``.
- ``perfetto`` — Chrome trace-event (Perfetto-loadable) export.
- ``profiler`` — ``torch.profiler`` windows (HTTP-armed or auto-armed on a
  step-time spike).
- ``logctx``   — contextvar-backed logging filter stamping
  ``request_id``/``trace_id`` into log records.
"""
