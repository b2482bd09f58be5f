"""Log correlation: stamp ``request_id``/``trace_id`` into log records (a
copy of ``arks_tpu/obs/logctx.py``).

A ``contextvars``-backed :class:`ContextFilter` sets ``record.request_id``
and ``record.trace_id`` on every record (``"-"`` when unbound) and, when
bound, appends a ``[rid=... trace=...]`` suffix to the message so
grep-by-request works with ANY formatter — no handler reconfiguration
required.  Server/router/gateway request threads bind around each
request; the engine binds in ``add_request`` and per-survivor in the
recovery path.  Format documented in docs/runbook.md.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging

request_id_var: contextvars.ContextVar = contextvars.ContextVar(
    "arks_request_id", default=None)
trace_id_var: contextvars.ContextVar = contextvars.ContextVar(
    "arks_trace_id", default=None)


class ContextFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        rid = request_id_var.get()
        tid = trace_id_var.get()
        record.request_id = rid or "-"
        record.trace_id = tid or "-"
        if rid or tid:
            # The suffix is literal text with no %-directives, so it is
            # safe to append before the formatter applies record.args.
            suffix = f" [rid={rid or '-'} trace={tid or '-'}]"
            msg = str(record.msg)
            if not msg.endswith(suffix):
                record.msg = msg + suffix
        return True


def install(logger: logging.Logger) -> None:
    """Attach the filter once (idempotent)."""
    if not any(isinstance(f, ContextFilter) for f in logger.filters):
        logger.addFilter(ContextFilter())


@contextlib.contextmanager
def bound(request_id: str | None = None, trace_id: str | None = None):
    """Bind ids for the current thread/context for the duration."""
    toks = []
    if request_id is not None:
        toks.append((request_id_var, request_id_var.set(request_id)))
    if trace_id is not None:
        toks.append((trace_id_var, trace_id_var.set(trace_id)))
    try:
        yield
    finally:
        for var, tok in toks:
            var.reset(tok)
