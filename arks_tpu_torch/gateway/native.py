"""ctypes bindings for the gateway's native data-plane library (the port's
copy of ``arks_tpu/gateway/native.py``, over its own copy of the source,
``arks_tpu_torch/csrc/arksgw.cpp``).

The reference's gateway hot loops run in compiled Go; ours run here when
the shared library builds (g++ at first use) and loads.  ``ARKS_NATIVE=0``
turns it off; ``ARKS_NATIVE_LIB`` points at a prebuilt .so.

Two surfaces, mirroring pkg/gateway's hot paths:
- ``NativeCounterBackend`` — fixed-window rate-limit counters
  (ratelimiter/redis_impl.go semantics, in-process).  Drop-in for
  ``ratelimiter.CounterBackend``.
- ``SseUsageScanner`` — incremental SSE frame scanner extracting the final
  usage object (handle_response.go:113-133), robust to arbitrary chunk
  fragmentation including frames and keys split across feeds.

The library lands in ``build/arks_tpu_torch/`` beside the package (listed
in ``.gitignore``), named by a hash of the source and the flags.  Each
build writes a temporary file of its own and renames it into place, so
processes that build at once (test workers, gateway replicas) each load a
whole library; the reference builds in place, where two such builds race.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
import time
from pathlib import Path

from arks_tpu_torch import knobs

log = logging.getLogger("arks_tpu_torch.gateway.native")

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "arksgw.cpp"
BUILD_DIR = _PKG.parent / "build" / "arks_tpu_torch"
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False
_error: str | None = None     # why the library is unavailable


def lib_path() -> Path:
    """The library's path, named by a hash of its source and the flags."""
    tag = hashlib.sha1(SOURCE.read_bytes()
                       + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libarksgw-{tag}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path.  Raises
    ``RuntimeError`` when g++ is missing or fails."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.{threading.get_ident()}.so")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp),
                               str(SOURCE)],
                              capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ could not build {SOURCE.name}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE.name} (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.arks_store_new.restype = ctypes.c_void_p
    lib.arks_store_free.argtypes = [ctypes.c_void_p]
    lib.arks_store_get.restype = ctypes.c_longlong
    lib.arks_store_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_double]
    lib.arks_store_incr.restype = ctypes.c_longlong
    lib.arks_store_incr.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_longlong, ctypes.c_double,
                                    ctypes.c_double]
    lib.arks_store_size.restype = ctypes.c_longlong
    lib.arks_store_size.argtypes = [ctypes.c_void_p]
    lib.arks_sse_new.restype = ctypes.c_void_p
    lib.arks_sse_free.argtypes = [ctypes.c_void_p]
    lib.arks_sse_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_size_t]
    lib.arks_sse_result.restype = ctypes.c_int
    lib.arks_sse_result.argtypes = [ctypes.c_void_p] + \
        [ctypes.POINTER(ctypes.c_longlong)] * 3
    lib.arks_sse_done.restype = ctypes.c_int
    lib.arks_sse_done.argtypes = [ctypes.c_void_p]
    return lib


def _load() -> ctypes.CDLL | None:
    """The library, built and loaded once per process; None (and the
    reason in ``_error``) when it is off or does not build or load."""
    global _lib, _tried, _error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not knobs.get_bool("ARKS_NATIVE"):
            _error = "ARKS_NATIVE=0"
            return None
        try:
            path = knobs.get_str("ARKS_NATIVE_LIB") or str(build())
            _lib = _bind(ctypes.CDLL(path))
        except (OSError, RuntimeError, AttributeError) as e:
            _error = str(e)
            log.warning("native gateway library unavailable: %s", e)
        return _lib


def available() -> bool:
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native gateway library unavailable: {_error}")
    return lib


class NativeCounterBackend:
    """CounterBackend over the C++ store (see ratelimiter.CounterBackend)."""

    def __init__(self) -> None:
        self._lib = _require()
        self._h = self._lib.arks_store_new()

    def get(self, key: str) -> int:
        return self._lib.arks_store_get(self._h, key.encode(), time.time())

    def incr(self, key: str, amount: int, ttl_s: int) -> int:
        return self._lib.arks_store_incr(self._h, key.encode(), amount,
                                         float(ttl_s), time.time())

    def __len__(self) -> int:
        return self._lib.arks_store_size(self._h)

    def __del__(self) -> None:
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h:
            lib.arks_store_free(h)


class SseUsageScanner:
    """Incremental usage extraction from an SSE byte stream."""

    def __init__(self) -> None:
        self._lib = _require()
        self._h = self._lib.arks_sse_new()

    def feed(self, chunk: bytes) -> None:
        self._lib.arks_sse_feed(self._h, chunk, len(chunk))

    def usage(self) -> dict | None:
        p = ctypes.c_longlong()
        c = ctypes.c_longlong()
        t = ctypes.c_longlong()
        if not self._lib.arks_sse_result(self._h, ctypes.byref(p),
                                         ctypes.byref(c), ctypes.byref(t)):
            return None
        out = {}
        if p.value >= 0:
            out["prompt_tokens"] = p.value
        if c.value >= 0:
            out["completion_tokens"] = c.value
        if t.value >= 0:
            out["total_tokens"] = t.value
        return out or None

    @property
    def done(self) -> bool:
        return bool(self._lib.arks_sse_done(self._h))

    def __del__(self) -> None:
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h:
            lib.arks_sse_free(h)
