"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by nvcc, by hand, into a shared library
with a plain C interface and loaded with ``ctypes`` — seconds per kernel, no
PyTorch headers and no ninja.  Libraries land in ``build/arks_tpu_torch/``
beside the package (listed in ``.gitignore``), named by a hash of the
source, the headers of ``csrc/`` and the flags, so an edited source or
header never loads a stale build.  Nothing
is built at import time: a kernel is built by its first launch or by
``build_all`` (which starts one nvcc per source, all at once).
``--split-compile=0`` lets nvcc optimise the template instances of one
source in parallel threads (the attention source's 12 took 33 s in one
thread on the H100 machine, 15 s split).

The flags keep IEEE division and round-to-nearest-even (no
``--use_fast_math``): the quantize-and-write kernel needs both to give the
reference's int8/int4 values and scales bit for bit, and the attention
kernel's exp/divide stay close to the reference's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "arks_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float

# C entry points: name -> (source stem, argtypes).  Every entry returns the
# cudaError_t of its launch (0 = success).
_SIGNATURES: dict[str, tuple[str, list]] = {
    "arks_paged_kv_update": ("paged_kv_update", [
        _P, _P, _P, _P,          # k_pool, v_pool, k_new, v_new
        _P, _P, _P,              # dst [T] or NULL; write_idx [T], tables
                                 # [T, MaxP] (read when dst is NULL)
        _I, _I, _I, _I, _I, _I,  # T, hkv, max_pages, n_pages, page, row_bytes
        _I, _I, _P]),            # layer, narrow (f32 rows -> bf16), stream
    "arks_paged_kv_update_quant": ("paged_kv_update_quant", [
        _P, _P, _P, _P,          # k_pool, v_pool (int8), k_scale, v_scale
        _P, _P,                  # k_new, v_new
        _P, _P, _P,              # dst [T] or NULL; write_idx [T], tables
        _I, _I, _I, _I, _I, _I,  # T, hkv, head_dim, max_pages, n_pages, page
        _I, _I, _I, _P]),        # int4, layer, dtype code, stream
    "arks_paged_mixed_attention": ("paged_mixed_attention", [
        _P, _P, _P, _P,          # q [T,H,D], out [T,H,D], k_pool, v_pool
        _P, _P,                  # k_scale, v_scale [L,N,Hkv,P] f32 or NULL
        _P, _P, _P, _P,          # tables [S,MaxP], pos_start, q_start, q_len
        _P, _P, _P, _P, _P,      # work list: seq, head, qb, plo, pages
        _P, _P, _P,              # pieces: pcum, pbase, pitem
        _P, _L,                  # partials [rows, D+4] f32, their rows
        _P, _P, _P,              # carry m [T,H], l [T,H], acc [T,H,D] or NULL
        _P, _P, _P,              # emit m, l, acc or NULL
        _I, _I, _I, _I, _I,      # n_items, n_heads, hkv, head_dim, page
        _I, _I, _I, _I,          # n_pages, max_pages, layer, block_q
        _F, _I, _I, _I, _P]),    # scale, dtype code (0 f32, 1 bf16), kv code
                                 # (0 q's dtype, 1 int8, 2 int4, 3 bf16
                                 # under f32 q), state mode, stream
    # The slot writes take their arguments packed, one int64 each (the
    # wrapper's struct.pack; csrc SlotWriteArgs / SlotQuantWriteArgs):
    # k_cache, v_cache, k_new, v_new, write_idx [B], B, hkv, max_len,
    # row_bytes, layer, narrow (f32 rows -> bf16), stream; and k_cache,
    # v_cache (int8), k_scale, v_scale, k_new, v_new, write_idx, B, hkv,
    # head_dim, max_len, layer, dtype code, stream.
    "arks_kv_cache_update": ("kv_cache_update", [ctypes.c_char_p]),
    "arks_kv_cache_update_quant": ("kv_cache_update", [ctypes.c_char_p]),
    "arks_ragged_decode_attention": ("decode_attention", [
        _P, _P, _P, _P,          # q [B,Hkv,G,D], out, k_cache, v_cache
        _P, _P, _P,              # k_scale, v_scale [L,B,Hkv,S] or NULL, lengths
        _P,                      # split-KV partials [B,Hkv,splits,G,D+2] f32
        _I, _I, _I, _I, _I, _I,  # B, n_heads, hkv, head_dim, max_len, layer
        _F, _I, _I, _P]),        # scale, dtype code, int8 cache, stream
    "arks_paged_decode_attention": ("decode_attention", [
        _P, _P, _P, _P,          # q [B,Hkv,G,D], out, k_pool, v_pool
        _P, _P, _P, _P,          # k_scale, v_scale or NULL, tables, lengths
        _P,                      # split-KV partials [B,Hkv,splits,G,D+2] f32
        _I, _I, _I, _I, _I,      # B, n_heads, hkv, head_dim, page
        _I, _I, _I,              # n_pages, max_pages, layer
        _F, _I, _I, _P]),        # scale, dtype code, int8 pool, stream
    "arks_paged_mixed_attention_dense": ("paged_mixed_attention", [
        _P, _P, _P, _P,          # q [T,H,D], out [T,H,D], k_pool, v_pool
        _P, _P,                  # k_scale, v_scale [L,N,Hkv,P] f32 or NULL
        _P, _P, _P, _P,          # tables [S,MaxP], pos_start, q_start, q_len
        _P, _P, _P,              # pieces: pcum, pbase, pitem
        _P, _L,                  # partials [rows, D+4] f32, their rows
        _I, _I, _I, _I, _I,      # S, num_qb, n_heads, hkv, head_dim
        _I, _I, _I, _I, _I,      # page, n_pages, max_pages, layer, block_q
        _F, _I, _I, _P]),        # scale, dtype code, kv code, stream
    "arks_grouped_matmul": ("grouped_matmul", [
        _P, _P, _P,              # xs [Tp,K], w, scale (NULL for raw w)
        _P, _P, _P, _P,          # block_expert, rows_used, tile_rows (each
                                 # [..] int32 or NULL), out
        _I, _I, _I, _I, _I,      # Tp, K, N, X, int4 group
        _I, _I, _P]),            # mode (0 raw, 1 int8, 2 int4), dtype, stream
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# Bound C entry points by name, filled on first use; later calls read the
# dict without the lock.
_entries: dict[str, ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels build from source at first use")


def _lib_path(stem: str) -> Path:
    """The library's path, named by a hash of its source, every header in
    ``csrc/`` (a source may include one) and the flags."""
    src = (CSRC / f"{stem}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{stem}-{tag}.so"


def _start_build(stem: str):
    """(library path, temp output, nvcc process or None when built)."""
    out = _lib_path(stem)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish_build(stem: str, out: Path, tmp: Path | None,
                  proc: subprocess.Popen | None) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{stem}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
    return log


def build_all() -> dict[str, str]:
    """Compile every kernel source concurrently (one nvcc each); returns
    {source stem: nvcc/ptxas output}.  Raises on the first failed build."""
    stems = sorted({stem for stem, _ in _SIGNATURES.values()})
    with _lock:
        started = {s: _start_build(s) for s in stems}
        return {s: _finish_build(s, *started[s]) for s in stems}


def _load(stem: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            out, tmp, proc = _start_build(stem)
            _finish_build(stem, out, tmp, proc)
            lib = ctypes.CDLL(str(out))
            for fn, (fstem, argtypes) in _SIGNATURES.items():
                if fstem == stem:
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            _libs[stem] = lib
        return lib


def entry(fn: str) -> ctypes._CFuncPtr:
    """C entry point ``fn``, bound once (its library built and loaded on
    first use)."""
    f = _entries.get(fn)
    if f is None:
        f = _entries[fn] = getattr(_load(_SIGNATURES[fn][0]), fn)
    return f


def launch(fn: str, *args) -> None:
    """Call C entry point ``fn`` (building its library on first use) and
    raise if the launch reported a CUDA error."""
    err = entry(fn)(*args)
    if err != 0:
        raise_launch_error(fn, err)


def raise_launch_error(fn: str, err: int) -> None:
    lib = _load(_SIGNATURES[fn][0])
    raise RuntimeError(f"{fn}: CUDA error {err} "
                       f"({cuda_error_name(lib, err)})")


def cuda_error_name(lib: ctypes.CDLL, err: int) -> str:
    fn = lib.arks_cuda_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(err).decode()
