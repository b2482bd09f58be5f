"""Weights: a JAX param tree bridged to the port's tensors, and weights read
from a local HuggingFace checkpoint (the port of
``arks_tpu/models/weights.py``'s safetensors path).

- ``params_from_numpy``: a JAX param tree (after ``jax.tree.map(np.asarray,
  ...)``) to the port's tensors — same keys, same ``[L, ...]`` layouts, so
  both packages compute the same function on the same weights.  MoE leaves
  carry their expert axis; quantized leaves cross as they are (int8
  ``{"q", "s"}``) or packed (int4 ``{"q", "gs"}``: the reference's ``q`` is
  an ml_dtypes int4 array, whose ``astype(np.int8)`` gives -7..7, and the
  bridge packs two values a byte along K, ``models/quant.py``'s layout).
- ``params_from_hf``: the ``*.safetensors`` shards of a checkpoint
  directory, read by this module's own reader (``HFTensors``: the format
  is an 8-byte little-endian header length, a JSON header, then the raw
  bytes; a tensor is read with ``pread`` from its shard only when it is
  asked for).  The reference's names, transposes and
  stacking: Qwen2/Llama dense (with the Qwen2 QKV bias), tied embeddings,
  Mixtral's ``block_sparse_moe`` experts and Qwen2-MoE's experts with the
  shared expert.  Projections are stored ``[in, out]`` and per-layer
  weights stacked with a leading ``[L]`` axis.
- **Bounded memory.**  The reference assembles every leaf on the host
  (the whole checkpoint: ~93 GB for Mixtral-8x7B in bf16) and moves it to
  the device leaf by leaf.  Here each leaf is allocated once on the device,
  quantized where asked, and filled one HF tensor (one layer, or one
  expert of one layer) at a time, in blocks of whole rows: a block is
  read from its file (``pread``) into a pinned host buffer, cast on the
  device to the engine
  dtype (round to nearest even, as numpy's ``astype`` in the reference),
  transposed, and — with ``weight_dtype`` int8/int4 — quantized.  An HF
  matrix's rows are the output channels (the embedding's, its quantize
  rows), and per-channel and groupwise reductions stay inside one, so
  this equals quantizing the whole leaf bit for bit.  Host memory holds
  two blocks; device memory the final tree plus one block and its
  quantize temporaries.
  Quantize-on-load copies the reference's jitted arithmetic (its scale
  multiplies by the f32 reciprocal of 127 or 7: ``quant``'s ``recip``).
- ``load_params``: the reference's order — an ``arks_orbax/`` directory
  raises (``orbax.checkpoint`` imports jax, and the port never does), then
  safetensors, then the seeded random init with the reference's warning.
"""

from __future__ import annotations

import json
import logging
import math
import os
import struct
from collections.abc import Mapping

import numpy as np
import torch

from arks_tpu_torch.device import resolve_device
from arks_tpu_torch.models import moe
from arks_tpu_torch.models import quant
from arks_tpu_torch.models.config import ModelConfig
from arks_tpu_torch.models.transformer import Params, init_params, torch_dtype
from arks_tpu_torch.ops.paged_attention import pack_int4

log = logging.getLogger("arks_tpu_torch.weights")

ORBAX_SUBDIR = "arks_orbax"

# safetensors dtype names -> torch dtypes (the ones a checkpoint's float
# weights come in); any other dtype raises when its tensor is read.
_ST_DTYPES = {"F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16}
# Elements per staged block (whole HF rows): the host buffers, the device
# copy and one quantize's f32 temporaries stay small beside the tree
# however wide the tensor.
_QBLOCK = 1 << 24


def _tensor(a) -> torch.Tensor:
    """numpy -> torch, bit for bit; bfloat16 arrays (numpy's ml_dtypes
    extension type) cross as their uint16 bit patterns."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _expected_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    l, e, f, v = (cfg.num_layers, cfg.hidden_size, cfg.intermediate_size,
                  cfg.vocab_size)
    qd, kvd = cfg.q_dim, cfg.kv_dim
    shapes = {"embed": (v, e), "final_norm": (e,), "layers/attn_norm": (l, e),
              "layers/wq": (l, e, qd), "layers/wk": (l, e, kvd),
              "layers/wv": (l, e, kvd), "layers/wo": (l, qd, e),
              "layers/mlp_norm": (l, e)}
    if cfg.num_experts:
        shapes.update({f"layers/{name}": shape for name, shape
                       in moe.moe_leaf_shapes(cfg).items()})
    else:
        shapes.update({"layers/w_gate": (l, e, f), "layers/w_up": (l, e, f),
                       "layers/w_down": (l, f, e)})
    if cfg.qkv_bias:
        shapes.update({"layers/bq": (l, qd), "layers/bk": (l, kvd),
                       "layers/bv": (l, kvd)})
    if not cfg.tie_word_embeddings:
        shapes["lm_head"] = (e, v)
    return shapes


def _quantized_leaf(path: str, arr: dict, shape: tuple, cfg: ModelConfig):
    """A quantized numpy leaf -> {"q", "s"} int8 / {"q", "gs"} packed int4
    tensors on the CPU, its shapes checked against the float ``shape``."""
    k, n = shape[-2], shape[-1]
    if "gs" in arr:
        q = np.asarray(arr["q"]).astype(np.int8)
        gs = np.asarray(arr["gs"], np.float32)
        ngroups = gs.shape[-2] if gs.ndim >= 2 else 0
        want_gs = shape[:-2] + (ngroups, n)
        if q.shape != shape or gs.shape != want_gs or not ngroups or \
                k % ngroups or k % 2:
            raise ValueError(f"{path}: int4 q {q.shape} / gs {gs.shape} != "
                             f"{shape} / {want_gs} for {cfg.name}")
        return {"q": pack_int4(torch.from_numpy(q), axis=-2),
                "gs": torch.from_numpy(gs.copy())}
    q = np.asarray(arr["q"])
    s = np.asarray(arr["s"], np.float32)
    want_s = shape[:-1] + (1,) if path == "embed" else shape[:-2] + (1, n)
    if q.dtype != np.int8 or q.shape != shape or s.shape != want_s:
        raise ValueError(f"{path}: int8 q {q.shape} {q.dtype} / s {s.shape} "
                         f"!= {shape} / {want_s} for {cfg.name}")
    return {"q": torch.from_numpy(q.copy()), "s": torch.from_numpy(s.copy())}


def params_from_numpy(tree: dict, cfg: ModelConfig,
                      device: torch.device | str | None = None,
                      dtype=None) -> Params:
    """Convert a numpy param tree with the reference's keys into the port's
    params on ``device`` (CUDA unless the caller passes "cpu"; float leaves
    cast to ``dtype`` when given, quantized leaves kept as they are).
    Raises on a missing or mis-shaped leaf."""
    device = resolve_device(device)
    dtype = torch_dtype(dtype) if dtype is not None else None
    out: Params = {"layers": {}}
    for path, shape in _expected_shapes(cfg).items():
        node, dst = tree, out
        *parents, leaf = path.split("/")
        for key in parents:
            node, dst = node[key], dst[key]
        arr = node.get(leaf)
        if arr is None:
            raise KeyError(f"param tree has no {path!r}")
        if isinstance(arr, dict):
            dst[leaf] = {name: t.to(device) for name, t in
                         _quantized_leaf(path, arr, shape, cfg).items()}
            continue
        if tuple(np.shape(arr)) != shape:
            raise ValueError(f"{path}: shape {tuple(np.shape(arr))} != "
                             f"{shape} for {cfg.name}")
        t = _tensor(arr)
        dst[leaf] = t.to(device=device, dtype=dtype or t.dtype)
    return out


# ---------------------------------------------------------------------------
# HF safetensors
# ---------------------------------------------------------------------------

class HFTensors(Mapping):
    """The reference's ``_hf_tensors``, lazily: every tensor of the
    ``*.safetensors`` shards under ``path`` (sorted by file name; a name
    repeated in a later shard wins, as in the reference's dict), by name.
    Only the headers are read up front; a tensor's bytes are read with
    ``pread`` when it is asked for (``read_into``, which the loader calls
    block by block into its own buffers), so host memory holds what the
    caller keeps and no page cache mapping.  Raises on a directory without
    shards and on a shard whose header cannot be read; reading a tensor of
    a dtype other than F32, F16 or BF16 raises, naming the tensor."""

    def __init__(self, path: str) -> None:
        files = sorted(f for f in os.listdir(path)
                       if f.endswith(".safetensors"))
        if not files:
            raise FileNotFoundError(f"no .safetensors files under {path}")
        self.files = [os.path.join(path, f) for f in files]
        self.nbytes = 0
        self._entries: dict[str, tuple] = {}
        self._fds: dict[str, int] = {}
        for fname in self.files:
            self._open(fname)

    def _open(self, fname: str) -> None:
        size = os.path.getsize(fname)
        with open(fname, "rb") as f:
            head = f.read(8)
            if len(head) < 8:
                raise ValueError(f"{fname}: not a safetensors file "
                                 f"({size} bytes)")
            (n,) = struct.unpack("<Q", head)
            if n > size - 8:
                raise ValueError(f"{fname}: header of {n} bytes overruns "
                                 f"the file ({size} bytes)")
            try:
                header = json.loads(f.read(n))
            except ValueError as e:
                raise ValueError(f"{fname}: unreadable header: {e}") from e
            if not isinstance(header, dict):
                raise ValueError(f"{fname}: header is not a JSON object")
        base = 8 + n
        for name, ent in header.items():
            if name == "__metadata__":
                continue
            try:
                dt, shape = ent["dtype"], tuple(int(x) for x in ent["shape"])
                start, end = (int(x) for x in ent["data_offsets"])
            except (KeyError, TypeError, ValueError) as e:
                raise ValueError(f"{fname}: bad header entry for {name!r}: "
                                 f"{ent!r}") from e
            if not 0 <= start <= end <= size - base:
                raise ValueError(f"{fname}: {name!r} data [{start}, {end}) "
                                 f"overruns the file")
            if dt in _ST_DTYPES:
                want = math.prod(shape) * _ST_DTYPES[dt].itemsize
                if end - start != want:
                    raise ValueError(f"{fname}: {name!r} holds {end - start} "
                                     f"bytes, {dt}{list(shape)} needs {want}")
            self._entries[name] = (dt, shape, base + start, base + end,
                                   fname)
            self.nbytes += end - start

    def __getitem__(self, name: str) -> torch.Tensor:
        """Tensor ``name``, read whole into a new CPU tensor."""
        buf = torch.empty(self.nbytes_of(name), dtype=torch.uint8)
        return self.read_into(name, None, buf)

    def _span(self, name: str, rows: slice | None):
        """(file, first byte, end byte, dtype, shape) of ``name``, or of its
        ``rows`` (leading-axis slice)."""
        dt, shape, start, end, fname = self._entries[name]
        if dt not in _ST_DTYPES:
            raise ValueError(f"{fname}: tensor {name!r} has dtype {dt}; "
                             f"supported: {', '.join(_ST_DTYPES)}")
        dtype = _ST_DTYPES[dt]
        if rows is not None:
            row = math.prod(shape[1:]) * dtype.itemsize
            start, end = start + rows.start * row, start + rows.stop * row
            shape = (rows.stop - rows.start,) + tuple(shape[1:])
        return fname, start, end, dtype, shape

    def shape_of(self, name: str) -> tuple:
        return self._entries[name][1]

    def nbytes_of(self, name: str, rows: slice | None = None) -> int:
        _, start, end, _, _ = self._span(name, rows)
        return end - start

    def read_into(self, name: str, rows: slice | None,
                  buf: torch.Tensor) -> torch.Tensor:
        """Read ``name`` (its ``rows``) from its shard file into the start
        of the byte tensor ``buf`` (a pinned buffer for the loader) with
        ``pread``, so host memory holds the buffer and no more however
        large the shard.  Returns that part of ``buf`` viewed as the
        tensor."""
        fname, start, end, dtype, shape = self._span(name, rows)
        n = end - start
        fd = self._fds.get(fname)
        if fd is None:
            fd = self._fds[fname] = os.open(fname, os.O_RDONLY)
        view = memoryview(buf[:n].numpy())
        got = 0
        while got < n:
            k = os.preadv(fd, [view[got:]], start + got)
            if k <= 0:
                raise ValueError(f"{fname}: {name!r} is cut short at byte "
                                 f"{start + got}")
            got += k
        return buf[:n].view(dtype).view(shape)

    def close(self) -> None:
        """Close the files ``read_into`` opened."""
        for fd in self._fds.values():
            os.close(fd)
        self._fds.clear()

    def __contains__(self, name) -> bool:
        return name in self._entries

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)


class _Stager:
    """Reads HF tensor blocks into two host buffers in turn (pinned on
    CUDA, where the read of block i+1 overlaps the copy of block i up the
    bus; a buffer is reused only after its copy has landed) and returns
    them on the device in the engine dtype."""

    def __init__(self, tensors: HFTensors, device: torch.device,
                 dtype: torch.dtype) -> None:
        self.t, self.device, self.dtype = tensors, device, dtype
        self._bufs: list = [None, None]     # (host bytes, event)
        self._turn = 0

    def get(self, name: str, rows: slice | None = None) -> torch.Tensor:
        """Tensor ``name`` (its ``rows``) on the device, cast."""
        cuda = self.device.type == "cuda"
        nbytes = self.t.nbytes_of(name, rows)
        buf, ev = self._bufs[self._turn] or (None, None)
        if ev is not None:
            ev.synchronize()
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=cuda)
        host = self.t.read_into(name, rows, buf)
        if cuda:
            x = host.to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
        else:
            x = host.clone()
        self._bufs[self._turn] = (buf, ev)
        self._turn ^= 1
        return x.to(self.dtype)

    def close(self) -> None:
        for item in self._bufs:
            if item is not None and item[1] is not None:
                item[1].synchronize()
        self._bufs = [None, None]


def _blocks(n: int, width: int):
    """Slices of at most ``width`` over ``range(n)``."""
    for a in range(0, n, width):
        yield slice(a, min(n, a + width))


class _Leaf:
    """One param leaf allocated on the device — float, int8 ``{"q", "s"}``
    or packed int4 ``{"q", "gs"}`` — and filled one HF tensor at a time,
    that tensor in blocks of its rows.  An HF matrix's rows are output
    channels (the embedding's rows are its quantize rows), and every scale
    reduces within one row, so each block quantizes on its own: equal to
    the whole leaf's quantize bit for bit."""

    def __init__(self, shape: tuple, dtype: torch.dtype, device, bits: int,
                 axis: int | None, group: int | None) -> None:
        self.bits = bits if axis is not None else 0
        self.axis = axis
        self.int4 = self.bits == 4 and axis == -2
        self.group = group
        if not self.bits:
            self.value = torch.empty(shape, dtype=dtype, device=device)
            return
        k, n = shape[-2], shape[-1]
        if self.int4:
            g = quant.int4_group_for(k, group)
            self.value = {
                "q": torch.empty(shape[:-2] + (k // 2, n), dtype=torch.int8,
                                 device=device),
                "gs": torch.empty(shape[:-2] + (k // g, n),
                                  dtype=torch.float32, device=device)}
        else:
            s_shape = shape[:-1] + (1,) if axis == -1 else \
                shape[:-2] + (1, n)
            self.value = {
                "q": torch.empty(shape, dtype=torch.int8, device=device),
                "s": torch.empty(s_shape, dtype=torch.float32,
                                 device=device)}

    def fill(self, idx: tuple, rows: slice, x: torch.Tensor,
             transpose: bool) -> None:
        """Write HF rows ``rows`` of slice ``idx`` from ``x`` (those rows,
        in the engine dtype): columns of the leaf's matrix when
        ``transpose``, else its rows."""
        if not self.bits:
            dst = self.value[idx]
            (dst[..., rows] if transpose else dst[rows]).copy_(
                x.T if transpose else x)
            return
        q_dst = self.value["q"][idx]
        s_dst = self.value["gs" if self.int4 else "s"][idx]
        if self.axis == -1:                       # the embedding's rows
            part = quant.quantize_tensor(x, axis=-1, recip=True)
            q_dst[rows].copy_(part["q"])
            s_dst[rows].copy_(part["s"])
        elif self.int4:
            part = quant.quantize_tensor_int4(x.T, self.group, recip=True)
            q_dst[..., rows].copy_(part["q"])
            s_dst[..., rows].copy_(part["gs"])
        else:
            part = quant.quantize_tensor(x.T, axis=-2, recip=True)
            q_dst[..., rows].copy_(part["q"])
            s_dst[..., rows].copy_(part["s"])


def _leaf_sources(cfg: ModelConfig, names) -> dict:
    """param path -> (shape, [(leading index, HF name, transpose,
    reshape)]) in the reference's names and stacking (``params_from_hf``
    :53, ``_moe_from_hf`` :157)."""
    shapes = _expected_shapes(cfg)
    l = cfg.num_layers
    out: dict = {}

    def per_layer(path, fmt, transpose=False, reshape=False):
        out[path] = (shapes[path], [((i,), fmt.format(i), transpose, reshape)
                                    for i in range(l)])

    out["embed"] = (shapes["embed"],
                    [((), "model.embed_tokens.weight", False, False)])
    per_layer("layers/attn_norm", "model.layers.{}.input_layernorm.weight")
    for leaf, proj in (("wq", "q"), ("wk", "k"), ("wv", "v"), ("wo", "o")):
        per_layer(f"layers/{leaf}",
                  f"model.layers.{{}}.self_attn.{proj}_proj.weight", True)
    per_layer("layers/mlp_norm",
              "model.layers.{}.post_attention_layernorm.weight")
    if cfg.num_experts:
        x = cfg.num_experts
        if any(".block_sparse_moe." in k for k in names):
            base = "model.layers.{}.block_sparse_moe"
            experts = {"w_gate": ".experts.{}.w1.weight",
                       "w_up": ".experts.{}.w3.weight",
                       "w_down": ".experts.{}.w2.weight"}
        else:
            base = "model.layers.{}.mlp"
            experts = {"w_gate": ".experts.{}.gate_proj.weight",
                       "w_up": ".experts.{}.up_proj.weight",
                       "w_down": ".experts.{}.down_proj.weight"}
        per_layer("layers/router", base + ".gate.weight", True)
        for leaf, tail in experts.items():
            path = f"layers/{leaf}"
            out[path] = (shapes[path], [
                ((i, e), (base + tail).format(i, e), True, False)
                for i in range(l) for e in range(x)])
        if cfg.shared_expert_intermediate_size:
            sh = "model.layers.{}.mlp.shared_expert"
            per_layer("layers/shared_gate_proj", sh + ".gate_proj.weight",
                      True)
            per_layer("layers/shared_up", sh + ".up_proj.weight", True)
            per_layer("layers/shared_down", sh + ".down_proj.weight", True)
            per_layer("layers/shared_gate",
                      "model.layers.{}.mlp.shared_expert_gate.weight",
                      reshape=True)
    else:
        for leaf, proj in (("w_gate", "gate"), ("w_up", "up"),
                           ("w_down", "down")):
            per_layer(f"layers/{leaf}",
                      f"model.layers.{{}}.mlp.{proj}_proj.weight", True)
    if cfg.qkv_bias:
        for leaf, proj in (("bq", "q"), ("bk", "k"), ("bv", "v")):
            per_layer(f"layers/{leaf}",
                      f"model.layers.{{}}.self_attn.{proj}_proj.bias")
    out["final_norm"] = (shapes["final_norm"],
                         [((), "model.norm.weight", False, False)])
    if not cfg.tie_word_embeddings:
        out["lm_head"] = (shapes["lm_head"],
                          [((), "lm_head.weight", True, False)])
    return out


def params_from_hf(cfg: ModelConfig, path: str, dtype=None,
                   weight_dtype: str = "bf16",
                   device: torch.device | str | None = None,
                   group: int | None = None) -> Params:
    """A HuggingFace checkpoint directory -> the port's params on
    ``device`` (CUDA unless the caller passes "cpu"), in ``dtype`` (the
    config's by default), quantized on load with ``weight_dtype`` int8 or
    int4 (matmul leaves; the embedding int8 in both).  Raises on a missing
    tensor, a mis-shaped one, or an unreadable shard."""
    device = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.dtype)
    bits = quant.weight_bits(weight_dtype)
    t = HFTensors(path)
    stager = _Stager(t, device, dtype)
    out: Params = {"layers": {}}
    try:
        for p, (shape, sources) in _leaf_sources(cfg, t).items():
            *parents, name = p.split("/")
            axis = (-1 if name == "embed" else
                    -2 if name in quant.MATMUL_KEYS else None)
            leaf = _Leaf(shape, dtype, device, bits, axis, group)
            for idx, hf_name, transpose, reshape in sources:
                if hf_name not in t:
                    raise KeyError(f"{path}: checkpoint has no {hf_name!r} "
                                   f"(for {p})")
                src = t.shape_of(hf_name)
                want = shape[len(idx):]
                got = src[::-1] if transpose else \
                    (math.prod(src),) if reshape else src
                if got != want:
                    raise ValueError(f"{hf_name}: shape {src} does not give "
                                     f"{want} for {p} of {cfg.name}")
                if len(src) == 2 and not reshape:
                    width = max(1, _QBLOCK // max(src[1], 1))
                    for rows in _blocks(src[0], width):
                        leaf.fill(idx, rows, stager.get(hf_name, rows),
                                  transpose)
                else:
                    leaf.value[idx].copy_(stager.get(hf_name).reshape(want))
            dst = out
            for key in parents:
                dst = dst[key]
            dst[name] = leaf.value
    finally:
        stager.close()
        t.close()
    return out


def weights_kind(model_path: str | None) -> str | None:
    """What ``load_params`` would load, from one directory scan:
    ``"orbax"`` > ``"safetensors"`` > ``None`` (random init)."""
    if not model_path:
        return None
    kind = None
    try:
        with os.scandir(model_path) as it:
            for e in it:
                if e.name == ORBAX_SUBDIR and e.is_dir():
                    return "orbax"
                if e.name.endswith(".safetensors"):
                    kind = "safetensors"
    except (FileNotFoundError, NotADirectoryError):
        return None
    return kind


def has_real_weights(model_path: str | None) -> bool:
    """True when ``load_params`` would load actual weights rather than
    take the random init."""
    return weights_kind(model_path) is not None


def load_params(cfg: ModelConfig, model_path: str | None, dtype=None,
                weight_dtype: str = "bf16",
                device: torch.device | str | None = None,
                seed: int = 0) -> Params:
    """Best available weights, in the reference's order: an Orbax
    checkpoint raises (``orbax.checkpoint`` imports jax, which the port
    never does), then safetensors, then the random init from ``seed``."""
    if model_path:
        kind = weights_kind(model_path)
        if kind == "orbax":
            raise NotImplementedError(
                f"{os.path.join(model_path, ORBAX_SUBDIR)}: Orbax "
                "checkpoints are not served by this port (orbax.checkpoint "
                "imports jax); convert the checkpoint to safetensors")
        if kind == "safetensors":
            log.info("loading HF safetensors from %s", model_path)
            return params_from_hf(cfg, model_path, dtype, weight_dtype,
                                  device)
        log.warning("no weights found under %s; using random init",
                    model_path)
    return init_params(cfg, seed, dtype or cfg.dtype, device,
                       bits=quant.weight_bits(weight_dtype))
