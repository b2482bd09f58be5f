"""The port's AKV1 wire (``arks_tpu_torch/engine/kv_transfer.py``) against
the reference's (``arks_tpu/engine/kv_transfer.py``): ``pack`` and
``pack_block`` give the same bytes for the same tensors in every pool
dtype (f32 and bf16 rows, int8 and packed int4 pages, f32 scales), each
side unpacks the other's messages to the same values, and a block whose
digest, epoch, field set or length disagrees raises ValueError on both
sides (a block of another pool layout is refused by its epoch, before
any shape could be misread)."""

import hashlib

import ml_dtypes
import numpy as np
import pytest
import torch

from arks_tpu.engine import kv_transfer as ref
from arks_tpu_torch.engine import kv_transfer as port

torch.set_num_threads(2)

DIGEST = hashlib.sha1(b"prefix").digest()
EPOCH = "0123456789abcdef"


def _pair(kind: str, shape, seed: int):
    """The same values as (numpy array for the reference, torch tensor
    for the port)."""
    rng = np.random.default_rng(seed)
    if kind == "float32":
        a = rng.standard_normal(shape).astype(np.float32)
        return a, torch.from_numpy(a.copy())
    if kind == "bfloat16":
        bits = rng.integers(0, 1 << 16, size=shape, dtype=np.uint16)
        bits &= 0x7F7F                    # finite values only
        a = bits.view(ml_dtypes.bfloat16)
        return a, torch.from_numpy(bits.view(np.int16).copy()).view(
            torch.bfloat16)
    if kind in ("int8", "int4"):
        hi = 127 if kind == "int8" else 7
        a = rng.integers(-hi, hi + 1, size=shape, dtype=np.int8)
        if kind == "int4":                # nibble pairs, as the pools hold
            a = ((a[..., 0::2] & 15) | (a[..., 1::2] << 4)).astype(np.int8)
        return a, torch.from_numpy(a.copy())
    raise AssertionError(kind)


def _block(kind: str, seed: int = 0):
    """One pool page block (k, v[, f32 scales]) as both sides hold it."""
    shape = (2, 4, 16, 8)
    k_ref, k_port = _pair(kind, shape, seed)
    v_ref, v_port = _pair(kind, shape, seed + 1)
    r, p = {"k": k_ref, "v": v_ref}, {"k": k_port, "v": v_port}
    if kind in ("int8", "int4"):
        for j, name in enumerate(("k_scale", "v_scale")):
            s_ref, s_port = _pair("float32", shape[:3], seed + 2 + j)
            r[name], p[name] = np.abs(s_ref), s_port.abs()
    return r, p


def _same(ref_arr, port_t) -> bool:
    a = np.asarray(ref_arr)
    if a.dtype == ml_dtypes.bfloat16:
        return port_t.dtype == torch.bfloat16 and np.array_equal(
            a.view(np.uint16), port_t.view(torch.int16).numpy().view(
                np.uint16))
    return str(a.dtype) == str(port_t.dtype).replace("torch.", "") and \
        np.array_equal(a, port_t.numpy())


KINDS = ["float32", "bfloat16", "int8", "int4"]


@pytest.mark.parametrize("kind", KINDS)
def test_pack_bytes_equal_the_reference(kind):
    """A prefill's K/V message and a page block's message: the same
    bytes from both packers."""
    shape = (2, 1, 24, 4, 8)
    k_ref, k_port = _pair(kind, shape, 1)
    v_ref, v_port = _pair(kind, shape, 2)
    meta = {"first_token": 7, "num_prompt": 19, "seed": 3,
            "prompt_ids": list(range(19)), "guide_row": 2,
            "first_lp": [-0.5, [[7, -0.5], [3, -1.25]]]}
    assert port.pack(meta, [k_port, v_port]) == ref.pack(meta, [k_ref, v_ref])
    blk_ref, blk_port = _block(kind)
    assert port.pack_block(DIGEST, EPOCH, blk_port) == \
        ref.pack_block(DIGEST, EPOCH, blk_ref)
    # The port packs numpy arrays too (the reference's own blocks).
    if kind != "bfloat16":
        assert port.pack_block(DIGEST, EPOCH, blk_ref) == \
            ref.pack_block(DIGEST, EPOCH, blk_ref)


@pytest.mark.parametrize("kind", KINDS)
def test_each_side_reads_the_others_messages(kind):
    blk_ref, blk_port = _block(kind, seed=4)
    got = port.unpack_block(ref.pack_block(DIGEST, EPOCH, blk_ref), DIGEST,
                            EPOCH)
    assert list(got) == list(blk_ref)
    assert all(_same(blk_ref[f], got[f]) for f in got)
    back = ref.unpack_block(port.pack_block(DIGEST, EPOCH, blk_port), DIGEST,
                            EPOCH)
    assert list(back) == list(blk_port)
    assert all(_same(back[f], blk_port[f]) for f in back)
    # The port's tensors own their memory: writable, contiguous.
    t = got["k"]
    t.add_(0)
    assert t.is_contiguous()


def test_empty_and_scalar_tensors_round_trip():
    meta = {"x": 1}
    tensors = [torch.zeros((0, 3), dtype=torch.float32),
               torch.tensor(5, dtype=torch.int32)]
    buf = port.pack(meta, tensors)
    assert buf == ref.pack(meta, [np.zeros((0, 3), np.float32),
                                  np.array(5, np.int32)])
    m, (a, b) = port.unpack(buf)
    assert m == meta and a.shape == (0, 3) and int(b) == 5 and b.shape == ()


def _fails_alike(buf, digest=DIGEST, epoch=EPOCH, match=None):
    for side in (ref, port):
        with pytest.raises(ValueError, match=match):
            side.unpack_block(buf, digest, epoch)


def test_mismatches_raise_value_error_on_both_sides():
    blk_ref, _ = _block("int8")
    buf = ref.pack_block(DIGEST, EPOCH, blk_ref)
    _fails_alike(buf, digest=hashlib.sha1(b"other").digest(), match="digest")
    _fails_alike(buf, epoch="fedcba9876543210", match="epoch")
    _fails_alike(buf[:-3], match=None)                   # truncated
    _fails_alike(buf + b"\0", match="length")            # trailing bytes
    _fails_alike(b"AKV2" + buf[4:], match="magic")
    bad = ref.pack({"digest": DIGEST.hex(), "epoch": EPOCH,
                    "fields": ["k", "q"]}, [blk_ref["k"], blk_ref["v"]])
    _fails_alike(bad, match="fields")
    short = ref.pack({"digest": DIGEST.hex(), "epoch": EPOCH,
                      "fields": ["k", "v", "k_scale"]},
                     [blk_ref["k"], blk_ref["v"]])
    _fails_alike(short, match="fields")


def test_a_cross_layout_block_is_refused_by_its_epoch():
    """A block of another layout (here int4 pages where the reader holds
    bf16 ones: other shapes, other dtypes) fails on the epoch check, not
    on a reshape."""
    _, blk_port = _block("int4")
    buf = port.pack_block(DIGEST, "aaaaaaaaaaaaaaaa", blk_port)
    with pytest.raises(ValueError, match="epoch"):
        port.unpack_block(buf, DIGEST, EPOCH)
    with pytest.raises(ValueError, match="unknown"):
        port.unpack(ref.pack({}, [np.zeros(2, np.complex64)]))
