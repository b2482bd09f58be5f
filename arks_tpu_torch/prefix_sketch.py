"""Prefix-digest sketches for cache-aware routing (the port's copy of the
engine half of ``arks_tpu/prefix_sketch.py``).

The prefix tiers key their blocks by chained content digests: tier 0 is
the page allocator's device index, tier 1 the host tier, tier 2 the disk
tier.  Each backend exports a compact, versioned summary of the digests it
holds, per tier (a bloom filter plus an exact top-K of the most recently
registered entries), at ``GET /v1/cache/sketch``; the router polls it and
places a request on the backend that covers the deepest prefix.

Two digest domains, so that the router needs no tokenizer:

- **token**: a request whose ``prompt`` is a token-id list hashes through
  the engine's own chain (``iter_chain_digests``);
- **text**: a text request hashes fixed character blocks of its canonical
  prompt text (``iter_text_digests``).  The server, which sees both the
  text and its ids, records each text block's aligned token digest
  (``SketchExporter.link``); a text digest is advertised in a tier iff its
  token digest is there, the required token depth rounded UP.

The engine and the server build and export (``SketchExporter``); the
router parses and scores (``BackendSketch``).  It imports nothing of the
engine.
"""

from __future__ import annotations

import base64
import hashlib
import os
import threading
import time
from collections import OrderedDict

import numpy as np

from arks_tpu_torch import knobs


def iter_chain_digests(ids, page: int):
    """Lazily yield chained content digests: digest j covers
    ids[: (j+1)*page] (a matcher can stop at the first missing block)."""
    h = hashlib.sha1()
    arr = np.asarray(ids, np.int32)
    for j in range(len(arr) // page):
        h.update(arr[j * page:(j + 1) * page].tobytes())
        yield h.digest()


def chain_digests(ids, page: int, nblocks: int) -> list[bytes]:
    """First ``nblocks`` chained digests as a list."""
    out = []
    for j, d in enumerate(iter_chain_digests(ids, page)):
        if j >= nblocks:
            break
        out.append(d)
    return out


def iter_text_digests(text: str, chars: int):
    """Text-domain chain: digest j covers text[: (j+1)*chars] (full char
    blocks only — a partial tail block can't anchor reuse)."""
    h = hashlib.sha1()
    # Block on CHARACTERS (stable across the router and server seeing the
    # same str), then hash the utf-8 bytes of each block.
    for j in range(len(text) // chars):
        h.update(text[j * chars:(j + 1) * chars].encode("utf-8",
                                                        "surrogatepass"))
        yield h.digest()


def canonical_prompt_text(obj) -> str | None:
    """The FULL prompt text of a parsed request body, extracted with the
    router's prefix-key scanning rules (content-part text joined, scan
    stops at the first unknown content shape so later turns never leak
    into the key).  The router's rendezvous key is a fixed-size prefix of
    this; the text-domain digest chain covers all of it.  None when the
    body carries no usable text (token-id prompts, image-only parts)."""
    if not isinstance(obj, dict):
        return None
    if isinstance(obj.get("messages"), list):
        parts = []
        for m in obj["messages"]:
            c = m.get("content") if isinstance(m, dict) else None
            if isinstance(c, list):
                c = "".join(t for p in c
                            if isinstance(p, dict) and p.get("type") == "text"
                            for t in (p.get("text"),) if isinstance(t, str))
                if not c:
                    break
            if not isinstance(c, str):
                break
            parts.append(c)
        text = "\x00".join(parts)
    elif isinstance(obj.get("prompt"), str):
        text = obj["prompt"]
    else:
        return None
    return text or None


# ---------------------------------------------------------------------------
# Bloom filter
# ---------------------------------------------------------------------------

class BloomSketch:
    """Fixed-size bloom filter over 20-byte digests.  The k bit indices
    are carved deterministically from the digest itself (4-byte
    big-endian words, extended by rehashing when k words outrun one
    digest) — no per-process salt, so an exported filter probes
    identically on any peer."""

    def __init__(self, m_bits: int, k: int, bits: bytes | None = None,
                 n: int = 0):
        if m_bits <= 0 or k <= 0:
            raise ValueError("m_bits and k must be positive")
        self.m = m_bits
        self.k = k
        self.n = n
        nbytes = (m_bits + 7) // 8
        self.bits = bytearray(bits) if bits is not None else bytearray(nbytes)
        if len(self.bits) != nbytes:
            raise ValueError("bloom bit-array size mismatch")

    def _indices(self, digest: bytes) -> list[int]:
        out: list[int] = []
        h, ctr = digest, 0
        while len(out) < self.k:
            for off in range(0, len(h) - 3, 4):
                if len(out) == self.k:
                    break
                out.append(int.from_bytes(h[off:off + 4], "big") % self.m)
            ctr += 1
            h = hashlib.sha1(digest + bytes([ctr & 0xFF])).digest()
        return out

    def add(self, digest: bytes) -> None:
        for i in self._indices(digest):
            self.bits[i >> 3] |= 1 << (i & 7)
        self.n += 1

    def __contains__(self, digest: bytes) -> bool:
        return all(self.bits[i >> 3] & (1 << (i & 7))
                   for i in self._indices(digest))

    def to_payload(self) -> dict:
        return {"m": self.m, "k": self.k, "n": self.n,
                "b64": base64.b64encode(bytes(self.bits)).decode()}

    @classmethod
    def from_payload(cls, p: dict) -> "BloomSketch":
        return cls(int(p["m"]), int(p["k"]),
                   bits=base64.b64decode(p["b64"]), n=int(p.get("n", 0)))


def _top_key(digest: bytes) -> str:
    """Exact-membership key for the top-K list: 8 bytes of the digest as
    hex — short enough to keep the payload compact, long enough that a
    collision is rarer than the bloom's false positives."""
    return digest[:8].hex()


# ---------------------------------------------------------------------------
# Engine side: build + export
# ---------------------------------------------------------------------------

class SketchExporter:
    """Per-engine sketch builder.  Holds the boot/reset epoch, the
    text->token alignment ledger, and a build cache keyed by the tier
    membership versions — a /v1/cache/sketch poll between membership
    changes returns the cached payload without re-walking anything.

    Thread-safety: built and linked from server threads, epoch-bumped
    from the engine thread; one lock guards the ledger and cache.  The
    engine thread itself never calls in here — membership reaches the
    builder through the allocator/host-tier snapshots the CALLER passes,
    keeping this class off the dispatch hot path entirely.
    """

    def __init__(self, page_tokens: int):
        self.page = page_tokens
        self.text_chars = knobs.get_int("ARKS_ROUTER_SKETCH_CHARS")
        self.m_bits = knobs.get_int("ARKS_ROUTER_SKETCH_BITS")
        self.k_hashes = knobs.get_int("ARKS_ROUTER_SKETCH_HASHES")
        self.top_k = knobs.get_int("ARKS_ROUTER_SKETCH_TOPK")
        self.max_links = knobs.get_int("ARKS_ROUTER_SKETCH_LINKS")
        if min(self.text_chars, self.m_bits, self.k_hashes, self.top_k,
               self.max_links) <= 0:
            raise ValueError("ARKS_ROUTER_SKETCH_* knobs must be positive")
        self._boot = os.urandom(4).hex()
        self._resets = 0
        self._reset_reason: str | None = None
        self._builds = 0
        self._lock = threading.Lock()
        # text digest -> aligned token digest, LRU order (oldest first).
        self._links: "OrderedDict[bytes, bytes]" = OrderedDict()
        self._links_version = 0
        self._cache: tuple | None = None  # (key, payload)

    @property
    def epoch(self) -> str:
        return f"{self._boot}.{self._resets}"

    def bump_epoch(self, reason: str | None = None) -> None:
        """Reset/restart marker: the next exported sketch carries a new
        epoch, and pollers drop their pre-reset copy immediately (a fresh
        cache must not keep winning on stale membership).  ``reason``
        ("resize", "rearm", ...) rides the next payloads' meta so a
        router operator can tell an elastic epoch roll from a crash."""
        with self._lock:
            self._resets += 1
            self._cache = None
            self._reset_reason = reason
            # The ledger maps text to token digests, not to residency —
            # it survives the reset like the host tier does.

    # -- text -> token alignment ledger --------------------------------

    def link(self, text: str | None, ids) -> None:
        """Record the text-block -> token-block alignment for one request
        (server threads, off the engine hot path).  Each full text block
        maps to the token chain digest at the depth that PROVABLY covers
        it: required token count rounded up to the next page boundary, so
        advertising the text digest never claims more token coverage than
        the tier actually holds."""
        if not text:
            return
        nchars, ntok = len(text), len(ids)
        ntok_blocks = ntok // self.page
        if nchars < self.text_chars or ntok_blocks == 0:
            return
        tok_digests = chain_digests(ids, self.page, ntok_blocks)
        pairs: list[tuple[bytes, bytes]] = []
        for j, td in enumerate(iter_text_digests(text, self.text_chars)):
            need_tokens = -(-((j + 1) * self.text_chars * ntok) // nchars)
            need_blocks = max(-(-need_tokens // self.page), 1)
            if need_blocks > ntok_blocks:
                break
            pairs.append((td, tok_digests[need_blocks - 1]))
        if not pairs:
            return
        with self._lock:
            changed = False
            for td, kd in pairs:
                if self._links.get(td) != kd:
                    changed = True
                self._links[td] = kd
                self._links.move_to_end(td)
            while len(self._links) > self.max_links:
                self._links.popitem(last=False)
                changed = True
            if changed:
                self._links_version += 1
                self._cache = None

    # -- build ---------------------------------------------------------

    def _tier_payload(self, members: list[bytes],
                      links: list[tuple[bytes, bytes]]) -> dict:
        bloom = BloomSketch(self.m_bits, self.k_hashes)
        for d in members:
            bloom.add(d)
        mset = set(members)
        covered = [td for td, kd in links if kd in mset]
        tbloom = BloomSketch(self.m_bits, self.k_hashes)
        for td in covered:
            tbloom.add(td)
        return {
            "count": len(members),
            # Most recently registered first — the exact-membership tier
            # of the summary.
            "top": [_top_key(d) for d in members[-self.top_k:]][::-1],
            "bloom": bloom.to_payload(),
            "text_count": len(covered),
            "text_top": [_top_key(t) for t in covered[-self.top_k:]][::-1],
            "text_bloom": tbloom.to_payload(),
        }

    def build(self, device: list[bytes], device_key, host: list[bytes],
              host_key, disk: list[bytes] | None = None, disk_key=-1,
              hit_tokens: dict | None = None,
              query_tokens: float = 0, extra: dict | None = None) -> dict:
        """The export payload for the given tier membership snapshots
        (oldest-first digest lists + an opaque version key per tier;
        ``disk`` is the optional tier-2 membership — peers use it to
        advertise restart-surviving blocks they can serve over
        /v1/cache/blocks).  Cached until a membership version, the link
        ledger, or the epoch changes; ``hit_tokens``/``query_tokens``
        ride every response uncached (they are cheap counters, and the
        actual-hit side of the router's expected-vs-actual accounting
        must not lag)."""
        with self._lock:
            key = (self._resets, device_key, host_key, disk_key,
                   self._links_version)
            if self._cache is not None and self._cache[0] == key:
                payload = self._cache[1]
            else:
                links = list(self._links.items())
                self._builds += 1
                tiers = {"device": self._tier_payload(device, links),
                         "host": self._tier_payload(host, links)}
                if disk:
                    tiers["disk"] = self._tier_payload(disk, links)
                payload = {
                    "enabled": True,
                    "epoch": self.epoch,
                    "epoch_reason": self._reset_reason,
                    "version": self._builds,
                    "built_unix": time.time(),
                    "page_tokens": self.page,
                    "text_chars": self.text_chars,
                    "tiers": tiers,
                }
                self._cache = (key, payload)
        out = dict(payload)
        out["hit_tokens"] = dict(hit_tokens or {})
        out["query_tokens"] = query_tokens
        if extra:
            out.update(extra)
        return out


# ---------------------------------------------------------------------------
# Router side: parse + score
# ---------------------------------------------------------------------------

class _TierView:
    def __init__(self, tier: dict, text: bool):
        pre = "text_" if text else ""
        self._top = set(tier.get(pre + "top") or [])
        b = tier.get(pre + "bloom")
        self._bloom = BloomSketch.from_payload(b) if b else None
        self.count = int(tier.get(pre + "count" if text else "count", 0))

    def contains(self, digest: bytes) -> bool:
        if _top_key(digest) in self._top:
            return True
        return self._bloom is not None and digest in self._bloom


class BackendSketch:
    """One backend's parsed sketch, as the router scores against it."""

    def __init__(self, payload: dict):
        self.enabled = bool(payload.get("enabled"))
        self.epoch = str(payload.get("epoch", ""))
        self.version = int(payload.get("version", 0))
        self.page_tokens = int(payload.get("page_tokens", 0) or 0)
        self.text_chars = int(payload.get("text_chars", 0) or 0)
        self.hit_tokens = {k: float(v) for k, v in
                           (payload.get("hit_tokens") or {}).items()}
        self.query_tokens = float(payload.get("query_tokens", 0) or 0)
        tiers = payload.get("tiers") or {}
        self._views = {}
        for tier in ("device", "host", "disk"):
            # "disk" is absent from pre-tier-2 backends' payloads; the
            # empty view then simply never extends a chain's coverage.
            t = tiers.get(tier) or {}
            self._views[(tier, "token")] = _TierView(t, text=False)
            self._views[(tier, "text")] = _TierView(t, text=True)

    @classmethod
    def from_payload(cls, payload: dict) -> "BackendSketch":
        return cls(payload)

    def score_chain(self, digests: list[bytes],
                    domain: str = "token") -> tuple[int, int, int]:
        """Expected hit depth for one request chain: the initial
        consecutive run resident in tier 0 (device), then the
        consecutive continuation resident in tier 1 (host), then the
        continuation resident in tier 2 (disk).  Returns
        (device_blocks, host_blocks, disk_blocks) — deterministic for a
        given sketch and chain."""
        dev_view = self._views[("device", domain)]
        host_view = self._views[("host", domain)]
        disk_view = self._views[("disk", domain)]
        dev = 0
        n = len(digests)
        while dev < n and dev_view.contains(digests[dev]):
            dev += 1
        host = 0
        while dev + host < n and host_view.contains(digests[dev + host]):
            host += 1
        disk = 0
        while (dev + host + disk < n
               and disk_view.contains(digests[dev + host + disk])):
            disk += 1
        return dev, host, disk
