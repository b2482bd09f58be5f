"""Shared counter store over the Redis protocol (RESP2); the port's copy of
``arks_tpu/gateway/rediskv.py``.

Why: the reference gateway keeps rate-limit windows and quota usage in
Redis (pkg/gateway/ratelimiter/redis_impl.go:47-168,
quota/redis_impl.go:38-107, dist/gateway.yaml:199-228) precisely so that a
SECOND gateway replica shares the same counters — in-process stores would
let N replicas each grant the full limit.  This module gives the port's
gateway the same HA story:

- ``RespClient`` — a minimal, dependency-free RESP2 client (the image has
  no redis-py).  Pipelining + the handful of commands the gateway needs.
- ``RedisCounterBackend`` — ratelimiter.CounterBackend over any
  RESP-speaking server (real Redis in production).  Same key layout and
  fixed-window semantics as the in-memory/native backends.
- ``RedisQuotaService`` — gateway.quota.QuotaService over the same server
  (plain non-expiring counters keyed namespace/quotaname/type, reference
  quota/redis_impl.go).
- ``RespServer`` — a tiny in-process RESP server (GET/SET/INCRBY/EXPIRE/
  TTL/DEL/PING/FLUSHALL with expiry).  The test double for the above, and
  a single-binary alternative for small deployments:
  ``python -m arks_tpu_torch.gateway.rediskv --port 6380``.
"""

from __future__ import annotations

import logging
import socket
import socketserver
import threading
import time

from arks_tpu_torch.control.resources import VALID_QUOTAS
from arks_tpu_torch.gateway.quota import QuotaService

log = logging.getLogger("arks_tpu_torch.gateway.rediskv")


# ---------------------------------------------------------------------------
# RESP2 client
# ---------------------------------------------------------------------------


class RespError(RuntimeError):
    pass


def _encode_command(args: tuple) -> bytes:
    out = [b"*%d\r\n" % len(args)]
    for a in args:
        if isinstance(a, bytes):
            b = a
        else:
            b = str(a).encode()
        out.append(b"$%d\r\n%s\r\n" % (len(b), b))
    return b"".join(out)


class _Conn:
    """One RESP connection with its read buffer."""

    def __init__(self, host: str, port: int, timeout_s: float):
        self.sock = socket.create_connection((host, port), timeout=timeout_s)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.buf = b""

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def read_line(self) -> bytes:
        while b"\r\n" not in self.buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("redis connection closed")
            self.buf += chunk
        line, self.buf = self.buf.split(b"\r\n", 1)
        return line

    def read_exact(self, n: int) -> bytes:
        while len(self.buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("redis connection closed")
            self.buf += chunk
        data, self.buf = self.buf[:n], self.buf[n:]
        return data

    def read_reply(self):
        """One reply; error replies come back as RespError VALUES so the
        caller always consumes every reply of a pipelined batch — raising
        mid-batch would leave replies buffered and desynchronize the
        stream for every later command."""
        line = self.read_line()
        t, rest = line[:1], line[1:]
        if t == b"+":
            return rest.decode()
        if t == b"-":
            return RespError(rest.decode())
        if t == b":":
            return int(rest)
        if t == b"$":
            n = int(rest)
            if n == -1:
                return None
            data = self.read_exact(n)
            self.read_exact(2)  # trailing \r\n
            return data
        if t == b"*":
            n = int(rest)
            if n == -1:
                return None
            return [self.read_reply() for _ in range(n)]
        raise ConnectionError(f"unexpected reply type {line!r}")


class RespClient:
    """Minimal RESP2 client with one connection PER THREAD — the gateway
    calls from concurrent request-handler threads, and a single locked
    connection would serialize every admission's round-trips head-of-line
    behind the slowest one."""

    def __init__(self, host: str, port: int, timeout_s: float = 5.0):
        self.host, self.port, self.timeout_s = host, port, timeout_s
        self._tls = threading.local()
        self._all: list[_Conn] = []
        self._all_lock = threading.Lock()
        self._conn()  # fail fast on a bad address

    def _conn(self) -> _Conn:
        conn = getattr(self._tls, "conn", None)
        if conn is None:
            conn = _Conn(self.host, self.port, self.timeout_s)
            self._tls.conn = conn
            with self._all_lock:
                self._all.append(conn)
        return conn

    def _drop_conn(self) -> None:
        conn = getattr(self._tls, "conn", None)
        if conn is not None:
            conn.close()
            with self._all_lock:
                if conn in self._all:
                    self._all.remove(conn)
            self._tls.conn = None

    def close(self) -> None:
        with self._all_lock:
            for c in self._all:
                c.close()
            self._all.clear()

    def pipeline(self, *commands: tuple) -> list:
        """Send several commands in one write, read all replies (the
        reference pipelines GET+TTL and INCRBY+EXPIRE the same way).

        Retry policy: a failure during SEND reconnects and resends once
        (the server cannot have executed a partially-delivered batch, and
        pipelined writes are small enough to fit the send buffer whole); a
        failure while READING replies does NOT resend — the server may
        have executed the commands, and re-applying INCRBYs would double-
        count rate windows and permanently inflate quota ledgers.
        """
        replies = self.pipeline_raw(*commands)
        for r in replies:
            if isinstance(r, RespError):
                raise r
        return replies

    def pipeline_raw(self, *commands: tuple) -> list:
        """Like ``pipeline`` but error replies come back as RespError
        VALUES — the cluster client inspects them for redirects."""
        payload = b"".join(_encode_command(c) for c in commands)
        try:
            conn = self._conn()
            conn.sock.sendall(payload)
        except (OSError, ConnectionError):
            # Reconnect once (gateway pods outlive store restarts).
            self._drop_conn()
            conn = self._conn()
            conn.sock.sendall(payload)
        try:
            return [conn.read_reply() for _ in commands]
        except (OSError, ConnectionError) as e:
            self._drop_conn()
            # Mark for the cluster client: the batch MAY have executed
            # (failure while reading replies) — re-executing it on another
            # node could double-count INCRBYs.
            e._resp_read_phase = True  # type: ignore[attr-defined]
            raise

    def command(self, *args):
        return self.pipeline(tuple(args))[0]


# ---------------------------------------------------------------------------
# Cluster + sentinel topologies (reference cmd/gateway/main.go:137-170:
# redis.NewUniversalClient — sentinel when a master name is set, cluster
# when several addresses are given, else single).
# ---------------------------------------------------------------------------


def _crc16(data: bytes) -> int:
    """CRC16-CCITT (XMODEM) — the Redis Cluster key-slot hash."""
    crc = 0
    for byte in data:
        crc ^= byte << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021) if crc & 0x8000 else (crc << 1)
            crc &= 0xFFFF
    return crc


def key_slot(key) -> int:
    """Cluster slot for a key, honoring {hash tags}."""
    k = key if isinstance(key, bytes) else str(key).encode()
    start = k.find(b"{")
    if start >= 0:
        end = k.find(b"}", start + 1)
        if end > start + 1:
            k = k[start + 1: end]
    return _crc16(k) % 16384


class RespClusterClient:
    """Slot-routing client over several cluster nodes — the counter/quota
    backends' commands are all single-key, so routing is: hash the key,
    send to the slot's node, follow ``-MOVED``/``-ASK`` redirects (and
    remember MOVED re-mappings).  Pipelines are regrouped per node and the
    replies re-assembled in request order.  Same public surface as
    ``RespClient``."""

    def __init__(self, addrs: list[tuple[str, int]], timeout_s: float = 5.0):
        if not addrs:
            raise ValueError("cluster mode needs at least one address")
        self.timeout_s = timeout_s
        self._clients: dict[tuple[str, int], RespClient] = {}
        self._default = tuple(addrs[0])
        self._slots: dict[int, tuple[str, int]] = {}
        # Known nodes = seeds + masters learned from CLUSTER SLOTS + MOVED
        # targets: the candidate set for failover when a node dies.
        self._nodes: set[tuple[str, int]] = {tuple(a) for a in addrs}
        self._lock = threading.Lock()
        # Fail fast needs ONE reachable seed, not all of them — a seed down
        # for maintenance must not block gateway startup when the rest of
        # the cluster can serve every slot.
        last: Exception | None = None
        for a in addrs:
            try:
                self._default = tuple(a)
                self._client(self._default)
                self._bootstrap_slots()
                return
            except (OSError, ConnectionError) as e:
                last = e
        raise ConnectionError(f"no cluster seed reachable: {last}")

    def _bootstrap_slots(self) -> None:
        """Populate the slot map up front via ``CLUSTER SLOTS`` so commands
        go to the right node on the FIRST try, and record every master as a
        failover candidate.  Best-effort: a standalone Redis answers -ERR
        (cluster support disabled) and the client falls back to learning
        mappings from MOVED redirects."""
        with self._lock:
            candidates = [self._default] + sorted(self._nodes
                                                  - {self._default})
        for addr in candidates:
            try:
                reply = self._client(addr).pipeline_raw(
                    ("CLUSTER", "SLOTS"))[0]
            except (OSError, ConnectionError):
                continue
            if isinstance(reply, RespError) or not isinstance(reply, list):
                return  # not a cluster — MOVED-learning mode
            mapping: dict[int, tuple[str, int]] = {}
            nodes: set[tuple[str, int]] = set()
            for entry in reply:
                try:
                    start, end, master = int(entry[0]), int(entry[1]), entry[2]
                    host = master[0].decode() \
                        if isinstance(master[0], (bytes, bytearray)) \
                        else str(master[0])
                    node = (host, int(master[1]))
                except (TypeError, ValueError, IndexError):
                    continue
                nodes.add(node)
                for s in range(start, end + 1):
                    mapping[s] = node
            with self._lock:
                self._slots.update(mapping)
                self._nodes |= nodes
            return

    def _failover(self, dead: tuple[str, int]) -> bool:
        """``dead`` stopped answering: drop its client, purge its slot
        entries, re-point the default at a reachable survivor, and re-learn
        the topology (the cluster may have promoted a replica).  Returns
        True if another node is available to retry against."""
        with self._lock:
            c = self._clients.pop(dead, None)
            self._nodes.discard(dead)
            self._slots = {s: a for s, a in self._slots.items() if a != dead}
            survivors = sorted(self._nodes)
            was_default = self._default == dead
        if c is not None:
            c.close()
        if not survivors:
            return False
        if was_default:
            for cand in survivors:
                try:
                    self._client(cand)
                except (OSError, ConnectionError):
                    continue
                self._default = cand
                break
            else:
                return False
        self._bootstrap_slots()
        return True

    def _client(self, addr: tuple[str, int]) -> RespClient:
        with self._lock:
            c = self._clients.get(addr)
        if c is not None:
            return c
        # Connect OUTSIDE the lock: a slow node's connect timeout must not
        # freeze every other thread's slot lookups.  Double-checked insert
        # tolerates a racing duplicate (the loser is closed).
        c = RespClient(addr[0], addr[1], self.timeout_s)
        with self._lock:
            cur = self._clients.get(addr)
            if cur is not None:
                close_me, c = c, cur
            else:
                self._clients[addr] = c
                close_me = None
        if close_me is not None:
            close_me.close()
        return c

    def close(self) -> None:
        with self._lock:
            for c in self._clients.values():
                c.close()
            self._clients.clear()

    @staticmethod
    def _cmd_key(cmd: tuple):
        # Every command the gateway issues is single-key with the key at
        # position 1 (GET/SET/INCRBY/EXPIRE/TTL/DEL); keyless commands
        # (PING/FLUSHALL) route to the default node.
        return cmd[1] if len(cmd) > 1 else None

    def _addr_for(self, cmd: tuple) -> tuple[str, int]:
        key = self._cmd_key(cmd)
        if key is None:
            return self._default
        with self._lock:
            return self._slots.get(key_slot(key), self._default)

    @staticmethod
    def _parse_redirect(err: RespError) -> tuple[str, int, int] | None:
        parts = str(err).split()
        if len(parts) == 3 and parts[0] in ("MOVED", "ASK"):
            host, _, port = parts[2].rpartition(":")
            return int(parts[1]), (host, int(port)), parts[0]
        return None

    def _follow_redirect(self, cmd: tuple, err: RespError):
        red = self._parse_redirect(err)
        if red is None:
            raise err
        slot, new_addr, kind = red
        if kind == "MOVED":
            with self._lock:
                self._slots[int(slot)] = new_addr
                self._nodes.add(new_addr)  # redirect target = live master
        try:
            target = self._client(new_addr)
            if kind == "ASK":
                reply = target.pipeline_raw(("ASKING",), cmd)[1]
            else:
                reply = target.pipeline_raw(cmd)[0]
        except (OSError, ConnectionError) as e:
            # Tag the failing hop so pipeline() can run its failover path
            # (the redirect pointed at a node that just died).
            e._arks_addr = new_addr  # type: ignore[attr-defined]
            raise
        if isinstance(reply, RespError):
            raise reply
        return reply

    def pipeline(self, *commands: tuple) -> list:
        # Group commands by their slot's node so same-node batches (the
        # hot-path INCRBY+TTL pair) stay ONE round trip; redirected replies
        # are retried individually and the results restored to input order.
        #
        # Node failure: connect/send failures CANNOT have executed, so the
        # affected commands are re-routed through the relearned topology
        # (bounded retries).  A failure while READING replies may have
        # executed — the topology is still relearned, but the error
        # propagates (re-running INCRBYs would double-count rate windows;
        # same policy as RespClient.pipeline).
        out: list = [None] * len(commands)
        todo = list(range(len(commands)))
        last: Exception | None = None
        for _ in range(3):
            by_addr: dict[tuple[str, int], list[int]] = {}
            for i in todo:
                by_addr.setdefault(self._addr_for(commands[i]), []).append(i)
            failed: list[int] = []
            for addr, idxs in by_addr.items():
                try:
                    replies = self._client(addr).pipeline_raw(
                        *(commands[i] for i in idxs))
                except (OSError, ConnectionError) as e:
                    alive = self._failover(addr)
                    if getattr(e, "_resp_read_phase", False) or not alive:
                        raise
                    last = e
                    failed.extend(idxs)
                    continue
                for i, reply in zip(idxs, replies):
                    if isinstance(reply, RespError):
                        try:
                            reply = self._follow_redirect(commands[i], reply)
                        except (OSError, ConnectionError) as e:
                            # The REDIRECT TARGET died mid-hop: same
                            # failover rules as a direct node failure (a
                            # connect/send failure never executed, so the
                            # command is safe to re-route).
                            hop = getattr(e, "_arks_addr", None)
                            alive = hop is not None and self._failover(hop)
                            if getattr(e, "_resp_read_phase", False) \
                                    or not alive:
                                raise
                            last = e
                            failed.append(i)
                            continue
                    out[i] = reply
            if not failed:
                return out
            todo = failed
        raise last if last is not None else ConnectionError(
            "cluster pipeline retries exhausted")

    def command(self, *args):
        return self.pipeline(tuple(args))[0]


class SentinelRespClient(RespClient):
    """RESP client that resolves its master through Redis Sentinel
    (``SENTINEL GET-MASTER-ADDR-BY-NAME``) and RE-resolves on connection
    loss or on a ``-READONLY`` reply (failover promoted a replica)."""

    def __init__(self, sentinel_addrs: list[tuple[str, int]],
                 master_name: str, timeout_s: float = 5.0):
        self.sentinels = [tuple(a) for a in sentinel_addrs]
        self.master_name = master_name
        self._resolve()
        super().__init__(self.host, self.port, timeout_s)

    def _resolve(self) -> None:
        last: Exception | None = None
        for host, port in self.sentinels:
            try:
                c = _Conn(host, port, 5.0)
                try:
                    c.sock.sendall(_encode_command(
                        ("SENTINEL", "GET-MASTER-ADDR-BY-NAME",
                         self.master_name)))
                    reply = c.read_reply()
                finally:
                    c.close()
                if isinstance(reply, list) and len(reply) == 2:
                    self.host = reply[0].decode()
                    self.port = int(reply[1])
                    return
                last = RespError(f"sentinel {host}:{port} returned {reply!r}")
            except (OSError, ConnectionError) as e:
                last = e
        raise ConnectionError(
            f"no sentinel could resolve master {self.master_name!r}: {last}")

    def _drop_conn(self) -> None:
        super()._drop_conn()
        # The master may have moved: ask the sentinels again before the
        # next connection attempt.
        try:
            self._resolve()
        except ConnectionError:
            log.warning("sentinel re-resolution failed; keeping %s:%s",
                        self.host, self.port, exc_info=True)

    def pipeline(self, *commands: tuple) -> list:
        try:
            return super().pipeline(*commands)
        except RespError as e:
            if not str(e).startswith("READONLY"):
                raise
            # Failover flipped this node to replica: re-resolve and retry
            # once.  (READONLY on a read-modify batch means the batch did
            # not execute — safe to resend.)
            self._drop_conn()
            return super().pipeline(*commands)


def make_resp_client(addrs: str, sentinel_master: str | None = None,
                     timeout_s: float = 5.0):
    """Factory matching the reference's UniversalClient selection
    (cmd/gateway/main.go:137-170): comma-separated ``addrs`` + a sentinel
    master name -> sentinel; several addrs -> cluster; one -> single."""
    parsed = []
    for a in addrs.split(","):
        a = a.strip()
        if not a:
            continue
        host, sep, port = a.rpartition(":")
        if sep and port.isdigit():
            parsed.append((host, int(port)))
        else:
            parsed.append((a, 6379))  # bare hostname defaults like redis-cli
    if sentinel_master:
        return SentinelRespClient(parsed, sentinel_master, timeout_s)
    if len(parsed) > 1:
        return RespClusterClient(parsed, timeout_s)
    return RespClient(parsed[0][0], parsed[0][1], timeout_s)


# ---------------------------------------------------------------------------
# Gateway backends over RESP
# ---------------------------------------------------------------------------


class RedisCounterBackend:
    """ratelimiter.CounterBackend over a RESP server — the HA replacement
    for the in-process stores (two gateway replicas share one window)."""

    def __init__(self, client: RespClient):
        self.client = client

    def get(self, key: str) -> int:
        val = self.client.command("GET", key)
        return int(val) if val is not None else 0

    def incr(self, key: str, amount: int, ttl_s: int) -> int:
        # Pipelined INCRBY + TTL, then EXPIRE only when the key has no
        # expiry yet (reference redis_impl.go:116-168).
        val, ttl = self.client.pipeline(("INCRBY", key, amount), ("TTL", key))
        if ttl is not None and int(ttl) < 0:
            self.client.command("EXPIRE", key, ttl_s)
        return int(val)


def quota_key(namespace: str, quota_name: str, typ: str) -> str:
    # key layout parity: prefix:namespace=..quotaname=..type=..
    # (reference quota/redis_impl.go)
    return f"arks:quota:namespace={namespace}:quotaname={quota_name}:type={typ}"


class RedisQuotaService(QuotaService):
    """gateway.quota.QuotaService over a RESP server (plain non-expiring
    counters; reference quota/redis_impl.go:38-107).  Only the storage
    methods are overridden — ``check`` is inherited so over-limit
    semantics can never diverge from the single-replica path."""

    def __init__(self, client: RespClient):
        self.client = client

    def incr_usage(self, namespace: str, quota_name: str,
                   amounts: dict[str, int]) -> None:
        cmds = [("INCRBY", quota_key(namespace, quota_name, t), a)
                for t, a in amounts.items() if t in VALID_QUOTAS and a > 0]
        if cmds:
            self.client.pipeline(*cmds)

    def get_usage(self, namespace: str, quota_name: str) -> dict[str, int]:
        types = list(VALID_QUOTAS)
        vals = self.client.pipeline(
            *(("GET", quota_key(namespace, quota_name, t)) for t in types))
        return {t: int(v) if v is not None else 0
                for t, v in zip(types, vals)}

    def set_usage(self, namespace: str, quota_name: str, typ: str,
                  value: int) -> None:
        self.client.command("SET", quota_key(namespace, quota_name, typ), value)


# ---------------------------------------------------------------------------
# Tiny RESP server (test double + single-binary deployments)
# ---------------------------------------------------------------------------


class _KV:
    _GC_THRESHOLD = 65536

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.data: dict[bytes, bytes] = {}
        self.expiry: dict[bytes, float] = {}
        self._gc_at = self._GC_THRESHOLD

    def _alive(self, key: bytes, now: float) -> bool:
        exp = self.expiry.get(key)
        if exp is not None and exp <= now:
            self.data.pop(key, None)
            self.expiry.pop(key, None)
            return False
        return key in self.data

    def gc(self, now: float) -> None:
        """Amortized sweep of expired keys.  Rate-limit window keys embed
        their window start and are never read again after the window rolls,
        so lazy-on-access expiry alone would grow the store without bound
        (one key per user/model/rule/window, forever)."""
        if len(self.data) <= self._gc_at:
            return
        dead = [k for k, exp in self.expiry.items() if exp <= now]
        for k in dead:
            self.data.pop(k, None)
            self.expiry.pop(k, None)
        # If most keys are live (long windows), wait for the map to double
        # before re-scanning rather than sweeping every write.
        self._gc_at = max(self._GC_THRESHOLD, len(self.data) * 2)


class _Handler(socketserver.StreamRequestHandler):
    def handle(self) -> None:
        kv: _KV = self.server.kv  # type: ignore[attr-defined]
        while True:
            try:
                line = self.rfile.readline()
            except OSError:
                return
            if not line:
                return
            if not line.startswith(b"*"):
                self.wfile.write(b"-ERR protocol error\r\n")
                return
            try:
                nargs = int(line[1:].strip())
                args = []
                for _ in range(nargs):
                    hdr = self.rfile.readline()
                    n = int(hdr[1:].strip())
                    args.append(self.rfile.read(n))
                    self.rfile.read(2)
            except (ValueError, OSError):
                return
            try:
                self.wfile.write(self._dispatch(kv, args))
                self.wfile.flush()
            except OSError:
                return

    def _dispatch(self, kv: _KV, args: list[bytes]) -> bytes:
        cmd = args[0].upper()
        now = time.time()
        srv = self.server
        # Topology test doubles: sentinel resolution + cluster redirects.
        if cmd == b"SENTINEL" and len(args) >= 3 \
                and args[1].upper() == b"GET-MASTER-ADDR-BY-NAME":
            master = getattr(srv, "sentinel_masters", {}).get(
                args[2].decode())
            if master is None:
                return b"*-1\r\n"
            h, p = str(master[0]).encode(), str(master[1]).encode()
            return (b"*2\r\n$%d\r\n%s\r\n$%d\r\n%s\r\n"
                    % (len(h), h, len(p), p))
        if cmd == b"ASKING":
            return b"+OK\r\n"
        if cmd == b"CLUSTER" and len(args) >= 2 \
                and args[1].upper() == b"SLOTS":
            ranges = getattr(srv, "cluster_slots", None)
            if not ranges:
                return b"-ERR This instance has cluster support disabled\r\n"
            out = b"*%d\r\n" % len(ranges)
            for start, end, host, port in ranges:
                h = str(host).encode()
                out += (b"*3\r\n:%d\r\n:%d\r\n*2\r\n$%d\r\n%s\r\n:%d\r\n"
                        % (int(start), int(end), len(h), h, int(port)))
            return out
        moved = getattr(srv, "moved_slots", None)
        if moved and len(args) > 1:
            slot = key_slot(args[1])
            target = moved.get(slot)
            if target is not None:
                return (b"-MOVED %d %s\r\n"
                        % (slot, str(target).encode()))
        with kv.lock:
            if cmd in (b"SET", b"INCRBY"):
                kv.gc(now)
            if cmd == b"PING":
                return b"+PONG\r\n"
            if cmd == b"GET":
                if not kv._alive(args[1], now):
                    return b"$-1\r\n"
                v = kv.data[args[1]]
                return b"$%d\r\n%s\r\n" % (len(v), v)
            if cmd == b"SET":
                kv.data[args[1]] = args[2]
                kv.expiry.pop(args[1], None)
                return b"+OK\r\n"
            if cmd == b"INCRBY":
                cur = int(kv.data[args[1]]) if kv._alive(args[1], now) else 0
                cur += int(args[2])
                kv.data[args[1]] = str(cur).encode()
                return b":%d\r\n" % cur
            if cmd == b"EXPIRE":
                if not kv._alive(args[1], now):
                    return b":0\r\n"
                kv.expiry[args[1]] = now + int(args[2])
                return b":1\r\n"
            if cmd == b"TTL":
                if not kv._alive(args[1], now):
                    return b":-2\r\n"
                exp = kv.expiry.get(args[1])
                return b":-1\r\n" if exp is None else b":%d\r\n" % int(exp - now)
            if cmd == b"DEL":
                n = 0
                for key in args[1:]:
                    if kv._alive(key, now):
                        kv.data.pop(key, None)
                        kv.expiry.pop(key, None)
                        n += 1
                return b":%d\r\n" % n
            if cmd == b"FLUSHALL":
                kv.data.clear()
                kv.expiry.clear()
                return b"+OK\r\n"
        return b"-ERR unknown command '%s'\r\n" % cmd


class RespServer:
    """Threaded RESP server over an in-memory KV with expiry."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._srv = socketserver.ThreadingTCPServer((host, port), _Handler,
                                                    bind_and_activate=True)
        self._srv.daemon_threads = True
        self._srv.kv = _KV()  # type: ignore[attr-defined]
        # Topology test doubles (see _Handler._dispatch):
        # sentinel_masters: {master_name: (host, port)};
        # moved_slots: {slot: "host:port"} -> -MOVED redirects;
        # cluster_slots: [(start, end, host, port)] -> CLUSTER SLOTS reply.
        self._srv.sentinel_masters = {}  # type: ignore[attr-defined]
        self._srv.moved_slots = {}  # type: ignore[attr-defined]
        self._srv.cluster_slots = []  # type: ignore[attr-defined]
        self.host, self.port = self._srv.server_address

    @property
    def sentinel_masters(self) -> dict:
        return self._srv.sentinel_masters  # type: ignore[attr-defined]

    @property
    def moved_slots(self) -> dict:
        return self._srv.moved_slots  # type: ignore[attr-defined]

    @property
    def cluster_slots(self) -> list:
        return self._srv.cluster_slots  # type: ignore[attr-defined]

    def start(self, background: bool = True) -> None:
        if background:
            threading.Thread(target=self._srv.serve_forever,
                             name="rediskv", daemon=True).start()
        else:
            self._srv.serve_forever()

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()


def main(argv: list[str] | None = None) -> None:
    import argparse

    p = argparse.ArgumentParser("arks_tpu_torch.gateway.rediskv")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=6380)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    srv = RespServer(args.host, args.port)
    log.info("rediskv serving on %s:%d", srv.host, srv.port)
    srv.start(background=False)


if __name__ == "__main__":
    main()
