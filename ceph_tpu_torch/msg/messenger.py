"""Async messenger: reactor, sessions, connections, dispatch.

Re-expresses the reference's AsyncMessenger stack (src/msg/async/
AsyncMessenger.cc, AsyncConnection.cc, Stack.h Worker reactors) and
ProtocolV2's lossless session semantics (src/msg/async/ProtocolV2.cc:
out_seq/in_seq, ack frames, session resume + replay on reconnect):

- Every connection opens with a HELLO frame carrying a stable entity
  identity and the receiver's highest-delivered seq; the server binds
  the TCP stream to a per-entity Session that survives reconnects.
- Senders keep unacked frames; receivers ack delivered seqs; acks trim
  the replay window.  On reconnect the peer's HELLO tells the sender
  what arrived, so replay starts exactly after it and the receive path
  drops any already-seen seq — exactly-once delivery per session.
- The Session owns the live TCP stream; Connections are facades over it,
  so a server reply issued after the client reconnected rides the new
  stream (the reference rebinds AsyncConnection to the existing session
  the same way on reconnect_ok).
- Lossy connections (heartbeats may opt in) skip retention and resume.

Fault injection (reference ms_inject_socket_failures / ms_inject_delay_*
in src/common/options.cc:1071-1092): per-messenger knobs that randomly
reset sockets or delay frame writes, used by the thrasher tests.

Idiomatic shift: a small POOL of asyncio event loops (each in its own
thread) replaces N epoll worker threads — every Messenger instance is
pinned to one loop of the pool at creation (reference AsyncMessenger
worker assignment).  A single shared loop was measured to serialize
the EC read fan-out: 8 concurrent 128 KiB sub-read replies took 4.2 ms
through one reactor vs 0.57 ms for one reply, because every frame's
encode + crc + retention copy runs on the loop thread.  Sessions,
sockets, and locks are all per-messenger, so loops never share
connection state.  The public surface (Messenger/Connection/
Dispatcher) keeps the reference's shape so daemon code reads the same.
"""

from __future__ import annotations

import asyncio
import collections
import json
import random
import struct
import threading
import time
import uuid
from concurrent.futures import TimeoutError as _FuturesTimeout
from typing import Callable

from .message import (CTRL_ACK, CTRL_COMP, CTRL_ENC, CTRL_HELLO, Message,
                      encode_frame)
from .msgr_ledger import MsgrLedger, msgr_ledger

Dispatcher = Callable[["Connection", Message], None]


def _grow_socket_buffers(writer: asyncio.StreamWriter,
                         size: int = 4 << 20) -> None:
    """MiB-scale frames on default (~64-208 KiB) kernel buffers cost
    several epoll write/read cycles each; grow both directions."""
    import socket as _socket
    sock = writer.get_extra_info("socket")
    if sock is None:
        return
    try:
        sock.setsockopt(_socket.SOL_SOCKET, _socket.SO_SNDBUF, size)
        sock.setsockopt(_socket.SOL_SOCKET, _socket.SO_RCVBUF, size)
    except OSError:
        pass

# A lossless peer that stops acking cannot hold frames forever: past this
# many retained frames the session is torn down (abnormal reset, like the
# reference's session reset after policy limits) rather than leaking.
UNACKED_HARD_CAP = 65536


def _parse_raw(raw: bytes) -> tuple[int, int, bytes, bytes, int]:
    """Split one frame already in memory (the unwrapped payload of an
    ENC/COMP envelope) into (tid, seq, meta_raw, data, pcrc).  A short
    or mangled buffer raises ValueError so the read loop's corruption
    path (session-preserving wire reset) handles it — struct.error
    would kill the loop."""
    import struct as _struct
    try:
        tid, seq, meta_len, data_len = \
            Message.parse_header(raw[:Message.HEADER_SIZE])
    except (_struct.error, ValueError) as e:
        raise ValueError(f"bad inner frame: {e}") from e
    off = Message.HEADER_SIZE
    if len(raw) < off + meta_len + data_len + 4:
        raise ValueError("truncated inner frame")
    meta_raw = raw[off:off + meta_len]
    data = raw[off + meta_len:off + meta_len + data_len]
    pcrc = int.from_bytes(raw[-4:], "little")
    return tid, seq, meta_raw, data, pcrc


async def read_frame(reader: asyncio.StreamReader
                     ) -> tuple[int, int, bytes, bytes, int]:
    """Read one wire frame -> (tid, seq, meta_raw, data, pcrc); raises
    ValueError on corruption (bad magic / header crc).  Two reads per
    frame (header, then body in one readexactly + slice) — each await
    is a potential reactor suspension, and the EC fan-out pays it per
    shard reply."""
    head = await reader.readexactly(Message.HEADER_SIZE)
    tid, seq, meta_len, data_len = Message.parse_header(head)
    body = await reader.readexactly(meta_len + data_len + 4)
    meta_raw = body[:meta_len]
    data = body[meta_len:meta_len + data_len]
    (pcrc,) = struct.unpack("<I", body[-4:])
    return tid, seq, meta_raw, data, pcrc


class Session:
    """Per-peer-entity delivery state + the live wire; survives TCP
    reconnects (reference ProtocolV2 session: out_seq/in_seq/out_queue
    replay, rebound to a new AsyncConnection on resume)."""

    def __init__(self, lossless: bool = True, nonce: str | None = None):
        self.lossless = lossless
        # Distinguishes incarnations: a client that abandons a session
        # (unacked overflow) starts a new nonce, telling the server to
        # discard its old seq window instead of dedup-dropping the fresh
        # one (reference ProtocolV2 client_cookie semantics).
        self.nonce = nonce or uuid.uuid4().hex[:12]
        # Epoch cookies (reference ProtocolV2 client_cookie/server_cookie):
        # local_cookie identifies THIS session object; peer_cookie is the
        # last cookie seen from the peer.  A seq number is only meaningful
        # within the epoch whose cookie it was learned under — trusting a
        # stale in_seq would trim undelivered frames from the peer's
        # replay window (observed as lost replies across server restarts).
        self.local_cookie = uuid.uuid4().hex[:12]
        self.peer_cookie: str | None = None
        self.out_seq = 0          # last seq assigned to an outgoing frame
        self.in_seq = 0           # highest seq delivered to the dispatcher
        self.unacked: collections.deque[tuple[int, bytes]] = \
            collections.deque()
        self.reader: asyncio.StreamReader | None = None
        self.writer: asyncio.StreamWriter | None = None
        self.send_lock = asyncio.Lock()
        self.broken = False
        self.down_since: float | None = None
        self.last_acked = 0       # highest seq we have acked to the peer
        # auth state (per wire epoch; re-derived on every HELLO):
        # conn_key signs/encrypts this connection, auth_identity is the
        # verified peer {entity, caps} (reference CephXAuthorizer
        # session_key + secure-mode keys from crypto_onwire.cc)
        self.conn_key: bytes | None = None
        self.secure = False
        self.auth_identity: dict | None = None
        self._enc_ctr = 0
        self._enc_dir = b"\x01"   # \x01 = connector, \x02 = acceptor
        self._aead = None         # cached AESGCM (one key schedule)
        # on-wire compression (reference msgr2.1 compression feature):
        # negotiated at HELLO; frames >= comp_min wrap in CTRL_COMP
        # before (optional) encryption
        self.comp = None          # Compressor | None
        self.comp_min = 4096
        self.compressed_out = 0
        self._decomp_cache: dict = {}

    def wire_prepare(self, raw: bytes) -> bytes:
        """Outbound frame pipeline: compress-then-encrypt."""
        if self.comp is not None and len(raw) >= self.comp_min:
            raw = encode_frame(CTRL_COMP, 0, {"a": self.comp.name},
                               self.comp.compress(raw))
            self.compressed_out += 1
        if self.secure and self.conn_key:
            raw = self.wire_encrypt(raw)
        return raw

    def wire_decompress(self, algo: str, data: bytes) -> bytes:
        from ..compressor import CompressorError, create
        c = self._decomp_cache.get(algo)
        if c is None:
            try:
                c = self._decomp_cache[algo] = create(algo)
            except CompressorError as e:
                raise ValueError(f"bad compression algo: {e}") from e
        try:
            return c.decompress(data)
        except CompressorError as e:
            raise ValueError(f"corrupt compressed frame: {e}") from e

    def set_conn_key(self, key: bytes | None, direction: bytes) -> None:
        """Install the per-wire-epoch key; the counter reset is safe
        because every HELLO derives a fresh key from a fresh nonce."""
        self.conn_key = key
        self._enc_ctr = 0
        self._dec_ctr = 0
        self._enc_dir = direction
        if key is not None:
            from cryptography.hazmat.primitives.ciphers.aead import AESGCM
            self._aead = AESGCM(key)
        else:
            self._aead = None

    def wire_encrypt(self, raw: bytes) -> bytes:
        """AES-GCM-wrap one plaintext frame for the wire (secure mode,
        reference msg/async/crypto_onwire.cc rx/tx handlers)."""
        self._enc_ctr += 1
        nonce = self._enc_dir * 4 + self._enc_ctr.to_bytes(8, "little")
        ct = self._aead.encrypt(nonce, raw, b"")
        return encode_frame(CTRL_ENC, self._enc_ctr, {}, nonce + ct)

    def wire_decrypt(self, data: bytes) -> bytes:
        # The nonce is implicit state, not attacker-controlled input: it
        # must be exactly (peer direction byte, rx_counter+1).  Checking
        # the frame's claimed nonce against our own counter rejects
        # replayed or reordered ciphertext that would otherwise pass
        # AEAD and poison the seq window (reference crypto_onwire.cc
        # uses a strictly-incrementing implicit nonce for the same
        # reason).
        peer_dir = b"\x02" if self._enc_dir == b"\x01" else b"\x01"
        expect = peer_dir * 4 + (self._dec_ctr + 1).to_bytes(8, "little")
        if data[:12] != expect:
            raise ValueError(
                "secure frame rejected: nonce out of sequence "
                "(replayed or reordered ciphertext)")
        try:
            pt = self._aead.decrypt(data[:12], data[12:], b"")
        except Exception as e:  # noqa: BLE001 - InvalidTag et al
            # surfaces as a session-preserving wire reset (same path as
            # a crc failure in plain mode)
            raise ValueError(f"secure frame rejected: {e}") from e
        self._dec_ctr += 1
        return pt

    def reset_epoch(self) -> None:
        """Abandon this session's delivery state and start a fresh epoch
        in place: new nonce (receiver will not dedup against the old seq
        space) and new cookie (peer resets its dedup window).  Used to
        self-heal after an unacked-window overflow so callers holding a
        cached Connection keep working (at-least-once across the reset;
        the overflow already lost the old window)."""
        self.nonce = uuid.uuid4().hex[:12]
        self.local_cookie = uuid.uuid4().hex[:12]
        self.peer_cookie = None
        self.out_seq = 0
        self.in_seq = 0
        self.last_acked = 0
        self.unacked.clear()
        self.broken = False
        self.drop_wire()

    def record_out(self, seq: int, raw: bytes) -> None:
        if self.lossless:
            self.unacked.append((seq, raw))
            if len(self.unacked) > UNACKED_HARD_CAP:
                # peer has not acked for 64k frames: abnormal reset
                self.unacked.clear()
                self.broken = True
                self.drop_wire()

    def trim_acked(self, upto: int) -> None:
        while self.unacked and self.unacked[0][0] <= upto:
            self.unacked.popleft()

    def replay_frames(self, peer_in_seq: int) -> list[bytes]:
        self.trim_acked(peer_in_seq)
        # retention holds parts-tuples (zero-concat send path); join
        # only here, on the rare replay
        return [raw if isinstance(raw, bytes) else b"".join(raw)
                for _, raw in self.unacked]

    def drop_wire(self) -> None:
        import time
        self.down_since = time.monotonic()
        w, self.writer, self.reader = self.writer, None, None
        if w is not None:
            try:
                w.transport.abort()
            except Exception:  # noqa: BLE001
                pass


class Connection:
    """One peer endpoint (reference AsyncConnection).  Client connections
    own their Session and reconnect on failure; accepted connections bind
    to a server-side Session resumed via HELLO and never dial out —
    frames they queue while the wire is down are replayed when the peer
    reconnects."""

    def __init__(self, messenger: "Messenger",
                 peer_addr: tuple[str, int] | None,
                 lossless: bool = True,
                 session: Session | None = None,
                 can_reconnect: bool = True):
        self.messenger = messenger
        self.peer_addr = peer_addr
        self.lossless = lossless
        self.session = session or Session(lossless)
        self.can_reconnect = can_reconnect
        self._closed = False
        self.last_error: str | None = None
        self.peer_entity: str | None = None
        self._label: str | None = None   # cached ledger peer label

    def is_connected(self) -> bool:
        return self.session.writer is not None and not self._closed

    def _peer_label(self) -> str:
        """Short peer name for ledger rows / trace events: the peer
        entity with its per-process uuid dropped ('osd.3'), else
        ip:port.  Cached once the entity is known (it never changes
        afterwards)."""
        lab = self._label
        if lab is None:
            ent = self.peer_entity
            if ent:
                lab = ent.rsplit(".", 1)[0] or ent
                self._label = lab
            elif self.peer_addr:
                lab = f"{self.peer_addr[0]}:{self.peer_addr[1]}"
            else:
                lab = "?"
        return lab

    # -- sending (thread-safe entry) ---------------------------------------

    def send_message(self, msg: Message) -> None:
        self.messenger._run_soon(self._send(msg))

    async def _send(self, msg: Message) -> None:
        sess = self.session
        m = self.messenger
        async with sess.send_lock:
            if sess.broken:
                if not self.can_reconnect:
                    # accepted side cannot dial; the peer's next
                    # reconnect gets a fresh session (see _on_accept)
                    return
                sess.reset_epoch()
            sess.out_seq += 1
            raw = msg.encode_parts(sess.out_seq)
            sess.record_out(sess.out_seq, raw)
            if sess.broken:       # overflow tripped by this very frame
                if not self.can_reconnect:
                    return
                sess.reset_epoch()          # carry this frame into the
                sess.out_seq = 1            # fresh epoch
                raw = msg.encode_parts(1)
                sess.record_out(1, raw)
            if m.inject_dispatch_stall > 0:
                # fault injection (conf ms_inject_dispatch_stall): the
                # assembled frame sits in the send queue while the
                # reactor "works" — a stalled dispatch's exact shape;
                # the late msgr_send(peer) stamp inherits the blame
                await asyncio.sleep(m.inject_dispatch_stall)
            try:
                if sess.writer is None:
                    if not self.can_reconnect:
                        return  # replayed when the peer reconnects
                    await self._connect()
                    if self.lossless:
                        # _connect's replay already carried raw
                        self._note_sent(msg, raw)
                        return
                await self._write_raw(raw)
                self._note_sent(msg, raw)
            except (ConnectionError, OSError, asyncio.TimeoutError,
                    asyncio.IncompleteReadError, ValueError) as e:
                # IncompleteReadError (EOF mid-HELLO) and ValueError
                # (corrupt HELLO reply) must not escape: an unhandled
                # reactor-task exception would strand the frame in
                # sess.unacked with no reconnect scheduled
                self.last_error = str(e)
                await self._reconnect()

    def _note_sent(self, msg: Message, raw) -> None:
        """Wire-plane ledger + trace stitch for one sent frame; one
        attribute check when the ledger is off."""
        m = self.messenger
        if not m.ledger.enabled:
            return
        parts = raw if isinstance(raw, tuple) else (raw,)
        nbytes = 0
        for p in parts:
            nbytes += len(p)
        peer = self._peer_label()
        m.stats.note_send(peer, type(msg).__name__, nbytes,
                          len(self.session.unacked))
        top = getattr(msg, "_top", None)
        if top is not None and getattr(top, "is_tracked", False):
            # the interval ENDING here (send-queue + wire write) lands
            # on the op timeline named by peer, so slow-op blame can
            # say "5.1 s in the send queue to osd.7"
            top.mark_event(f"msgr_send({peer})")

    async def _write_raw(self, raw: bytes) -> None:
        """Single choke point for outgoing bytes: fault injection hooks
        live here (reference ms_inject_socket_failures / ms_inject_delay
        applied in AsyncConnection::write)."""
        m = self.messenger
        if m.inject_delay_prob > 0 and \
                m._inject_rng.random() < m.inject_delay_prob:
            await asyncio.sleep(m._inject_rng.random() * m.inject_delay_max)
        if m.inject_socket_failures > 0 and \
                m._inject_rng.randrange(m.inject_socket_failures) == 0:
            m.injected_failures += 1
            self.session.drop_wire()
            raise ConnectionResetError("injected socket failure")
        writer = self.session.writer
        if writer is None:
            # wire dropped while we slept in the injected delay (the
            # accepted-conn read loop nulls it without the send lock)
            raise ConnectionResetError("wire dropped during delayed write")
        sess = self.session
        parts = raw if isinstance(raw, tuple) else (raw,)
        if sess.comp is not None or (sess.secure and sess.conn_key):
            # compression/encryption wrap the whole frame: join first
            joined = b"".join(parts)
            wired = sess.wire_prepare(joined)
            if m.ledger.enabled:
                m.stats.note_wrapped(
                    self._peer_label(), len(wired),
                    compressed=sess.comp is not None and
                    len(joined) >= sess.comp_min,
                    encrypted=bool(sess.secure and sess.conn_key))
            writer.write(wired)
        else:
            # writev-style: payload buffers go to the transport as-is,
            # never copied into one frame buffer
            for p in parts:
                writer.write(p)
        await writer.drain()

    async def _connect(self) -> None:
        """Open the TCP stream and run the HELLO exchange: send our
        entity + in_seq (+ authorizer), read the peer's (+ mutual auth
        proof), trim + replay unacked."""
        assert self.peer_addr is not None
        # 4 MiB stream buffer: the default 64 KiB limit makes every
        # 128 KiB shard reply / 1 MiB op reply ping-pong through flow
        # control pauses (resume_reading wakeups) several times per
        # frame
        reader, writer = await asyncio.open_connection(
            *self.peer_addr, limit=4 << 20)
        _grow_socket_buffers(writer)
        sess = self.session
        m = self.messenger
        hello_meta = {
            "entity": m.entity,
            "session": sess.nonce,
            "in_seq": sess.in_seq,
            "peer_cookie": sess.peer_cookie,
            "lossless": self.lossless,
            "secure": m.secure,
            "compress": [m.compress_algo] if m.compress_algo else [],
        }
        authorizer = None
        if m.auth is not None:
            authorizer = m.auth.build_authorizer(secure=m.secure)
            hello_meta["auth"] = authorizer
        writer.write(encode_frame(CTRL_HELLO, 0, hello_meta))
        await writer.drain()
        tid, _seq, meta_raw, _data, _pcrc = await asyncio.wait_for(
            read_frame(reader), timeout=5.0)
        if tid != CTRL_HELLO:
            writer.close()
            raise ConnectionError(f"expected HELLO, got frame type {tid:#x}")
        meta = json.loads(meta_raw.decode())
        if meta.get("auth_error"):
            # bad credentials are fatal, not retryable
            writer.close()
            self._closed = True
            raise ConnectionError(f"auth rejected: {meta['auth_error']}")
        if authorizer is not None:
            from ..auth.cephx import AuthError
            try:
                key = m.auth.check_reply(
                    authorizer, meta.get("auth_reply"))
            except AuthError as e:
                writer.close()
                self._closed = True
                raise ConnectionError(str(e)) from e
            sess.set_conn_key(key, b"\x01")
            # the secure decision was authenticated by check_reply
            # (mismatch already raised); m.secure == the agreed mode
            sess.secure = m.secure
            # mutual proof: whoever answered holds cluster-side
            # credentials (service key, keyring, or our ticket's
            # session key — all daemon-resident), so frames arriving
            # on this outbound session are from a cluster daemon
            sess.auth_identity = {"entity": meta.get("entity"),
                                  "kind": "service", "caps": ""}
        # compression: the server echoes the chosen algo — accept it
        # only if it is exactly what we offered (a bogus echo must not
        # crash the connect path or select an algo we lack)
        chosen = meta.get("compress")
        if chosen and chosen == m.compress_algo:
            from ..compressor import create
            sess.comp = create(chosen)
            sess.comp_min = m.compress_min
        else:
            sess.comp = None
        self.peer_entity = meta.get("entity")
        cookie = meta.get("cookie")
        if self.lossless and cookie != sess.peer_cookie:
            # New server-side session epoch (restart, prune, or we never
            # saw this session's first reply): its out_seq space starts
            # over at 0, so our dedup window must too, or we would
            # silently drop its first in_seq frames as replays.
            sess.in_seq = 0
            sess.last_acked = 0
            sess.peer_cookie = cookie
        sess.reader, sess.writer = reader, writer
        frames = sess.replay_frames(int(meta.get("in_seq", 0)))
        if frames and m.ledger.enabled:
            m.stats.note_replay(self._peer_label(), len(frames))
        for raw in frames:
            writer.write(sess.wire_prepare(raw))
        await writer.drain()
        self.messenger._spawn_read_loop(self)

    async def _reconnect(self) -> None:
        """Lossless policy: reconnect; the HELLO exchange replays exactly
        the frames the peer is missing (reference session reset/replay)."""
        if not self.lossless or not self.can_reconnect or \
                self.peer_addr is None or self._closed:
            return
        m = self.messenger
        if m.ledger.enabled:
            m.stats.note_reconnect(self._peer_label())
        for attempt in range(5):
            try:
                await asyncio.sleep(0.05 * (attempt + 1))
                self.session.drop_wire()
                await self._connect()
                return
            except (ConnectionError, OSError, asyncio.TimeoutError,
                    asyncio.IncompleteReadError, ValueError) as e:
                self.last_error = str(e)
        self._closed = True

    async def _send_ack(self) -> None:
        sess = self.session
        writer = sess.writer
        if writer is None:
            return
        try:
            sess.last_acked = sess.in_seq
            writer.write(sess.wire_prepare(
                encode_frame(CTRL_ACK, sess.in_seq, {})))
        except (ConnectionError, OSError):
            pass  # peer will learn our in_seq from the next HELLO

    async def _close(self) -> None:
        self._closed = True
        sess = self.session
        if sess.writer is not None:
            try:
                sess.writer.close()
            except Exception:  # noqa: BLE001
                pass
            sess.writer = None
            sess.reader = None

    def close(self) -> None:
        self.messenger._run_soon(self._close())


class Messenger:
    """Owns the reactor; binds servers; creates client connections
    (reference Messenger::create + bind + add_dispatcher_head)."""

    _loops: list[asyncio.AbstractEventLoop] = []
    _loop_threads: list[threading.Thread] = []
    _executor = None
    _next_loop = 0
    _loop_lock = threading.Lock()
    # pool size (reference ms_async_op_threads): loops beyond the core
    # count only add context switches — measured on a 1-core host,
    # 4 loops made the 8-way 128 KiB fan-out *slower* (4.8 vs 4.2 ms).
    # The auto default; conf ms_async_op_threads overrides it through
    # configure_pool() BEFORE the first messenger exists.
    import os as _os
    REACTORS = max(1, min(4, _os.cpu_count() or 1))

    @classmethod
    def configure_pool(cls, reactors) -> None:
        """Startup sizing of the reactor pool (conf
        ms_async_op_threads): applies to the NEXT pool creation — an
        already-running pool keeps its size (pinned loops cannot be
        resized live; the reference reads ms_async_op_threads once at
        start too).  0/None keeps the cpu-count auto size."""
        if reactors:
            n = int(reactors)
            if n > 0:
                cls.REACTORS = n

    def __init__(self, name: str = "client", auth=None,
                 secure: bool = False):
        self.name = name
        # Stable per-instance identity; the session key (reference
        # entity_name_t + nonce in the ProtocolV2 banner).
        self.entity = f"{name}.{uuid.uuid4().hex[:12]}"
        # auth context (auth.CephxAuth) — when set, every accepted
        # connection must present a verifiable authorizer and every
        # outgoing HELLO carries one; secure=True additionally AES-GCM
        # encrypts all frames under the per-connection key
        self.auth = auth
        self.secure = secure
        # on-wire compression opt-in (reference ms_osd_compress_mode);
        # effective only when both endpoints enable it
        self.compress_algo: str | None = None
        self.compress_min = 4096
        self.dispatcher: Dispatcher | None = None
        # fast dispatch (reference ms_fast_dispatch): a predicate
        # selecting messages whose handler is guaranteed non-blocking
        # (no nested synchronous RPC, no long store I/O waits).  Those
        # run INLINE on the reactor, skipping the executor's two
        # context switches per message — the dominant cost of the EC
        # sub-read fan-out on few-core hosts.
        self.fast_dispatch: Callable[[Message], bool] | None = None
        # test hook: drop received messages matching a predicate
        # (message-loss partitions without killing processes)
        self.recv_filter = None
        self.my_addr: tuple[str, int] | None = None
        self._server: asyncio.AbstractServer | None = None
        self._conns: dict[tuple[str, int], Connection] = {}
        self._accepted: list[Connection] = []
        self._sessions: dict[str, Session] = {}
        # fault injection (reference ms_inject_* dev options)
        self.inject_socket_failures = 0   # ~1/N frames resets the socket
        self.inject_delay_prob = 0.0
        self.inject_delay_max = 0.0
        self.injected_failures = 0
        self._inject_rng = random.Random(0xC3B7)
        # conf ms_inject_dispatch_stall: sleep this long in the send
        # path before the wire write (a stalled dispatch for the
        # slow-op blame gates)
        self.inject_dispatch_stall = 0.0
        # blocking-bridge deadline (conf ms_sync_timeout; was a
        # hardcoded 30 s) — expiries count in msgr_sync_timeouts
        self.sync_timeout = 30.0
        # wire-plane flight recorder (msg/msgr_ledger.py): the
        # process ledger plus this messenger's own counter slice
        self.ledger = MsgrLedger.host_instance()
        self.stats = self.ledger.register_messenger(self.entity)
        # pin this messenger to one loop of the pool for its lifetime
        self._loop = self._pick_loop()

    # -- reactor pool -------------------------------------------------------

    @classmethod
    def _ensure_pool(cls) -> list[asyncio.AbstractEventLoop]:
        with cls._loop_lock:
            if not cls._loops or \
                    not all(t.is_alive() for t in cls._loop_threads):
                cls._loops, cls._loop_threads = [], []
                # Wide dispatcher pool, SHARED across loops: handlers may
                # block on nested RPC round-trips (shard stat/attr fetches
                # inside a client-op handler), so the pool must exceed the
                # plausible nesting across all in-process daemons
                # (single-host test clusters share this pool).
                from concurrent.futures import ThreadPoolExecutor
                cls._executor = ThreadPoolExecutor(
                    max_workers=96, thread_name_prefix="msgr-dispatch")
                for i in range(cls.REACTORS):
                    loop = asyncio.new_event_loop()
                    loop.set_default_executor(cls._executor)

                    def run(loop=loop):
                        asyncio.set_event_loop(loop)
                        loop.run_forever()

                    t = threading.Thread(target=run,
                                         name=f"msgr-reactor-{i}",
                                         daemon=True)
                    t.start()
                    cls._loops.append(loop)
                    cls._loop_threads.append(t)
                # arm the per-reactor loop-lag probe on the fresh pool
                # (wire-plane flight recorder, msg/msgr_ledger.py)
                msgr_ledger().attach_reactors(cls._loops)
            return cls._loops

    @classmethod
    def _pick_loop(cls) -> asyncio.AbstractEventLoop:
        loops = cls._ensure_pool()
        with cls._loop_lock:
            cls._next_loop += 1
            return loops[cls._next_loop % len(loops)]

    @classmethod
    def dispatch_executor(cls):
        """The shared dispatcher thread pool — for handlers that must
        hand work OFF the reactor (blocking pipeline continuations)."""
        cls._ensure_pool()
        return cls._executor

    @classmethod
    def submit_dispatch(cls, fn, *args) -> None:
        """dispatch_executor().submit with the exception fence the
        bare Future lacks: a pipeline continuation that raises must
        surface a traceback, not die unobserved in the Future.  Queue
        wait and run time land in the wire-plane ledger's
        lat_msgr_qwait / lat_msgr_dispatch histograms."""
        led = msgr_ledger()
        t_sub = led.dispatch_submit() if led.enabled else None

        def run():
            t_run = led.dispatch_run(t_sub) if t_sub is not None \
                else None
            try:
                fn(*args)
            except Exception:  # noqa: BLE001
                import traceback
                traceback.print_exc()
            finally:
                if t_run is not None:
                    led.dispatch_done(t_run)

        cls.dispatch_executor().submit(run)

    def _run_soon(self, coro) -> None:
        # self._loop is pinned for the messenger's lifetime: pool
        # loops never stop while healthy, and run_coroutine_threadsafe
        # queues correctly even on a loop that has not entered
        # run_forever yet — re-picking here could split one session's
        # coroutines (and its asyncio.Lock) across two loops
        asyncio.run_coroutine_threadsafe(coro, self._loop)

    def send_batch(self, pairs) -> None:
        """Send [(conn, msg), ...] with ONE loop signal for the whole
        batch — a k-way shard fan-out otherwise pays a task creation +
        loop wakeup per message.  Each CONNECTION still gets its own
        task (messages to one peer stay ordered, but a dead/
        unreachable peer must not head-of-line-block the other
        shards' sends behind its reconnect timeouts)."""

        async def _send_group(conn, msgs):
            for m in msgs:
                try:
                    await conn._send(m)
                except Exception:  # noqa: BLE001 - per-conn isolation
                    import traceback
                    traceback.print_exc()

        async def _all():
            groups: dict[int, tuple] = {}
            for conn, msg in pairs:
                groups.setdefault(id(conn), (conn, []))[1].append(msg)
            for conn, msgs in groups.values():
                asyncio.ensure_future(_send_group(conn, msgs))

        self._run_soon(_all())

    def _run_sync(self, coro, timeout: float | None = None):
        """Blocking bridge into the reactor.  The default deadline is
        conf ms_sync_timeout (was a hardcoded 30 s); an expiry counts
        in the ledger (msgr_sync_timeouts) before surfacing — the
        caller still needs the exception, but the event is no longer
        invisible."""
        fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
        try:
            return fut.result(self.sync_timeout if timeout is None
                              else timeout)
        except _FuturesTimeout:
            if self.ledger.enabled:
                self.stats.note_sync_timeout()
            raise

    # -- server side --------------------------------------------------------

    def add_dispatcher(self, dispatcher: Dispatcher) -> None:
        self.dispatcher = dispatcher

    def bind(self, addr: tuple[str, int]) -> tuple[str, int]:
        """Bind and start accepting; port 0 picks a free port."""

        async def _bind():
            server = await asyncio.start_server(
                self._on_accept, addr[0], addr[1], limit=4 << 20)
            return server

        self._server = self._run_sync(_bind())
        sock = self._server.sockets[0]
        self.my_addr = sock.getsockname()[:2]
        return self.my_addr

    async def _on_accept(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        """Accept = read the peer's HELLO, bind/resume its Session, reply
        with our in_seq, replay anything it is missing."""
        try:
            tid, _seq, meta_raw, _data, _pcrc = await asyncio.wait_for(
                read_frame(reader), timeout=10.0)
            if tid != CTRL_HELLO:
                writer.close()
                return
            meta = json.loads(meta_raw.decode())
        except (asyncio.IncompleteReadError, asyncio.TimeoutError,
                ConnectionError, OSError, ValueError):
            writer.close()
            return
        entity = str(meta.get("entity", ""))
        lossless = bool(meta.get("lossless", True))
        nonce = str(meta.get("session", ""))
        claimed_entity = entity
        # authorizer gate (reference AuthAuthorizeHandler at accept):
        # with an auth context, no verifiable authorizer -> no session
        auth_identity = None
        conn_key = None
        auth_reply = None
        if self.auth is not None:
            from ..auth.cephx import AuthError
            try:
                auth_identity, conn_key, auth_reply = \
                    self.auth.verify_authorizer(meta.get("auth"),
                                                server_secure=self.secure)
            except AuthError as e:
                try:
                    writer.write(encode_frame(CTRL_HELLO, 0, {
                        "entity": self.entity, "auth_error": str(e)}))
                    await writer.drain()
                except (ConnectionError, OSError):
                    pass
                writer.close()
                return
            # Session resumption is a capability of the AUTHENTICATED
            # identity: a peer holding different credentials must not
            # resume (and thereby hijack + drain the replay window of)
            # another daemon's session just by claiming its entity
            # string from a sniffed HELLO.
            entity = f"{auth_identity['entity']}/{claimed_entity}"
        self._prune_sessions()
        if lossless:
            sess = self._sessions.get(entity)
            # a broken session (unacked overflow) must not be resumed:
            # its _send path drops frames, so hand out a fresh one — the
            # new cookie makes the client reset its dedup window
            if sess is None or sess.nonce != nonce or sess.broken:
                sess = Session(lossless=True, nonce=nonce)
                self._sessions[entity] = sess
        else:
            sess = Session(lossless=False, nonce=nonce)
        sess.drop_wire()          # supersede any stale stream
        _grow_socket_buffers(writer)
        sess.reader, sess.writer = reader, writer
        sess.auth_identity = auth_identity
        sess.set_conn_key(conn_key, b"\x02")
        sess.secure = bool(auth_identity and
                           auth_identity.get("secure"))
        # compression: accept the client's offer when we opt in too
        offered = meta.get("compress") or []
        chosen = None
        if self.compress_algo and offered:
            from ..compressor import available, create
            for algo in offered:
                if algo in available():
                    chosen = algo
                    sess.comp = create(algo)
                    sess.comp_min = self.compress_min
                    break
        if chosen is None:
            sess.comp = None
        conn = Connection(self, None, lossless=lossless, session=sess,
                          can_reconnect=False)
        conn.peer_entity = claimed_entity
        peer = writer.get_extra_info("peername")
        conn.peer_addr = peer[:2] if peer else None
        # one facade per session: drop superseded ones from the registry
        self._accepted = [c for c in self._accepted
                          if c.session is not sess]
        self._accepted.append(conn)
        try:
            reply_meta = {"entity": self.entity, "in_seq": sess.in_seq,
                          "cookie": sess.local_cookie,
                          "secure": sess.secure,
                          "compress": chosen}
            if auth_reply is not None:
                reply_meta["auth_reply"] = auth_reply
            writer.write(encode_frame(CTRL_HELLO, 0, reply_meta))
            # The client's in_seq only counts frames of THIS session
            # epoch if it has seen our cookie; a stale epoch's in_seq
            # must trim nothing or undelivered replies would be lost.
            peer_in = int(meta.get("in_seq", 0)) \
                if meta.get("peer_cookie") == sess.local_cookie else 0
            frames = sess.replay_frames(peer_in)
            if frames and self.ledger.enabled:
                self.stats.note_replay(conn._peer_label(), len(frames))
            for raw in frames:
                writer.write(sess.wire_prepare(raw))
            await writer.drain()
        except (ConnectionError, OSError):
            writer.close()
            return
        self._spawn_read_loop(conn)

    def _prune_sessions(self, max_down: float = 600.0) -> None:
        """Reap server-side sessions whose wire has been down for a long
        time (their entities are per-process uuids, so a dead peer never
        comes back) and accepted-conn facades whose wire was superseded."""
        import time
        now = time.monotonic()
        for entity, sess in list(self._sessions.items()):
            if sess.writer is None and sess.down_since is not None and \
                    now - sess.down_since > max_down:
                del self._sessions[entity]
        self._accepted = [c for c in self._accepted
                          if c.session.reader is not None]

    # -- client side --------------------------------------------------------

    def connect(self, addr: tuple[str, int],
                lossless: bool = True) -> Connection:
        """Get-or-create the client connection for addr.  Lossless and
        lossy conns are separate sessions (the reference runs heartbeats
        on dedicated lossy messengers for the same reason: ping retention
        and replay make no sense)."""
        key = (addr[0], addr[1], lossless)
        conn = self._conns.get(key)
        if conn is None or conn._closed:
            # Carry the old session into the replacement connection: the
            # server resumes sessions by entity, so a fresh seq space
            # would collide with its dedup window (frames silently
            # dropped as "already seen").  A broken session (unacked
            # overflow) starts over with a new nonce.
            old = conn
            sess = None
            if old is not None and not old.session.broken:
                sess = old.session
            conn = Connection(self, (addr[0], addr[1]), lossless=lossless,
                              session=sess)
            self._conns[key] = conn
        return conn

    # -- read loop ----------------------------------------------------------

    def _spawn_read_loop(self, conn: Connection) -> None:
        self._run_soon(self._read_loop(conn, conn.session.reader))

    async def _read_loop(self, conn: Connection,
                         reader: asyncio.StreamReader) -> None:
        sess = conn.session
        try:
            while not conn._closed and reader is sess.reader:
                tid, seq, meta_raw, data, pcrc = await read_frame(reader)
                if reader is not sess.reader:
                    # epoch reset while we were blocked in read_frame: a
                    # buffered old-epoch frame must not touch the fresh
                    # epoch's seq window (in_seq poisoning)
                    break
                if tid == CTRL_ENC:
                    if sess.conn_key is None:
                        raise ValueError("encrypted frame on plain session")
                    inner = sess.wire_decrypt(data)  # raises on tamper
                    tid, seq, meta_raw, data, pcrc = _parse_raw(inner)
                elif sess.secure and sess.conn_key is not None and \
                        tid != CTRL_HELLO:
                    # plaintext data frame on a secure session: reject
                    raise ValueError("plaintext frame on secure session")
                if tid == CTRL_COMP:
                    algo = json.loads(meta_raw.decode()).get("a", "")
                    inner = sess.wire_decompress(algo, data)
                    tid, seq, meta_raw, data, pcrc = _parse_raw(inner)
                if tid == CTRL_ACK:
                    sess.trim_acked(seq)
                    continue
                if tid == CTRL_HELLO:
                    continue  # late/duplicate hello: ignore
                if conn.lossless and seq <= sess.in_seq:
                    # replayed frame we already delivered: re-ack, drop
                    # (reference ProtocolV2 in_seq dedup on session resume)
                    await conn._send_ack()
                    continue
                msg = Message.decode(tid, seq, meta_raw, data, pcrc)
                # ingest stamp for op tracking (reference
                # Message::recv_stamp set by the messenger): dispatch
                # latency is attributable even when the executor queues
                msg.recv_stamp = time.time()
                if self.ledger.enabled:
                    self.stats.note_recv(
                        conn._peer_label(), type(msg).__name__,
                        Message.HEADER_SIZE + len(meta_raw) +
                        len(data) + 4)
                sess.in_seq = seq
                if self.recv_filter is not None and \
                        self.recv_filter(msg):
                    # injected receive-side loss (partition testing):
                    # the frame is consumed and acked but never reaches
                    # the dispatcher — indistinguishable, to the
                    # protocol above, from a network that ate it
                    continue
                if self.dispatcher is not None:
                    if self.fast_dispatch is not None and \
                            self.fast_dispatch(msg):
                        # inline on the reactor (handler is declared
                        # non-blocking); fence exceptions so a handler
                        # bug cannot kill the read loop
                        try:
                            self.dispatcher(conn, msg)
                        except Exception:  # noqa: BLE001
                            import traceback
                            traceback.print_exc()
                    else:
                        # dispatch off-reactor so handlers may send
                        # synchronously / block on nested RPCs; the
                        # ledger times queue wait + handler run so
                        # "dispatcher slow" is attributable
                        led = self.ledger
                        if led.enabled:
                            t_sub = led.dispatch_submit()

                            def _timed(d=self.dispatcher, c=conn,
                                       mm=msg, t=t_sub):
                                t_run = led.dispatch_run(t)
                                try:
                                    d(c, mm)
                                finally:
                                    led.dispatch_done(t_run)

                            await asyncio.get_event_loop() \
                                .run_in_executor(None, _timed)
                        else:
                            await asyncio.get_event_loop() \
                                .run_in_executor(None, self.dispatcher,
                                                 conn, msg)
                # Batch acks: piggyback-style — ack when the pipe goes
                # idle or every 64 frames, not per message (reference
                # ProtocolV2 acks lazily from the write path too).
                buffered = getattr(reader, "_buffer", None)
                if (buffered is not None and len(buffered) == 0) or \
                        sess.in_seq - sess.last_acked >= 64:
                    await conn._send_ack()
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            # Wire died under us.  Mark the wire down (starts the prune
            # clock for accepted sessions); client conns re-dial so
            # pending server replies (in the peer's unacked window) flow.
            if not conn.can_reconnect:
                if sess.reader is reader:
                    sess.drop_wire()
            elif not conn._closed:
                async with sess.send_lock:
                    if sess.reader is reader or sess.reader is None:
                        sess.drop_wire()
                        await conn._reconnect()
        except ValueError as e:
            # crc/corruption: abort this wire; the session (seq window)
            # survives, so a reconnect replays cleanly (reference
            # ProtocolV2 treats a bad crc as a session-preserving reset)
            conn.last_error = str(e)
            if sess.reader is reader:
                sess.drop_wire()
            if conn.can_reconnect and not conn._closed:
                async with sess.send_lock:
                    if sess.writer is None:
                        await conn._reconnect()

    # -- lifecycle ----------------------------------------------------------

    def shutdown(self) -> None:
        async def _stop():
            if self._server is not None:
                self._server.close()
            for c in list(self._conns.values()) + self._accepted:
                await c._close()
            self._sessions.clear()
            self._accepted.clear()
            self._conns.clear()
        try:
            self._run_sync(_stop(), timeout=5)
        except Exception:  # noqa: BLE001
            pass
