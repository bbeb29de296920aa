"""Admin socket: per-daemon out-of-band introspection.

Re-expresses the reference's AdminSocket (src/common/admin_socket.h:105):
a unix-domain socket every daemon exposes regardless of cluster health,
answering JSON commands — `perf dump`, `config show`, `config set`,
`dump_ops_in_flight`, plus commands components register at runtime.

Protocol: client sends one JSON line {"prefix": ...}, daemon replies
with a 4-byte big-endian length + JSON body (close enough to the
reference's framing to feel familiar, simple enough for `nc -U`).

The port's copy of ceph_tpu/common/admin_socket.py (standard library
only).
"""

from __future__ import annotations

import json
import os
import socket
import struct
import threading
from typing import Callable

Handler = Callable[[dict], dict]


class AdminSocket:
    def __init__(self, path: str):
        self.path = path
        self._handlers: dict[str, Handler] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        if os.path.exists(path):
            os.unlink(path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(path)
        self._sock.listen(8)
        self._sock.settimeout(0.25)
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name=f"asok:{os.path.basename(path)}")
        self._thread.start()

    def register_command(self, prefix: str, handler: Handler) -> None:
        with self._lock:
            self._handlers[prefix] = handler

    def shutdown(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)
        try:
            self._sock.close()
            os.unlink(self.path)
        except OSError:
            pass

    # -- server -------------------------------------------------------------

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _handle(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(5)
            data = b""
            while not data.endswith(b"\n"):
                chunk = conn.recv(65536)
                if not chunk:
                    break
                data += chunk
            req = json.loads(data.decode() or "{}")
            prefix = req.get("prefix", "")
            with self._lock:
                handler = self._handlers.get(prefix)
            if handler is None:
                reply = {"error": f"unknown command {prefix!r}",
                         "known": sorted(self._handlers)}
            else:
                reply = handler(req)
            body = json.dumps(reply).encode()
            conn.sendall(struct.pack(">I", len(body)) + body)
        except Exception as e:  # noqa: BLE001
            try:
                body = json.dumps({"error": repr(e)}).encode()
                conn.sendall(struct.pack(">I", len(body)) + body)
            except OSError:
                pass
        finally:
            conn.close()


def admin_command(path: str, cmd: dict, timeout: float = 5.0) -> dict:
    """Client side: one round trip to a daemon's admin socket."""
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(timeout)
    try:
        s.connect(path)
        s.sendall(json.dumps(cmd).encode() + b"\n")
        raw = b""
        while len(raw) < 4:
            raw += s.recv(4 - len(raw))
        (ln,) = struct.unpack(">I", raw)
        body = b""
        while len(body) < ln:
            body += s.recv(ln - len(body))
        return json.loads(body.decode())
    finally:
        s.close()
