"""cephx-role protocol: tickets, authorizers, per-connection keys.

Re-expresses reference src/auth/cephx/CephxProtocol.{h,cc} reduced to
its load-bearing shape:

- The mon issues a TICKET: {entity, caps, session_key, expiry}
  AES-GCM-sealed under the cluster SERVICE KEY.  The client cannot read
  or forge it; every daemon (which holds the service key) can.
  (reference CephXTicketBlob sealed under the service secret.)
- A connection presents an AUTHORIZER: the ticket (or a direct
  shared-key identity for daemons/mon clients) plus an HMAC proof over
  a fresh nonce+timestamp.  The acceptor verifies the proof with the
  key it can derive, and returns its own proof over the client's nonce
  (mutual authentication — reference CephXAuthorizeReply).
- Both ends derive a per-connection key = HMAC(base_key, nonce); the
  secure wire mode (crypto_onwire.cc role) AES-GCM-encrypts every
  frame under it.

Authorizer kinds and who can verify them:
  "client_key"  proof with the entity's own keyring secret — only the
                mon (keyring holder) verifies; used client->mon.
  "service"     proof with the cluster service key — any daemon
                verifies; used daemon<->daemon and daemon->mon.
  "ticket"      mon-issued ticket + proof with its session key — any
                daemon verifies; used client->osd.
"""

from __future__ import annotations

import base64
import hmac
import hashlib
import json
import os
import time

try:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
except ImportError:          # optional dep: auth protocol still
    AESGCM = None            # importable, sealing raises at use


class AuthError(Exception):
    pass


def _require_aead():
    if AESGCM is None:
        raise AuthError(
            "cephx sealed payloads need the 'cryptography' package")


FRESHNESS_WINDOW = 120.0   # seconds of clock skew tolerated


def sign(key: bytes, *parts) -> str:
    h = hmac.new(key, digestmod=hashlib.sha256)
    for p in parts:
        h.update(str(p).encode() if not isinstance(p, bytes) else p)
        h.update(b"\x00")
    return h.hexdigest()[:32]


def derive_key(base: bytes, *parts) -> bytes:
    h = hmac.new(base, digestmod=hashlib.sha256)
    for p in parts:
        h.update(str(p).encode() if not isinstance(p, bytes) else p)
        h.update(b"\x00")
    return h.digest()[:16]


def _seal(key: bytes, payload: dict) -> str:
    _require_aead()
    nonce = os.urandom(12)
    ct = AESGCM(key).encrypt(nonce, json.dumps(payload).encode(), b"")
    return base64.b64encode(nonce + ct).decode()


def _unseal(key: bytes, blob: str) -> dict:
    _require_aead()
    try:
        raw = base64.b64decode(blob)
        pt = AESGCM(key).decrypt(raw[:12], raw[12:], b"")
        return json.loads(pt.decode())
    except Exception as e:  # noqa: BLE001 - tamper/garbage
        raise AuthError(f"bad ticket: {e}") from e


def seal(key: bytes, payload: dict) -> str:
    """Public sealing helper (mon seals the session key to the client)."""
    return _seal(key, payload)


def unseal(key: bytes, blob: str) -> dict:
    return _unseal(key, blob)


def issue_ticket(service_key: bytes, entity: str, caps: str = "allow *",
                 ttl: float = 3600.0) -> tuple[str, bytes]:
    """Mon-side: returns (sealed ticket blob, session_key)."""
    session_key = os.urandom(16)
    blob = _seal(service_key, {
        "entity": entity, "caps": caps,
        "session_key": base64.b64encode(session_key).decode(),
        "expires": time.time() + ttl})
    return blob, session_key


def decode_ticket(service_key: bytes, blob: str) -> dict:
    """Daemon-side: unseal + expiry check; returns the ticket dict with
    session_key as bytes."""
    t = _unseal(service_key, blob)
    if t.get("expires", 0) < time.time():
        raise AuthError("ticket expired")
    t["session_key"] = base64.b64decode(t["session_key"])
    return t


class CephxAuth:
    """Per-process auth context plugged into the Messenger.

    Daemons get (entity, service_key [, keyring on the mon]).
    Clients get (entity, own key) and later adopt a mon-issued ticket
    via set_ticket().
    """

    def __init__(self, entity: str, key: bytes | None = None,
                 service_key: bytes | None = None,
                 keyring=None):
        self.entity = entity
        self.key = key
        self.service_key = service_key
        self.keyring = keyring
        self.ticket_blob: str | None = None
        self.ticket_session_key: bytes | None = None
        self.ticket_expires = 0.0
        # acceptor-side replay fence: an authorizer's nonce may be used
        # once within the freshness window (the challenge-response fix
        # of CVE-2018-1128, collapsed to a nonce cache so the handshake
        # stays one round trip)
        self._seen_nonces: dict[tuple[str, str], float] = {}
        import threading
        self._nonce_lock = threading.Lock()

    def set_ticket(self, blob: str, session_key: bytes,
                   expires: float = 0.0) -> None:
        self.ticket_blob = blob
        self.ticket_session_key = session_key
        self.ticket_expires = expires

    def ticket_valid(self, margin: float = 60.0) -> bool:
        return (self.ticket_blob is not None and
                (self.ticket_expires == 0.0 or
                 self.ticket_expires > time.time() + margin))

    # -- client side ---------------------------------------------------------

    def build_authorizer(self, secure: bool = False) -> dict:
        """The auth section of the HELLO frame.  `secure` (the wire
        encryption request) is covered by the hmac so a man in the
        middle cannot silently downgrade it."""
        nonce = base64.b64encode(os.urandom(12)).decode()
        ts = time.time()
        if self.service_key is not None:
            kind, key = "service", self.service_key
        elif self.ticket_valid():
            kind, key = "ticket", self.ticket_session_key
        elif self.key is not None:
            kind, key = "client_key", self.key
        else:
            raise AuthError("no credentials to build an authorizer")
        auth = {"kind": kind, "entity": self.entity, "nonce": nonce,
                "ts": ts, "secure": bool(secure),
                "hmac": sign(key, kind, self.entity, nonce, ts,
                             bool(secure))}
        if kind == "ticket":
            auth["ticket"] = self.ticket_blob
        return auth

    def check_reply(self, auth: dict, reply: dict | None) -> bytes:
        """Verify the acceptor's mutual proof, which binds the FINAL
        secure-mode decision (a man in the middle can forge neither);
        both sides must agree on secure mode or the connection fails.
        Returns the derived per-connection key."""
        key = self._base_key_for(auth["kind"])
        final = bool(reply.get("secure", False)) if reply else False
        if not reply or not hmac.compare_digest(
                str(reply.get("proof", "")),
                sign(key, "server", auth["nonce"], final)):
            raise AuthError("server failed mutual authentication")
        if final != bool(auth["secure"]):
            raise AuthError("secure-mode mismatch between endpoints")
        return derive_key(key, auth["nonce"])

    def _base_key_for(self, kind: str) -> bytes:
        if kind == "service":
            return self.service_key
        if kind == "ticket":
            return self.ticket_session_key
        return self.key

    # -- acceptor side -------------------------------------------------------

    def verify_authorizer(self, auth: dict | None,
                          server_secure: bool = False
                          ) -> tuple[dict, bytes, dict]:
        """Validate an incoming authorizer.  Returns
        (identity {entity, caps, kind, secure}, per_connection_key,
        reply dict).  `server_secure` is this acceptor's wire-crypto
        config; the final secure decision (request AND support) is
        bound into the mutual proof."""
        if not auth:
            raise AuthError("authorizer required")
        kind = auth.get("kind")
        entity = str(auth.get("entity", ""))
        nonce, ts = auth.get("nonce", ""), float(auth.get("ts", 0))
        secure = bool(auth.get("secure", False))
        now = time.time()
        if abs(now - ts) > FRESHNESS_WINDOW:
            raise AuthError("authorizer outside freshness window")
        # replay fence: each (entity, nonce) authenticates exactly once
        with self._nonce_lock:
            for k in [k for k, exp in self._seen_nonces.items()
                      if exp < now]:
                del self._seen_nonces[k]
            if (entity, nonce) in self._seen_nonces:
                raise AuthError("authorizer replayed")
        caps = "allow *"
        if kind == "service":
            if self.service_key is None:
                raise AuthError("cannot verify service authorizer")
            key = self.service_key
        elif kind == "ticket":
            if self.service_key is None:
                raise AuthError("cannot verify ticket authorizer")
            t = decode_ticket(self.service_key, auth.get("ticket", ""))
            if t["entity"] != entity:
                raise AuthError("ticket entity mismatch")
            key, caps = t["session_key"], t["caps"]
        elif kind == "client_key":
            if self.keyring is None:
                raise AuthError("cannot verify client_key authorizer")
            key = self.keyring.get(entity)
            if key is None:
                raise AuthError(f"unknown entity {entity}")
            caps = self.keyring.caps.get(entity, "")
        else:
            raise AuthError(f"unknown authorizer kind {kind!r}")
        want = sign(key, kind, entity, nonce, ts, secure)
        if not hmac.compare_digest(str(auth.get("hmac", "")), want):
            raise AuthError("bad authorizer hmac")
        # Burn the nonce only AFTER the hmac verifies: a forged
        # authorizer carrying a sniffed in-flight nonce (garbage hmac)
        # must not poison the cache and DoS the legitimate handshake.
        # Re-check under the lock: two concurrent replays of the same
        # VALID authorizer both pass the early check (TOCTOU); exactly
        # one may burn the nonce and proceed.
        with self._nonce_lock:
            if (entity, nonce) in self._seen_nonces:
                raise AuthError("authorizer replayed")
            self._seen_nonces[(entity, nonce)] = now + FRESHNESS_WINDOW
        final = bool(server_secure) and secure
        reply = {"proof": sign(key, "server", nonce, final),
                 "secure": final}
        return ({"entity": entity, "caps": caps, "kind": kind,
                 "secure": final},
                derive_key(key, nonce), reply)
