"""AWS Signature Version 4: request signing + verification.

Re-expresses the reference's SigV4 support (src/rgw/rgw_auth_s3.cc
canonical request assembly + signing-key derivation) as the standard
algorithm: both halves live here so the gateway verifies exactly what
the test/CLI client signs.  Payloads are authenticated via the
x-amz-content-sha256 header; STREAMING-AWS4-HMAC-SHA256-PAYLOAD
(aws-chunked bodies, the default for large PUTs in real SDKs) is
verified chunk-by-chunk against the rolling signature chain, matching
the reference's AWSv4ComplSingle/AWSv4ComplMulti completers.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import urllib.parse

ALGO = "AWS4-HMAC-SHA256"
REGION = "default"
SERVICE = "s3"
STREAMING_PAYLOAD = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"


def _sha256(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def signing_key(secret: str, datestamp: str) -> bytes:
    k = _hmac(f"AWS4{secret}".encode(), datestamp)
    k = _hmac(k, REGION)
    k = _hmac(k, SERVICE)
    return _hmac(k, "aws4_request")


def canonical_request(method: str, path: str, query: str,
                      headers: dict[str, str], signed_headers: list[str],
                      payload_hash: str) -> str:
    q = urllib.parse.parse_qsl(query, keep_blank_values=True)
    canon_q = "&".join(
        f"{urllib.parse.quote(k, safe='-_.~')}="
        f"{urllib.parse.quote(v, safe='-_.~')}"
        for k, v in sorted(q))
    canon_h = "".join(
        f"{h}:{' '.join(headers.get(h, '').split())}\n"
        for h in signed_headers)
    # S3 canonical URI (AWS SigV4 spec, S3 variant: encode each path
    # segment exactly ONCE, '/' left alone).  The wire path arrives
    # already percent-encoded; decode it once first so keys containing
    # encoded or reserved characters don't get double-encoded — the same
    # normalization runs on sign and verify, matching real S3 SDKs.
    canon_path = urllib.parse.quote(urllib.parse.unquote(path),
                                    safe="/-_.~")
    return "\n".join([
        method, canon_path,
        canon_q, canon_h, ";".join(signed_headers), payload_hash])


def string_to_sign(amzdate: str, datestamp: str, canon_req: str) -> str:
    scope = f"{datestamp}/{REGION}/{SERVICE}/aws4_request"
    return "\n".join([ALGO, amzdate, scope, _sha256(canon_req.encode())])


def sign_request(method: str, path: str, query: str, headers: dict,
                 payload: bytes, access_key: str, secret: str) -> dict:
    """Client side: returns the headers to add (Authorization,
    x-amz-date, x-amz-content-sha256, host must already be present)."""
    now = datetime.datetime.now(datetime.timezone.utc)
    amzdate = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    payload_hash = _sha256(payload)
    hdrs = {k.lower(): v for k, v in headers.items()}
    hdrs["x-amz-date"] = amzdate
    hdrs["x-amz-content-sha256"] = payload_hash
    # sign host + every x-amz-* header present (the SDK convention —
    # x-amz-copy-source etc. must be tamper-proof)
    signed = sorted({"host"} |
                    {k for k in hdrs if k.startswith("x-amz-")})
    creq = canonical_request(method, path, query, hdrs, signed,
                             payload_hash)
    sts = string_to_sign(amzdate, datestamp, creq)
    sig = hmac.new(signing_key(secret, datestamp), sts.encode(),
                   hashlib.sha256).hexdigest()
    scope = f"{datestamp}/{REGION}/{SERVICE}/aws4_request"
    return {
        "x-amz-date": amzdate,
        "x-amz-content-sha256": payload_hash,
        "Authorization": (
            f"{ALGO} Credential={access_key}/{scope}, "
            f"SignedHeaders={';'.join(signed)}, Signature={sig}"),
    }


class SigError(Exception):
    pass


# -- query-string (presigned URL) auth ---------------------------------------
#
# Reference: rgw_auth_s3.cc query-string SigV4 (X-Amz-Signature & co in
# the query instead of an Authorization header; payload is always
# UNSIGNED-PAYLOAD; expiry carried in X-Amz-Expires relative to
# X-Amz-Date, capped at 7 days like AWS).

MAX_PRESIGN_EXPIRES = 7 * 24 * 3600


def presign_url(method: str, path: str, access_key: str, secret: str,
                expires: int, host: str = "", query: str = "",
                now: datetime.datetime | None = None) -> str:
    """Client side: returns the full query string (existing `query`
    params + the X-Amz-* auth params) for a presigned request."""
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amzdate = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    scope = f"{datestamp}/{REGION}/{SERVICE}/aws4_request"
    params = urllib.parse.parse_qsl(query, keep_blank_values=True)
    params += [
        ("X-Amz-Algorithm", ALGO),
        ("X-Amz-Credential", f"{access_key}/{scope}"),
        ("X-Amz-Date", amzdate),
        ("X-Amz-Expires", str(expires)),
        ("X-Amz-SignedHeaders", "host"),
    ]
    qs = urllib.parse.urlencode(params)
    creq = canonical_request(method, path, qs, {"host": host},
                             ["host"], "UNSIGNED-PAYLOAD")
    sts = string_to_sign(amzdate, datestamp, creq)
    sig = hmac.new(signing_key(secret, datestamp), sts.encode(),
                   hashlib.sha256).hexdigest()
    return qs + "&X-Amz-Signature=" + sig


def is_presigned(query: str) -> bool:
    q = dict(urllib.parse.parse_qsl(query, keep_blank_values=True))
    return "X-Amz-Signature" in q and \
        q.get("X-Amz-Algorithm", ALGO) == ALGO


def verify_presigned(method: str, path: str, query: str, headers: dict,
                     creds: dict[str, str],
                     now: datetime.datetime | None = None) -> dict:
    """Server side: validates query-string SigV4; returns
    {"access_key": ...}.  Raises SigError on bad signature, unknown
    key, malformed params, or an expired/overlong window."""
    params = urllib.parse.parse_qsl(query, keep_blank_values=True)
    q = dict(params)
    if q.get("X-Amz-Algorithm") != ALGO:
        raise SigError("X-Amz-Algorithm must be " + ALGO)
    try:
        access_key, datestamp, region, service, _ = \
            q["X-Amz-Credential"].split("/")
        amzdate = q["X-Amz-Date"]
        expires = int(q["X-Amz-Expires"])
        signed = q["X-Amz-SignedHeaders"].split(";")
        got_sig = q["X-Amz-Signature"]
    except (KeyError, ValueError) as e:
        raise SigError(f"malformed presigned query: {e}") from e
    secret = creds.get(access_key)
    if secret is None:
        raise SigError(f"unknown access key {access_key!r}")
    if not 0 < expires <= MAX_PRESIGN_EXPIRES:
        raise SigError("X-Amz-Expires out of range")
    try:
        ts = datetime.datetime.strptime(
            amzdate, "%Y%m%dT%H%M%SZ").replace(
            tzinfo=datetime.timezone.utc)
    except ValueError as e:
        raise SigError(f"bad X-Amz-Date: {e}") from e
    if not amzdate.startswith(datestamp):
        raise SigError("X-Amz-Date does not match credential scope")
    now = now or datetime.datetime.now(datetime.timezone.utc)
    if now < ts - datetime.timedelta(seconds=900):
        raise SigError("presigned URL not yet valid")
    if now > ts + datetime.timedelta(seconds=expires):
        raise SigError("presigned URL expired")
    # canonical query = every param except the signature itself
    qs = urllib.parse.urlencode(
        [(k, v) for k, v in params if k != "X-Amz-Signature"])
    hdrs = {k.lower(): v for k, v in headers.items()}
    creq = canonical_request(method, path, qs, hdrs, signed,
                             "UNSIGNED-PAYLOAD")
    sts = string_to_sign(amzdate, datestamp, creq)
    want = hmac.new(signing_key(secret, datestamp), sts.encode(),
                    hashlib.sha256).hexdigest()
    if not hmac.compare_digest(got_sig, want):
        raise SigError("presigned signature mismatch")
    return {"access_key": access_key, "streaming": False}


# -- aws-chunked streaming payloads ------------------------------------------

def _chunk_sts(amzdate: str, datestamp: str, prev_sig: str,
               data: bytes) -> str:
    scope = f"{datestamp}/{REGION}/{SERVICE}/aws4_request"
    return "\n".join([
        f"{ALGO}-PAYLOAD", amzdate, scope, prev_sig,
        _sha256(b""), _sha256(data)])


def sign_chunk(secret: str, amzdate: str, datestamp: str,
               prev_sig: str, data: bytes) -> str:
    return hmac.new(signing_key(secret, datestamp),
                    _chunk_sts(amzdate, datestamp, prev_sig,
                               data).encode(),
                    hashlib.sha256).hexdigest()


def encode_streaming_body(payload: bytes, secret: str, amzdate: str,
                          datestamp: str, seed_sig: str,
                          chunk_size: int = 64 * 1024) -> bytes:
    """Client side: wrap a payload in aws-chunked framing with a
    signature chain seeded by the request signature."""
    out = bytearray()
    prev = seed_sig
    offs = list(range(0, len(payload), chunk_size)) or [0]
    for off in offs:
        data = payload[off:off + chunk_size]
        sig = sign_chunk(secret, amzdate, datestamp, prev, data)
        out += (f"{len(data):x};chunk-signature={sig}\r\n").encode()
        out += data + b"\r\n"
        prev = sig
    final = sign_chunk(secret, amzdate, datestamp, prev, b"")
    out += (f"0;chunk-signature={final}\r\n\r\n").encode()
    return bytes(out)


def decode_streaming_body(body: bytes, secret: str, amzdate: str,
                          datestamp: str, seed_sig: str) -> bytes:
    """Server side: unwrap aws-chunked framing, verifying every chunk
    signature against the rolling chain (reference AWSv4ComplMulti).
    Raises SigError on any tamper or truncation."""
    out = bytearray()
    prev = seed_sig
    pos = 0
    saw_final = False
    while pos < len(body):
        nl = body.find(b"\r\n", pos)
        if nl < 0:
            raise SigError("truncated chunk header")
        header = body[pos:nl].decode(errors="replace")
        size_hex, _, sigpart = header.partition(";")
        if not sigpart.startswith("chunk-signature="):
            raise SigError("missing chunk-signature")
        got_sig = sigpart[len("chunk-signature="):]
        try:
            size = int(size_hex, 16)
        except ValueError as e:
            raise SigError(f"bad chunk size {size_hex!r}") from e
        data = body[nl + 2:nl + 2 + size]
        if len(data) != size:
            raise SigError("truncated chunk data")
        want = sign_chunk(secret, amzdate, datestamp, prev, data)
        if not hmac.compare_digest(got_sig, want):
            raise SigError("chunk signature mismatch")
        prev = got_sig
        out += data
        pos = nl + 2 + size + 2      # skip trailing \r\n
        if size == 0:
            saw_final = True
            break
    if not saw_final:
        raise SigError("missing final zero-length chunk")
    return bytes(out)


def verify_request(method: str, path: str, query: str, headers: dict,
                   payload: bytes, creds: dict[str, str]) -> dict:
    """Server side: validates the Authorization header against `creds`
    (access_key -> secret); returns the auth context — access_key plus,
    for STREAMING-AWS4-HMAC-SHA256-PAYLOAD requests, what
    decode_streaming_body needs (streaming=True, secret, amzdate,
    datestamp, seed_sig)."""
    hdrs = {k.lower(): v for k, v in headers.items()}
    auth = hdrs.get("authorization", "")
    if not auth.startswith(ALGO):
        raise SigError("missing or non-SigV4 Authorization header")
    try:
        parts = dict(
            p.strip().split("=", 1)
            for p in auth[len(ALGO):].strip().split(","))
        access_key, datestamp, region, service, _ = \
            parts["Credential"].split("/")
        signed = parts["SignedHeaders"].split(";")
        got_sig = parts["Signature"]
    except (KeyError, ValueError) as e:
        raise SigError(f"malformed Authorization header: {e}") from e
    secret = creds.get(access_key)
    if secret is None:
        raise SigError(f"unknown access key {access_key!r}")
    # every x-amz-* header present must be signed (AWS SigV4 rule) —
    # otherwise an injected unsigned header (e.g. x-amz-copy-source)
    # changes gateway behavior while the signature still verifies
    signed_set = set(signed)
    for h in hdrs:
        if h.startswith("x-amz-") and h not in signed_set:
            raise SigError(f"header {h} present but not signed")
    amzdate = hdrs.get("x-amz-date", "")
    # freshness: a captured signed request must not replay forever
    # (reference rgw_auth_s3 enforces a 15-minute skew window)
    try:
        ts = datetime.datetime.strptime(
            amzdate, "%Y%m%dT%H%M%SZ").replace(
            tzinfo=datetime.timezone.utc)
    except ValueError as e:
        raise SigError(f"bad x-amz-date: {e}") from e
    now = datetime.datetime.now(datetime.timezone.utc)
    if abs((now - ts).total_seconds()) > 900:
        raise SigError("request outside the 15-minute skew window")
    if not amzdate.startswith(datestamp):
        raise SigError("x-amz-date does not match credential scope date")
    payload_hash = hdrs.get("x-amz-content-sha256", "UNSIGNED-PAYLOAD")
    if payload_hash not in ("UNSIGNED-PAYLOAD", STREAMING_PAYLOAD) and \
            payload_hash != _sha256(payload):
        raise SigError("payload hash mismatch")
    creq = canonical_request(method, path, query, hdrs, signed,
                             payload_hash)
    sts = string_to_sign(amzdate, datestamp, creq)
    want = hmac.new(signing_key(secret, datestamp), sts.encode(),
                    hashlib.sha256).hexdigest()
    if not hmac.compare_digest(got_sig, want):
        raise SigError("signature mismatch")
    return {"access_key": access_key,
            "streaming": payload_hash == STREAMING_PAYLOAD,
            "secret": secret, "amzdate": amzdate,
            "datestamp": datestamp, "seed_sig": got_sig}
