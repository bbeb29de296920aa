"""Swift REST dialect over the same RGWStore (reference rgw_rest_swift
— the reference gateway speaks both S3 and Swift against one RADOS
layout; so does this one: objects PUT via S3 are readable via Swift
and vice versa).

Surface (the OpenStack object-storage subset a Swift client needs),
mounted under the reference's default /swift prefix so Swift never
shadows an S3 bucket named 'v1' (rgw_swift_url_prefix):

  GET  /auth/v1.0                        X-Auth-User/X-Auth-Key ->
                                         X-Auth-Token + X-Storage-Url
  GET  /swift/v1/AUTH_<acct>             account: list containers
  PUT  /swift/v1/AUTH_<acct>/<c>         create container
  DELETE /swift/v1/AUTH_<acct>/<c>       delete container (409 if full)
  GET  /swift/v1/AUTH_<acct>/<c>         list objects (marker/prefix/
                                         delimiter/limit; plain or JSON)
  PUT  /swift/v1/AUTH_<acct>/<c>/<obj>   upload (ETag = md5)
  GET  /swift/v1/AUTH_<acct>/<c>/<obj>   download
  HEAD /swift/v1/AUTH_<acct>/<c>/<obj>   metadata
  DELETE /swift/v1/AUTH_<acct>/<c>/<obj> delete

Tokens are HMACs over the account + a daily window (stateless, like
the reference's tempauth role); Keystone integration is out of scope.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import time

from .store import RGWError


def _token(secret: str, user: str, window: int) -> str:
    return hmac.new(secret.encode(), f"{user}:{window}".encode(),
                    hashlib.sha256).hexdigest()


class SwiftFrontend:
    """Routes /auth and /v1 paths; mounted by the S3 gateway's HTTP
    handler so both dialects share one listener and one store."""

    def __init__(self, store, creds: dict[str, str] | None):
        self.store = store
        self.creds = creds          # user -> key; None = open access

    # -- auth ---------------------------------------------------------------

    def _check_token(self, headers) -> str | None:
        """Returns the authenticated user (the bucket/object owner
        for writes), or None on an open-access frontend."""
        if self.creds is None:
            return None
        tok = headers.get("x-auth-token", "")
        window = int(time.time() // 86400)
        for user, key in self.creds.items():
            for w in (window, window - 1):   # tolerate day rollover
                if hmac.compare_digest(tok, _token(key, user, w)):
                    return user
        raise RGWError(401, "Unauthorized", "bad or missing token")

    def handle_auth(self, headers) -> tuple[int, dict, bytes]:
        user = headers.get("x-auth-user", "")
        key = headers.get("x-auth-key", "")
        if self.creds is None:
            return 200, {"X-Auth-Token": "anonymous",
                         "X-Storage-Url": "/swift/v1/AUTH_main"}, b""
        if not hmac.compare_digest(str(self.creds.get(user, "")), key):
            raise RGWError(401, "Unauthorized", "bad credentials")
        window = int(time.time() // 86400)
        return 200, {"X-Auth-Token": _token(key, user, window),
                     "X-Storage-Url": "/swift/v1/AUTH_main"}, b""

    # -- dispatch -----------------------------------------------------------

    def handle(self, method: str, path: str, query: dict,
               headers, body: bytes) -> tuple[int, dict, bytes]:
        """Returns (status, extra_headers, body)."""
        if path.startswith("/auth"):
            return self.handle_auth(headers)
        user = self._check_token(headers)
        parts = [p for p in path.split("/") if p]
        # /swift/v1/AUTH_x[/container[/object...]] — version and
        # account segments are validated, not just counted
        if len(parts) < 3 or parts[1] != "v1" or \
                not parts[2].startswith("AUTH_"):
            raise RGWError(404, "NotFound", path)
        rest = parts[3:]
        if not rest:
            return self._account(method, query, user)
        container = rest[0]
        if len(rest) == 1:
            return self._container(method, container, query, user)
        obj = "/".join(rest[1:])
        return self._object(method, container, obj, body, user)

    # -- account ------------------------------------------------------------

    def _account(self, method: str, query: dict,
                 user: str | None = None):
        if method != "GET":
            raise RGWError(405, "MethodNotAllowed", method)
        rows = [(n, m) for n, m in self.store.list_buckets()
                if self.creds is None or m.get("owner") is None or
                m.get("owner") == user]
        if query.get("format") == "json":
            out = json.dumps([{"name": n, "count": 0, "bytes": 0}
                              for n, _m in rows]).encode()
            return 200, {"Content-Type": "application/json"}, out
        return 200, {"Content-Type": "text/plain"}, \
            ("".join(f"{n}\n" for n, _m in rows)).encode()

    # -- containers ---------------------------------------------------------

    def _require_access(self, container: str, user: str | None,
                        perm: str) -> None:
        """Same owner/canned-ACL gate the S3 dialect enforces (ONE
        shared predicate, rgw/acl.py) — a Swift token must not become
        a side door into another account's private bucket.  Swift
        callers are always authenticated."""
        meta = self.store._bucket_meta(container)
        if meta is None:
            raise RGWError(404, "NotFound", container)
        if self.creds is None:
            return
        from .acl import canned_allows
        if not canned_allows(user, meta.get("owner"),
                             meta.get("acl", "private"), perm):
            raise RGWError(403, "Forbidden", container)

    def _container(self, method: str, container: str, query: dict,
                   user: str | None = None):
        st = self.store
        if method == "PUT":
            existing = st._bucket_meta(container)
            if existing is None:
                try:
                    st.create_bucket(container, owner=user)
                except RGWError as e:
                    if e.status != 409:
                        raise
            elif existing.get("owner") not in (None, user):
                # a different account owns this name: no hijack
                raise RGWError(409, "Conflict", container)
            return 201, {}, b""
        if method == "DELETE":
            self._require_access(container, user, "OWNER")
            st.delete_bucket(container)
            return 204, {}, b""
        if method == "HEAD":
            if not st.bucket_exists(container):
                raise RGWError(404, "NotFound", container)
            self._require_access(container, user, "READ")
            return 204, {}, b""
        if method == "GET":
            self._require_access(container, user, "READ")
            limit = int(query.get("limit", 10000))
            entries, cps, _trunc, _nm = st.list_objects(
                container, prefix=query.get("prefix", ""),
                marker=query.get("marker", ""), max_keys=limit,
                delimiter=query.get("delimiter", ""))
            if query.get("format") == "json":
                rows = [{"name": k, "bytes": m["size"],
                         "hash": m["etag"]} for k, m in entries]
                rows += [{"subdir": cp} for cp in cps]
                return 200, {"Content-Type": "application/json"}, \
                    json.dumps(rows).encode()
            names = [k for k, _ in entries] + list(cps)
            return 200, {"Content-Type": "text/plain"}, \
                ("".join(f"{n}\n" for n in sorted(names))).encode()
        raise RGWError(405, "MethodNotAllowed", method)

    # -- objects ------------------------------------------------------------

    def _object_readable(self, container: str, obj: str,
                         user: str | None, meta: dict) -> None:
        """Object-level gate mirroring the S3 dialect (same shared
        predicate): object owner, else the object's canned ACL
        (default private), with the bucket owner as fallback owner
        for ownerless objects."""
        if self.creds is None:
            return
        owner = meta.get("owner")
        if owner is None:
            bmeta = self.store._bucket_meta(container) or {}
            owner = bmeta.get("owner")
        from .acl import canned_allows
        if not canned_allows(user, owner, meta.get("acl", "private"),
                             "READ"):
            raise RGWError(403, "Forbidden", f"{container}/{obj}")

    def _object(self, method: str, container: str, obj: str,
                body: bytes, user: str | None = None):
        st = self.store
        if method == "PUT":
            self._require_access(container, user, "WRITE")
            etag = st.put_object(
                container, obj, body,
                extra={"owner": user} if user else None)
            return 201, {"ETag": etag}, b""
        if method == "GET":
            meta = st.head_object(container, obj)
            self._object_readable(container, obj, user, meta)
            data, meta = st.get_object(container, obj, meta=meta)
            return 200, {"ETag": meta["etag"],
                         "Content-Type": "application/octet-stream"}, \
                bytes(data)
        if method == "HEAD":
            meta = st.head_object(container, obj)
            self._object_readable(container, obj, user, meta)
            # real Content-Length (the resource's size, not the empty
            # response body) — the gateway's HTTP layer honors a
            # pre-set Content-Length instead of len(body)
            return 200, {"ETag": meta["etag"],
                         "Content-Length": str(meta["size"])}, b""
        if method == "DELETE":
            self._require_access(container, user, "WRITE")
            st.delete_object(container, obj)
            return 204, {}, b""
        raise RGWError(405, "MethodNotAllowed", method)
