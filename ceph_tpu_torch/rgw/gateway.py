"""S3 REST frontend (radosgw role).

Re-expresses the reference's civetweb/beast + rgw_rest_s3 stack
(src/rgw/rgw_rest_s3.cc op dispatch, rgw_op.cc:RGWListBucket/RGWPutObj/
RGWGetObj/RGWDeleteObj...) over Python's threading HTTP server: the
S3 dialect subset a librados-backed object store needs —

  GET  /                bucket listing (ListAllMyBucketsResult)
  PUT  /b               create bucket
  DELETE /b             delete bucket (409 BucketNotEmpty)
  GET  /b?list-type=2   ListBucketResult v2 (prefix/start-after/max-keys)
  PUT  /b/k             put object (ETag = md5)
  PUT  /b/k  + x-amz-copy-source
                        server-side CopyObject (CopyObjectResult)
  GET  /b/k             get object
  HEAD /b/k             object metadata
  DELETE /b/k           delete object
  POST /b/k?uploads     InitiateMultipartUpload (UploadId)
  PUT  /b/k?partNumber=N&uploadId=U   UploadPart (ETag)
  GET  /b/k?uploadId=U  ListParts
  POST /b/k?uploadId=U  CompleteMultipartUpload (XML part list body)
  DELETE /b/k?uploadId=U  AbortMultipartUpload
  GET  /b?uploads       ListMultipartUploads

Requests authenticate with AWS SigV4 (sigv4.py) unless the gateway is
constructed without credentials.
"""

from __future__ import annotations

import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from xml.sax.saxutils import escape

from . import sigv4
from .store import RGWError, RGWStore


def _xml_error(code: str, msg: str) -> bytes:
    return (f'<?xml version="1.0" encoding="UTF-8"?>'
            f"<Error><Code>{escape(code)}</Code>"
            f"<Message>{escape(msg)}</Message></Error>").encode()


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "ceph-tpu-rgw/1.0"

    # quiet request logging (the daemon's dout owns the log surface)
    def log_message(self, fmt, *args):  # noqa: A003
        pass

    @property
    def gw(self) -> "S3Gateway":
        return self.server.gateway

    # -- plumbing ------------------------------------------------------------

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(length) if length else b""

    def _reply(self, status: int, body: bytes = b"",
               content_type: str = "application/xml",
               extra: dict | None = None,
               content_length: str | None = None) -> None:
        """content_length overrides the header for HEAD replies that
        advertise the RESOURCE's size rather than the (empty) body's."""
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length",
                         content_length if content_length is not None
                         else str(len(body)))
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        if self.command != "HEAD" and body:
            self.wfile.write(body)

    def _fail(self, e: RGWError) -> None:
        self._reply(e.status, _xml_error(e.code, str(e)))

    def _route(self) -> None:
        parsed = urllib.parse.urlsplit(self.path)
        path = urllib.parse.unquote(parsed.path)
        if path == "/auth" or path.startswith("/auth/") or \
                path == "/swift" or path.startswith("/swift/"):
            # Swift dialect shares the listener and the store
            # (reference rgw_rest_swift.cc: one frontend stack, two
            # REST dialects, one RADOS layout).  Mounted under the
            # reference's default /swift prefix (+ the classic
            # /auth/v1.0 tempauth endpoint) so Swift never shadows an
            # S3 bucket named 'v1'.  Swift authenticates by token,
            # not SigV4.
            self._swift_route(parsed, path)
            return
        body = self._read_body()
        # identity: the verified access key, or None for anonymous
        # requests (no Authorization header).  Anonymous requests pass
        # routing and face the ACL checks — a BAD signature still
        # fails hard (reference rgw_auth_s3 -> verify_permission
        # split: authentication vs authorization).
        self._identity = None
        if self.gw.creds is not None and \
                self.headers.get("Authorization"):
            try:
                auth = sigv4.verify_request(
                    self.command, parsed.path, parsed.query,
                    dict(self.headers), body, self.gw.creds)
                self._identity = auth["access_key"]
                if auth["streaming"]:
                    # aws-chunked body: strip the framing after
                    # verifying each chunk's rolling signature
                    body = sigv4.decode_streaming_body(
                        body, auth["secret"], auth["amzdate"],
                        auth["datestamp"], auth["seed_sig"])
            except sigv4.SigError as e:
                self._reply(403, _xml_error("SignatureDoesNotMatch",
                                            str(e)))
                return
        elif self.gw.creds is not None and \
                sigv4.is_presigned(parsed.query):
            # query-string SigV4 (presigned URL): authentication via
            # X-Amz-* query params, UNSIGNED-PAYLOAD, expiry enforced
            # (reference rgw_auth_s3.cc query-string path).  A BAD
            # presigned request fails hard — it never downgrades to
            # anonymous.
            try:
                auth = sigv4.verify_presigned(
                    self.command, parsed.path, parsed.query,
                    dict(self.headers), self.gw.creds)
                self._identity = auth["access_key"]
            except sigv4.SigError as e:
                self._reply(403, _xml_error("AccessDenied", str(e)))
                return
        parts = path.lstrip("/").split("/", 1)
        bucket = parts[0]
        key = parts[1] if len(parts) > 1 else None
        query = dict(urllib.parse.parse_qsl(
            parsed.query, keep_blank_values=True))
        try:
            if not bucket:
                self._service_get()
            elif key is None or key == "":
                self._bucket_op(bucket, query, body)
            else:
                self._object_op(bucket, key, query, body)
        except RGWError as e:
            self._fail(e)
        except Exception as e:  # noqa: BLE001 - surface as 500
            self._reply(500, _xml_error("InternalError", repr(e)))

    def _swift_route(self, parsed, path: str) -> None:
        body = self._read_body()
        query = dict(urllib.parse.parse_qsl(
            parsed.query, keep_blank_values=True))
        try:
            status, extra, out = self.gw.swift.handle(
                self.command, path, query, self.headers, body)
        except RGWError as e:
            self._reply(e.status, f"{e.code}: {e}".encode(),
                        "text/plain")
            return
        except Exception as e:  # noqa: BLE001 - surface as 500
            self._reply(500, repr(e).encode(), "text/plain")
            return
        extra = dict(extra)
        ctype = extra.pop("Content-Type", "text/plain")
        # HEAD carries the RESOURCE's length, pre-set by the frontend
        clen = extra.pop("Content-Length", None)
        self._reply(status, out, ctype, extra, content_length=clen)

    do_GET = do_PUT = do_DELETE = do_HEAD = do_POST = _route

    # -- ACLs (reference rgw_acl.h canned ACLs, enforced like
    #    rgw_op.cc verify_permission; decision shared with the Swift
    #    dialect via rgw/acl.py) -------------------------------------------

    from .acl import CANNED_ACLS  # noqa: F401 (class-level re-export)

    def _acl_allows(self, owner, canned: str, perm: str) -> bool:
        if self.gw.creds is None:
            return True                       # open gateway: no ACLs
        from .acl import canned_allows
        return canned_allows(self._identity, owner, canned, perm)

    def _bucket_acl(self, bucket: str) -> tuple:
        meta = self.gw.store._bucket_meta(bucket)
        if meta is None:
            raise RGWError(404, "NoSuchBucket", bucket)
        return meta.get("owner"), meta.get("acl", "private")

    def _bucket_meta_or_404(self, bucket: str) -> dict:
        """ONE bucket-index round-trip per authz decision (store.py
        _bucket_meta's own contract) — policy and ACL both read from
        the returned meta."""
        meta = self.gw.store._bucket_meta(bucket)
        if meta is None:
            raise RGWError(404, "NoSuchBucket", bucket)
        return meta

    def _policy_eval(self, bmeta: dict, bucket: str, action: str,
                     key: str | None = None) -> str | None:
        """Bucket-policy decision for this request's identity, or None
        when the bucket has no policy (reference rgw_iam_policy.cc
        eval_principal/eval_statements)."""
        pol = bmeta.get("policy")
        if not pol:
            return None
        from .policy import bucket_arn, evaluate, object_arn
        arn = object_arn(bucket, key) if key is not None \
            else bucket_arn(bucket)
        return evaluate(pol, self._identity, action, arn)

    # default policy action per canned-ACL permission bit
    _PERM_ACTION = {"READ": "s3:GetObject", "WRITE": "s3:PutObject",
                    "READ_ACP": "s3:GetObjectAcl",
                    "WRITE_ACP": "s3:PutObjectAcl"}

    def _require_bucket_perm(self, bucket: str, perm: str,
                             action: str | None = None,
                             key: str | None = None) -> None:
        """AWS combination: explicit policy Deny always wins, policy
        Allow grants without consulting the ACL, otherwise the canned
        ACL decides."""
        bmeta = self._bucket_meta_or_404(bucket)
        decision = self._policy_eval(
            bmeta, bucket, action or
            ("s3:ListBucket" if perm == "READ" else "s3:PutObject"),
            key)
        if decision == "Deny":
            raise RGWError(403, "AccessDenied", bucket)
        if decision == "Allow":
            return
        if not self._acl_allows(bmeta.get("owner"),
                                bmeta.get("acl", "private"), perm):
            raise RGWError(403, "AccessDenied", bucket)

    def _require_bucket_owner(self, bucket: str) -> None:
        owner, _ = self._bucket_acl(bucket)
        if self.gw.creds is not None and not (
                self._identity is not None and
                (owner is None or self._identity == owner)):
            raise RGWError(403, "AccessDenied", bucket)

    def _require_object_perm(self, bucket: str, key: str,
                             meta: dict, perm: str,
                             action: str | None = None) -> dict:
        """Object ACL governs the object (S3: a public-read BUCKET
        does not expose its objects; each object carries its own
        canned ACL, default private to its owner).  Bucket policy is
        consulted first, the AWS way (Deny final, Allow grants)."""
        bmeta = self._bucket_meta_or_404(bucket)
        decision = self._policy_eval(
            bmeta, bucket, action or self._PERM_ACTION[perm], key)
        if decision == "Deny":
            raise RGWError(403, "AccessDenied", f"{bucket}/{key}")
        if decision == "Allow":
            return bmeta
        owner = meta.get("owner")
        if owner is None:                     # legacy/ownerless object
            owner = bmeta.get("owner")
        if not self._acl_allows(owner, meta.get("acl", "private"),
                                perm):
            raise RGWError(403, "AccessDenied", f"{bucket}/{key}")
        return bmeta

    def _requested_acl(self) -> str:
        acl = self.headers.get("x-amz-acl", "") or "private"
        if acl not in self.CANNED_ACLS:
            raise RGWError(400, "InvalidArgument",
                           f"unsupported canned ACL {acl!r}")
        return acl

    def _acl_xml(self, owner, canned: str) -> bytes:
        grants = {"private": ["owner:FULL_CONTROL"],
                  "public-read": ["owner:FULL_CONTROL", "AllUsers:READ"],
                  "public-read-write": ["owner:FULL_CONTROL",
                                        "AllUsers:READ", "AllUsers:WRITE"],
                  "authenticated-read": ["owner:FULL_CONTROL",
                                         "AuthenticatedUsers:READ"]}
        rows = "".join(
            f"<Grant><Grantee>{escape(g.split(':')[0])}</Grantee>"
            f"<Permission>{g.split(':')[1]}</Permission></Grant>"
            for g in grants[canned])
        return (
            '<?xml version="1.0" encoding="UTF-8"?>'
            "<AccessControlPolicy>"
            f"<Owner><ID>{escape(owner or '')}</ID></Owner>"
            f"<AccessControlList>{rows}</AccessControlList>"
            "</AccessControlPolicy>").encode()

    # -- service -------------------------------------------------------------

    def _service_get(self) -> None:
        if self.command != "GET":
            self._reply(405, _xml_error("MethodNotAllowed", self.command))
            return
        if self.gw.creds is not None and self._identity is None:
            # S3 has no anonymous ListBuckets
            self._reply(403, _xml_error("AccessDenied", "anonymous"))
            return
        rows = "".join(
            f"<Bucket><Name>{escape(b)}</Name></Bucket>"
            for b, m in self.gw.store.list_buckets()
            if self.gw.creds is None or m.get("owner") is None or
            m.get("owner") == self._identity)
        self._reply(200, (
            '<?xml version="1.0" encoding="UTF-8"?>'
            "<ListAllMyBucketsResult>"
            f"<Buckets>{rows}</Buckets>"
            "</ListAllMyBucketsResult>").encode())

    # -- buckets -------------------------------------------------------------

    def _bucket_op(self, bucket: str, query: dict, body: bytes) -> None:
        st = self.gw.store
        if self.command == "PUT" and "policy" in query:
            self._require_bucket_owner(bucket)
            from .policy import PolicyError, validate_policy
            try:
                doc = validate_policy(body)
            except PolicyError as e:
                raise RGWError(400, "MalformedPolicy", str(e)) from e
            st.set_bucket_policy(bucket, doc)
            self._reply(204)
        elif self.command == "GET" and "policy" in query:
            self._require_bucket_owner(bucket)
            pol = st.get_bucket_policy(bucket)
            if pol is None:
                raise RGWError(404, "NoSuchBucketPolicy", bucket)
            import json as _json
            self._reply(200, _json.dumps(pol).encode(),
                        "application/json")
        elif self.command == "DELETE" and "policy" in query:
            self._require_bucket_owner(bucket)
            st.set_bucket_policy(bucket, None)
            self._reply(204)
        elif self.command == "PUT" and "lifecycle" in query:
            self._require_bucket_owner(bucket)
            st.set_lifecycle(bucket, _parse_lifecycle_body(body))
            self._reply(200)
        elif self.command == "GET" and "lifecycle" in query:
            self._require_bucket_owner(bucket)
            rules = st.get_lifecycle(bucket)
            if not rules:
                raise RGWError(404, "NoSuchLifecycleConfiguration",
                               bucket)
            self._reply(200, _lifecycle_xml(rules))
        elif self.command == "DELETE" and "lifecycle" in query:
            self._require_bucket_owner(bucket)
            st.delete_lifecycle(bucket)
            self._reply(204)
        elif self.command == "PUT" and "acl" in query:
            self._require_bucket_owner(bucket)
            st.set_bucket_acl(bucket, self._requested_acl())
            self._reply(200)
        elif self.command == "GET" and "acl" in query:
            self._require_bucket_owner(bucket)
            owner, canned = self._bucket_acl(bucket)
            self._reply(200, self._acl_xml(owner, canned))
        elif self.command == "PUT" and "versioning" in query:
            self._require_bucket_owner(bucket)
            import xml.etree.ElementTree as ET
            try:
                root = ET.fromstring(body.decode())
                status = next(
                    (c.text for c in root.iter()
                     if c.tag.rpartition("}")[2] == "Status"), "")
            except Exception as e:  # noqa: BLE001
                raise RGWError(400, "MalformedXML", str(e)) from e
            st.set_versioning(bucket, status or "")
            self._reply(200)
        elif self.command == "GET" and "versioning" in query:
            self._require_bucket_owner(bucket)
            status = st.get_versioning(bucket)
            inner = f"<Status>{status}</Status>" if status else ""
            self._reply(200, (
                '<?xml version="1.0" encoding="UTF-8"?>'
                f"<VersioningConfiguration>{inner}"
                "</VersioningConfiguration>").encode())
        elif self.command == "GET" and "versions" in query:
            self._require_bucket_owner(bucket)
            rows = st.list_versions(bucket, query.get("prefix", ""))
            parts = []
            for r in rows:
                tag = "DeleteMarker" if r.get("delete_marker") \
                    else "Version"
                etag = (f"<ETag>&quot;{r['etag']}&quot;</ETag>"
                        if not r.get("delete_marker") else "")
                parts.append(
                    f"<{tag}><Key>{escape(r['key'])}</Key>"
                    f"<VersionId>{r['version_id']}</VersionId>"
                    f"<IsLatest>"
                    f"{'true' if r['is_latest'] else 'false'}"
                    f"</IsLatest><Size>{r.get('size', 0)}</Size>"
                    f"{etag}</{tag}>")
            self._reply(200, (
                '<?xml version="1.0" encoding="UTF-8"?>'
                "<ListVersionsResult>"
                f"<Name>{escape(bucket)}</Name>"
                f"{''.join(parts)}</ListVersionsResult>").encode())
        elif self.command == "PUT":
            if self.gw.creds is not None and self._identity is None:
                raise RGWError(403, "AccessDenied",
                               "anonymous bucket creation")
            existing = st._bucket_meta(bucket)
            if existing is not None:
                eo = existing.get("owner")
                if self.gw.creds is not None and eo is not None and \
                        eo != self._identity:
                    raise RGWError(409, "BucketAlreadyExists", bucket)
                self._reply(200)    # idempotent re-create by owner:
                return              # keep versioning/acl meta intact
            shards = self.headers.get("x-rgw-index-shards")
            st.create_bucket(bucket, owner=self._identity,
                             acl=self._requested_acl(),
                             shards=int(shards) if shards else None)
            self._reply(200)
        elif self.command == "DELETE":
            self._require_bucket_owner(bucket)
            st.delete_bucket(bucket)
            self._reply(204)
        elif self.command in ("GET", "HEAD"):
            if self.command == "HEAD":
                if not st.bucket_exists(bucket):
                    self._reply(404, _xml_error("NoSuchBucket", bucket))
                    return
                self._require_bucket_perm(bucket, "READ")
                self._reply(200)
                return
            self._require_bucket_perm(bucket, "READ")
            if "uploads" in query:
                rows = "".join(
                    "<Upload>"
                    f"<Key>{escape(k)}</Key>"
                    f"<UploadId>{escape(uid)}</UploadId>"
                    "</Upload>"
                    for k, uid, _m in st.list_multipart_uploads(bucket))
                self._reply(200, (
                    '<?xml version="1.0" encoding="UTF-8"?>'
                    "<ListMultipartUploadsResult>"
                    f"<Bucket>{escape(bucket)}</Bucket>{rows}"
                    "</ListMultipartUploadsResult>").encode())
                return
            prefix = query.get("prefix", "")
            # S3 semantics: ContinuationToken (inclusive resume point
            # we minted, OPAQUE base64 — raw resume strings can carry
            # bytes like NUL that are illegal in XML) wins over
            # StartAfter (client's exclusive key)
            import base64
            marker = query.get("start-after", "")
            resume = ""
            tok = query.get("continuation-token", "")
            if tok:
                try:
                    resume = base64.urlsafe_b64decode(
                        tok.encode()).decode()
                except Exception as e:  # noqa: BLE001
                    raise RGWError(400, "InvalidArgument",
                                   "bad continuation-token") from e
            max_keys = int(query.get("max-keys", 1000))
            delimiter = query.get("delimiter", "")
            entries, cps, truncated, next_marker = st.list_objects(
                bucket, prefix, marker, max_keys, delimiter, resume)
            rows = "".join(
                "<Contents>"
                f"<Key>{escape(k)}</Key>"
                f"<Size>{m['size']}</Size>"
                f"<ETag>&quot;{m['etag']}&quot;</ETag>"
                "</Contents>" for k, m in entries)
            rows += "".join(
                f"<CommonPrefixes><Prefix>{escape(cp)}</Prefix>"
                f"</CommonPrefixes>" for cp in cps)
            tok_out = base64.urlsafe_b64encode(
                next_marker.encode()).decode() if next_marker else ""
            nct = (f"<NextContinuationToken>{tok_out}"
                   f"</NextContinuationToken>"
                   if truncated and tok_out else "")
            self._reply(200, (
                '<?xml version="1.0" encoding="UTF-8"?>'
                "<ListBucketResult>"
                f"<Name>{escape(bucket)}</Name>"
                f"<Prefix>{escape(prefix)}</Prefix>"
                f"<KeyCount>{len(entries) + len(cps)}</KeyCount>"
                f"<IsTruncated>{'true' if truncated else 'false'}"
                f"</IsTruncated>{nct}{rows}"
                "</ListBucketResult>").encode())
        else:
            self._reply(405, _xml_error("MethodNotAllowed", self.command))

    # -- objects -------------------------------------------------------------

    def _object_op(self, bucket: str, key: str, query: dict,
                   body: bytes) -> None:
        st = self.gw.store
        # the owner/acl stamp every write path records on the object
        def _stamp():
            ex = {}
            if self._identity is not None:
                ex["owner"] = self._identity
            acl = self._requested_acl()
            if acl != "private":
                ex["acl"] = acl
            return ex
        if self.command == "PUT" and "acl" in query:
            meta = st.head_object(bucket, key)
            self._require_object_perm(bucket, key, meta, "WRITE_ACP")
            st.set_object_acl(bucket, key, self._requested_acl())
            self._reply(200)
        elif self.command == "GET" and "acl" in query:
            meta = st.head_object(bucket, key)
            bmeta = self._require_object_perm(bucket, key, meta,
                                              "READ_ACP")
            self._reply(200, self._acl_xml(
                meta.get("owner") or bmeta.get("owner"),
                meta.get("acl", "private")))
        elif self.command == "PUT" and "partNumber" in query:
            self._require_bucket_perm(bucket, "WRITE",
                                      action="s3:PutObject", key=key)
            try:
                part_num = int(query["partNumber"])
            except ValueError:
                raise RGWError(400, "InvalidArgument",
                               f"partNumber {query['partNumber']!r}")
            etag = st.upload_part(bucket, key, query.get("uploadId", ""),
                                  part_num, body)
            self._reply(200, extra={"ETag": f'"{etag}"'})
        elif self.command == "PUT" and \
                self.headers.get("x-amz-copy-source"):
            self._require_bucket_perm(bucket, "WRITE",
                                      action="s3:PutObject", key=key)
            src = urllib.parse.unquote(
                self.headers["x-amz-copy-source"]).lstrip("/")
            src_bucket, _, src_key = src.partition("/")
            if not src_key:
                raise RGWError(400, "InvalidArgument",
                               "x-amz-copy-source must be /bucket/key")
            src_meta = st.head_object(src_bucket, src_key)
            self._require_object_perm(src_bucket, src_key, src_meta,
                                      "READ")
            out = st.copy_object(src_bucket, src_key, bucket, key,
                                 extra=_stamp())
            import datetime
            lm = datetime.datetime.fromtimestamp(
                out["mtime"], datetime.timezone.utc).strftime(
                "%Y-%m-%dT%H:%M:%S.000Z")
            self._reply(200, (
                '<?xml version="1.0" encoding="UTF-8"?>'
                "<CopyObjectResult>"
                f"<ETag>&quot;{out['etag']}&quot;</ETag>"
                f"<LastModified>{lm}</LastModified>"
                "</CopyObjectResult>").encode())
        elif self.command == "PUT":
            self._require_bucket_perm(bucket, "WRITE",
                                      action="s3:PutObject", key=key)
            etag = st.put_object(bucket, key, body, extra=_stamp())
            self._reply(200, extra={"ETag": f'"{etag}"'})
        elif self.command == "POST" and "uploads" in query:
            self._require_bucket_perm(bucket, "WRITE",
                                      action="s3:PutObject", key=key)
            upload_id = st.init_multipart(bucket, key)
            self._reply(200, (
                '<?xml version="1.0" encoding="UTF-8"?>'
                "<InitiateMultipartUploadResult>"
                f"<Bucket>{escape(bucket)}</Bucket>"
                f"<Key>{escape(key)}</Key>"
                f"<UploadId>{upload_id}</UploadId>"
                "</InitiateMultipartUploadResult>").encode())
        elif self.command == "POST" and "uploadId" in query:
            self._require_bucket_perm(bucket, "WRITE",
                                      action="s3:PutObject", key=key)
            parts = _parse_complete_body(body)
            etag = st.complete_multipart(bucket, key, query["uploadId"],
                                         parts, extra=_stamp())
            self._reply(200, (
                '<?xml version="1.0" encoding="UTF-8"?>'
                "<CompleteMultipartUploadResult>"
                f"<Bucket>{escape(bucket)}</Bucket>"
                f"<Key>{escape(key)}</Key>"
                f"<ETag>&quot;{etag}&quot;</ETag>"
                "</CompleteMultipartUploadResult>").encode())
        elif self.command == "GET" and "uploadId" in query:
            self._require_bucket_perm(
                bucket, "WRITE",
                action="s3:ListMultipartUploadParts", key=key)
            rows = "".join(
                "<Part>"
                f"<PartNumber>{num}</PartNumber>"
                f"<ETag>&quot;{m['etag']}&quot;</ETag>"
                f"<Size>{m['size']}</Size>"
                "</Part>"
                for num, m in st.list_parts(bucket, key,
                                            query["uploadId"]))
            self._reply(200, (
                '<?xml version="1.0" encoding="UTF-8"?>'
                "<ListPartsResult>"
                f"<Bucket>{escape(bucket)}</Bucket>"
                f"<Key>{escape(key)}</Key>"
                f"<UploadId>{query['uploadId']}</UploadId>{rows}"
                "</ListPartsResult>").encode())
        elif self.command == "GET" and "versionId" in query:
            # ACL check on the META before paying the data read —
            # denied requests must not drive full object reads
            vmeta = st._version_row(bucket, key, query["versionId"])
            if vmeta is not None:
                self._require_object_perm(bucket, key, vmeta, "READ")
            data, meta = st.get_object_version(bucket, key,
                                               query["versionId"])
            self._reply(200, data, "application/octet-stream",
                        {"ETag": f'"{meta["etag"]}"',
                         "x-amz-version-id": meta["version_id"]})
        elif self.command == "GET":
            meta = st.head_object(bucket, key)
            self._require_object_perm(bucket, key, meta, "READ")
            data, meta = st.get_object(bucket, key, meta=meta)
            extra = {"ETag": f'"{meta["etag"]}"'}
            if meta.get("version_id"):
                extra["x-amz-version-id"] = meta["version_id"]
            self._reply(200, data, "application/octet-stream", extra)
        elif self.command == "HEAD":
            meta = st.head_object(bucket, key)
            self._require_object_perm(bucket, key, meta, "READ")
            self._reply(200, content_length=str(meta["size"]),
                        extra={"ETag": f'"{meta["etag"]}"'})
        elif self.command == "DELETE" and "uploadId" in query:
            self._require_bucket_perm(
                bucket, "WRITE", action="s3:AbortMultipartUpload",
                key=key)
            st.abort_multipart(bucket, key, query["uploadId"])
            self._reply(204)
        elif self.command == "DELETE" and "versionId" in query:
            self._require_bucket_owner(bucket)   # permanent destroy
            st.delete_object_version(bucket, key, query["versionId"])
            self._reply(204)
        elif self.command == "DELETE":
            self._require_bucket_perm(bucket, "WRITE",
                                      action="s3:DeleteObject", key=key)
            st.delete_object(bucket, key)
            self._reply(204)
        else:
            self._reply(405, _xml_error("MethodNotAllowed", self.command))


def _parse_lifecycle_body(body: bytes) -> list[dict]:
    """LifecycleConfiguration XML -> rule dicts (reference rgw_lc
    grammar subset: Expiration/Days, ExpiredObjectDeleteMarker,
    AbortIncompleteMultipartUpload/DaysAfterInitiation)."""
    import xml.etree.ElementTree as ET
    try:
        root = ET.fromstring(body.decode())
    except Exception as e:  # noqa: BLE001
        raise RGWError(400, "MalformedXML", str(e)) from e

    def tag(el):
        return el.tag.rpartition("}")[2]

    def pos_int(txt, what):
        try:
            v = int(txt)
        except ValueError as e:
            raise RGWError(400, "MalformedXML",
                           f"{what} {txt!r}") from e
        if v < 1:       # S3: must be a positive integer — a zero or
            # negative value would make the sweep delete everything
            raise RGWError(400, "InvalidArgument",
                           f"{what} must be a positive integer")
        return v

    rules = []
    for el in root.iter():
        if tag(el) != "Rule":
            continue
        rule: dict = {"prefix": ""}
        status = "Enabled"
        # STRUCTURE-aware walk (direct children only): a Transition
        # rule also carries <Days>, and flat tag-matching would misread
        # it as Expiration days — turning a move-to-GLACIER request
        # into deletion
        for child in el:
            t = tag(child)
            txt = (child.text or "").strip()
            if t == "ID":
                rule["id"] = txt
            elif t == "Prefix":
                rule["prefix"] = txt
            elif t == "Filter":
                for f in child:
                    if tag(f) == "Prefix":
                        rule["prefix"] = (f.text or "").strip()
            elif t == "Status":
                status = txt
            elif t == "Expiration":
                for e in child:
                    if tag(e) == "Days":
                        rule["days"] = pos_int(
                            (e.text or "").strip(), "Days")
                    elif tag(e) == "ExpiredObjectDeleteMarker":
                        rule["expired_obj_delete_marker"] = \
                            (e.text or "").strip() == "true"
            elif t == "AbortIncompleteMultipartUpload":
                for e in child:
                    if tag(e) == "DaysAfterInitiation":
                        rule["abort_mpu_days"] = pos_int(
                            (e.text or "").strip(),
                            "DaysAfterInitiation")
            elif t in ("Transition", "NoncurrentVersionTransition"):
                raise RGWError(501, "NotImplemented",
                               f"{t} (no storage classes)")
        if status == "Enabled":
            rules.append(rule)
    if not rules:
        raise RGWError(400, "MalformedXML", "no enabled Rule")
    return rules


def _lifecycle_xml(rules: list[dict]) -> bytes:
    parts = []
    for r in rules:
        body = f"<ID>{escape(r.get('id', ''))}</ID>" \
               f"<Prefix>{escape(r.get('prefix', ''))}</Prefix>" \
               "<Status>Enabled</Status>"
        exp = ""
        if r.get("days"):
            exp += f"<Days>{r['days']}</Days>"
        if r.get("expired_obj_delete_marker"):
            exp += ("<ExpiredObjectDeleteMarker>true"
                    "</ExpiredObjectDeleteMarker>")
        if exp:     # ONE Expiration element (S3 schema)
            body += f"<Expiration>{exp}</Expiration>"
        if r.get("abort_mpu_days"):
            body += ("<AbortIncompleteMultipartUpload>"
                     f"<DaysAfterInitiation>{r['abort_mpu_days']}"
                     "</DaysAfterInitiation>"
                     "</AbortIncompleteMultipartUpload>")
        parts.append(f"<Rule>{body}</Rule>")
    return ('<?xml version="1.0" encoding="UTF-8"?>'
            "<LifecycleConfiguration>"
            f"{''.join(parts)}</LifecycleConfiguration>").encode()


def _parse_complete_body(body: bytes) -> list[tuple[int, str]]:
    """CompleteMultipartUpload XML -> [(part_num, etag), ...]."""
    import xml.etree.ElementTree as ET
    try:
        root = ET.fromstring(body.decode())
    except Exception as e:  # noqa: BLE001
        raise RGWError(400, "MalformedXML", str(e)) from e
    parts = []
    for part in root.iter():
        if part.tag.rpartition("}")[2] != "Part":
            continue
        num = etag = None
        for child in part:
            tag = child.tag.rpartition("}")[2]
            if tag == "PartNumber":
                try:
                    num = int(child.text)
                except (TypeError, ValueError) as e:
                    raise RGWError(400, "MalformedXML",
                                   f"PartNumber {child.text!r}") from e
            elif tag == "ETag":
                etag = (child.text or "").strip().strip('"')
        if num is None or etag is None:
            raise RGWError(400, "MalformedXML",
                           "Part needs PartNumber and ETag")
        parts.append((num, etag))
    return parts


class S3Gateway:
    """One radosgw instance: an RGWStore + the HTTP frontend."""

    def __init__(self, client, addr: tuple[str, int] = ("127.0.0.1", 0),
                 creds: dict[str, str] | None = None,
                 ec_profile: str | None = None,
                 lc_interval: float = 60.0, modlog: bool = False,
                 asok_path: str | None = None):
        # modlog=True for a multisite source zone (rgw/sync.py)
        self.store = RGWStore(client, ec_profile=ec_profile,
                              modlog=modlog)
        # reshard maintenance registry: mgr's rgw_reshard module
        # drives sweeps on every attached store (in-process clusters)
        from ..mgr.modules import RgwReshardModule
        RgwReshardModule.attach(self.store)
        self.asok = None
        if asok_path:
            from ..common.admin_socket import AdminSocket
            self.asok = AdminSocket(asok_path)
            self.asok.register_command("bucket reshard status",
                                       self._asok_reshard_status)
            self.asok.register_command("bucket reshard start",
                                       self._asok_reshard_start)
            self.asok.register_command("bucket limit check",
                                       self._asok_limit_check)
            self.asok.register_command("bucket stats",
                                       self._asok_bucket_stats)
        self.creds = creds          # access_key -> secret; None = open
        from .swift import SwiftFrontend
        self.swift = SwiftFrontend(self.store, creds)
        self.httpd = ThreadingHTTPServer(addr, _Handler)
        self.httpd.gateway = self
        self.addr = self.httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True,
            name="rgw-frontend")
        self._thread.start()
        # lifecycle worker (reference RGWLC thread): periodic sweep of
        # every bucket's rules; tests call store.lifecycle_sweep(now=)
        # directly with a mocked clock
        self._lc_stop = threading.Event()

        def _lc_loop():
            while not self._lc_stop.wait(lc_interval):
                try:
                    self.store.lifecycle_sweep()
                except Exception:  # noqa: BLE001 - worker must survive
                    import traceback
                    traceback.print_exc()
                try:
                    # same cadence: resume interrupted reshards and
                    # autoscale over-full bucket indexes (the mgr's
                    # rgw_reshard module covers clusters where the
                    # gateway died mid-reshard)
                    self.store.reshard_sweep()
                except Exception:  # noqa: BLE001 - worker must survive
                    import traceback
                    traceback.print_exc()

        self._lc_thread = threading.Thread(
            target=_lc_loop, daemon=True, name="rgw-lc")
        self._lc_thread.start()

    # -- asok surface (ceph daemon ASOK bucket ...; reference
    #    radosgw-admin bucket reshard / bucket limit check) ---------------

    def _asok_reshard_status(self, cmd: dict) -> dict:
        try:
            return self.store.reshard_status(cmd["bucket"])
        except (RGWError, KeyError) as e:
            return {"error": str(e)}

    def _asok_reshard_start(self, cmd: dict) -> dict:
        try:
            return self.store.reshard_bucket(cmd["bucket"],
                                             int(cmd["shards"]))
        except (RGWError, KeyError, ValueError) as e:
            return {"error": str(e)}

    def _asok_limit_check(self, _cmd: dict) -> dict:
        return {"buckets": self.store.bucket_limit_check()}

    def _asok_bucket_stats(self, cmd: dict) -> dict:
        try:
            return self.store.bucket_stats(cmd["bucket"])
        except (RGWError, KeyError) as e:
            return {"error": str(e)}

    def shutdown(self) -> None:
        self._lc_stop.set()
        from ..mgr.modules import RgwReshardModule
        RgwReshardModule.detach(self.store)
        if self.asok is not None:
            self.asok.shutdown()
        self.httpd.shutdown()
        self.httpd.server_close()


def main(argv=None) -> int:
    import argparse
    import sys
    import time

    ap = argparse.ArgumentParser(prog="radosgw")
    ap.add_argument("-m", "--mon", required=True, help="mon HOST:PORT")
    ap.add_argument("--port", type=int, default=7480)
    ap.add_argument("--access-key", default=None)
    ap.add_argument("--secret", default=None)
    ap.add_argument("--ec-profile", default=None,
                    help="EC profile for the data pool")
    from ..tools.rados_cli import add_auth_args, cli_auth, parse_addr
    add_auth_args(ap)
    args = ap.parse_args(argv)
    from ..rados import RadosClient
    auth, secure = cli_auth(args)
    client = RadosClient(parse_addr(args.mon), "rgw", auth=auth,
                         secure=secure).connect()
    creds = {args.access_key: args.secret} \
        if args.access_key and args.secret else None
    gw = S3Gateway(client, ("0.0.0.0", args.port), creds=creds,
                   ec_profile=args.ec_profile)
    print(f"radosgw listening on {gw.addr}", flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        gw.shutdown()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
