"""Canned-ACL decision shared by BOTH REST dialects (reference
rgw_acl.h RGWAccessControlPolicy::verify_permission — one policy
evaluator behind rgw_rest_s3 and rgw_rest_swift alike).

One predicate, one truth: the S3 gateway and the Swift frontend must
never drift on what a canned ACL grants.
"""

from __future__ import annotations

CANNED_ACLS = ("private", "public-read", "public-read-write",
               "authenticated-read")


def canned_allows(identity: str | None, owner: str | None,
                  canned: str, perm: str) -> bool:
    """identity None = anonymous.  perm is 'READ' or 'WRITE'; any
    other perm string (ACP ops, OWNER-only admin) is owner-only by
    construction — no canned grant names it.  Ownerless (legacy)
    resources are open to any authenticated caller."""
    if identity is not None and (owner is None or identity == owner):
        return True
    if canned == "public-read-write":
        return perm in ("READ", "WRITE")
    if canned == "public-read":
        return perm == "READ"
    if canned == "authenticated-read":
        return perm == "READ" and identity is not None
    return False        # private
