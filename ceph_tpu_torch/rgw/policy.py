"""S3 bucket policy documents: validation + evaluation.

Re-expresses the reference's IAM policy engine subset
(src/rgw/rgw_iam_policy.{h,cc}: parse_policy + Effect/Principal/Action/
Resource matching with explicit-deny-overrides) for the grammar the S3
dialect actually exercises:

  Version    "2012-10-17" (required, the only accepted value)
  Statement  list of {Effect, Principal, Action, Resource}
  Effect     "Allow" | "Deny"
  Principal  "*" | {"AWS": "*" | id | [ids]}
  Action     "s3:Action" | "s3:*" | wildcard patterns, str or list
  Resource   "arn:aws:s3:::bucket[/key-pattern]", str or list,
             * and ? wildcards

Evaluation (evaluate) returns "Deny" / "Allow" / None; the gateway
combines it with canned ACLs the AWS way: explicit Deny always wins,
policy Allow grants without consulting the ACL, otherwise the ACL
decides.  Conditions / NotAction / NotPrincipal are out of scope (the
reference supports them; nothing in this build's consumers emits them).
"""

from __future__ import annotations

import fnmatch
import json


class PolicyError(ValueError):
    pass


_VALID_EFFECTS = {"Allow", "Deny"}


def _listify(x) -> list:
    return x if isinstance(x, list) else [x]


def validate_policy(raw: bytes | str | dict) -> dict:
    """Parse + structurally validate a policy document; returns the
    parsed dict.  Raises PolicyError with a caller-displayable message
    (surfaced as S3 MalformedPolicy)."""
    if isinstance(raw, dict):
        doc = raw
    else:
        try:
            doc = json.loads(raw)
        except (ValueError, UnicodeDecodeError) as e:
            raise PolicyError(f"invalid JSON: {e}") from e
    if not isinstance(doc, dict):
        raise PolicyError("policy must be a JSON object")
    if doc.get("Version") != "2012-10-17":
        raise PolicyError("Version must be \"2012-10-17\"")
    stmts = doc.get("Statement")
    if not isinstance(stmts, list) or not stmts:
        raise PolicyError("Statement must be a non-empty list")
    for i, st in enumerate(stmts):
        if not isinstance(st, dict):
            raise PolicyError(f"Statement[{i}] must be an object")
        if st.get("Effect") not in _VALID_EFFECTS:
            raise PolicyError(f"Statement[{i}].Effect must be "
                              "Allow or Deny")
        if "Principal" not in st:
            raise PolicyError(f"Statement[{i}] missing Principal")
        p = st["Principal"]
        if p != "*" and not (
                isinstance(p, dict) and "AWS" in p and
                all(isinstance(a, str) for a in _listify(p["AWS"]))):
            raise PolicyError(f"Statement[{i}].Principal must be '*' "
                              "or {\"AWS\": id|[ids]}")
        actions = _listify(st.get("Action", []))
        if not actions or not all(
                isinstance(a, str) and (a == "*" or a.startswith("s3:"))
                for a in actions):
            raise PolicyError(f"Statement[{i}].Action must be s3:* "
                              "action names")
        resources = _listify(st.get("Resource", []))
        if not resources or not all(
                isinstance(r, str) and r.startswith("arn:aws:s3:::")
                for r in resources):
            raise PolicyError(f"Statement[{i}].Resource must be "
                              "arn:aws:s3::: ARNs")
    return doc


def _principal_matches(principal, identity: str | None) -> bool:
    if principal == "*":
        return True
    ids = _listify(principal["AWS"])
    if "*" in ids:
        return True
    return identity is not None and identity in ids


def _pattern_matches(pattern: str, value: str) -> bool:
    """AWS-style * / ? wildcards.  fnmatch's [seq] classes are not part
    of the policy grammar: escape them so literal brackets match."""
    pattern = pattern.replace("[", "[[]")
    return fnmatch.fnmatchcase(value, pattern)


def evaluate(policy: dict, identity: str | None, action: str,
             resource: str) -> str | None:
    """-> "Deny" (explicit deny matched), "Allow" (an allow matched and
    no deny), or None (policy is silent).  identity None = anonymous.
    action e.g. "s3:GetObject"; resource an arn:aws:s3::: ARN."""
    decision = None
    for st in policy.get("Statement", []):
        if not _principal_matches(st["Principal"], identity):
            continue
        if not any(_pattern_matches(a, action)
                   for a in _listify(st["Action"])):
            continue
        if not any(_pattern_matches(r, resource)
                   for r in _listify(st["Resource"])):
            continue
        if st["Effect"] == "Deny":
            return "Deny"                # explicit deny: final
        decision = "Allow"
    return decision


def bucket_arn(bucket: str) -> str:
    return f"arn:aws:s3:::{bucket}"


def object_arn(bucket: str, key: str) -> str:
    return f"arn:aws:s3:::{bucket}/{key}"
