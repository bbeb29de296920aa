"""The port's pure RGW functions against the JAX package's, on seeded
tables at a fixed clock: SigV4 (header signing and verification,
presigned URLs, aws-chunked streaming bodies), bucket-policy
validation and evaluation, canned ACLs and the bucket index's shard
routing, which is a contract between the packages (a bucket resharded
by one lists the same in the other)."""

import datetime
import itertools
import json
import types

import numpy as np
import pytest

import ceph_tpu.rgw.acl as jacl
import ceph_tpu.rgw.bucket_index as jbi
import ceph_tpu.rgw.policy as jpol
import ceph_tpu.rgw.sigv4 as jsig
import ceph_tpu_torch.rgw.acl as tacl
import ceph_tpu_torch.rgw.bucket_index as tbi
import ceph_tpu_torch.rgw.policy as tpol
import ceph_tpu_torch.rgw.sigv4 as tsig

NOW = datetime.datetime(2026, 10, 18, 1, 2, 3, tzinfo=datetime.timezone.utc)
CREDS = {"alice": "alice-secret", "bob": "bob-secret"}
KEY_CHARS = list("abcxyz019-_.~/ %+=&?") + ["é", "∂", "😀"]


class _Clock(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return NOW


@pytest.fixture
def clock(monkeypatch):
    """Both packages' sigv4 read NOW as the time."""
    fake = types.SimpleNamespace(datetime=_Clock,
                                 timezone=datetime.timezone,
                                 timedelta=datetime.timedelta)
    for mod in (jsig, tsig):
        monkeypatch.setattr(mod, "datetime", fake)


def _key(rng) -> str:
    return "".join(KEY_CHARS[int(i)] for i in rng.integers(
        0, len(KEY_CHARS), int(rng.integers(1, 24))))


def _requests(n=64, seed=11):
    rng = np.random.default_rng(seed)
    for i in range(n):
        method = ["GET", "PUT", "POST", "DELETE", "HEAD"][i % 5]
        path = f"/b{i % 3}/" + _key(rng)
        query = "&".join(f"{_key(rng)[:6]}={int(v)}" for v in
                         rng.integers(0, 100, int(rng.integers(0, 3))))
        headers = {"host": "127.0.0.1:7480"}
        if i % 4 == 0:
            headers["x-amz-copy-source"] = "/b0/" + _key(rng)
        if i % 7 == 0:
            headers["x-amz-acl"] = "public-read"
        body = rng.integers(0, 256, int(rng.integers(0, 5000)),
                            dtype=np.uint8).tobytes()
        user = ["alice", "bob"][i % 2]
        yield method, path, query, headers, body, user


def test_sign_request_is_the_same_and_verifies_across(clock):
    n = 0
    for method, path, query, headers, body, user in _requests():
        signed = [mod.sign_request(method, path, query, headers, body,
                                   user, CREDS[user]) for mod in
                  (jsig, tsig)]
        assert signed[0] == signed[1], (method, path, query)
        full = {**headers, **signed[1]}
        for verifier in (jsig, tsig):
            got = verifier.verify_request(method, path, query, full, body,
                                          CREDS)
            assert got["access_key"] == user and not got["streaming"]
        # a changed body or header fails in both
        bad = {**full, "x-amz-content-sha256": "0" * 64}
        for verifier, err in ((jsig, jsig.SigError),
                              (tsig, tsig.SigError)):
            with pytest.raises(err):
                verifier.verify_request(method, path, query, bad, body,
                                        CREDS)
        n += 1
    assert n == 64


def test_presigned_urls_are_the_same_and_verify_across():
    rng = np.random.default_rng(12)
    for i in range(48):
        method = ["GET", "PUT", "DELETE"][i % 3]
        path = f"/pb/{_key(rng)}"
        expires = int(rng.integers(1, 7 * 24 * 3600))
        query = "versionId=v1" if i % 5 == 0 else ""
        urls = [mod.presign_url(method, path, "alice", CREDS["alice"],
                                expires, host="h:1", query=query, now=NOW)
                for mod in (jsig, tsig)]
        assert urls[0] == urls[1]
        for verifier in (jsig, tsig):
            assert verifier.verify_presigned(
                method, path, urls[0], {"host": "h:1"}, CREDS,
                now=NOW)["access_key"] == "alice"
            late = NOW + datetime.timedelta(seconds=expires + 1)
            with pytest.raises(verifier.SigError):
                verifier.verify_presigned(method, path, urls[0],
                                          {"host": "h:1"}, CREDS, now=late)
            with pytest.raises(verifier.SigError):
                verifier.verify_presigned(method, path + "x", urls[0],
                                          {"host": "h:1"}, CREDS, now=NOW)


@pytest.mark.parametrize("chunk", [1024, 64 * 1024])
def test_streaming_bodies_are_the_same_and_decode_across(chunk):
    rng = np.random.default_rng(13)
    for size in (0, 1, 1023, 1024, 1025, 200_000):
        payload = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        seed = "ab" * 32
        bodies = [mod.encode_streaming_body(
            payload, "s3cr3t", "20261018T010203Z", "20261018", seed,
            chunk_size=chunk) for mod in (jsig, tsig)]
        assert bodies[0] == bodies[1]
        for mod in (jsig, tsig):
            assert mod.decode_streaming_body(
                bodies[0], "s3cr3t", "20261018T010203Z", "20261018",
                seed) == payload
            # the first chunk's signature, or its first data byte
            tampered = bytearray(bodies[0])
            at = bodies[0].index(b"\r\n") + (2 if size else -1)
            tampered[at] ^= 1
            with pytest.raises(mod.SigError):
                mod.decode_streaming_body(bytes(tampered), "s3cr3t",
                                          "20261018T010203Z", "20261018",
                                          seed)


def _policies(n=40, seed=14):
    rng = np.random.default_rng(seed)
    principals = ["*", {"AWS": "*"}, {"AWS": ["alice"]}, {"AWS": "bob"},
                  {"AWS": ["alice", "bob"]}]
    actions = ["s3:*", "s3:GetObject", "s3:PutObject", "s3:Get*",
               ["s3:ListBucket", "s3:DeleteObject"], "s3:*Object"]
    resources = ["arn:aws:s3:::b", "arn:aws:s3:::b/*",
                 "arn:aws:s3:::b/pub/*", ["arn:aws:s3:::*"],
                 "arn:aws:s3:::b/k?"]
    for _ in range(n):
        yield {"Version": "2012-10-17", "Statement": [
            {"Effect": ["Allow", "Deny"][int(rng.integers(0, 2))],
             "Principal": principals[int(rng.integers(0, len(principals)))],
             "Action": actions[int(rng.integers(0, len(actions)))],
             "Resource": resources[int(rng.integers(0, len(resources)))]}
            for _ in range(int(rng.integers(1, 4)))]}


def test_policy_evaluation_is_the_same():
    asks = list(itertools.product(
        [None, "alice", "bob"],
        ["s3:GetObject", "s3:PutObject", "s3:ListBucket",
         "s3:DeleteObject"],
        ["arn:aws:s3:::b", "arn:aws:s3:::b/k1", "arn:aws:s3:::b/pub/x",
         "arn:aws:s3:::c/k"]))
    decisions = set()
    for pol in _policies():
        raw = json.dumps(pol)
        docs = [mod.validate_policy(raw) for mod in (jpol, tpol)]
        assert docs[0] == docs[1]
        for who, action, res in asks:
            got = [mod.evaluate(doc, who, action, res)
                   for mod, doc in zip((jpol, tpol), docs)]
            assert got[0] == got[1], (pol, who, action, res)
            decisions.add(got[0])
    assert decisions == {"Allow", "Deny", None}
    assert tpol.bucket_arn("b") == jpol.bucket_arn("b")
    assert tpol.object_arn("b", "k/x") == jpol.object_arn("b", "k/x")


@pytest.mark.parametrize("raw", [
    b"not json", b"{}", json.dumps({"Statement": [{"Effect": "Maybe",
                                                   "Principal": "*",
                                                   "Action": "s3:*",
                                                   "Resource": "*"}]}),
    json.dumps({"Statement": [{"Effect": "Allow", "Action": "s3:*"}]}),
    json.dumps({"Statement": [{"Effect": "Allow", "Principal": "*",
                               "Action": "iam:*", "Resource": "*"}]})])
def test_malformed_policies_fail_in_both(raw):
    for mod in (jpol, tpol):
        with pytest.raises(mod.PolicyError):
            mod.validate_policy(raw)


def test_canned_acls_are_the_same():
    assert tacl.CANNED_ACLS == jacl.CANNED_ACLS
    rows = list(itertools.product(
        [None, "alice", "bob"], [None, "alice"], jacl.CANNED_ACLS,
        ["READ", "WRITE", "READ_ACP", "WRITE_ACP", "OWNER"]))
    got = [tacl.canned_allows(*r) for r in rows]
    assert got == [jacl.canned_allows(*r) for r in rows]
    assert 0 < sum(got) < len(rows)


def test_shard_routing_is_the_same():
    rng = np.random.default_rng(15)
    keys = [_key(rng) for _ in range(2000)] + ["", "a", "\udcff"]
    for n in (0, 1, 2, 3, 7, 8, 16, 64, 1021):
        got = [tbi.shard_of(k, n) for k in keys]
        assert got == [jbi.shard_of(k, n) for k in keys], n
        if n > 1:
            assert set(got) == set(range(n)) or n > 64
