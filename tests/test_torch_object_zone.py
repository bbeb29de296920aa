"""A zone written through one package's gateway opens in the other's:
buckets, objects, a multipart object, a versioned key under a delete
marker and a bucket resharded to 8 index shards, every request signed
by the other package's sigv4 (so a request one package signs verifies
in the other's gateway), on BlueStore with a jerasure data pool (a
plugin both packages have); reopened with the same pools and mon data
dir, the other package's gateway lists and reads back the same."""

import numpy as np
import pytest

import chip_smoke
from test_torch_cluster_foundations import port_singletons  # noqa: F401
from test_torch_object_service import CREDS, PACKAGES, _data_pool


def _zone_view(s3, store) -> dict:
    """Buckets, listings (flat and with a delimiter, pages of 3), versions
    and every object's digest, through a gateway and its store."""
    view = {"zone": chip_smoke.zone_state(store), "listings": {}}
    for b, _m in store.list_buckets():
        for d in ("", "/"):
            view["listings"][(b, d)] = chip_smoke.s3_listing(s3, b, d, 3)
    st, _, body = s3.request("GET", "/v", "versions")
    assert st == 200
    view["versions"] = [r for r in body.decode().split("<") if
                        r.startswith(("Size>", "IsLatest>"))]
    view["shards"] = store.index.read_layout("r").shards
    return view


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_zone_opens_in_the_other_package(tmp_path, writer, reader):
    """A zone written through one package's gateway on BlueStore, every
    request signed by the other package's sigv4 (buckets, objects, a
    multipart object, a versioned key with a delete marker, a bucket
    resharded to 8 index shards), opens with the same pools and mon data
    dir in the other package's gateway and reads back equal.  Its data
    pool is jerasure k=4 m=2, a plugin both packages have."""
    rng = np.random.default_rng(31)
    d = str(tmp_path / "c")
    cls, kw, gw_cls, rgw = PACKAGES[writer]
    signer = PACKAGES[reader][3].sigv4
    with cls(n_osds=6, objectstore="bluestore", data_dir=d, **kw) as c:
        _data_pool(c, "jerasure", {"k": "4", "m": "2",
                                   "stripe_unit": "4096"})
        gw = gw_cls(c.client(), creds=CREDS, ec_profile="rgw_ec")
        try:
            s3 = chip_smoke.S3Client(gw.addr, signer)
            for b in ("p", "v", "r"):
                assert s3.request("PUT", f"/{b}")[0] == 200
            for i in range(12):
                body = rng.integers(0, 256, int(rng.integers(1, 40000)),
                                    dtype=np.uint8).tobytes()
                b = "pr"[i % 2]
                assert s3.request("PUT", f"/{b}/d{i % 3}/k{i}",
                                  body=body)[0] == 200
            st, _, bd = s3.request("POST", "/p/mp", "uploads")
            uid = bd.decode().split("<UploadId>")[1].split("<")[0]
            rows = []
            for n in (1, 2):
                st, hd, _ = s3.request(
                    "PUT", "/p/mp", f"partNumber={n}&uploadId={uid}",
                    rng.integers(0, 256, 20000, dtype=np.uint8).tobytes())
                rows.append(f"<Part><PartNumber>{n}</PartNumber><ETag>"
                            f"{hd['ETag']}</ETag></Part>")
            assert s3.request("POST", "/p/mp", f"uploadId={uid}", (
                "<CompleteMultipartUpload>" + "".join(rows) +
                "</CompleteMultipartUpload>").encode())[0] == 200
            assert s3.request("PUT", "/v", "versioning", (
                b"<VersioningConfiguration><Status>Enabled</Status>"
                b"</VersioningConfiguration>"))[0] == 200
            for body in (b"first", b"second"):
                assert s3.request("PUT", "/v/key", body=body)[0] == 200
            assert s3.request("DELETE", "/v/key")[0] == 204
            gw.store.reshard_bucket("r", 8)
            view = _zone_view(s3, gw.store)
        finally:
            gw.shutdown()
    assert view["shards"] == 8 and len(view["versions"]) == 6
    cls, kw, gw_cls, _rgw = PACKAGES[reader]
    with cls(n_osds=6, objectstore="bluestore", data_dir=d, **kw) as c:
        c.wait_active_clean(timeout=120)
        gw = gw_cls(c.client(), creds=CREDS, ec_profile="rgw_ec")
        try:
            s3 = chip_smoke.S3Client(gw.addr, PACKAGES[writer][3].sigv4)
            assert _zone_view(s3, gw.store) == view
            assert s3.request("GET", "/v/key")[0] == 404
        finally:
            gw.shutdown()
