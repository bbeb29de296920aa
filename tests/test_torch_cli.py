"""The port's client CLIs on a port cluster on the CPU: `rbd_cli` and
`rados_cli` run as `python -m ceph_tpu_torch.tools.<cli>` (binary
stdin and stdout for `import -`, `export -`, `put -` and `get -`), and
their read-only commands print what the JAX package's CLIs print
against the same cluster; `crushtool` runs as a module."""

import contextlib
import io as _io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ceph_tpu.tools import rados_cli as jrados_cli
from ceph_tpu.tools import rbd_cli as jrbd_cli
from ceph_tpu_torch.tools import rados_cli as trados_cli
from ceph_tpu_torch.tools import rbd_cli as trbd_cli
from ceph_tpu_torch.tools.vstart import Cluster
from test_torch_cluster_foundations import port_singletons  # noqa: F401
from test_torch_crush_compiler import MAP_TEXT

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def cluster():
    """A port cluster with a torch EC pool (images) and a replicated
    pool (omap); yields (cluster, the CLIs' -m/-p arguments by pool)."""
    with Cluster(n_osds=4, device="cpu") as c:
        cl = c.client()
        cl.set_ec_profile("clip", {"plugin": "torch", "k": "2", "m": "1",
                                   "stripe_unit": "4096"})
        cl.create_pool("cliec", "erasure", erasure_code_profile="clip",
                       pg_num=4)
        cl.create_pool("clirep", "replicated", size=2, pg_num=4)
        mon = "%s:%d" % tuple(c.mon.addr)
        yield c, {p: ["-m", mon, "-p", p] for p in ("cliec", "clirep")}


def _module(cli, argv, stdin=b""):
    proc = subprocess.run(
        [sys.executable, "-m", f"ceph_tpu_torch.tools.{cli}", *argv],
        input=stdin, capture_output=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    return proc.stdout


def _main(mod, argv) -> tuple[int, bytes]:
    raw = _io.BytesIO()
    out = _io.TextIOWrapper(raw, encoding="utf-8")
    with contextlib.redirect_stdout(out):
        rc = mod.main(argv)
    out.flush()
    return rc, raw.getvalue()


def test_rbd_cli_import_and_export_through_stdin_and_stdout(cluster):
    _, base = cluster
    data = np.random.default_rng(3).integers(
        0, 256, 300_000, dtype=np.uint8).tobytes()
    said = _module("rbd_cli", base["cliec"] + ["import", "-", "piped",
                                               "--order", "16"], data)
    assert said.decode().strip() == "imported 300000 bytes to piped"
    assert _module("rbd_cli", base["cliec"] + ["export", "piped",
                                               "-"]) == data
    assert _module("rbd_cli", base["cliec"] + ["ls"]).split() == \
        [b"piped"]


def test_rados_cli_put_and_get_through_stdin_and_stdout(cluster):
    _, base = cluster
    data = bytes(range(256)) * 1000
    _module("rados_cli", base["cliec"] + ["put", "blob", "-"], data)
    assert _module("rados_cli", base["cliec"] + ["get", "blob", "-"]) == \
        data


def test_read_only_commands_print_what_the_reference_prints(cluster):
    """The same commands through each package's CLI against the port's
    cluster (the two packages speak one wire protocol)."""
    _, base = cluster
    ec, rep = base["cliec"], base["clirep"]
    setup = [ec + ["create", "disk", "--size", "1048576", "--order", "16"],
             ec + ["snap", "create", "disk@one"],
             ec + ["bench", "disk", "--io-size", "65536",
                   "--io-total", "262144"],
             ec + ["clone", "disk@one", "kid"]]
    for argv in setup:
        assert _main(trbd_cli, argv)[0] == 0
    assert _main(trados_cli, rep + ["setomapval", "o", "k1", "v1"])[0] == 0
    assert _main(trados_cli, rep + ["setomapheader", "o", "hdr"])[0] == 0
    rbd_reads = [ec + ["ls"], ec + ["info", "disk"], ec + ["info", "kid"],
                 ec + ["snap", "ls", "disk"], ec + ["du", "disk"],
                 ec + ["lock", "ls", "disk"], ec + ["info", "nosuch"]]
    for argv in rbd_reads:
        assert _main(trbd_cli, argv) == _main(jrbd_cli, argv), argv
    rados_reads = [rep + ["listomapkeys", "o"], rep + ["listomapvals", "o"],
                   rep + ["getomapval", "o", "k1"],
                   rep + ["getomapval", "o", "nokey"]]
    for argv in rados_reads:
        assert _main(trados_cli, argv) == _main(jrados_cli, argv), argv


def test_crushtool_runs_as_a_module(tmp_path):
    path = tmp_path / "map.txt"
    path.write_text(MAP_TEXT)
    said = _module("crushtool", ["--compile", str(path)]).decode()
    assert said.strip() == "ok: 6 devices, 4 buckets, 2 rules"
    text = _module("crushtool", ["--decompile", str(path)]).decode()
    path.write_text(text)
    assert _module("crushtool", ["--decompile", str(path)]).decode() == text
