"""The port's CPU thread policy (`ceph_tpu_torch.resolve_device`): the
first CPU resolve in a process sets torch's intra-op threads to one,
unless OMP_NUM_THREADS is set; a CUDA resolve changes nothing; and the
CPU path's bytes and crcs do not depend on the count.  Each case runs
in a child process, so that the worker's own count is not what is
tested.

The `slow` case is the load reproduction: the many-PG sweep at the
replay's size (tests/test_load_harness.py's structural case) on the
port and on the JAX package, each in a child process beside six
busy-loop processes.  Run it by hand:

    python -m pytest tests/test_torch_cpu_threads.py -m slow -k repro -s
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

# the replay's call (tests/test_torch_load_harness.py's substitution of
# tests/test_load_harness.py:277)
SWEEP = "pg_counts=(1, 4), total_objs=16, objsize=64 << 10, passes=1, " \
        "min_frac=0.0"


def _child(code: str, omp: str | None = None, timeout: float = 240.0):
    """Run `code` in a fresh interpreter at the repo's root, with
    OMP_NUM_THREADS set to `omp` or unset; its last line of output is
    a JSON value."""
    env = dict(os.environ)
    env.pop("OMP_NUM_THREADS", None)
    if omp is not None:
        env["OMP_NUM_THREADS"] = omp
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


RESOLVE = """
import json, torch
from ceph_tpu_torch import resolve_device
before = torch.get_num_threads()
err = None
try:
    resolve_device({device!r})
except RuntimeError as e:
    err = str(e)
print(json.dumps([before, torch.get_num_threads(), err]))
"""


def test_cpu_resolve_sets_one_thread():
    _before, after, err = _child(RESOLVE.format(device="cpu"))
    assert err is None
    assert after == 1


def test_omp_num_threads_keeps_its_count():
    before, after, err = _child(RESOLVE.format(device="cpu"), omp="3")
    assert err is None
    assert before == after == 3


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="holds where no GPU exists")
def test_cuda_resolve_without_a_gpu_raises_and_keeps_the_count():
    before, after, err = _child(RESOLVE.format(device="cuda"))
    assert err is not None and "no CUDA device" in err
    assert after == before


# the sweep with every MemStore it builds recorded: one digest of every
# shard's bytes, xattrs (the HashInfo crcs among them) and omap
SWEEP_DIGEST = f"""
import hashlib, json, torch
import ceph_tpu_torch.store as st
stores = []
class Recorded(st.MemStore):
    def __init__(self):
        super().__init__()
        stores.append(self)
st.MemStore = Recorded
from ceph_tpu_torch.tools.load_harness import run_ec_pg_sweep
row = run_ec_pg_sweep(device="cpu", {SWEEP})
h = hashlib.sha256()
objs = hinfo = 0
for s in stores:
    for cid in sorted(s.list_collections(), key=str):
        for oid in sorted(s.list_objects(cid), key=str):
            objs += 1
            h.update(str((cid, oid)).encode())
            h.update(s.read(cid, oid).tobytes())
            for name, val in sorted(s.getattrs(cid, oid).items()):
                hinfo += name == "hinfo_key"
                h.update(name.encode() + bytes(val))
            for key, val in sorted(s.omap_get(cid, oid).items()):
                h.update(bytes(key) + bytes(val))
print(json.dumps({{"threads": torch.get_num_threads(), "stores": len(stores),
                  "objects": objs, "hinfo": hinfo, "digest": h.hexdigest(),
                  "ok": row["ok"]}}))
"""


def test_sweep_bytes_and_crcs_equal_at_one_and_four_threads():
    one = _child(SWEEP_DIGEST)
    four = _child(SWEEP_DIGEST, omp="4")
    assert (one["threads"], four["threads"]) == (1, 4)
    # (1 + 4 backends) x (warm + 1 pass), one store of k + m = 11
    # shard collections each
    assert one["stores"] == 10
    assert one["objects"] > 0 and one["hinfo"] > 0
    assert four == {**one, "threads": 4}


# -- the load reproduction ----------------------------------------------------

SWEEP_WALL = """
import json, time
{setup}
from {package}.tools.load_harness import run_ec_pg_sweep
t0 = time.perf_counter()
row = run_ec_pg_sweep({device}{sweep})
print(json.dumps({{"wall_s": time.perf_counter() - t0,
                  "agg_GBps": row["agg_GBps"]}}))
"""

PORT_WALL = SWEEP_WALL.format(setup="", package="ceph_tpu_torch",
                              device='device="cpu", ', sweep=SWEEP)
REF_WALL = SWEEP_WALL.format(
    setup='import jax; jax.config.update("jax_platforms", "cpu")',
    package="ceph_tpu", device="", sweep=SWEEP)

N_BUSY = 6


@pytest.mark.slow
def test_sweep_beside_busy_loops_repro():
    """The port's sweep takes no more than twice the reference's wall
    beside six busy-loop processes, and its rates stay above zero after
    rounding (the reference's assertion at tests/test_load_harness.py:
    282)."""
    busy = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
            for _ in range(N_BUSY)]
    try:
        port = _child(PORT_WALL, timeout=600.0)
        ref = _child(REF_WALL, timeout=600.0)
    finally:
        for p in busy:
            p.kill()
            p.wait()
    print(f"\nbeside {N_BUSY} busy loops: port {port['wall_s']:.2f} s "
          f"{port['agg_GBps']}, reference {ref['wall_s']:.2f} s "
          f"{ref['agg_GBps']}")
    assert all(v > 0 for v in port["agg_GBps"].values())
    assert port["wall_s"] <= 2 * ref["wall_s"]
