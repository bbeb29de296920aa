"""ProcCluster: the multi-process dev cluster.

Same surface as vstart.Cluster but every daemon is its own OS process
(reference qa/standalone/ceph-helpers.sh run_mon/run_osd: real daemons,
one host).  What this buys over the thread topology:

  * kill -9 is a REAL SIGKILL — no destructor, no flushed buffer, no
    shared-memory state surviving by accident; revive replays whatever
    the store made durable, exactly like a crashed host
  * concurrency is real parallelism (each daemon owns a Python
    interpreter — no shared GIL), so cluster throughput numbers measure
    the system, not one interpreter's scheduler
  * serialization is load-bearing: every byte between daemons crosses
    a socket; nothing can lean on sharing objects in memory

Every daemon runs `python -m ceph_tpu_torch.tools.daemon_main` with
the cluster's `device` (the card by default; "cpu" for the plain
versions), writes its stderr to `<data_dir>/<name>.log` (a daemon that
dies at boot shows that log's tail in the error) and, with `asok_dir`,
serves its admin socket at `<asok_dir>/<name>.asok` as vstart.Cluster's
daemons do.

Library use:
    with ProcCluster(n_osds=4, objectstore="bluestore",
                     device="cpu") as c:
        client = c.client()
        ...
        c.kill_osd(2)          # SIGKILL the process
        c.revive_osd(2)        # respawn on the surviving store
        c.kill_all()           # SIGKILL every daemon (a power loss)
        c.restart_all()        # the mon and every OSD from their dirs
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from ..rados import RadosClient

# the directory that holds the package: daemons import it from there
# whatever the caller's working directory
_ROOT = str(Path(__file__).resolve().parents[2])


def _log_tail(log: Path | None, nbytes: int = 4000) -> str:
    if log is None or not log.exists():
        return ""
    data = log.read_bytes()[-nbytes:].decode(errors="replace")
    return f"; {log} ends:\n{data}"


def wait_ready(proc: subprocess.Popen, what: str,
               timeout: float = 120.0, log: Path | None = None) -> str:
    """Wait for daemon_main's one-line READY handshake on a raw-fd
    pipe (buffered wrappers can strand the line).  Scans for READY
    BEFORE checking liveness so a daemon that prints READY and exits
    still reports its address.  A daemon that dies or never gets ready
    raises with the tail of its stderr log."""
    import select
    fd = proc.stdout.fileno()
    buf = b""
    deadline = time.time() + timeout
    while time.time() < deadline:
        *complete, _partial = buf.split(b"\n")
        for line in complete:
            if line.startswith(b"READY"):
                return line.split()[1].decode()
        if proc.poll() is not None:
            raise RuntimeError(f"{what} died at boot "
                               f"(rc={proc.returncode})"
                               f"{_log_tail(log)}")
        r, _, _ = select.select([fd], [], [], 0.2)
        if r:
            chunk = os.read(fd, 4096)
            if chunk:
                buf += chunk
    raise RuntimeError(f"{what} not ready in {timeout}s{_log_tail(log)}")


def _free_ports(n: int) -> list[int]:
    """Reserve n distinct loopback ports (bind-then-release; the race
    window on a dev box is acceptable for test clusters — the reference
    helpers pick fixed port ranges the same way)."""
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


class ProcCluster:
    def __init__(self, n_osds: int = 4, n_mons: int = 1,
                 objectstore: str = "filestore",
                 data_dir: str | None = None,
                 heartbeat_interval: float = 1.0,
                 failure_quorum: int = 2,
                 conf: dict | None = None,
                 boot_timeout: float = 120.0,
                 mesh_devices: str | None = None,
                 prewarm: bool = False,
                 compile_cache_dir: str | None = None,
                 asok_dir: str | None = None,
                 device: str = "cuda"):
        # compile lifecycle (ops/compile_cache.py, ops/prewarm.py): in
        # the process topology EVERY OSD process prewarms its own
        # launch buckets and loads the kernel library from the cache
        # directory, which holds the library the caller built (a
        # daemon that finds none builds its own).  compile_cache_dir
        # points it at a private dir for hermetic runs.
        if prewarm or compile_cache_dir is not None:
            conf = dict(conf or {})
            if prewarm:
                conf.setdefault("osd_ec_prewarm", True)
            if compile_cache_dir is not None:
                conf.setdefault("osd_ec_compile_cache_dir",
                                str(compile_cache_dir))
        self.n_osds = n_osds
        self.n_mons = n_mons
        self.objectstore = objectstore
        # multichip mode in the process topology: each OSD process
        # stands in for a host and owns its OWN mesh; daemon_main
        # configures its MeshService from this conf (a CPU mesh
        # repeats the CPU)
        self.mesh_devices = mesh_devices
        if mesh_devices is not None:
            conf = dict(conf or {})
            conf.setdefault("osd_ec_use_mesh", True)
            conf.setdefault("mesh_devices", mesh_devices)
        self.data_dir = Path(data_dir or tempfile.mkdtemp(
            prefix="ceph_tpu_torch_proc_"))
        self.data_dir.mkdir(parents=True, exist_ok=True)
        self.asok_dir = asok_dir
        self.device = str(device)      # every daemon's codecs
        self.heartbeat_interval = heartbeat_interval
        self.failure_quorum = failure_quorum
        self.conf = dict(conf or {})
        # per-OSD conf overrides carried across revive (chaos knobs
        # must survive restarts): merged over self.conf at every
        # (re)spawn of that daemon
        self.osd_conf: dict[int, dict] = {}
        self.boot_timeout = boot_timeout
        self.mon_ports = _free_ports(n_mons)
        self.mon_addrs = [("127.0.0.1", p) for p in self.mon_ports]
        self.mon_procs: list[subprocess.Popen] = []
        self.osd_procs: list[subprocess.Popen | None] = []
        # each OSD process's READY address: a restarted cluster is up
        # when the map shows these, not the dead processes' addresses
        self.osd_addrs: dict[int, tuple[str, int]] = {}
        self._clients: list[RadosClient] = []
        # each daemon's seconds from spawn to READY, its last start
        self.ready_s: dict[str, float] = {}
        self._spawned_at: dict[str, float] = {}

    # -- spawning -----------------------------------------------------------

    def log_path(self, name: str) -> Path:
        """Where daemon `name` ("mon.0", "osd.3") writes its stderr."""
        return self.data_dir / f"{name}.log"

    def asok_path(self, name: str) -> str | None:
        return f"{self.asok_dir}/{name}.asok" if self.asok_dir else None

    def _spawn(self, argv: list[str], name: str) -> subprocess.Popen:
        """Start one daemon process on the cluster's device; its stderr
        appends to its log (a revived daemon's traceback lands after
        the killed one's)."""
        argv = [*argv, "--device", self.device]
        if self.asok_dir:
            argv += ["--asok", self.asok_path(name)]
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_ROOT, env.get("PYTHONPATH")) if p)
        self._spawned_at[name] = time.perf_counter()
        with open(self.log_path(name), "ab") as log:
            return subprocess.Popen(
                [sys.executable, "-m", "ceph_tpu_torch.tools.daemon_main",
                 *argv],
                stdout=subprocess.PIPE, stderr=log, text=True, env=env)

    def _wait_ready(self, proc: subprocess.Popen, what: str) -> str:
        addr = wait_ready(proc, what, self.boot_timeout,
                          self.log_path(what))
        self.ready_s[what] = time.perf_counter() - self._spawned_at[what]
        return addr

    def start(self) -> "ProcCluster":
        try:
            return self._start()
        except Exception:
            self.stop()        # never leak orphan daemon processes
            raise

    def _start(self) -> "ProcCluster":
        self._spawn_mons()
        for i in range(self.n_osds):
            self.osd_procs.append(self._spawn_osd(i))
        for i in range(self.n_osds):
            self._wait_osd_ready(i)
        self.wait_all_up()
        return self

    def _spawn_mons(self) -> None:
        addrs = ",".join(f"{h}:{p}" for h, p in self.mon_addrs)
        for rank in range(self.n_mons):
            p = self._spawn([
                "mon", "--rank", str(rank), "--addrs", addrs,
                "--failure-quorum", str(self.failure_quorum),
                "--data-dir", str(self.data_dir / f"mon.{rank}")],
                f"mon.{rank}")
            self.mon_procs.append(p)
        for rank, p in enumerate(self.mon_procs):
            self._wait_ready(p, f"mon.{rank}")

    def _wait_osd_ready(self, osd_id: int) -> None:
        addr = self._wait_ready(self.osd_procs[osd_id], f"osd.{osd_id}")
        host, _, port = addr.rpartition(":")
        self.osd_addrs[osd_id] = (host, int(port))

    def wait_all_up(self) -> None:
        """Wait until the map shows every OSD up at the address its
        running process reported."""
        admin = self.admin()
        deadline = time.time() + self.boot_timeout
        while time.time() < deadline:
            admin.objecter.refresh_map(timeout=2.0)
            osds = admin.objecter.osdmap.osds
            if len(osds) == self.n_osds and all(
                    o.up and o.addr is not None
                    and tuple(o.addr) == self.osd_addrs.get(i)
                    for i, o in osds.items()):
                return
            time.sleep(0.2)
        raise RuntimeError("OSDs never all came up")

    def _spawn_osd(self, osd_id: int) -> subprocess.Popen:
        argv = ["osd", "--id", str(osd_id),
                "--mon", ",".join(f"{h}:{p}" for h, p in self.mon_addrs),
                "--objectstore", self.objectstore,
                "--data-dir", str(self.data_dir / f"osd.{osd_id}"),
                "--heartbeat", str(self.heartbeat_interval)]
        merged = {**self.conf, **self.osd_conf.get(osd_id, {})}
        for k, v in merged.items():
            argv += ["--conf", f"{k}={v}"]
        return self._spawn(argv, f"osd.{osd_id}")

    def set_osd_conf(self, osd_id: int, key: str, value) -> None:
        """Record a per-OSD conf override applied at every (re)spawn —
        the process analog of Cluster.set_osd_conf.  A running daemon
        picks it up on its next revive (live injection would need the
        asok injectargs path; spawn-time conf is what the thrasher
        needs to survive kill/revive)."""
        self.osd_conf.setdefault(osd_id, {})[key] = value

    def spawn_rgw(self) -> tuple[str, int]:
        raise NotImplementedError(
            "spawn_rgw: rgw (the S3 gateway) is not ported to "
            "ceph_tpu_torch")

    def spawn_mds(self, name: str = "a") -> tuple[str, int]:
        raise NotImplementedError(
            "spawn_mds: fs (the MDS and CephFS client) is not ported to "
            "ceph_tpu_torch")

    # -- cluster surface (vstart.Cluster-compatible subset) -----------------

    def client(self) -> RadosClient:
        c = RadosClient(self.mon_addrs).connect()
        self._clients.append(c)
        return c

    def admin(self) -> RadosClient:
        if not self._clients:
            return self.client()
        return self._clients[0]

    def kill_osd(self, osd_id: int) -> None:
        """SIGKILL — the real thing (reference ceph_manager kill_osd)."""
        p = self.osd_procs[osd_id]
        if p is not None:
            p.kill()
            p.wait()
            self.osd_procs[osd_id] = None

    def revive_osd(self, osd_id: int) -> None:
        assert self.osd_procs[osd_id] is None, "still running"
        p = self._spawn_osd(osd_id)
        self.osd_procs[osd_id] = p
        self._wait_osd_ready(osd_id)

    def _active_clean_once(self) -> tuple[bool, str]:
        """One clean-state probe from outside the daemons, on the mon's
        map and its `pg stat` (the OSDs' MPGStats reports): every
        running OSD up at its process's address, reporting on the
        current epoch with no recovery pending or running, nothing
        misplaced or unfound, and every PG with a primary and a full
        acting set."""
        from ..crush.map import CRUSH_ITEM_NONE
        from ..osd.types import pg_t
        admin = self.admin()
        admin.objecter.refresh_map(timeout=2.0)
        m = admin.objecter.osdmap
        r, st = admin.mon_command({"prefix": "pg stat"})
        if r != 0:
            return False, f"pg stat: {r} {st}"
        for i, proc in enumerate(self.osd_procs):
            if proc is None:
                continue
            info = m.osds.get(i)
            if info is None or not info.up or info.addr is None or \
                    tuple(info.addr) != self.osd_addrs.get(i):
                return False, f"osd.{i} not up at its address"
            epoch = st["osd_epochs"].get(str(i))
            if epoch != m.epoch:
                return False, f"osd.{i} reports epoch {epoch} < {m.epoch}"
        for key in ("degraded_pgs", "misplaced_objects", "unfound_objects"):
            if st[key]:
                return False, (f"{key} {st[key]} (osds "
                               f"{st['recovering_osds']})")
        if st["recovery_running"]:
            return False, f"recovery running on {st['recovery_running']}"
        for pool in m.pools.values():
            for seed in range(pool.pg_num):
                _, acting, _, primary = m.pg_to_up_acting_osds(
                    pg_t(pool.id, seed))
                alive = sum(1 for o in acting
                            if o != CRUSH_ITEM_NONE and m.is_up(o))
                if primary < 0 or alive < pool.size:
                    return False, (f"pg {pool.id}.{seed:x} acting "
                                   f"{alive}/{pool.size}")
        return True, "active+clean"

    def wait_active_clean(self, timeout: float = 180.0,
                          stable_for: float = 2.0) -> float:
        """Block until the probe holds and STAYS so for `stable_for`
        seconds (longer than an OSD's report interval, so a pass that
        starts on a fresh map shows); returns the seconds waited, or
        raises with the blocking condition."""
        t0 = time.time()
        stable_since = None
        why = "never probed"
        while time.time() - t0 < timeout:
            ok, why = self._active_clean_once()
            if ok:
                if stable_since is None:
                    stable_since = time.time()
                if time.time() - stable_since >= stable_for:
                    return stable_since - t0
            else:
                stable_since = None
            time.sleep(0.1)
        raise RuntimeError(f"not active+clean in {timeout}s: {why}")

    def kill_all(self) -> None:
        """SIGKILL every daemon, the mons too (a power loss): nothing
        but what the stores made durable survives.  The clients are
        shut, since their sessions die with the mons."""
        for c in self._clients:
            try:
                c.shutdown()
            except Exception:  # noqa: BLE001
                pass
        self._clients = []
        for p in [p for p in self.osd_procs if p is not None] + \
                self.mon_procs:
            p.kill()
            p.wait()
        self.osd_procs = [None] * len(self.osd_procs)
        self.mon_procs = []

    def restart_all(self) -> dict:
        """A cold restart after kill_all: the mons from their data dirs,
        then every OSD from its store, until the map shows them all up.
        Returns the seconds to every READY and to all up."""
        assert not self.mon_procs and \
            all(p is None for p in self.osd_procs), "still running"
        t0 = time.perf_counter()
        self._spawn_mons()
        self.osd_procs = [self._spawn_osd(i) for i in range(self.n_osds)]
        for i in range(self.n_osds):
            self._wait_osd_ready(i)
        ready = time.perf_counter() - t0
        self.wait_all_up()
        return {"ready_s": ready, "up_s": time.perf_counter() - t0}

    def mark_osd_down(self, osd_id: int) -> None:
        r, _ = self.admin().mon_command(
            {"prefix": "osd down", "id": osd_id})
        assert r == 0, f"osd down failed: {r}"

    def stop(self) -> None:
        for c in self._clients:
            try:
                c.shutdown()
            except Exception:  # noqa: BLE001
                pass
        procs = [p for p in self.osd_procs if p is not None] + \
            self.mon_procs
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    def __enter__(self) -> "ProcCluster":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
