"""Dev cluster launcher (reference src/vstart.sh + qa/standalone/
ceph-helpers.sh run_mon/run_osd): start a mon and N OSDs on localhost
loopback — in-process threads by default (standalone-test style: many
daemons, one host, real messenger over loopback).  For the
multi-PROCESS topology (real SIGKILL, no shared GIL/memory) use
tools/proc_cluster.ProcCluster, same surface.

Library use:
    with Cluster(n_osds=6) as c:
        client = c.client()
        ...

CLI use:
    python -m ceph_tpu_torch.tools.vstart --osds 6     # runs until Ctrl-C
    python -m ceph_tpu_torch.tools.vstart --osds 6 --device cpu

The cluster's EC codecs run on `device`: the card ("cuda", the
default) or the CPU ("cpu", the plain versions of the kernels).  The
mon validates `torch` profiles there and every OSD builds its PGs'
codecs and its launch queue there; a CUDA request without a GPU fails
the command or op that needs the codec.  Only `memstore` is ported:
the persistent stores raise.
"""

from __future__ import annotations

import argparse
import sys
import time

from ..mon import Monitor
from ..osd.daemon import OSDDaemon
from ..rados import RadosClient


class Cluster:
    def __init__(self, n_osds: int = 6, heartbeat_interval: float = 0.0,
                 failure_quorum: int = 2, asok_dir: str | None = None,
                 objectstore: str = "memstore",
                 data_dir: str | None = None, n_mons: int = 1,
                 auth: str = "none", secure: bool = False,
                 conf: dict | None = None,
                 mesh_devices: str | None = None,
                 boot_parallel: bool = False,
                 prewarm: bool = False,
                 compile_cache_dir: str | None = None,
                 device: str = "cuda"):
        self.conf = dict(conf or {})   # applied to every OSD pre-boot
        self.device = str(device)      # every mon and OSD's codecs
        # compile lifecycle (ops/compile_cache.py, ops/prewarm.py):
        # prewarm=True boots every OSD with the launch-bucket prewarm
        # pass (the first in-process booter warms for the host);
        # compile_cache_dir points the kernel library cache at a private
        # directory (hermetic CI: a tmpdir instead of
        # ceph_tpu_torch/build/)
        if prewarm:
            self.conf.setdefault("osd_ec_prewarm", True)
        if compile_cache_dir is not None:
            self.conf.setdefault("osd_ec_compile_cache_dir",
                                 str(compile_cache_dir))
        # multichip deployment mode (docs/MULTICHIP.md): every OSD in
        # this (one-host) cluster shares the process-wide MeshService,
        # so EC PGs drain and repair on the device mesh.  '' = all
        # visible devices, 'SxD' pins the shape; None = single-chip.
        if mesh_devices is not None:
            self.conf.setdefault("osd_ec_use_mesh", True)
            self.conf.setdefault("mesh_devices", mesh_devices)
        # per-OSD conf overrides that SURVIVE revive: a revived daemon
        # gets a fresh CephContext, so anything set only via
        # cct.conf.set (chaos knobs like ms_inject_socket_failures)
        # would silently reset — set through set_osd_conf instead
        self.osd_conf: dict[int, dict] = {}
        # cephx deployment: one cluster service key shared by daemons,
        # a keyring of client entities on the mon (reference
        # vstart.sh's keyring bootstrap + ceph auth get-or-create)
        self.auth_mode = auth
        self.secure = secure
        self.keyring = None
        self.service_key = None
        # reactor pool sizing (ms_async_op_threads, startup-only): the
        # class-level pool is created by the FIRST messenger in this
        # process — the mon's — so the knob must land before Monitor
        # construction to take effect for the whole cluster
        if self.conf.get("ms_async_op_threads"):
            from ..msg.messenger import Messenger
            Messenger.configure_pool(
                int(self.conf["ms_async_op_threads"]))
        mon_auths = [None] * n_mons
        if auth == "cephx":
            import os as _os
            from ..auth import CephxAuth, Keyring
            self.keyring = Keyring()
            self.service_key = _os.urandom(16)
            self.keyring.gen_key("client.admin", "allow *")
            mon_auths = [CephxAuth("mon", service_key=self.service_key,
                                   keyring=self.keyring)
                         for _ in range(n_mons)]
        self.mons = [Monitor(failure_quorum=failure_quorum,
                             auth=mon_auths[i], secure=secure,
                             data_dir=(f"{data_dir}/mon.{i}"
                                       if data_dir else None),
                             asok_path=(f"{asok_dir}/mon.{i}.asok"
                                        if asok_dir else None),
                             device=self.device)
                     for i in range(n_mons)]
        self.mon_addrs = [m.addr for m in self.mons]
        if n_mons > 1:
            for i, m in enumerate(self.mons):
                m.join(self.mon_addrs, i)
        self.mon = self.mons[0]   # convenience alias (rank 0)
        self.osds: list[OSDDaemon] = []
        self.n_osds = n_osds
        # concurrent boots (the scale topology): all MOSDBoots land in
        # the mon's batch window and commit as a couple of epochs
        # instead of one epoch + full publish round per OSD — the
        # difference between O(N) and O(N^2) cold-start control-plane
        # work.  Sequential remains the default (tests that reason
        # about per-boot epochs keep their semantics).
        self.boot_parallel = boot_parallel
        self.heartbeat_interval = heartbeat_interval
        self.asok_dir = asok_dir
        self.objectstore = objectstore
        self.data_dir = data_dir
        self._clients: list[RadosClient] = []

    def wait_for_leader(self, timeout: float = 10.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            for m in self.mons:
                if m.is_leader:
                    return m
            time.sleep(0.05)
        raise RuntimeError("no mon leader elected")

    def start(self) -> "Cluster":
        from ..store import create_store
        self.wait_for_leader()
        for i in range(self.n_osds):
            asok = (f"{self.asok_dir}/osd.{i}.asok"
                    if self.asok_dir else None)
            store = create_store(
                self.objectstore,
                f"{self.data_dir}/osd.{i}" if self.data_dir else None)
            osd = OSDDaemon(i, self.mon_addrs, store=store,
                            heartbeat_interval=self.heartbeat_interval,
                            asok_path=asok, auth=self._daemon_auth(i),
                            secure=self.secure,
                            conf={**self.conf,
                                  **self.osd_conf.get(i, {})},
                            device=self.device)
            self.osds.append(osd)
        if self.boot_parallel:
            import threading
            ts = [threading.Thread(target=osd.boot, daemon=True)
                  for osd in self.osds]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
        else:
            for osd in self.osds:
                osd.boot()
        return self

    def set_osd_conf(self, osd_id: int, key: str, value) -> None:
        """Set a conf override that sticks across kill/revive (the
        thrasher's chaos knobs must survive restarts; reference
        ceph.conf [osd.N] sections persist the same way).  Applied
        live when the daemon is running."""
        self.osd_conf.setdefault(osd_id, {})[key] = value
        osd = self.osds[osd_id] if osd_id < len(self.osds) else None
        if osd is not None:
            try:
                osd.cct.conf.set(key, value)
            except Exception:  # noqa: BLE001 - daemon mid-shutdown
                pass

    def _daemon_auth(self, osd_id: int):
        if self.auth_mode != "cephx":
            return None
        from ..auth import CephxAuth
        return CephxAuth(f"osd.{osd_id}", service_key=self.service_key)

    def _client_auth(self):
        if self.auth_mode != "cephx":
            return None
        from ..auth import CephxAuth
        return CephxAuth("client.admin",
                         key=self.keyring.get("client.admin"))

    def client(self) -> RadosClient:
        c = RadosClient(self.mon_addrs, auth=self._client_auth(),
                        secure=self.secure).connect()
        self._clients.append(c)
        return c

    def kill_osd(self, osd_id: int) -> None:
        """Hard-kill an OSD (thrasher-style, reference
        qa/tasks/ceph_manager.py kill_osd)."""
        osd = self.osds[osd_id]
        osd.shutdown()

    def revive_osd(self, osd_id: int) -> None:
        """Restart a killed OSD on its surviving store (reference
        qa/tasks/ceph_manager.py revive_osd): FileStore replays its
        WAL on mount; MemStore data survives in-process.  Cluster and
        per-OSD conf overrides re-apply to the fresh CephContext —
        chaos settings (fault injection) survive the restart."""
        old = self.osds[osd_id]
        asok = (f"{self.asok_dir}/osd.{osd_id}.asok"
                if self.asok_dir else None)
        osd = OSDDaemon(osd_id, self.mon_addrs, store=old.store,
                        heartbeat_interval=self.heartbeat_interval,
                        asok_path=asok, auth=self._daemon_auth(osd_id),
                        secure=self.secure,
                        conf={**self.conf,
                              **self.osd_conf.get(osd_id, {})},
                        device=self.device)
        self.osds[osd_id] = osd
        osd.boot()

    def remove_osd(self, osd_id: int) -> None:
        """Decommission an OSD for good: shut the daemon down and drop
        it from the roster so quiescence checks stop expecting it (the
        map-side removal is `osd rm` — run drain/safe-to-destroy
        first)."""
        osd = self.osds[osd_id]
        if osd is not None:
            osd.shutdown()
        self.osds[osd_id] = None
        self.osd_conf.pop(osd_id, None)

    def kill_mon(self, rank: int) -> None:
        """Hard-kill a monitor (quorum must re-elect)."""
        self.mons[rank].shutdown()

    def mark_osd_down(self, osd_id: int) -> None:
        """Administratively mark down (what failure detection would do)."""
        r, _ = self.admin().mon_command(
            {"prefix": "osd down", "id": osd_id})
        assert r == 0, f"osd down failed: {r}"

    def admin(self) -> RadosClient:
        if not self._clients:
            return self.client()
        return self._clients[0]

    # -- quiescence (the "all PGs active+clean" gate; reference
    #    qa/tasks/ceph_manager.wait_for_clean) -----------------------------

    def _active_clean_once(self) -> tuple[bool, str]:
        """One clean-state probe: every PG of every pool has a live
        primary and a full acting set, every up OSD is on the current
        map with peering settled, no recovery pending or running, and
        no client ops in flight on any EC pipeline."""
        from ..crush.map import CRUSH_ITEM_NONE
        from ..osd.types import pg_t
        m = self.mon.osdmap
        epoch = m.epoch
        live = []
        for osd in self.osds:
            if osd is None:
                continue          # decommissioned (remove_osd)
            if not m.is_up(osd.osd_id):
                return False, f"osd.{osd.osd_id} down"
            if osd.osdmap.epoch < epoch:
                return False, (f"osd.{osd.osd_id} on epoch "
                               f"{osd.osdmap.epoch} < {epoch}")
            live.append(osd)
        for osd in live:
            if osd._pgs_needing_recovery:
                return False, (f"osd.{osd.osd_id} recovery pending: "
                               f"{sorted(map(str, osd._pgs_needing_recovery))[:4]}")
            if osd._recovery_inflight:
                return False, f"osd.{osd.osd_id} recovery running"
            if osd._split_push_pending:
                return False, (f"osd.{osd.osd_id} split pushes "
                               f"pending: {len(osd._split_push_pending)}")
            for pgid, state in list(osd.pgs.items()):
                if state.kind == "ec":
                    if state.needs_peer:
                        return False, f"pg {pgid} unpeered on " \
                                      f"osd.{osd.osd_id}"
                    be = state.backend
                    if be.waiting_state or be.waiting_reads or \
                            be.waiting_commit:
                        return False, f"pg {pgid} ops in flight"
        for pool in m.pools.values():
            for seed in range(pool.pg_num):
                pgid = pg_t(pool.id, seed)
                try:
                    _, acting, _, primary = m.pg_to_up_acting_osds(pgid)
                except Exception:  # noqa: BLE001
                    return False, f"pg {pgid} unmapped"
                alive = sum(1 for o in acting
                            if o != CRUSH_ITEM_NONE and m.is_up(o))
                if primary < 0 or alive < pool.size:
                    return False, (f"pg {pgid} acting {alive}/"
                                   f"{pool.size}")
        return True, "active+clean"

    def wait_active_clean(self, timeout: float = 180.0,
                          stable_for: float = 1.0) -> None:
        """Block until the cluster is quiescent — all PGs active+clean
        with in-flight ops and recovery drained, and STAYS so for
        `stable_for` seconds — or raise with the blocking condition.
        Event-driven settling for thrash tests: a liveness regression
        surfaces as the named stuck condition instead of hiding behind
        a wall-clock grace."""
        deadline = time.time() + timeout
        stable_since = None
        why = "never probed"
        while time.time() < deadline:
            ok, why = self._active_clean_once()
            if ok:
                if stable_since is None:
                    stable_since = time.time()
                elif time.time() - stable_since >= stable_for:
                    return
            else:
                stable_since = None
            time.sleep(0.2)
        raise TimeoutError(
            f"cluster not active+clean within {timeout}s: {why}")

    def stop(self) -> None:
        for c in self._clients:
            c.shutdown()
        for osd in self.osds:
            if osd is not None:
                osd.shutdown()
        for m in self.mons:
            m.shutdown()

    def __enter__(self) -> "Cluster":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="vstart")
    ap.add_argument("--osds", type=int, default=6)
    ap.add_argument("--mons", type=int, default=1)
    ap.add_argument("--heartbeat", type=float, default=1.0)
    ap.add_argument("--objectstore", choices=("memstore",),
                    default="memstore",
                    help="only memstore is ported; the persistent "
                         "stores are not yet")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the EC codecs run (default: the card)")
    ap.add_argument("--asok-dir", default=None)
    ap.add_argument("--auth", choices=("none", "cephx"), default="none")
    ap.add_argument("--secure", action="store_true")
    ap.add_argument("--mesh-devices", default=None, metavar="SxD|N",
                    help="enable the multichip EC mesh plane on this "
                         "host: 'SHARDxDATA' shape, a device count, "
                         "or '' for all visible devices")
    ap.add_argument("--keyring-out", default=None,
                    help="write the client keyring here (cephx)")
    args = ap.parse_args(argv)
    cluster = Cluster(args.osds, heartbeat_interval=args.heartbeat,
                      asok_dir=args.asok_dir,
                      objectstore=args.objectstore, n_mons=args.mons,
                      auth=args.auth, secure=args.secure,
                      mesh_devices=args.mesh_devices,
                      device=args.device).start()
    if args.auth == "cephx" and args.keyring_out:
        cluster.keyring.save(args.keyring_out)
        print(f"keyring written to {args.keyring_out}", flush=True)
    print(f"mon at {cluster.mon.addr}; {args.mons} mons, "
          f"{args.osds} osds up on {args.device}; Ctrl-C to stop",
          flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        cluster.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
