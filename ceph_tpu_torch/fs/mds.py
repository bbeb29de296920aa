"""MDS: the metadata server daemon.

Re-expresses the reference src/mds/ at the fidelity the namespace
needs (MDSRank dispatch of MClientRequest -> Server::handle_client_*,
src/mds/Server.cc):

- The namespace lives in a METADATA POOL: one directory object per
  directory inode ("dir.<ino>"), entries maintained server-side by the
  generic directory object class (reference CDir dirfrags as omap
  objects; cls-side updates make each dentry mutation atomic).  Child
  inode attributes are EMBEDDED in the parent's dentry (reference
  stores inodes in dentries the same way — no separate inode objects
  on the common path).
- File data is NOT proxied: clients write striped blocks straight to
  the data pool; the MDS only records size/mtime reported back by the
  client (the reduced form of the reference's client-caps size
  recall).
- Inode numbers come from a persisted allocator object (reference
  InoTable).
- Multi-step mutations (mkdir/unlink/rmdir/rename) journal a redo
  INTENT to the MDLog before touching directory objects and replay it
  on restart (reference MDLog + journal/; see mdlog.py) — an MDS
  killed mid-rename comes back to a consistent namespace.
- FS snapshots (reference SnapServer + the .snap virtual directory,
  reduced): snapshotting a directory allocates a RADOS selfmanaged
  snap id for the data pool — file DATA is COW'd by the OSDs at zero
  copy cost, exactly like RBD snapshots — and records an EAGER copy of
  the subtree namespace in a snap registry object (the reference COWs
  dentries lazily; eager manifest is the reduced form, O(subtree) at
  snap time).  Clients learn the new SnapContext through an MClientCaps
  "snapc" broadcast so subsequent writes clone; reads under
  path/.snap/<name>/... resolve against the manifest at the recorded
  snap id.  In-flight writes racing the broadcast land pre-snap
  (documented reduction of the reference's cap-revoke quiesce).
- File capabilities (reference Locker.h / Capability.h, reduced):
  open grants caps per (ino, session) — "r"ead, "w"rite, and "c"ache
  (the right to cache attrs and buffer size updates client-side,
  granted only to a SOLE opener).  A second client opening the same
  inode triggers revocation: the MDS sends MClientCaps revoke, the
  holder flushes dirty size/mtime and acks (op cap_flush), and only
  then is the new open granted — so contending clients always observe
  each other's flushed state.

Locking: each active MDS owns the subtrees the SUBTREE MAP assigns it
(reference MDSRank auth + subtree partitioning); within a rank,
per-directory striped locks serialize multi-step ops (rename takes
both directory locks in ino order).

Multi-MDS (reference Migrator.cc / MDBalancer, idiomatically reduced):
because dirfrags live IN RADOS (not in MDS memory), migrating a subtree
moves AUTHORITY, not metadata — export freezes the subtree (EAGAIN to
clients, who retry), flushes/revokes client caps under it, then commits
ONE atomic subtree-map update; the importer has nothing to import.  A
donor crash mid-export recovers from its mdlog intent: the map update
is the commit point, so the export either happened or it didn't.
Clients reaching the wrong rank get a redirect with the owner's addr
(reference forward/auth hints).  Rank failover: a surviving MDS
`mds_takeover`s a dead peer — probes its address, replays the peer's
pending mdlog intents, and adopts its subtrees in the map.
"""

from __future__ import annotations

import errno
import json
import threading
import time

from ..msg import Messenger
from ..msg import messages as M
from ..rados.client import RadosError

META_POOL = "cephfs_metadata"
DATA_POOL = "cephfs_data"
ROOT_INO = 1
INOTABLE_OBJ = "mds_inotable"
SNAP_REGISTRY = "mds_snaptable"
SUBTREE_OBJ = "mds_subtreemap"

S_IFDIR = 0o040000
S_IFREG = 0o100000


def data_oid(ino: int, block: int) -> str:
    """reference file layout object naming: <ino hex>.<block hex>."""
    return f"{ino:016x}.{block:08x}"


class MDSDaemon:
    def __init__(self, mon_addr, addr=("127.0.0.1", 0),
                 block_size: int = 1 << 22, auth=None,
                 secure: bool = False, ec_profile: str | None = None,
                 pg_num: int = 8, name: str = "a",
                 fs_name: str = "cephfs"):
        from ..rados import RadosClient
        self.block_size = block_size
        self.name = name
        self.fs_name = fs_name
        self.client = RadosClient(mon_addr, "mds", auth=auth,
                                  secure=secure).connect()
        self._ensure_pools(ec_profile, pg_num)
        self.meta = self.client.open_ioctx(META_POOL)
        self.data = self.client.open_ioctx(DATA_POOL)
        self._locks = [threading.Lock() for _ in range(64)]
        self._ino_lock = threading.Lock()
        self._mkfs()
        # capability + snapshot state first: mdlog replay may purge
        # data, which consults the snapc (reference Locker/Capability,
        # SnapServer — both reduced)
        self._sessions: dict[str, object] = {}      # client id -> conn
        self._caps: dict[int, dict[str, str]] = {}  # ino -> {sess: caps}
        self._cap_lock = threading.Lock()
        self._cap_seq = 0
        self._snapc_cache: list | None = None
        self._snap_epoch = 0
        self._flush_waiters: dict[tuple, threading.Event] = {}
        # multi-MDS state: subtree authority + migration freezes —
        # initialized BEFORE the mdlog replay, whose rename_cross
        # handler consults the fsmap/peer machinery
        self.rank = name
        # frozen prefixes: an immutable snapshot REPLACED on change, so
        # gate reads never race an in-place mutation from the export
        # thread
        self._frozen: frozenset[str] = frozenset()
        self._subtree_cache: tuple[float, dict] | None = None
        self._fsmap_cache: tuple[float, dict] | None = None
        self._probe_cache: dict[str, tuple[float, bool]] = {}
        self._takeover_lock = threading.Lock()
        self._inflight = 0                   # gated path-ops in flight
        self._inflight_lock = threading.Lock()
        self._peer_tid = 0                   # MDS->MDS slave requests
        self._peer_waiters: dict[int, dict] = {}
        self.ops_served = 0                  # observability (tests)
        from .mdlog import MDLog
        # log keyed by MDS name: a restart under the same name replays
        # its own intents; a concurrently-booted second MDS must NOT
        # replay (and delete) a live peer's in-flight intents.  A DEAD
        # peer's log is replayed by whoever runs mds_takeover.
        self.mdlog = MDLog(self.meta, rank=name)
        self._replay_mdlog()
        self._bootstrap_subtree_map()
        self.messenger = Messenger("mds", auth=auth, secure=secure)
        self.messenger.add_dispatcher(self._dispatch)
        self.addr = self.messenger.bind(addr)
        self._register_fsmap()

    def _register_fsmap(self) -> None:
        """Put this filesystem + MDS into the mon's replicated fsmap
        (reference MDSMonitor: an MDS exists only through the FSMap).
        Best-effort: a mon predating the fs commands must not block
        the data path."""
        try:
            r, _ = self.client.mon_command({
                "prefix": "fs new", "name": self.fs_name,
                "metadata_pool": META_POOL, "data_pool": DATA_POOL})
            import errno as _e
            if r not in (0, -_e.EEXIST):
                return
            self.client.mon_command({
                "prefix": "mds boot", "name": self.name,
                "fs": self.fs_name, "addr": list(self.addr)})
        except Exception:  # noqa: BLE001
            pass

    def shutdown(self) -> None:
        self.messenger.shutdown()
        self.client.shutdown()

    def _ensure_pools(self, ec_profile, pg_num) -> None:
        for name, kind in ((META_POOL, "replicated"),
                           (DATA_POOL,
                            "erasure" if ec_profile else "replicated")):
            try:
                kw = {"pg_num": pg_num}
                if kind == "erasure":
                    kw["erasure_code_profile"] = ec_profile
                else:
                    kw["size"] = 2
                self.client.create_pool(name, kind, **kw)
            except RadosError as e:
                if e.errno != errno.EEXIST:
                    raise

    def _mkfs(self) -> None:
        """Create the root directory + inode table if absent."""
        self.meta.execute(f"dir.{ROOT_INO:x}", "rgw", "dir_init", b"")
        try:
            raw = self.meta.read(INOTABLE_OBJ, 0)
        except RadosError:
            raw = b""
        if raw:
            self._next_ino = json.loads(raw.decode())["next"]
        else:
            self._next_ino = ROOT_INO + 1
            self._persist_inotable()

    def _persist_inotable(self) -> None:
        self.meta.write_full(INOTABLE_OBJ, json.dumps(
            {"next": self._next_ino}).encode())

    def _alloc_ino(self) -> int:
        with self._ino_lock:
            ino = self._next_ino
            self._next_ino += 1
            self._persist_inotable()
            return ino

    # -- dir object helpers --------------------------------------------------

    def _dir_lock(self, ino: int) -> threading.Lock:
        return self._locks[ino % len(self._locks)]

    def _dget(self, dino: int, name: str) -> dict | None:
        try:
            raw = self.meta.execute(
                f"dir.{dino:x}", "rgw", "dir_get",
                json.dumps({"key": name}).encode())
        except RadosError as e:
            if e.errno == errno.ENOENT:
                return None
            raise
        return json.loads(raw.decode())

    def _dset(self, dino: int, name: str, ent: dict) -> None:
        self.meta.execute(f"dir.{dino:x}", "rgw", "dir_add",
                          json.dumps({"key": name, "meta": ent}).encode())

    def _drm(self, dino: int, name: str) -> None:
        self.meta.execute(f"dir.{dino:x}", "rgw", "dir_rm",
                          json.dumps({"key": name}).encode())

    def _dlist(self, dino: int) -> list:
        raw = self.meta.execute(
            f"dir.{dino:x}", "rgw", "dir_list",
            json.dumps({"max": 100000}).encode())
        return json.loads(raw.decode())["entries"]

    def _dcount(self, dino: int) -> int:
        return int(self.meta.execute(f"dir.{dino:x}", "rgw",
                                     "dir_count", b""))

    # -- subtree authority (reference MDCache subtree map + Migrator) -------

    @staticmethod
    def _norm(path: str) -> str:
        parts = [p for p in path.split("/") if p]
        return "/" + "/".join(parts)

    def _bootstrap_subtree_map(self) -> None:
        """First active MDS claims the root subtree.  (A simultaneous
        first-boot of two MDSes could race the claim; deployments boot
        rank 0 first, like the reference's rank-0 creation.)"""
        self.meta.execute(SUBTREE_OBJ, "rgw", "dir_init", b"")
        try:
            self.meta.execute(SUBTREE_OBJ, "rgw", "dir_get",
                              json.dumps({"key": "/"}).encode())
        except RadosError:
            self.meta.execute(SUBTREE_OBJ, "rgw", "dir_add", json.dumps(
                {"key": "/", "meta": {"rank": self.rank}}).encode())

    def _load_subtrees(self, force: bool = False) -> dict[str, str]:
        now = time.time()
        if not force and self._subtree_cache is not None and \
                now - self._subtree_cache[0] < 1.0:
            return self._subtree_cache[1]
        raw = self.meta.execute(SUBTREE_OBJ, "rgw", "dir_list",
                                json.dumps({"max": 10000}).encode())
        m = {k: v["rank"]
             for k, v in json.loads(raw.decode())["entries"]}
        self._subtree_cache = (now, m)
        return m

    def _authority(self, path: str) -> str:
        """Longest-prefix owner of `path`.  "mine" from a fresh-enough
        cache is trustworthy (this rank updates its own cache
        synchronously when it exports); "not mine" forces a refresh
        before redirecting, so an importer serves as soon as the map
        commits."""
        path = self._norm(path)

        def owner_in(m):
            best, best_len = None, -1
            for prefix, rank in m.items():
                p = prefix.rstrip("/") or "/"
                if (path == p or path.startswith(p + "/") or
                        p == "/") and len(p) > best_len:
                    best, best_len = rank, len(p)
            return best

        owner = owner_in(self._load_subtrees())
        if owner != self.rank:
            owner = owner_in(self._load_subtrees(force=True))
        return owner

    def _fs_mds_map(self, force: bool = False) -> dict:
        now = time.time()
        if not force and self._fsmap_cache is not None and \
                now - self._fsmap_cache[0] < 2.0:
            return self._fsmap_cache[1]
        try:
            _r, out = self.client.mon_command({"prefix": "fs dump"})
            m = out["filesystems"].get(self.fs_name, {}).get("mds", {})
        except Exception:  # noqa: BLE001 - mon electing
            m = (self._fsmap_cache or (0, {}))[1]
        self._fsmap_cache = (now, m)
        return m

    def _mds_addr(self, rank: str,
                  force: bool = False) -> tuple | None:
        ent = self._fs_mds_map(force).get(rank)
        if ent and ent.get("addr"):
            return tuple(ent["addr"])
        return None

    def _peer_alive(self, rank: str, addr: tuple) -> bool:
        import socket
        now = time.time()
        hit = self._probe_cache.get(rank)
        if hit is not None and now - hit[0] < 2.0:
            return hit[1]
        try:
            with socket.create_connection(tuple(addr), timeout=0.5):
                alive = True
        except OSError:
            alive = False
        self._probe_cache[rank] = (now, alive)
        return alive

    def _authority_gate(self, path: str,
                        allow_foreign: bool = False) -> str | None:
        owner = self._authority(path)
        if owner == self.rank or owner is None:
            return None
        if allow_foreign:
            return owner
        addr = self._mds_addr(owner) or self._mds_addr(owner,
                                                       force=True)
        if addr is not None and self._peer_alive(owner, addr):
            raise _Redirect(owner, addr)
        # recorded owner is dead or unknown: adopt its subtrees and
        # serve (auto-failover; the reference drives this from mon
        # beacons + standby promotion — the probe+takeover form is the
        # reduced single-host equivalent, split-brain caveat documented
        # in _handle_takeover)
        self._handle_takeover({"rank": owner, "force": True})

    def _frozen_gate(self, path: str) -> None:
        path = self._norm(path)
        for fz in self._frozen:
            if path == fz or path.startswith(fz + "/") or fz == "/":
                raise _Err(errno.EAGAIN, f"subtree {fz} migrating")

    def _subtree_inos(self, dino: int) -> list[int]:
        out = [dino]
        for name, ent in self._dlist(dino):
            if name.startswith("@"):
                continue
            if ent.get("mode", 0) & S_IFDIR:
                out.extend(self._subtree_inos(ent["ino"]))
            else:
                out.append(ent["ino"])
        return out

    def _handle_export_dir(self, a: dict) -> dict:
        """Migrate authority over a subtree to another rank (reference
        Migrator::export_dir, collapsed to an authority hand-off —
        see the module docstring).  `hold_s` is a test hook that holds
        the freeze window open."""
        path = self._norm(a["path"])
        to = a["to"]
        if self._authority(path) != self.rank:
            raise _Err(errno.EINVAL, f"{path} not owned by this rank")
        if to != self.rank and self._mds_addr(to, force=True) is None:
            raise _Err(errno.ENOENT, f"no such mds {to!r}")
        _, ent = self._resolve(path)
        if not ent["mode"] & S_IFDIR:
            raise _Err(errno.ENOTDIR, path)
        ev = {"op": "export", "path": path, "to": to}
        seq = self.mdlog.append(ev)
        with self._inflight_lock:        # RMW of the snapshot is
            self._frozen = self._frozen | {path}   # serialized
        # drain: ops admitted BEFORE the freeze may still be mutating
        # the subtree; the map must not commit under their feet
        # (reference Migrator waits for in-flight requests)
        deadline = time.time() + 10.0
        while self._inflight > 0 and time.time() < deadline:
            time.sleep(0.02)
        try:
            # cap migration, reduced: flush + revoke every cap under
            # the subtree so dirty state reaches the shared pool before
            # authority moves; clients re-open against the new owner
            # on their next op (via redirect)
            for ino in self._subtree_inos(ent["ino"]):
                with self._cap_lock:
                    holders = list(self._caps.get(ino, {}))
                for sess in holders:
                    with self._cap_lock:
                        self._cap_seq += 1
                        seq_r = self._cap_seq
                    self._revoke(sess, ino, "", seq_r)
            if a.get("hold_s"):
                time.sleep(float(a["hold_s"]))
            # THE commit point: one atomic map update
            self.meta.execute(SUBTREE_OBJ, "rgw", "dir_add", json.dumps(
                {"key": path, "meta": {"rank": to}}).encode())
            self._subtree_cache = None
        finally:
            with self._inflight_lock:
                self._frozen = self._frozen - {path}
        self.mdlog.mark_done(seq)
        return {"exported": path, "to": to}

    def _handle_takeover(self, a: dict) -> dict:
        """Adopt a dead peer's subtrees + replay its pending mdlog
        intents (rank failover; reference standby takeover +
        MDCache::resolve).  force=True skips the liveness probe — the
        probe guards the common case, but a partitioned-yet-alive peer
        could still be usurped (the reference closes this with mon
        fencing/blacklist; documented reduction)."""
        peer = a["rank"]
        if peer == self.rank:
            raise _Err(errno.EINVAL, "cannot take over self")
        addr = self._mds_addr(peer, force=True)
        if addr is not None and not a.get("force"):
            import socket
            try:
                with socket.create_connection(addr, timeout=1.0):
                    raise _Err(errno.EBUSY, f"mds {peer} is alive")
            except OSError:
                pass              # unreachable: proceed
        from .mdlog import MDLog
        with self._takeover_lock:
            peer_log = MDLog(self.meta, rank=peer)
            replayed = 0
            for seq, ev in peer_log.pending():
                self._apply_event(ev)
                peer_log.mark_done(seq)
                replayed += 1
            adopted = []
            for prefix, owner in self._load_subtrees(
                    force=True).items():
                if owner == peer:
                    self.meta.execute(
                        SUBTREE_OBJ, "rgw", "dir_add", json.dumps(
                            {"key": prefix,
                             "meta": {"rank": self.rank}}).encode())
                    adopted.append(prefix)
            self._subtree_cache = None
            return {"adopted": adopted, "replayed": replayed}

    # -- MDS-to-MDS slave requests (reference Server slave ops /
    #    Migrator peer messages, reduced) ------------------------------------

    def _peer_request(self, rank: str, op: str, args: dict,
                      timeout: float = 10.0) -> dict:
        addr = self._mds_addr(rank) or self._mds_addr(rank, force=True)
        if addr is None:
            raise _Err(errno.EIO, f"peer mds {rank} unknown")
        conn = self.messenger.connect(tuple(addr))
        with self._inflight_lock:
            self._peer_tid += 1
            tid = self._peer_tid
            w = {"event": threading.Event(), "reply": None}
            self._peer_waiters[tid] = w
        conn.send_message(M.MClientRequest(op, args, tid))
        if not w["event"].wait(timeout):
            with self._inflight_lock:
                self._peer_waiters.pop(tid, None)
            raise _Err(errno.EIO, f"peer mds {rank} timed out")
        r = w["reply"]
        if r.result != 0:
            raise _Err(-r.result, f"peer {op}: {r.out.get('error')}")
        return r.out

    def _handle_peer_drm(self, a: dict) -> dict:
        """Slave half of a cross-rank rename: remove a dentry from a
        dirfrag THIS rank owns, on behalf of the dst owner.  Guarded by
        the expected ino so a racing local mutation is never clobbered
        (reference rmdir/rename witness ops)."""
        dino, name = a["dino"], a["name"]
        with self._dir_lock(dino):
            cur = self._dget(dino, name)
            if cur is not None and cur["ino"] == a["ino"]:
                self._drm(dino, name)
        return {}

    def _rename_cross(self, a: dict, src_owner: str) -> dict:
        """Cross-rank rename: this rank owns dst; the src dentry is
        removed THROUGH its owner.  The intent is journaled here, so a
        crash between the local link and the peer removal replays to
        completion — never a doubled entry that stays.

        Lock order: the dst dir lock covers ONLY the journal append and
        the local dst link; the peer_drm call runs after it is
        released.  Holding it across the peer request inverted the
        distributed lock order — two opposite-direction cross-rank
        renames each held their own dst dir lock while the peer's
        handler blocked on taking it, stalling both until the 10s peer
        timeout.  Releasing first is safe: the journaled intent already
        commits the rename, and _handle_peer_drm is ino-guarded, so a
        racing local mutation of the src dentry is never clobbered."""
        sdino, sname = self._split(a["src"])
        ddino, dname = self._split(a["dst"])
        with self._dir_lock(ddino):
            ent = self._dget(sdino, sname)   # read-only peek is safe
            if ent is None:
                raise _Err(errno.ENOENT, a["src"])
            existing = self._dget(ddino, dname)
            replaced = None
            if existing is not None:
                if existing["mode"] & S_IFDIR:
                    raise _Err(errno.EISDIR, a["dst"])
                if existing["ino"] != ent["ino"]:
                    replaced = existing
            ev = {"op": "rename_cross", "sdino": sdino, "sname": sname,
                  "ddino": ddino, "dname": dname, "ent": ent,
                  "replaced": replaced, "src_owner": src_owner}
            seq = self.mdlog.append(ev)
            self._dset(ddino, dname, ent)
        # if the peer call fails the intent stays pending and the
        # removal completes on replay/takeover
        self._peer_request(src_owner, "peer_drm", {
            "dino": sdino, "name": sname, "ino": ent["ino"]})
        if replaced is not None:
            self._purge_data(replaced)
        self.mdlog.mark_done(seq)
        return {}

    # -- path walking (reference Server::rdlock_path_pin_ref) ---------------

    def _resolve(self, path: str) -> tuple[int, dict]:
        """Path -> (parent dir ino of the LAST component, entry dict of
        the full path).  Root resolves to a synthetic dir entry."""
        parts = [p for p in path.split("/") if p]
        cur = {"ino": ROOT_INO, "mode": S_IFDIR, "size": 0, "mtime": 0}
        dino = ROOT_INO
        for i, name in enumerate(parts):
            if not cur["mode"] & S_IFDIR:
                raise _Err(errno.ENOTDIR, "/".join(parts[:i]))
            dino = cur["ino"]
            ent = self._dget(dino, name)
            if ent is None:
                raise _Err(errno.ENOENT, "/".join(parts[: i + 1]))
            cur = ent
        return dino, cur

    def _split(self, path: str) -> tuple[int, str]:
        """Path -> (parent dir ino, last component); parent must be an
        existing directory."""
        parts = [p for p in path.split("/") if p]
        if not parts:
            raise _Err(errno.EINVAL, "empty path")
        _, parent = self._resolve("/".join(parts[:-1]))
        if not parent["mode"] & S_IFDIR:
            raise _Err(errno.ENOTDIR, path)
        return parent["ino"], parts[-1]

    # -- dispatch ------------------------------------------------------------

    def _dispatch(self, conn, msg) -> None:
        if isinstance(msg, M.MClientReply):
            # reply to one of OUR slave requests to a peer MDS
            with self._inflight_lock:
                w = self._peer_waiters.pop(msg.tid, None)
            if w is not None:
                w["reply"] = msg
                w["event"].set()
            return
        if not isinstance(msg, M.MClientRequest):
            return
        try:
            out = self._handle(msg.op, msg.args, conn)
            conn.send_message(M.MClientReply(msg.tid, 0, out))
        except _Redirect as r:
            conn.send_message(M.MClientReply(
                msg.tid, -errno.ESTALE,
                {"redirect_rank": r.rank,
                 "redirect_addr": list(r.addr)}))
        except _Err as e:
            conn.send_message(M.MClientReply(msg.tid, -e.errno,
                                             {"error": str(e)}))
        except RadosError as e:
            conn.send_message(M.MClientReply(msg.tid, -e.errno,
                                             {"error": str(e)}))
        except Exception as e:  # noqa: BLE001 - daemon must not die
            conn.send_message(M.MClientReply(
                msg.tid, -errno.EIO, {"error": repr(e)}))

    PATH_OPS = frozenset({
        "open", "stat", "mkdir", "create", "readdir", "setattr",
        "unlink", "rmdir", "snap_create", "snap_rm", "snap_list",
        "snap_resolve", "export_dir"})

    def _handle(self, op: str, a: dict, conn=None) -> dict:
        if op in self.PATH_OPS or op == "rename":
            # subtree authority first (redirect to the owner), then the
            # migration freeze (EAGAIN: retry until authority settles).
            # Rename gates BOTH paths; a foreign SRC does not redirect —
            # the dst owner executes and removes the foreign dentry
            # through the src owner (peer_drm), so no rank ever mutates
            # a dirfrag it does not own.
            paths = ([a["dst"], a["src"]] if op == "rename"
                     else [a["path"]])
            if op == "export_dir":      # the drainer itself is not
                self._authority_gate(a["path"])          # counted
                self._frozen_gate(a["path"])
                self.ops_served += 1
                return self._handle_gated(op, a, conn)
            # register in-flight BEFORE the freeze check: an op that
            # passed the gate must already be visible to the export
            # drain loop, or the map could commit under its feet
            with self._inflight_lock:
                self._inflight += 1
            try:
                for p in paths:
                    self._authority_gate(p, allow_foreign=(
                        op == "rename" and p == a.get("src")))
                    self._frozen_gate(p)
                self.ops_served += 1
                return self._handle_gated(op, a, conn)
            finally:
                with self._inflight_lock:
                    self._inflight -= 1
        return self._handle_gated(op, a, conn)

    def _handle_gated(self, op: str, a: dict, conn=None) -> dict:
        if op == "export_dir":
            # gated above: only the subtree's owner reaches here
            return self._handle_export_dir(a)
        if op == "peer_drm":
            return self._handle_peer_drm(a)
        if op == "mds_takeover":
            return self._handle_takeover(a)
        if op == "subtree_map":
            return {"map": self._load_subtrees(force=True)}
        if op == "mount":
            sess = a.get("client")
            if sess:
                with self._cap_lock:
                    self._sessions[sess] = conn
            with self._cap_lock:
                epoch = self._snap_epoch
            return {"block_size": self.block_size,
                    "data_pool": DATA_POOL, "root": ROOT_INO,
                    "snapc": self._fs_snapc(), "snap_epoch": epoch}
        if op == "open":
            return self._handle_open(a)
        if op == "snap_create":
            return self._handle_snap_create(a)
        if op == "snap_rm":
            return self._handle_snap_rm(a)
        if op == "snap_list":
            _, ent = self._resolve(a["path"])
            rows = self._snap_rows(ent["ino"])
            return {"snaps": sorted(rows)}
        if op == "snap_resolve":
            return self._handle_snap_resolve(a)
        if op == "cap_flush":
            return self._handle_cap_flush(a)
        if op == "cap_release":
            with self._cap_lock:
                holders = self._caps.get(a["ino"], {})
                holders.pop(a.get("client", ""), None)
                if not holders:
                    self._caps.pop(a["ino"], None)
            return {}
        if op == "stat":
            _, ent = self._resolve(a["path"])
            return {"ent": ent}
        if op == "mkdir":
            dino, name = self._split(a["path"])
            with self._dir_lock(dino):
                if self._dget(dino, name) is not None:
                    raise _Err(errno.EEXIST, a["path"])
                ino = self._alloc_ino()
                ent = {"ino": ino, "mode": S_IFDIR | 0o755, "size": 0,
                       "mtime": time.time()}
                ev = {"op": "mkdir", "dino": dino, "name": name,
                      "ent": ent}
                seq = self.mdlog.append(ev)
                try:
                    self.meta.execute(f"dir.{ino:x}", "rgw",
                                      "dir_init", b"")
                    self._dset(dino, name, ent)
                except Exception:
                    self._finish_event(seq, ev)
                    raise
                self.mdlog.mark_done(seq)
            return {"ino": ino}
        if op == "create":
            dino, name = self._split(a["path"])
            with self._dir_lock(dino):
                ent = self._dget(dino, name)
                if ent is not None:
                    if ent["mode"] & S_IFDIR:
                        raise _Err(errno.EISDIR, a["path"])
                    if a.get("excl"):
                        raise _Err(errno.EEXIST, a["path"])
                    return {"ent": ent}
                ino = self._alloc_ino()
                ent = {"ino": ino, "mode": S_IFREG | 0o644, "size": 0,
                       "mtime": time.time()}
                self._dset(dino, name, ent)
            return {"ent": ent}
        if op == "readdir":
            _, ent = self._resolve(a["path"])
            if not ent["mode"] & S_IFDIR:
                raise _Err(errno.ENOTDIR, a["path"])
            return {"entries": self._dlist(ent["ino"])}
        if op == "setattr":
            # client reports size/mtime after data writes (the reduced
            # form of cap recall; reference Server::handle_client_setattr)
            dino, name = self._split(a["path"])
            with self._dir_lock(dino):
                ent = self._dget(dino, name)
                if ent is None:
                    raise _Err(errno.ENOENT, a["path"])
                if not self._attr_apply(ent, a):
                    return {"ent": ent}
                self._dset(dino, name, ent)
            return {"ent": ent}
        if op == "unlink":
            dino, name = self._split(a["path"])
            with self._dir_lock(dino):
                ent = self._dget(dino, name)
                if ent is None:
                    raise _Err(errno.ENOENT, a["path"])
                if ent["mode"] & S_IFDIR:
                    raise _Err(errno.EISDIR, a["path"])
                ev = {"op": "unlink", "dino": dino, "name": name,
                      "ent": ent}
                seq = self.mdlog.append(ev)
                try:
                    self._drm(dino, name)
                except Exception:
                    self._finish_event(seq, ev)
                    raise
            self._purge_data(ent)
            self.mdlog.mark_done(seq)
            return {}
        if op == "rmdir":
            dino, name = self._split(a["path"])
            # lock BOTH the parent's stripe and the victim dir's own
            # stripe: the emptiness check must exclude a concurrent
            # create inside the victim.  The ino is read before
            # locking, so re-verify it under the locks (the dentry may
            # have been replaced) and retry with the fresh ino.
            for _ in range(8):
                ent = self._dget(dino, name)
                if ent is None:
                    raise _Err(errno.ENOENT, a["path"])
                with self._multi_lock(dino, ent["ino"]):
                    cur = self._dget(dino, name)
                    if cur is None:
                        raise _Err(errno.ENOENT, a["path"])
                    if cur["ino"] != ent["ino"]:
                        continue   # replaced meanwhile: retry
                    if not cur["mode"] & S_IFDIR:
                        raise _Err(errno.ENOTDIR, a["path"])
                    if self._dcount(cur["ino"]) > 0:
                        raise _Err(errno.ENOTEMPTY, a["path"])
                    ev = {"op": "rmdir", "dino": dino, "name": name,
                          "ino": cur["ino"]}
                    seq = self.mdlog.append(ev)
                    try:
                        self._drm(dino, name)
                        try:
                            self.meta.remove(f"dir.{cur['ino']:x}")
                        except RadosError:
                            pass
                    except Exception:
                        self._finish_event(seq, ev)
                        raise
                    self.mdlog.mark_done(seq)
                return {}
            raise _Err(errno.EAGAIN, a["path"])
        if op == "rename":
            src_owner = self._authority(a["src"])
            if src_owner not in (None, self.rank):
                return self._rename_cross(a, src_owner)
            sdino, sname = self._split(a["src"])
            ddino, dname = self._split(a["dst"])
            if (sdino, sname) == (ddino, dname):
                if self._dget(sdino, sname) is None:
                    raise _Err(errno.ENOENT, a["src"])
                return {}   # POSIX: rename to itself is a no-op
            replaced = None
            with self._multi_lock(sdino, ddino):
                ent = self._dget(sdino, sname)
                if ent is None:
                    raise _Err(errno.ENOENT, a["src"])
                existing = self._dget(ddino, dname)
                if existing is not None:
                    if existing["mode"] & S_IFDIR:
                        raise _Err(errno.EISDIR, a["dst"])
                    if existing["ino"] != ent["ino"]:
                        replaced = existing
                ev = {"op": "rename", "sdino": sdino, "sname": sname,
                      "ddino": ddino, "dname": dname, "ent": ent,
                      "replaced": replaced}
                seq = self.mdlog.append(ev)
                try:
                    self._dset(ddino, dname, ent)
                    self._drm(sdino, sname)
                except Exception:
                    self._finish_event(seq, ev)
                    raise
            if replaced is not None:
                # the displaced file's inode lost its last link: purge
                # its data like unlink would (reference purge queue)
                self._purge_data(replaced)
            self.mdlog.mark_done(seq)
            return {}
        raise _Err(errno.EOPNOTSUPP, op)

    # -- FS snapshots (reference SnapServer / .snap, reduced) ---------------

    def _snap_rows(self, dino: int) -> dict[str, dict]:
        """Registry rows for one directory: small (snapid/created),
        the manifest lives in its own object."""
        try:
            raw = self.meta.execute(
                SNAP_REGISTRY, "rgw", "dir_list",
                json.dumps({"prefix": f"{dino:x}/",
                            "max": 10000}).encode())
        except RadosError as e:
            if e.errno == errno.ENOENT:
                return {}        # registry never created: no snaps
            raise                # cluster fault != "no snapshots"
        out = json.loads(raw.decode())
        if out["truncated"]:
            raise RadosError(errno.EIO,
                             "snap registry exceeds one page")
        return {k.split("/", 1)[1]: m for k, m in out["entries"]}

    @staticmethod
    def _manifest_oid(dino: int, name: str) -> str:
        return f"snapmanifest.{dino:x}.{name}"

    def _collect_subtree(self, dino: int, rel: str = "") -> dict:
        """Eager namespace manifest: relpath -> entry, recursively."""
        manifest: dict[str, dict] = {}
        for name, ent in self._dlist(dino):
            path = f"{rel}{name}"
            manifest[path] = ent
            if ent["mode"] & S_IFDIR:
                manifest.update(
                    self._collect_subtree(ent["ino"], f"{path}/"))
        return manifest

    def _fs_snapc(self) -> list:
        """[seq, [ids desc]] across every live snapshot (one data pool
        -> one SnapContext, like the reference's global snap realm).
        Cached; snap_create/rm invalidate.  A registry READ FAULT must
        raise, never degrade to "no snapshots" — a purge under an
        empty snapc destroys snapshot data."""
        with self._cap_lock:
            if self._snapc_cache is not None:
                return list(self._snapc_cache)
            epoch_at_read = self._snap_epoch
        ids = []
        try:
            raw = self.meta.execute(
                SNAP_REGISTRY, "rgw", "dir_list",
                json.dumps({"max": 10000}).encode())
            out = json.loads(raw.decode())
            if out["truncated"]:
                # a snapc missing ids silently destroys those
                # snapshots on the next purge — refuse instead
                raise RadosError(errno.EIO,
                                 "snap registry exceeds one page")
            for _k, m in out["entries"]:
                ids.append(int(m["snapid"]))
        except RadosError as e:
            if e.errno != errno.ENOENT:
                raise
        ids.sort(reverse=True)
        snapc = [ids[0] if ids else 0, ids]
        with self._cap_lock:
            # a snap_create/rm racing this read has bumped the epoch:
            # its registry row may be missing from our list, and
            # caching it would pin a stale snapc until the NEXT
            # mutation — only cache what no mutation outran
            if self._snap_epoch == epoch_at_read:
                self._snapc_cache = list(snapc)
        return snapc

    def _snap_mutated(self) -> tuple[list, int]:
        """Invalidate + recompute the snapc and bump the epoch clients
        order their updates by; returns (snapc, epoch)."""
        with self._cap_lock:
            self._snapc_cache = None
            self._snap_epoch += 1
            epoch = self._snap_epoch
        snapc = self._fs_snapc()
        self._broadcast_snapc(snapc, epoch)
        return snapc, epoch

    def _broadcast_snapc(self, snapc: list, epoch: int) -> None:
        payload = json.dumps(snapc)
        with self._cap_lock:
            conns = list(self._sessions.values())
        for conn in conns:
            try:
                conn.send_message(
                    M.MClientCaps("snapc", 0, payload, epoch))
            except Exception:  # noqa: BLE001 - dead session
                pass

    def _handle_snap_create(self, a: dict) -> dict:
        _, ent = self._resolve(a["path"])
        if not ent["mode"] & S_IFDIR:
            raise _Err(errno.ENOTDIR, a["path"])
        dino = ent["ino"]
        if a["name"] in self._snap_rows(dino):
            raise _Err(errno.EEXIST, a["name"])
        snapid = self.data.selfmanaged_snap_create()
        manifest = self._collect_subtree(dino)
        # manifest first (its own object: registry rows stay tiny),
        # then the registry row that makes the snapshot visible
        self.meta.write_full(
            self._manifest_oid(dino, a["name"]),
            json.dumps(manifest, separators=(",", ":")).encode())
        self.meta.execute(SNAP_REGISTRY, "rgw", "dir_add", json.dumps({
            "key": f"{dino:x}/{a['name']}",
            "meta": {"snapid": snapid,
                     "created": time.time()}}).encode())
        snapc, epoch = self._snap_mutated()
        return {"snapid": snapid, "snapc": snapc, "snap_epoch": epoch}

    def _handle_snap_rm(self, a: dict) -> dict:
        _, ent = self._resolve(a["path"])
        rows = self._snap_rows(ent["ino"])
        row = rows.get(a["name"])
        if row is None:
            raise _Err(errno.ENOENT, a["name"])
        self.meta.execute(SNAP_REGISTRY, "rgw", "dir_rm", json.dumps({
            "key": f"{ent['ino']:x}/{a['name']}"}).encode())
        try:
            self.meta.remove(self._manifest_oid(ent["ino"], a["name"]))
        except RadosError:
            pass
        # let the OSD snap trimmer reclaim the clones
        try:
            self.data.selfmanaged_snap_remove(int(row["snapid"]))
        except RadosError:
            pass   # advisory; trim just won't run for this id yet
        snapc, epoch = self._snap_mutated()
        return {"snapc": snapc, "snap_epoch": epoch}

    def _handle_snap_resolve(self, a: dict) -> dict:
        """path/.snap/<name>/<rel> -> (ent at snap time, snapid).
        rel='' names the snapshotted dir itself; 'entries' lists one
        level of the manifest for readdir."""
        _, ent = self._resolve(a["path"])
        rows = self._snap_rows(ent["ino"])
        row = rows.get(a["name"])
        if row is None:
            raise _Err(errno.ENOENT, f".snap/{a['name']}")
        rel = a.get("rel", "").strip("/")
        manifest = json.loads(self.meta.read(
            self._manifest_oid(ent["ino"], a["name"]), 0).decode())
        if rel:
            target = manifest.get(rel)
            if target is None:
                raise _Err(errno.ENOENT, rel)
        else:
            target = {"ino": ent["ino"], "mode": S_IFDIR, "size": 0,
                      "mtime": row["created"]}
        out = {"ent": target, "snapid": int(row["snapid"])}
        if target["mode"] & S_IFDIR:
            pfx = f"{rel}/" if rel else ""
            out["entries"] = sorted(
                (p[len(pfx):], e) for p, e in manifest.items()
                if p.startswith(pfx) and "/" not in p[len(pfx):])
        return out

    # -- capabilities (reference Locker::issue_caps / revoke) ---------------

    def _handle_open(self, a: dict) -> dict:
        """Open with caps: create if asked, then grant "rwc" to a sole
        opener or shared "rw" (revoking other holders' cache cap
        first, waiting for their flush ack)."""
        sess = a.get("client", "")
        want = a.get("want", "r")
        dino, name = self._split(a["path"])
        with self._dir_lock(dino):
            ent = self._dget(dino, name)
            if ent is None:
                if not a.get("create"):
                    raise _Err(errno.ENOENT, a["path"])
                ino = self._alloc_ino()
                ent = {"ino": ino, "mode": S_IFREG | 0o644, "size": 0,
                       "mtime": time.time()}
                ev = {"op": "create", "dino": dino, "name": name,
                      "ent": ent}
                seq = self.mdlog.append(ev)
                try:
                    self._dset(dino, name, ent)
                except Exception:
                    self._finish_event(seq, ev)
                    raise
                self.mdlog.mark_done(seq)
            elif ent["mode"] & S_IFDIR:
                raise _Err(errno.EISDIR, a["path"])
            elif a.get("excl"):
                raise _Err(errno.EEXIST, a["path"])
        ino = ent["ino"]
        # grant outside the dir lock: revocation blocks on other
        # clients' acks
        to_revoke: list[tuple] = []
        with self._cap_lock:
            holders = self._caps.setdefault(ino, {})
            others = [s for s in holders if s != sess]
            grant = want + ("c" if not others else "")
            for s in others:
                if "c" in holders[s]:
                    # drop the cache right: holder must flush first
                    self._cap_seq += 1
                    to_revoke.append((s, holders[s].replace("c", ""),
                                      self._cap_seq))
            holders[sess] = grant
            self._cap_seq += 1
            grant_seq = self._cap_seq
        for s, newcaps, seq in to_revoke:
            self._revoke(s, ino, newcaps, seq)
        # re-read: the flush may have updated size/mtime.  A rename/
        # unlink racing in after the grant means the path no longer
        # names this inode — tell the opener rather than hand back a
        # stale pre-flush size
        ent = self._dget(dino, name)
        if ent is None or ent["ino"] != ino:
            with self._cap_lock:
                self._caps.get(ino, {}).pop(sess, None)
            raise _Err(errno.ENOENT, a["path"])
        return {"ent": ent, "caps": grant, "cap_seq": grant_seq}

    def _revoke(self, sess: str, ino: int, newcaps: str,
                seq: int, timeout: float = 10.0) -> None:
        with self._cap_lock:
            conn = self._sessions.get(sess)
        if conn is None:
            with self._cap_lock:
                self._caps.get(ino, {}).pop(sess, None)
            return
        ev = threading.Event()
        self._flush_waiters[(sess, ino, seq)] = ev
        try:
            conn.send_message(M.MClientCaps("revoke", ino, newcaps, seq))
        except Exception:  # noqa: BLE001 - dead session
            self._flush_waiters.pop((sess, ino, seq), None)
            with self._cap_lock:
                self._caps.get(ino, {}).pop(sess, None)
            return
        if not ev.wait(timeout):
            # unresponsive holder: drop its caps (reference session
            # autoclose on cap revoke timeout)
            with self._cap_lock:
                self._caps.get(ino, {}).pop(sess, None)
        self._flush_waiters.pop((sess, ino, seq), None)

    def _handle_cap_flush(self, a: dict) -> dict:
        """Holder's answer to a revoke (or a voluntary writeback):
        apply flushed attrs, record the reduced caps, wake the
        revoker."""
        if "path" in a and ("size" in a or "mtime" in a):
            try:
                dino, name = self._split(a["path"])
                with self._dir_lock(dino):
                    ent = self._dget(dino, name)
                    if ent is not None and ent["ino"] == a["ino"] and \
                            self._attr_apply(ent, a):
                        self._dset(dino, name, ent)
            except _Err:
                pass   # path raced away; the flush is advisory now
        sess = a.get("client", "")
        with self._cap_lock:
            if a.get("caps"):
                self._caps.setdefault(a["ino"], {})[sess] = a["caps"]
            else:
                self._caps.get(a["ino"], {}).pop(sess, None)
        ev = self._flush_waiters.get((sess, a["ino"], a.get("seq", 0)))
        if ev is not None:
            ev.set()
        return {}

    @staticmethod
    def _attr_apply(ent: dict, a: dict) -> bool:
        """Ordered attr update: each client stamps its setattr/cap_flush
        with a per-client monotonically increasing tick, and an update
        ordered BEFORE the entry's last update from the SAME client is
        dropped (a revoke-time flush racing that client's own later
        write-through).  Wall clocks are never compared across clients
        — different machines' clocks carry no ordering."""
        src = a.get("client")
        tick = a.get("tick")
        if src is not None and tick is not None:
            last = ent.get("attr_src")
            if last and last[0] == src and last[1] >= tick:
                return False
            ent["attr_src"] = [src, tick]
        for k in ("size", "mtime"):
            if k in a:
                ent[k] = a[k]
        return True

    # -- mdlog replay (reference MDLog::replay) ------------------------------

    def _apply_event(self, ev: dict) -> None:
        """Redo one journaled mutation; checks current state first so
        re-applying is idempotent."""
        op = ev["op"]
        if op in ("create", "mkdir"):
            if op == "mkdir":
                self.meta.execute(f"dir.{ev['ent']['ino']:x}",
                                  "rgw", "dir_init", b"")
            if self._dget(ev["dino"], ev["name"]) is None:
                self._dset(ev["dino"], ev["name"], ev["ent"])
        elif op == "unlink":
            cur = self._dget(ev["dino"], ev["name"])
            if cur is not None and cur["ino"] == ev["ent"]["ino"]:
                self._drm(ev["dino"], ev["name"])
            self._purge_data(ev["ent"])
        elif op == "rmdir":
            cur = self._dget(ev["dino"], ev["name"])
            if cur is not None and cur["ino"] == ev["ino"]:
                self._drm(ev["dino"], ev["name"])
            try:
                self.meta.remove(f"dir.{ev['ino']:x}")
            except RadosError:
                pass
        elif op == "rename":
            dst = self._dget(ev["ddino"], ev["dname"])
            if dst is None or dst["ino"] != ev["ent"]["ino"]:
                self._dset(ev["ddino"], ev["dname"], ev["ent"])
            src = self._dget(ev["sdino"], ev["sname"])
            if src is not None and src["ino"] == ev["ent"]["ino"]:
                self._drm(ev["sdino"], ev["sname"])
            if ev.get("replaced"):
                self._purge_data(ev["replaced"])
        elif op == "export":
            # the subtree-map write is the commit point: if it landed,
            # the export completed; if not, authority never moved and
            # there is nothing to roll back (the freeze dies with the
            # crashed process).  Either way the intent just retires.
            pass
        elif op == "rename_cross":
            dst = self._dget(ev["ddino"], ev["dname"])
            if dst is None or dst["ino"] != ev["ent"]["ino"]:
                self._dset(ev["ddino"], ev["dname"], ev["ent"])
            # finish the foreign-side removal: directly if we own the
            # src dirfrag by now (takeover), else through its owner
            cur = self._dget(ev["sdino"], ev["sname"])
            if cur is not None and cur["ino"] == ev["ent"]["ino"]:
                if getattr(self, "messenger", None) is None:
                    # boot-time replay (messenger not built yet):
                    # complete the ino-guarded removal directly
                    self._drm(ev["sdino"], ev["sname"])
                else:
                    try:
                        self._peer_request(
                            ev["src_owner"], "peer_drm", {
                                "dino": ev["sdino"],
                                "name": ev["sname"],
                                "ino": ev["ent"]["ino"]})
                    except _Err:
                        # peer dead/unknown: direct removal
                        self._drm(ev["sdino"], ev["sname"])
            if ev.get("replaced"):
                self._purge_data(ev["replaced"])

    def _replay_mdlog(self) -> None:
        for seq, ev in self.mdlog.pending():
            self._apply_event(ev)
            self.mdlog.mark_done(seq)

    def _finish_event(self, seq: int, ev: dict) -> None:
        """Error path after an intent was journaled: an intent must not
        linger while the MDS keeps serving — hours later a restart
        would replay it over NEWER state (clobbering a file created at
        dst since, or deleting a file the client was told still
        exists).  Drive the redo to completion NOW via the idempotent
        replay handler; only if that also fails does the intent stay
        pending for the (imminent) restart to finish."""
        self._apply_event(ev)
        self.mdlog.mark_done(seq)

    def _multi_lock(self, *inos: int):
        """Acquire the stripe locks of several inodes deadlock-free:
        ordered by STRIPE INDEX (two renames ordering by raw ino could
        take aliased stripes in opposite order), deduplicated."""
        import contextlib

        idxs = sorted({ino % len(self._locks) for ino in inos})
        locks = [self._locks[i] for i in idxs]

        @contextlib.contextmanager
        def _ctx():
            for lk in locks:
                lk.acquire()
            try:
                yield
            finally:
                for lk in reversed(locks):
                    lk.release()
        return _ctx()

    def _purge_data(self, ent: dict) -> None:
        """Remove a dead inode's data blocks (reference PurgeQueue).
        The removal carries the fs SnapContext: blocks referenced by a
        live snapshot are COW-preserved by the OSD (delete clones +
        snapdir), not destroyed."""
        snapc = self._fs_snapc()
        self.data.snapc = snapc if snapc[1] else None
        nblocks = -(-max(ent.get("size", 0), 1) // self.block_size)
        for b in range(nblocks):
            try:
                self.data.remove(data_oid(ent["ino"], b))
            except RadosError:
                pass


class _Redirect(Exception):
    """This rank is not the path's authority: bounce the client to
    the owner (reference MDS forward / auth hints)."""

    def __init__(self, rank: str, addr: tuple):
        super().__init__(f"redirect to mds {rank} at {addr}")
        self.rank = rank
        self.addr = addr


class _Err(Exception):
    def __init__(self, err: int, msg: str = ""):
        super().__init__(msg)
        self.errno = err
