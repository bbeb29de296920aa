"""CephFS client: libcephfs-role POSIX-ish surface.

Re-expresses reference src/client/Client.cc + libcephfs.h at the
surface a filesystem consumer needs: mount, open/create, pread/pwrite
with block striping straight to the data pool (the MDS never sees file
bytes — reference file I/O goes client->OSD under caps), mkdir,
readdir, rename, unlink, rmdir, stat, truncate.

Capabilities (reference client cap handling, reduced): open() asks the
MDS for caps.  A sole opener gets "rwc" — the "c" cap is the right to
cache stat results (dentry-lease role) and defer the size/mtime
writeback to close().  When another client opens the same inode the
MDS revokes "c": this client flushes dirty attrs immediately, drops
its stat cache, and acks — after which every write is written through
(attr flush per write) so contenders observe each other.
"""

from __future__ import annotations

import os
import threading
import time

from ..msg import Messenger
from ..msg import messages as M
from .mds import data_oid

LEASE_TTL = 5.0      # stat-cache lifetime under the "c" cap


def _norm(path: str) -> str:
    """One normalization for every _stat_cache key: insert and
    invalidate must never disagree on the spelling of a path."""
    return "/" + "/".join(p for p in path.split("/") if p)


class FSError(Exception):
    def __init__(self, err: int, msg: str = ""):
        super().__init__(f"[errno {err}] {msg}")
        self.errno = err


class CephFS:
    def __init__(self, mon_addr, mds_addr, auth=None,
                 secure: bool = False, name: str = "fsclient"):
        from ..rados import RadosClient
        self.client_id = f"{name}.{os.urandom(6).hex()}"
        self.messenger = Messenger(name, auth=auth, secure=secure)
        self.messenger.add_dispatcher(self._dispatch)
        self.mds_conn = self.messenger.connect(tuple(mds_addr))
        self._mds_conns: dict[tuple, object] = {}   # other ranks
        self._route_cache: dict[str, tuple] = {}    # path -> owner addr
        self._lock = threading.Lock()
        self._tid = 0
        self._waiters: dict[int, dict] = {}
        self._caps: dict[int, str] = {}              # ino -> caps held
        self._cap_seqs: dict[int, int] = {}          # ino -> last seq
        self._attr_tick = 0      # per-client attr-update order stamp
        self._snap_epoch = -1    # last applied snapc epoch
        self._early_snapc = None  # broadcast that beat mount()
        self.data = None
        self._files: dict[int, list] = {}            # ino -> open Files
        self._stat_cache: dict[str, tuple] = {}      # path -> (ent, exp)
        self.revokes_seen = 0      # observability (tests/metrics)
        self.rados = RadosClient(mon_addr, name, auth=auth,
                                 secure=secure).connect()
        info = self._req("mount", {"client": self.client_id})
        self.block_size = info["block_size"]
        self.data = self.rados.open_ioctx(info["data_pool"])
        self._apply_snapc(info.get("snapc"),
                          info.get("snap_epoch", 0))
        # a snapc broadcast may have raced ahead of self.data existing;
        # apply the buffered one if it is newer than the mount's
        with self._lock:
            early = self._early_snapc
            self._early_snapc = None
        if early is not None:
            self._apply_snapc(early[1], early[0])

    def shutdown(self) -> None:
        self.messenger.shutdown()
        self.rados.shutdown()

    # -- MDS RPC -------------------------------------------------------------

    def _dispatch(self, conn, msg) -> None:
        if isinstance(msg, M.MClientReply):
            with self._lock:
                w = self._waiters.pop(msg.tid, None)
            if w is not None:
                w["reply"] = msg
                w["event"].set()
        elif isinstance(msg, M.MClientCaps) and msg.op == "snapc":
            # a snapshot was created/removed: writes must carry the
            # new SnapContext so the OSDs COW data objects.  msg.seq
            # carries the MDS's snap epoch (ordering across racing
            # broadcasts and the mount reply).
            import json as _json
            try:
                snapc = _json.loads(msg.caps)
            except ValueError:
                return
            with self._lock:
                pre_mount = self.data is None
                if pre_mount and (self._early_snapc is None or
                                  msg.seq > self._early_snapc[0]):
                    self._early_snapc = (msg.seq, snapc)
            if not pre_mount:
                self._apply_snapc(snapc, msg.seq)
        elif isinstance(msg, M.MClientCaps) and msg.op == "revoke":
            # flush + ack on a worker: this runs on the mds_conn reader
            # thread, and the flush's own RPC reply must be readable
            threading.Thread(target=self._handle_revoke, args=(msg,),
                             daemon=True, name="fs-cap-revoke").start()

    def _handle_revoke(self, msg: M.MClientCaps) -> None:
        """MDS took our cache cap: write back dirty state, drop caches,
        ack with the reduced cap set (reference Client::handle_caps
        CEPH_CAP_OP_REVOKE)."""
        self.revokes_seen += 1
        flush = {"ino": msg.ino, "seq": msg.seq, "caps": msg.caps,
                 "client": self.client_id}
        with self._lock:
            self._caps[msg.ino] = msg.caps
            self._cap_seqs[msg.ino] = max(
                msg.seq, self._cap_seqs.get(msg.ino, 0))
            files = list(self._files.get(msg.ino, ()))
            self._stat_cache = {p: v for p, v in
                                self._stat_cache.items()
                                if v[0].get("ino") != msg.ino}
            # size snapshot + tick must be ONE atomic step under the
            # lock: a concurrent write-through flush snapshots under
            # the same lock, so tick order == snapshot order and the
            # MDS can safely drop the older of the two
            dirty = [f for f in files if f._dirty]
            if dirty:
                # several handles on one inode: the file's logical
                # size is the furthest any handle wrote
                flush["path"] = dirty[0].path
                flush["size"] = max(f.size for f in dirty)
                flush["mtime"] = time.time()
                self._attr_tick += 1
                flush["tick"] = self._attr_tick
        try:
            self._req("cap_flush", flush)
        except FSError:
            return   # MDS drops our caps on timeout; keep _dirty set
        for f in dirty:
            f._dirty = False

    def _req_raw(self, conn, op: str, args: dict,
                 timeout: float = 30.0):
        with self._lock:
            self._tid += 1
            tid = self._tid
            w = {"event": threading.Event(), "reply": None}
            self._waiters[tid] = w
        conn.send_message(M.MClientRequest(op, args, tid))
        if not w["event"].wait(timeout):
            with self._lock:             # no reply will ever pop it:
                self._waiters.pop(tid, None)   # reclaim the waiter
            raise FSError(110, f"mds request {op} timed out")
        return w["reply"]

    def _conn_for(self, addr: tuple):
        """Connection to another MDS rank (multi-MDS redirects); mounts
        a session on first use so caps/revokes work against that rank."""
        with self._lock:
            conn = self._mds_conns.get(addr)
        if conn is not None:
            return conn
        conn = self.messenger.connect(addr)
        reply = self._req_raw(conn, "mount",
                              {"client": self.client_id})
        if reply.result != 0:
            raise FSError(-reply.result, "mount on redirect target")
        with self._lock:
            self._mds_conns[addr] = conn
        return conn

    def _req(self, op: str, args: dict, timeout: float = 30.0) -> dict:
        """MDS RPC with multi-MDS handling: ESTALE+redirect_addr sends
        the op to the owning rank (reference client MDS-session
        retargeting on auth hints); EAGAIN (subtree frozen by a
        migration, or a transient server retry limit) backs off and
        retries until the authority settles."""
        import errno as _e
        conn = self.mds_conn
        cur_addr = None                  # non-None = redirected conn
        # last-known-owner cache: ops under an exported subtree go
        # straight to the owning rank instead of paying a permanent
        # ESTALE redirect hop through the primary every time
        route_key = args.get("path") or args.get("dst")
        cached = self._route_cache.get(route_key) \
            if route_key else None
        if cached is not None:
            try:
                conn = self._conn_for(cached)
                cur_addr = cached
            except FSError:
                self._route_cache.pop(route_key, None)
        redirects = 0
        deadline = time.time() + timeout
        while True:
            try:
                attempt = min(timeout, 10.0) if cur_addr else timeout
                reply = self._req_raw(conn, op, args, attempt)
            except FSError as e:
                if e.errno == 110 and cur_addr is not None and \
                        time.time() < deadline:
                    # the redirect target died: drop the cached conn
                    # and re-resolve authority from the primary (the
                    # surviving rank auto-takes-over dead subtrees)
                    with self._lock:
                        self._mds_conns.pop(cur_addr, None)
                    if route_key:
                        self._route_cache.pop(route_key, None)
                    conn, cur_addr = self.mds_conn, None
                    continue
                raise
            if reply.result == 0:
                if route_key and cur_addr is not None:
                    if len(self._route_cache) > 4096:
                        self._route_cache.clear()
                    self._route_cache[route_key] = cur_addr
                return reply.out
            if reply.result == -_e.ESTALE and \
                    reply.out.get("redirect_addr"):
                redirects += 1
                if redirects > 8:
                    raise FSError(_e.ELOOP, f"redirect loop on {op}")
                if route_key:
                    self._route_cache.pop(route_key, None)
                cur_addr = tuple(reply.out["redirect_addr"])
                conn = self._conn_for(cur_addr)
                continue
            if reply.result == -_e.EAGAIN and time.time() < deadline:
                time.sleep(0.2)
                continue
            raise FSError(-reply.result,
                          reply.out.get("error", op))

    # -- namespace -----------------------------------------------------------

    def stat(self, path: str) -> dict:
        parts = [p for p in path.split("/") if p]
        if parts and parts[-1] == ".snap":
            # the .snap virtual directory itself
            from .mds import S_IFDIR
            self.snap_list("/" + "/".join(parts[:-1]))  # ENOENT check
            return {"ino": 0, "mode": S_IFDIR | 0o555, "size": 0,
                    "mtime": 0}
        snap = self._split_snap(path)
        if snap is not None:
            dirpath, name, rel = snap
            return self._req("snap_resolve", {
                "path": dirpath, "name": name, "rel": rel})["ent"]
        norm = _norm(path)
        with self._lock:
            hit = self._stat_cache.get(norm)
            if hit is not None and hit[1] > time.time():
                return dict(hit[0])
        ent = self._req("stat", {"path": path})["ent"]
        # cache only under the "c" cap, RE-checked under the lock at
        # insert time: a revoke landing between the RPC and here has
        # already purged the cache and must not be undone by a stale
        # re-insert
        with self._lock:
            if "c" in self._caps.get(ent.get("ino"), ""):
                self._stat_cache[norm] = (dict(ent),
                                          time.time() + LEASE_TTL)
        return ent

    def export_dir(self, path: str, to_rank: str) -> dict:
        """Migrate a subtree's authority to another MDS rank
        (redirect-routed to the current owner like any path op)."""
        return self._req("export_dir", {"path": path, "to": to_rank})

    def mkdir(self, path: str) -> None:
        self._req("mkdir", {"path": path})

    def makedirs(self, path: str) -> None:
        parts = [p for p in path.split("/") if p]
        for i in range(1, len(parts) + 1):
            try:
                self.mkdir("/".join(parts[:i]))
            except FSError as e:
                if e.errno != 17:   # EEXIST
                    raise

    def readdir(self, path: str) -> list[tuple[str, dict]]:
        parts = [p for p in path.split("/") if p]
        if parts and parts[-1] == ".snap":
            # listing the .snap virtual dir enumerates snapshot names
            from .mds import S_IFDIR
            dirpath = "/" + "/".join(parts[:-1])
            return [(n, {"ino": 0, "mode": S_IFDIR | 0o555,
                         "size": 0, "mtime": 0})
                    for n in self.snap_list(dirpath)]
        snap = self._split_snap(path)
        if snap is not None:
            dirpath, name, rel = snap
            out = self._req("snap_resolve", {
                "path": dirpath, "name": name, "rel": rel})
            return [(k, m) for k, m in out.get("entries", [])]
        out = self._req("readdir", {"path": path})
        return [(k, m) for k, m in out["entries"]]

    def _apply_snapc(self, snapc, epoch: int = 0) -> None:
        """Route the fs SnapContext onto the data ioctx (reference
        client snap realm update): [seq, [ids desc]] or None.  Epochs
        order racing updates — an older broadcast must not clobber a
        newer one."""
        with self._lock:
            if epoch < self._snap_epoch:
                return
            self._snap_epoch = epoch
            if snapc and snapc[1]:
                self.data.snapc = [int(snapc[0]),
                                   [int(s) for s in snapc[1]]]
            else:
                self.data.snapc = None

    @staticmethod
    def _split_snap(path: str):
        """path/.snap/<name>/<rel> -> (dirpath, name, rel) or None."""
        parts = [p for p in path.split("/") if p]
        if ".snap" not in parts:
            return None
        i = parts.index(".snap")
        if i + 1 >= len(parts):
            return None
        return ("/" + "/".join(parts[:i]), parts[i + 1],
                "/".join(parts[i + 2:]))

    def snap_create(self, dirpath: str, name: str) -> None:
        """Snapshot a directory subtree (reference mkdir .snap/<name>)."""
        out = self._req("snap_create", {"path": dirpath, "name": name})
        self._apply_snapc(out.get("snapc"), out.get("snap_epoch", 0))

    def snap_rm(self, dirpath: str, name: str) -> None:
        out = self._req("snap_rm", {"path": dirpath, "name": name})
        self._apply_snapc(out.get("snapc"), out.get("snap_epoch", 0))

    def snap_list(self, dirpath: str) -> list[str]:
        return self._req("snap_list", {"path": dirpath})["snaps"]

    def _uncache(self, *paths: str, subtree: bool = False) -> None:
        """Our own namespace mutations invalidate the lease cache: no
        revoke arrives for them (we ARE the holder).  subtree=True
        also evicts every cached descendant — renaming/removing a
        directory must not leave stat hits live under the old name
        for up to LEASE_TTL."""
        with self._lock:
            for p in paths:
                np = _norm(p)
                self._stat_cache.pop(np, None)
                if subtree:
                    pre = np.rstrip("/") + "/"
                    for c in [c for c in self._stat_cache
                              if c.startswith(pre)]:
                        self._stat_cache.pop(c, None)

    def unlink(self, path: str) -> None:
        self._req("unlink", {"path": path})
        self._uncache(path)

    def rmdir(self, path: str) -> None:
        self._req("rmdir", {"path": path})
        self._uncache(path, subtree=True)

    def rename(self, src: str, dst: str) -> None:
        self._req("rename", {"src": src, "dst": dst})
        self._uncache(src, dst, subtree=True)

    # -- file I/O ------------------------------------------------------------

    def open(self, path: str, mode: str = "r") -> "File":
        snap = self._split_snap(path)
        if snap is not None:
            if "w" in mode or "a" in mode or "+" in mode:
                raise FSError(30, f"{path}: snapshots are read-only")
            dirpath, name, rel = snap
            out = self._req("snap_resolve", {
                "path": dirpath, "name": name, "rel": rel})
            from .mds import S_IFDIR
            if out["ent"]["mode"] & S_IFDIR:
                raise FSError(21, path)
            return File(self, path, out["ent"], snap_id=out["snapid"])
        writing = "w" in mode or "a" in mode or "+" in mode
        # POSIX fopen: w/w+/a/a+ create; r/r+ require existence
        out = self._req("open", {
            "path": path, "client": self.client_id,
            "want": "rw" if writing else "r",
            "create": "w" in mode or "a" in mode})
        ent, caps = out["ent"], out.get("caps", "")
        with self._lock:
            # a revoke that raced in after the MDS granted (higher
            # seq) must not be clobbered by this stale grant
            seq = out.get("cap_seq", 0)
            if seq >= self._cap_seqs.get(ent["ino"], 0):
                self._caps[ent["ino"]] = caps
                self._cap_seqs[ent["ino"]] = seq
        f = File(self, path, ent)
        with self._lock:
            self._files.setdefault(ent["ino"], []).append(f)
        if "w" in mode and ent.get("size", 0):
            f.truncate(0)
        if "a" in mode:
            f.pos = f.size
        return f

    def write_file(self, path: str, data: bytes) -> None:
        with self.open(path, "w") as f:
            f.write(data)

    def read_file(self, path: str) -> bytes:
        with self.open(path, "r") as f:
            return f.read()


class File:
    """An open file handle (reference Fh): striped block I/O against
    the data pool; size/mtime pushed to the MDS on flush/close."""

    def __init__(self, fs: CephFS, path: str, ent: dict,
                 snap_id: int = 0):
        self.fs = fs
        self.path = path
        self.ino = ent["ino"]
        self.size = ent.get("size", 0)
        self.pos = 0
        self.snap_id = snap_id      # >0: read-only snapshot view
        self._dirty = False

    # -- striping ------------------------------------------------------------

    def pwrite(self, data: bytes, offset: int) -> int:
        if self.snap_id:
            raise FSError(30, f"{self.path}: snapshot is read-only")
        bs = self.fs.block_size
        off = offset
        view = memoryview(data)
        while view:
            blk, in_blk = divmod(off, bs)
            n = min(bs - in_blk, len(view))
            self.fs.data.write(data_oid(self.ino, blk),
                               bytes(view[:n]), offset=in_blk)
            view = view[n:]
            off += n
        self.size = max(self.size, offset + len(data))
        self._dirty = True
        # without the "c" cap another client holds caps on this inode:
        # write attrs through so it observes our size promptly
        if "c" not in self.fs._caps.get(self.ino, ""):
            self.flush()
        return len(data)

    def pread(self, length: int, offset: int) -> bytes:
        bs = self.fs.block_size
        end = min(offset + length, self.size)
        if end <= offset:
            return b""
        out = bytearray()
        off = offset
        while off < end:
            blk, in_blk = divmod(off, bs)
            n = min(bs - in_blk, end - off)
            from ..rados.client import RadosError
            try:
                piece = self.fs.data.read(data_oid(self.ino, blk),
                                          n, offset=in_blk,
                                          snap=self.snap_id)
            except RadosError as e:
                if e.errno != 2:   # only ENOENT is a sparse hole
                    # a cluster fault must not read back as zeros
                    raise FSError(e.errno, f"read {self.path}") from e
                piece = b""
            out += piece.ljust(n, b"\x00")
            off += n
        return bytes(out)

    # -- posix-ish surface ---------------------------------------------------

    def write(self, data: bytes) -> int:
        n = self.pwrite(data, self.pos)
        self.pos += n
        return n

    def read(self, length: int | None = None) -> bytes:
        if length is None:
            length = self.size - self.pos
        out = self.pread(length, self.pos)
        self.pos += len(out)
        return out

    def seek(self, pos: int) -> None:
        self.pos = pos

    def truncate(self, size: int) -> None:
        if self.snap_id:
            raise FSError(30, f"{self.path}: snapshot is read-only")
        bs = self.fs.block_size
        from ..rados.client import RadosError
        old_blocks = -(-max(self.size, 1) // bs)
        keep_blocks = -(-size // bs) if size else 0
        for b in range(keep_blocks, old_blocks):
            try:
                self.fs.data.remove(data_oid(self.ino, b))
            except RadosError:
                pass
        if size and size % bs:
            try:
                self.fs.data.truncate(data_oid(self.ino,
                                               keep_blocks - 1),
                                      size % bs)
            except RadosError:
                pass
        self.size = size
        self._dirty = True
        # same shared-mode write-through rule as pwrite: contenders
        # must observe the truncated size promptly
        if "c" not in self.fs._caps.get(self.ino, ""):
            self.flush()

    def flush(self) -> None:
        if self._dirty:
            with self.fs._lock:    # atomic (size, tick) snapshot
                self.fs._attr_tick += 1
                args = {"path": self.path, "size": self.size,
                        "mtime": time.time(),
                        "client": self.fs.client_id,
                        "tick": self.fs._attr_tick}
            self.fs._req("setattr", args)
            self._dirty = False
            with self.fs._lock:
                self.fs._stat_cache.pop(_norm(self.path), None)

    def close(self) -> None:
        self.flush()
        with self.fs._lock:
            files = self.fs._files.get(self.ino, [])
            if self in files:
                files.remove(self)
            last = not files
        if last:
            try:
                self.fs._req("cap_release", {
                    "ino": self.ino, "client": self.fs.client_id})
            except FSError:
                pass
            with self.fs._lock:
                self.fs._caps.pop(self.ino, None)
                # no caps -> no right to serve cached stats: another
                # client can now mutate without any revoke reaching us
                self.fs._stat_cache = {
                    p: v for p, v in self.fs._stat_cache.items()
                    if v[0].get("ino") != self.ino}

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
