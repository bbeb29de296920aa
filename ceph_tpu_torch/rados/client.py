"""RadosClient / IoCtx: the public client API.

Re-expresses the reference librados surface (src/librados/librados.cc,
RadosClient/IoCtxImpl; python binding src/pybind/rados/rados.pyx):
connect to the cluster, open an IoCtx per pool, then object I/O —
write_full / write / append / read / stat / remove / truncate /
setxattr — plus pool and EC-profile administration via mon commands.
Synchronous surface over the async Objecter (aio_* variants return
concurrent futures).
"""

from __future__ import annotations

import errno
from concurrent.futures import ThreadPoolExecutor, Future

from ..osdc import Objecter


class RadosError(Exception):
    def __init__(self, err: int, msg: str = ""):
        super().__init__(f"[errno {err}] {msg}")
        self.errno = err


class RadosClient:
    def __init__(self, mon_addr, name: str = "client", auth=None,
                 secure: bool = False, compress: str | None = None):
        self.objecter = Objecter(mon_addr, name, auth=auth,
                                 secure=secure, compress=compress)
        self._pool = ThreadPoolExecutor(max_workers=16,
                                        thread_name_prefix="rados-aio")

    def connect(self) -> "RadosClient":
        self.objecter.start()
        return self

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False)
        self.objecter.shutdown()

    # -- pool admin ---------------------------------------------------------

    def mon_command(self, cmd: dict) -> tuple[int, dict]:
        return self.objecter.mon_command(cmd)

    def create_pool(self, name: str, pool_type: str = "replicated",
                    **kw) -> dict:
        cmd = {"prefix": "osd pool create", "name": name,
               "type": pool_type, **kw}
        result, out = self.mon_command(cmd)
        if result != 0:
            raise RadosError(-result, out.get("error", "pool create failed"))
        return out

    def set_ec_profile(self, name: str, profile: dict) -> dict:
        result, out = self.mon_command(
            {"prefix": "osd erasure-code-profile set", "name": name,
             "profile": profile})
        if result != 0:
            raise RadosError(-result, out.get("error", "profile set failed"))
        return out

    def pool_list(self) -> list[str]:
        result, out = self.mon_command({"prefix": "osd pool ls"})
        return out.get("pools", [])

    def status(self) -> dict:
        result, out = self.mon_command({"prefix": "status"})
        return out

    def open_ioctx(self, pool_name: str) -> "IoCtx":
        self.objecter.refresh_map()
        pool = self.objecter.osdmap.lookup_pool(pool_name)
        if pool is None:
            raise RadosError(errno.ENOENT, f"no pool {pool_name}")
        return IoCtx(self, pool.id, pool_name)


class IoCtx:
    def __init__(self, client: RadosClient, pool_id: int, pool_name: str):
        self.client = client
        self.pool_id = pool_id
        self.pool_name = pool_name
        # self-managed snapshots (reference rados_ioctx_selfmanaged_*):
        # snapc rides every write; read_snap redirects reads to a clone
        self.snapc: list | None = None     # [seq, [snap ids desc]]
        self.read_snap: int = 0
        # QoS class every op of this ioctx declares on the wire (the
        # mClock scheduler's per-tenant key; None = plain "client")
        self.qos_class: str | None = None

    def set_qos_class(self, qos_class: str | None) -> None:
        """Tag this ioctx's ops with an mClock QoS class (tenant name);
        the OSD schedules them under that class's (reservation,
        weight, limit) triple — see docs/QOS.md."""
        self.qos_class = qos_class

    def set_snap_context(self, seq: int, snaps: list[int]) -> None:
        self.snapc = [int(seq), [int(s) for s in snaps]]

    def set_read_snap(self, snap: int) -> None:
        self.read_snap = int(snap)

    def selfmanaged_snap_create(self) -> int:
        """Allocate a snap id from the mon (reference
        rados_ioctx_selfmanaged_snap_create)."""
        r, out = self.client.mon_command({
            "prefix": "osd pool selfmanaged-snap-create",
            "pool": self.pool_name})
        if r != 0:
            raise RadosError(-r, out.get("error", "snap create"))
        return int(out["snapid"])

    def selfmanaged_snap_remove(self, snapid: int) -> None:
        """Mark a snap id deleted; its clones are reclaimed by the
        OSD snap trimmer (reference rados_ioctx_selfmanaged_snap_remove
        + the snap trim queue)."""
        r, out = self.client.mon_command({
            "prefix": "osd pool selfmanaged-snap-rm",
            "pool": self.pool_name, "snapid": snapid})
        if r != 0:
            raise RadosError(-r, out.get("error", "snap rm"))

    def _submit(self, name: str, ops: list, data: bytes = b"",
                snap: int = 0) -> bytes:
        reply = self.client.objecter.op_submit(
            self.pool_id, name, ops, data, snap=snap,
            snapc=self.snapc, qos_class=self.qos_class)
        if reply.result != 0:
            raise RadosError(-reply.result, f"op on {name}")
        return reply.data

    # -- sync I/O -----------------------------------------------------------

    def write_full(self, name: str, data: bytes) -> None:
        self._submit(name, [["writefull", len(data)]], bytes(data))

    def write(self, name: str, data: bytes, offset: int = 0) -> None:
        self._submit(name, [["write", offset, len(data)]], bytes(data))

    def read(self, name: str, length: int = 0, offset: int = 0,
             snap: int | None = None) -> bytes:
        return self._submit(name, [["read", offset, length]],
                            snap=self.read_snap if snap is None
                            else snap)

    def stat(self, name: str) -> int:
        self._submit(name, [["stat"]])
        return 0  # size via read for now; meta channel reserved

    def remove(self, name: str) -> None:
        self._submit(name, [["delete"]])

    def truncate(self, name: str, size: int) -> None:
        self._submit(name, [["truncate", size]])

    def setxattr(self, name: str, key: str, value: bytes) -> None:
        self._submit(name, [["setxattr", key, len(value)]], bytes(value))

    def getxattr(self, name: str, key: str) -> bytes:
        return bytes(self._submit(name, [["getxattr", key]]))

    def rmxattr(self, name: str, key: str) -> None:
        self._submit(name, [["rmxattr", key]])

    def cmpxattr(self, name: str, key: str, value: bytes) -> None:
        """Guard: raises RadosError(ECANCELED) unless the xattr
        currently equals `value` (reference rados_cmpxattr EQ)."""
        self._submit(name, [["cmpxattr", key, len(value)]],
                     bytes(value))

    def append(self, name: str, data: bytes) -> None:
        """reference rados_append: write at the current size."""
        self._submit(name, [["append", len(data)]], bytes(data))

    def zero(self, name: str, off: int, length: int) -> None:
        """reference rados_zero: logical zeros over a range."""
        self._submit(name, [["zero", off, length]])

    def create(self, name: str, exclusive: bool = True) -> None:
        """reference rados_create: make an empty object; exclusive
        raises EEXIST if it already exists."""
        self._submit(name, [["create", 1 if exclusive else 0]])

    # -- omap (reference rados_omap_* / ObjectWriteOperation omap ops;
    #    OSD-side: the OMAP cases of PrimaryLogPG::do_osd_ops) ---------------

    def omap_set(self, name: str, kv: dict[bytes, bytes]) -> None:
        from ..common import omap_codec as oc
        payload = oc.encode_kv(kv)
        self._submit(name, [["omapsetkeys", len(payload)]], payload)

    def omap_rm_keys(self, name: str, keys) -> None:
        from ..common import omap_codec as oc
        payload = oc.encode_keys(keys)
        self._submit(name, [["omaprmkeys", len(payload)]], payload)

    def omap_clear(self, name: str) -> None:
        self._submit(name, [["omapclear"]])

    def omap_set_header(self, name: str, data: bytes) -> None:
        self._submit(name, [["omapsetheader", len(data)]], bytes(data))

    def omap_get_header(self, name: str) -> bytes:
        return self._submit(name, [["omapgetheader"]])

    def omap_get_keys(self, name: str, start_after: bytes | None = None,
                      max_return: int = 0) -> list[bytes]:
        from ..common import omap_codec as oc
        sa = oc.encode_keys([start_after] if start_after else [])
        out = self._submit(
            name, [["omapgetkeys", len(sa), max_return]], sa)
        keys, _ = oc.decode_keys(out)
        return keys

    def omap_get_vals(self, name: str, start_after: bytes | None = None,
                      max_return: int = 0) -> dict[bytes, bytes]:
        from ..common import omap_codec as oc
        sa = oc.encode_keys([start_after] if start_after else [])
        out = self._submit(
            name, [["omapgetvals", len(sa), max_return]], sa)
        kv, _ = oc.decode_kv(out)
        return kv

    def omap_get_vals_by_keys(self, name: str,
                              keys) -> dict[bytes, bytes]:
        from ..common import omap_codec as oc
        payload = oc.encode_keys(keys)
        out = self._submit(
            name, [["omapgetvalsbykeys", len(payload)]], payload)
        kv, _ = oc.decode_kv(out)
        return kv

    # -- cls / watch-notify --------------------------------------------------

    def execute(self, name: str, cls: str, method: str,
                inp: bytes = b"") -> bytes:
        """Server-side class call (reference rados_exec / IoCtx::exec)."""
        return self._submit(name, [["call", f"{cls}.{method}", len(inp)]],
                            bytes(inp))

    def watch(self, name: str, callback) -> int:
        """callback(oid_name, payload) fires on each notify."""
        return self.client.objecter.watch(self.pool_id, name, callback)

    def list_watchers(self, name: str) -> list[int]:
        """Cookies of live watchers (reference rados_watchers_list)."""
        import json
        return json.loads(self._submit(name, [["listwatchers"]]).decode())

    def unwatch(self, name: str, cookie: int) -> None:
        self.client.objecter.unwatch(self.pool_id, name, cookie)

    def notify(self, name: str, payload: bytes = b"") -> None:
        self.client.objecter.notify(self.pool_id, name, payload)

    # -- async --------------------------------------------------------------

    def aio_write_full(self, name: str, data: bytes) -> Future:
        return self.client._pool.submit(self.write_full, name, data)

    def aio_read(self, name: str, length: int = 0, offset: int = 0) -> Future:
        return self.client._pool.submit(self.read, name, length, offset)
