"""CephContext equivalent: per-daemon config + logging + perf + asok.

Re-expresses the reference's CephContext/global_init pairing
(src/common/ceph_context.h, src/global/global_init.cc): one object a
daemon threads everywhere, owning its Config, DoutStream, perf-counter
collection and admin socket, plus the startup EC-plugin preload
(global_init_preload_erasure_code, reference global_init.cc:571).

The port's copy of ceph_tpu/common/context.py.  Its plugin preload
loads every configured plugin: ceph_tpu skips `jax` there because
importing it initialises a device, while the port's `torch` plugin
touches no device until a codec is built on one.
"""

from __future__ import annotations

from .admin_socket import AdminSocket
from .dout import DoutStream
from .options import Config
from .perf_counters import PerfCountersCollection


class CephContext:
    def __init__(self, name: str = "client",
                 asok_path: str | None = None):
        self.name = name
        self.conf = Config()
        self.log = DoutStream()
        self.log.name = name
        self.perf = PerfCountersCollection()
        self.asok: AdminSocket | None = None
        if asok_path:
            self.asok = AdminSocket(asok_path)
            self._register_builtin_asok()

    def dout(self, subsys: str, level: int, msg: str) -> None:
        self.log.log(subsys, level, msg)

    def preload_erasure_code(self) -> list[str]:
        """global_init_preload_erasure_code: eager-load the configured
        plugins so pool creation can't stall a daemon later."""
        from ..ec import ErasureCodePluginRegistry
        plugins = [p for p in
                   str(self.conf.get("osd_erasure_code_plugins")).split()
                   if p]
        directory = str(self.conf.get("erasure_code_dir")) or None
        ErasureCodePluginRegistry.instance().preload(plugins, directory)
        self.dout("ec", 10, f"load: preloaded {plugins}")
        return plugins

    def _register_builtin_asok(self) -> None:
        self.asok.register_command(
            "perf dump", lambda cmd: self.perf.dump())
        self.asok.register_command(
            "perf schema", lambda cmd: self.perf.schema())
        # precomputed p50/p95/p99/p999 (+ error bounds) of every
        # latency histogram — the tail-latency answer to `perf dump`'s
        # raw buckets (docs/QOS.md, docs/TRACING.md)
        self.asok.register_command(
            "dump_latencies", lambda cmd: self.perf.dump_latencies())
        self.asok.register_command(
            "config show", lambda cmd: self.conf.show())

        def config_set(cmd):
            self.conf.set(cmd["key"], cmd["value"])
            return {"success": True, cmd["key"]: self.conf.get(cmd["key"])}
        self.asok.register_command("config set", config_set)

        def log_dump(cmd):
            """Structured dump of the in-memory recent-events ring
            (reference `log dump`: the higher-verbosity ring kept for
            post-hoc debugging); optional `count` bounds the tail."""
            count = cmd.get("count")
            return {"ok": 1, "count": len(self.log.ring),
                    "entries": self.log.recent(
                        int(count) if count is not None else None)}
        self.asok.register_command("log dump", log_dump)

    def shutdown(self) -> None:
        if self.asok is not None:
            self.asok.shutdown()
