"""MgrDaemon: map subscription + module host.

Re-expresses reference src/mgr/Mgr.cc + PyModuleRegistry: the daemon
keeps a live OSDMap from the mon and runs each enabled module's
serve() on its own thread; modules reach the cluster through the
MgrModule API (get_osdmap / mon_command / set_health), the analog of
the reference's ActivePyModules surface.
"""

from __future__ import annotations

import threading
import time

from ..msg import Messenger
from ..msg import messages as M
from ..osd.osd_map import OSDMap, apply_inc_chain


class MgrModule:
    """Base class for mgr modules (reference MgrModule in
    pybind/mgr/mgr_module.py)."""

    name = "module"
    run_interval = 1.0

    def __init__(self, mgr: "MgrDaemon"):
        self.mgr = mgr

    def tick(self) -> None:
        """Called every run_interval while the mgr is active."""

    def shutdown(self) -> None:
        """Optional teardown (servers, files) at mgr shutdown."""

    # convenience passthroughs
    def get_osdmap(self) -> OSDMap:
        return self.mgr.osdmap

    def mon_command(self, cmd: dict) -> tuple[int, dict]:
        return self.mgr.mon_command(cmd)


class MgrDaemon:
    def __init__(self, mon_addr, modules: list[type] | None = None,
                 auth=None, secure: bool = False, name: str = "x"):
        from ..msg.addrs import normalize_mon_addrs
        self.name = name
        self.mon_addrs = normalize_mon_addrs(mon_addr)
        self._mon_idx = 0
        self.messenger = Messenger("mgr", auth=auth, secure=secure)
        self.messenger.add_dispatcher(self._dispatch)
        self.mon_conn = self.messenger.connect(self.mon_addrs[0])
        self.osdmap = OSDMap()
        self.map_event = threading.Event()
        self._lock = threading.Lock()
        self._tid = 0
        self._waiters: dict[int, dict] = {}
        self.health: dict[str, dict] = {}   # module -> health report
        self._stop = threading.Event()
        from .modules import DEFAULT_MODULES
        self.modules = [cls(self) for cls in
                        (modules if modules is not None
                         else DEFAULT_MODULES)]
        self._threads: list[threading.Thread] = []

    def start(self, timeout: float = 10.0) -> "MgrDaemon":
        deadline = time.time() + timeout
        while self.osdmap.epoch == 0 and time.time() < deadline:
            self.mon_conn.send_message(M.MMonGetMap())
            if not self.map_event.wait(1.0):
                self._rotate_mon()
            self.map_event.clear()
        try:
            # join the replicated mgrmap (reference MgrMonitor beacon:
            # first mgr becomes active, later ones standby)
            self.mon_command({"prefix": "mgr boot", "name": self.name})
        except Exception:  # noqa: BLE001 - registration is best-effort
            pass
        for mod in self.modules:
            t = threading.Thread(target=self._run_module, args=(mod,),
                                 daemon=True, name=f"mgr.{mod.name}")
            t.start()
            self._threads.append(t)
        return self

    def shutdown(self) -> None:
        self._stop.set()
        for mod in self.modules:
            try:
                mod.shutdown()
            except Exception:  # noqa: BLE001 - teardown best-effort
                pass
        self.messenger.shutdown()

    def _rotate_mon(self) -> None:
        if len(self.mon_addrs) == 1:
            return
        self._mon_idx = (self._mon_idx + 1) % len(self.mon_addrs)
        self.mon_conn = self.messenger.connect(
            self.mon_addrs[self._mon_idx])

    def _run_module(self, mod: MgrModule) -> None:
        while not self._stop.wait(mod.run_interval):
            try:
                mod.tick()
            except Exception as e:  # noqa: BLE001 - module crash is
                # the module's problem, not the mgr's (reference
                # PyModule health error surface)
                self.health[mod.name] = {
                    "status": "HEALTH_ERR",
                    "detail": [f"module {mod.name} failed: {e!r}"]}

    def _dispatch(self, conn, msg) -> None:
        if isinstance(msg, M.MMonMap):
            newmap = OSDMap.from_json(msg.map_json)
            if newmap.epoch >= self.osdmap.epoch:
                self.osdmap = newmap
            self.map_event.set()
        elif isinstance(msg, M.MOSDMapInc):
            # incremental publish / keepalive (same contract as the
            # OSD/objecter appliers; gap -> full re-request)
            m = apply_inc_chain(self.osdmap, msg.incs)
            if m is None or (not msg.incs and
                             msg.epoch > self.osdmap.epoch):
                try:
                    self.mon_conn.send_message(M.MMonGetMap())
                except Exception:  # noqa: BLE001 - mon electing
                    pass
                return
            self.osdmap = m
            self.map_event.set()
        elif isinstance(msg, M.MMonCommandAck):
            with self._lock:
                w = self._waiters.pop(msg.tid, None)
            if w is not None:
                w["reply"] = msg
                w["event"].set()

    def mon_command(self, cmd: dict, timeout: float = 10.0
                    ) -> tuple[int, dict]:
        with self._lock:
            self._tid += 1
            tid = self._tid
            w = {"event": threading.Event(), "reply": None}
            self._waiters[tid] = w
        self.mon_conn.send_message(M.MMonCommand(cmd, tid))
        if not w["event"].wait(timeout):
            self._rotate_mon()
            raise TimeoutError(f"mon command {cmd.get('prefix')}")
        return w["reply"].result, w["reply"].out

    # -- health model (reference Mgr health aggregation) --------------------

    def set_health(self, module: str, status: str,
                   detail: list[str]) -> None:
        if status == "HEALTH_OK":
            self.health.pop(module, None)
        else:
            self.health[module] = {"status": status, "detail": detail}

    def health_summary(self) -> dict:
        worst = "HEALTH_OK"
        for rep in self.health.values():
            if rep["status"] == "HEALTH_ERR":
                worst = "HEALTH_ERR"
            elif worst == "HEALTH_OK":
                worst = rep["status"]
        return {"status": worst, "checks": dict(self.health)}
