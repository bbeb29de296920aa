"""MeshService: the per-host owner of the multi-card EC data plane.

The port of ceph_tpu/parallel/service.py.  A host runs ONE process-wide
MeshService owning the ('shard', 'data') mesh (parallel/mesh.Mesh);
every OSD daemon on the host, and every EC PG backend inside each,
acquires its `DistributedStripeCodec` handle from the service instead of
building a private mesh: one set of per-shard product tables per EC
geometry, the host's launch queue, shared failure accounting.

Acquisition is geometry-checked: the codec's k must divide over the
mesh's 'shard' axis and, when the caller supplies its plugin's
generator matrix, the mesh codec's matrix must be bit-identical (cauchy
parity written by the mesh is garbage to a reed_sol_van decode).
Violations raise MeshError; callers (ECBackend) treat that as a
surfaced config error and serve from the single-card plane.

The service also keeps the containment ledger: when a mesh launch fails
the owning ECBackend aborts the op, moves that PG to the single-card
plane for good, and reports the failure here, so `status()` shows which
plane serves and why.

On the card: the visible devices are the CUDA devices
(`torch.cuda.device_count()`); a test passes its own list (`visible=`,
e.g. ["cpu"] * 8 for the reference tests' 8 virtual CPU devices).
`status()` reports torch's CUDA version, the mesh's device names and
its gather where the reference reported jax's backend.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch


class MeshError(RuntimeError):
    """Mesh configuration/geometry error: the caller must fall back to
    the single-card plane (never fatal to a daemon)."""


def parse_mesh_shape(spec: str | None, have: int) -> tuple[int, int]:
    """'SxD' -> (S, D); a bare count (or empty = all `have` devices)
    gets the reference's heuristic: the largest of 4/2/1 dividing the
    count becomes the 'shard' axis (k=8 work shards 4-ways; odd meshes
    are data-parallel only)."""
    spec = (spec or "").strip().lower()
    if "x" in spec:
        s, _, d = spec.partition("x")
        try:
            shape = (int(s), int(d))
        except ValueError as e:
            raise MeshError(f"bad mesh_devices spec {spec!r}: {e}") from e
        if shape[0] < 1 or shape[1] < 1:
            raise MeshError(f"bad mesh_devices spec {spec!r}")
        return shape
    try:
        n = int(spec) if spec else have
    except ValueError as e:
        raise MeshError(f"bad mesh_devices spec {spec!r}: {e}") from e
    if n < 1:
        raise MeshError(f"bad mesh_devices count {n}")
    n_shard = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    return n_shard, n // n_shard


def _visible_devices(visible) -> list:
    if visible is not None:
        return list(visible)
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


class MeshService:
    """Process-wide (= per-host) broker of the device mesh."""

    _instance: "MeshService | None" = None
    _lock = threading.Lock()

    def __init__(self, mesh, spec: str, visible: int):
        from .launch_queue import ECLaunchQueue
        self.mesh = mesh
        self.spec = spec
        self.visible = visible
        self.n_shard = mesh.shape["shard"]
        self.n_data = mesh.shape["data"]
        self._codecs: dict[tuple, object] = {}
        self._codec_lock = threading.Lock()
        self.created_at = time.time()
        self.failures = 0
        self.last_error: str | None = None
        # the host's EC launch queue when one has been wired: the
        # service owns the device plane, so it brokers the queue too
        self.launch_queue = ECLaunchQueue.host_get()

    # -- lifecycle ----------------------------------------------------------

    @classmethod
    def configure(cls, devices: str | int | None = None,
                  visible=None) -> "MeshService":
        """Build (or return) the host's mesh service over the first S*D
        of the `visible` devices (default: the CUDA devices).  First
        configuration wins: one mesh per host is the deployment
        contract — a second configure with a conflicting shape raises
        MeshError instead of rebuilding tables under live backends."""
        spec = "" if devices is None else str(devices)
        with cls._lock:
            if cls._instance is not None:
                inst = cls._instance
                if spec and spec != inst.spec:
                    want = parse_mesh_shape(spec, inst.visible)
                    if want != (inst.n_shard, inst.n_data):
                        raise MeshError(
                            f"mesh already configured as "
                            f"{inst.n_shard}x{inst.n_data} "
                            f"(requested {spec!r} = "
                            f"{want[0]}x{want[1]})")
                return inst
            from .mesh import make_mesh
            devs = _visible_devices(visible)
            have = len(devs)
            n_shard, n_data = parse_mesh_shape(spec, have)
            if n_shard * n_data > have:
                raise MeshError(
                    f"mesh {n_shard}x{n_data} needs "
                    f"{n_shard * n_data} devices, have {have}")
            cls._instance = cls(make_mesh(n_shard, n_data, devs), spec,
                                have)
            return cls._instance

    @classmethod
    def get(cls) -> "MeshService | None":
        """The configured instance, or None (mesh mode off)."""
        return cls._instance

    @classmethod
    def get_or_configure(cls, devices: str | int | None = None,
                         visible=None) -> "MeshService":
        return cls.configure(devices, visible)

    @classmethod
    def reset(cls) -> None:
        """Drop the singleton (tests only: production never resets a
        live service)."""
        with cls._lock:
            cls._instance = None

    # -- launch queue (cross-PG continuous batching) ------------------------

    @classmethod
    def host_launch_queue(cls, window_us: float | None = None,
                          max_bytes: int | None = None, device=None):
        """The host's EC launch queue (launch_queue.ECLaunchQueue),
        built on first use — with or without a configured mesh
        (single-card hosts batch across PGs too).  First caller's knobs
        win, like the mesh shape."""
        from .launch_queue import ECLaunchQueue
        queue = ECLaunchQueue.host_instance(window_us=window_us,
                                            max_bytes=max_bytes,
                                            device=device)
        inst = cls.get()
        if inst is not None:
            inst.launch_queue = queue
        return queue

    # -- acquisition --------------------------------------------------------

    def acquire(self, k: int, m: int, technique: str = "cauchy",
                matrix=None):
        """Geometry-checked DistributedStripeCodec handle, cached per
        (k, m, technique) so every PG of every OSD on the host shares
        one set of per-shard tables per EC profile.

        matrix: the acquiring plugin's generator matrix when it has
        one — must match the mesh codec's bit for bit (parity written
        on the mesh plane must decode on the single-card plane and vice
        versa)."""
        from .mesh import DistributedStripeCodec
        if k % self.n_shard:
            raise MeshError(
                f"EC k={k} not divisible by mesh shard axis "
                f"{self.n_shard} (mesh {self.n_shard}x{self.n_data})")
        tech = "cauchy" if technique in ("cauchy", "cauchy_good") \
            else "reed_sol_van"
        key = (k, m, tech)
        with self._codec_lock:
            codec = self._codecs.get(key)
            if codec is None:
                try:
                    codec = DistributedStripeCodec(
                        k, m, self.mesh,
                        technique="cauchy" if tech == "cauchy"
                        else "vandermonde")
                except Exception as e:  # noqa: BLE001 — geometry/build
                    raise MeshError(f"mesh codec build failed: {e}") \
                        from e
                self._codecs[key] = codec
        if matrix is not None and \
                not np.array_equal(np.asarray(matrix), codec.matrix):
            raise MeshError(
                f"plugin generator matrix (technique={technique!r}) "
                f"does not match the mesh codec's {tech} matrix — "
                f"mesh parity would not decode on the plugin plane")
        return codec

    # -- containment ledger -------------------------------------------------

    def note_failure(self, err: BaseException | str) -> None:
        """Record a mesh launch failure (the owning backend has already
        aborted the op and moved to the single-card plane); surfaced
        via status()."""
        self.failures += 1
        self.last_error = repr(err) if isinstance(err, BaseException) \
            else str(err)

    # -- observability ------------------------------------------------------

    def status(self) -> dict:
        devs = self.mesh.distinct_devices()
        return {
            "shape": {"shard": self.n_shard, "data": self.n_data},
            "n_devices": self.n_shard * self.n_data,
            "devices_visible": self.visible,
            "backend": devs[0].type,
            "cuda": torch.version.cuda,
            "devices": [torch.cuda.get_device_name(dv)
                        if dv.type == "cuda" else str(dv) for dv in devs],
            "gather": self.mesh.gather,
            "codecs": sorted(
                f"k={k} m={m} {t}" for (k, m, t) in self._codecs),
            "failures": self.failures,
            "last_error": self.last_error,
            "launch_queue": (self.launch_queue.status()
                             if self.launch_queue is not None else None),
            "uptime_s": round(time.time() - self.created_at, 1),
        }
