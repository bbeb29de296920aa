"""ceph_tpu_torch — the erasure-coded data plane on PyTorch and CUDA.

The PyTorch/CUDA counterpart of the `ceph_tpu` package, laid out module
for module like it (`ceph_tpu_torch/ec/gf.py` <-> `ceph_tpu/ec/gf.py`,
and so on) so a reader finds each counterpart by path.  The GF(2^8)
parity and crc32c kernels are hand-written CUDA for Hopper
(`csrc/*.cu`, built with nvcc at first use by `ops/_build.py`); every
kernel keeps a plain PyTorch version beside it, which serves tensors
that lie on the CPU.

Layer map:
  common/   crc32c (numpy tables), perf counters, native CPU library,
            config options, dout logging, admin socket, CephContext,
            op tracking, lockdep, buffers, small helpers
  ec/       codec interface, GF(2^8) matrices, registry, plugins (`torch`
            on the card; `isa`, `jerasure`, `example`, `clay`, `lrc`,
            `shec` on the host)
  ops/      crc32c-as-linear-algebra helpers, kernel wrappers, nvcc build
            and its library cache, the boot prewarm, the operating-point
            autotuner, the launch flight recorder
  parallel/ the sharded stripe codec over a device mesh and its per-host
            MeshService, the per-host launch queue, the CLAY repair plan
  osd/      ECBackend write/read/recovery pipeline, ECUtil, ECTransaction,
            PG log, the OSDMap, the OSD daemon
  crush/    CRUSH placement and the CRUSH text compiler
  msg/      the messenger and its typed messages
  mon/      the monitor, its Paxos quorum and store
  auth/     cephx tickets and authorizers; compressor/ frame compression
  cls/      object classes the daemon runs (lock, numops, log, ...)
  osdc/     the objecter; rados/ the RADOS client and the striper
  rbd/      RBD images: snapshots, clones, diffs, exclusive lock,
            object map, journal
  store/    ObjectStore contract + MemStore, the in-memory kv store
  tools/    ec_benchmark, the kernel sweeps, the vstart dev cluster,
            crushtool and the rados and rbd CLIs
  csrc/     CUDA C++ kernels (sm_90a)

Entry points run on the card unless the caller asks for the CPU
(`device="cpu"`); asking for CUDA without a GPU raises.
"""

from __future__ import annotations

__version__ = "0.1.0"

# Plugins embed this and the registry refuses mismatches (reference:
# src/erasure-code/ErasureCodePlugin.cc:142).
PLUGIN_ABI_VERSION = "ceph-tpu-torch-plugin-1"


def resolve_device(device: "str | torch.device" = "cuda") -> "torch.device":
    """The torch.device an entry point runs on.  "cuda" resolves to the
    current card's indexed device; a CUDA request on a machine without
    a usable GPU raises instead of quietly running on the CPU."""
    import torch      # not at import: the client tools never touch it
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but no CUDA device is "
                "available (pass device='cpu' to run the plain versions)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
