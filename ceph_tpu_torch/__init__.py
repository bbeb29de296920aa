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
            small helpers
  ec/       codec interface, GF(2^8) matrices, registry, plugins (`torch`
            on the card; `isa`, `jerasure`, `example`, `clay`, `lrc`,
            `shec` on the host)
  ops/      crc32c-as-linear-algebra helpers, kernel wrappers, nvcc build,
            the operating-point autotuner, the launch flight recorder
  parallel/ the per-host launch queue, the CLAY repair plan (K4)
  osd/      ECBackend write/read/recovery pipeline, ECUtil, ECTransaction,
            PG log
  store/    ObjectStore contract + MemStore
  tools/    ec_benchmark and the kernel sweeps
  csrc/     CUDA C++ kernels (sm_90a)

Entry points run on the card unless the caller asks for the CPU
(`device="cpu"`); asking for CUDA without a GPU raises.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

# Plugins embed this and the registry refuses mismatches (reference:
# src/erasure-code/ErasureCodePlugin.cc:142).
PLUGIN_ABI_VERSION = "ceph-tpu-torch-plugin-1"


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch.device an entry point runs on.  "cuda" resolves to the
    current card's indexed device; a CUDA request on a machine without
    a usable GPU raises instead of quietly running on the CPU."""
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
