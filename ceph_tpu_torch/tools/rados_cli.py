"""`rados` CLI: object-level operations + bench.

Re-expresses the reference's src/tools/rados/rados.cc surface (put/get/
ls-free subset + `rados bench` style throughput run) over the client
API.  Usage:

  python -m ceph_tpu_torch.tools.rados_cli -m HOST:PORT -p POOL put NAME FILE
  python -m ceph_tpu_torch.tools.rados_cli -m HOST:PORT -p POOL get NAME FILE
  python -m ceph_tpu_torch.tools.rados_cli -m HOST:PORT -p POOL rm NAME
  python -m ceph_tpu_torch.tools.rados_cli -m HOST:PORT -p POOL bench SECONDS \\
      write
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def parse_addr(s: str) -> tuple[str, int]:
    host, port = s.rsplit(":", 1)
    return host, int(port)


def cli_auth(args):
    """--keyring/--name/--secure -> (auth_ctx, secure) for CLIs
    (reference CEPH_KEYRING + --name plumbing in the tool frontends)."""
    if not getattr(args, "keyring", None):
        return None, False
    from ..auth import CephxAuth, Keyring
    kr = Keyring.load(args.keyring)
    key = kr.get(args.name)
    if key is None:
        raise SystemExit(f"entity {args.name!r} not in {args.keyring}")
    return CephxAuth(args.name, key=key), bool(args.secure)


def add_auth_args(ap) -> None:
    ap.add_argument("--keyring", default=None,
                    help="keyring file (enables cephx)")
    ap.add_argument("--name", default="client.admin")
    ap.add_argument("--secure", action="store_true",
                    help="AES-GCM frame mode")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rados")
    ap.add_argument("-m", "--mon", required=True, help="mon HOST:PORT")
    ap.add_argument("-p", "--pool", required=True)
    ap.add_argument("command", choices=(
        "put", "get", "rm", "bench", "listomapkeys", "listomapvals",
        "getomapval", "setomapval", "rmomapkey", "getomapheader",
        "setomapheader"))
    ap.add_argument("args", nargs="*")
    ap.add_argument("-b", "--block-size", type=int, default=1 << 20)
    add_auth_args(ap)
    args = ap.parse_args(argv)

    from ..rados import RadosClient

    auth, secure = cli_auth(args)
    client = RadosClient(parse_addr(args.mon), auth=auth,
                         secure=secure).connect()
    try:
        io = client.open_ioctx(args.pool)
        if args.command == "put":
            name, path = args.args
            data = sys.stdin.buffer.read() if path == "-" else \
                open(path, "rb").read()
            io.write_full(name, data)
            print(f"wrote {len(data)} bytes to {name}")
        elif args.command == "get":
            name, path = args.args
            data = io.read(name, 0)
            if path == "-":
                sys.stdout.buffer.write(data)
            else:
                open(path, "wb").write(data)
                print(f"read {len(data)} bytes from {name}")
        elif args.command == "rm":
            io.remove(args.args[0])
            print(f"removed {args.args[0]}")
        elif args.command == "listomapkeys":
            for k in io.omap_get_keys(args.args[0]):
                print(k.decode(errors="replace"))
        elif args.command == "listomapvals":
            for k, v in sorted(io.omap_get_vals(args.args[0]).items()):
                print(f"{k.decode(errors='replace')}")
                print(f"value ({len(v)} bytes) :")
                print(v.decode(errors="replace"))
        elif args.command == "getomapval":
            name, key = args.args[:2]
            kv = io.omap_get_vals_by_keys(name, [key.encode()])
            if key.encode() not in kv:
                print(f"error getting omap value {key}: no such key")
                return 1
            sys.stdout.flush()
            sys.stdout.buffer.write(kv[key.encode()] + b"\n")
            sys.stdout.buffer.flush()
        elif args.command == "setomapval":
            name, key, val = args.args[:3]
            io.omap_set(name, {key.encode(): val.encode()})
        elif args.command == "rmomapkey":
            name, key = args.args[:2]
            io.omap_rm_keys(name, [key.encode()])
        elif args.command == "getomapheader":
            hdr = io.omap_get_header(args.args[0])
            print(f"header ({len(hdr)} bytes) :")
            sys.stdout.flush()
            sys.stdout.buffer.write(hdr + b"\n")
            sys.stdout.buffer.flush()
        elif args.command == "setomapheader":
            name, val = args.args[:2]
            io.omap_set_header(name, val.encode())
        elif args.command == "bench":
            seconds = float(args.args[0]) if args.args else 5.0
            payload = np.random.default_rng(0).integers(
                0, 256, args.block_size, dtype=np.uint8).tobytes()
            t0 = time.time()
            n = 0
            while time.time() - t0 < seconds:
                io.write_full(f"bench_{n}", payload)
                n += 1
            dt = time.time() - t0
            mb = n * args.block_size / 1e6
            print(f"wrote {n} x {args.block_size}B in {dt:.2f}s = "
                  f"{mb / dt:.1f} MB/s")
        return 0
    finally:
        client.shutdown()


if __name__ == "__main__":
    sys.exit(main())
