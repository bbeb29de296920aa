"""`rbd` CLI: image management + I/O over the rbd library.

Re-expresses the reference's src/tools/rbd surface (rbd.cc action
dispatch) at the subset the library supports:

  rbd -m MON -p POOL create NAME --size BYTES [--order N]
  rbd -m MON -p POOL ls
  rbd -m MON -p POOL info NAME
  rbd -m MON -p POOL rm NAME
  rbd -m MON -p POOL resize NAME --size BYTES
  rbd -m MON -p POOL snap create NAME@SNAP
  rbd -m MON -p POOL snap ls NAME
  rbd -m MON -p POOL snap rm NAME@SNAP
  rbd -m MON -p POOL snap rollback NAME@SNAP
  rbd -m MON -p POOL clone PARENT@SNAP CHILD
  rbd -m MON -p POOL flatten NAME
  rbd -m MON -p POOL export NAME FILE      ('-' = stdout)
  rbd -m MON -p POOL import FILE NAME      ('-' = stdin)
  rbd -m MON -p POOL export-diff [--from-snap A] NAME[@B] FILE
  rbd -m MON -p POOL import-diff FILE NAME
  rbd -m MON -p POOL du NAME
  rbd -m MON -p POOL lock ls NAME
  rbd -m MON -p POOL bench NAME --io-size N --io-total N
"""

from __future__ import annotations

import argparse
import sys
import time

from .rados_cli import add_auth_args, cli_auth, parse_addr


def _split_at(spec: str) -> tuple[str, str]:
    name, _, snap = spec.partition("@")
    if not snap:
        raise SystemExit(f"expected IMAGE@SNAP, got {spec!r}")
    return name, snap


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rbd")
    ap.add_argument("-m", "--mon", required=True, help="mon HOST:PORT")
    ap.add_argument("-p", "--pool", required=True)
    ap.add_argument("command")
    ap.add_argument("args", nargs="*")
    ap.add_argument("--size", type=int, default=None)
    ap.add_argument("--order", type=int, default=22)
    ap.add_argument("--io-size", type=int, default=1 << 20)
    ap.add_argument("--io-total", type=int, default=64 << 20)
    ap.add_argument("--exclusive", action="store_true",
                    help="hold the exclusive lock during I/O commands")
    ap.add_argument("--from-snap", default=None,
                    help="export-diff: the base snapshot")
    add_auth_args(ap)
    # parse_intermixed_args, not parse_args: with the greedy
    # (command, args*) positional pattern, plain parse_args consumes
    # the positional group BEFORE a following option and then rejects
    # positionals after it — `rbd create --size N NAME` died with
    # "unrecognized arguments: NAME" while `rbd create NAME --size N`
    # worked; intermixed parsing collects positionals across option
    # boundaries the way the reference rbd CLI accepts them
    args = ap.parse_intermixed_args(argv)

    from ..rados import RadosClient
    from ..rados.client import RadosError
    from ..rbd import RBD, Image

    auth, secure = cli_auth(args)
    client = RadosClient(parse_addr(args.mon), auth=auth,
                         secure=secure).connect()
    try:
        io = client.open_ioctx(args.pool)
        rbd = RBD(io)
        cmd, rest = args.command, args.args
        if cmd == "create":
            if args.size is None:
                raise SystemExit("create requires --size")
            rbd.create(rest[0], args.size, order=args.order)
        elif cmd == "ls":
            for n in rbd.list():
                print(n)
        elif cmd == "info":
            img = Image(io, rest[0])
            print(f"rbd image '{rest[0]}':")
            print(f"\tsize {img.size()} bytes in "
                  f"{img._nblocks()} objects")
            print(f"\torder {img._header['order']} "
                  f"({img.block_size} byte objects)")
            if img._header.get("parent"):
                p, s = img._header["parent"]
                print(f"\tparent: {p} (snap id {s})")
            snaps = img.snap_list()
            if snaps:
                print(f"\tsnapshots: {', '.join(snaps)}")
        elif cmd == "rm":
            rbd.remove(rest[0])
        elif cmd == "resize":
            if args.size is None:
                raise SystemExit("resize requires --size")
            img = Image(io, rest[0], exclusive=args.exclusive)
            img.resize(args.size)
            img.close()
        elif cmd == "snap":
            sub = rest[0]
            if sub == "ls":
                for s in Image(io, rest[1]).snap_list():
                    print(s)
            else:
                name, snap = _split_at(rest[1])
                img = Image(io, name, exclusive=args.exclusive)
                if sub == "create":
                    img.snap_create(snap)
                elif sub == "rm":
                    img.snap_remove(snap)
                elif sub == "rollback":
                    img.snap_rollback(snap)
                else:
                    raise SystemExit(f"unknown snap subcommand {sub!r}")
                img.close()
        elif cmd == "clone":
            parent, snap = _split_at(rest[0])
            rbd.clone(parent, snap, rest[1])
        elif cmd == "flatten":
            img = Image(io, rest[0], exclusive=args.exclusive)
            img.flatten()
            img.close()
        elif cmd == "export":
            img = Image(io, rest[0])
            data = img.read(0, img.size())
            if rest[1] == "-":
                sys.stdout.buffer.write(data)
            else:
                open(rest[1], "wb").write(data)
                print(f"exported {len(data)} bytes")
        elif cmd == "import":
            data = sys.stdin.buffer.read() if rest[0] == "-" else \
                open(rest[0], "rb").read()
            name = rest[1]
            rbd.create(name, len(data), order=args.order)
            img = Image(io, name, exclusive=args.exclusive)
            img.write(0, data)
            img.close()
            print(f"imported {len(data)} bytes to {name}")
        elif cmd == "export-diff":
            # rbd export-diff [--from-snap S] IMG[@TO] FILE
            name, to_snap = _split_at(rest[0]) if "@" in rest[0] \
                else (rest[0], None)
            img = Image(io, name)
            out = sys.stdout.buffer if rest[1] == "-" else \
                open(rest[1], "wb")
            n = img.export_diff(out, from_snap=args.from_snap,
                                to_snap=to_snap)
            if rest[1] != "-":
                out.close()
                print(f"exported {n} changed extents")
        elif cmd == "import-diff":
            # rbd import-diff FILE IMG
            inp = sys.stdin.buffer if rest[0] == "-" else \
                open(rest[0], "rb")
            img = Image(io, rest[1], exclusive=args.exclusive)
            stats = img.import_diff(inp)
            img.close()
            print(f"applied {stats['w']} writes / {stats['z']} zero "
                  f"runs ({stats['bytes']} bytes)")
        elif cmd == "du":
            img = Image(io, rest[0], exclusive=args.exclusive)
            used = img.du()
            print(f"{rest[0]}: {img.size()} provisioned, {used} used")
            img.close()
        elif cmd == "lock":
            if rest[0] != "ls":
                raise SystemExit(f"unknown lock subcommand {rest[0]!r}")
            for owner in Image(io, rest[1]).lock_owners():
                print(owner)
        elif cmd == "bench":
            img = Image(io, rest[0], exclusive=args.exclusive)
            import numpy as np
            payload = np.random.default_rng(0).integers(
                0, 256, args.io_size, dtype=np.uint8).tobytes()
            total = min(args.io_total, img.size())
            t0 = time.time()
            off = 0
            n = 0
            while off + args.io_size <= total:
                img.write(off, payload)
                off += args.io_size
                n += 1
            dt = time.time() - t0
            img.close()
            print(f"wrote {n} x {args.io_size}B in {dt:.2f}s = "
                  f"{n * args.io_size / dt / 1e6:.1f} MB/s")
        else:
            raise SystemExit(f"unknown command {cmd!r}")
        return 0
    except RadosError as e:
        print(f"rbd: {e}", file=sys.stderr)
        return 1
    finally:
        client.shutdown()


if __name__ == "__main__":
    sys.exit(main())
