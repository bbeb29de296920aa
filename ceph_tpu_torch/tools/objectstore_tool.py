"""ceph-objectstore-tool analog: offline surgery on an OSD's store.

Re-expresses the reference's src/tools/ceph_objectstore_tool.cc surface
this framework needs: with the daemon stopped, open its store (a
FileStore, or with `--type bluestore[-<compressor>]` a BlueStore) and
  --op list-pgs                 collections present
  --op list --pgid P            objects of one PG shard
  --op dump --pgid P OBJ        object size/attrs/omap (hinfo decoded)
  --op export --pgid P --file F export a PG shard's objects
  --op import --file F          re-import into (possibly another) store
  --op remove --pgid P OBJ      surgical removal

Export format: one JSON header line then one JSON record a line —
versioned, so exports survive tool upgrades; ceph_tpu's tool writes and
reads the same format, so an export moves between the packages.

Usage: python -m ceph_tpu_torch.tools.objectstore_tool --data-path DIR --op ...
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def parse_pgid(s: str):
    from ..osd.types import pg_t, spg_t
    # "1.2s3" or "1.2"
    shard = -1
    if "s" in s:
        s, shard_s = s.split("s")
        shard = int(shard_s)
    pool, seed = s.split(".")
    return spg_t(pg_t(int(pool), int(seed, 16)), shard)


def fmt_pgid(cid) -> str:
    return str(cid)


def main(argv=None) -> int:
    from ..osd.ec_util import HINFO_KEY, HashInfo
    from ..store import create_store

    ap = argparse.ArgumentParser(prog="objectstore-tool")
    ap.add_argument("--data-path", required=True)
    ap.add_argument("--type", default="filestore",
                    help="the store's kind: filestore (default), "
                         "bluestore or bluestore-<compressor>")
    ap.add_argument("--op", required=True,
                    choices=("list-pgs", "list", "dump", "export",
                             "import", "remove"))
    ap.add_argument("--pgid")
    ap.add_argument("--file")
    ap.add_argument("object", nargs="?")
    args = ap.parse_args(argv)

    if args.type != "filestore" and not args.type.startswith("bluestore"):
        ap.error(f"unknown --type {args.type!r}")
    store = create_store(args.type, args.data_path)
    store.mount()
    try:
        if args.op == "list-pgs":
            for cid in store.list_collections():
                print(fmt_pgid(cid))
            return 0
        if args.op == "import":
            return do_import(store, args.file)
        cid = parse_pgid(args.pgid)
        if args.op == "list":
            for g in store.list_objects(cid):
                print(g.hobj.name)
            return 0
        if args.op == "dump":
            g = next((g for g in store.list_objects(cid)
                      if g.hobj.name == args.object), None)
            if g is None:
                print(f"no object {args.object}", file=sys.stderr)
                return 1
            attrs = store.getattrs(cid, g)
            out = {
                "oid": g.hobj.name,
                "size": store.stat(cid, g),
                "attrs": {k: v.hex() for k, v in attrs.items()},
                "omap": {k.hex(): v.hex()
                         for k, v in store.omap_get(cid, g).items()},
            }
            if HINFO_KEY in attrs:
                h = HashInfo.decode(attrs[HINFO_KEY])
                out["hinfo"] = {
                    "total_chunk_size": h.total_chunk_size,
                    "logical_size": h.logical_size,
                    "shard_crcs": [hex(c)
                                   for c in h.cumulative_shard_hashes],
                }
            print(json.dumps(out, indent=2))
            return 0
        if args.op == "export":
            return do_export(store, cid, args.file)
        if args.op == "remove":
            from ..store.object_store import Transaction
            g = next((g for g in store.list_objects(cid)
                      if g.hobj.name == args.object), None)
            if g is None:
                print(f"no object {args.object}", file=sys.stderr)
                return 1
            t = Transaction()
            t.remove(g)
            store.queue_transactions(cid, [t])
            print(f"removed {args.object}")
            return 0
        return 2
    finally:
        store.umount()


def do_export(store, cid, path: str) -> int:
    with open(path, "w") as f:
        f.write(json.dumps({"version": 1,
                            "pgid": [cid.pgid.pool, cid.pgid.seed,
                                     cid.shard]}) + "\n")
        count = 0
        for g in store.list_objects(cid):
            rec = {
                "oid": [g.hobj.pool, g.hobj.name, g.hobj.key,
                        g.hobj.snap, g.hobj.hash],
                "gen": g.generation, "shard": g.shard,
                "data": store.read(cid, g).tobytes().hex(),
                "attrs": {k: v.hex()
                          for k, v in store.getattrs(cid, g).items()},
                "omap": {k.hex(): v.hex()
                         for k, v in store.omap_get(cid, g).items()},
            }
            f.write(json.dumps(rec) + "\n")
            count += 1
    print(f"exported {count} objects from {fmt_pgid(cid)} to {path}")
    return 0


def do_import(store, path: str) -> int:
    from ..osd.types import ghobject_t, hobject_t, pg_t, spg_t
    from ..store.object_store import Transaction
    with open(path) as f:
        header = json.loads(f.readline())
        assert header["version"] == 1
        pool, seed, shard = header["pgid"]
        cid = spg_t(pg_t(pool, seed), shard)
        store.create_collection(cid)
        count = 0
        for line in f:
            rec = json.loads(line)
            h = hobject_t(*rec["oid"])
            g = ghobject_t(h, rec["gen"], rec["shard"])
            t = Transaction()
            t.write(g, 0, np.frombuffer(
                bytes.fromhex(rec["data"]), dtype=np.uint8))
            if rec["attrs"]:
                t.setattrs(g, {k: bytes.fromhex(v)
                               for k, v in rec["attrs"].items()})
            if rec["omap"]:
                t.omap_setkeys(g, {bytes.fromhex(k): bytes.fromhex(v)
                                   for k, v in rec["omap"].items()})
            store.queue_transactions(cid, [t])
            count += 1
    print(f"imported {count} objects into {fmt_pgid(cid)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
