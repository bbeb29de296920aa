"""OSDMap: the epoch-versioned cluster map.

Re-expresses reference src/osd/OSDMap.{h,cc}: which OSDs exist/are
up/in, their addresses and weights, the pools (`pg_pool_t` with type,
size, pg_num, EC profile, stripe_width), pg_temp overrides, and the
placement queries everything uses — object -> PG -> OSDs
(`pg_to_up_acting_osds`, reference OSDMap.cc:2627, which runs CRUSH and
then applies up/down filtering and overrides).

Incremental maps: `Incremental` records deltas; `apply_incremental`
advances the epoch.  (The mon is the sole author; everyone else applies.)
The delta is produced by structural diff of the committed wire JSON
(`Incremental.diff`) rather than by mutation recording — the reference's
`OSDMap::Incremental` is likewise a new_*/old_* delta encoding, and the
diff construction makes `apply_incremental(full_{e-1}) == full_e`
bit-equal BY CONSTRUCTION for every mutator, present and future, instead
of relying on each mutation site to remember to record itself.
"""

from __future__ import annotations

import json

from dataclasses import dataclass, field, replace

from ..crush import CrushWrapper
from ..crush.hash import crush_hash32
from ..crush.map import CRUSH_ITEM_NONE
from .types import PoolType, pg_t, spg_t


@dataclass
class PGPool:
    """pg_pool_t (reference osd_types.h)."""
    id: int
    name: str
    type: PoolType
    size: int                     # replicas or k+m
    min_size: int
    pg_num: int
    crush_rule: int
    erasure_code_profile: str = ""
    stripe_width: int = 0
    # self-managed snapshot id allocator (reference pg_pool_t snap_seq
    # for SNAP_MODE_SELFMANAGED; the mon allocates ids, clients carry
    # them in per-op SnapContexts) + deleted ids awaiting trim
    # (reference pg_pool_t removed_snaps interval set)
    snap_seq: int = 0
    removed_snaps: list = field(default_factory=list)
    # pg_autoscaler authority (reference pg_pool_t pg_autoscale_mode):
    # "warn" = advisory only (health warning), "on" = the mgr module
    # may issue real pg_num changes (both directions) through the mon
    pg_autoscale_mode: str = "warn"
    # highest pg_num this pool ever had (reference: the role of
    # pg_num_pending/past_intervals history for merges).  Committed in
    # the map so ANY osd — including one that was down across the
    # shrink — can derive which seeds are dying merge children
    # (pg_num <= seed < pg_num_max) and where their data may still
    # sit.  0 means "never resized" (treat as pg_num).
    pg_num_max: int = 0

    def pg_num_ever(self) -> int:
        return max(self.pg_num, self.pg_num_max)

    def is_erasure(self) -> bool:
        return self.type == PoolType.ERASURE


def validate_pg_num_step(cur: int, new: int) -> None:
    """Structural validation for a pg_num change, shared by the mon
    command path and the map mutator (one source of truth for the
    error strings): >= 1, and powers of two on both sides — the
    ps-bits rule (child = hash mod pg_num) only folds exactly when
    both counts are powers of two, in either direction."""
    if new < 1:
        raise ValueError(
            f"pg_num {new} below 1: a pool needs at least one PG")
    if new & (new - 1) or cur & (cur - 1):
        raise ValueError(
            f"pg_num must step between powers of two "
            f"({cur} -> {new}): the ps-bits rule "
            f"(child = hash mod pg_num) only folds exactly when "
            f"both counts are powers of two")


@dataclass
class OSDInfo:
    id: int
    up: bool = False
    in_: bool = True
    weight: float = 1.0           # reweight in [0,1]
    addr: tuple[str, int] | None = None


class OSDMap:
    def __init__(self) -> None:
        self.epoch = 0
        self.osds: dict[int, OSDInfo] = {}
        self.pools: dict[int, PGPool] = {}
        self.pool_ids_by_name: dict[str, int] = {}
        self.crush = CrushWrapper()
        self.pg_temp: dict[pg_t, list[int]] = {}
        # fine-grained balancer overrides (reference pg_upmap_items,
        # OSDMap.h): per-PG [from, to] device substitutions applied to
        # the RAW crush result — unlike pg_temp (a whole acting-set
        # override for peering/backfill), upmap items survive remaps of
        # unrelated devices and compose with CRUSH
        self.pg_upmap_items: dict[pg_t, list[tuple[int, int]]] = {}
        # memo of the raw CRUSH walk per pg — the per-op hot path's
        # expensive part; pure in (crush, pools), so every structural
        # mutator below invalidates.  pg_temp/upmap overlays apply
        # live on top (they may be mutated directly in tests/tools)
        self._pg_cache: dict[pg_t, list[int]] = {}
        self.ec_profiles: dict[str, dict[str, str]] = {}
        # client fencing (reference OSDMap blacklist, consumed by
        # ManagedLock): messenger entity -> expiry unix time.  OSDs
        # reject ops from blacklisted entities with -ESHUTDOWN (the
        # EBLACKLISTED role), closing the in-flight-op window an
        # exclusive-lock steal leaves open.
        self.blacklist: dict[str, float] = {}

    # -- queries ------------------------------------------------------------

    def get_pool(self, pool_id: int) -> PGPool | None:
        return self.pools.get(pool_id)

    def lookup_pool(self, name: str) -> PGPool | None:
        pid = self.pool_ids_by_name.get(name)
        return self.pools.get(pid) if pid is not None else None

    def is_up(self, osd: int) -> bool:
        o = self.osds.get(osd)
        return bool(o and o.up)

    def object_to_pg(self, pool_id: int, name: str, key: str = "") -> pg_t:
        """object name -> pg seed (reference object_locator_to_pg via
        ceph_str_hash + ceph_stable_mod)."""
        pool = self.pools[pool_id]
        h = crush_hash32(key or name)
        return pg_t(pool_id, h % pool.pg_num)

    def _weight_of(self):
        osds = self.osds

        def weight(item: int) -> float:
            if item < 0:
                return 1.0
            o = osds.get(item)
            if o is None or not o.in_:
                return 0.0
            return o.weight
        return weight

    def pg_to_raw_osds(self, pgid: pg_t) -> list[int]:
        hit = self._pg_cache.get(pgid)
        if hit is not None:
            return list(hit)
        pool = self.pools[pgid.pool]
        x = crush_hash32(pgid.pool, pgid.seed)
        out = self.crush.do_rule(pool.crush_rule, x, pool.size,
                                 weight_of=self._weight_of())
        self._pg_cache[pgid] = list(out)
        return out

    def pg_to_raw_upmap_osds(self, pgid: pg_t) -> list[int]:
        """Raw crush result with pg_upmap_items applied, BEFORE any
        up/down filtering — the positional list the balancer diffs
        against (reference _pg_to_raw_osds + _apply_upmap)."""
        raw = self.pg_to_raw_osds(pgid)
        pairs = self.pg_upmap_items.get(pgid)
        if pairs:
            mapping = dict(pairs)
            cand = [mapping.get(d, d) for d in raw]
            live = [d for d in cand if d != CRUSH_ITEM_NONE]
            if len(set(live)) == len(live):
                raw = cand
        return raw

    def pg_to_up_acting_osds(self, pgid: pg_t
                             ) -> tuple[list[int], list[int], int, int]:
        """(up, acting, up_primary, acting_primary) — reference
        OSDMap.cc:2627.  EC pools keep positional NONE holes; replicated
        pools compact them out."""
        pool = self.pools[pgid.pool]
        raw = self.pg_to_raw_upmap_osds(pgid)
        if pool.is_erasure():
            up = [d if d != CRUSH_ITEM_NONE and self.is_up(d)
                  else CRUSH_ITEM_NONE for d in raw]
        else:
            up = [d for d in raw if d != CRUSH_ITEM_NONE and self.is_up(d)]
        acting = self.pg_temp.get(pgid, up)
        up_primary = next((d for d in up if d != CRUSH_ITEM_NONE), -1)
        acting_primary = next(
            (d for d in acting if d != CRUSH_ITEM_NONE), -1)
        return up, acting, up_primary, acting_primary

    def primary_shard(self, pgid: pg_t) -> spg_t | None:
        pool = self.pools[pgid.pool]
        up, acting, _, primary = self.pg_to_up_acting_osds(pgid)
        if primary < 0:
            return None
        if pool.is_erasure():
            return spg_t(pgid, acting.index(primary))
        return spg_t(pgid)

    # -- mutation (mon-side) ------------------------------------------------

    def add_osd(self, osd_id: int, host: str, weight: float = 1.0,
                addr: tuple[str, int] | None = None) -> None:
        self.osds[osd_id] = OSDInfo(osd_id, up=False, in_=True,
                                    weight=1.0, addr=addr)
        self.crush.add_osd(osd_id, weight, host)
        self._pg_cache.clear()

    def set_osd_up(self, osd_id: int, addr: tuple[str, int] | None = None
                   ) -> None:
        o = self.osds[osd_id]
        o.up = True
        if addr:
            o.addr = addr
        self._pg_cache.clear()

    def set_osd_down(self, osd_id: int) -> None:
        if osd_id in self.osds:
            self.osds[osd_id].up = False
        self._pg_cache.clear()

    def set_osd_out(self, osd_id: int) -> None:
        if osd_id in self.osds:
            self.osds[osd_id].in_ = False
        self._pg_cache.clear()

    def set_osd_weight(self, osd_id: int, weight: float) -> None:
        """Reweight in [0,1] (reference `osd reweight`): CRUSH draws
        scale by it, so walking it to 0 backfills every PG off the OSD
        while the daemon stays up to serve as a recovery source."""
        if not 0.0 <= weight <= 1.0:
            raise ValueError(f"weight {weight} not in [0, 1]")
        self.osds[osd_id].weight = weight
        self._pg_cache.clear()

    def remove_osd(self, osd_id: int) -> None:
        """Drop an OSD from the map entirely (reference `osd rm` +
        `osd crush remove`): device, crush bucket membership, and any
        override-table entries naming it."""
        self.osds.pop(osd_id, None)
        self.crush.remove_osd(osd_id)
        self.pg_temp = {pg: v for pg, v in self.pg_temp.items()
                        if osd_id not in v}
        self.pg_upmap_items = {
            pg: pairs for pg, pairs in self.pg_upmap_items.items()
            if all(osd_id not in p for p in pairs)}
        self._pg_cache.clear()

    def create_pool(self, name: str, type_: PoolType, size: int,
                    pg_num: int, crush_rule: int,
                    erasure_code_profile: str = "",
                    stripe_width: int = 0,
                    min_size: int | None = None) -> PGPool:
        pid = max(self.pools, default=0) + 1
        if min_size is None:
            min_size = size - 1 if type_ == PoolType.REPLICATED else size
        pool = PGPool(pid, name, type_, size, min_size, pg_num, crush_rule,
                      erasure_code_profile, stripe_width)
        self.pools[pid] = pool
        self.pool_ids_by_name[name] = pid
        return pool

    def set_pool_pg_num(self, pool_id: int, new_pg_num: int) -> None:
        """Resize a pool's pg_num in EITHER direction (PG split or
        merge; reference OSDMonitor prepare_command pg_num change —
        decrease landed in Nautilus).  Structural validation lives
        here (the mon command path adds cluster-state gating such as
        the split/merge interleave guard); the mutator also keeps the
        override tables consistent: every pg_temp and pg_upmap_items
        entry of the pool is pruned — a resize is a new interval for
        every PG of the pool (parents change content, children are
        born or die), so acting-set and raw-mapping overrides computed
        for the old interval no longer describe anything (reference
        OSDMonitor clean_temps + maybe_remove_pg_upmaps pruning on
        pg_num change)."""
        pool = self.pools[pool_id]
        validate_pg_num_step(pool.pg_num, new_pg_num)
        pool.pg_num_max = max(pool.pg_num_ever(), new_pg_num)
        pool.pg_num = new_pg_num
        self.pg_temp = {pg: v for pg, v in self.pg_temp.items()
                        if pg.pool != pool_id}
        self.pg_upmap_items = {pg: v for pg, v in
                               self.pg_upmap_items.items()
                               if pg.pool != pool_id}
        self._pg_cache.clear()

    def bump_epoch(self) -> int:
        self.epoch += 1
        self._pg_cache.clear()
        return self.epoch

    # -- incremental adoption (subscriber side) -----------------------------

    def canonical(self) -> str:
        """Order-independent canonical serialization — the bit-equality
        yardstick: two maps are the same state iff their canonical
        strings are equal (wire JSON list ordering is insertion-order
        on the mon and id-order after an incremental rebuild; no query
        depends on it)."""
        return json.dumps(map_json_keyed(self.to_json()), sort_keys=True)

    def apply_incremental(self, inc: "Incremental") -> "OSDMap":
        """Advance this map by one committed delta, returning the NEW
        map (the adoption paths replace their map wholesale, like the
        full-map path).  Raises ValueError on an epoch gap — the caller
        falls back to an explicit full-map re-request."""
        if inc.prev != self.epoch:
            raise ValueError(
                f"incremental {inc.prev}->{inc.epoch} does not apply "
                f"to epoch {self.epoch} (gap)")
        keyed = map_json_keyed(self.to_json())
        inc.patch(keyed)
        return OSDMap.from_json(keyed_to_map_json(keyed))

    # -- wire form (mon -> everyone; reference OSDMap::encode) --------------

    def to_json(self) -> dict:
        from ..crush.map import Rule, Step
        crush = self.crush.map
        # every mutable container is COPIED: a to_json snapshot (the
        # mon's committed value, the incremental diff base) must not
        # change underneath when the live map mutates in place
        return {
            "epoch": self.epoch,
            "osds": [[o.id, o.up, o.in_, o.weight, list(o.addr or ())]
                     for o in self.osds.values()],
            "pools": [[p.id, p.name, int(p.type), p.size, p.min_size,
                       p.pg_num, p.crush_rule, p.erasure_code_profile,
                       p.stripe_width, p.snap_seq,
                       list(p.removed_snaps), p.pg_autoscale_mode,
                       p.pg_num_max]
                      for p in self.pools.values()],
            "pg_temp": [[pg.pool, pg.seed, list(osds)]
                        for pg, osds in self.pg_temp.items()],
            "pg_upmap_items": [
                [pg.pool, pg.seed, [list(p) for p in pairs]]
                for pg, pairs in self.pg_upmap_items.items()],
            "ec_profiles": {name: dict(p)
                            for name, p in self.ec_profiles.items()},
            "blacklist": dict(self.blacklist),
            "crush": {
                "devices": [[d.id, d.weight, d.device_class]
                            for d in crush.devices.values()],
                "buckets": [[b.id, b.name, b.type_name, list(b.items),
                             list(b.weights)]
                            for b in crush.buckets.values()],
                "rules": [[r.id, r.name, r.mode,
                           [[s.op, s.num, s.type_name, s.mode, s.item]
                            for s in r.steps]]
                          for r in crush.rules.values()],
                "next_bucket_id": self.crush._next_bucket_id,
                "next_rule_id": self.crush._next_rule_id,
            },
        }

    @classmethod
    def from_json(cls, j: dict) -> "OSDMap":
        from ..crush.map import Bucket, Rule, Step
        m = cls()
        m.epoch = j["epoch"]
        for oid_, up, in_, w, addr in j["osds"]:
            m.osds[oid_] = OSDInfo(oid_, up, in_, w,
                                   tuple(addr) if addr else None)
        for rec in j["pools"]:
            pid, name, t, size, msize, pgn, rule, prof, sw = rec[:9]
            snap_seq = rec[9] if len(rec) > 9 else 0
            removed = list(rec[10]) if len(rec) > 10 else []
            autoscale = rec[11] if len(rec) > 11 else "warn"
            pg_num_max = rec[12] if len(rec) > 12 else 0
            m.pools[pid] = PGPool(pid, name, PoolType(t), size, msize,
                                  pgn, rule, prof, sw,
                                  snap_seq=snap_seq,
                                  removed_snaps=removed,
                                  pg_autoscale_mode=autoscale,
                                  pg_num_max=pg_num_max)
            m.pool_ids_by_name[name] = pid
        for pool, seed, osds in j.get("pg_temp", []):
            m.pg_temp[pg_t(pool, seed)] = osds
        for pool, seed, pairs in j.get("pg_upmap_items", []):
            m.pg_upmap_items[pg_t(pool, seed)] = \
                [tuple(p) for p in pairs]
        m.ec_profiles = dict(j.get("ec_profiles", {}))
        m.blacklist = dict(j.get("blacklist", {}))
        cj = j["crush"]
        cm = m.crush.map
        for did, w, dc in cj["devices"]:
            cm.devices[did] = __import__(
                "ceph_tpu_torch.crush.map", fromlist=["Device"]).Device(did, w, dc)
        for bid, name, tname, items, weights in cj["buckets"]:
            b = Bucket(bid, name, tname, list(items), list(weights))
            cm.buckets[bid] = b
            cm.buckets_by_name[name] = b
        for rid, name, mode, steps in cj["rules"]:
            cm.rules[rid] = Rule(rid, name,
                                 [Step(op=s[0], num=s[1], type_name=s[2],
                                       mode=s[3], item=s[4]) for s in steps],
                                 mode=mode)
        m.crush._next_bucket_id = cj["next_bucket_id"]
        m.crush._next_rule_id = cj["next_rule_id"]
        return m


# -- incremental maps (reference OSDMap::Incremental + the MOSDMap
#    incremental ranges OSDMonitor::send_incremental ships) -----------------
#
# The wire JSON's sections re-keyed as dicts so a delta is a set of
# dict set/del operations and map equality is order-independent.

_KEYED_SECTIONS = ("osds", "pools", "pg_temp", "pg_upmap_items",
                   "ec_profiles", "blacklist", "crush_devices",
                   "crush_buckets", "crush_rules")
_SCALAR_KEYS = ("next_bucket_id", "next_rule_id")


def map_json_keyed(j: dict) -> dict:
    """Canonical keyed form of a full-map wire JSON (extra keys such
    as the piggybacked central config are dropped — they are not map
    state)."""
    crush = j.get("crush", {})
    return {
        "epoch": j["epoch"],
        "osds": {str(rec[0]): list(rec) for rec in j.get("osds", [])},
        "pools": {str(rec[0]): list(rec) for rec in j.get("pools", [])},
        "pg_temp": {f"{pool}.{seed}": [pool, seed, list(osds)]
                    for pool, seed, osds in j.get("pg_temp", [])},
        "pg_upmap_items": {
            f"{pool}.{seed}": [pool, seed,
                               [list(p) for p in pairs]]
            for pool, seed, pairs in j.get("pg_upmap_items", [])},
        "ec_profiles": {name: dict(p)
                        for name, p in j.get("ec_profiles", {}).items()},
        "blacklist": dict(j.get("blacklist", {})),
        "crush_devices": {str(rec[0]): list(rec)
                          for rec in crush.get("devices", [])},
        "crush_buckets": {str(rec[0]): list(rec)
                          for rec in crush.get("buckets", [])},
        "crush_rules": {str(rec[0]): list(rec)
                        for rec in crush.get("rules", [])},
        "next_bucket_id": crush.get("next_bucket_id", -1),
        "next_rule_id": crush.get("next_rule_id", 0),
    }


def keyed_to_map_json(keyed: dict) -> dict:
    """Rebuild a from_json-consumable full-map JSON from the keyed
    form (sections come out id-ordered; nothing reads the order)."""
    def by_id(sec: str) -> list:
        return [keyed[sec][k]
                for k in sorted(keyed[sec], key=lambda s: int(s))]

    def by_pg(sec: str) -> list:
        return [keyed[sec][k] for k in sorted(
            keyed[sec], key=lambda s: tuple(map(int, s.split("."))))]

    return {
        "epoch": keyed["epoch"],
        "osds": by_id("osds"),
        "pools": by_id("pools"),
        "pg_temp": by_pg("pg_temp"),
        "pg_upmap_items": by_pg("pg_upmap_items"),
        "ec_profiles": keyed["ec_profiles"],
        "blacklist": keyed["blacklist"],
        "crush": {
            "devices": by_id("crush_devices"),
            "buckets": by_id("crush_buckets"),
            "rules": by_id("crush_rules"),
            "next_bucket_id": keyed["next_bucket_id"],
            "next_rule_id": keyed["next_rule_id"],
        },
    }


def apply_inc_chain(osdmap: OSDMap, incs: list) -> OSDMap | None:
    """Apply a published delta chain (Incremental wire JSONs, oldest
    first) on top of `osdmap`: already-applied epochs are skipped
    (duplicate delivery), and None means an epoch GAP — the caller
    must fall back to an explicit full-map request.  The one applier
    shared by OSD, objecter, and mgr."""
    m = osdmap
    try:
        for j in incs:
            inc = Incremental.from_json(j)
            if inc.epoch <= m.epoch:
                continue
            m = m.apply_incremental(inc)
    except ValueError:
        return None
    return m


@dataclass
class Incremental:
    """One committed epoch's delta: apply on top of epoch `prev` to
    reach epoch `epoch`.  Sections carry full replacement records for
    changed/added keys and a removal list — the shape of the
    reference's new_*/old_* maps in OSDMap::Incremental."""
    epoch: int
    prev: int
    sets: dict = field(default_factory=dict)   # section -> {key: record}
    dels: dict = field(default_factory=dict)   # section -> [keys]

    @classmethod
    def diff(cls, old_j: dict, new_j: dict) -> "Incremental":
        """Structural diff of two full-map wire JSONs (old -> new)."""
        ok, nk = map_json_keyed(old_j), map_json_keyed(new_j)
        sets: dict = {}
        dels: dict = {}
        for sec in _KEYED_SECTIONS:
            o, n = ok[sec], nk[sec]
            changed = {k: v for k, v in n.items() if o.get(k) != v}
            gone = sorted(k for k in o if k not in n)
            if changed:
                sets[sec] = changed
            if gone:
                dels[sec] = gone
        scalars = {k: nk[k] for k in _SCALAR_KEYS if ok[k] != nk[k]}
        if scalars:
            sets["_scalars"] = scalars
        return cls(epoch=nk["epoch"], prev=ok["epoch"],
                   sets=sets, dels=dels)

    def patch(self, keyed: dict) -> None:
        """Apply in place onto a keyed full-map form."""
        for sec, keys in self.dels.items():
            d = keyed.get(sec)
            if d is not None:
                for k in keys:
                    d.pop(k, None)
        for sec, vals in self.sets.items():
            if sec == "_scalars":
                keyed.update(vals)
            else:
                keyed.setdefault(sec, {}).update(vals)
        keyed["epoch"] = self.epoch

    def to_json(self) -> dict:
        return {"epoch": self.epoch, "prev": self.prev,
                "set": self.sets, "del": self.dels}

    @classmethod
    def from_json(cls, j: dict) -> "Incremental":
        return cls(epoch=j["epoch"], prev=j["prev"],
                   sets=dict(j.get("set", {})),
                   dels=dict(j.get("del", {})))
