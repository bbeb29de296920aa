"""CRUSH map + rule evaluation.

Re-expresses the reference's crush map model and `crush_do_rule`
(src/crush/crush.h, src/crush/mapper.c) with straw2 bucket selection:

* devices: id >= 0, weight, optional class
* buckets: id < 0, a type (host/rack/root/...), straw2 items
* rules: take -> choose/chooseleaf {firstn|indep} n {type} -> emit

straw2 semantics (reference bucket_straw2_choose, mapper.c:361): each
item draws ln(u)/w with u a per-(input, item, trial) uniform draw and w
its weight; highest draw wins.  This gives weight-proportional selection
and optimal data movement on weight change — the property that matters.
We compute ln in float (the reference uses a 128-entry fixed-point log
table for kernel compatibility; same math, different precision — our
placements are internally stable, which is the actual contract).

firstn vs indep (reference crush_choose_firstn/_indep): firstn fills a
result vector compactly (replicated pools); indep is positional and
leaves holes as NONE (erasure-coded pools, where position = shard id).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from .hash import crush_hash32, crush_unit_interval

CRUSH_ITEM_NONE = 0x7FFFFFFF


@dataclass
class Device:
    id: int
    weight: float
    device_class: str | None = None


@dataclass
class Bucket:
    id: int                       # < 0
    name: str
    type_name: str                # e.g. "host", "rack", "root"
    items: list[int] = field(default_factory=list)   # device or bucket ids
    weights: list[float] = field(default_factory=list)

    @property
    def weight(self) -> float:
        return sum(self.weights)


@dataclass
class Step:
    op: str                       # take | choose | chooseleaf | emit
    num: int = 0                  # for choose*: replica count (0 = all)
    type_name: str | None = None  # failure-domain type for choose*
    mode: str = "firstn"          # firstn | indep
    item: int | str | None = None  # for take: bucket name/id


@dataclass
class Rule:
    id: int
    name: str
    steps: list[Step]
    mode: str = "firstn"          # overall replicated/EC intent


class CrushMap:
    def __init__(self) -> None:
        self.devices: dict[int, Device] = {}
        self.buckets: dict[int, Bucket] = {}
        self.buckets_by_name: dict[str, Bucket] = {}
        self.rules: dict[int, Rule] = {}
        self.tunable_choose_tries = 50   # reference choose_total_tries

    # -- construction -------------------------------------------------------

    def add_device(self, dev_id: int, weight: float,
                   device_class: str | None = None) -> None:
        self.devices[dev_id] = Device(dev_id, weight, device_class)

    def add_bucket(self, bucket_id: int, name: str, type_name: str) -> Bucket:
        assert bucket_id < 0, "bucket ids are negative"
        b = Bucket(bucket_id, name, type_name)
        self.buckets[bucket_id] = b
        self.buckets_by_name[name] = b
        return b

    def bucket_add_item(self, bucket: Bucket, item_id: int,
                        weight: float) -> None:
        bucket.items.append(item_id)
        bucket.weights.append(weight)

    def add_rule(self, rule: Rule) -> int:
        self.rules[rule.id] = rule
        return rule.id

    def item_weight(self, item_id: int) -> float:
        if item_id >= 0:
            d = self.devices.get(item_id)
            return d.weight if d else 0.0
        b = self.buckets.get(item_id)
        return b.weight if b else 0.0

    def item_type(self, item_id: int) -> str:
        if item_id >= 0:
            return "osd"
        return self.buckets[item_id].type_name

    # -- straw2 -------------------------------------------------------------

    def _straw2_choose(self, bucket: Bucket, x: int, r: int,
                       exclude: set[int],
                       weight_of=None) -> int | None:
        """Pick one item of `bucket` for input x, trial r (reference
        bucket_straw2_choose)."""
        best, best_draw = None, -math.inf
        for item, w in zip(bucket.items, bucket.weights):
            if item in exclude:
                continue
            w = weight_of(item) if weight_of else w
            if w <= 0:
                continue
            u = crush_unit_interval(x, item & 0xFFFFFFFF, r)
            draw = math.log(u) / w
            if draw > best_draw:
                best, best_draw = item, draw
        return best

    def _descend_to_type(self, start: int, x: int, r: int,
                         type_name: str, exclude: set[int],
                         weight_of) -> int | None:
        """Walk from `start` down to an item of `type_name` with straw2
        draws at every level."""
        cur = start
        for _ in range(32):  # depth bound
            if self.item_type(cur) == type_name:
                return cur
            b = self.buckets.get(cur)
            if b is None:
                return None
            nxt = self._straw2_choose(b, x, r, exclude, weight_of)
            if nxt is None:
                return None
            cur = nxt
        return None

    # -- rule evaluation (reference crush_do_rule) --------------------------

    def do_rule(self, rule_id: int, x: int, num_rep: int,
                weight_of=None) -> list[int]:
        """Evaluate a rule for input x (pg seed), wanting num_rep items.

        weight_of(item_id)->float overrides device weights (the OSDMap
        layers reweight/out on top of crush weights, reference
        mapper.c's weight vector argument).
        Returns device ids; indep rules return positional results with
        CRUSH_ITEM_NONE holes.
        """
        rule = self.rules[rule_id]
        working: list[int] = []
        out: list[int] = []
        for step in rule.steps:
            if step.op == "take":
                item = step.item
                if isinstance(item, str):
                    item = self.buckets_by_name[item].id
                working = [item]
            elif step.op in ("choose", "chooseleaf"):
                n = step.num or num_rep
                chosen = self._choose(
                    working, x, n, step.type_name, step.mode,
                    leaf=(step.op == "chooseleaf"), weight_of=weight_of)
                working = chosen
            elif step.op == "emit":
                out.extend(working)
                working = []
            else:
                raise ValueError(f"unknown step {step.op}")
        return out[:num_rep] if rule.mode == "firstn" else out

    def _choose(self, parents: list[int], x: int, n: int,
                type_name: str, mode: str, leaf: bool,
                weight_of) -> list[int]:
        results: list[int] = []
        for parent in parents:
            if mode == "indep":
                results.extend(self._choose_indep(
                    parent, x, n, type_name, leaf, weight_of))
            else:
                results.extend(self._choose_firstn(
                    parent, x, n, type_name, leaf, weight_of))
        return results

    def _leaf_of(self, item: int, x: int, r: int,
                 weight_of) -> int | None:
        """chooseleaf: descend from a failure-domain item to an osd."""
        if item >= 0:
            return item
        return self._descend_to_type(item, x, r, "osd", set(), weight_of)

    def _choose_firstn(self, parent: int, x: int, n: int,
                       type_name: str, leaf: bool, weight_of) -> list[int]:
        chosen: list[int] = []
        chosen_domains: set[int] = set()
        r = 0
        tries = 0
        while len(chosen) < n and tries < self.tunable_choose_tries * n:
            tries += 1
            item = self._descend_to_type(parent, x, r, type_name,
                                         chosen_domains, weight_of)
            r += 1
            if item is None:
                continue
            if item in chosen_domains:
                continue
            dev = self._leaf_of(item, x, r, weight_of) if leaf else item
            if dev is None or dev in chosen:
                continue
            if leaf and weight_of and weight_of(dev) <= 0:
                continue
            chosen_domains.add(item)
            chosen.append(dev)
        return chosen

    def _choose_indep(self, parent: int, x: int, n: int,
                      type_name: str, leaf: bool, weight_of) -> list[int]:
        """Positional selection: slot s keeps its draw stream so a failed
        slot doesn't shift the others (reference crush_choose_indep)."""
        slots: list[int] = [CRUSH_ITEM_NONE] * n
        used_domains: set[int] = set()
        used_devs: set[int] = set()
        for s in range(n):
            for attempt in range(self.tunable_choose_tries):
                r = s + attempt * n   # per-slot independent trial stream
                item = self._descend_to_type(parent, x, r, type_name,
                                             used_domains, weight_of)
                if item is None or item in used_domains:
                    continue
                dev = self._leaf_of(item, x, r, weight_of) if leaf else item
                if dev is None or dev in used_devs:
                    continue
                if leaf and weight_of and weight_of(dev) <= 0:
                    continue
                used_domains.add(item)
                used_devs.add(dev)
                slots[s] = dev
                break
        return slots
