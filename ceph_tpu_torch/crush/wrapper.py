"""CrushWrapper: map-building convenience API.

Re-expresses the reference's CrushWrapper (src/crush/CrushWrapper.h)
surface the rest of the system uses: build a hierarchy from a flat
device list, add_simple_rule (what EC create_rule calls, reference
src/erasure-code/ErasureCode.cc:64-83), lookup by name.
"""

from __future__ import annotations

from .map import Bucket, CrushMap, Rule, Step


class CrushWrapper:
    def __init__(self) -> None:
        self.map = CrushMap()
        self._next_bucket_id = -1
        self._next_rule_id = 0

    # -- hierarchy building -------------------------------------------------

    def _alloc_bucket_id(self) -> int:
        bid = self._next_bucket_id
        self._next_bucket_id -= 1
        return bid

    def ensure_bucket(self, name: str, type_name: str) -> Bucket:
        b = self.map.buckets_by_name.get(name)
        if b is None:
            b = self.map.add_bucket(self._alloc_bucket_id(), name, type_name)
        return b

    def add_osd(self, osd_id: int, weight: float, host: str,
                root: str = "default") -> None:
        """Add a device under host under root (the standard 3-level
        default hierarchy cephadm builds)."""
        self.map.add_device(osd_id, weight)
        rb = self.ensure_bucket(root, "root")
        hb = self.ensure_bucket(host, "host")
        if hb.id not in rb.items:
            self.map.bucket_add_item(rb, hb.id, 0.0)
        self.map.bucket_add_item(hb, osd_id, weight)
        # parent weight = sum of children
        rb.weights[rb.items.index(hb.id)] = hb.weight

    def remove_osd(self, osd_id: int) -> None:
        """Remove a device and its bucket membership (reference
        CrushWrapper::remove_item): the device row goes away and every
        bucket drops it, with parent weights re-summed so straw2 draws
        stop landing on the hole."""
        self.map.devices.pop(osd_id, None)
        for b in self.map.buckets.values():
            if osd_id in b.items:
                i = b.items.index(osd_id)
                del b.items[i]
                del b.weights[i]
        # re-sum interior bucket weights to a fixpoint: dict order is
        # insertion order (parents usually precede children), so one
        # pass could copy a stale child weight in a >=3-level
        # hierarchy — iterate until no entry changes (bounded by the
        # hierarchy depth)
        for _ in range(len(self.map.buckets) + 1):
            changed = False
            for b in self.map.buckets.values():
                for i, item in enumerate(b.items):
                    if item < 0:
                        child = self.map.buckets.get(item)
                        if child is not None and \
                                b.weights[i] != child.weight:
                            b.weights[i] = child.weight
                            changed = True
            if not changed:
                break

    # -- rules --------------------------------------------------------------

    def add_simple_rule(self, name: str, root: str, failure_domain: str,
                        num_rep: int = 0, rule_mode: str = "firstn") -> int:
        """reference CrushWrapper::add_simple_rule; EC passes indep +
        k+m (ErasureCode.cc:69)."""
        for r in self.map.rules.values():
            if r.name == name:
                return r.id
        rid = self._next_rule_id
        self._next_rule_id += 1
        steps = [
            Step(op="take", item=root),
            Step(op="chooseleaf", num=num_rep, type_name=failure_domain,
                 mode=rule_mode),
            Step(op="emit"),
        ]
        self.map.add_rule(Rule(rid, name, steps, mode=rule_mode))
        return rid

    def rule_id_by_name(self, name: str) -> int | None:
        for r in self.map.rules.values():
            if r.name == name:
                return r.id
        return None

    def do_rule(self, rule_id: int, x: int, num_rep: int,
                weight_of=None) -> list[int]:
        return self.map.do_rule(rule_id, x, num_rep, weight_of)
