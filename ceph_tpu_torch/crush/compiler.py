"""CRUSH map text compiler/decompiler + placement tester.

Re-expresses reference src/crush/CrushCompiler.{h,cc} (the crushtool
text format: device / type / bucket / rule stanzas) and the
CrushTester role (src/crush/CrushTester.cc: run a rule over many
inputs and check the outputs hold the placement invariants) over this
build's CrushMap.

Supported grammar (the subset CrushMap models):

    # devices
    device 0 osd.0
    device 1 osd.1 class ssd

    # types
    type 0 osd
    type 1 host
    type 10 root

    # buckets
    host node1 {
        id -2
        alg straw2
        hash 0
        item osd.0 weight 1.000
    }
    root default {
        id -1
        alg straw2
        item node1 weight 2.000
    }

    # rules
    rule replicated_rule {
        id 0
        type replicated
        step take default
        step chooseleaf firstn 0 type host
        step emit
    }

`alg`/`hash` lines parse and must be straw2/0 when present (the only
bucket algorithm this build implements — a deliberate deviation noted
in crush/map.py); other algs raise a compile error rather than
silently changing placement.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .map import Bucket, CrushMap, Device, Rule, Step

DEFAULT_TYPES = {0: "osd", 1: "host", 2: "chassis", 3: "rack",
                 4: "row", 5: "pdu", 6: "pod", 7: "room",
                 8: "datacenter", 9: "zone", 10: "region", 11: "root"}


class CrushCompileError(ValueError):
    pass


@dataclass
class CompiledMap:
    """A CrushMap plus the text-format side tables (type ids, rule
    metadata) needed to round-trip."""
    map: CrushMap
    types: dict[int, str] = field(default_factory=dict)
    rule_types: dict[int, str] = field(default_factory=dict)


def _tokens(text: str):
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if line:
            yield lineno, line.split()


def compile_text(text: str) -> CompiledMap:
    """crushmap text -> CompiledMap.  Raises CrushCompileError with
    line numbers on malformed input (reference CrushCompiler::compile)."""
    cm = CrushMap()
    types: dict[int, str] = {}
    rule_types: dict[int, str] = {}
    dev_by_name: dict[str, int] = {}
    lines = list(_tokens(text))
    i = 0

    def err(lineno, msg):
        raise CrushCompileError(f"line {lineno}: {msg}")

    def resolve_item(lineno, name):
        if name in dev_by_name:
            return dev_by_name[name]
        b = cm.buckets_by_name.get(name)
        if b is not None:
            return b.id
        err(lineno, f"unknown item {name!r}")

    # pass 1: flat stanzas + collect bucket blocks (buckets may
    # reference buckets defined earlier; the reference requires
    # definition-before-use the same way)
    while i < len(lines):
        lineno, t = lines[i]
        if t[0] == "device":
            if not (len(t) == 3 or
                    (len(t) == 5 and t[3] == "class")):
                err(lineno, "device <id> <name> [class <c>]")
            did = int(t[1])
            dev_class = t[4] if len(t) == 5 else None
            cm.add_device(did, 1.0, dev_class)
            dev_by_name[t[2]] = did
            i += 1
        elif t[0] == "type":
            if len(t) != 3:
                err(lineno, "type <id> <name>")
            types[int(t[1])] = t[2]
            i += 1
        elif t[0] == "tunable":
            i += 1                       # accepted and ignored
        elif t[0] == "rule":
            i = _parse_rule(cm, rule_types, lines, i, err,
                            resolve_item)
        elif len(t) >= 2 and t[-1] == "{":
            i = _parse_bucket(cm, types, lines, i, err,
                              resolve_item, dev_by_name)
        else:
            err(lineno, f"unexpected {' '.join(t)!r}")
    # device weights live on the bucket ITEM lines in the text format;
    # mirror them onto the Device records so weight-based checks (and
    # item_weight) see what placement actually uses
    for b in cm.buckets.values():
        for item, w in zip(b.items, b.weights):
            if item >= 0 and item in cm.devices:
                cm.devices[item].weight = w
    return CompiledMap(cm, types or dict(DEFAULT_TYPES), rule_types)


def _parse_bucket(cm, types, lines, i, err, resolve_item,
                  dev_by_name):
    lineno, t = lines[i]
    type_name, name = t[0], t[1]
    if types and type_name not in types.values():
        err(lineno, f"unknown bucket type {type_name!r}")
    bid = None
    items: list[tuple[int, float]] = []
    i += 1
    while i < len(lines):
        lineno, t = lines[i]
        if t[0] == "}":
            i += 1
            break
        if t[0] == "id":
            bid = int(t[1])
        elif t[0] == "alg":
            if t[1] != "straw2":
                err(lineno, f"unsupported bucket alg {t[1]!r} "
                            "(this build implements straw2 only)")
        elif t[0] == "hash":
            pass                          # rjenkins selector: N/A here
        elif t[0] == "item":
            weight = 1.0
            if "weight" in t:
                weight = float(t[t.index("weight") + 1])
            items.append((resolve_item(lineno, t[1]), weight))
        else:
            err(lineno, f"unknown bucket field {t[0]!r}")
        i += 1
    else:
        err(lineno, f"bucket {name!r}: missing closing brace")
    if bid is None:
        err(lineno, f"bucket {name!r}: missing id")
    if bid >= 0:
        err(lineno, f"bucket {name!r}: id must be negative")
    b = cm.add_bucket(bid, name, type_name)
    for item_id, w in items:
        cm.bucket_add_item(b, item_id, w)
    return i


def _parse_rule(cm, rule_types, lines, i, err, resolve_item):
    lineno, t = lines[i]
    if len(t) != 3 or t[2] != "{":
        err(lineno, "rule <name> {")
    name = t[1]
    rid = None
    rtype = "replicated"
    steps: list[Step] = []
    mode = "firstn"
    i += 1
    while i < len(lines):
        lineno, t = lines[i]
        if t[0] == "}":
            i += 1
            break
        if t[0] == "id" or t[0] == "ruleset":
            rid = int(t[1])
        elif t[0] == "type":
            rtype = t[1]
        elif t[0] in ("min_size", "max_size"):
            pass                          # legacy fields: accepted
        elif t[0] == "step":
            if t[1] == "take":
                # resolve to the numeric id NOW: unknown targets error
                # with a line number, and device-name takes work at
                # map time (do_rule only name-resolves buckets)
                steps.append(Step(op="take",
                                  item=resolve_item(lineno, t[2])))
            elif t[1] == "emit":
                steps.append(Step(op="emit"))
            elif t[1] in ("choose", "chooseleaf"):
                # step chooseleaf firstn 0 type host
                if len(t) != 6 or t[4] != "type":
                    err(lineno, "step choose[leaf] "
                                "{firstn|indep} <n> type <t>")
                mode = t[2]
                if mode not in ("firstn", "indep"):
                    err(lineno, f"unknown mode {mode!r}")
                steps.append(Step(op=t[1], num=int(t[3]),
                                  type_name=t[5], mode=mode))
            else:
                err(lineno, f"unknown step {t[1]!r}")
        else:
            err(lineno, f"unknown rule field {t[0]!r}")
        i += 1
    else:
        err(lineno, f"rule {name!r}: missing closing brace")
    if rid is None:
        err(lineno, f"rule {name!r}: missing id")
    if not steps or steps[0].op != "take" or steps[-1].op != "emit":
        err(lineno, f"rule {name!r}: must be take ... emit")
    cm.add_rule(Rule(rid, name, steps, mode=mode))
    rule_types[rid] = rtype
    return i


def decompile(compiled: CompiledMap) -> str:
    """CompiledMap -> crushmap text (reference CrushCompiler::decompile).
    compile_text(decompile(m)) reproduces the same placements."""
    cm = compiled.map
    out = ["# begin crush map", "", "# devices"]
    for did in sorted(cm.devices):
        dev = cm.devices[did]
        line = f"device {did} osd.{did}"
        if dev.device_class:
            line += f" class {dev.device_class}"
        out.append(line)
    out += ["", "# types"]
    for tid in sorted(compiled.types):
        out.append(f"type {tid} {compiled.types[tid]}")
    out += ["", "# buckets"]
    # children before parents (definition-before-use)
    emitted: set[int] = set()

    def emit_bucket(bid: int):
        if bid in emitted:
            return
        b = cm.buckets[bid]
        for item in b.items:
            if item < 0:
                emit_bucket(item)
        emitted.add(bid)
        out.append(f"{b.type_name} {b.name} {{")
        out.append(f"    id {b.id}")
        out.append("    alg straw2")
        out.append("    hash 0")
        for item, w in zip(b.items, b.weights):
            iname = f"osd.{item}" if item >= 0 \
                else cm.buckets[item].name
            out.append(f"    item {iname} weight {w:.3f}")
        out.append("}")

    for bid in sorted(cm.buckets, reverse=True):
        emit_bucket(bid)
    out += ["", "# rules"]
    for rid in sorted(cm.rules):
        r = cm.rules[rid]
        out.append(f"rule {r.name} {{")
        out.append(f"    id {rid}")
        out.append(f"    type {compiled.rule_types.get(rid, 'replicated')}")
        for st in r.steps:
            if st.op == "take":
                iname = st.item if isinstance(st.item, str) \
                    else (f"osd.{st.item}" if st.item >= 0
                          else cm.buckets[st.item].name)
                out.append(f"    step take {iname}")
            elif st.op == "emit":
                out.append("    step emit")
            else:
                out.append(f"    step {st.op} {st.mode} {st.num} "
                           f"type {st.type_name}")
        out.append("}")
    out.append("# end crush map")
    return "\n".join(out) + "\n"


# ----------------------------------------------------------------------------
# CrushTester role
# ----------------------------------------------------------------------------

def test_rule(cm: CrushMap, rule_id: int, num_rep: int,
              n_inputs: int = 1024, weight_of=None) -> dict:
    """Run a rule over n_inputs and validate placement invariants
    (reference CrushTester::test_with_fork, reduced to the checks that
    matter): full result vectors, no duplicate devices, failure-domain
    uniqueness for chooseleaf rules, and weight-proportional usage.
    Returns {ok, problems[], utilization{osd: count}, expected{...}}."""
    from .map import CRUSH_ITEM_NONE
    rule = cm.rules[rule_id]
    leaf_types = [st.type_name for st in rule.steps
                  if st.op == "chooseleaf"]
    problems: list[str] = []
    util: dict[int, int] = {d: 0 for d in cm.devices}

    parent: dict[int, int] = {}
    for b in cm.buckets.values():
        for item in b.items:
            parent[item] = b.id

    def domain_of(dev: int, type_name: str) -> int | None:
        """Nearest ancestor bucket of type_name (a chooseleaf type may
        sit levels above the device's direct parent)."""
        cur = parent.get(dev)
        while cur is not None:
            if cm.buckets[cur].type_name == type_name:
                return cur
            cur = parent.get(cur)
        return None

    for x in range(n_inputs):
        out = cm.do_rule(rule_id, x, num_rep, weight_of)
        live = [d for d in out if d != CRUSH_ITEM_NONE]
        if len(out) != num_rep:
            problems.append(f"x={x}: got {len(out)} results, "
                            f"want {num_rep}")
        if len(set(live)) != len(live):
            problems.append(f"x={x}: duplicate devices {out}")
        for lt in leaf_types:
            doms = [domain_of(d, lt) for d in live]
            if len(set(doms)) != len(doms):
                problems.append(
                    f"x={x}: two replicas share a {lt}: {out}")
        for d in live:
            util[d] += 1
        if len(problems) > 16:
            break
    # weight proportionality (loose bound: straw2 converges ~1/sqrt(n))
    # — over the devices REACHABLE from the rule's take roots only:
    # declared-but-unbucketed spares must not skew the baseline
    reachable: set[int] = set()

    def walk(item: int):
        if item >= 0:
            reachable.add(item)
            return
        for child in cm.buckets[item].items:
            walk(child)

    for st in rule.steps:
        if st.op == "take":
            item = st.item
            if isinstance(item, str):
                item = cm.buckets_by_name[item].id
            walk(item)
    total_w = sum((cm.item_weight(d) if weight_of is None
                   else weight_of(d)) or 0.0 for d in reachable)
    expected = {}
    placed = sum(util.values())
    if total_w > 0 and placed:
        for d in sorted(reachable):
            w = (cm.item_weight(d) if weight_of is None
                 else weight_of(d)) or 0.0
            expected[d] = placed * w / total_w
            if expected[d] >= 16 and \
                    abs(util[d] - expected[d]) > 0.5 * expected[d]:
                problems.append(
                    f"osd.{d}: utilization {util[d]} vs expected "
                    f"~{expected[d]:.0f} (weight skew)")
    return {"ok": not problems, "problems": problems,
            "utilization": util, "expected": expected}
