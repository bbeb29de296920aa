"""The port's CRUSH compiler (crush/compiler.py) and crushtool against
the JAX package's: tests/test_crush_compiler.py replayed on the port,
the same text compiled by both packages decompiling to the same text
and placing the same 1024 PGs (compiled maps and maps built through
CrushWrapper), and crushtool's three modes printing the same output."""

import json
import signal

import pytest

import ceph_tpu.crush.compiler as jcomp
import ceph_tpu_torch.crush.compiler as tcomp
from ceph_tpu.crush import CrushWrapper as JWrapper
from ceph_tpu.tools import crushtool as jtool
from ceph_tpu_torch.crush import CrushWrapper as TWrapper
from ceph_tpu_torch.tools import crushtool as ttool
from test_torch_cluster_foundations import ported, run_case

COMPILER = ported("test_crush_compiler")

# a map with two rules, an EC-style indep rule among them, and an
# uneven weight, so the placement comparison covers both modes
MAP_TEXT = COMPILER.MAP_TEXT.replace("""    step emit
}
""", """    step emit
}
rule ec_rule {
    id 1
    type erasure
    step take default
    step chooseleaf indep 0 type osd
    step emit
}
""")
N_PGS = 1024


def _crushtool(tool, argv) -> int:
    """tool.main(argv) in this process: crushtool restores SIGPIPE's
    default action (a closed `| head` ends it quietly), which would let
    a later write to a closed socket kill the test process."""
    old = signal.getsignal(signal.SIGPIPE)
    try:
        return tool.main(argv)
    finally:
        signal.signal(signal.SIGPIPE, old)


@pytest.mark.parametrize("case", [
    "test_compile_basic", "test_roundtrip_identical_placements",
    "test_compile_errors_have_line_numbers",
    "test_tester_validates_good_map",
    "test_tester_flags_failure_domain_violation",
    "test_upmap_items_positional_override"])
def test_crush_compiler_replay(case):
    run_case(COMPILER, case)


def test_compiled_maps_decompile_and_place_alike():
    j, t = jcomp.compile_text(MAP_TEXT), tcomp.compile_text(MAP_TEXT)
    assert tcomp.decompile(t) == jcomp.decompile(j)
    assert (t.types, t.rule_types) == (j.types, j.rule_types)
    for rule, num_rep in ((0, 3), (1, 5)):
        for x in range(N_PGS):
            assert t.map.do_rule(rule, x, num_rep) == \
                j.map.do_rule(rule, x, num_rep), (rule, x)
        # test_rule is imported under a module name: pytest would
        # collect a bare `test_rule`
        tres = tcomp.test_rule(t.map, rule, num_rep, n_inputs=N_PGS)
        jres = jcomp.test_rule(j.map, rule, num_rep, n_inputs=N_PGS)
        assert tres == jres


def test_wrapper_maps_place_alike():
    maps = []
    for wrapper in (JWrapper, TWrapper):
        w = wrapper()
        for osd in range(12):
            w.add_osd(osd, 1.0 + (osd % 3) * 0.5, host=f"h{osd // 3}")
        w.add_simple_rule("rep", "default", "host", 3)
        w.add_simple_rule("ec", "default", "osd", 11, rule_mode="indep")
        maps.append(w)
    jw, tw = maps
    for rule, num_rep in ((0, 3), (1, 11)):
        for x in range(N_PGS):
            assert tw.do_rule(rule, x, num_rep) == \
                jw.do_rule(rule, x, num_rep), (rule, x)
        assert tcomp.test_rule(tw.map, rule, num_rep, N_PGS) == \
            jcomp.test_rule(jw.map, rule, num_rep, N_PGS)


@pytest.mark.parametrize("argv", [
    ["--compile"], ["--decompile"],
    ["--test", "--rule", "0", "--num-rep", "3", "--inputs", "1024"],
    ["--test", "--rule", "1", "--num-rep", "5"],
    ["--test", "--rule", "7"]],
    ids=["compile", "decompile", "test", "test_indep", "test_no_rule"])
def test_crushtool_prints_what_the_reference_prints(argv, tmp_path, capsys):
    path = tmp_path / "map.txt"
    path.write_text(MAP_TEXT)
    args = argv[:1] + [str(path)] + argv[1:]
    outs = []
    for tool in (jtool, ttool):
        rc = _crushtool(tool, args)
        out, err = capsys.readouterr()
        outs.append((rc, out, err))
    assert outs[1] == outs[0]
    if argv[0] == "--test" and outs[0][0] == 0:
        assert json.loads(outs[0][1])["ok"]


def test_crushtool_reports_a_compile_error(tmp_path, capsys):
    path = tmp_path / "bad.txt"
    path.write_text(MAP_TEXT.replace("alg straw2", "alg straw", 1))
    outs = []
    for tool in (jtool, ttool):
        outs.append((_crushtool(tool, ["--compile", str(path)]),
                     capsys.readouterr()))
    assert outs[1] == outs[0]
    assert outs[1][0] == 1 and "line " in outs[1][1].err
