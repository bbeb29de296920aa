"""Recovery and background scrub on a port cluster on the CPU:
tests/test_scrub_recovery.py's cluster cases replayed on the port (`osd
out` remaps and backfills, the background scrub finds and repairs
bitrot), on the reference's jerasure pool and on a torch one.  The
file's other cases are replayed in tests/test_torch_scrub.py and
tests/test_torch_scheduler.py."""

import pytest

from test_torch_cluster_foundations import (  # noqa: F401
    port_singletons, ported, run_case)

SCRUB = ported("test_scrub_recovery")
SCRUB_TORCH = ported("test_scrub_recovery", subs=[
    ('"plugin": "jerasure"', '"plugin": "torch"')])


@pytest.mark.parametrize("mod", [SCRUB, SCRUB_TORCH],
                         ids=["jerasure", "torch"])
@pytest.mark.parametrize("case", ["test_osd_out_triggers_backfill",
                                  "test_background_scrub_auto_repairs_bitrot"])
def test_scrub_recovery_replay(mod, case):
    run_case(mod, case)
