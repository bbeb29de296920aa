"""`correct` against the control and the faults it has to catch.

The control (the reference computed in GF(2^8) mod 0x11b, where the
configurations state 0x11d) in the program's place must come out not
correct; so must a run whose timed path is broken underneath the
harness: a step that leaves its output unwritten, half of the batch
left out, one byte altered where it is produced.  The cells run on one
card, so no exchange between cards can be left out.  At small sizes on
the CPU, through the same harness as a run on the card.
"""

from __future__ import annotations

import pytest
import torch

from benchmark.tests import support

CELLS = support.ON_CARD


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return support.make_root(tmp_path_factory.mktemp("cells"))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(root, cell):
    for seed in (3, 2**31 + 11):
        res = support.run_small(root, cell, seed=seed)
        assert res["correct"] is True, res["checks"]
        assert res["failed"] == 0
        assert all(v["value"] == 0 for k, v in res["checks"].items()
                   if "limit" in v)


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cell):
    res = support.run_small(root, cell, control=True)
    assert res["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["checks"].values()
               if "limit" in v)


def _unwritten(real):
    def call(*args, **kw):
        out = real(*args, **kw)
        if isinstance(out, tuple):
            return tuple(torch.zeros_like(t) for t in out)
        return torch.zeros_like(out)
    return call


def _half(real):
    def call(*args, **kw):
        out = real(*args, **kw)
        outs = out if isinstance(out, tuple) else (out,)
        parity = outs[0]
        parity[:, parity.shape[1] // 2:] = 0
        if len(outs) > 1:                      # the later objects' crcs
            outs[1][outs[1].shape[0] // 2:] = 0
        return out
    return call


def _altered(real):
    def call(*args, **kw):
        out = real(*args, **kw)
        t = out[0] if isinstance(out, tuple) else out
        t[0, -1] ^= 1
        return out
    return call


WRAPPED = {"tiny-encode": "fused_hier_acc_call",
           "tiny-repair": "gf_bitmatmul",
           "tiny-clay": "gf_bitmatmul_stream"}


@pytest.mark.parametrize("fault", [_unwritten, _half, _altered],
                         ids=["unwritten", "half_batch", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(root, cell, fault, monkeypatch):
    from ceph_tpu_torch.ops import bitsliced as bs
    name = WRAPPED[cell]
    monkeypatch.setattr(bs, name, fault(getattr(bs, name)))
    res = support.run_small(root, cell)
    assert res["correct"] is False
    assert res["failed"] > 0
