"""The rooflines' bytes and operations against counts worked by hand
from the problems' shapes."""

from __future__ import annotations

import pytest

from benchmark.harness import roofline

H100 = "NVIDIA H100 80GB HBM3"


def test_k3_one_object():
    # 8 data + 3 parity shards of 512 KiB, 3 x 8 coefficients, 11 crcs
    nbytes, ops = roofline.encode_cost(8, 3, 1, 512 * 1024)
    assert nbytes == 5_767_168 + 24 + 44
    least = roofline.least_seconds(H100, nbytes, ops)
    assert least == pytest.approx(1.72e-6, abs=0.005e-6)
    assert least == nbytes / 3.35e12          # bound by bytes


def test_k4_clay_shape():
    # 176 helper-plane rows in, 64 planes out, over 32 x 8 KiB
    nbytes, ops = roofline.apply_cost(64, 176, 256 * 1024)
    assert nbytes == 62_914_560 + 11_264
    assert ops == 64 * 176 * 256 * 1024
    least = roofline.least_seconds(H100, nbytes, ops)
    assert least == pytest.approx(18.78e-6, abs=0.005e-6)


def test_k1_repair_shape():
    nbytes, ops = roofline.apply_cost(1, 8, 64 * 512 * 1024)
    assert nbytes == 9 * 64 * 512 * 1024 + 8


def test_unknown_card_has_no_peak():
    assert roofline.least_seconds("cpu", 1, 1) is None
