"""The reference against values worked by hand."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import clay, crc32c, gf256


def test_crc32c_check_value():
    assert crc32c.crc32c(b"123456789") == 0xE3069283
    assert crc32c.update(0, b"") == 0


def test_crc32c_rows_and_seeds():
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 256, (3, 5000), dtype=np.uint8)
    seeds = [0xFFFFFFFF, 0, 12345]
    want = [crc32c.update(s, r.tobytes()) for s, r in zip(seeds, rows)]
    assert crc32c.rows_crc(torch.from_numpy(rows), seeds) == want
    assert crc32c.zeros(0xFFFFFFFF, 10) == crc32c.update(0xFFFFFFFF,
                                                         bytes(10))


def test_field_by_hand():
    f = gf256.field(0x11D)
    assert f.inv[2] == 0x8E and f.inv[3] == 0xF4
    assert gf256.field(0x11B).mul[0x57, 0x83] == 0xC1   # FIPS-197 4.2


def test_cauchy_parity_by_hand():
    # k=2 m=1: parity = inv(2) a ^ inv(3) b = 0x8e a ^ 0xf4 b
    g = gf256.field().cauchy(2, 1)
    assert g.tolist() == [[1, 0], [0, 1], [0x8E, 0xF4]]
    data = torch.tensor([[1, 0, 1, 2], [0, 1, 1, 0]], dtype=torch.uint8)
    par = gf256.apply(gf256.STATED_POLY, g[2:], data)
    assert par.tolist() == [[0x8E, 0xF4, 0x7A, 0x01]]


def test_vandermonde_by_hand():
    # k=2 m=1: V = [[1, 0], [1, 1], [1, 2]], V[:2]^-1 = [[1, 0], [1, 1]],
    # so the parity row is [1 ^ 2, 2] = [3, 2]
    g = gf256.field().generator("reed_sol_van", 2, 1)
    assert g.tolist() == [[1, 0], [0, 1], [3, 2]]


@pytest.mark.parametrize("technique", gf256.TECHNIQUES)
def test_generators_equal_the_port_s(technique):
    """The frozen constructions give the matrices the port's torch
    plugin installs for the same profile (its plain versions, CPU)."""
    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
    codec = ErasureCodePluginRegistry.instance().factory(
        "torch", {"k": "8", "m": "3", "technique": technique,
                  "device": "cpu"})
    assert gf256.field().generator(technique, 8, 3).tolist() == \
        codec.matrix.tolist()


def test_configuration_states_the_code():
    assert gf256.poly_of({"field_polynomial": "0x11d"}) == 0x11D
    assert gf256.poly_of({"field_polynomial": 283}) == 0x11B
    assert gf256.control_poly(0x11D) == 0x11B
    assert gf256.control_poly(0x11B) == 0x11D
    assert gf256.technique_of({"profile": {"technique": "reed_sol_van"},
                               "technique": "cauchy"}) == "reed_sol_van"
    assert gf256.technique_of({"profile": {"k": 8},
                               "technique": "cauchy"}) == "cauchy"
    for cfg in ({"profile": {"technique": "liberation"}}, {"profile": {}}):
        with pytest.raises(ValueError, match="not"):
            gf256.technique_of(cfg)


def test_recovery_rebuilds():
    f = gf256.field()
    g = f.cauchy(8, 3)
    coeff = f.recovery(g, 8, [0, 1, 2, 4, 5, 6, 7, 8], [3])
    assert f.matmul(coeff, g[[0, 1, 2, 4, 5, 6, 7, 8]]).tolist() == \
        [g[3].tolist()]


def test_clay_layout_by_hand():
    c = clay.Clay(8, 4, 11)
    assert (c.q, c.t, c.nu, c.sub_chunks) == (4, 3, 0, 64)
    # chunk 0 at (0, 0): the planes with z_0 = 0, helpers all 11 others
    assert c.repair_planes(0) == list(range(16))
    assert c.helpers(0) == list(range(1, 12))
    # chunk 5 at (1, 1): z_1 = 1
    assert c.repair_planes(5) == [z0 * 16 + 4 + z2 for z0 in range(4)
                                  for z2 in range(4)]


@pytest.mark.parametrize("technique", gf256.TECHNIQUES)
def test_clay_repair_rebuilds_lost_chunk(technique):
    for k, m, d in ((8, 4, 11), (4, 3, 5)):
        c = clay.Clay(k, m, d, technique=technique)
        g = torch.Generator().manual_seed(1)
        data = torch.randint(0, 256, (k, c.sub_chunks, 8), generator=g,
                             dtype=torch.uint8)
        chunks = c.encode(data)
        assert torch.equal(chunks[:k], data)
        for lost in range(k + m):
            rows = c.helper_rows(chunks, lost)
            assert rows.shape[0] == d * len(c.repair_planes(lost))
            assert torch.equal(c.repair(lost, rows), chunks[lost])
            mat = c.repair_matrix(lost)
            again = gf256.apply(gf256.STATED_POLY, mat, rows)
            assert torch.equal(again, chunks[lost])
