"""Rules of the port: ceph_tpu_torch and chip_smoke.py import neither
JAX nor ceph_tpu; a CUDA request without a GPU raises instead of
running on the CPU; kernel wrappers refuse operands on different
devices, of the wrong type or shape."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import ceph_tpu_torch
from ceph_tpu_torch.ec import ErasureCodePluginRegistry, gf
from ceph_tpu_torch.ops import bitsliced as bs

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "ceph_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "ceph_tpu")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_nothing_of_jax_or_ceph_tpu(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_cuda_request_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ceph_tpu_torch.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ErasureCodePluginRegistry.instance().factory(
            "torch", {"k": "4", "m": "2"})          # default device: cuda
    assert ceph_tpu_torch.resolve_device("cpu") == torch.device("cpu")


def _operands():
    mat = gf.cauchy_rs_matrix(4, 2)[4:]
    tables = bs.tables_tensor(gf.product_tables(mat), torch.device("cpu"))
    chunks = torch.zeros((4, 4096), dtype=torch.uint8)
    return tables, chunks


@pytest.mark.parametrize("entry", [
    lambda t, c: bs.gf_bitmatmul(t, c),
    lambda t, c: bs.fused_hier_call(t, c),
    lambda t, c: bs.gf_encode_with_crc_w32(t, c),
    lambda t, c: bs.fused_hier_acc_call(
        t, c, torch.tensor([2], dtype=torch.int64, device=c.device)
        if isinstance(c, torch.Tensor) else torch.tensor([2])),
    lambda t, c: bs.gf_encode_with_crc(t, c),
    lambda t, c: bs.gf_bitmatmul_stream(t, c)],
    ids=["gf_bitmatmul", "fused_hier_call", "gf_encode_with_crc_w32",
         "fused_hier_acc_call", "gf_encode_with_crc", "gf_bitmatmul_stream"])
def test_wrappers_refuse_bad_operands(entry):
    tables, chunks = _operands()
    # operands on two devices ("meta" stands in for the card here)
    with pytest.raises(ValueError, match="expected"):
        entry(tables, chunks.to("meta"))
    with pytest.raises(ValueError, match="expected"):
        entry(tables.to("meta"), chunks)
    with pytest.raises(TypeError):
        entry(tables, chunks.to(torch.int32))
    with pytest.raises(ValueError):
        entry(tables, chunks[:3])
    with pytest.raises(TypeError):
        entry(tables, chunks.numpy())
    with pytest.raises(ValueError, match="contiguous"):
        entry(tables, torch.zeros((4096, 4), dtype=torch.uint8).T)


def test_fused_entries_refuse_partial_blocks():
    tables, _ = _operands()
    with pytest.raises(ValueError, match="multiple of the block"):
        bs.gf_encode_with_crc_w32(tables, torch.zeros((4, 3000),
                                                      dtype=torch.uint8))
    with pytest.raises(ValueError, match="multiple of the block"):
        bs.fused_hier_call(tables, torch.zeros((4, 1024), dtype=torch.uint8))
    with pytest.raises(ValueError, match="multiple of the block"):
        bs.gf_encode_with_crc(tables, torch.zeros((4, 3000),
                                                  dtype=torch.uint8))


def test_cpu_wrappers_do_not_count_launches():
    tables, chunks = _operands()
    bs.reset_launch_counts()
    bs.gf_bitmatmul(tables, chunks)
    bs.fused_hier_call(tables, chunks)
    bs.gf_encode_with_crc_w32(tables, chunks)
    bs.fused_hier_acc_call(tables, chunks,
                           torch.tensor([2], dtype=torch.int64))
    bs.gf_encode_with_crc(tables, chunks)
    bs.gf_bitmatmul_stream(tables, chunks)
    bs.crc32c_rows_l(chunks.reshape(-1),
                     torch.tensor([3, 8], dtype=torch.int64))
    assert bs.launch_counts() == {"gf_bitmatmul": 0, "fused_hier_call": 0,
                                  "gf_encode_with_crc_w32": 0,
                                  "fused_hier_acc_call": 0,
                                  "gf_encode_with_crc": 0,
                                  "gf_bitmatmul_stream": 0,
                                  "crc32c_rows_l": 0}


def test_crc32c_rows_refuses_bad_operands():
    data = torch.zeros(8192, dtype=torch.uint8)
    ends = torch.tensor([1, 4], dtype=torch.int64)
    with pytest.raises(ValueError, match="expected"):
        bs.crc32c_rows_l(data, ends.to("meta"))
    with pytest.raises(TypeError):
        bs.crc32c_rows_l(data.to(torch.int32), ends)
    with pytest.raises(TypeError):
        bs.crc32c_rows_l(data.numpy(), ends)
    with pytest.raises(ValueError, match="whole"):
        bs.crc32c_rows_l(data[:3000], ends)
    with pytest.raises(ValueError, match="at least one row"):
        bs.crc32c_rows_l(data, ends[:0])
    with pytest.raises(ValueError, match="non-decreasing"):
        bs.crc32c_rows_l(data, torch.tensor([3, 1, 4], dtype=torch.int64))
    with pytest.raises(ValueError, match="end at the block count"):
        bs.crc32c_rows_l(data, torch.tensor([1, 3], dtype=torch.int64))
    with pytest.raises(ValueError, match="multiple of 128"):
        bs.k5_smem(100)


def test_k5_launch_args_refuse_bad_counts():
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="bad row block counts"):
        bs._rows_launch_args([3, -1, 2], 4, cpu)
    with pytest.raises(ValueError, match="bad row block counts"):
        bs._rows_launch_args([], 0, cpu)
    with pytest.raises(ValueError, match="end at the block count"):
        bs._rows_launch_args([1, 2], 4, cpu)
    _, ends = bs._rows_launch_args([1, 0, 3], 4, cpu)
    assert ends.dtype == torch.int64 and ends.tolist() == [1, 1, 4]


def test_extents_refuse_runs_of_another_k():
    tables, _ = _operands()
    with pytest.raises(ValueError, match="k=4"):
        bs.gf_encode_extents_with_crc_submit(
            tables, [np.zeros((3, 64), dtype=np.uint8)])
