"""The two stages of a kernel launch (ops/bitsliced `launch_stages`,
`LaunchStage`): `prep` from the outermost instrumented entry's first
line to just before the C call, `launch` from there to the return-code
check, armed only while a torch.profiler session records.

The CPU cases run the plain versions and drive the stage helper with a
CUDA device object where a launch is needed: no card is touched.  The
cases marked `cuda` make one armed launch each of K1, K3 and K4 and
read the exported trace; they skip without a card.  This file imports
nothing of JAX or ceph_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_launch_stages.py -q
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from ceph_tpu_torch.ec import ErasureCodePluginRegistry, gf
from ceph_tpu_torch.ops import bitsliced as bs

FAKE_CARD = torch.device("cuda", 0)
SPANS = ("ec.prep", "ec.launch")


@pytest.fixture(autouse=True)
def kept_totals():
    """Each case leaves the process's stage totals as it found them."""
    saved = {k: list(v) for k, v in bs._stage_totals.items()}
    yield
    for k, v in saved.items():
        bs._stage_totals[k][:] = v
    bs._stage_tls.stage = None


def _profiler(cuda=False, record_shapes=False):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts,
                                  record_shapes=record_shapes)


def _events(prof, tmp_path, names=SPANS):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    # the host's events; kineto also projects user annotations onto the
    # card's timeline (`gpu_user_annotation`)
    return [e for e in events if e.get("ph") == "X"
            and not str(e.get("cat", "")).startswith("gpu_user")
            and (names is None or e.get("name") in names)]


def _cpu_calls():
    """One call through each kind of instrumented entry on the CPU: a
    codec entry (decode, encode, stripes) and the bare wrappers."""
    codec = ErasureCodePluginRegistry.instance().factory(
        "torch", {"k": "8", "m": "3", "device": "cpu"})
    rng = np.random.default_rng(3)
    chunks = torch.from_numpy(rng.integers(0, 256, (8, 4096),
                                           dtype=np.uint8))
    tables = bs.tables_tensor(gf.product_tables(codec.matrix[8:]),
                              torch.device("cpu"))
    codec.decode_chunks_device(chunks, tuple(range(1, 9)), (0,))
    codec.encode_chunks_device(chunks)
    codec.encode_stripes(chunks.reshape(8, 2, 2048).permute(1, 0, 2))
    bs.gf_bitmatmul(tables, chunks)
    bs.gf_bitmatmul_stream(tables, chunks)
    bs.fused_hier_acc_call(tables, chunks,
                           torch.tensor([2], dtype=torch.int64))
    bs.fused_hier_call(tables, chunks)
    bs.crc32c_rows_l(chunks.reshape(-1), torch.tensor([16],
                                                      dtype=torch.int64))


def test_off_path_reads_the_flag_and_nothing_more(tmp_path, monkeypatch):
    """With no profiler recording, no entry reaches the stage helper or
    a span: a session started and stopped around nothing leaves the
    flag down, and the calls after it leave launch_stages() as it was."""
    prof = _profiler()
    prof.start()
    prof.stop()
    assert not _events(prof, tmp_path)
    assert bs._profiler._is_profiler_enabled is False

    def refuse(*_a, **_k):
        raise AssertionError("an unarmed entry reached the stage helper")
    monkeypatch.setattr(bs, "launch_stage_enter", refuse)
    monkeypatch.setattr(bs, "_span", refuse)
    before = bs.launch_stages()
    _cpu_calls()
    assert bs.launch_stages() == before
    assert getattr(bs._stage_tls, "stage", None) is None


def test_cpu_path_records_nothing_while_armed(tmp_path):
    before = bs.launch_stages()
    prof = _profiler()
    prof.start()
    try:
        assert bs._profiler._is_profiler_enabled is True
        _cpu_calls()
    finally:
        prof.stop()
    assert bs.launch_stages() == before
    assert getattr(bs._stage_tls, "stage", None) is None
    assert not _events(prof, tmp_path)


def test_an_outer_entry_prep_takes_in_the_inner_wrapper(tmp_path):
    """A codec entry opens prep; the wrapper it calls joins that stage,
    so prep holds both parts, and the launch is counted once, under the
    wrapper.  Both spans carry the wrapper and the launch's number."""
    before = bs.launch_stages()["gf_bitmatmul"]
    prof = _profiler(record_shapes=True)
    prof.start()
    try:
        outer = bs.launch_stage_enter("gf_bitmatmul", FAKE_CARD)
        time.sleep(0.004)                    # the entry's own prep
        inner = bs.launch_stage_enter("gf_bitmatmul", FAKE_CARD)
        assert inner is outer
        time.sleep(0.002)                    # the wrapper's prep
        inner.launch()
        time.sleep(0.003)                    # the C launch
        inner.launched()
        inner.exit()
        assert bs._stage_tls.stage is outer
        outer.exit()
        assert bs._stage_tls.stage is None
    finally:
        prof.stop()
    after = bs.launch_stages()["gf_bitmatmul"]
    assert after["calls"] == before["calls"] + 1
    prep = after["prep_ns"] - before["prep_ns"]
    launch = after["launch_ns"] - before["launch_ns"]
    assert prep >= 6_000_000 and launch >= 3_000_000
    assert prep < 6_000_000 + launch
    spans = sorted(_events(prof, tmp_path), key=lambda e: e["ts"])
    assert [e["name"] for e in spans] == ["ec.prep", "ec.launch"]
    assert spans[0]["ts"] + spans[0]["dur"] <= spans[1]["ts"]
    assert spans[0]["dur"] >= prep / 1e3
    assert spans[0]["args"]["wrapper"] == spans[1]["args"]["wrapper"] == \
        "gf_bitmatmul"
    assert spans[0]["args"]["launch"] == spans[1]["args"]["launch"]


def test_a_thread_sees_only_its_own_stage():
    prof = _profiler()
    prof.start()
    try:
        outer = bs.launch_stage_enter("gf_bitmatmul", FAKE_CARD)
        seen = []

        def other():
            st = bs.launch_stage_enter("gf_bitmatmul_stream", FAKE_CARD)
            seen.append(st)
            st.launch()
            st.launched()
            st.exit()
            seen.append(getattr(bs._stage_tls, "stage", None))
        before = bs.launch_stages()
        t = threading.Thread(target=other)
        t.start()
        t.join()
        assert seen[0] is not outer and seen[1] is None
        assert bs._stage_tls.stage is outer and outer.depth == 1
        after = bs.launch_stages()
        assert after["gf_bitmatmul_stream"]["calls"] == \
            before["gf_bitmatmul_stream"]["calls"] + 1
        assert after["gf_bitmatmul"] == before["gf_bitmatmul"]
        outer.exit()
    finally:
        prof.stop()


@pytest.mark.parametrize("reach", ["before launch", "failed launch"])
def test_an_entry_left_before_its_launch_counts_nothing(tmp_path, reach):
    """An entry that returns or raises before launched() (an empty
    width, a refused operand, a failed C call) closes its open span and
    adds nothing."""
    before = bs.launch_stages()
    prof = _profiler()
    prof.start()
    try:
        st = bs.launch_stage_enter("fused_hier_acc_call", FAKE_CARD)
        if reach == "failed launch":
            st.launch()
        st.exit()
        assert bs._stage_tls.stage is None
    finally:
        prof.stop()
    assert bs.launch_stages() == before
    names = [e["name"] for e in _events(prof, tmp_path)]
    assert names == (["ec.prep"] if reach == "before launch"
                     else ["ec.prep", "ec.launch"])


def test_reset_launch_counts_zeroes_the_stages(monkeypatch):
    for f in bs.KERNEL_WRAPPERS:
        monkeypatch.setattr(f, "launches", f.launches)
    prof = _profiler()
    prof.start()
    try:
        st = bs.launch_stage_enter("crc32c_rows_l", FAKE_CARD)
        st.launch()
        st.launched()
        st.exit()
    finally:
        prof.stop()
    assert bs.launch_stages()["crc32c_rows_l"]["calls"] >= 1
    bs.reset_launch_counts()
    assert set(bs.launch_stages()) == set(bs.launch_counts())
    assert all(v == {"calls": 0, "prep_ns": 0, "launch_ns": 0}
               for v in bs.launch_stages().values())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture()
def cuda_device(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("CEPH_TPU_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    from ceph_tpu_torch import resolve_device
    return resolve_device("cuda")


def _k1_decode(dev):
    codec = ErasureCodePluginRegistry.instance().factory(
        "torch", {"k": "8", "m": "3", "device": str(dev)})
    chunks = torch.randint(0, 256, (8, 1 << 20), dtype=torch.uint8,
                           device=dev)
    return "gf_bitmatmul", "gf_bitmatmul_kernel", \
        lambda: codec.decode_chunks_device(chunks, tuple(range(1, 9)), (0,))


def _k3(dev):
    tables = bs.tables_tensor(gf.product_tables(gf.cauchy_rs_matrix(8, 3)[8:]),
                              dev)
    chunks = torch.randint(0, 256, (8, 1 << 20), dtype=torch.uint8,
                           device=dev)
    ends = torch.tensor([256, 512], dtype=torch.int64, device=dev)
    return "fused_hier_acc_call", "gf_encode_crc_kernel", \
        lambda: bs.fused_hier_acc_call(tables, chunks, ends)


def _k4(dev):
    mat = np.random.default_rng(4).integers(0, 256, (64, 176),
                                            dtype=np.uint8)
    tables = bs.tables_tensor(gf.product_tables(mat), dev)
    chunks = torch.randint(0, 256, (176, 65536), dtype=torch.uint8,
                           device=dev)
    return "gf_bitmatmul_stream", "gf_bitmatmul_stream_kernel", \
        lambda: bs.gf_bitmatmul_stream(tables, chunks)


@pytest.mark.cuda
@pytest.mark.parametrize("make", [_k1_decode, _k3, _k4],
                         ids=["k1_decode", "k3", "k4"])
def test_armed_launch_on_the_card(cuda_device, tmp_path, make):
    """One armed launch counts one call with both stages above 0; its
    `ec.prep` ends before its `ec.launch` opens, and the kernel starts
    after `ec.launch` opens.  An unarmed launch is counted by
    `.launches` and not by the stages."""
    wrapper, kernel, call = make(cuda_device)
    call()                                   # builds and loads the library
    torch.cuda.synchronize()
    stages0, launches0 = bs.launch_stages(), bs.launch_counts()
    call()
    torch.cuda.synchronize()
    assert bs.launch_stages() == stages0
    assert bs.launch_counts()[wrapper] == launches0[wrapper] + 1
    prof = _profiler(cuda=True)
    prof.start()
    try:
        call()
        torch.cuda.synchronize()
    finally:
        prof.stop()
    got, was = bs.launch_stages()[wrapper], stages0[wrapper]
    assert got["calls"] == was["calls"] + 1
    assert got["prep_ns"] > was["prep_ns"]
    assert got["launch_ns"] > was["launch_ns"]
    events = _events(prof, tmp_path, names=None)
    prep = [e for e in events if e["name"] == "ec.prep"]
    launch = [e for e in events if e["name"] == "ec.launch"]
    kernels = [e for e in events if str(e.get("cat")).lower() == "kernel"
               and kernel in e["name"]]
    assert len(prep) == len(launch) == len(kernels) == 1
    assert prep[0]["ts"] + prep[0]["dur"] <= launch[0]["ts"]
    assert kernels[0]["ts"] >= launch[0]["ts"]
