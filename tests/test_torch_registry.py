"""The port's plugin registry (ceph_tpu_torch/ec/registry.py): the
loading and fault-model tests of tests/test_plugin_registry.py run on
the port's registry, with out-of-tree plugins that import
ceph_tpu_torch (the error contract ENOENT / EXDEV / ENOEXEC / EBADF /
EEXIST, the plugin directory, concurrent loads and preload), then
`get` / `remove` and the ErasureCodeInterface default methods
(minimum_to_decode(_with_cost), get_chunk_mapping, decode_concat,
create_rule, Profile.to_bool) against the JAX package's."""

import errno
import textwrap
import threading

import pytest

from ceph_tpu_torch.ec import ErasureCodeError, ErasureCodePluginRegistry

REG = ErasureCodePluginRegistry.instance()


def write_plugin(tmp_path, name, body):
    (tmp_path / f"ec_{name}.py").write_text(textwrap.dedent(body))
    return str(tmp_path)


def test_load_missing_plugin():
    with pytest.raises(ErasureCodeError) as ei:
        REG.factory("no_such_plugin_xyz", {})
    assert ei.value.errno == errno.ENOENT


def test_missing_version(tmp_path):
    d = write_plugin(tmp_path, "noversion", """
        def __erasure_code_init__(name, directory):
            pass
    """)
    with pytest.raises(ErasureCodeError) as ei:
        REG.factory("noversion", {}, directory=d)
    assert ei.value.errno == errno.EXDEV


def test_version_mismatch(tmp_path):
    d = write_plugin(tmp_path, "badversion", """
        __erasure_code_version__ = "something-old"
        def __erasure_code_init__(name, directory):
            pass
    """)
    with pytest.raises(ErasureCodeError) as ei:
        REG.factory("badversion", {}, directory=d)
    assert ei.value.errno == errno.EXDEV


def test_missing_entry_point(tmp_path):
    d = write_plugin(tmp_path, "noentry", """
        from ceph_tpu_torch import PLUGIN_ABI_VERSION
        __erasure_code_version__ = PLUGIN_ABI_VERSION
    """)
    with pytest.raises(ErasureCodeError) as ei:
        REG.factory("noentry", {}, directory=d)
    assert ei.value.errno == errno.ENOENT


def test_fail_to_initialize(tmp_path):
    d = write_plugin(tmp_path, "failinit", """
        from ceph_tpu_torch import PLUGIN_ABI_VERSION
        __erasure_code_version__ = PLUGIN_ABI_VERSION
        def __erasure_code_init__(name, directory):
            raise RuntimeError("boom")
    """)
    with pytest.raises(ErasureCodeError) as ei:
        REG.factory("failinit", {}, directory=d)
    assert ei.value.errno == errno.ENOEXEC


def test_fail_to_register(tmp_path):
    d = write_plugin(tmp_path, "noregister", """
        from ceph_tpu_torch import PLUGIN_ABI_VERSION
        __erasure_code_version__ = PLUGIN_ABI_VERSION
        def __erasure_code_init__(name, directory):
            pass  # "forgets" to call registry.add
    """)
    with pytest.raises(ErasureCodeError) as ei:
        REG.factory("noregister", {}, directory=d)
    assert ei.value.errno == errno.EBADF


def test_double_add_is_eexist(tmp_path):
    from ceph_tpu_torch.ec.registry import ErasureCodePlugin
    if REG.get("example") is None:
        REG.load("example")
    with pytest.raises(ErasureCodeError) as ei:
        REG.add("example", ErasureCodePlugin())
    assert ei.value.errno == errno.EEXIST


def test_external_plugin_dir_loads(tmp_path):
    """A valid out-of-tree plugin loads from erasure_code_dir, like
    libec_*.so from the plugin directory (options.cc:564)."""
    d = write_plugin(tmp_path, "extxor", """
        import numpy as np
        from ceph_tpu_torch import PLUGIN_ABI_VERSION
        from ceph_tpu_torch.ec.plugins.ec_example import ErasureCodeExample
        from ceph_tpu_torch.ec.registry import (
            ErasureCodePlugin, ErasureCodePluginRegistry)
        __erasure_code_version__ = PLUGIN_ABI_VERSION
        class P(ErasureCodePlugin):
            def factory(self, profile):
                return ErasureCodeExample()
        def __erasure_code_init__(name, directory):
            ErasureCodePluginRegistry.instance().add(name, P())
    """)
    codec = REG.factory("extxor", {}, directory=d)
    enc = codec.encode({0, 1, 2}, b"x" * 100)
    assert len(enc) == 3


def test_concurrent_factory_threadsafe():
    """Registry must survive concurrent lazy loads (reference deadlock
    test TestErasureCodePlugin.cc:30-72 with the Hangs fixture)."""
    errs = []

    def run():
        try:
            REG.factory("jerasure", {"k": "2", "m": "1"})
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=run) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errs


def test_preload():
    REG.preload(["jerasure", "isa", "example"])
    assert REG.get("jerasure") is not None
    assert REG.get("isa") is not None



def test_get_and_remove(tmp_path):
    d = write_plugin(tmp_path, "removable", """
        from ceph_tpu_torch import PLUGIN_ABI_VERSION
        from ceph_tpu_torch.ec.plugins.ec_example import ErasureCodeExample
        from ceph_tpu_torch.ec.registry import (
            ErasureCodePlugin, ErasureCodePluginRegistry)
        __erasure_code_version__ = PLUGIN_ABI_VERSION
        class P(ErasureCodePlugin):
            def factory(self, profile):
                return ErasureCodeExample()
        def __erasure_code_init__(name, directory):
            ErasureCodePluginRegistry.instance().add(name, P())
    """)
    assert REG.get("removable") is None
    REG.factory("removable", {}, directory=d)
    plugin = REG.get("removable")
    assert plugin is not None
    REG.remove("removable")
    assert REG.get("removable") is None
    REG.remove("removable")                   # absent: a no-op
    REG.factory("removable", {}, directory=d)  # loads again
    assert REG.get("removable") is not plugin


def test_default_plugins_name_the_port():
    from ceph_tpu_torch.ec.registry import DEFAULT_PLUGINS
    REG.preload([p for p in DEFAULT_PLUGINS if p != "torch"])
    assert "torch" in DEFAULT_PLUGINS and "jax" not in DEFAULT_PLUGINS


PROFILES = [("jerasure", {"k": "4", "m": "2"}), ("isa", {"k": "5", "m": "3"}),
            ("lrc", {"k": "4", "m": "2", "l": "3"}),
            ("shec", {"k": "4", "m": "3", "c": "2"}),
            ("clay", {"k": "4", "m": "2", "d": "5"})]


def _attempt(fn):
    """fn's value, or the errno of the ErasureCodeError it raises."""
    from ceph_tpu.ec import ErasureCodeError as JError
    try:
        return fn()
    except (ErasureCodeError, JError) as e:
        return ("error", e.errno)


@pytest.mark.parametrize("plugin,profile", PROFILES,
                         ids=[p for p, _ in PROFILES])
def test_interface_defaults_match_reference(plugin, profile):
    import numpy as np

    from ceph_tpu.ec import ErasureCodePluginRegistry as JReg
    out = []
    for reg in (REG, JReg.instance()):
        codec = reg.factory(plugin, dict(profile))
        n = codec.get_chunk_count()
        k = codec.get_data_chunk_count()
        got = [codec.get_chunk_mapping()]
        for want, avail in (({0}, set(range(n))), ({0, 1}, set(range(1, n))),
                            (set(range(k)), set(range(n - k, n)))):
            got.append(_attempt(lambda: sorted(
                codec.minimum_to_decode_with_cost(
                    want, {s: 1 for s in avail}))))
            got.append(_attempt(lambda: sorted(
                (s, list(map(tuple, r))) for s, r in
                codec.minimum_to_decode(want, avail).items())))
        payload = np.random.default_rng(n).integers(0, 256, 4000,
                                                    dtype=np.uint8)
        enc = codec.encode(set(range(n)), payload.tobytes())
        # every chunk but the first: one erasure any of these codes
        # decodes
        got.append(codec.decode_concat({s: enc[s] for s in range(1, n)}))
        out.append(got)
    assert out[0] == out[1]
    assert out[0][-1][:4000] == payload.tobytes()


def test_profile_to_bool_matches_reference():
    from ceph_tpu.ec.interface import Profile as JProfile
    from ceph_tpu_torch.ec.interface import Profile as TProfile
    for raw in ("true", "Yes", "1", "on", "false", "0", "", None, "off"):
        got = []
        for cls in (TProfile, JProfile):
            p = cls({} if raw is None else {"flag": raw})
            got.append((p.to_bool("flag", True), p.to_bool("flag", False),
                        dict(p.data)))
        assert got[0] == got[1]
