"""Erasure-code plugin registry (in-process plugins).

Re-expresses reference src/erasure-code/ErasureCodePlugin.{h,cc}: a
process-wide singleton that lazily loads plugins by name, verifies an
ABI version stamp, and hands out codec instances from profiles.  The
dlopen of `libec_<name>.so` becomes an import of
`ceph_tpu_torch.ec.plugins.ec_<name>`, and the `__erasure_code_init__`
entry point keeps its name and contract: it must call registry.add()
itself (reference ErasureCodePlugin.cc:149-175).

Error contract (reference TestErasureCodePlugin.cc:83-103):
  ENOENT - no such plugin module / entry point missing
  EXDEV  - plugin ABI version mismatch
  ENOEXEC- entry point raised during load
  EBADF  - entry point ran but did not register the plugin
  EEXIST - add() of a name already registered
"""

from __future__ import annotations

import errno
import importlib
import threading

from .. import PLUGIN_ABI_VERSION
from .interface import ErasureCodeError, ErasureCodeInterface, Profile


class ErasureCodePlugin:
    """Base for plugin objects: a factory for codec instances
    (reference ErasureCodePlugin.h:29-43)."""

    abi_version = PLUGIN_ABI_VERSION

    def factory(self, profile: Profile) -> ErasureCodeInterface:
        raise NotImplementedError


class ErasureCodePluginRegistry:
    """Singleton registry (reference ErasureCodePlugin.h:45)."""

    _instance: "ErasureCodePluginRegistry | None" = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self.lock = threading.RLock()
        self.plugins: dict[str, ErasureCodePlugin] = {}

    @classmethod
    def instance(cls) -> "ErasureCodePluginRegistry":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    # -- registration -------------------------------------------------------

    def add(self, name: str, plugin: ErasureCodePlugin) -> None:
        with self.lock:
            if name in self.plugins:
                raise ErasureCodeError(
                    errno.EEXIST, f"plugin {name} already registered")
            self.plugins[name] = plugin

    # -- loading ------------------------------------------------------------

    def load(self, name: str) -> ErasureCodePlugin:
        """Load plugin `name` (reference ErasureCodePlugin.cc:110-182)."""
        try:
            module = importlib.import_module(
                f"ceph_tpu_torch.ec.plugins.ec_{name}")
        except ModuleNotFoundError:
            raise ErasureCodeError(errno.ENOENT, f"no plugin named {name}")
        version = getattr(module, "__erasure_code_version__", None)
        if version != PLUGIN_ABI_VERSION:
            raise ErasureCodeError(
                errno.EXDEV,
                f"plugin {name} version {version!r} != expected "
                f"{PLUGIN_ABI_VERSION!r}")
        entry = getattr(module, "__erasure_code_init__", None)
        if entry is None:
            raise ErasureCodeError(
                errno.ENOENT,
                f"plugin {name} has no __erasure_code_init__ entry point")
        try:
            entry(name, None)
        except ErasureCodeError:
            raise
        except Exception as e:  # noqa: BLE001 - plugin boundary
            raise ErasureCodeError(
                errno.ENOEXEC, f"plugin {name} init raised: {e!r}")
        plugin = self.plugins.get(name)
        if plugin is None:
            raise ErasureCodeError(
                errno.EBADF,
                f"plugin {name} init ran but did not register itself")
        return plugin

    # -- factory ------------------------------------------------------------

    def factory(self, plugin_name: str,
                profile: Profile | dict) -> ErasureCodeInterface:
        """Instantiate a codec: lazy-load the plugin then delegate
        (reference ErasureCodePlugin.cc:90)."""
        if isinstance(profile, dict):
            profile = Profile(dict(profile))
        with self.lock:
            plugin = self.plugins.get(plugin_name)
            if plugin is None:
                plugin = self.load(plugin_name)
        codec = plugin.factory(profile)
        codec.init(profile)
        return codec
