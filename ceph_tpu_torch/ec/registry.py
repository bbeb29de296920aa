"""Erasure-code plugin registry.

Re-expresses reference src/erasure-code/ErasureCodePlugin.{h,cc}: a
process-wide singleton that lazily loads plugins by name, verifies an ABI
version stamp, and hands out codec instances from profiles.  The dlopen of
`libec_<name>.so` becomes an import of
`ceph_tpu_torch.ec.plugins.ec_<name>` (or of `ec_<name>` from a
configured plugin directory; such a plugin imports `ceph_tpu_torch`), and
the `__erasure_code_init__` entry point keeps its name and its contract:
it must call registry.add() itself (reference ErasureCodePlugin.cc:149-175).

The error contract is preserved via ErasureCodeError errnos, matching the
reference's tested behaviors (src/test/erasure-code/TestErasureCodePlugin.cc:83-103):
  ENOENT - no such plugin module
  EXDEV  - plugin ABI version mismatch
  ENOEXEC- entry point raised during load ("expected initialization failed")
  ENOENT - entry point missing
  EBADF  - entry point ran but did not register the plugin
  EEXIST - add() of a name already registered
"""

from __future__ import annotations

import errno
import importlib
import importlib.util
import sys
import threading
from pathlib import Path

from .. import PLUGIN_ABI_VERSION
from .interface import ErasureCodeError, ErasureCodeInterface, Profile


class ErasureCodePlugin:
    """Base for plugin objects: a factory for codec instances.

    Reference ErasureCodePlugin.h:29-43.  Subclasses implement factory();
    the module's __erasure_code_init__ registers an instance.
    """

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

    def get(self, name: str) -> ErasureCodePlugin | None:
        with self.lock:
            return self.plugins.get(name)

    def remove(self, name: str) -> None:
        with self.lock:
            self.plugins.pop(name, None)

    # -- loading ------------------------------------------------------------

    def load(self, name: str, directory: str | None = None) -> ErasureCodePlugin:
        """Load plugin `name` (reference ErasureCodePlugin.cc:110-182)."""
        module = self._import_module(name, directory)
        version = getattr(module, "__erasure_code_version__", None)
        if version is None:
            raise ErasureCodeError(
                errno.EXDEV,
                f"plugin {name} has no __erasure_code_version__ stamp")
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
            entry(name, directory)
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

    def _import_module(self, name: str, directory: str | None):
        modname = f"ec_{name}"
        if directory:
            path = Path(directory) / f"{modname}.py"
            if not path.exists():
                raise ErasureCodeError(
                    errno.ENOENT, f"no plugin file {path}")
            spec = importlib.util.spec_from_file_location(
                f"ceph_tpu_torch_extplugin.{modname}", path)
            module = importlib.util.module_from_spec(spec)
            sys.modules[spec.name] = module
            try:
                spec.loader.exec_module(module)
            except Exception as e:  # noqa: BLE001
                sys.modules.pop(spec.name, None)
                raise ErasureCodeError(
                    errno.ENOEXEC, f"plugin {name} failed to import: {e!r}")
            return module
        try:
            return importlib.import_module(
                f"ceph_tpu_torch.ec.plugins.{modname}")
        except ModuleNotFoundError:
            raise ErasureCodeError(errno.ENOENT, f"no plugin named {name}")
        except ErasureCodeError:
            raise
        except Exception as e:  # noqa: BLE001
            raise ErasureCodeError(
                errno.ENOEXEC, f"plugin {name} failed to import: {e!r}")

    # -- factory ------------------------------------------------------------

    def factory(self, plugin_name: str, profile: Profile | dict,
                directory: str | None = None) -> ErasureCodeInterface:
        """Instantiate a codec: lazy-load the plugin then delegate
        (reference ErasureCodePlugin.cc:90)."""
        if isinstance(profile, dict):
            profile = Profile(dict(profile))
        with self.lock:
            plugin = self.plugins.get(plugin_name)
            if plugin is None:
                plugin = self.load(plugin_name, directory)
        codec = plugin.factory(profile)
        codec.init(profile)
        return codec

    def preload(self, plugins: list[str], directory: str | None = None) -> None:
        """Eagerly load a list of plugins (reference
        ErasureCodePlugin.cc:184, called from global_init_preload at
        daemon startup, src/global/global_init.cc:571)."""
        with self.lock:
            for name in plugins:
                if name not in self.plugins:
                    self.load(name, directory)


DEFAULT_PLUGINS = ["jerasure", "isa", "torch"]  # analog of osd_erasure_code_plugins
