"""Plugin loading: external connectors registered at runtime.

The port of the reference ``plugin.py``.  Mirrors ``spi/Plugin.java`` +
``server/PluginManager.java`` in python terms: a plugin is a module (import
path or .py file) exposing a ``plugin()`` callable that returns a
:class:`Plugin`; its connector factories are registered into a
:class:`PluginManager`, and catalogs are then created from factory name +
config (``CatalogFactory`` role).  The per-plugin classloader isolation of
the JVM maps to python module namespaces — good enough for in-process
engines; process isolation is a deployment concern.

A plugin's connector is any port ``Connector``; where its pages live is
its own choice.  A ``MemoryConnector`` from a plugin holds what the
runner writes into it, so a table that a runner on the card fills through
CREATE TABLE / INSERT keeps its pages on the card.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
from typing import Callable, Optional

from .connectors.catalog import Catalog
from .spi.connector import Connector

__all__ = ["Plugin", "PluginManager"]


class Plugin:
    """Base plugin: name -> connector factory (callable(config) -> Connector)."""

    def get_connector_factories(self) -> dict[str, Callable[[dict], Connector]]:
        return {}

    def get_event_listener_factories(self) -> dict[str, Callable[[dict], object]]:
        return {}


class PluginManager:
    def __init__(self, catalog: Optional[Catalog] = None):
        self.catalog = catalog
        self._factories: dict[str, Callable[[dict], Connector]] = {}
        self._listener_factories: dict[str, Callable[[dict], object]] = {}
        self.loaded: list[str] = []

    def install(self, plugin: Plugin, name: str = "") -> None:
        self._factories.update(plugin.get_connector_factories())
        self._listener_factories.update(plugin.get_event_listener_factories())
        self.loaded.append(name or type(plugin).__name__)

    def load(self, module_or_path: str) -> None:
        """Load a plugin from an import path ('my_pkg.my_plugin') or a
        filesystem path ('/plugins/foo.py'); the module must expose
        ``plugin()`` returning a Plugin."""
        if os.path.sep in module_or_path or module_or_path.endswith(".py"):
            modname = "_trino_tpu_torch_plugin_" + os.path.splitext(
                os.path.basename(module_or_path))[0]
            spec = importlib.util.spec_from_file_location(
                modname, module_or_path)
            if spec is None or spec.loader is None:
                raise ImportError(f"cannot load plugin: {module_or_path}")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        else:
            mod = importlib.import_module(module_or_path)
        factory = getattr(mod, "plugin", None)
        if factory is None:
            raise ImportError(
                f"plugin module {module_or_path!r} exposes no plugin()")
        self.install(factory(), module_or_path)

    def connector_factories(self) -> dict:
        return dict(self._factories)

    def create_event_listener(self, name: str, config: Optional[dict] = None):
        """Instantiate a plugin-provided event listener (register it on a
        runner via ``runner.event_listeners.add``; reference: PluginManager
        wiring EventListenerFactory into the EventListenerManager)."""
        if name not in self._listener_factories:
            raise KeyError(f"no such event listener: {name!r} "
                           f"(loaded: {sorted(self._listener_factories)})")
        return self._listener_factories[name](config or {})

    def create_catalog(self, catalog_name: str, connector_name: str,
                       config: Optional[dict] = None) -> Connector:
        """CREATE CATALOG equivalent (reference:
        connector/CoordinatorDynamicCatalogManager + CatalogFactory)."""
        if connector_name not in self._factories:
            raise KeyError(f"no such connector: {connector_name!r} "
                           f"(loaded: {sorted(self._factories)})")
        conn = self._factories[connector_name](config or {})
        if self.catalog is not None:
            self.catalog.register(catalog_name, conn)
        return conn
