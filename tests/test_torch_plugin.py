"""The port's plugin loading (trino_tpu_torch/plugin.py) against the
reference's.

The reference's case (tests/test_observability.py ``test_plugin_loading``)
runs through both packages: a plugin file exposing ``plugin()`` is loaded
by path, its connector factory becomes a catalog, and a runner whose
default catalog is the plugin's creates, fills and reads a table there,
with the same rows and the same refusal of an unknown factory.  Then what
the reference's case leaves implicit: an import-path plugin, a plugin
event listener, a module without ``plugin()``, and the table's pages on
the runner's device.
"""

import os
import sys
import textwrap

import pytest

from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.plugin import PluginManager as RefPluginManager
from trino_tpu.runner import Session as RefSession
from trino_tpu.runner import StandaloneQueryRunner as RefRunner
from trino_tpu_torch.caching import result_cache
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.plugin import Plugin, PluginManager
from trino_tpu_torch.runner import Session, StandaloneQueryRunner

SRC = textwrap.dedent('''
    from {pkg}.plugin import Plugin
    from {pkg}.connectors.memory import MemoryConnector

    class TinyPlugin(Plugin):
        def get_connector_factories(self):
            return {{"tiny_memory": lambda config: MemoryConnector()}}

        def get_event_listener_factories(self):
            return {{"counting": lambda config: Counting(config)}}

    class Counting:
        def __init__(self, config):
            self.config = config
            self.completed = []

        def query_created(self, event):
            pass

        def query_completed(self, event):
            self.completed.append(event.query_id)

    def plugin():
        return TinyPlugin()
''')

STATEMENTS = ["create table p (v bigint)", "insert into p values (7)",
              "insert into p values (5), (11)", "select v from p order by v",
              "select count(*), sum(v) from p"]


@pytest.fixture(autouse=True)
def _execution_not_cached():
    with result_cache.disabled():
        yield


def _write(tmp_path, pkg: str, name: str) -> str:
    path = os.path.join(tmp_path, f"{name}.py")
    with open(path, "w") as f:
        f.write(SRC.format(pkg=pkg))
    return path


def test_plugin_loading(tmp_path):
    """The reference's case, through the port."""
    path = _write(tmp_path, "trino_tpu_torch", "tiny_plugin")
    cat = default_catalog(scale_factor=0.01)
    pm = PluginManager(cat)
    pm.load(path)
    assert "tiny_memory" in pm.connector_factories()
    pm.create_catalog("extra", "tiny_memory")
    runner = StandaloneQueryRunner(cat, device="cpu", session=Session(
        default_catalog="extra"))
    runner.execute("create table p (v bigint)")
    runner.execute("insert into p values (7)")
    assert runner.execute("select v from p").rows() == [(7,)]
    with pytest.raises(KeyError):
        pm.create_catalog("x", "nope")


def test_plugin_statements_equal_reference(tmp_path):
    port_pm = PluginManager(default_catalog(scale_factor=0.01))
    port_pm.load(_write(tmp_path, "trino_tpu_torch", "port_plugin"))
    ref_pm = RefPluginManager(ref_catalog(scale_factor=0.01))
    ref_pm.load(_write(tmp_path, "trino_tpu", "ref_plugin"))
    for pm in (port_pm, ref_pm):
        pm.create_catalog("extra", "tiny_memory")
    port = StandaloneQueryRunner(port_pm.catalog, device="cpu",
                                 session=Session(default_catalog="extra"))
    ref = RefRunner(ref_pm.catalog,
                    session=RefSession(default_catalog="extra"))
    for sql in STATEMENTS:
        assert port.execute(sql).rows() == ref.execute(sql).rows(), sql
    assert port_pm.loaded == [os.path.join(tmp_path, "port_plugin.py")]
    assert sorted(port_pm.connector_factories()) == \
        sorted(ref_pm.connector_factories())


def test_plugin_table_lives_on_the_runner_device(tmp_path):
    pm = PluginManager(default_catalog(scale_factor=0.01))
    pm.load(_write(tmp_path, "trino_tpu_torch", "dev_plugin"))
    conn = pm.create_catalog("extra", "tiny_memory")
    runner = StandaloneQueryRunner(pm.catalog, device="cpu",
                                   session=Session(default_catalog="extra"))
    runner.execute("create table li as select l_orderkey, l_quantity "
                   "from tpch.lineitem where l_orderkey < 100")
    devices = {c.device.type for b in conn._data["li"] for c in b.columns}
    assert devices == {runner.device.type}
    n = runner.execute("select count(*) from li").rows()[0][0]
    assert n == runner.execute("select count(*) from tpch.lineitem "
                               "where l_orderkey < 100").rows()[0][0] > 0


def test_plugin_by_import_path_and_event_listener(tmp_path, monkeypatch):
    _write(tmp_path, "trino_tpu_torch", "tiny_import_plugin")
    monkeypatch.syspath_prepend(str(tmp_path))
    pm = PluginManager(default_catalog(scale_factor=0.01))
    pm.load("tiny_import_plugin")
    assert pm.loaded == ["tiny_import_plugin"]
    listener = pm.create_event_listener("counting", {"k": 1})
    assert listener.config == {"k": 1}
    runner = StandaloneQueryRunner(pm.catalog, device="cpu")
    runner.event_listeners.add(listener)
    runner.execute("select count(*) from nation")
    assert len(listener.completed) == 1
    with pytest.raises(KeyError):
        pm.create_event_listener("nope")
    sys.modules.pop("tiny_import_plugin", None)


def test_module_without_plugin_is_refused(tmp_path):
    path = os.path.join(tmp_path, "not_a_plugin.py")
    with open(path, "w") as f:
        f.write("X = 1\n")
    with pytest.raises(ImportError):
        PluginManager().load(path)


def test_install_without_catalog_returns_the_connector():
    class P(Plugin):
        def get_connector_factories(self):
            from trino_tpu_torch.connectors.memory import MemoryConnector

            return {"m": lambda config: MemoryConnector()}

    pm = PluginManager()
    pm.install(P())
    assert pm.loaded == ["P"]
    assert pm.create_catalog("c", "m").__class__.__name__ == \
        "MemoryConnector"
