"""The port imports neither JAX nor the reference package.

In a fresh interpreter, every module under ``trino_tpu_torch/`` and
``chip_smoke`` is imported with an import hook that refuses ``jax`` and
``trino_tpu`` (any module already loaded under those names is dropped
first, so a preloaded copy cannot hide an import); afterwards neither name
may be in ``sys.modules``.
"""

import json
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, importlib.abc, json, pkgutil, sys

    BANNED = ("jax", "jaxlib", "trino_tpu")

    def banned(name):
        return any(name == b or name.startswith(b + ".") for b in BANNED)

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if banned(name):
                raise ImportError(f"the port imported {name}")
            return None

    for name in [m for m in sys.modules if banned(m)]:
        del sys.modules[name]
    sys.meta_path.insert(0, Refuse())
    import trino_tpu_torch
    names = ["trino_tpu_torch", "chip_smoke"] + [
        m.name for m in pkgutil.walk_packages(trino_tpu_torch.__path__,
                                              "trino_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    print(json.dumps({"imported": names,
                      "banned": sorted(m for m in sys.modules if banned(m))}))
""")


def test_port_imports_neither_jax_nor_the_reference():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["banned"] == []
    imported = set(result["imported"])
    for module in ("chip_smoke", "trino_tpu_torch.runner",
                   "trino_tpu_torch.spi.security",
                   "trino_tpu_torch.spi.session",
                   "trino_tpu_torch.execution.transaction",
                   "trino_tpu_torch.execution.control",
                   "trino_tpu_torch.execution.resource_manager",
                   "trino_tpu_torch.execution.worker",
                   "trino_tpu_torch.execution.remote",
                   "trino_tpu_torch.execution.ha",
                   "trino_tpu_torch.server",
                   "trino_tpu_torch.server.protocol",
                   "trino_tpu_torch.server.client",
                   "trino_tpu_torch.server.front_tier",
                   "trino_tpu_torch.caching.plan_cache",
                   "trino_tpu_torch.caching.result_cache",
                   "trino_tpu_torch.plugin",
                   "trino_tpu_torch.testing.oracle",
                   "trino_tpu_torch.testing.chaos",
                   "trino_tpu_torch.tools.dist_probe"):
        assert module in imported
    assert len(imported) > 40
