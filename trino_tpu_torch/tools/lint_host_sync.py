"""Host-sync lint of the exec layer: no raw device-to-host reads.

The port's own copy of the reference's ``tools/lint_host_sync.py`` pattern
layer, with torch spellings: every deliberate host read under
``trino_tpu_torch/exec/`` goes through ``exec/syncguard.py`` (``SG.fetch``,
``SG.async_scalar``, ``SG.count_sync``), which counts it and forbids it in
the probe's hot regions; a raw ``.item()``, ``.cpu()``, ``.tolist()`` or
``int(...)`` / ``bool(...)`` / ``float(...)`` of a reduction would bypass
that accounting.  ``syncguard.py`` itself is exempt.

Run from the repository root::

    python -m trino_tpu_torch.tools.lint_host_sync

It prints one line per finding and exits 1 when there is any.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

__all__ = ["PATTERNS", "SCAN_DIR", "EXEMPT_FILES", "lint_file", "run"]

PATTERNS = [
    (re.compile(r"\.item\(\)"), ".item() blocking sync"),
    (re.compile(r"\.cpu\(\)"), ".cpu() blocking copy"),
    (re.compile(r"\.tolist\(\)"), ".tolist() blocking copy"),
    (re.compile(r"\b(int|bool|float)\([^()]*(\([^()]*\)[^()]*)*"
                r"\.(sum|max|min|any|all)\(\)\s*\)"),
     "int/bool/float of a reduction: blocking sync"),
]

SCAN_DIR = Path(__file__).resolve().parent.parent / "exec"
EXEMPT_FILES = ("syncguard.py",)


def lint_file(path: Path) -> list:
    """[(path, line number, label, source line)] of one file."""
    out = []
    for n, line in enumerate(path.read_text().splitlines(), 1):
        code = line.split("#", 1)[0]
        for pat, label in PATTERNS:
            if pat.search(code):
                out.append((path, n, label, line.strip()))
    return out


def run(scan_dir: Path = SCAN_DIR) -> list:
    """Findings over every module of ``scan_dir`` but the exempt ones."""
    out = []
    for path in sorted(scan_dir.glob("*.py")):
        if path.name not in EXEMPT_FILES:
            out += lint_file(path)
    return out


def main() -> int:
    findings = run()
    for path, n, label, src in findings:
        print(f"{path}:{n}: {label}: {src}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
