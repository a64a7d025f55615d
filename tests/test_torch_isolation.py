"""The port stands alone: importing every module of ``repro_torch`` loads no
JAX and nothing of ``repro``, and no source file imports either."""
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    if not m.name.endswith("__main__"):
        importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith(("jax.", "jaxlib")) or n == "repro" or n.startswith("repro."))
print(len([n for n in sys.modules if n.startswith("repro_torch")]), bad)
"""


def test_import_loads_no_jax_and_no_reference():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.split(" ", 1)
    assert int(count) >= 20
    assert bad.strip() == "[]"


def test_no_source_imports_jax_or_reference():
    pattern = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)(\.|\s)(?!_))",
                         re.MULTILINE)
    files = list(PKG.rglob("*.py"))
    assert len(files) >= 20
    for f in files:
        assert not pattern.search(f.read_text()), f
