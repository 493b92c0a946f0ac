"""Import isolation: nothing in the port, nor ``chip_smoke.py``, pulls in
``jax`` or the ``repro`` package.  Runs in a fresh interpreter, because this
test process has already imported jax through ``tests/conftest.py``."""
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, importlib.util, pkgutil, sys
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)          # defines main(); runs nothing
assert callable(mod.main)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "repro."))
             or m == "repro")
print(len(names), "modules")
print("BAD", bad)
"""


def test_port_and_chip_smoke_import_no_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE,
                          str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env, timeout=300,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "BAD []", out.stdout
    assert int(lines[-2].split()[0]) >= 25, out.stdout   # every module imported
