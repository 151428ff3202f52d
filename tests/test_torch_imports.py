"""The port's first rule: quantizedattention_tpu_torch and chip_smoke.py
import nothing of JAX and nothing of the JAX package.

A fresh interpreter installs a meta-path finder that refuses `jax`,
`jaxlib` and `quantizedattention_tpu` (with their submodules), then imports
every module of quantizedattention_tpu_torch and chip_smoke.py. Every import
must succeed; a module that reached a refused name fails with its name.
"""

import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, importlib.abc, importlib.util, pkgutil, sys, traceback
sys.path.insert(0, %r)
REFUSED = ("jax", "jaxlib", "quantizedattention_tpu")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == r or name.startswith(r + ".") for r in REFUSED):
            raise ImportError(f"refused import of {name}")
        return None


sys.meta_path.insert(0, Refuse())
import quantizedattention_tpu_torch as pkg

names = [pkg.__name__] + [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
failed = []
for name in names:
    try:
        importlib.import_module(name)
    except Exception:
        failed.append((name, traceback.format_exc(limit=3)))
spec = importlib.util.spec_from_file_location("chip_smoke", %r)
try:
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
except Exception:
    failed.append(("chip_smoke", traceback.format_exc(limit=3)))
leaked = sorted(m for m in sys.modules if any(m == r or m.startswith(r + ".") for r in REFUSED))
print("IMPORTED", len(names) + 1, "FAILED", len(failed), "LEAKED", leaked)
for name, tb in failed:
    print(name, tb)
"""


def test_port_imports_nothing_of_jax():
    script = _SCRIPT % (_REPO, os.path.join(_REPO, "chip_smoke.py"))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=_REPO).stdout
    assert "FAILED 0 LEAKED []" in out, out
    n = int(out.split("IMPORTED")[1].split()[0])
    files = sum(name.endswith(".py") for _, _, names in
                os.walk(os.path.join(_REPO, "quantizedattention_tpu_torch")) for name in names)
    assert n == files + 1, out  # every module of the package, and chip_smoke.py
