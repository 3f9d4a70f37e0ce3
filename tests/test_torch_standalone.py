"""dav1d_tpu_torch stands alone: it imports nothing of the JAX package
``dav1d_tpu`` and never imports jax.

* an ``ast`` walk of every module of the package and of chip_smoke.py
  finds no import of ``dav1d_tpu`` (the package, not ``dav1d_tpu_torch``)
  or of jax: no ``import``/``from`` statement at any depth, and no
  ``importlib.import_module``/``__import__`` of such a name;
* in a subprocess where both ``dav1d_tpu`` and ``jax`` are unimportable
  (``sys.modules[name] = None``), the port decodes the committed 10-bit
  stream on the CPU to its committed md5, through chip_smoke.decode."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "dav1d_tpu_torch"
SOURCES = sorted(p.relative_to(REPO).as_posix()
                 for p in [*PKG.rglob("*.py"), REPO / "chip_smoke.py"]
                 if "_build" not in p.parts)
FORBIDDEN = ("dav1d_tpu", "jax", "jaxlib")


def _forbidden(name):
    return name is not None and name.split(".")[0] in FORBIDDEN


def _imports(tree):
    """(line, module name) of every absolute import in ``tree``, and of
    every import_module / __import__ call with a constant name."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                yield node.lineno, node.module
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", None)
            if name in ("import_module", "__import__"):
                yield node.lineno, node.args[0].value


def test_sources_found():
    assert "chip_smoke.py" in SOURCES
    assert "dav1d_tpu_torch/decoder.py" in SOURCES
    assert len(SOURCES) > 40


@pytest.mark.parametrize("rel", SOURCES)
def test_module_imports_no_reference_nor_jax(rel):
    tree = ast.parse((REPO / rel).read_text(), filename=rel)
    bad = [(line, name) for line, name in _imports(tree)
           if _forbidden(name)]
    assert bad == [], f"{rel} imports {bad}"


def test_forbidden_names():
    assert _forbidden("dav1d_tpu.decoder") and _forbidden("jax.numpy")
    assert not _forbidden("dav1d_tpu_torch.decoder")
    tree = ast.parse("import dav1d_tpu_torch\nfrom dav1d_tpu import obu\n"
                     "def f():\n    import jax.numpy\n"
                     "importlib.import_module('dav1d_tpu.native')\n")
    assert [n for _, n in _imports(tree) if _forbidden(n)] == [
        "dav1d_tpu", "jax.numpy", "dav1d_tpu.native"]


_BLOCKED = r"""
import json, sys
from pathlib import Path

for name in ("dav1d_tpu", "jax", "jaxlib"):
    sys.modules[name] = None  # any import of these raises ImportError
sys.path.insert(0, sys.argv[1])
import chip_smoke

data = Path(sys.argv[2]).read_bytes()
n, md5, _ = chip_smoke.decode(data, "cpu")
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in ("dav1d_tpu", "jax", "jaxlib"))
print(json.dumps({"frames": n, "md5": md5, "loaded": loaded}))
"""


def test_decodes_with_reference_and_jax_blocked():
    data = PKG / "data"
    want = json.loads((data / "md5.json").read_text())["hbd10_128x96.ivf"]
    r = subprocess.run([sys.executable, "-c", _BLOCKED, str(REPO),
                        str(data / "hbd10_128x96.ivf")],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got == {"frames": want["frames"], "md5": want["md5"],
                   "loaded": []}
