"""Nothing the benchmark runs may load JAX or the JAX package. Module
names are compared by their top-level name (the part before the first
dot) as a whole: the system's own name begins with the JAX package's."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from benchmark import common

SOURCES = sorted(common.HERE.rglob("*.py"))


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def test_sources_import_no_jax():
    assert SOURCES
    for path in SOURCES:
        bad = _top_level_imports(path) & set(common.FORBIDDEN)
        assert not bad, (path, bad)


def test_forbidden_names_are_whole_top_level_names():
    before = dict(sys.modules)
    try:
        sys.modules["nnacousticmodeling_tpu_torch.fake"] = object()
        sys.modules["jaxlike"] = object()
        assert common.forbidden_modules() == []
        sys.modules["jax.numpy"] = object()
        assert common.forbidden_modules() == ["jax.numpy"]
    finally:
        for name in set(sys.modules) - set(before):
            del sys.modules[name]


def test_dry_run_loads_no_jax():
    """A whole tiny run on the CPU in a fresh interpreter, then the
    loaded modules."""
    code = (
        "import json, sys\n"
        "from benchmark.tests.tiny import run_tiny\n"
        "from benchmark import common\n"
        "r = run_tiny('lstm_serve_testset')\n"
        "print(json.dumps([r['correct'], common.forbidden_modules(),\n"
        "                  'nnacousticmodeling_tpu_torch' in sys.modules]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    correct, found, system_loaded = json.loads(out.stdout.splitlines()[-1])
    assert correct and system_loaded
    assert found == []
