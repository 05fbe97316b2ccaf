"""No process of the benchmark imports JAX or the JAX package (top-level
module names compared whole: `raytracer_tpu_torch` is the program), and
the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

from portbench import harness

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def _sources(*parts):
    for d, _, files in os.walk(os.path.join(PKG, *parts)):
        if "_cache" not in d:
            yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_source_imports_jax():
    for path in _sources():
        found = set(_imports(path)) & set(harness.FORBIDDEN)
        assert not found, f"{path} imports {found}"


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        found = {m for m in _imports(path) if m.startswith("raytracer_tpu")}
        assert not found, f"{path} imports {found}"


def test_a_run_loads_no_jax_module():
    script = (
        "import time, torch\n"
        "from portbench import harness, scenes\n"
        "cfg = scenes.resized(scenes.load_config('config4_mesh'), 32, 18, 2)\n"
        "run = harness.Run('config4-render-1080p-d4', 1, 0.2, True,\n"
        "                  torch.device('cpu'), time.perf_counter(), cfg=cfg)\n"
        "harness.execute(run)\n"
        "import raytracer_tpu_torch.cli, raytracer_tpu_torch.parallel.shard\n"
        "print(harness.loaded_forbidden())\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert "raytracer_tpu_torch" not in harness.FORBIDDEN


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "raytracer_tpu_torch_fake", sys)
    assert "raytracer_tpu" not in harness.loaded_forbidden() or \
        any(m.split(".")[0] == "raytracer_tpu" for m in sys.modules)
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in harness.loaded_forbidden()
