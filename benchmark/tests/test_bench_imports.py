"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names, and the reference imports nothing of the
port."""

import ast
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "mirres_restir_nerf_mesh_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]


def test_no_source_names_jax():
    for p in BENCH.rglob("*.py"):
        assert not (set(_imports(p)) & FORBIDDEN), p


def test_reference_imports_nothing_of_the_port():
    for p in (BENCH / "reference").rglob("*.py"):
        assert "mirres_restir_nerf_mesh_torch" not in set(_imports(p)), p


def test_loaded_modules_by_top_level_name():
    code = ("import sys, json\n"
            "import benchmark.run, benchmark.harness.drivers, benchmark.harness.trace\n"
            "import benchmark.reference.stage1, benchmark.reference.stage0\n"
            "import mirres_restir_nerf_mesh_torch.train.trainer\n"
            "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    tops = set(json.loads(out.strip().splitlines()[-1]))
    assert not (tops & FORBIDDEN)
    assert "mirres_restir_nerf_mesh_torch" in tops
