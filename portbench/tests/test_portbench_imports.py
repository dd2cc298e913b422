"""What the benchmark runs never loads JAX or the JAX package, and the
reference imports nothing of the program it judges."""

import ast
import os
import subprocess
import sys

from portbench import cells

FORBIDDEN = {"jax", "jaxlib", "flax", "sr3_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    root = os.path.join(cells.HERE, sub)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not set(_imports(path)) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        names = set(_imports(path))
        assert names <= {"__future__", "math", "numpy", "torch",
                         "portbench"}, (path, names)
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("portbench"):
                assert node.module.startswith("portbench.reference"), path


def test_a_run_loads_neither_at_run_time():
    """A tiny run of both kinds in a fresh process, then its modules."""
    code = (
        "import sys, time\n"
        "from portbench.kinds import driver\n"
        "from portbench import cells\n"
        "from portbench.tests.portbench_tiny import tiny_opt\n"
        "from portbench.run import forbidden_modules\n"
        "for kind, mix in (('sample', 'ancestral_b8'), ('train', 'train_b128')):\n"
        "    t = dict(cells.traffic(mix), batch=2, resident=4)\n"
        "    driver(kind).run(tiny_opt(), t, 5, 0.05, False, 'cpu', time.time())\n"
        "assert 'sr3_tpu_torch' in sys.modules\n"
        "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
