"""Nothing of the benchmark imports JAX or the JAX package, compared by
whole top-level module name (the port's name begins with the JAX
package's); the reference imports nothing of the program; nothing reads
the JAX package's benchmark files."""

import ast
import os
import subprocess
import sys

from gpubench.harness import spec
from gpubench.harness.cli import FORBIDDEN


def _sources():
    for d, _, files in os.walk(spec.BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = set(_imports(path)) & set(FORBIDDEN)
        assert not bad, (path, bad)


def test_the_whole_name_is_compared():
    from gpubench.harness import cli

    assert cli.forbidden_modules(["kubeflow_controller_tpu_torch.models.generate",
                                  "jaxtyping", "flaxen", "numpy"]) == []
    assert cli.forbidden_modules(["jax.numpy", "kubeflow_controller_tpu.api",
                                  "flax.linen", "jaxlib"]) == [
        "flax", "jax", "jaxlib", "kubeflow_controller_tpu"]


def test_the_reference_imports_nothing_of_the_program():
    ref_dir = os.path.join(spec.BENCH_DIR, "reference")
    for f in os.listdir(ref_dir):
        if f.endswith(".py"):
            tops = set(_imports(os.path.join(ref_dir, f)))
            assert tops <= {"__future__", "contextlib", "typing", "torch"}, (f, tops)


def test_nothing_reads_the_jax_benchmarks():
    for path in _sources():
        text = open(path).read()
        for name in ("benchmarks/", "bench.py", "chip_smoke", "chip_ab"):
            assert name not in text or path.endswith("test_gpubench_imports.py"), (path, name)


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from gpubench.drivers import serve_open, serve_closed, train\n"
            "from gpubench.harness import cli\n"
            "import kubeflow_controller_tpu_torch.dataplane.serving_engine\n"
            "import kubeflow_controller_tpu_torch.dataplane.train\n"
            "print(cli.forbidden_modules())\n") % spec.ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
