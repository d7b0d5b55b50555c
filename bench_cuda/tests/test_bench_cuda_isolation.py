"""Nothing the benchmark runs imports the JAX stack or the JAX package, and
the reference imports nothing of the program; top-level module names are
compared whole (``pl_convlstm_gan_tpu_torch`` begins with the JAX
package's name and is allowed)."""
import ast
import os
import subprocess
import sys

from bench_cuda import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "pl_convlstm_gan_tpu"}
PROGRAM = "pl_convlstm_gan_tpu_torch"


def _sources(sub=""):
    base = os.path.join(harness.BENCH_DIR, sub)
    for dirpath, _, files in os.walk(base):
        if os.sep + "tests" in dirpath[len(harness.BENCH_DIR):] + os.sep:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _top_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        found = set(_top_imports(path)) & FORBIDDEN
        assert not found, f"{path} imports {found}"


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        names = set(_top_imports(path))
        assert PROGRAM not in names and not names & FORBIDDEN, path


def test_names_compared_whole():
    assert harness.forbidden_modules([
        "pl_convlstm_gan_tpu_torch", "pl_convlstm_gan_tpu_torch.streaming",
        "jax_like", "flaxen.x"]) == []
    assert harness.forbidden_modules([
        "jax.numpy", "jaxlib", "flax.linen", "pl_convlstm_gan_tpu.models"]) \
        == ["flax", "jax", "jaxlib", "pl_convlstm_gan_tpu"]


def test_a_run_loads_no_jax(tmp_path):
    """A tiny CPU run of the stream and train drivers in a fresh process
    leaves no module of the JAX stack or package in ``sys.modules``."""
    code = (
        "import sys, time\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "from bench_cuda.tests import tiny\n"
        "tiny.run('nowcast_128_bf16.stream')\n"
        "tiny.run('generator_default.train')\n"
        "from bench_cuda import harness\n"
        "print('FOUND', harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code, harness.ROOT],
                         capture_output=True, text=True, timeout=600,
                         cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout
