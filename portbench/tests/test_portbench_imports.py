"""Nothing the benchmark runs imports JAX or the JAX package, compared by
the whole top-level name of each module (the port's name begins with the
JAX package's), and the reference imports nothing of the port."""
from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from portbench.tests.helpers import ROOT

JAX_NAMES = {"jax", "jaxlib", "flax", "manifold_constrained_gaussian_process_inference_tpu"}
PORT = "manifold_constrained_gaussian_process_inference_tpu_torch"


def _imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return {n.split(".")[0] for n in names}


@pytest.mark.parametrize("path", sorted((ROOT / "portbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax(path):
    assert not _imported(path) & JAX_NAMES


def test_reference_imports_nothing_of_the_port():
    for path in (ROOT / "portbench" / "reference").rglob("*.py"):
        text = path.read_text()
        assert PORT not in text and "from ..core" not in text, path
        assert not _imported(path) & (JAX_NAMES | {PORT})


def test_running_modules_load_no_jax():
    """The harness, the port's modules it drives and the reference, loaded
    in one fresh process, leave no JAX module in sys.modules."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import portbench.run, portbench.core.sampler as s, portbench.core.judge, "
        "portbench.core.traced, portbench.core.faults, portbench.reference.nuts\n"
        "s.port(); s._mod('inference.tempering'); s._mod('parallel.chains')\n"
        "print(sorted({n.split('.')[0] for n in sys.modules} & %r))\n" % (str(ROOT), JAX_NAMES))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_reference_alone_loads_no_port():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.reference.posterior, portbench.reference.nuts\n"
            "print(sorted({n.split('.')[0] for n in sys.modules} & %r))\n"
            % (str(ROOT), JAX_NAMES | {PORT}))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
