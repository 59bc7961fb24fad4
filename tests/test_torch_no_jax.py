"""The PyTorch port imports neither JAX nor optax: every module of the
package imports in a fresh interpreter where both are blocked, and no
source file of the package or chip_smoke.py names them in an import."""
import ast
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = "manifold_constrained_gaussian_process_inference_tpu_torch"


def _modules():
    root = REPO / PACKAGE
    return sorted(
        ".".join((PACKAGE,) + p.relative_to(root).with_suffix("").parts).removesuffix(".__init__")
        for p in root.rglob("*.py")
    )


def test_port_imports_without_jax():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['optax'] = None\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules if sys.modules[m])\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_no_source_names_jax_or_optax():
    files = list((REPO / PACKAGE).rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "optax"), f"{path}: imports {name}"
                assert not name.startswith("manifold_constrained_gaussian_process_inference_tpu.") \
                    and name != "manifold_constrained_gaussian_process_inference_tpu", path
