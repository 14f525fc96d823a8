"""ipp_tpu_torch, chip_smoke.py and the port's kernel benches import no jax
and no ipp_tpu module: the port keeps its own copies of the reference's
host code (tests/test_torch_hostio.py holds them to their originals).
They import OpenCV nowhere but in the converter's movie writer
(`pipeline/convert.tif_series_to_movie`, host codec work, as in the JAX
package): the card's host has no OpenCV.  They import h5py nowhere: the
card's host has none, and the port reads and writes HDF5 through its own
`io/hdf5.py`."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "ipp_tpu_torch"
# reference modules the port may import: none
SHARED = set()
# the port's kernel benches (scripts/pallas_dwt_bench.py is the reference's)
BENCHES = ["stage_fft_bench.py", "dft_fft_bench.py", "rdft_y_bench.py",
           "dwt_bench.py", "mesh_bench.py", "rdft_dense_bench.py",
           "stage_mixed_bench.py", "stage_large_bench.py",
           "cplx_dense_bench.py"]
FILES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + [ROOT / "scripts" / b for b in BENCHES])
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).replace(
        ".__init__", "")
    for p in PORT.rglob("*.py"))


def _imported(tree):
    """(module, [full names]) of every absolute import in the tree."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, [a.name]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, [f"{node.module}.{a.name}" for a in node.names]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_only_shared_reference_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for module, names in _imported(tree):
        top = module.split(".")[0]
        assert top not in ("jax", "jaxlib"), f"{path}: imports {module}"
        if top == "ipp_tpu":
            ok = module in SHARED or all(n in SHARED for n in names)
            assert ok, f"{path}: imports {module} {names}"


@pytest.mark.parametrize("platform", [None, "cpu"])
def test_every_port_module_imports_without_jax(platform):
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules, sorted(\n"
            "    k for k in sys.modules if k.startswith('jax'))\n"
            "ref = sorted(k for k in sys.modules\n"
            "             if k == 'ipp_tpu' or k.startswith('ipp_tpu.'))\n"
            "assert not ref, ref\n"
            "print('OK', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("IPP_TPU_PLATFORM", "PYTHONSTARTUP")}
    if platform:
        env["IPP_TPU_PLATFORM"] = platform
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")


# the one place the port may import OpenCV: (file, enclosing function)
CV2_ALLOWED = {("ipp_tpu_torch/pipeline/convert.py", "tif_series_to_movie")}


def _cv2_imports(tree):
    """(enclosing function name or None, line) of every cv2 import."""
    found = []

    def visit(node, func):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, child.name)
                continue
            if isinstance(child, ast.Import):
                if any(a.name.split(".")[0] == "cv2" for a in child.names):
                    found.append((func, child.lineno))
            elif isinstance(child, ast.ImportFrom) and child.module and \
                    child.module.split(".")[0] == "cv2":
                found.append((func, child.lineno))
            visit(child, func)

    visit(tree, None)
    return found


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_opencv_but_in_the_movie_writer(path):
    rel = str(path.relative_to(ROOT))
    for func, line in _cv2_imports(ast.parse(path.read_text())):
        assert (rel, func) in CV2_ALLOWED, f"{rel}:{line} imports cv2"


def test_the_movie_writer_is_the_one_opencv_import():
    tree = ast.parse((ROOT / "ipp_tpu_torch/pipeline/convert.py").read_text())
    assert [f for f, _ in _cv2_imports(tree)] == ["tif_series_to_movie"]


def _h5py_imports(tree):
    """Lines that import h5py: import statements, and __import__ or
    importlib.import_module called with the name."""
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [node.lineno for a in node.names
                      if a.name.split(".")[0] == "h5py"]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and \
                node.module.split(".")[0] == "h5py":
            found.append(node.lineno)
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                str(node.args[0].value).split(".")[0] == "h5py" and \
                getattr(node.func, "attr", getattr(node.func, "id", None)) \
                in ("import_module", "__import__"):
            found.append(node.lineno)
    return found


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_h5py(path):
    lines = _h5py_imports(ast.parse(path.read_text()))
    assert not lines, f"{path.relative_to(ROOT)}:{lines} imports h5py"


def test_the_h5py_guard_sees_every_form():
    src = ("import h5py\nimport h5py.h5t as t\nfrom h5py import File\n"
           "importlib.import_module('h5py')\n__import__('h5py')\n"
           "from . import hdf5 as h5py\n")
    assert _h5py_imports(ast.parse(src)) == [1, 2, 3, 4, 5]
