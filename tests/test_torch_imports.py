"""ipp_tpu_torch imports no jax and no ipp_tpu module outside the shared
host list."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "ipp_tpu_torch"
SHARED = {"ipp_tpu", "ipp_tpu.io.tiff", "ipp_tpu.native",
          "ipp_tpu.utils.lagged", "ipp_tpu.utils.log",
          "ipp_tpu.utils.progress"}
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
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
