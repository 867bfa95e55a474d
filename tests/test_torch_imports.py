"""PyTorch port: import hygiene. `repro_torch` (its serving driver
`launch/serve.py` too), `chip_smoke.py`, the port's scripts (`scripts/`)
and its examples (`examples/torch_*.py`) import neither JAX nor anything of
the JAX package `repro`, so all run on a GPU machine that has no JAX."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "scripts").glob("*.py"))
            + sorted((ROOT / "examples").glob("torch_*.py")))


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_sources_import_no_jax_and_no_repro():
    bad = [
        f"{p.relative_to(ROOT)}: {mod}"
        for p in _port_files()
        for mod in _imported_roots(p)
        if mod.split(".")[0] in ("jax", "jaxlib", "repro")
    ]
    assert not bad, bad
    assert len(_port_files()) > 15
    names = {p.name for p in _port_files()}
    assert "serve.py" in names and {f"torch_{n}.py" for n in (
        "quickstart", "sparse_grid_uq", "mlda_inversion", "serve_uq", "train_lm")} <= names


def test_importing_every_port_module_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= len(modules)
