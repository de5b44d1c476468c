"""The port stands alone: no module of ``src/repro_torch`` imports ``jax`` or
the JAX package, importing it needs neither a card nor ``nvcc``, and its
entry points default to the card."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

PKG = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax_and_no_reference_package():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 10
    bad = {(str(f.relative_to(PKG)), r) for f in files for r in _imported_roots(f)
           if r in FORBIDDEN}
    assert not bad, bad


def test_import_without_cuda_pulls_in_no_jax():
    """Every module imports with no visible card and leaves jax unloaded."""
    mods = sorted("repro_torch." + ".".join(f.relative_to(PKG).with_suffix("").parts)
                  for f in PKG.rglob("*.py") if f.name != "__init__.py")
    code = ("import sys, importlib, repro_torch\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(PKG.parent))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from repro_torch.configs import get_reduced
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine

    cfg = get_reduced("qwen2-1.5b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, {}, max_seq=8)
