"""The port stands alone: no module of ``src/repro_torch``, and neither of
its scripts at the root, imports ``jax`` or the JAX package; importing it
needs neither a card nor ``nvcc``; its entry points default to the card; and
its kernel package exports every name of the JAX package's."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SCRIPTS = ("chip_smoke.py", "decode_trace.py")  # the port's scripts at the root
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax_and_no_reference_package():
    files = sorted(PKG.rglob("*.py")) + [ROOT / name for name in SCRIPTS]
    assert len(files) >= 12 and all(f.is_file() for f in files)
    assert {PKG / "models" / "mla.py", PKG / "configs" / "deepseek_v2_lite.py",
            PKG / "models" / "mamba.py", PKG / "configs" / "falcon_mamba_7b.py"} <= set(files)
    bad = {(str(f.relative_to(ROOT)), r) for f in files for r in _imported_roots(f)
           if r in FORBIDDEN}
    assert not bad, bad


def test_kernels_export_every_name_of_the_jax_kernels():
    """``repro_torch.kernels`` has every name of ``repro.kernels.__all__``,
    read from the JAX package's source (so nothing of JAX is imported)."""
    tree = ast.parse((ROOT / "src" / "repro" / "kernels" / "__init__.py").read_text())
    (names,) = [ast.literal_eval(node.value) for node in tree.body
                if isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == "__all__" for t in node.targets)]
    assert "bitplane_matmul" in names and "fold_sum" in names
    import repro_torch.kernels as kernels

    missing = [n for n in names if n not in kernels.__all__ or not hasattr(kernels, n)]
    assert not missing, missing


def test_core_exports_every_name_of_the_jax_core():
    """``repro_torch.core`` has every name of ``repro.core.__all__``, read
    from the JAX package's source."""
    tree = ast.parse((ROOT / "src" / "repro" / "core" / "__init__.py").read_text())
    (names,) = [ast.literal_eval(node.value) for node in tree.body
                if isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == "__all__" for t in node.targets)]
    assert "PicasoArray" in names and "scalability" in names
    import repro_torch.core as core

    assert core.__all__ == names
    assert all(hasattr(core, n) for n in names)


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


@pytest.mark.parametrize("module", ["repro_torch.kernels.pim_matvec",
                                    "repro_torch.kernels.pim_matmul",
                                    "repro_torch.kernels.bitplane",
                                    "repro_torch.kernels.fold_reduce",
                                    "repro_torch.kernels.flash_attn",
                                    "repro_torch.kernels.ops",
                                    "repro_torch.models.attention",
                                    "repro_torch.serving.engine",
                                    "repro_torch.serving.prefix",
                                    "repro_torch.serving.resilience",
                                    "repro_torch.serving.chaos",
                                    "repro_torch.serving.router",
                                    "repro_torch.serving.speculative",
                                    "repro_torch.runtime.fault",
                                    "repro_torch.core.simulator",
                                    "repro_torch.core.paper_tables",
                                    "repro_torch.configs.llama3_2_3b",
                                    "repro_torch.configs.starcoder2_7b",
                                    "repro_torch.configs.starcoder2_15b",
                                    "repro_torch.configs.llama3_2_vision_90b",
                                    "repro_torch.configs.seamless_m4t_medium",
                                    "repro_torch.configs.moonshot_16b_a3b",
                                    "repro_torch.configs.deepseek_v2_lite",
                                    "repro_torch.models.moe",
                                    "repro_torch.models.mla",
                                    "repro_torch.models.draw"])
def test_kernel_module_imports_alone_without_card_or_build(module):
    """A kernel module, a module of the paged serving path, its resilience
    tier or its speculation, of the PiCaSO machine, a config, the MoE
    layer, MLA attention, or the slice-by-slice weight draw,
    imported on its own, with no card and no CUDA toolkit, pulls in
    neither jax nor the JAX package and builds nothing."""
    assert (PKG / Path(*module.split(".")[1:])).with_suffix(".py").is_file()
    code = (f"import sys, {module}\n"
            "from repro_torch.kernels import build\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n"
            "assert not build._libs, build._libs\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", CUDA_HOME="/nonexistent",
               PYTHONPATH=str(PKG.parent))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from repro_torch.configs import get_reduced
    from repro_torch.models import init_params
    from repro_torch.models import init_paged_cache
    from repro_torch.serving import ContinuousBatchingEngine, ServingEngine, SpecConfig

    cfg = get_reduced("qwen2-1.5b")
    for arch in ("llama3.2-3b", "starcoder2-7b", "starcoder2-15b", "deepseek-v2-lite-16b",
                 "moonshot-v1-16b-a3b", "seamless-m4t-medium", "llama-3.2-vision-90b"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_params(get_reduced(arch), torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, {}, max_seq=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatchingEngine(cfg, {}, slots=1, max_seq=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatchingEngine(cfg, {}, slots=1, max_seq=8, speculate=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatchingEngine(cfg, {}, slots=1, max_seq=8, speculate=SpecConfig(mode="draft"),
                                 draft_cfg=cfg, draft_params={})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_paged_cache(cfg, 1, 8, 3, 4)
    from repro_torch.core import PicasoArray, simulate_dot_product

    with pytest.raises(RuntimeError, match="device='cpu'"):
        PicasoArray(n_blocks=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate_dot_product(list(range(16)), list(range(16)), 8)
