"""The PyTorch port imports neither JAX nor the JAX package, and its entry
points run on the card unless asked for the CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "hugectr_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "hugectr_tpu"}


def test_fresh_process_imports_every_port_module_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import hugectr_tpu_torch\n"
        "for m in pkgutil.walk_packages(hugectr_tpu_torch.__path__, 'hugectr_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in %r)\n"
        "print(sum(n.startswith('hugectr_tpu_torch') for n in sys.modules))\n"
        "assert not bad, bad\n"
        "assert {'hugectr_tpu_torch.tools.samples', 'hugectr_tpu_torch.layers.core_layers'} <= set(sys.modules)\n"
        % (FORBIDDEN,)
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.strip().splitlines()[-1]) >= 20  # every module was imported


def _top_level_imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_port_file_imports_jax_or_the_jax_package():
    bad = [
        (str(p.relative_to(ROOT)), name)
        for p in PORT_FILES
        for name in _top_level_imports(p)
        if name in FORBIDDEN  # exact top-level name: hugectr_tpu_torch is fine
    ]
    assert not bad, bad
    assert len(PORT_FILES) > 20


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    import hugectr_tpu_torch as hugectr
    from hugectr_tpu_torch.core.mesh import ResourceManager

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hugectr.Model(hugectr.CreateSolver(), None, hugectr.CreateOptimizer())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ResourceManager.create()
    assert ResourceManager.create(device="cpu").device.type == "cpu"
