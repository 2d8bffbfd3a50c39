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
        "assert {'hugectr_tpu_torch.tools.samples', 'hugectr_tpu_torch.layers.core_layers',\n"
        "        'hugectr_tpu_torch.io.filesystem', 'hugectr_tpu_torch.utils.diagnose',\n"
        "        'hugectr_tpu_torch.data.native_reader', 'hugectr_tpu_torch.data.generator'} <= set(sys.modules)\n"
        % (FORBIDDEN,)
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.strip().splitlines()[-1]) >= 20  # every module was imported


def test_io_alone_imports_no_jax():
    """The port's copy of hugectr_tpu/io/filesystem.py (a module that
    imports no JAX in the JAX package either) pulls in neither JAX nor the
    JAX package when imported on its own."""
    code = (
        "import sys\n"
        "from hugectr_tpu_torch.io import filesystem\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in %r)\n"
        "assert not bad, bad\n"
        "assert filesystem.BF16_DESCR == '<V2'\n" % (FORBIDDEN,)
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert any(p.parent.name == "io" for p in PORT_FILES)


def test_native_reader_import_builds_nothing():
    """Importing the native Raw reader's module (or the readers, or the
    generator) compiles nothing, imports no JAX and no pyarrow: g++ runs at
    the first `NativeRawReader`, pyarrow at the first Parquet reader."""
    code = (
        "import subprocess, sys\n"
        "calls = []\n"
        "subprocess.run = subprocess.Popen = lambda *a, **k: calls.append(a)\n"
        "import hugectr_tpu_torch.data.native_reader as n\n"
        "import hugectr_tpu_torch.data.reader, hugectr_tpu_torch.data.generator\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "assert not bad, bad\n"
        "assert calls == [] and n._lib is None, calls\n"
        "assert 'pyarrow' not in sys.modules\n" % (FORBIDDEN,)
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert (ROOT / "hugectr_tpu_torch" / "csrc" / "raw_reader.cpp").exists()


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


def test_module_exports_reference_names():
    """The port's module exports every name that the JAX package's
    tests/test_api_parity.py::test_module_exports_reference_names asks of
    it, with the same member spot-checks, and `HugeCTRError`."""
    import hugectr_tpu_torch as hugectr

    names = [
        "CreateSolver", "CreateOptimizer", "Model", "Input", "SparseEmbedding",
        "DenseLayer", "DenseLayerComputeConfig", "EmbeddingCollectionConfig",
        "EmbeddingTableConfig", "DataReaderParams", "DataReaderSparseParam",
        "AsyncParam", "DataSourceParams", "DataGenerator",
        "DataGeneratorParams", "LearningRateScheduler", "TrainingCallback",
        "OptParamsPy",
        "Error_t", "Check_t", "DataReaderType_t", "FileSystemType_t",
        "SourceType_t", "TrainPSType_t", "Embedding_t", "Initializer_t",
        "Layer_t", "Alignment_t", "LrPolicy_t", "Optimizer_t", "Update_t",
        "Activation_t", "FcPosition_t", "Regularizer_t", "MetricsType",
        "MetricsRawType", "DeviceLayout", "AllReduceAlgo", "Distribution_t",
        "PowerLaw_t", "Tensor_t", "CommunicationStrategy",
        "CompressionStrategy",
    ]
    assert len(names) == 43
    missing = [n for n in names + ["HugeCTRError"] if not hasattr(hugectr, n)]
    assert not missing, f"missing exports: {missing}"
    assert set(names + ["HugeCTRError"]) <= set(hugectr.__all__)
    assert hugectr.FcPosition_t.Head and hugectr.FcPosition_t.Tail
    assert hugectr.Alignment_t.Auto and hugectr.Alignment_t.Non
    assert hugectr.FileSystemType_t.HDFS and hugectr.FileSystemType_t.S3
    assert hugectr.Distribution_t.PowerLaw
    assert hugectr.Tensor_t.Train and hugectr.Tensor_t.Evaluate
    assert hugectr.DeviceLayout.LocalFirst
    assert hugectr.AllReduceAlgo.OneShot
    assert hugectr.Update_t.LazyGlobal
    assert hugectr.Error_t.WrongInput
    err = hugectr.HugeCTRError(hugectr.Error_t.EndOfFile, "eof")
    assert err.error_t == hugectr.Error_t.EndOfFile
    # the reference's no-op arguments are accepted
    layer = hugectr.DenseLayer(layer_type="ReLU", bottom_names=["a"], top_names=["b"],
                               compute_config=hugectr.DenseLayerComputeConfig(async_wgrad=True))
    assert layer == hugectr.DenseLayer(layer_type="ReLU", bottom_names=["a"], top_names=["b"])
    ebc = hugectr.EmbeddingCollectionConfig()
    ebc.shard(shard_matrix=[["t"]], shard_strategy=[("mp", ["t"])],
              compression_strategy={hugectr.CompressionStrategy.Unique: ["t"]})
    assert ebc.shard_matrix == [["t"]]


def test_mesh_settings_are_accepted_and_kept():
    """The JAX Solver's mesh settings and `group_rows`, Hierarchical
    communication and column factors are fields the port keeps (they
    raised until the meshes were ported)."""
    import hugectr_tpu_torch as hugectr

    s = hugectr.CreateSolver(num_slices=2, group_rows=4096)
    assert (s.num_slices, s.ev_parallelism, s.group_rows) == (2, 1, 4096)
    assert hugectr.CreateSolver(ev_parallelism=2).ev_parallelism == 2
    ebc = hugectr.EmbeddingCollectionConfig(comm_strategy="hierarchical")
    assert ebc.comm_strategy == hugectr.CommunicationStrategy.Hierarchical
    ebc.shard(shard_matrix=[["t"]], shard_strategy=[("mp", ["t"])], column_factors={"t": 2})
    assert ebc.sharding_plan().column_factors == {"t": 2}
