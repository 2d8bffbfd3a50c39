"""The root tools' command lines on the port, against the JAX package's
scripts on the same inputs (made here from a seed).

- data_generator: Raw and RawAsync files byte-equal, Parquet files equal
  column by column (and their `_metadata.json`).
- criteo_to_raw: a synthetic Criteo TSV of 300 lines (empty fields,
  negative integers, repeated hex ids): the port's native engine (g++)
  and numpy engine byte-equal to the JAX script's native and numpy paths,
  with and without `--remap`.
- criteo_preprocess: the same TSV gives the same Parquet values, with and
  without `--frequency-remap`.
- embedding_gen: the same seed gives the same files, byte for byte.
- embedding_workspace_calculator: the weights line equals the JAX
  script's for sgd, adagrad, adam and ftrl at 1 and 4 devices (tables of
  more than 8,192 rows, model-parallel in the port); every line's bytes
  equal the tables' and optimizer state's `nbytes` of a port model built
  from the same tables; `rowwise_adagrad` sizes in the port and raises
  KeyError in the JAX script (a fault of the reference).
- fullscale_dryrun: the tool's build-and-step function at cap 4,000, batch
  64, 2 steps with `TINY_BENCH`'s sizes (so the hot/cold split is taken)
  against JAX's `build_dlrm_dcnv2` under the same HCTR_TPU_* settings from
  carried state: losses within tests/test_torch_bench.py's tolerances
  (step 1 rtol 1e-5, step 2 rtol 5e-3); its flags parse.
- auc_scale_probe at 20,000 tied predictions: both AUCs within 1e-6 of
  JAX's `auc_score` / `auc_score_large` on the same inputs.
- eval_batch_sweep and eval_profile at tiny sizes: every line parses.
"""
import json
import os
import re
import runpy
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import hugectr_tpu as jh
from hugectr_tpu.core.mesh import ResourceManager as JaxResourceManager
from hugectr_tpu.metrics.metrics import auc_score as jax_auc, auc_score_large as jax_auc_large
from hugectr_tpu.tools import flagship as jflagship

import hugectr_tpu_torch as th
from hugectr_tpu_torch.tools import (auc_scale_probe, criteo_preprocess, criteo_to_raw, data_generator,
                                     embedding_gen, embedding_workspace_calculator as calc, eval_batch_sweep,
                                     eval_profile, flagship as tflagship, fullscale_dryrun)
from hugectr_tpu_torch.tools.carry import load_jax_state

torch.set_num_threads(1)
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TOOLS = os.path.join(ROOT, "tools")


def run_jax_tool(monkeypatch, name, argv):
    """tools/<name>.py of the JAX package as `__main__` with `argv`."""
    monkeypatch.setattr(sys, "argv", [name, *argv])
    runpy.run_path(os.path.join(TOOLS, f"{name}.py"), run_name="__main__")


def files_under(d):
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)


# ------------------------------------------------------------ data generator
@pytest.mark.parametrize("fmt", ["raw", "raw_async", "parquet"])
def test_data_generator_cli_matches_jax(fmt, tmp_path, monkeypatch, capsys):
    args = ["--format", fmt, "--slot_size_array", "100,7,3000", "--nnz_array", "2,1,3", "--num_files", "2",
            "--eval_num_files", "1", "--num_samples_per_file", "300", "--alpha", "1.1"]
    out = {}
    for side in ("jax", "port"):
        d = tmp_path / side
        argv = [*args, "--source", str(d / ("train.bin" if fmt != "parquet" else "file_list.txt")),
                "--eval_source", str(d / ("eval.bin" if fmt != "parquet" else "file_list_test.txt"))]
        if side == "jax":
            run_jax_tool(monkeypatch, "data_generator", argv)
        else:
            data_generator.main(argv)
        out[side] = d
    assert capsys.readouterr().out.count("wrote train=") == 2
    names = files_under(out["jax"])
    assert names == files_under(out["port"]) and names
    for n in names:
        j, t = out["jax"] / n, out["port"] / n
        if n.endswith(".parquet"):
            import pyarrow.parquet as pq

            jt, tt = pq.read_table(j), pq.read_table(t)
            assert jt.schema == tt.schema, n
            for c in jt.column_names:  # list columns for nnz > 1
                assert tt[c].to_pylist() == jt[c].to_pylist(), f"{n} {c}"
        elif n.endswith(".json"):
            assert json.loads(t.read_text()) == json.loads(j.read_text()), n
        elif n.endswith(".txt"):  # file lists name each side's own directory
            assert t.read_text().replace(str(out["port"]), "") == j.read_text().replace(str(out["jax"]), ""), n
        else:
            assert t.read_bytes() == j.read_bytes(), n


# -------------------------------------------------------------------- Criteo
@pytest.fixture(scope="module")
def criteo_tsv(tmp_path_factory):
    """300 Criteo lines from a seed: empty fields, negative integers, hex ids
    drawn from a small pool (so they repeat), a short line."""
    rng = np.random.default_rng(3)
    pool = [format(int(x), "08x") for x in rng.integers(0, 2**32, 40)]
    lines = []
    for i in range(300):
        f = [str(int(rng.integers(0, 2)))]
        for _ in range(13):
            f.append("" if rng.random() < 0.15 else str(int(rng.integers(-3, 5000))))
        for _ in range(26):
            hot = rng.random() < 0.5  # half the ids from 4 of the pool: many repeats
            f.append("" if rng.random() < 0.1 else pool[int(rng.integers(0, 4 if hot else len(pool)))])
        lines.append("\t".join(f[: 30] if i == 7 else f))
    path = tmp_path_factory.mktemp("criteo") / "day.tsv"
    path.write_text("\n".join(lines) + "\n")
    return path


@pytest.mark.parametrize("remap", [False, True], ids=["plain", "remap"])
def test_criteo_to_raw_engines_match_jax(criteo_tsv, tmp_path, remap):
    extra = ["--vocab_cap", "1000003", "--threads", "3"] + (["--remap"] if remap else [])
    outs = {}
    for engine in ("native", "numpy"):
        env = dict(os.environ, PYTHONPATH=ROOT)
        env.pop("HCTR_TPU_FORCE_NUMPY", None)
        if engine == "numpy":
            env["HCTR_TPU_FORCE_NUMPY"] = "1"
        jout = tmp_path / f"jax_{engine}.bin"
        r = subprocess.run([sys.executable, os.path.join(TOOLS, "criteo_to_raw.py"), "--input", str(criteo_tsv),
                            "--output", str(jout), *extra], env=env, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr
        assert ("numpy fallback" in r.stderr) is False
        tout = tmp_path / f"port_{engine}.bin"
        criteo_to_raw.main(["--input", str(criteo_tsv), "--output", str(tout), "--engine", engine, *extra])
        outs[engine] = (jout.read_bytes(), tout.read_bytes())
        assert outs[engine][1] == outs[engine][0], engine
    assert outs["native"][1] == outs["numpy"][1]
    rows = np.frombuffer(outs["numpy"][1], np.int32).reshape(-1, 40)
    assert rows.shape[0] == 300 and (rows[:, 1:14] < 0).any()
    if remap:
        assert rows[:, 14:].min() == 0 and rows[:, 14:].max() < 45


def test_criteo_to_raw_build_failure_raises(tmp_path, monkeypatch):
    """A converter source that does not compile raises with g++'s message;
    nothing falls back to the numpy engine."""
    from hugectr_tpu_torch.data import native_reader

    bad = tmp_path / "criteo_convert.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(criteo_to_raw, "SOURCE", bad)
    monkeypatch.setattr(native_reader, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build the Criteo converter"):
        criteo_to_raw.main(["--input", str(bad), "--output", str(tmp_path / "x.bin")])
    assert not (tmp_path / "x.bin").exists()


@pytest.mark.parametrize("remap", [False, True], ids=["plain", "frequency_remap"])
def test_criteo_preprocess_matches_jax(criteo_tsv, tmp_path, monkeypatch, remap):
    import pyarrow.parquet as pq

    extra = ["--vocab_cap", "1000003", "--rows_per_file", "128"] + (["--frequency-remap"] if remap else [])
    run_jax_tool(monkeypatch, "criteo_preprocess", ["--input", str(criteo_tsv), "--out_dir", str(tmp_path / "j"),
                                                    *extra])
    criteo_preprocess.main(["--input", str(criteo_tsv), "--out_dir", str(tmp_path / "t"), *extra])
    names = files_under(tmp_path / "j")
    assert names == files_under(tmp_path / "t") and len([n for n in names if n.endswith(".parquet")]) == 3
    for n in names:
        j, t = tmp_path / "j" / n, tmp_path / "t" / n
        if n.endswith(".parquet"):
            jt, tt = pq.read_table(j), pq.read_table(t)
            assert jt.column_names == tt.column_names and jt.schema == tt.schema, n
            for c in jt.column_names:
                np.testing.assert_array_equal(tt[c].to_numpy(), jt[c].to_numpy(), err_msg=f"{n} {c}")
        elif n.endswith(".json"):
            assert json.loads(t.read_text()) == json.loads(j.read_text()), n


def test_embedding_gen_matches_jax(tmp_path, monkeypatch):
    argv = ["--embedding-size", "1000-37-2500", "--dim", "16", "--names", "a,b,c", "--seed", "5"]
    run_jax_tool(monkeypatch, "embedding_gen", [*argv, "--output", str(tmp_path / "j")])
    embedding_gen.main([*argv, "--output", str(tmp_path / "t")])
    names = files_under(tmp_path / "j")
    assert names == files_under(tmp_path / "t") == [f"sparse_{n}/emb_vector.npy" for n in "abc"]
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == (tmp_path / "j" / n).read_bytes(), n


# ---------------------------------------------------------------- calculator
VOCABS, EVS, HOT = [20000, 50001, 9000, 300000], [16, 16, 8, 32], [2, 1, 3, 1]
CALC_ARGV = ["--vocab", ",".join(map(str, VOCABS)), "--ev", ",".join(map(str, EVS)),
             "--hotness", ",".join(map(str, HOT)), "--batchsize", "512"]


@pytest.mark.parametrize("devices", [1, 4])
@pytest.mark.parametrize("opt", ["sgd", "adagrad", "adam", "ftrl"])
def test_calculator_weights_line_matches_jax(opt, devices, monkeypatch, capsys):
    argv = [*CALC_ARGV, "--optimizer", opt, "--num_devices", str(devices)]
    run_jax_tool(monkeypatch, "embedding_workspace_calculator", argv)
    jlines = capsys.readouterr().out.splitlines()
    calc.main(argv)
    tlines = capsys.readouterr().out.splitlines()
    assert tlines[0] == jlines[0] and tlines[1] == jlines[1]  # rows, weights
    assert tlines[2] == jlines[2]  # the state's layouts agree for these optimizers
    assert len(tlines) == len(jlines) + 1 and tlines[-1].startswith("  bytes: weights=")


def _port_model(opt: str):
    """A port model with the calculator's tables, on the CPU."""
    solver = th.CreateSolver(batchsize=64, batchsize_eval=64, max_eval_batches=1)
    reader = th.DataReaderParams(data_reader_type="synthetic", synthetic_num_batches=1)
    m = th.Model(solver, reader, th.CreateOptimizer(optimizer_type=opt), device="cpu")
    m.add(th.Input(label_dim=1, label_name="label", dense_dim=1, dense_name="dense",
                   data_reader_sparse_param_array=[th.DataReaderSparseParam(f"d{i}", h, True, 1)
                                                   for i, h in enumerate(HOT)]))
    ebc = th.EmbeddingCollectionConfig()
    tables = [th.EmbeddingTableConfig(name=str(i), max_vocabulary_size=v, ev_size=e)
              for i, (v, e) in enumerate(zip(VOCABS, EVS))]
    ebc.embedding_lookup(tables, [f"d{i}" for i in range(len(VOCABS))], "emb", ["sum"] * len(VOCABS))
    ebc.shard(shard_matrix=[[t.name for t in tables]], shard_strategy=[("mp", [t.name for t in tables])])
    m.add(ebc)
    m.add(th.DenseLayer(layer_type=th.Layer_t.InnerProduct, bottom_names=["emb"], top_names=["fc"], num_output=1))
    m.add(th.DenseLayer(layer_type=th.Layer_t.BinaryCrossEntropyLoss, bottom_names=["fc", "label"],
                        top_names=["loss"]))
    m.compile()
    return m


@pytest.mark.parametrize("opt", ["sgd", "momentum_sgd", "adagrad", "rowwise_adagrad", "rmsprop", "adam", "ftrl"])
def test_calculator_bytes_are_what_the_port_allocates(opt, capsys):
    m = _port_model(opt)
    tables = sum(t.numel() * t.element_size() for t in m.tables.values())
    state = sum(t.numel() * t.element_size() for st in m.eopt.values() for t in st.values())
    calc.main([*CALC_ARGV, "--optimizer", opt])
    last = capsys.readouterr().out.splitlines()[-1]
    got = dict(kv.split("=") for kv in last.split(":", 1)[1].split())
    assert int(got["weights"]) == tables and int(got["state"]) == state, (last, tables, state)
    est = calc.estimate(VOCABS, EVS, HOT, opt)
    assert est["rows"] == sum(VOCABS) and (opt != "rowwise_adagrad" or est["state"] == sum(VOCABS) * 4)


def test_calculator_rowwise_adagrad_sizes_in_the_port_only(monkeypatch, capsys):
    """The JAX script cannot size bench.py's own optimizer: `STATE_SLOTS`
    lacks RowWiseAdaGrad (tools/embedding_workspace_calculator.py:14-23),
    a fault of the reference; the port sizes its [R, 1] slot."""
    argv = [*CALC_ARGV, "--optimizer", "rowwise_adagrad", "--dtype_bytes", "2"]
    with pytest.raises(KeyError):
        run_jax_tool(monkeypatch, "embedding_workspace_calculator", argv)
    calc.main(argv)
    out = capsys.readouterr().out
    assert "(rowwise_adagrad)" in out and f"state={sum(VOCABS) * 2} " in out


# ---------------------------------------------------------------- full scale
# the JAX tool's settings (tools/fullscale_dryrun.py:6-9: the caps measured,
# the headroom left at its default), at the tiny split sizes
JAX_ENV = {
    "HCTR_TPU_EMB_DTYPE": "bfloat16", "HCTR_TPU_EMB_STATE_DTYPE": "bfloat16", "HCTR_TPU_SEGSUM": "xla",
    "HCTR_TPU_UCAP_FACTOR": "auto", "HCTR_TPU_UCAP_HEADROOM": "1.25", "HCTR_TPU_HOT_ROWS": "256", "HCTR_TPU_SUPERHOT_ROWS": "32",
    "HCTR_TPU_SPLIT_VOCAB": "512", "HCTR_TPU_ONEHOT_VOCAB": "64", "HCTR_TPU_AUC_EXACT_MAX": "100",
    "HCTR_TPU_DENSE_UPDATE_ROWS": "1024", "HCTR_TPU_DENSE_KEY_RATIO": "0.3", "HCTR_BENCH_OPT": "rowwise_adagrad",
}


def test_fullscale_tool_at_a_small_cap_matches_jax(monkeypatch):
    """The tool's `run` at cap 4,000, batch 64, 2 steps with TINY_BENCH's
    widths and split sizes, from JAX's carried state."""
    for k, v in JAX_ENV.items():
        monkeypatch.setenv(k, v)
    t = tflagship.TINY_BENCH
    widths = {k: t[k] for k in ("ev_size", "bottom_mlp", "top_mlp", "projection_dim", "num_cross_layers")}
    reader = jh.DataReaderParams(data_reader_type="synthetic", synthetic_num_batches=2, synthetic_alpha=1.05,
                                 synthetic_learnable=True)
    jm = jflagship.build_dlrm_dcnv2(JaxResourceManager.create(num_devices=1), batchsize=64, vocab_cap=4000,
                                    use_mixed_precision=True, reader=reader, max_eval_batches=1, **widths)
    overrides = dict(widths, onehot_vocab=t["onehot_vocab"], hot_rows=t["hot_rows"],
                     superhot_rows=t["superhot_rows"], split_vocab=t["split_vocab"],
                     dense_update_rows=t["dense_update_rows"], auc_exact_max=t["auc_exact_max"],
                     synthetic_learnable=True)
    lines = []

    def carry(model, i):
        if i == 1:
            assert model.ec.plan.table_splits == jm.ec.plan.table_splits and model.ec.plan.table_splits
            load_jax_state(model, jax.device_get(jm.state))

    tm, rec = fullscale_dryrun.run(["--vocab-cap", "4000", "--batch", "64", "--steps", "2", "--device", "cpu"],
                                   overrides=overrides, step_hook=carry,
                                   say=lambda *a, **k: lines.append(" ".join(map(str, a))))
    jl = [jm.train() for _ in range(2)]
    assert rec["caps"] == dict(unique=jm.ec.unique_caps, valid=jm.ec.valid_caps,
                               dense_exchange=jm.ec.dense_exchange_caps) and rec["caps"]["valid"]
    np.testing.assert_allclose(rec["losses"][0], jl[0], rtol=1e-5)
    np.testing.assert_allclose(rec["losses"][1], jl[1], rtol=5e-3)
    assert rec["rows_total"] == fullscale_dryrun.rows_total(4000) == sum(min(v, 4000)
                                                                         for v in tflagship.MLPERF_TABLE_SIZES)
    assert rec["allocated"]["tables"] == rec["allocated"]["plan_tables"] == rec["calculator"]["weights"]
    assert rec["allocated"]["state"] == rec["calculator"]["state"]
    assert set(rec["routes"].values()) == {"onehot", "dense", "sorted"}
    assert re.match(r"build\+init [0-9.]+s; rows total [0-9,]+$", lines[0])
    assert [ln.split()[:2] for ln in lines[3:5]] == [["step", "1"], ["step", "2"]]
    assert json.loads(lines[-1])["losses"] == rec["losses"]
    assert fullscale_dryrun.rows_total(fullscale_dryrun.FULL_VOCAB) == 204_184_588


def test_fullscale_flags_parse(capsys):
    a = fullscale_dryrun.parse_args([])
    assert (a.steps, a.eval_batches, a.vocab_cap, a.batch, a.device) == (2, 0, 40_000_000, 16384, None)
    with pytest.raises(SystemExit) as e:
        fullscale_dryrun.parse_args(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert all(f in out for f in ("--steps", "--eval-batches", "--vocab-cap", "--batch", "--device"))


# ----------------------------------------------------------------------- AUC
def test_auc_probe_with_ties_matches_jax(capsys):
    recs = auc_scale_probe.main(["--sizes", "20000", "--device", "cpu", "--ties", "64"])
    preds, labels = auc_scale_probe.inputs(20000, 0, 64)
    assert len(np.unique(preds)) < 200  # many ties
    (rec,) = recs
    assert abs(rec["exact"] - float(jax_auc(preds, labels))) <= 1e-6
    assert abs(rec["binned"] - float(jax_auc_large(preds, labels))) <= 1e-6
    out = capsys.readouterr().out.splitlines()
    assert all(re.match(r"n=\s+20,000\s+(exact|binned)\s+auc=[0-9.]+ finalize=\s*[0-9.]+ ms$", ln)
               for ln in out[:2]) and json.loads(out[2]) == rec


# ---------------------------------------------------------------- eval tools
def test_eval_tools_lines_parse(capsys):
    eval_batch_sweep.main(["--eval-batches", "64,128", "--samples", "256", "--vocab-cap", "1000", "--batch", "64",
                           "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert all(re.match(r"eval_batch\s+\d+: [0-9,]+ ex/s \([0-9.]+s for \d+ batches\)$", ln) for ln in out[:2])
    assert [r["batches"] for r in json.loads(out[2])] == [4, 2]
    rec = eval_profile.main(["--eval-batches", "3", "--vocab-cap", "1000", "--batch", "64", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    pats = [r"3 eval batches cached$", r"eval_step alone: [0-9.]+ ms/batch = [0-9,]+ ex/s$",
            r"eval_step\+write: [0-9.]+ ms/batch = [0-9,]+ ex/s$", r"finalize\(192 buf\): [0-9.]+ ms  \{.*\}$",
            r"model.eval\(\): [0-9.]+s for 3 batches = [0-9.]+ ms/batch = [0-9,]+ ex/s$"]
    assert len(out) == 6 and all(re.match(p, ln) for p, ln in zip(pats, out)), out
    assert json.loads(out[5]) == json.loads(json.dumps(rec))
