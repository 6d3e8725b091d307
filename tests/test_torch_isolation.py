"""Rules of the PyTorch port that later slices must keep:

- ``lightgbm_tpu_torch`` imports neither ``jax`` nor the JAX package
  ``lightgbm_tpu`` (it runs on a GPU host that has no JAX);
- with the default ``device_type`` ("cuda") and no CUDA device, training
  (with a custom objective too) raises a RuntimeError naming the device;
  it never continues on the CPU;
- a parameter outside the ported slice raises NotImplementedError naming
  it, instead of being silently ignored;
- pandas is imported only on the path that receives a DataFrame (the GPU
  host has no pandas), and scikit-learn, matplotlib and graphviz only when
  an estimator or a plotting helper is named;
- the native parser builds into ``lightgbm_tpu_torch/_build/``.
"""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt

# one intra-op thread: the suite runs in worker processes that share the cores
torch.set_num_threads(1)

PKG = Path(lt.__file__).resolve().parent
REPO = PKG.parent


def test_training_imports_no_jax_in_a_fresh_interpreter():
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import lightgbm_tpu_torch as lgb
        rng = np.random.RandomState(0)
        X = rng.randn(300, 4)
        y = X[:, 0] + 0.1 * rng.randn(300)
        b = lgb.train({"objective": "regression", "device_type": "cpu",
                       "verbosity": -1}, lgb.Dataset(X, label=y), 1)
        assert b.num_trees() == 1
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "lightgbm_tpu" or m.startswith("lightgbm_tpu."))
        print("BAD", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_module_imports_jax_or_the_jax_package(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "lightgbm_tpu"), (path, name)


def test_isolation_covers_the_distributed_modules():
    """The import rule's cases include the collective layer, the
    distributed learners, the supervision layer and the ops layer."""
    names = {str(p.relative_to(PKG)) for p in PKG.rglob("*.py")}
    assert {"network.py", "distributed.py", "parallel/learners.py",
            "parallel/data_parallel.py", "supervisor.py", "checkpoint.py",
            "utils/faults.py", "utils/profiling.py", "serving.py",
            "telemetry.py", "postmortem.py",
            "scripts/postmortem.py"} <= names


def test_supervisor_imports_no_jax_in_a_fresh_interpreter():
    """The supervision layer (supervisor, watchdog, heartbeats, sharded
    checkpoints, the integrity vote) loads without JAX."""
    code = textwrap.dedent("""
        import sys
        import lightgbm_tpu_torch as lgb
        from lightgbm_tpu_torch import checkpoint, distributed, supervisor
        from lightgbm_tpu_torch.utils import faults, profiling
        assert lgb.supervisor is supervisor
        assert distributed.WATCHDOG_EXIT_CODE == 97
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "lightgbm_tpu" or m.startswith("lightgbm_tpu."))
        print("BAD", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.random.RandomState(1).randn(100, 3)
    with pytest.raises(RuntimeError, match="CUDA device"):
        lt.train({"objective": "binary", "verbosity": -1},
                 lt.Dataset(X, label=(X[:, 0] > 0).astype(float)), 1)
    with pytest.raises(RuntimeError, match="CUDA device"):
        lt.Config.from_params({}).torch_device()
    # a custom objective does not take the run to the CPU either
    with pytest.raises(RuntimeError, match="CUDA device"):
        lt.train({"verbosity": -1},
                 lt.Dataset(X, label=(X[:, 0] > 0).astype(float)), 1,
                 fobj=lambda score, ds: (score, np.ones_like(score)))


@pytest.mark.parametrize("key,value", [
    ("histogram_method", "onehot_q8"),
    ("histogram_method", "scatter"),
    ("construct_chunk_rows", 4096),
    ("construct_streaming", True),
    ("num_gpu", 2),
    ("sketch_max_size", 256),
    ("predict_sharded", True),
    ("boost_rounds_per_dispatch", 4),
    ("mesh_shape", {"data": 8}),
    ("hist_pallas_interpret", True),
])
def test_unported_parameter_raises(key, value):
    with pytest.raises(NotImplementedError, match=key):
        lt.Config.from_params({key: value, "device_type": "cpu"})


@pytest.mark.parametrize("key,value,item", [
    ("predict_sharded", True, "Queue 1 item 15"),
    ("construct_chunk_rows", 4096, "Queue 1 item 15"),
])
def test_unported_parameter_names_its_item(key, value, item):
    with pytest.raises(NotImplementedError, match=item):
        lt.Config.from_params({key: value, "device_type": "cpu"})


@pytest.mark.parametrize("key,value", [
    ("serve_max_batch_rows", 512),
    ("serve_flush_ms", 5.0),
    ("telemetry_ring_size", 64),
    ("telemetry_dir", "telemetry"),
    ("fault_slow_predict_ms", 50.0),
    ("serve_deadline_ms", 50.0),
    ("serve_max_batch_rows", 1024),
], ids=["serve_max_batch_rows", "serve_flush_ms", "telemetry_ring_size",
        "telemetry_dir", "fault_slow_predict_ms", "serve_deadline_ms",
        "serve_max_batch_rows_named_item"])
def test_ops_layer_parameters_are_accepted(key, value):
    """The ops layer's parameters (the serving front end, the flight
    recorder, the slow-predict fault), which raised naming Queue 1 item
    16 until the layer was ported, configure the port."""
    cfg = lt.Config.from_params({key: value, "device_type": "cpu"})
    assert getattr(cfg, key) == value != getattr(lt.Config(), key)


@pytest.mark.parametrize("key,value", [
    ("first_metric_only", True),
    ("refit_decay_rate", 0.5),
    ("early_stopping_round", 5),
    ("objective", "none"),
    ("objective", "custom"),
])
def test_training_control_parameters_are_accepted(key, value):
    """Training control's parameters configure the port (the JAX
    package's train reads early_stopping_round and refit_decay_rate
    nowhere, and neither does the port's)."""
    cfg = lt.Config.from_params({key: value, "device_type": "cpu"})
    assert getattr(cfg, key) != getattr(lt.Config(), key)


def test_gain_adjust_raises_naming_item_9():
    """CEGB's per-(leaf, feature) gain adjustment, which the classic search
    refused naming Queue 1 item 9, is ported with that item: it no longer
    raises, and it comes off the keyed gains (a cost above every gain
    leaves no split)."""
    from lightgbm_tpu_torch.ops import split
    meta = split.feature_meta_from_mappers([])
    params = split.SplitParams.from_config(
        lt.Config.from_params({"device_type": "cpu", "min_data_in_leaf": 1,
                               "min_sum_hessian_in_leaf": 0.0}))
    hist = torch.zeros((1, 1, 2, 3))
    hist[0, 0, 0] = torch.tensor([-5.0, 1.0, 1.0])
    hist[0, 0, 1] = torch.tensor([5.0, 1.0, 1.0])
    g, h, c, o = (torch.tensor([v]) for v in (0.0, 2.0, 2.0, 0.0))
    args = (hist, g, h, c, o, torch.zeros((1,), dtype=torch.int32), meta,
            params, torch.ones((1,), dtype=torch.bool))
    free = split.find_best_splits(*args, gain_adjust=torch.zeros((1, 1)))
    assert torch.isfinite(free.gain).all()
    blocked = split.find_best_splits(
        *args, gain_adjust=free.gain[:, None] + 1.0)
    assert not bool((blocked.gain > 0).any())


@pytest.mark.parametrize("key,value", [
    ("forcedsplits_filename", "forced.json"),
    ("forcedbins_filename", "bins.json"),
    ("max_bin_by_feature", "15,31"),
    ("cegb_tradeoff", 0.5),
    ("cegb_penalty_split", 0.5),
    ("cegb_penalty_feature_lazy", "1,0,2"),
    ("cegb_penalty_feature_coupled", "1,0,2"),
    ("force_col_wise", True),
    ("force_row_wise", True),
])
def test_data_layer_parameters_are_accepted(key, value):
    """The data layer's parameters configure the port."""
    cfg = lt.Config.from_params({key: value, "device_type": "cpu"})
    assert getattr(cfg, key) != getattr(lt.Config(), key)


@pytest.mark.parametrize("key,value", [
    ("gpu_use_dp", True),
    ("linear_tree", True),
    ("linear_lambda", 0.1),
])
def test_precision_parameters_are_accepted(key, value):
    """The precision modes' parameters configure the port."""
    cfg = lt.Config.from_params({key: value, "device_type": "cpu"})
    assert getattr(cfg, key) != getattr(lt.Config(), key)


def test_pandas_is_imported_only_for_a_dataframe():
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import scipy.sparse as sp
        import lightgbm_tpu_torch as lgb
        rng = np.random.RandomState(0)
        X = rng.randn(300, 4)
        y = X[:, 0] + 0.1 * rng.randn(300)
        p = {"objective": "regression", "device_type": "cpu",
             "verbosity": -1}
        for data in (X, sp.csr_matrix(X)):
            b = lgb.train(p, lgb.Dataset(data, label=y), 1)
            b.predict(data)
        print("PANDAS", "pandas" in sys.modules)
        sys.exit(1 if "pandas" in sys.modules else 0)
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_group_column_raises_naming_item_12():
    """Query groups from a column of a data file came with the
    file-loading API (ROADMAP Queue 1 item 12b): ``group_column`` no
    longer raises, and the CLI's loader turns the column's runs of query
    ids into group sizes."""
    cfg = lt.Config.from_params({"group_column": "1", "device_type": "cpu"})
    assert cfg.group_column == "1"
    from lightgbm_tpu_torch.cli import _qid_to_group
    np.testing.assert_array_equal(_qid_to_group(np.array([4, 4, 1, 4])),
                                  [2, 1, 1])


@pytest.mark.parametrize("key,value", [
    ("task", "predict"), ("data", "train.csv"), ("valid", "a.csv,b.csv"),
    ("header", True), ("label_column", "name:y"), ("weight_column", "2"),
    ("ignore_column", "3,4"), ("two_round", True), ("save_binary", True),
    ("precise_float_parser", True), ("start_iteration_predict", 2),
    ("num_iteration_predict", 5), ("predict_raw_score", True),
    ("predict_leaf_index", True), ("predict_contrib", True),
    ("predict_disable_shape_check", True), ("pred_early_stop", True),
    ("pred_early_stop_freq", 20), ("pred_early_stop_margin", 1.5),
    ("output_result", "out.txt"), ("convert_model_language", "cpp"),
    ("convert_model", "m.cpp"), ("input_model", "model.txt"),
    ("output_model", "m.txt"), ("predict_chunk_rows", 100),
    ("predict_accum", "compensated"), ("predict_bucket_min_rows", 64),
])
def test_prediction_parameters_are_accepted(key, value):
    """Prediction's, the data files' and the CLI's parameters configure
    the port (ROADMAP Queue 1 item 12b)."""
    cfg = lt.Config.from_params({key: value, "device_type": "cpu"})
    assert getattr(cfg, key) != getattr(lt.Config(), key)


def test_import_loads_no_sklearn_matplotlib_or_graphviz():
    """The estimators and plotting helpers are exported lazily: importing
    the package, training and predicting load none of scikit-learn,
    matplotlib or graphviz; naming an estimator loads scikit-learn."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import lightgbm_tpu_torch as lgb
        X = np.random.RandomState(0).randn(200, 3)
        b = lgb.train({"objective": "regression", "device_type": "cpu",
                       "verbosity": -1}, lgb.Dataset(X, label=X[:, 0]), 1)
        b.predict(X, pred_leaf=True)
        loaded = [m for m in ("sklearn", "matplotlib", "graphviz")
                  if m in sys.modules]
        print("LOADED", loaded)
        assert not loaded, loaded
        assert lgb.LGBMRegressor.__module__ == "lightgbm_tpu_torch.sklearn"
        assert callable(lgb.plot_importance)
        assert "matplotlib" not in sys.modules
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_native_loader_builds_into_the_package_build_dir():
    """The native text parser is built with g++ on first use into
    ``lightgbm_tpu_torch/_build/`` (which .gitignore lists), not next to
    its source."""
    from lightgbm_tpu_torch import native
    lib = native.load()
    path = native.lib_path()
    assert path.parent == PKG / "_build" and path.exists()
    assert lib is native.load()
    ignored = (REPO / ".gitignore").read_text().splitlines()
    assert "lightgbm_tpu_torch/_build/" in ignored
    assert not list((PKG / "native").glob("*.so"))


def test_sparse_input_raises():
    class Sparse:
        shape = (4, 2)

        def toarray(self):
            return np.zeros(self.shape)

    with pytest.raises(NotImplementedError, match="sparse"):
        lt.Dataset(Sparse(), label=np.zeros(4),
                   params={"device_type": "cpu"}).construct()


def test_model_text_leaves_out_the_device():
    X = np.random.RandomState(2).randn(200, 3)
    b = lt.train({"objective": "regression", "device_type": "cpu",
                  "verbosity": -1}, lt.Dataset(X, label=X[:, 0]), 2)
    text = b.model_to_string()
    assert "device_type" not in text and "[verbosity: -1]" in text
