"""Rules of the PyTorch port that later slices must keep:

- ``lightgbm_tpu_torch`` imports neither ``jax`` nor the JAX package
  ``lightgbm_tpu`` (it runs on a GPU host that has no JAX);
- with the default ``device_type`` ("cuda") and no CUDA device, training
  raises a RuntimeError naming the device; it never continues on the CPU;
- a parameter outside the ported slice raises NotImplementedError naming
  it, instead of being silently ignored.
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


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.random.RandomState(1).randn(100, 3)
    with pytest.raises(RuntimeError, match="CUDA device"):
        lt.train({"objective": "binary", "verbosity": -1},
                 lt.Dataset(X, label=(X[:, 0] > 0).astype(float)), 1)
    with pytest.raises(RuntimeError, match="CUDA device"):
        lt.Config.from_params({}).torch_device()


@pytest.mark.parametrize("key,value", [
    ("histogram_method", "onehot_q8"),
    ("histogram_method", "scatter"),
    ("cegb_tradeoff", 0.5),
    ("gpu_use_dp", True),
    ("forcedsplits_filename", "forced.json"),
    ("bagging_fraction", 0.5),
    ("boosting", "dart"),
    ("objective", "multiclass"),
    ("linear_tree", True),
    ("tree_learner", "data"),
    ("monotone_constraints", "1,0,0"),
    ("feature_fraction", 0.5),
    ("metric", "ndcg"),
    ("early_stopping_round", 5),
    ("hist_pallas_interpret", True),
])
def test_unported_parameter_raises(key, value):
    with pytest.raises(NotImplementedError, match=key):
        lt.Config.from_params({key: value, "device_type": "cpu"})


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
