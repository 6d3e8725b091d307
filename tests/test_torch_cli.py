"""The port's CLI, native parser, data files, refit, save_binary and
convert_model against the JAX package's, on the CPU.

Data files are written from numpy rows made from a seed (TSV, CSV with a
header, LibSVM). The port's C++ parser (built with g++ into
``lightgbm_tpu_torch/_build/``) is bitwise its plain numpy version on each;
``python -m lightgbm_tpu_torch``'s tasks (``device_type=cpu``) write the
JAX CLI's model texts for train (label, weight, ignore and group columns,
``.weight`` / ``.query`` side files, valid files, ``two_round`` with
small chunks), refit and save_binary round trips; ``task=predict`` writes
``Booster.predict``'s values; ``task=convert_model`` writes the JAX
package's C++ byte for byte, which compiles with g++ and predicts what
the Booster does.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu.cli import main as jmain
from lightgbm_tpu_torch import cli as tcli
from lightgbm_tpu_torch import native

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rows(n=1500, f=6, seed=0):
    rng = np.random.RandomState(seed)
    X = np.round(rng.randn(n, f), 6)
    X[rng.rand(n) < 0.05, 1] = np.nan
    y = (X[:, 0] + 0.5 * np.nan_to_num(X[:, 1]) - X[:, 2] > 0).astype(float)
    return X, y


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    X, y = _rows()
    tsv = np.column_stack([y, X])
    np.savetxt(d / "train.tsv", tsv[:1200], delimiter="\t", fmt="%.6g")
    np.savetxt(d / "test.tsv", tsv[1200:], delimiter="\t", fmt="%.6g")
    rng = np.random.RandomState(1)
    w = rng.rand(1500) + 0.5
    qid = np.repeat(np.arange(150), 10)
    with open(d / "train.csv", "w") as fh:
        fh.write("a,b,w,label,c,d,e,f,q\n")
        for i in range(1200):
            xs = ["" if np.isnan(v) else f"{v:.6g}" for v in X[i]]
            fh.write(",".join([xs[0], xs[1], f"{w[i]:.4f}", f"{y[i]:g}",
                               xs[2], xs[3], xs[4], xs[5],
                               str(qid[i])]) + "\n")
    np.savetxt(d / "train.tsv.weight", w[:1200], fmt="%.4f")
    with open(d / "train.svm", "w") as fh:
        for i in range(300):
            nz = [f"{j + 1}:{X[i, j]:.6g}" for j in range(6)
                  if not np.isnan(X[i, j]) and abs(X[i, j]) > 0.5]
            fh.write(" ".join([f"{y[i]:g}"] + nz) + "\n")
    orig = os.getcwd()
    os.chdir(d)
    yield d
    os.chdir(orig)


_OUTPUTS = ("output_model", "output_result", "convert_model")


def _both(args):
    """Run the JAX CLI and the port's on the same arguments (the output
    files' names are model parameters, so both write the same names);
    each output ``f`` is kept as ``j_f`` and ``t_f``."""
    outs = [a.split("=", 1)[1] for a in args
            if a.split("=", 1)[0] in _OUTPUTS]
    for run, pre in ((jmain, "j_"), (lambda a: tcli.main(
            a + ["device_type=cpu"]), "t_")):
        run(list(args))
        for f in outs:
            os.replace(f, pre + f)


def _text(path):
    return open(path).read()


def test_native_parser_is_the_plain_parser(files):
    for name, header in (("train.tsv", False), ("train.csv", True),
                         ("train.svm", False)):
        mat, fmt = native.parse_text_file(name, has_header=header)
        ref, rfmt = native._parse_text_file_py(name, header)
        assert fmt == rfmt
        if fmt == "libsvm":
            mat = mat[:, :ref.shape[1]]
        np.testing.assert_array_equal(mat, ref)
    data = open("train.tsv", "rb").read()
    cut = data.find(b"\n", len(data) // 2) + 1
    mat, _ = native.parse_buffer(data[:cut])
    np.testing.assert_array_equal(mat, native._parse_buffer_py(data[:cut],
                                                               False)[0])


def test_native_parser_csv_missing(tmp_path):
    p = tmp_path / "t.csv"
    p.write_text("a,b,c\n1,2.5,3\n4,,6\n7,8,na\n")
    mat, fmt = native.parse_text_file(str(p), has_header=True)
    assert fmt == "csv" and mat.shape == (3, 3)
    assert np.isnan(mat[1, 1]) and np.isnan(mat[2, 2])


def test_train_predict_consistency(files):
    """task=train gives the JAX CLI's model text and ``lt.train``'s on the
    parsed arrays; task=predict writes ``Booster.predict``'s values (and
    the JAX CLI's file)."""
    common = ["task=train", "objective=binary", "data=train.tsv",
              "valid=test.tsv", "metric=auc", "num_trees=6",
              "num_leaves=15", "output_model=model.txt", "verbosity=-1"]
    os.rename("train.tsv.weight", "hold.weight")
    try:
        _both(common)
    finally:
        os.rename("hold.weight", "train.tsv.weight")
    assert _text("t_model.txt") == _text("j_model.txt")
    tr = np.loadtxt("train.tsv")
    params = dict(a.split("=", 1) for a in common)
    params["device_type"] = "cpu"
    b = lt.train(params, lt.Dataset(tr[:, 1:], label=tr[:, 0],
                                    params=dict(params)), 6)
    assert b.model_to_string() == _text("t_model.txt")
    for extra in ([], ["predict_raw_score=true"],
                  ["predict_leaf_index=true"], ["predict_contrib=true"],
                  ["num_iteration_predict=3", "start_iteration_predict=1",
                   "predict_raw_score=true"]):
        jmain(["task=predict", "data=test.tsv", "input_model=j_model.txt",
               "output_result=j_preds.txt", "verbosity=-1"] + extra)
        tcli.main(["task=predict", "data=test.tsv",
                   "input_model=t_model.txt", "output_result=t_preds.txt",
                   "verbosity=-1", "device_type=cpu"] + extra)
        assert _text("t_preds.txt") == _text("j_preds.txt"), extra
    te = np.loadtxt("test.tsv")
    tcli.main(["task=predict", "data=test.tsv", "input_model=t_model.txt",
               "output_result=t_p.txt", "verbosity=-1", "device_type=cpu"])
    want = b.predict(te[:, 1:])
    np.testing.assert_array_equal(
        np.loadtxt("t_p.txt"),
        np.array([float(f"{v:.10g}") for v in want]))


def test_columns_and_side_files(files):
    """header, label/weight/ignore columns by name and index, and the
    ``.weight`` side file: the JAX CLI's model texts."""
    _both(["task=train", "objective=binary", "data=train.csv", "header=true",
           "label_column=name:label", "weight_column=2", "ignore_column=8",
           "num_trees=3", "num_leaves=7", "output_model=mcsv.txt",
           "verbosity=-1"])
    assert _text("t_mcsv.txt") == _text("j_mcsv.txt")
    _both(["task=train", "objective=binary", "data=train.tsv",
           "num_trees=3", "num_leaves=7", "output_model=mw.txt",
           "verbosity=-1"])
    assert _text("t_mw.txt") == _text("j_mw.txt")
    X, y, w, g, i = tcli.load_data_file(
        "train.tsv", lt.Config.from_params({"device_type": "cpu"}))
    assert w is not None and len(w) == len(y) and g is None


def test_group_column_lambdarank(files):
    _both(["task=train", "objective=lambdarank", "data=train.csv",
           "header=true", "label_column=3", "weight_column=2",
           "group_column=name:q", "num_trees=2", "num_leaves=7",
           "output_model=mrank.txt", "verbosity=-1"])
    assert _text("t_mrank.txt") == _text("j_mrank.txt")


def test_save_binary_round_trip(files):
    tcli.main(["task=save_binary", "data=train.tsv", "verbosity=-1",
               "device_type=cpu"])
    jmain(["task=save_binary", "data=train.tsv", "verbosity=-1"])
    got = tcli._load_binary("train.tsv.bin")
    txt = tcli.load_data_file("train.tsv",
                              lt.Config.from_params({"device_type": "cpu"}))
    for a, b in zip(got, txt):
        np.testing.assert_array_equal(a, b)
    _both(["task=train", "objective=binary", "data=train.tsv.bin",
           "num_trees=3", "output_model=mbin.txt", "verbosity=-1"])
    assert _text("t_mbin.txt") == _text("j_mbin.txt")
    X, y = _rows(200)
    path = "ds.bin"
    lt.Dataset(X, label=y, free_raw_data=False,
               params={"device_type": "cpu"}).save_binary(path)
    Xb, yb, _, _, _ = tcli._load_binary(path)
    np.testing.assert_array_equal(Xb, X)
    np.testing.assert_array_equal(yb, y)


def test_two_round_matches_in_memory(files, monkeypatch):
    """two_round streams the train and valid files in chunks (tiny here):
    the model text of in-memory loading, and the JAX CLI's."""
    orig = tcli._iter_parsed_chunks
    monkeypatch.setattr(tcli, "_iter_parsed_chunks",
                        lambda path, config, chunk_bytes=64 << 20:
                        orig(path, config, chunk_bytes=4096))
    os.rename("train.tsv.weight", "hold.weight")
    try:
        common = ["task=train", "data=train.tsv", "valid=test.tsv",
                  "objective=binary", "metric=auc", "num_leaves=15",
                  "num_iterations=4", "verbosity=-1",
                  "bin_construct_sample_cnt=100000"]
        tcli.main(common + ["output_model=2r.txt", "device_type=cpu"])
        os.replace("2r.txt", "mem_2r.txt")
        _both(common + ["two_round=true", "output_model=2r.txt"])
    finally:
        os.rename("hold.weight", "train.tsv.weight")
    # the same trees; only the parameters block names two_round
    mem, two = _text("mem_2r.txt"), _text("t_2r.txt")
    assert two.split("parameters:")[0] == mem.split("parameters:")[0]
    assert two == _text("j_2r.txt")


def test_refit_task(files):
    _both(["task=train", "objective=binary", "data=train.tsv",
           "num_trees=4", "num_leaves=7", "output_model=mr.txt",
           "verbosity=-1"])
    for run, pre in ((jmain, "j_"), (lambda a: tcli.main(
            a + ["device_type=cpu"]), "t_")):
        run(["task=refit", "data=test.tsv", f"input_model={pre}mr.txt",
             "output_model=refit.txt", "verbosity=-1"])
        os.replace("refit.txt", pre + "refit.txt")
    assert _text("t_refit.txt") == _text("j_refit.txt")


def test_convert_model_compiles_and_matches(files, tmp_path):
    _both(["task=train", "objective=binary", "data=train.tsv",
           "num_trees=5", "num_leaves=7", "output_model=m5.txt",
           "verbosity=-1"])
    for run, pre in ((jmain, "j_"), (lambda a: tcli.main(
            a + ["device_type=cpu"]), "t_")):
        run(["task=convert_model", f"input_model={pre}m5.txt",
             "convert_model=m5.cpp", "verbosity=-1"])
        os.replace("m5.cpp", pre + "m5.cpp")
    code = _text("t_m5.cpp")
    assert code == _text("j_m5.cpp")
    assert "PredictTree0" in code and "double Predict(" in code
    from lightgbm_tpu_torch.io.codegen import model_to_if_else
    b = lt.Booster(model_file="t_m5.txt")
    assert model_to_if_else(b._boosting) == code
    harness = tmp_path / "main.cpp"
    harness.write_text(
        '#include <cstdio>\n#include "t_m5.cpp"\n'
        "int main(){double f[6];double l;FILE*fp=fopen(\"test.tsv\",\"r\");"
        "for(int r=0;r<40;++r){fscanf(fp,\"%lf\",&l);"
        "for(int i=0;i<6;++i)fscanf(fp,\"%lf\",&f[i]);"
        'printf("%.17g\\n",lightgbm_tpu_model::Predict(f));}return 0;}\n')
    exe = tmp_path / "m5run"
    proc = subprocess.run(["g++", "-O1", "-std=c++17", str(harness),
                           f"-I{files}", "-o", str(exe)],
                          capture_output=True, cwd=files)
    assert proc.returncode == 0, proc.stderr.decode()[:500]
    out = subprocess.run([str(exe)], capture_output=True, cwd=files)
    cpp = np.array([float(x) for x in out.stdout.split()])
    te = np.loadtxt("test.tsv")
    np.testing.assert_allclose(cpp, b.predict(te[:40, 1:]), rtol=1e-6,
                               atol=1e-7)


def test_python_m_entry_point_and_snapshot(files):
    """``python -m lightgbm_tpu_torch`` runs the CLI in a fresh
    interpreter; ``snapshot_freq`` writes checkpoints under
    ``<output_model>.ckpt``: a run killed at iteration 3 (exit 137) and
    the same command again end with the JAX CLI's uninterrupted text."""
    import shutil
    env = dict(os.environ, PYTHONPATH=REPO)
    args = ["task=train", "objective=binary", "data=train.tsv",
            "num_trees=2", "num_leaves=7", "output_model=pm.txt",
            "verbosity=-1"]
    res = subprocess.run(
        [sys.executable, "-m", "lightgbm_tpu_torch", *args,
         "device_type=cpu"], capture_output=True, text=True, env=env,
        cwd=files, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    os.replace("pm.txt", "m_pm.txt")
    _both(args)
    assert _text("m_pm.txt") == _text("t_pm.txt") == _text("j_pm.txt")
    snap = ["task=train", "objective=binary", "data=train.tsv",
            "num_trees=5", "num_leaves=7", "output_model=snap.txt",
            "verbosity=-1", "snapshot_freq=2", "bagging_fraction=0.7",
            "bagging_freq=3"]
    jmain(list(snap))
    os.replace("snap.txt", "j_snap.txt")
    shutil.rmtree("snap.txt.ckpt")
    res = subprocess.run(
        [sys.executable, "-m", "lightgbm_tpu_torch", *snap,
         "device_type=cpu"], capture_output=True, text=True,
        env=dict(env, LGBM_TPU_FAULT_KILL_AT_ITER="3"), cwd=files,
        timeout=300)
    assert res.returncode == 137, res.stderr[-2000:]
    assert not os.path.exists("snap.txt")
    assert sorted(os.listdir("snap.txt.ckpt")) == ["ckpt_00000002"]
    tcli.main(snap + ["device_type=cpu"])
    assert _text("snap.txt") == _text("j_snap.txt")
    assert sorted(os.listdir("snap.txt.ckpt")) == ["ckpt_00000002",
                                                   "ckpt_00000004"]


def test_qid_group_column_run_order():
    from lightgbm_tpu.cli import _qid_to_group as jq
    for ids in ([7, 7, 7, 1, 1], [2, 2, 9, 2], []):
        np.testing.assert_array_equal(tcli._qid_to_group(np.array(ids)),
                                      jq(np.array(ids)))
    np.testing.assert_array_equal(tcli._qid_to_group(np.array([2, 2, 9, 2])),
                                  [2, 1, 1])
