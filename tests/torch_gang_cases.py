"""Cases the distributed tests train in a gang of processes.

Imported by the test modules and, by reference through
``lightgbm_tpu_torch.distributed.spawn``, by every spawned rank: it
imports numpy, scipy and the port only (no JAX), so a rank starts fast.
Each case is (data, label, params); the test modules train the same case
through the JAX package in their own process.
"""

import numpy as np

ROUNDS = 3


def _dense(seed=0, n=600, f=8, regression=False):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[rng.rand(n) < 0.1, 2] = np.nan
    X[:, 3] = np.round(X[:, 3] * 2)
    if regression:
        y = 2.0 * X[:, 0] - X[:, 1] + 0.5 * rng.randn(n)
    else:
        y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.randn(n) > 0).astype(float)
    return X, y


def _categorical(seed=1, n=600):
    X, _ = _dense(seed, n)
    rng = np.random.RandomState(seed + 100)
    X[:, 5] = rng.randint(0, 12, n)
    y = ((X[:, 5] % 3 == 0) + 0.5 * X[:, 0] + 0.3 * rng.randn(n)
         > 0.5).astype(float)
    return X, y


def _onehotish(seed=2, n=600, f=24, dense=3):
    import scipy.sparse as sp
    rng = np.random.RandomState(seed)
    X = sp.random(n, f, density=0.06, random_state=rng, format="csr",
                  data_rvs=lambda k: rng.uniform(0.5, 2.0, k)).toarray()
    X = np.hstack([X, rng.randn(n, dense)])
    y = (X[:, :f].sum(1) + 0.3 * X[:, f] + 0.3 * rng.randn(n) > 0.4)
    return sp.csr_matrix(X), y.astype(np.float64)


BASE = {"num_leaves": 10, "min_data_in_leaf": 5, "verbosity": -1,
        "max_bin": 63}

CASES = {
    "data_binary": (lambda: _dense(), {"objective": "binary",
                                       "tree_learner": "data"}),
    "data_regression": (lambda: _dense(3, regression=True),
                        {"objective": "regression", "tree_learner": "data"}),
    "data_categorical": (lambda: _categorical(),
                         {"objective": "binary", "tree_learner": "data"}),
    "data_efb": (lambda: _onehotish(), {"objective": "binary",
                                        "tree_learner": "data"}),
    "feature_binary": (lambda: _dense(4), {"objective": "binary",
                                           "tree_learner": "feature"}),
    "voting_binary": (lambda: _dense(5), {"objective": "binary",
                                          "tree_learner": "voting",
                                          "top_k": 3}),
}


# the Dataset's keyword arguments of a case
DATASET_KW = {"data_categorical": {"categorical_feature": [5]}}


def case(name):
    """(X, y, params, Dataset keywords) of a case (params without
    ``device_type``)."""
    make, extra = CASES[name]
    X, y = make()
    return X, y, dict(BASE, **extra), dict(DATASET_KW.get(name, {}))


def train_cases(rank, names):
    """One rank's body: every case trained replicated over the gang (each
    rank holds all rows), on the CPU. Returns {case: model text}."""
    import torch
    import lightgbm_tpu_torch as lt
    torch.set_num_threads(1)        # the gang's ranks share the cores
    out = {}
    for name in names:
        X, y, params, kw = case(name)
        params = dict(params, device_type="cpu")
        ds = lt.Dataset(X, label=y, params=dict(params), **kw)
        out[name] = lt.train(params, ds, ROUNDS).model_to_string()
    return out


def partitioned(rank, names, ports):
    """One rank's body of the 2-rank gang: per case, the replicated run,
    the pre-partitioned run over this rank's contiguous half
    (``load_partitioned``) and its bin mappers; then the gang is left
    (``free_network``) and joined again through ``set_network`` on a
    machine list of two entries on this host, told apart by
    ``local_listen_port`` (``ports[:2]``), and the first case trained
    replicated once more; then the CLI (``task=train`` with the network
    keys ``num_machines``, ``machines``, ``local_listen_port`` on
    ``ports[2:]``) trains it from a data file."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import network
    torch.set_num_threads(1)
    out = {}
    for name in names:
        X, y, params, _ = case(name)
        params = dict(params, device_type="cpu", boost_from_average=False)
        rep = lt.train(params, lt.Dataset(X, label=y, params=dict(params)),
                       ROUNDS).model_to_string()
        w = network.current().world
        c = -(-X.shape[0] // w)
        ds = lt.distributed.load_partitioned(
            X[rank * c:(rank + 1) * c], label=y[rank * c:(rank + 1) * c],
            params=dict(params))
        mappers = [np.asarray(m.bin_upper_bound, np.float64).tobytes()
                   for m in ds.mappers]
        pre = lt.train(params, ds, ROUNDS).model_to_string()
        out[name] = {"replicated": rep, "prepart": pre, "mappers": mappers,
                     "ranks_mappers": network.current().allgather_object(
                         mappers),
                     "local_rows": ds.num_local_data,
                     "num_data": ds.num_data}
    X, y, params, _ = case(names[0])
    params = dict(params, device_type="cpu", boost_from_average=False)
    ds = lt.Dataset(X, label=y, params=dict(params, tree_learner="serial"))
    b = lt.Booster(dict(params, tree_learner="serial"), ds)
    b.free_network()
    alone = network.current().world
    b.set_network([f"127.0.0.1:{p}" for p in ports],
                  local_listen_port=ports[rank], num_machines=2)
    net = network.current()
    again = lt.train(params, lt.Dataset(X, label=y, params=dict(params)),
                     ROUNDS).model_to_string()
    out["set_network"] = {"alone": alone, "rank": net.rank,
                          "world": net.world, "text": again}
    # the CLI joins a gang of its own from its network keys
    b.free_network()
    import tempfile
    from lightgbm_tpu_torch import cli
    d = tempfile.mkdtemp()
    np.savetxt(f"{d}/train.tsv", np.column_stack([y, X]), delimiter="\t")
    cli.main(["task=train", f"data={d}/train.tsv",
              f"output_model={d}/model.txt", f"num_trees={ROUNDS}",
              "num_machines=2", "machines=" + ",".join(
                  f"127.0.0.1:{p}" for p in ports[2:]),
              f"local_listen_port={ports[2 + rank]}", "device_type=cpu",
              "boost_from_average=false"]
             + [f"{k}={v}" for k, v in case(names[0])[2].items()])
    with open(f"{d}/model.txt") as fh:
        out["cli"] = {"world": network.current().world, "text": fh.read()}
    return out
