"""Bodies of the supervised gangs the supervision tests run.

Imported by the test modules and, by reference through
``lightgbm_tpu_torch.supervisor.run_supervised``, by every spawned rank:
it imports numpy and the port only (no JAX), so a rank starts fast. Every
rank takes its contiguous block of the rows from the gang's rank and world
after the init (``network.current()``), so a gang that shrinks re-splits
the rows; it trains pre-partitioned (``distributed.load_partitioned``) with
sharded checkpoints every iteration and ``resume_from`` on the same
directory, and appends one line a completed iteration to
``<ckdir>.events.jsonl`` (incarnation, rank, world, iteration, wall time)
for the tests' timing checks.
"""

import json
import os

import numpy as np

N, F = 320, 6
ROUNDS = 4

PARAMS = {"objective": "binary", "num_leaves": 8, "min_data_in_leaf": 5,
          "boost_from_average": False, "verbosity": -1,
          "tree_learner": "data", "bagging_fraction": 0.7, "bagging_freq": 2,
          "bagging_seed": 5,
          # fast supervision knobs: a heartbeat every 0.4 s; a deadline
          # well above a healthy step on a loaded test machine
          "heartbeat_interval": 0.4, "collective_deadline": 4.0}


def data(n=N, f=F, seed=7):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f))
    y = (X[:, 0] - 0.5 * X[:, 2] > 0).astype(np.float64)
    return X, y


def rows_of(rank, world, n=N):
    """The contiguous block of rows rank ``rank`` of ``world`` holds."""
    c = -(-n // world)
    return rank * c, min((rank + 1) * c, n)


def _events(ckdir):
    import time
    from lightgbm_tpu_torch import network

    def cb(env):
        net = network.current()
        line = json.dumps({
            "incarnation": int(os.environ.get("LGBM_TPU_RESTART_COUNT",
                                              "0")),
            "rank": net.rank, "world": net.world,
            "iteration": env.iteration, "t": time.time()})
        with open(ckdir + ".events.jsonl", "a") as fh:
            fh.write(line + "\n")
    cb.order = 50
    return cb


def gang_train(rank, ckdir, extra=None, rounds=ROUNDS, prepart=True):
    """One rank: its rows pre-partitioned (or, ``prepart=False``, every
    row replicated), checkpointed every iteration, resumed from ``ckdir``.
    Returns the model text."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import network
    torch.set_num_threads(1)        # the gang's ranks share the cores
    params = dict(PARAMS, device_type="cpu", **(extra or {}))
    X, y = data()
    net = network.current()
    if prepart:
        lo, hi = rows_of(net.rank, net.world)
        ds = lt.distributed.load_partitioned(X[lo:hi], label=y[lo:hi],
                                             params=dict(params))
    else:
        ds = lt.Dataset(X, label=y, params=dict(params))
    booster = lt.train(dict(params), ds, rounds,
                       callbacks=[lt.checkpoint_callback(ckdir, period=1),
                                  _events(ckdir)],
                       resume_from=ckdir)
    return booster.model_to_string()


def events(ckdir):
    """The events the gang's ranks appended, in file order."""
    with open(ckdir + ".events.jsonl") as fh:
        return [json.loads(line) for line in fh]
