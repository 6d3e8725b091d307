"""Distributed training end to end: ``lt.train({"tree_learner": ...})`` in a
gang of 8 processes of the PyTorch port against ``lightgbm_tpu.train`` with
the same learner, which shards over the 8 virtual CPU devices of the test
process.

One gang (``lightgbm_tpu_torch.distributed.spawn``, 8 ranks on the CPU,
each holding all rows: the replicated flow) trains every case of
``torch_gang_cases``: the data learner on binary and regression, on a
categorical feature and on scipy-sparse input with EFB bundles, and the
feature and voting learners; each rank pads and slices the rows and
features as the JAX learner's mesh does. ``model_to_string()`` is the
JAX package's byte for byte.
"""

import os
import sys

import pytest

import lightgbm_tpu as lj
from lightgbm_tpu_torch import distributed

sys.path.insert(0, os.path.dirname(__file__))
import torch_gang_cases as gc  # noqa: E402

NAMES = sorted(gc.CASES)


@pytest.fixture(scope="module")
def gang_texts():
    return distributed.spawn(gc.train_cases, nproc=8, args=(NAMES,),
                             device_type="cpu", timeout=600)


@pytest.mark.parametrize("name", NAMES)
def test_model_text_matches_jax_at_8_ranks(gang_texts, name):
    X, y, params, kw = gc.case(name)
    ref = lj.train(dict(params), lj.Dataset(X, label=y, params=dict(params),
                                            **kw), gc.ROUNDS)
    text = ref.model_to_string()
    assert f"[tree_learner: {params['tree_learner']}]" in text
    assert gang_texts[name] == text
