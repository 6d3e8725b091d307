"""The JAX package's data learner on a mesh of a chosen number of devices.

The port's gang of W ranks trains, bit for bit, the model of
``lightgbm_tpu.train`` with the same ``tree_learner`` on a W-device mesh
(replicated rows; a pre-partitioned gang the same model). The JAX package
builds its mesh over every visible device (``make_mesh``), so the test
process's 8 virtual devices give W = 8; this helper patches the learner's
``make_mesh`` for the duration of one run. The reference run's own
supervision (``start_health``) is left unarmed, so a deadline in the
params cannot judge its compiles. Imported by test modules only.
"""

import lightgbm_tpu as lj
from lightgbm_tpu import distributed as jd


def jax_on_mesh(world, params, X, y, rounds, callbacks=None,
                resume_from=None):
    """The model text of ``lightgbm_tpu.train(params, Dataset(X, y),
    rounds)`` with the learner on ``world`` devices."""
    import lightgbm_tpu.parallel.learners as learners
    from lightgbm_tpu.parallel import data_parallel
    orig = learners.make_mesh, jd.start_health
    learners.make_mesh = lambda num_devices=None, axis="data": \
        data_parallel.make_mesh(world, axis=axis)
    jd.start_health = lambda *a, **k: jd._Health(None, None)
    try:
        ds = lj.Dataset(X, label=y, params=dict(params), free_raw_data=False)
        return lj.train(dict(params), ds, rounds, callbacks=callbacks or [],
                        resume_from=resume_from).model_to_string()
    finally:
        learners.make_mesh, jd.start_health = orig
