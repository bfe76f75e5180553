"""quickrank_tpu — a learning-to-rank framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of hpclab/quickrank
(gradient-boosted tree rankers, linear rankers, IR metrics, ensemble
post-optimization, model codegen), built for SPMD execution over device
meshes; its accelerator is an NVIDIA H100.  See README.md / PARITY.md /
PERF.md.

Quick start::

    from quickrank_tpu import LambdaMart, Ndcg, read_svml
    model = LambdaMart(ntrees=1000, nleaves=16)
    model.learn(read_svml("train.svml"), read_svml("vali.svml"), Ndcg(10))
    model.save("model.xml")
"""

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy re-exports: importing the package must stay side-effect free
    # (no jax backend initialization at import time).
    from importlib import import_module

    _exports = {
        "Dataset": "quickrank_tpu.data.dataset",
        "read_svml": "quickrank_tpu.data.svml",
        "write_svml": "quickrank_tpu.data.svml",
        "shard_and_pad": "quickrank_tpu.data.dataset",
        "metric_factory": "quickrank_tpu.metrics.metrics",
        "Dcg": "quickrank_tpu.metrics.metrics",
        "Ndcg": "quickrank_tpu.metrics.metrics",
        "Tndcg": "quickrank_tpu.metrics.metrics",
        "Map": "quickrank_tpu.metrics.metrics",
        "Rmse": "quickrank_tpu.metrics.metrics",
        "Mart": "quickrank_tpu.learning.mart",
        "LambdaMart": "quickrank_tpu.learning.lambdamart",
        "ObliviousMart": "quickrank_tpu.learning.obliviousmart",
        "ObliviousLambdaMart": "quickrank_tpu.learning.obliviousmart",
        "Dart": "quickrank_tpu.learning.dart",
        "RankBoost": "quickrank_tpu.learning.rankboost",
        "RandomForest": "quickrank_tpu.learning.randomforest",
        "LambdaMartSelective": "quickrank_tpu.learning.selective",
        "StochasticNegative": "quickrank_tpu.learning.stochasticnegative",
        "CoordinateAscent": "quickrank_tpu.learning.linear",
        "LineSearch": "quickrank_tpu.learning.linear",
        "CustomLTR": "quickrank_tpu.learning.custom",
        "MetaCleaver": "quickrank_tpu.learning.meta",
        "LTRAlgorithm": "quickrank_tpu.learning.base",
        "ltr_algorithm_factory": "quickrank_tpu.learning.factory",
        "Cleaver": "quickrank_tpu.optimization.cleaver",
        "optimization_factory": "quickrank_tpu.optimization.factory",
        "make_mesh": "quickrank_tpu.parallel.mesh",
        "make_mesh_2d": "quickrank_tpu.parallel.mesh",
    }
    if name in _exports:
        return getattr(import_module(_exports[name]), name)
    raise AttributeError(f"module 'quickrank_tpu' has no attribute {name!r}")
