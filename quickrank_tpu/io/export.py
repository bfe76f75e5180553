"""AOT scorer export — the analog of the C code generators.

The reference ships rankers to production by generating C source from a
model and compiling it into the serving binary (src/io/generate_conditional_
operators.cc, generate_oblivious.cc, generate_vpred.cc; SURVEY §2.2).  The
equivalent here is an ahead-of-time compiled artifact: the batched
scorer — model constants embedded — serialized with ``jax.export`` as a
portable StableHLO module.  A serving process deserializes and calls it
with only jax installed: no quickrank_tpu, no XML model, no retracing.

The exported computation is the pure-XLA QuickScorer bitvector scan
(trees/qs.py::score_qs — Kahan-compensated across trees like the
reference's double accumulator, ensemble.cc:111-118; exact for any tree
shape and depth-independent) or the linear dot product; the Pallas fast
paths are runtime specializations and deliberately NOT exported
(StableHLO portability over device-specific Mosaic payloads).  The batch
dimension is symbolic by default so one artifact serves any batch size.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

GENERATOR_NAME = "stablehlo"


def _is_linear(model) -> bool:
    """Linear rankers (CA/LS) score by dot product; tree models also expose
    get_weights (per-TREE weights, ensemble.cc:67-75) so dispatch on the
    linear base class, not on the method."""
    from quickrank_tpu.learning.linear import _LinearRanker

    return isinstance(model, _LinearRanker)


def _is_rankboost(model) -> bool:
    from quickrank_tpu.learning.rankboost import RankBoost

    return isinstance(model, RankBoost)


def _unwrap(model):
    """MetaCleaver delegates scoring to its inner ranker — export that."""
    from quickrank_tpu.learning.meta import MetaCleaver

    return model.ltr_algo if isinstance(model, MetaCleaver) else model


def _model_num_features(model) -> int:
    """Smallest feature-vector width the model can score (max used global
    feature id + 1)."""
    if _is_linear(model):
        w = np.asarray(model.get_weights())
        return int(w.shape[0])
    if _is_rankboost(model):
        if model.features_ is None:
            raise RuntimeError("RANKBOOST: no trained model to export")
        return int(np.asarray(model.features_).max()) + 1
    ens = model._require_model()
    feat = np.asarray(ens.feature)[: int(ens.num_trees)]
    leaf = np.asarray(ens.is_leaf)[: int(ens.num_trees)]
    used = feat[~leaf]
    return int(used.max()) + 1 if used.size else 1


def _scorer_fn(model) -> Callable:
    """Jittable ``X [N, F] f32 -> scores [N] f32`` with model constants
    closed over (embedded as StableHLO constants at export time)."""
    import jax
    import jax.numpy as jnp

    if _is_linear(model):
        w = jnp.asarray(np.asarray(model.get_weights(), np.float32))

        # full f32 precision: a default f32 product may run in TF32 on
        # the GPU, and the artifact must score like the model
        def linear(X):
            return jnp.matmul(X, w, precision=jax.lax.Precision.HIGHEST)

        return linear

    if _is_rankboost(model):
        fid = jnp.asarray(np.asarray(model.features_, np.int32))
        theta = jnp.asarray(np.asarray(model.thetas_, np.float32))
        aw = jnp.asarray(
            np.asarray(model.alphas_ * model.signs_, np.float32)
        )

        def rankboost(X):
            bits = (X[:, fid] > theta[None, :]).astype(jnp.float32)
            return jnp.matmul(bits, aw, precision=jax.lax.Precision.HIGHEST)

        return rankboost

    from quickrank_tpu.trees.qs import ensemble_to_qs, score_qs

    ens = model._require_model()
    # QS bitvector form: depth-independent (the descent scan pays one
    # pass per tree level), bitwise the compensated descent
    # (tests/test_qs.py)
    qs = ensemble_to_qs(ens)

    def trees(X):
        return score_qs(X, qs)

    return trees


def export_scorer(
    model,
    path: Optional[str] = None,
    num_features: Optional[int] = None,
    batch: Optional[int] = None,
    platforms: Optional[Sequence[str]] = ("cpu", "cuda"),
) -> bytes:
    """Serialize the model's batched scorer as a StableHLO artifact.

    num_features: feature-matrix width baked into the artifact (defaults
        to the model's max used feature id + 1 — score calls must pass
        exactly this width; slice wider datasets).
    batch: fix the leading dim; None exports a symbolic batch dimension.
    platforms: lowering targets; None = the current default platform only.
    Returns the serialized bytes (also written to ``path`` if given).
    """
    import jax
    import jax.numpy as jnp
    from jax import export as jexport

    model = _unwrap(model)
    F_min = _model_num_features(model)  # also raises on untrained models
    fn = _scorer_fn(model)
    F = int(num_features) if num_features else F_min
    if F < F_min:
        # under jit, out-of-bounds feature gathers would CLAMP, not raise —
        # the artifact would return plausible wrong scores; fail loudly now
        raise ValueError(
            f"num_features={F} is narrower than the model's max used "
            f"feature id ({F_min - 1}); scores would be silently wrong"
        )
    if batch is None:
        b = jexport.symbolic_shape("b")[0]
    else:
        b = int(batch)
    spec = jax.ShapeDtypeStruct((b, F), jnp.float32)
    kw = {"platforms": tuple(platforms)} if platforms else {}
    exp = jexport.export(jax.jit(fn), **kw)(spec)
    blob = exp.serialize()
    if path:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def load_scorer(src) -> Callable[[np.ndarray], np.ndarray]:
    """Load an exported scorer (path or bytes) into an ``X -> scores``
    callable.  Needs only jax — the model constants live in the artifact."""
    from jax import export as jexport

    if isinstance(src, (bytes, bytearray)):
        blob = bytes(src)
    else:
        with open(src, "rb") as f:
            blob = f.read()
    exp = jexport.deserialize(blob)

    def call(X: np.ndarray) -> np.ndarray:
        return np.asarray(exp.call(np.asarray(X, np.float32)))

    return call
