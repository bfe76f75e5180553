"""QuickScorer bitvector scoring (trees/qs.py): exactness vs descent.

QS is the scorer of non-oblivious models (Mart.score_dataset); these tests
pin it BITWISE to score_ensemble's compensated per-tree descent scan."""

import numpy as np
import jax.numpy as jnp
import pytest

from quickrank_tpu.ops.scoring import score_ensemble
from quickrank_tpu.trees.qs import ensemble_to_qs, score_qs
from quickrank_tpu.trees.random_ensemble import (
    random_balanced_ensemble,
    random_bestfirst_ensemble,
)


def _score_ref(X, ens, md):
    return np.asarray(
        score_ensemble(X, ens, max_depth=md, compensated=True)
    )


@pytest.mark.parametrize(
    "T,leaves,F",
    [(40, 16, 12), (7, 16, 12), (3, 4, 5), (1, 2, 3), (25, 16, 136),
     (6, 32, 20), (5, 64, 40)],
)
def test_qs_bitwise_matches_descent(T, leaves, F):
    """Random best-first-shaped (deep, asymmetric) ensembles, including
    tree counts that don't divide the kernel group size: bitwise equal
    to the Kahan-compensated descent scan."""
    ens = random_bestfirst_ensemble(T, leaves, F, seed=T + leaves)
    qs = ensemble_to_qs(ens)
    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.standard_normal((257, F), dtype=np.float32))
    np.testing.assert_array_equal(
        np.asarray(score_qs(X, qs)), _score_ref(X, ens, 2 * leaves)
    )


def test_qs_balanced_trees():
    ens = random_balanced_ensemble(20, 4, 9, seed=2)
    qs = ensemble_to_qs(ens)
    rng = np.random.default_rng(1)
    X = jnp.asarray(rng.standard_normal((300, 9), dtype=np.float32))
    np.testing.assert_array_equal(
        np.asarray(score_qs(X, qs)), _score_ref(X, ens, 5)
    )


def test_qs_trained_model_roundtrip(tmp_path):
    """A really-trained LambdaMART model (variable leaf counts from the
    minls veto, depth past the perfect-embedding bound) scores bitwise
    through QS tables, including after an XML save/load."""
    from quickrank_tpu.data.synthetic import make_ranking_dataset
    from quickrank_tpu.learning import LambdaMart
    from quickrank_tpu.learning.base import LTRAlgorithm
    from quickrank_tpu.metrics.metrics import Ndcg

    ds = make_ranking_dataset(num_queries=40, avg_docs_per_query=20, seed=0)
    lm = LambdaMart(
        ntrees=10, nleaves=8, shrinkage=0.2, nthresholds=63, esr=0, seed=3
    )
    lm.learn(ds, None, Ndcg(10), verbose=False)
    ens = lm.ensemble
    X = jnp.asarray(ds.features)
    ref = _score_ref(X, ens, lm._descend_depth())
    np.testing.assert_array_equal(
        np.asarray(score_qs(X, ensemble_to_qs(ens))), ref
    )

    fn = tmp_path / "m.xml"
    lm.save(str(fn))
    lm2 = LTRAlgorithm.load(str(fn))
    qs2 = ensemble_to_qs(lm2.ensemble)
    # XML text round-trips f32 exactly (%.9g), so still bitwise
    np.testing.assert_array_equal(np.asarray(score_qs(X, qs2)), ref)


def test_qs_dead_capacity_slots():
    """Ensembles with capacity > num_trees (mid-training snapshots):
    dead slots must contribute exactly like score_ensemble's zero-weight
    Kahan steps."""
    ens = random_bestfirst_ensemble(12, 8, 6, seed=9)
    # simulate a partially-filled buffer: pretend only 5 trees are live
    ens = ens.replace(num_trees=jnp.asarray(5, jnp.int32))
    qs = ensemble_to_qs(ens)
    rng = np.random.default_rng(3)
    X = jnp.asarray(rng.standard_normal((100, 6), dtype=np.float32))
    np.testing.assert_array_equal(
        np.asarray(score_qs(X, qs)), _score_ref(X, ens, 16)
    )


@pytest.mark.parametrize("T,leaves,F", [(40, 16, 12), (9, 8, 7), (3, 4, 5)])
def test_qs_matches_uncompensated_descent(T, leaves, F):
    """QS against the PLAIN (uncompensated) descent sum: routing and leaf
    picks are exact, so the two differ only by f32 summation error, far
    below one part in 10^6 of the summed magnitudes."""
    ens = random_bestfirst_ensemble(T, leaves, F, seed=T + F)
    qs = ensemble_to_qs(ens)
    rng = np.random.default_rng(1)
    X = jnp.asarray(rng.standard_normal((300, F), dtype=np.float32))
    a = np.asarray(score_qs(X, qs))
    b = np.asarray(score_ensemble(X, ens, max_depth=2 * leaves))
    scale = max(1.0, np.abs(a).max())
    np.testing.assert_allclose(b, a, atol=2e-6 * scale, rtol=0)


def test_qs_single_tree_exact():
    """With one tree there is no summation-order freedom: QS is bitwise
    the weighted leaf value of the descent."""
    ens = random_bestfirst_ensemble(1, 16, 10, seed=11)
    qs = ensemble_to_qs(ens)
    rng = np.random.default_rng(2)
    X = jnp.asarray(rng.standard_normal((300, 10), dtype=np.float32))
    np.testing.assert_array_equal(
        np.asarray(score_qs(X, qs)),
        np.asarray(score_ensemble(X, ens, max_depth=16)),
    )


def test_partial_scores_qs_bitwise():
    """Per-tree columns from the QS form == ops/scoring.py::partial_scores
    (Cleaver/LineSearch input), incl. zero columns for dead slots."""
    from quickrank_tpu.ops.scoring import partial_scores
    from quickrank_tpu.trees.qs import partial_scores_qs

    ens = random_bestfirst_ensemble(12, 8, 6, seed=9)
    ens = ens.replace(num_trees=jnp.asarray(9, jnp.int32))
    qs = ensemble_to_qs(ens)
    rng = np.random.default_rng(4)
    X = jnp.asarray(rng.standard_normal((150, 6), dtype=np.float32))
    a = np.asarray(partial_scores(X, ens, max_depth=16))
    b = np.asarray(partial_scores_qs(X, qs))
    assert b.shape == a.shape
    np.testing.assert_array_equal(a, b)


def test_qs_bin_space_matches_rescore_scan():
    """Bin-space QS tables (space="bin") reproduce the warm-restart
    rescoring scan bitwise: scoring the binned tensor with threshold_bin
    routing == the compensated per-tree descent (mart.py::rescore_binned's
    two paths must be interchangeable)."""
    from quickrank_tpu.data.synthetic import make_ranking_dataset
    from quickrank_tpu.learning import LambdaMart
    from quickrank_tpu.learning.mart import TrainData
    from quickrank_tpu.metrics.metrics import Ndcg
    from quickrank_tpu.ops.scoring import kahan_add, tree_delta_binned

    ds = make_ranking_dataset(num_queries=30, avg_docs_per_query=15, seed=2)
    lm = LambdaMart(
        ntrees=6, nleaves=8, shrinkage=0.2, nthresholds=31, esr=0, seed=1
    )
    lm.learn(ds, None, Ndcg(10), verbose=False)
    ens = lm.ensemble
    td = TrainData.build(ds, 31)
    md = lm._descend_depth()

    # the scan path, exactly as rescore_binned's multi-process branch
    import jax
    import jax.numpy as jnp2

    def body(carry, t):
        tree = ens.tree(t)
        d = tree_delta_binned(td.step.binned, tree, md)
        w = jnp2.where(t < ens.num_trees, ens.weight[t], 0.0)
        return kahan_add(carry[0], carry[1], w * d), None

    z = jnp2.zeros((td.step.binned.shape[0],), jnp2.float32)
    (ref, _), _ = jax.lax.scan(body, (z, z), jnp2.arange(ens.capacity))

    qs = ensemble_to_qs(ens, space="bin")
    got = score_qs(td.step.binned.astype(jnp2.float32), qs)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_qs_stump_mix():
    """An ensemble mixing a stump (root is a leaf) with a real tree: the
    stump excludes nothing and always yields its root value."""
    from quickrank_tpu.trees.structs import EnsembleTensors

    T, max_nodes = 2, 3
    feature = np.full((T, max_nodes), -1, np.int32)
    feature[1, 0] = 0
    threshold = np.zeros((T, max_nodes), np.float32)
    threshold[1, 0] = 0.5
    left = np.zeros((T, max_nodes), np.int32)
    right = np.zeros((T, max_nodes), np.int32)
    left[1, 0], right[1, 0] = 1, 2
    is_leaf = np.ones((T, max_nodes), bool)
    is_leaf[1, 0] = False
    leaf_value = np.zeros((T, max_nodes), np.float32)
    leaf_value[0, 0] = 3.0
    leaf_value[1, 1] = 1.0
    leaf_value[1, 2] = -2.0
    ens = EnsembleTensors(
        feature=jnp.asarray(feature), threshold=jnp.asarray(threshold),
        threshold_bin=jnp.zeros((T, max_nodes), jnp.int32),
        left=jnp.asarray(left), right=jnp.asarray(right),
        is_leaf=jnp.asarray(is_leaf), leaf_value=jnp.asarray(leaf_value),
        weight=jnp.asarray([0.5, 1.0], jnp.float32),
        num_trees=jnp.asarray(2, jnp.int32),
    )
    X = jnp.asarray(np.array([[0.0], [1.0]], np.float32))
    np.testing.assert_array_equal(
        np.asarray(score_qs(X, ensemble_to_qs(ens))), _score_ref(X, ens, 3)
    )
