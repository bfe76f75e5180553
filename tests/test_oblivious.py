"""Oblivious-tree tests: level-synchronous fit semantics, bit-OR scorer
parity with the generic descent, quality floors (mirrors
test-obliviousmart.cc / test-obvlambdamart.cc strategy)."""

import numpy as np
import jax.numpy as jnp
import pytest

from quickrank_tpu.learning import ObliviousLambdaMart, ObliviousMart
from quickrank_tpu.metrics import Ndcg
from quickrank_tpu.ops.binning import bin_dataset
from quickrank_tpu.ops.oblivious import score_oblivious, score_oblivious_binned
from quickrank_tpu.ops.scoring import score_ensemble
from quickrank_tpu.trees.oblivious import (
    fit_oblivious_tree,
    oblivious_leaf_outputs,
    oblivious_to_tree,
)


def test_oblivious_fit_level_semantics():
    """Every level must use one (feature, threshold); the chosen split must
    maximize the gain summed across fringe nodes (ot.cc:177-201)."""
    rng = np.random.default_rng(7)
    N, F, D = 500, 6, 2
    X = rng.normal(size=(N, F)).astype(np.float32)
    y = (1.5 * (X[:, 0] > 0) + (X[:, 1] > 0.5)).astype(np.float32)
    b = bin_dataset(X, nthresholds=16)
    mask = jnp.ones((N,), bool)
    fid, thr, tbin, node = fit_oblivious_tree(
        jnp.asarray(b.binned), jnp.asarray(y), mask, jnp.asarray(b.thresholds), D
    )
    fid, tbin, node = np.asarray(fid), np.asarray(tbin), np.asarray(node)

    # Level 0: brute-force the best root split.
    best, best_ft = -np.inf, None
    for f in range(F):
        for t in range(b.num_bins):
            left = b.binned[:, f] <= t
            lc, rc = left.sum(), (~left).sum()
            if lc >= 1 and rc >= 1:
                ls, rs = y[left].sum(), y[~left].sum()
                g = ls * ls / lc + rs * rs / rc
                if g > best:
                    best, best_ft = g, (f, t)
    assert (fid[0], tbin[0]) == best_ft

    # Assignment consistency: leaf index bits == per-level comparisons.
    bits0 = (b.binned[:, fid[0]] > tbin[0]).astype(int)
    bits1 = (b.binned[:, fid[1]] > tbin[1]).astype(int)
    np.testing.assert_array_equal(node, bits0 * 2 + bits1)


def test_oblivious_leaf_outputs_mean():
    rng = np.random.default_rng(3)
    node = rng.integers(0, 4, size=200)
    g = rng.normal(size=200).astype(np.float32)
    vals = np.asarray(
        oblivious_leaf_outputs(
            jnp.asarray(node), jnp.asarray(g), jnp.ones(200, bool), 4
        )
    )
    for leaf in range(4):
        assert vals[leaf] == pytest.approx(g[node == leaf].mean(), rel=1e-5)


@pytest.fixture(scope="module")
def obv_model(splits):
    train, valid, _ = splits
    om = ObliviousMart(ntrees=30, treedepth=4, nthresholds=64, seed=1)
    info = om.learn(train, valid, Ndcg(10), verbose=False)
    return om, info


def test_obliviousmart_quality(obv_model, splits):
    _, _, test = splits
    om, info = obv_model
    assert info["train"][-1] >= 0.80
    assert om.evaluate(test, Ndcg(10)) >= 0.75


def test_fast_scorer_matches_descent(obv_model, splits):
    _, _, test = splits
    om, _ = obv_model
    fast = om.score_dataset(test)
    slow = np.asarray(
        score_ensemble(
            jnp.asarray(test.features), om.ensemble, max_depth=om._descend_depth()
        )
    )
    np.testing.assert_allclose(fast, slow, atol=1e-5)


def test_fast_scorer_chunked_matches(obv_model, splits):
    _, _, test = splits
    om, _ = obv_model
    obl = om.oblivious_ensemble()
    T = int(obl.num_trees)
    full = np.asarray(score_oblivious(jnp.asarray(test.features), obl))
    # pick a REAL divisor of the actual tree count (the trained count is
    # the validation-rollback prefix, not the requested ntrees — a
    # conditional `if T % 5 == 0` silently skipped the whole assertion
    # for most rollback outcomes)
    chunk = next(c for c in range(min(5, T), 0, -1) if T % c == 0)
    chunked = np.asarray(
        score_oblivious(jnp.asarray(test.features), obl, tree_chunk=chunk)
    )
    np.testing.assert_allclose(full, chunked, atol=1e-5)


def test_binned_scorer_matches_value_scorer(obv_model, splits):
    train, _, _ = splits
    om, _ = obv_model
    obl = om.oblivious_ensemble()
    # Bin-space routing needs the same thresholds used in training.
    from quickrank_tpu.ops.binning import apply_bins

    from quickrank_tpu.learning.mart import TrainData

    tr = TrainData.build(train, 64)
    binned = apply_bins(train.features, np.asarray(tr.step.thresholds))
    sv = np.asarray(score_oblivious(jnp.asarray(train.features), obl))
    sb = np.asarray(score_oblivious_binned(jnp.asarray(binned), obl))
    np.testing.assert_allclose(sv, sb, atol=1e-5)


def test_obliviouslambdamart_trains(splits):
    train, valid, _ = splits
    ol = ObliviousLambdaMart(ntrees=15, treedepth=3, nthresholds=32, seed=2)
    info = ol.learn(train, valid, Ndcg(10), verbose=False)
    assert info["train"][-1] > info["train"][0]
    assert info["train"][-1] >= 0.55


def test_leaf_indices_match_host_walk(obv_model, splits):
    """oblivious_leaf_indices (the routing score_oblivious sums over)
    equals a host walk of the level tables, and the scores are the
    weighted leaf values at those indices."""
    from quickrank_tpu.ops.oblivious import oblivious_leaf_indices

    _, _, test = splits
    om, _ = obv_model
    obl = om.oblivious_ensemble()
    X = np.asarray(test.features[:256])
    fid, thr = np.asarray(obl.fid), np.asarray(obl.thr)
    T, D = fid.shape
    ref = np.zeros((X.shape[0], T), np.int64)
    for d in range(D):
        ref = ref * 2 + (X[:, fid[:, d]] > thr[None, :, d])
    got = np.asarray(oblivious_leaf_indices(jnp.asarray(X), obl))
    np.testing.assert_array_equal(got, ref)
    live = np.arange(T) < int(obl.num_trees)
    w = np.asarray(obl.weight) * live
    expect = (np.asarray(obl.leaf)[np.arange(T)[None, :], ref] * w).sum(1)
    np.testing.assert_allclose(
        np.asarray(score_oblivious(jnp.asarray(X), obl)), expect, atol=1e-5
    )


def test_scorer_threshold_equality(rng):
    """Feature values exactly equal to thresholds must route left (v <= t),
    exactly like the reference comparison (rt.cc:330)."""
    from quickrank_tpu.ops.oblivious import oblivious_leaf_indices
    from quickrank_tpu.trees.oblivious import ObliviousEnsemble

    F, T, D = 8, 4, 2
    thr = rng.normal(size=(T, D)).astype(np.float32)
    fid = rng.integers(0, F, size=(T, D)).astype(np.int32)
    leaf = rng.normal(size=(T, 4)).astype(np.float32)
    ens = ObliviousEnsemble(
        fid=jnp.asarray(fid),
        thr=jnp.asarray(thr),
        thr_bin=jnp.zeros((T, D), jnp.int32),
        leaf=jnp.asarray(leaf),
        weight=jnp.ones((T,), jnp.float32),
        num_trees=jnp.asarray(T, jnp.int32),
    )
    # craft docs whose selected features EQUAL the thresholds
    X = rng.normal(size=(16, F)).astype(np.float32)
    for t in range(T):
        for d in range(D):
            X[t * D + d, fid[t, d]] = thr[t, d]
    idx = np.asarray(oblivious_leaf_indices(jnp.asarray(X), ens))
    for t in range(T):
        for d in range(D):
            bit = (idx[t * D + d, t] >> (D - 1 - d)) & 1
            assert bit == 0, (t, d)  # equal -> not greater -> left
    expect = leaf[np.arange(T)[None, :], idx].sum(1)
    np.testing.assert_allclose(
        np.asarray(score_oblivious(jnp.asarray(X), ens)), expect, atol=1e-6
    )
