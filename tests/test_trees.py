"""Tree-machinery tests: split-oracle parity, routing consistency, ensemble
bookkeeping.  Mirrors the reference's strategy of closed-form/brute-force
oracles (SURVEY.md §4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from quickrank_tpu.ops.binning import bin_dataset
from quickrank_tpu.ops.histogram import doc_channels, masked_histogram
from quickrank_tpu.ops.scoring import (
    descend_tree,
    descend_tree_binned,
    partial_scores,
    score_ensemble,
    score_tree,
)
from quickrank_tpu.trees.grow import GrowConfig, fit_tree, leaf_outputs
from quickrank_tpu.trees.structs import EnsembleTensors


@pytest.fixture(scope="module")
def small_problem():
    rng = np.random.default_rng(42)
    N, F = 400, 7
    X = rng.normal(size=(N, F)).astype(np.float32)
    y = (
        2.0 * (X[:, 0] > 0.2)
        + 1.0 * (X[:, 1] > -0.5) * X[:, 2]
        + 0.1 * rng.normal(size=N)
    ).astype(np.float32)
    return X, y


def _fit(X, y, nleaves=8, minls=1, nthresholds=32):
    b = bin_dataset(X, nthresholds=nthresholds)
    cfg = GrowConfig(nleaves=nleaves, min_leaf_support=minls, num_bins=b.num_bins)
    binned = jnp.asarray(b.binned)
    grad = jnp.asarray(y)
    mask = jnp.ones((X.shape[0],), bool)
    tree, node = fit_tree(binned, grad, mask, jnp.asarray(b.thresholds), cfg)
    tree = leaf_outputs(tree, node, grad, mask)
    return b, cfg, tree, np.asarray(node)


def test_histogram_matches_numpy(small_problem):
    X, y = small_problem
    b = bin_dataset(X, nthresholds=16)
    mask = np.zeros(X.shape[0], bool)
    mask[::3] = True
    chan = doc_channels(jnp.asarray(y), jnp.asarray(mask))
    h = np.asarray(
        masked_histogram(jnp.asarray(b.binned), chan, jnp.asarray(mask), b.num_bins)
    )
    for f in range(X.shape[1]):
        for t in range(b.num_bins):
            sel = mask & (b.binned[:, f] == t)
            assert h[f, t, 0] == pytest.approx(sel.sum())
            assert h[f, t, 1] == pytest.approx(y[sel].sum(), abs=1e-4)


def test_root_split_is_global_argmax(small_problem):
    """First split must maximize lsum^2/lcount + rsum^2/rcount over every
    (feature, bin) with both children >= minls (rt.cc:261-291)."""
    X, y = small_problem
    minls = 5
    b, cfg, tree, _ = _fit(X, y, nleaves=2, minls=minls)
    best = -np.inf
    for f in range(X.shape[1]):
        for t in range(b.num_bins):
            left = b.binned[:, f] <= t
            lc, rc = left.sum(), (~left).sum()
            if lc >= minls and rc >= minls:
                ls, rs = y[left].sum(), y[~left].sum()
                best = max(best, ls * ls / lc + rs * rs / rc)
    f0 = int(tree.feature[0])
    t0 = int(tree.threshold_bin[0])
    left = b.binned[:, f0] <= t0
    ls, rs = y[left].sum(), y[~left].sum()
    got = ls * ls / left.sum() + rs * rs / (~left).sum()
    assert got == pytest.approx(best, rel=1e-5)


def test_leaf_values_are_leaf_means(small_problem):
    X, y = small_problem
    b, cfg, tree, node = _fit(X, y, nleaves=8)
    lv = np.asarray(tree.leaf_value)
    for n in np.unique(node):
        sel = node == n
        assert lv[n] == pytest.approx(y[sel].mean(), rel=1e-4)


def test_node_assignment_matches_descent(small_problem):
    """node_of_doc built during growth == routing a fresh descent, in both
    bin space and value space."""
    X, y = small_problem
    b, cfg, tree, node = _fit(X, y, nleaves=8)
    via_bins = np.asarray(descend_tree_binned(jnp.asarray(b.binned), tree, cfg.nleaves))
    via_vals = np.asarray(descend_tree(jnp.asarray(X), tree, cfg.nleaves))
    np.testing.assert_array_equal(node, via_bins)
    np.testing.assert_array_equal(node, via_vals)


def test_min_leaf_support(small_problem):
    X, y = small_problem
    b, cfg, tree, node = _fit(X, y, nleaves=8, minls=30)
    counts = np.bincount(node, minlength=cfg.max_nodes)
    leaves = np.asarray(tree.is_leaf) & (counts > 0)
    assert (counts[leaves] >= 30).all()


def test_nleaves_budget(small_problem):
    X, y = small_problem
    for nl in (2, 4, 13):
        b, cfg, tree, node = _fit(X, y, nleaves=nl)
        n_leaves = int(np.asarray(tree.is_leaf)[: int(tree.n_nodes)].sum())
        assert n_leaves <= nl
        assert len(np.unique(node)) == n_leaves


def test_doc_mask_excludes_docs(small_problem):
    """Masked docs are ROUTED (so score updates are a pure leaf gather) but
    must not influence the tree: fitting with a mask must build the same
    structure as fitting on the kept subset alone."""
    X, y = small_problem
    b = bin_dataset(X, nthresholds=32)
    cfg = GrowConfig(nleaves=4, min_leaf_support=1, num_bins=b.num_bins)
    mask = np.ones(X.shape[0], bool)
    mask[::2] = False
    tree, node = fit_tree(
        jnp.asarray(b.binned),
        jnp.asarray(y),
        jnp.asarray(mask),
        jnp.asarray(b.thresholds),
        cfg,
    )
    node = np.asarray(node)
    assert (node >= 0).all()  # every doc routed
    # same tree from the kept subset only (same binning)
    tree2, _ = fit_tree(
        jnp.asarray(b.binned[mask]),
        jnp.asarray(y[mask]),
        jnp.ones(int(mask.sum()), bool),
        jnp.asarray(b.thresholds),
        cfg,
    )
    np.testing.assert_array_equal(np.asarray(tree.feature), np.asarray(tree2.feature))
    np.testing.assert_array_equal(
        np.asarray(tree.threshold_bin), np.asarray(tree2.threshold_bin)
    )


def test_tree_reduces_sse(small_problem):
    X, y = small_problem
    b, cfg, tree, node = _fit(X, y, nleaves=16)
    pred = np.asarray(score_tree(jnp.asarray(X), tree, cfg.nleaves))
    assert ((y - pred) ** 2).sum() < 0.5 * ((y - y.mean()) ** 2).sum()


def test_ensemble_push_pop_and_partial_scores(small_problem):
    X, y = small_problem
    b, cfg, tree, node = _fit(X, y, nleaves=8)
    ens = EnsembleTensors.empty(4, cfg.max_nodes)
    ens = ens.push(tree, 0.5).push(tree, 0.25)
    s = np.asarray(score_ensemble(jnp.asarray(X), ens, max_depth=cfg.nleaves))
    one = np.asarray(score_tree(jnp.asarray(X), tree, cfg.nleaves))
    np.testing.assert_allclose(s, 0.75 * one, rtol=1e-5)
    ps = np.asarray(partial_scores(jnp.asarray(X), ens, max_depth=cfg.nleaves))
    assert ps.shape == (X.shape[0], 4)
    np.testing.assert_allclose(ps[:, 0], one, rtol=1e-6)
    np.testing.assert_allclose(ps[:, 2:], 0.0)
    popped = ens.pop()
    s1 = np.asarray(score_ensemble(jnp.asarray(X), popped, max_depth=cfg.nleaves))
    np.testing.assert_allclose(s1, 0.5 * one, rtol=1e-5)


def test_feature_sampling_runs(small_problem):
    X, y = small_problem
    b = bin_dataset(X, nthresholds=16)
    cfg = GrowConfig(
        nleaves=4, min_leaf_support=1, num_bins=b.num_bins, max_features=0.5
    )
    tree, node = fit_tree(
        jnp.asarray(b.binned),
        jnp.asarray(y),
        jnp.ones((X.shape[0],), bool),
        jnp.asarray(b.thresholds),
        cfg,
        key=jax.random.PRNGKey(3),
    )
    assert int(tree.n_nodes) > 1


def test_histogram_oob_bin_dropped_consistently(small_problem):
    """bin id == num_bins (a feature value past the FLT_MAX sentinel,
    e.g. +inf) must be DROPPED per (doc, feature) element by every
    histogram route — the node passes and the masked (best-first) pass —
    never clamped into the top bin (which would diverge trees between the
    CPU scatter and the GPU kernel, whose bin test drops it)."""
    from quickrank_tpu.ops.histogram import doc_channels, node_histograms

    X, y = small_problem
    b = bin_dataset(X, nthresholds=16)
    N = X.shape[0]
    num_bins = b.num_bins
    rng = np.random.default_rng(3)
    binned = np.asarray(b.binned).copy()
    oob = rng.uniform(size=binned.shape) < 0.05
    binned[oob] = num_bins  # what apply_bins yields for +inf values
    binned = jnp.asarray(binned)
    mask = jnp.ones((N,), bool)
    node = jnp.asarray(rng.integers(0, 2, size=N).astype(np.int32))
    chan = doc_channels(jnp.asarray(y), mask)

    hist = np.asarray(node_histograms(binned, chan, node, mask, 2, num_bins))
    # the dropped elements really are gone: per-feature count equals the
    # number of in-range docs for that feature
    counts = hist[..., 0].sum(axis=(0, 2))  # [F]
    expect = (np.asarray(binned) < num_bins).sum(axis=0)
    np.testing.assert_allclose(counts, expect, atol=1e-4)
    # the masked pass (node 0 = everyone) drops the same elements
    whole = np.asarray(masked_histogram(binned, chan, mask, num_bins))
    np.testing.assert_allclose(whole, hist.sum(axis=0), rtol=1e-5, atol=1e-5)


def test_masked_histogram_mask_as_node(small_problem):
    """masked_histogram folds the subset mask in as a node id (in-mask docs
    -> node 0, the rest -> -1, outside every pass) — it must equal the
    node pass over the same rows restricted by hand, for a subset that
    leaves whole doc runs empty."""
    from quickrank_tpu.ops.histogram import histogram_pass_xla

    X, y = small_problem
    b = bin_dataset(X, nthresholds=16)
    N = X.shape[0]
    rng = np.random.default_rng(11)
    doc_mask = jnp.asarray(rng.uniform(size=N) < 0.9)
    sub = rng.uniform(size=N) < 0.5
    sub[128:256] = False  # a long run of docs outside the subset
    subset = jnp.asarray(sub) & doc_mask
    chan = doc_channels(jnp.asarray(y), doc_mask)
    num_bins = b.num_bins
    sel = np.asarray(subset)
    ref = np.asarray(
        histogram_pass_xla(
            jnp.asarray(b.binned[sel]), chan[sel], jnp.zeros(int(sel.sum()), jnp.int32),
            0, 1, num_bins,
        )
    )[0]
    got = np.asarray(
        masked_histogram(jnp.asarray(b.binned), chan, subset, num_bins)
    )
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_collapse_leaves_factor(small_problem):
    """Bottom-up leaf-merge pruning (rt.cc:93-152): larger factors collapse
    deeper, trees stay scorable, factor=0 is a no-op."""
    X, y = small_problem
    b = bin_dataset(X, nthresholds=32)

    def fit_with(factor):
        cfg = GrowConfig(
            nleaves=16, min_leaf_support=1, num_bins=b.num_bins,
            collapse_factor=factor,
        )
        tree, node = fit_tree(
            jnp.asarray(b.binned), jnp.asarray(y),
            jnp.ones((X.shape[0],), bool), jnp.asarray(b.thresholds), cfg,
        )
        tree = leaf_outputs(tree, node, jnp.asarray(y), jnp.ones(X.shape[0], bool))
        return tree, np.asarray(node)

    t0, n0 = fit_with(0.0)
    t1, n1 = fit_with(0.25)
    leaves0 = int((np.asarray(t0.is_leaf) & (np.bincount(n0, minlength=t0.max_nodes) > 0)).sum())
    leaves1 = int((np.asarray(t1.is_leaf) & (np.bincount(n1, minlength=t1.max_nodes) > 0)).sum())
    assert leaves1 <= leaves0
    # collapsed tree still routes consistently and scores finitely
    pred = np.asarray(score_tree(jnp.asarray(X), t1, 16))
    assert np.isfinite(pred).all()
    via = np.asarray(descend_tree_binned(jnp.asarray(b.binned), t1, 16))
    np.testing.assert_array_equal(n1, via)


def test_levelwise_growth(small_problem):
    """Level-wise mode: depth-bounded trees, per-node own splits, routing
    consistent with descent, root split equals best-first's root split."""
    from quickrank_tpu.trees.grow_level import fit_tree_levelwise

    X, y = small_problem
    b = bin_dataset(X, nthresholds=32)
    cfg = GrowConfig(nleaves=16, min_leaf_support=1, num_bins=b.num_bins)
    tree, node = fit_tree_levelwise(
        jnp.asarray(b.binned), jnp.asarray(y),
        jnp.ones((X.shape[0],), bool), jnp.asarray(b.thresholds), 4, cfg,
    )
    tree_bf, _ = fit_tree(
        jnp.asarray(b.binned), jnp.asarray(y),
        jnp.ones((X.shape[0],), bool), jnp.asarray(b.thresholds),
        GrowConfig(nleaves=2, min_leaf_support=1, num_bins=b.num_bins),
    )
    assert int(tree.feature[0]) == int(tree_bf.feature[0])
    assert int(tree.threshold_bin[0]) == int(tree_bf.threshold_bin[0])
    via = np.asarray(descend_tree_binned(jnp.asarray(b.binned), tree, 5))
    np.testing.assert_array_equal(np.asarray(node), via)


def test_levelwise_routing_above_256_bins(rng):
    """Regression: _route_bits once cast bin ids to bf16, which is only
    exact up to 256 — with >257 bins, odd bin ids adjacent to the chosen
    threshold mis-routed.  Level-wise routing must equal tree descent for
    any bin count the u16 wire supports."""
    from quickrank_tpu.trees.grow_level import fit_tree_levelwise

    N, F = 3000, 4
    X = rng.integers(0, 400, size=(N, F)).astype(np.float32)
    y = (X[:, 0] > 300).astype(np.float32) + rng.normal(0, 0.1, N).astype(
        np.float32
    )
    b = bin_dataset(X, nthresholds=0)  # one bin per distinct value: ~400
    assert b.num_bins > 257, b.num_bins
    cfg = GrowConfig(nleaves=16, min_leaf_support=1, num_bins=b.num_bins)
    tree, node = fit_tree_levelwise(
        jnp.asarray(b.binned), jnp.asarray(y),
        jnp.ones((N,), bool), jnp.asarray(b.thresholds), 4, cfg,
    )
    assert int(jnp.max(tree.threshold_bin)) > 256  # splits land up high
    via = np.asarray(descend_tree_binned(jnp.asarray(b.binned), tree, 5))
    np.testing.assert_array_equal(np.asarray(node), via)


@pytest.mark.parametrize("newton", [False, True])
def test_levelwise_leaf_values_match_leaf_outputs(small_problem, newton):
    """The level-wise grower's histogram-derived leaf values (left = cum at
    the chosen split, right = total - left, stopped node = own totals) must
    agree with the per-leaf aggregation pass they replace."""
    from quickrank_tpu.trees.grow import leaf_outputs
    from quickrank_tpu.trees.grow_level import fit_tree_levelwise

    X, y = small_problem
    rng = np.random.default_rng(7)
    w = rng.uniform(0.1, 2.0, size=y.shape).astype(np.float32) if newton else None
    mask = jnp.asarray(rng.uniform(size=y.shape) < 0.9)  # exercise masking
    b = bin_dataset(X, nthresholds=32)
    cfg = GrowConfig(
        nleaves=16, min_leaf_support=1, num_bins=b.num_bins, newton=newton
    )
    tree, node = fit_tree_levelwise(
        jnp.asarray(b.binned), jnp.asarray(y), mask,
        jnp.asarray(b.thresholds), 4, cfg,
        weights=jnp.asarray(w) if newton else None,
    )
    ref = leaf_outputs(
        tree.replace(leaf_value=jnp.zeros_like(tree.leaf_value)),
        node, jnp.asarray(y), mask,
        weights=jnp.asarray(w) if newton else None,
    )
    np.testing.assert_allclose(
        np.asarray(tree.leaf_value), np.asarray(ref.leaf_value),
        rtol=2e-5, atol=1e-6,
    )


def test_tree_delta_binned_bitwise_matches_gather(small_problem):
    """The scoring delta (ops/scoring.py::tree_delta_binned, every
    rescoring site: Mart valid update, DART dropped-set/full rescore) is
    BITWISE ``leaf_value[descend_tree_binned(...)]``, and leaf_values
    clamps negative node ids to the root like the reference's guard."""
    from quickrank_tpu.ops.scoring import leaf_values, tree_delta_binned

    X, y = small_problem
    b, cfg, tree, node = _fit(X, y, nleaves=8)
    binned = jnp.asarray(b.binned)
    ref_node = np.asarray(descend_tree_binned(binned, tree, cfg.nleaves))
    ref = np.asarray(tree.leaf_value)[ref_node]
    np.testing.assert_array_equal(
        np.asarray(tree_delta_binned(binned, tree, cfg.nleaves)), ref
    )
    node_neg = jnp.asarray(ref_node).at[0].set(-1)
    expect = np.asarray(tree.leaf_value)[np.maximum(np.asarray(node_neg), 0)]
    np.testing.assert_array_equal(
        np.asarray(leaf_values(node_neg, tree)), expect
    )


@pytest.mark.parametrize("wire", [np.uint8, np.uint16])
def test_descend_tree_binned_wire_dtypes(small_problem, wire):
    """Bin-space descent routes the u8 wire (<= 256 bins, the default
    StepData.binned) and the u16 wire (> 256 bins) exactly like i32 bin
    ids — the bin compare is integer-exact for every storage dtype."""
    X, y = small_problem
    nthr = 32 if wire == np.uint8 else 1000
    b, cfg, tree, node = _fit(X, y, nleaves=8, nthresholds=nthr)
    assert (b.num_bins <= 256) == (wire == np.uint8)
    ref = np.asarray(descend_tree_binned(jnp.asarray(b.binned), tree, cfg.nleaves))
    got = descend_tree_binned(
        jnp.asarray(np.asarray(b.binned).astype(wire)), tree, cfg.nleaves
    )
    np.testing.assert_array_equal(np.asarray(got), ref)
    np.testing.assert_array_equal(ref, node)


def test_tree_delta_binned_feature_sharded(small_problem):
    """Under a feature mesh the delta routes via owner-psum descent and
    still equals the single-device gather path."""
    from functools import partial as _partial

    from jax.sharding import Mesh, PartitionSpec as P

    from quickrank_tpu.parallel.mesh import shard_map as _shard_map
    from quickrank_tpu.ops.scoring import tree_delta_binned

    X, y = small_problem
    b, cfg, tree, node = _fit(X, y, nleaves=8)
    F = b.binned.shape[1]
    k = 2
    Fp = (F + k - 1) // k * k
    binned = np.pad(np.asarray(b.binned), ((0, 0), (0, Fp - F)))
    ref = np.asarray(tree.leaf_value)[
        np.asarray(descend_tree_binned(jnp.asarray(b.binned), tree, cfg.nleaves))
    ]
    devs = np.array(jax.devices("cpu")[:k])
    with Mesh(devs, ("feat",)) as mesh:
        fn = _shard_map(
            _partial(tree_delta_binned, max_depth=cfg.nleaves, feat_axis="feat"),
            mesh,
            in_specs=(P(None, "feat"), P()),
            out_specs=P(),
        )
        out = np.asarray(fn(jnp.asarray(binned), tree))
    np.testing.assert_array_equal(out, ref)
