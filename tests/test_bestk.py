"""Best-k grower (trees/grow_bestk.py): k=1 must reproduce exact best-first
bit for bit; k>1 must obey the same leaf-budget/minls/gain rules and hold
quality on a learnable task; sharded runs must match single-device."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from quickrank_tpu.data.synthetic import make_train_valid_test
from quickrank_tpu.learning import LambdaMart
from quickrank_tpu.metrics import Ndcg
from quickrank_tpu.ops.binning import bin_dataset
from quickrank_tpu.parallel import make_mesh
from quickrank_tpu.trees.grow import GrowConfig, fit_tree
from quickrank_tpu.trees.grow_bestk import fit_tree_bestk

TREE_FIELDS = ("feature", "threshold", "threshold_bin", "left", "right",
               "is_leaf", "n_nodes")


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(42)
    N, F = 400, 7
    X = rng.normal(size=(N, F)).astype(np.float32)
    y = (
        2.0 * (X[:, 0] > 0.2)
        + 1.0 * (X[:, 1] > -0.5) * X[:, 2]
        + 0.1 * rng.normal(size=N)
    ).astype(np.float32)
    b = bin_dataset(X, nthresholds=32)
    return (
        jnp.asarray(b.binned),
        jnp.asarray(y),
        jnp.ones((N,), bool),
        jnp.asarray(b.thresholds),
        b.num_bins,
    )


@pytest.mark.parametrize(
    "nleaves,minls,mf,max_depth",
    [(8, 1, 1.0, 0), (10, 5, 1.0, 0), (8, 1, 0.5, 0), (16, 3, 1.0, 3)],
)
def test_k1_bitwise_matches_exact_bestfirst(problem, nleaves, minls, mf,
                                            max_depth):
    binned, grad, mask, thr, B = problem
    cfg = GrowConfig(nleaves=nleaves, min_leaf_support=minls, num_bins=B,
                     max_features=mf, max_depth=max_depth)
    key = jax.random.PRNGKey(7)
    t1, n1 = fit_tree(binned, grad, mask, thr, cfg, key=key)
    t2, n2 = fit_tree_bestk(binned, grad, mask, thr, cfg, 1, key=key)
    for f in TREE_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(t1, f)), np.asarray(getattr(t2, f)), err_msg=f
        )
    np.testing.assert_array_equal(np.asarray(n1), np.asarray(n2))


@pytest.mark.parametrize("k", [2, 4, 8])
def test_bestk_leaf_budget_and_minls(problem, k):
    """Final leaf count equals exact best-first's (rt.cc:64-90 budget) and
    every leaf holds >= minls docs."""
    binned, grad, mask, thr, B = problem
    minls = 3
    cfg = GrowConfig(nleaves=10, min_leaf_support=minls, num_bins=B)
    tree, node = fit_tree_bestk(binned, grad, mask, thr, cfg, k,
                                key=jax.random.PRNGKey(7))
    is_leaf = np.asarray(tree.is_leaf)
    nn = int(tree.n_nodes)
    leaves = [i for i in range(nn) if is_leaf[i]]
    assert len(leaves) == 10
    nod = np.asarray(node)
    assert np.all(is_leaf[nod]), "every doc must land on a leaf"
    for i in leaves:
        assert int((nod == i).sum()) >= minls


@pytest.mark.parametrize("k", [2, 8])
def test_bestk_splits_are_per_node_argmax(problem, k):
    """Each internal node's (feature, bin) must be the max-gain split over
    the docs routed to it — same oracle exact best-first satisfies."""
    binned, grad, mask, thr, B = problem
    minls = 5
    cfg = GrowConfig(nleaves=8, min_leaf_support=minls, num_bins=B)
    tree, node = fit_tree_bestk(binned, grad, mask, thr, cfg, k,
                                key=jax.random.PRNGKey(3))
    bn = np.asarray(binned)
    g = np.asarray(grad)
    nn = int(tree.n_nodes)
    feat = np.asarray(tree.feature)
    tbin = np.asarray(tree.threshold_bin)
    left = np.asarray(tree.left)
    right = np.asarray(tree.right)
    is_leaf = np.asarray(tree.is_leaf)

    # recover each internal node's doc set by walking down from the root
    members = {0: np.ones(bn.shape[0], bool)}
    order = [0]
    for i in order:
        if is_leaf[i]:
            continue
        m = members[i]
        goes_left = bn[:, feat[i]] <= tbin[i]
        members[left[i]] = m & goes_left
        members[right[i]] = m & ~goes_left
        order.extend([left[i], right[i]])

    for i in range(nn):
        if is_leaf[i]:
            continue
        m = members[i]
        best = -np.inf
        for f in range(bn.shape[1]):
            for t in range(B):
                lsel = m & (bn[:, f] <= t)
                lc, rc = lsel.sum(), (m & ~lsel).sum()
                if lc >= minls and rc >= minls:
                    ls, rs = g[lsel].sum(), g[m & ~lsel].sum()
                    best = max(best, ls * ls / lc + rs * rs / rc)
        lsel = m & (bn[:, feat[i]] <= tbin[i])
        ls, rs = g[lsel].sum(), g[m & ~lsel].sum()
        got = ls * ls / lsel.sum() + rs * rs / (m & ~lsel).sum()
        assert got == pytest.approx(best, rel=1e-5), f"node {i}"


def test_bestk_lambdamart_quality():
    """growth='bestk' must track growth='best' NDCG on a learnable fixture —
    the trade of batching splits stays small."""
    train, valid, _ = make_train_valid_test(num_queries=(48, 16, 16))
    res = {}
    for growth in ("best", "bestk"):
        lm = LambdaMart(ntrees=25, nleaves=8, nthresholds=64, seed=5,
                        growth=growth, esr=0)
        info = lm.learn(train, valid, Ndcg(10), verbose=False)
        res[growth] = info
    assert res["bestk"]["train"][-1] > res["best"]["train"][-1] - 0.02
    assert res["bestk"]["valid"][-1] > res["best"]["valid"][-1] - 0.03


def test_bestk_sharded_matches_single_device():
    train, valid, _ = make_train_valid_test(num_queries=(32, 12, 12))
    i1 = LambdaMart(ntrees=8, nleaves=8, nthresholds=32, seed=1,
                    growth="bestk").learn(train, valid, Ndcg(10),
                                          verbose=False)
    i4 = LambdaMart(ntrees=8, nleaves=8, nthresholds=32, seed=1,
                    growth="bestk").learn(train, valid, Ndcg(10),
                                          verbose=False, mesh=make_mesh(4))
    np.testing.assert_allclose(i1["train"], i4["train"], atol=1e-2)
    np.testing.assert_allclose(i1["valid"], i4["valid"], atol=1e-2)


def test_bestk_2d_mesh_matches_single_device():
    """data x feature mesh: per-leaf candidate all_gather + owner-psum
    routing must reproduce the single-device run (split decisions derive
    only from reduced histograms)."""
    from quickrank_tpu.learning import Mart
    from quickrank_tpu.parallel.mesh import make_mesh_2d

    train, valid, _ = make_train_valid_test(num_queries=(32, 12, 12))
    i1 = Mart(ntrees=8, nleaves=8, nthresholds=32, seed=1,
              growth="bestk").learn(train, valid, Ndcg(10), verbose=False)
    i2 = Mart(ntrees=8, nleaves=8, nthresholds=32, seed=1,
              growth="bestk").learn(train, valid, Ndcg(10), verbose=False,
                                    mesh=make_mesh_2d(2, 4))
    np.testing.assert_allclose(i1["train"], i2["train"], atol=1e-6)
    np.testing.assert_allclose(i1["valid"], i2["valid"], atol=1e-6)


def test_bestk_split_pack_1_matches_best_end_to_end():
    """Mart(growth='bestk', split_pack=1) must equal Mart(growth='best')
    exactly — the whole-training-loop form of the k=1 bitwise guarantee."""
    from quickrank_tpu.learning import Mart

    train, valid, _ = make_train_valid_test(num_queries=(24, 8, 8))
    i1 = Mart(ntrees=6, nleaves=8, nthresholds=32, seed=2,
              growth="best").learn(train, valid, Ndcg(10), verbose=False)
    i2 = Mart(ntrees=6, nleaves=8, nthresholds=32, seed=2, growth="bestk",
              split_pack=1).learn(train, valid, Ndcg(10), verbose=False)
    np.testing.assert_array_equal(i1["train"], i2["train"])
    np.testing.assert_array_equal(i1["valid"], i2["valid"])


def test_growth_alias_and_validation():
    from quickrank_tpu.learning import Mart

    assert Mart(growth="best-k").growth == "bestk"
    with pytest.raises(ValueError):
        Mart(growth="bogus")
