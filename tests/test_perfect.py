"""Depth-capped best-first growth and tree-depth measurement."""

import numpy as np
import jax.numpy as jnp
import pytest

from quickrank_tpu.learning import LambdaMart, Mart
from quickrank_tpu.metrics import Ndcg
from quickrank_tpu.trees.structs import tree_depths


def _chain_ensemble(n: int):
    """One chain-shaped tree of ``n`` splits (depth n): node 2i splits
    into (leaf 2i+1, chain 2i+2).  Shared by the depth-refusal and
    iterative-depth tests."""
    from quickrank_tpu.trees.structs import EnsembleTensors, Tree

    max_nodes = 2 * n + 1
    tree = Tree.empty(max_nodes)
    idx = np.arange(n)
    feature = np.full((max_nodes,), -1, np.int32)
    left = np.zeros((max_nodes,), np.int32)
    right = np.zeros((max_nodes,), np.int32)
    is_leaf = np.ones((max_nodes,), bool)
    feature[2 * idx] = 0
    left[2 * idx] = 2 * idx + 1
    right[2 * idx] = 2 * idx + 2
    is_leaf[2 * idx] = False
    tree = tree.replace(
        feature=jnp.asarray(feature),
        left=jnp.asarray(left),
        right=jnp.asarray(right),
        is_leaf=jnp.asarray(is_leaf),
    )
    ens = EnsembleTensors.empty(1, max_nodes)
    return ens.replace(
        feature=tree.feature[None], threshold=ens.threshold,
        left=tree.left[None], right=tree.right[None],
        is_leaf=tree.is_leaf[None],
        weight=jnp.ones((1,), jnp.float32),
        num_trees=jnp.asarray(1, jnp.int32),
    )


@pytest.fixture(scope="module")
def capped_model(splits):
    train, valid, _ = splits
    lm = LambdaMart(
        ntrees=8, nleaves=16, nthresholds=32, seed=1, max_depth=4
    )
    lm.learn(train, valid, Ndcg(10), verbose=False)
    return lm


def test_max_depth_respected(capped_model):
    depths = tree_depths(capped_model.ensemble)
    assert (depths <= 4).all()
    # still uses a real leaf budget
    assert int(capped_model.ensemble.num_trees) >= 1


def test_quality_with_depth_cap(splits):
    train, valid, test = splits
    lm = LambdaMart(ntrees=30, nleaves=16, nthresholds=64, seed=1, max_depth=5)
    info = lm.learn(train, valid, Ndcg(10), verbose=False)
    assert info["train"][-1] >= 0.70  # parity-ish with unbounded trees


def test_chain_tree_depth_is_iterative():
    """A degenerate chain-shaped tree (every split's right child is a leaf —
    the shape an adversarial XML import produces) must be measured without
    recursion: depth >> sys recursion limits may appear in imported models
    and must not crash (VERDICT r2 item 8)."""
    import sys

    n = max(4 * sys.getrecursionlimit(), 8192)  # far past any Python stack
    ens = _chain_ensemble(n)
    # cap-bounded probe: must not walk the whole chain, let alone recurse
    assert tree_depths(ens, cap=5)[0] == 6
    # uncapped exact depth still works iteratively
    assert tree_depths(ens)[0] == n
