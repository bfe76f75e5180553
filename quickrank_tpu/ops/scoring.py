"""Vectorized ensemble scoring — the QuickScore-style traversal-free path.

Replaces the reference's per-doc recursive tree walk
(``RTNode::score_instance``, include/learning/tree/rtnode.h:134-152, and
``Ensemble::score_instance``, src/learning/tree/ensemble.cc:111-118) with a
batched iterative descent: all docs advance one level per step via gathers,
so there is no recursion, no branching per doc, and XLA fuses the whole
ensemble sweep.  The oblivious-tree bit-OR leaf indexing trick
(src/io/generate_oblivious.cc:306-312) lives in ops/oblivious.py.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from quickrank_tpu.trees.structs import EnsembleTensors, Tree


def kahan_add(s: jnp.ndarray, c: jnp.ndarray, d: jnp.ndarray):
    """One Kahan-compensated accumulation step: returns (s', c') with
    ``s' + c' ~= s + c + d`` to ~f64 accuracy while staying in f32.

    The reference accumulates ensemble scores in double (``Score = double``,
    include/types.h:28-35; ensemble.cc:111-118); on the GPU f64 runs at a
    small fraction of the f32 rate, so compensated f32 is the equivalent.  XLA does not
    reassociate float arithmetic by default, so the correction term
    survives compilation (asserted by tests/test_precision.py).
    """
    y = d - c
    t = s + y
    return t, (t - s) - y


def descend_tree(features: jnp.ndarray, tree: Tree, max_depth: int) -> jnp.ndarray:
    """Leaf node id reached by every doc: i32 [N].

    ``max_depth`` iterations of: gather split params at the current node,
    route left/right on ``x[f] <= threshold`` (rt.cc:330 semantics).  Docs
    already at a leaf stay put, so ``max_depth`` only needs to upper-bound
    the tree depth (worst case nleaves-1 for best-first trees).
    """
    N = features.shape[0]
    node0 = jnp.zeros((N,), jnp.int32)

    def step(_, node):
        f = tree.feature[node]
        thr = tree.threshold[node]
        leaf = tree.is_leaf[node]
        x = jnp.take_along_axis(
            features, jnp.maximum(f, 0)[:, None], axis=1
        )[:, 0]
        nxt = jnp.where(x <= thr, tree.left[node], tree.right[node])
        return jnp.where(leaf, node, nxt).astype(jnp.int32)

    return jax.lax.fori_loop(0, max_depth, step, node0)


def score_tree(features: jnp.ndarray, tree: Tree, max_depth: int) -> jnp.ndarray:
    """Unweighted output of one tree for every doc: f32 [N]."""
    return tree.leaf_value[descend_tree(features, tree, max_depth)]


def descend_tree_binned(
    binned: jnp.ndarray,
    tree: Tree,
    max_depth: int,
    feat_axis: Optional[str] = None,
) -> jnp.ndarray:
    """Same descent in bin space (training-time path: bin <= threshold_bin
    routing is exactly the value <= threshold routing by construction).

    With ``feat_axis`` (inside a shard_map over a 2-D data x feature mesh)
    ``binned`` is the shard-LOCAL feature block while ``tree.feature``
    holds GLOBAL feature ids: each level, the shard owning the split
    feature computes the routing bit and a psum over the feature axis
    broadcasts it — the same owner-psum discipline fit_tree uses for
    split routing (trees/grow.py do_split)."""
    N, F = binned.shape
    node0 = jnp.zeros((N,), jnp.int32)

    def step(_, node):
        f = tree.feature[node]
        tb = tree.threshold_bin[node]
        leaf = tree.is_leaf[node]
        if feat_axis is None:
            x = jnp.take_along_axis(
                binned, jnp.maximum(f, 0)[:, None], axis=1
            )[:, 0]
            goes_left = x <= tb
        else:
            shard = jax.lax.axis_index(feat_axis)
            owns = (f // F) == shard  # f = -1 on leaves: owned by no shard
            fl = jnp.where(owns, f % F, 0)
            x = jnp.take_along_axis(binned, fl[:, None], axis=1)[:, 0]
            bit = ((x <= tb) & owns).astype(jnp.int32)
            goes_left = jax.lax.psum(bit, feat_axis) > 0
        nxt = jnp.where(goes_left, tree.left[node], tree.right[node])
        return jnp.where(leaf, node, nxt).astype(jnp.int32)

    return jax.lax.fori_loop(0, max_depth, step, node0)


def leaf_values(node: jnp.ndarray, tree: Tree) -> jnp.ndarray:
    """``tree.leaf_value[node]`` for every doc: f32 [N] — the reference's
    leaf-output read after routing (rtnode.h:134-152 returns the reached
    leaf's avglabel); negative node ids clamp to 0."""
    return tree.leaf_value[jnp.maximum(node, 0)]


def tree_delta_binned(
    binned: jnp.ndarray,
    tree: Tree,
    max_depth: int,
    feat_axis: Optional[str] = None,
) -> jnp.ndarray:
    """Leaf value reached by every doc, in bin space: f32 [N].

    The scoring delta of every per-iteration validation rescore
    (mart.cc:361-366's per-tree valid update) and DART's dropped-set/full
    rescores (dart.cc:552-558).  Under feature sharding (``feat_axis``)
    the owner-psum descent routes."""
    node = descend_tree_binned(binned, tree, max_depth, feat_axis)
    return leaf_values(node, tree)


@partial(
    jax.jit, static_argnames=("max_depth", "num_trees_hint", "compensated")
)
def score_ensemble(
    features: jnp.ndarray,
    ens: EnsembleTensors,
    max_depth: Optional[int] = None,
    num_trees_hint: Optional[int] = None,
    compensated: bool = False,
) -> jnp.ndarray:
    """Weighted ensemble scores: f32 [N] = sum_t weight_t * tree_t(doc).

    A scan over tree slots (memory-light; the per-tree descent is itself
    fully vectorized over docs).  Dead slots (t >= num_trees) have weight 0.
    With ``compensated`` the sum over trees is Kahan-compensated — the f32
    analog of the reference's double accumulator (ensemble.cc:111-118).
    """
    md = max_depth or ens.max_nodes

    def body(carry, t):
        acc, comp = carry
        tree = ens.tree(t)
        s = score_tree(features, tree, md)
        w = jnp.where(t < ens.num_trees, ens.weight[t], 0.0)
        if compensated:
            return kahan_add(acc, comp, w * s), None
        return (acc + w * s, comp), None

    T = num_trees_hint or ens.capacity
    init = jnp.zeros((features.shape[0],), jnp.float32)
    (out, _), _ = jax.lax.scan(body, (init, init), jnp.arange(T))
    return out


@partial(jax.jit, static_argnames=("max_depth",))
def partial_scores(
    features: jnp.ndarray, ens: EnsembleTensors, max_depth: Optional[int] = None
) -> jnp.ndarray:
    """Per-tree *unweighted* scores [N, T] — the partial-score dataset used
    by Cleaver/LineSearch post-optimization (Ensemble::partial_scores_instance
    ensemble.cc:120-131, Driver::extract_partial_scores driver.cc:411-446).
    """
    md = max_depth or ens.max_nodes

    def body(_, t):
        s = score_tree(features, ens.tree(t), md)
        return None, jnp.where(t < ens.num_trees, s, 0.0)

    _, cols = jax.lax.scan(body, None, jnp.arange(ens.capacity))
    return jnp.swapaxes(cols, 0, 1)
