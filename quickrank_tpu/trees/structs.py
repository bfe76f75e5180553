"""Dense tensor (SoA) tree + ensemble containers.

Replacement of the pointer-based ``RTNode`` tree
(include/learning/tree/rtnode.h:37) and the growable ``Ensemble`` of
``(root*, weight, maxlabel)`` entries (include/learning/tree/ensemble.h:28).
Trees are fixed-size arrays over a padded node axis so an ensemble is one
stacked tensor per field and scoring is a traversal-free vectorized gather
loop (see ops/scoring.py) instead of per-doc recursion (rtnode.h:134-152).

Node layout: node 0 is the root; children are allocated in split order.
``is_leaf`` marks current leaves; unused padding nodes have ``is_leaf=True``
and ``leaf_value=0`` so they are harmless if ever reached (they are not).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax.numpy as jnp
from quickrank_tpu.utils import struct


@struct.dataclass
class Tree:
    """One regression tree over a fixed ``max_nodes`` node budget."""

    feature: jnp.ndarray  # i32 [max_nodes], -1 when leaf/unused
    threshold: jnp.ndarray  # f32 [max_nodes], go left iff x[f] <= threshold
    threshold_bin: jnp.ndarray  # i32 [max_nodes] bin-space split point
    left: jnp.ndarray  # i32 [max_nodes]
    right: jnp.ndarray  # i32 [max_nodes]
    is_leaf: jnp.ndarray  # bool [max_nodes]
    leaf_value: jnp.ndarray  # f32 [max_nodes]
    n_nodes: jnp.ndarray  # i32 scalar

    @property
    def max_nodes(self) -> int:
        return int(self.feature.shape[-1])

    @staticmethod
    def empty(max_nodes: int) -> "Tree":
        return Tree(
            feature=jnp.full((max_nodes,), -1, jnp.int32),
            threshold=jnp.zeros((max_nodes,), jnp.float32),
            threshold_bin=jnp.full((max_nodes,), -1, jnp.int32),
            left=jnp.zeros((max_nodes,), jnp.int32),
            right=jnp.zeros((max_nodes,), jnp.int32),
            is_leaf=jnp.ones((max_nodes,), bool),
            leaf_value=jnp.zeros((max_nodes,), jnp.float32),
            n_nodes=jnp.asarray(1, jnp.int32),
        )


@struct.dataclass
class EnsembleTensors:
    """Stacked trees ``[T, max_nodes]`` + per-tree weights ``[T]``.

    ``num_trees`` (i32 scalar) is the live prefix; slots >= num_trees are
    zero-weighted empty trees, so fixed-capacity buffers can be preallocated
    and updated functionally inside jit (the growable push/pop of
    ensemble.cc:97-108 becomes an index write + counter bump).
    """

    feature: jnp.ndarray
    threshold: jnp.ndarray
    threshold_bin: jnp.ndarray
    left: jnp.ndarray
    right: jnp.ndarray
    is_leaf: jnp.ndarray
    leaf_value: jnp.ndarray
    weight: jnp.ndarray  # f32 [T]
    num_trees: jnp.ndarray  # i32 scalar

    @property
    def capacity(self) -> int:
        return int(self.feature.shape[0])

    @property
    def max_nodes(self) -> int:
        return int(self.feature.shape[1])

    @staticmethod
    def empty(capacity: int, max_nodes: int) -> "EnsembleTensors":
        t = Tree.empty(max_nodes)
        tile = lambda x: jnp.broadcast_to(x, (capacity,) + x.shape).copy()  # noqa: E731
        return EnsembleTensors(
            feature=tile(t.feature),
            threshold=tile(t.threshold),
            threshold_bin=tile(t.threshold_bin),
            left=tile(t.left),
            right=tile(t.right),
            is_leaf=tile(t.is_leaf),
            leaf_value=tile(t.leaf_value),
            weight=jnp.zeros((capacity,), jnp.float32),
            num_trees=jnp.asarray(0, jnp.int32),
        )

    def push(self, tree: Tree, weight) -> "EnsembleTensors":
        """Append a tree at slot ``num_trees`` (Ensemble::push,
        ensemble.cc:97-105)."""
        t = self.num_trees
        return self.replace(
            feature=self.feature.at[t].set(tree.feature),
            threshold=self.threshold.at[t].set(tree.threshold),
            threshold_bin=self.threshold_bin.at[t].set(tree.threshold_bin),
            left=self.left.at[t].set(tree.left),
            right=self.right.at[t].set(tree.right),
            is_leaf=self.is_leaf.at[t].set(tree.is_leaf),
            leaf_value=self.leaf_value.at[t].set(tree.leaf_value),
            weight=self.weight.at[t].set(jnp.asarray(weight, jnp.float32)),
            num_trees=t + 1,
        )

    def pop(self, n=1) -> "EnsembleTensors":
        """Drop the newest ``n`` trees (Ensemble::pop, ensemble.cc:107-108
        — used by the early-stopping rollback, mart.cc:390-395)."""
        return self.replace(num_trees=jnp.maximum(self.num_trees - n, 0))

    def tree(self, t) -> Tree:
        return Tree(
            feature=self.feature[t],
            threshold=self.threshold[t],
            threshold_bin=self.threshold_bin[t],
            left=self.left[t],
            right=self.right[t],
            is_leaf=self.is_leaf[t],
            leaf_value=self.leaf_value[t],
            n_nodes=jnp.asarray(self.max_nodes, jnp.int32),
        )

    def tree_mask(self) -> jnp.ndarray:
        """bool [T]: live tree slots."""
        return jnp.arange(self.capacity) < self.num_trees


def tree_depths(ens, cap: Optional[int] = None) -> np.ndarray:
    """Max depth of each live tree in an EnsembleTensors.

    Iterative (explicit worklist): a degenerate chain-shaped tree from an
    XML import is bounded by the node budget, not Python's process-global
    recursion limit (rtnode.h:134's recursion rides the C++ stack; ours must
    not ride sys.setrecursionlimit).  With ``cap``, a tree found deeper than
    ``cap`` reports ``cap + 1`` without walking its remaining nodes."""
    T = int(ens.num_trees)
    left = np.asarray(ens.left)
    right = np.asarray(ens.right)
    isleaf = np.asarray(ens.is_leaf)

    def depth(t):
        maxd = 0
        stack = [(0, 0)]
        while stack:
            i, d = stack.pop()
            if isleaf[t, i]:
                maxd = max(maxd, d)
                continue
            if cap is not None and d >= cap:
                return cap + 1
            stack.append((int(left[t, i]), d + 1))
            stack.append((int(right[t, i]), d + 1))
        return maxd

    return np.asarray([depth(t) for t in range(T)])
